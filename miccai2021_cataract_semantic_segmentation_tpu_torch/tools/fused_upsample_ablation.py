"""Where P1's and P2's time goes on the card: each pass of the committed
kernels beside builds of the same source with work taken out.

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fused_upsample_ablation

It builds kernels/csrc/fused_upsample.cu as committed and four edited
copies into build/kernels/ablation/ (a directory .gitignore lists):

    full         the committed kernels (3xTF32);
    cvt_split    the same, rounding to TF32 by `cvt.rna.tf32.f32` in place
                 of the committed integer add and mask (the same bits);
    no_split     the same three products on the unsplit bits (no split work);
    one_product  one product on the unsplit bits (the TF32 arithmetic alone);
    copies_only  no products: the staging ring, the loop and the stores.

`full` and `cvt_split` compute P1/P2 (their outputs are held bit-equal);
the others time the work that is left. At the prototype's shape (N 8,
R 36, 68 x 120 -> 544 x 960, pads 72/128/1024) it prints, in turns (full,
the ablations, the ablations reversed, full), each function's time (CUDA
events, median of `reps`) and each pass's device time (torch.profiler,
median over `reps` calls). It runs on the card only.
"""
from __future__ import annotations

import ctypes
import functools
import json
import statistics
import subprocess

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _ptr, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.proto_fused_upsample import (
    PROTO, prep)

SPLIT = """  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));   // the subtraction is exact"""
RAW = """  big = small = __float_as_uint(x);"""
TF32 = """  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"""
CVT = """  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;"""
PRODUCTS = """          mma(acc[i][j], a_small[i], b_big);
          mma(acc[i][j], a_big[i], b_small);
          mma(acc[i][j], a_big[i], b_big);"""
ONE_PRODUCT = """          mma(acc[i][j], a_big[i], b_big);"""
EDITS = {
    "full": (),
    "cvt_split": ((TF32, CVT),),
    "no_split": ((SPLIT, RAW),),
    "one_product": ((SPLIT, RAW), (PRODUCTS, ONE_PRODUCT)),
    "copies_only": ((PRODUCTS, ""),),
}
# the passes in launch order
PASSES = {"fused_upsample_fwd": ("p1_cols", "p1_rows"),
          "fused_downsample_bwd": ("p2_rows", "p2_cols")}


def sources() -> dict[str, str]:
    """Each variant's source: the committed one with its edits applied;
    raises where an edit no longer matches the committed source."""
    src = (build.CSRC / "fused_upsample.cu").read_text()
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> dict[str, ctypes.CDLL]:
    """nvcc every variant at once with the library's flags; their handles."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for entry in PASSES:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return libs


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _pass_us(fn, names, reps: int) -> dict[str, float]:
    """Each pass's median device microseconds over `reps` calls of `fn`,
    whose kernels run in the order of `names`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "fused_upsample_gemm" in e.name),
                     key=lambda e: e.time_range.start)
    if len(kernels) != reps * len(names):
        raise RuntimeError(f"profiled {len(kernels)} kernels, expected "
                           f"{reps * len(names)}")
    return {name: statistics.median(e.time_range.elapsed_us()
                                    for e in kernels[i::len(names)])
            for i, name in enumerate(names)}


def main(reps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    p = PROTO
    n, c, rows = 8, p["c"], 2 * p["c"]
    big_h = p["out_hw"][0]
    gen = torch.Generator().manual_seed(0)
    li, lf = (torch.randn((n, c, p["h"], p["ws"]), generator=gen).to(dev)
              for _ in range(2))
    ls2d, mhT, mw = prep(li, lf, p["out_hw"], p["h_pad"], p["ws_pad"], p["w_pad"])
    mwT = mw.t().contiguous()
    d = torch.randn((n, rows, big_h, p["w_pad"]), generator=gen).to(dev)
    empty = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    outs = {"fused_upsample_fwd": (ls2d, mhT, mw, empty(n, p["h_pad"], rows, p["w_pad"]),
                                   empty(n, rows, big_h, p["w_pad"])),
            "fused_downsample_bwd": (d, mhT, mwT, empty(n, rows, p["h_pad"], p["w_pad"]),
                                     empty(n, rows, p["h_pad"], p["ws_pad"]))}
    dims = (n, rows, big_h, p["h_pad"], p["ws_pad"], p["w_pad"], dev.index or 0,
            stream_ptr(dev))
    libs = build_variants()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)

    def call(lib, entry):
        def run():
            err = getattr(lib, entry)(*map(_ptr, outs[entry]), *dims)
            if err != 0:
                raise RuntimeError(f"{entry} failed with cudaError {err}")
        return run

    order = list(EDITS)
    order = order + order[::-1]
    result, full_out = {}, {}
    for name in order:
        row = {}
        for entry, names in PASSES.items():
            fn = call(libs[name], entry)
            row[f"{names[0][:2]}_ms"] = _median_ms(fn, reps)
            row.update(_pass_us(fn, names, reps))
            if name == "full":
                full_out[entry] = outs[entry][-1].clone()
            elif name == "cvt_split" and entry in full_out:
                if not torch.equal(outs[entry][-1], full_out[entry]):
                    raise AssertionError(f"{entry}: cvt_split differs from full")
                row[f"{names[0][:2]}_bit_equal_to_full"] = True
        print(f"{name}: " + json.dumps(row), flush=True)
        result.setdefault(name, []).append(row)
    return result


if __name__ == "__main__":
    main()
