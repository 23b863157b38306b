"""Where B4's and B4f's time goes on the card: the committed kernels beside
edited builds of the same source, other launch plans, and the parent
commit's B4.

    git archive 5c34bc3 | tar -x -C build/parent    # once, for the parent
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.bucket_grad_ablation \\
        [--parent build/parent] [--out ablation.json]

It builds kernels/csrc/bucket_grad.cu as committed and edited copies into
build/kernels/ablation/ (a directory .gitignore lists), and the parent's
bucket_grad.cu where --parent names a checkout of it. B4, the gather:

    full            the committed kernel and its plan (the row's table in
                    shared memory as bf16, float4 errors and gradient, uchar4
                    flags, two vectors a thread in flight, 256 threads, one
                    wave of blocks);
    scalar_loads    every row on the scalar path (one 4-byte error, one
                    1-byte flag and one 4-byte store a thread at a time);
    table_global    the gather from the float32 table in global memory with
                    an `__ldg` per pixel, as the parent did (no fill);
    one_vector, four_vectors  one or four float4 vectors a thread in flight;
    t128, t512, t1024  other block sizes;
    blocks_x2, blocks_half  twice and half the blocks a row;
    parent          the parent commit's B4 (scalar loads, the float32 table
                    from global memory, about 8 blocks an SM, a 64-bit
                    index);

at the HRNetv2 cell's errors (17 rows of 8 x 544 x 960 from seeded logits)
and at views of them one float and two bytes into their storage (cell_view:
the scalar path). B4f, the fused backward:

    full            the committed kernel and its plan (the C 17 instance,
                    the tables in shared memory, 1024 threads, tiles of 2048
                    pixels, p and dp in registers);
    reread_logits   the write loop reads the logits again and recomputes p
                    (the softmax's max and sum kept) instead of keeping p
                    in registers;
    global_instance the plan's instance for C above 25 (MAXC 32, the table
                    gathered from global memory, 512 threads) at C 17;
    t512, t256      other block sizes;
    tile1024, tile4096  other tiles;
    seg8, seg33     per image only: 8 blocks an image (half a wave), or 33
                    (a block walks two images and loads two tables);

at the cell's bf16 logits (cell), float32 logits (cell_f32) and per image
(per_image, 136 rows). Every build's output is held bit-equal to the
committed kernel's (the parent's B4 included), the committed one's to its
plain version (B4) or within its tolerances (B4f). Each case is timed in
turns (the variants, then in reverse; median of `reps`) twice: the call
with the allocation of its output (CUDA events), then the kernel's own
device time (torch.profiler, held within 0.85-1.10 of queued CUDA events,
`fu_grad_ablation.device_ms`). It prints each build's registers and spills
(ptxas). It runs on the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import subprocess

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import bucket_grad as bg
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    bucket_histogram)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _ptr, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    grad_table, losses_and_tables)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import lovasz_rows
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.bucket_hist_ablation import (
    _median_ms, _nvcc)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
    device_ms)

CELL = (8, 17, 544, 960)   # N, C, H, W of the HRNetv2 cell's logits
# the profiler's names of the committed gather (bucket_gather_kernel) and
# the parent's (bucket_grad_kernel)
GATHER_KERNELS = "bucket_g"

ALIGNED = "  const bool aligned = ((a_e | a_o) & 3) == 0"
GATHER_SMEM = "  return b < 0 ? 0.0f : bf16_float(tbl[(fg ? bk::kBuckets : 0) + b]);\n"
GATHER_FILL = "  fill_table(tbl, gtbl, bk::kBins);\n  __syncthreads();\n"
VECS = "constexpr int kGatherVecs = 2;"
KEEP_P = "      z[c] = prob;\n"
WRITE_P = "      store_grad<T>(dst + c * hw, __fmul_rn(z[c], __fsub_rn(dp, s)));\n"
WRITE_REREAD = ("      const float prob =\n"
                "          __fdiv_rn(expf(__fsub_rn(load_logit<T>(src + c * hw), m)), sum);\n"
                "      store_grad<T>(dst + c * hw, __fmul_rn(prob, __fsub_rn(dp, s)));\n")
EDITS = {
    "scalar_loads": ((ALIGNED, "  const bool aligned = false && ((a_e | a_o) & 3) == 0"),),
    "table_global": ((GATHER_SMEM,
                      "  return b < 0 ? 0.0f : __ldg(gtbl + (fg ? bk::kBuckets : 0) + b);\n"),
                     (GATHER_FILL, "")),
    "one_vector": ((VECS, "constexpr int kGatherVecs = 1;"),),
    "four_vectors": ((VECS, "constexpr int kGatherVecs = 4;"),),
    "reread_logits": ((KEEP_P, ""), (WRITE_P, WRITE_REREAD)),
}
GATHER_BUILDS = ("scalar_loads", "table_global", "one_vector", "four_vectors")
FUSED_BUILDS = ("reread_logits",)
GATHER_PLANS = {"t128": dict(threads=128), "t512": dict(threads=512),
                "t1024": dict(threads=1024), "blocks_x2": dict(scale=2.0),
                "blocks_half": dict(scale=0.5)}
FUSED_PLANS = {"global_instance": dict(table_smem=False), "t512": dict(threads=512),
               "t256": dict(threads=256), "tile1024": dict(tile_px=1024),
               "tile4096": dict(tile_px=4096), "seg8": dict(per_seg=8),
               "seg33": dict(per_seg=33)}


def edited_sources() -> dict[str, str]:
    """Each EDITS variant's text of the committed source; raises where an
    edit no longer matches it."""
    src = (build.CSRC / "bucket_grad.cu").read_text()
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source does not hold {old!r} once")
            text = text.replace(old, new)
        out[name] = text
    return out


def registers(log: str) -> dict[str, str]:
    """{kernel instance: ptxas' registers and spills} of a build log."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[-1].strip()
        elif fn and "spill" in line:
            out[fn] = line.strip()
        elif fn and "Used" in line and "registers" in line:
            out[fn] = f"{line.split('info    : ')[-1].strip()}; {out.get(fn, '')}"
            fn = None
    return out


def build_variants(parent: pathlib.Path | None) -> tuple[dict, dict]:
    """nvcc the committed source, every edited one (and the parent's) at
    once with the library's flags; ({name: handle}, {name: ptxas lines})."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {"full": _nvcc(build.CSRC / "bucket_grad.cu", build.CSRC,
                           out_dir / "bucket_grad_full.so")}
    for name, text in edited_sources().items():
        cu = out_dir / f"bucket_grad_{name}.cu"
        cu.write_text(text)
        procs[name] = _nvcc(cu, build.CSRC, out_dir / f"bucket_grad_{name}.so")
    if parent is not None:
        csrc = parent / "miccai2021_cataract_semantic_segmentation_tpu_torch" / "kernels" / "csrc"
        procs["parent"] = _nvcc(csrc / "bucket_grad.cu", csrc, out_dir / "bucket_grad_parent.so")
    libs, info = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"bucket_grad_{name}.so"))
        info[name] = registers(log)
        if name == "parent":
            vp = ctypes.c_void_p
            libs[name].bucket_grad_bwd.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                                                   vp, ctypes.c_int, vp]
            libs[name].bucket_grad_bwd.restype = ctypes.c_int
        else:
            bg.set_argtypes(libs[name])
    return libs, info


def _parent_gather(lib, e, fg, table):
    out = torch.empty_like(e)
    err = lib.bucket_grad_bwd(_ptr(e), _ptr(fg), _ptr(table), e.shape[0], e.shape[1], _ptr(out),
                              e.device.index, stream_ptr(e.device))
    if err != 0:
        raise RuntimeError(f"parent bucket_grad failed with cudaError {err}")
    return out


def fused_inputs(dev, dtype, per_image: bool):
    """(errors, flags, table, logits) of the cell from seeded 3 x randn
    logits and labels constant on 8 x 8 blocks (18 values: the ignore id
    17 counts as background), the table from the loss's cotangent on a B3
    forward."""
    n, c, h, w = CELL
    gen = torch.Generator(device=dev).manual_seed(14)
    logits = (3.0 * torch.randn(CELL, generator=gen, device=dev)).to(dtype)
    blocks = np.random.default_rng(14).integers(0, c + 1, (n, h // 8, w // 8))
    labels = torch.as_tensor(np.repeat(np.repeat(blocks, 8, 1), 8, 2), device=dev)
    e, fg, present = lovasz_rows(logits, labels, None, per_image)
    e, fg = e.contiguous(), fg.contiguous()
    _, _, g_fg, g_bg = losses_and_tables(bucket_histogram(e, fg))
    pr = present.reshape(n if per_image else 1, c)
    ct = (pr / pr.sum(1, keepdim=True).clamp_min(1.0) / pr.shape[0]).reshape(-1)
    return e, fg, grad_table(g_fg, g_bg, ct), logits


def gather_runners(libs, e, fg, table) -> dict:
    """Each gather variant's call at one case, and its plan."""
    dev = e.device.index
    rows, p = e.shape
    full = libs["full"]
    out = {}
    base = bg.b4_plan(rows, p, bg.gather_resident(full, bg.GATHER_THREADS, dev))
    for name in ("full", *GATHER_BUILDS, *GATHER_PLANS):
        lib = libs.get(name, full)
        kw = GATHER_PLANS.get(name, {})
        threads = kw.get("threads", bg.GATHER_THREADS)
        if "scale" in kw:
            plan = bg.b4_plan(rows, p, 0, per_row=max(1, round(base.per_row * kw["scale"])))
        else:
            plan = bg.b4_plan(rows, p, bg.gather_resident(lib, threads, dev), threads)
        out[name] = (lambda lib=lib, plan=plan: bg.run_gather_plan(lib, plan, e, fg, table)), plan
    if "parent" in libs:
        out["parent"] = (lambda: _parent_gather(libs["parent"], e, fg, table)), None
    return out


def fused_runners(libs, e, fg, table, logits, per_image: bool) -> dict:
    """Each B4f variant's call at one case, and its plan."""
    dev = logits.device.index
    n, c, h, w = logits.shape
    bf16 = logits.dtype == torch.bfloat16
    out = {}
    for name in ("full", *FUSED_BUILDS, *FUSED_PLANS):
        lib = libs.get(name, libs["full"])
        kw = dict(FUSED_PLANS.get(name, {}))
        per_seg = kw.pop("per_seg", None)
        if per_seg is not None and not per_image:
            continue
        layout = bg.b4f_layout(c, **kw)
        plan = bg.b4f_plan(layout, n, h * w, per_image, per_seg=per_seg,
                           resident=bg.fused_resident(lib, layout, bf16, dev))
        out[name] = (lambda lib=lib, plan=plan: bg.run_fused_plan(lib, plan, e, fg, table,
                                                                  logits)), plan
    return out


def time_case(case: str, calls: dict, reps: int, kernel: str) -> dict:
    """Calls (CUDA events) and kernels alone (profiler), in two turns."""
    order = list(calls) + list(calls)[::-1]
    times, alone = {}, {}
    for name in order:
        times.setdefault(name, []).append(_median_ms(calls[name][0], reps))
    for name in order:
        alone.setdefault(name, []).append(device_ms(calls[name][0], reps, kernel=kernel))
    print(f"{case} call ms, C entry with its output allocation (CUDA events; two turns): "
          f"{json.dumps(times)}", flush=True)
    print(f"{case} kernel ms (profiler; two turns): {json.dumps(alone)}", flush=True)
    return {"call_ms": times, "kernel_ms": alone}


def main(reps: int = 20, parent: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    bg._grad_lib()     # the committed library, built as the wrapper builds it
    libs, info = build_variants(pathlib.Path(parent) if parent else None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for name, item in info.items():
        print(f"build {name}: {json.dumps(item)}", flush=True)
    result = {"card": card, "builds": info}
    e, fg, table, logits = fused_inputs(dev, torch.bfloat16, False)
    view_e = torch.cat([e.new_zeros(1), e.flatten()])[1:].view(e.shape)
    view_fg = torch.cat([fg.new_zeros(2), fg.flatten()])[2:].view(fg.shape)
    for case, (ce, cf) in {"cell": (e, fg), "cell_view": (view_e, view_fg)}.items():
        calls = gather_runners(libs, ce, cf, table)
        ref = calls["full"][0]()
        if not torch.equal(ref, bg.bucket_gather_plain(ce, cf, table)):
            raise AssertionError(f"B4 {case}: the committed kernel differs from its plain version")
        for name, (fn, plan) in calls.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"B4 {case} {name}: the gradient differs")
            if plan is not None:
                print(f"B4 {case} {name}: plan {plan}", flush=True)
        print(f"B4 {case}: every gradient bit-equal to the committed kernel's and to the "
              f"plain version ({', '.join(calls)})", flush=True)
        result[f"B4 {case}"] = time_case(f"B4 {case}", calls, reps, GATHER_KERNELS)
        del ref
    del view_e, view_fg, e, fg, table, logits
    for case, (dtype, per_image) in {"cell": (torch.bfloat16, False),
                                     "cell_f32": (torch.float32, False),
                                     "per_image": (torch.bfloat16, True)}.items():
        e, fg, table, logits = fused_inputs(dev, dtype, per_image)
        calls = fused_runners(libs, e, fg, table, logits, per_image)
        ref = calls["full"][0]()
        plain = bg.bucket_dlogits_plain(e, fg, table, logits, per_image)
        max_abs = float((ref.float() - plain.float()).abs().max())
        for name, (fn, plan) in calls.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"B4f {case} {name}: the gradient differs")
            print(f"B4f {case} {name}: plan {dataclasses.asdict(plan)}", flush=True)
        print(f"B4f {case}: every gradient bit-equal to the committed kernel's "
              f"({', '.join(calls)}); its largest difference from the plain version "
              f"{max_abs!r}", flush=True)
        result[f"B4f {case}"] = time_case(f"B4f {case}", calls, reps, "bucket_dlogits_kernel")
        result[f"B4f {case}"]["max_abs_vs_plain"] = max_abs
        del e, fg, table, logits, ref, plain
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of the parent commit")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", help="also write the result as JSON here")
    args = parser.parse_args()
    res = main(args.reps, args.parent)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
