"""Where B3's time goes on the card: the committed kernel beside edited
builds of the same source, other launch plans, and the parent commit's B3.

    git archive cefeb1d | tar -x -C build/parent    # once, for the parent
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.bucket_hist_ablation \\
        [--parent build/parent]

It builds kernels/csrc/bucket_hist.cu as committed and edited copies into
build/kernels/ablation/ (a directory .gitignore lists), and the parent's
bucket_hist.cu where --parent names a checkout of it:

    full           the committed kernel and its default plan;
    no_hot_bins    buckets 0 and 2047 through 64-bit shared atomics, not
                   per-lane registers;
    shared64       buckets 1..2046 sum their units in 64-bit shared atomics
                   (the first design's 48 KB table), not 32-bit offsets;
    fp64_units     the units through double, as the first design;
    int_units      the units from the bf16 bit pattern by shift and mask;
    run_merge      a lane's run of equal bins added at once, as the first
                   design;
    scalar_loads   one error and one flag a load, block-strided, as the
                   first design;
    occupancy3     three blocks an SM (at most 40 registers), not four;
    t256, t1024    blocks of 256 or 1024 threads;
    waves2, ceil_wave, rows_x0.5  the committed kernel with the blocks of
                   two waves, with the blocks per row rounded up (a partial
                   second wave, as the first design) or with half the
                   default plan's blocks per row (longer blocks flush fewer
                   bins);
    parent         the parent commit's B3.

At the HRNetv2 cell's shape (17 rows of 8 x 544 x 960 pixels) it runs four
inputs: "cell", the rows of `lovasz_rows` from 3 x randn logits and blocky
labels (as chip_smoke.py phase 9); "piled", 45 % of the errors in bucket 0
and 45 % in bucket 2047 (phase 9's distribution, here at the cell's shape);
"init", the rows from 0.1 x randn logits, the near-uniform softmax of an
untrained net; "smooth", the rows from 0.1 x randn logits at stride 8
upsampled bilinearly, as a net at random weights gives them (neighbouring
pixels' errors nearly equal). It holds every variant's counts and sums equal to the
committed kernel's and those to the plain version, then times them in
turns (the variants, then in reverse; median of `reps`) twice: the whole C
entry call with the zeroing of its outputs (CUDA events), then the
kernel's own device time (torch.profiler). It prints each build's
registers (ptxas) and its shared-memory atomics by SASS opcode
(cuobjdump). It runs on the card only.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    N_BUCKETS, _check, _hist_lib, _ptr, b3_plan, bucket_stats_plain, resident,
    run_plan, set_argtypes, stream_ptr)

CELL = (8, 544, 960)        # (N, H, W) of the HRNetv2 cell's logits
N_CLS = 17
CASES = ("cell", "piled", "init", "smooth")


# Each variant is a list of (text of the committed source, its replacement).
# The committed kernel keeps one design; these put one part of it back to
# the first design's.
INT_UNITS = (
    ("""  return static_cast<long long>(__fmul_rn(v, scale));""",
     """  const unsigned h = __float_as_uint(v) >> 16;
  const unsigned long long mant = (h & 0x7Fu) | 0x80u;
  const int sh = static_cast<int>((h >> 7) & 0xFFu) - (scale == 0x1p48f ? 86 : 116);
  const unsigned long long mag = sh >= 0 ? mant << sh : mant >> min(-sh, 8);
  return static_cast<long long>((h & 0x8000u) ? 0ull - mag : mag);"""),
    ("""  return static_cast<int>(__fmul_rn(v, 0x1p18f));""",
     """  const unsigned h = __float_as_uint(v) >> 16;
  return static_cast<int>(((h & 0x7Fu) | 0x80u) << (((h >> 7) & 0xFFu) - 116));"""),
)
FP64_UNITS = (
    ("""  return static_cast<long long>(__fmul_rn(v, scale));""",
     """  return static_cast<long long>(static_cast<double>(v) * scale);"""),
    ("""  return static_cast<int>(__fmul_rn(v, 0x1p18f));""",
     """  return static_cast<int>(static_cast<double>(v) * 0x1p18);"""),
)
# every hot pair through the side bins' 64-bit shared atomics
NO_HOT_BINS = (
    ("    if (b == 0 && e >= 0.0f) {", "    if (false) {"),
    ("    } else if (b == kLast && v == 1.0f) {", "    } else if (false) {"),
)
# buckets 1..2046 sum their units in 64 bits: a 48 KB table, which must be
# dynamic shared memory
SMEM64 = "4096 * 12"
SHARED64 = (
    ("  int* off;                 // (kBins,): their offset sums",
     "  unsigned long long* off;"),
    ("  __shared__ int s_cnt[bk::kBins];\n  __shared__ int s_off[bk::kBins];\n",
     "  extern __shared__ int s_cnt[];\n"
     "  auto* s_off = reinterpret_cast<unsigned long long*>(s_cnt + bk::kBins);\n"),
    ("  atomicAdd(t.off + k, mid_units(v) - 128 * b);",
     "  atomicAdd(t.off + k, static_cast<unsigned long long>(mid_units(v)));"),
    ("      s = 128ull * b * static_cast<unsigned>(c)\n"
     "          + static_cast<unsigned long long>(static_cast<long long>(t.off[i]));",
     "      s = t.off[i];"),
    ("}  // namespace\n",
     "cudaError_t opt_in(Kernel kern) {\n"
     "  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     f"                              {SMEM64});\n"
     "}\n\n}  // namespace\n"),
    ("  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);",
     "  err = opt_in(kern);\n  if (err != cudaSuccess) return err;\n"
     "  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,\n"
     f"                                                      {SMEM64});"),
    ("  kern<<<dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(rows)), kThreads, 0,",
     "  err = opt_in(kern);\n  if (err != cudaSuccess) return err;\n"
     "  kern<<<dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(rows)), kThreads,\n"
     f"         {SMEM64},"),
)
# a lane's run of equal bins added at once
RUN_MERGE = (
    ("struct Lane {\n", "struct Lane {\n  int key = -1, run_n = 0, run_off = 0;\n"),
    ("  atomicAdd(t.cnt + k, 1);\n  atomicAdd(t.off + k, mid_units(v) - 128 * b);\n",
     "  if (k != ln.key) {\n"
     "    if (ln.run_n) {\n"
     "      atomicAdd(t.cnt + ln.key, ln.run_n);\n"
     "      atomicAdd(t.off + ln.key, ln.run_off);\n"
     "    }\n"
     "    ln.key = k;\n    ln.run_n = 0;\n    ln.run_off = 0;\n"
     "  }\n"
     "  ln.run_n += 1;\n"
     "  ln.run_off += mid_units(v) - 128 * b;\n"),
    ("  const int warp = threadIdx.x >> 5;\n",
     "  if (ln.run_n) {\n"
     "    atomicAdd(t.cnt + ln.key, ln.run_n);\n"
     "    atomicAdd(t.off + ln.key, ln.run_off);\n"
     "  }\n"
     "  const int warp = threadIdx.x >> 5;\n"),
)
# one error and one flag a load, block-strided over the block's pixels
SCALAR_LOADS = (
    ("  for (int v = v_lo + threadIdx.x; v < v_hi; v += kThreads) {",
     "  const int lo = first ? 0 : head + 4 * min(v_lo, n_vec);\n"
     "  const int hi = last ? p : head + 4 * v_hi;\n"
     "  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {\n"
     "    add_pixel(__ldg(e_row + j), __ldg(f_row + j) != 0, ln, t);\n  }\n"
     "  for (int v = v_hi; v < v_hi; ++v) {"),
    ("  if (edge >= 0) add_pixel(", "  if (false) add_pixel("),
)
THREADS = "constexpr int kThreads = 512;"
EDITS = {
    "no_hot_bins": NO_HOT_BINS,
    "shared64": SHARED64,
    "fp64_units": FP64_UNITS,
    "int_units": INT_UNITS,
    "run_merge": RUN_MERGE,
    "scalar_loads": SCALAR_LOADS,
    "occupancy3": (("constexpr int kMinBlocks = 2048 / kThreads;",
                    "constexpr int kMinBlocks = 1536 / kThreads;"),),
    "t256": ((THREADS, THREADS.replace("512", "256")),),
    "t1024": ((THREADS, THREADS.replace("512", "1024")),),
}


def row_plans(rows: int, resident: int) -> dict:
    """Blocks per row of the launch-plan variants, on the committed build."""
    one = max(1, resident // rows)
    return {"waves2": max(1, 2 * resident // rows), "ceil_wave": -(-resident // rows),
            "rows_x0.5": max(1, one // 2)}


def inputs(name: str, dev):
    """(errors (17, 8·544·960) float32, fg bool) of a CASES row, seeded by
    its name."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_rows)

    seed = sum(map(ord, name))
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n, h, w = CELL
    if name == "piled":
        shape = (N_CLS, n * h * w)
        u = torch.rand(shape, generator=gen, device=dev)
        which = torch.rand(shape, generator=gen, device=dev)
        e = torch.where(which < 0.45, u * (2.0 ** -11) * 0.999,
                        torch.where(which < 0.9, 1.0 - u * 2.0 ** -12, u))
        return e.contiguous(), torch.rand(shape, generator=gen, device=dev) < 0.3
    if name == "smooth":
        coarse = 0.1 * torch.randn((n, N_CLS, h // 8, w // 8), generator=gen, device=dev)
        logits = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                                 align_corners=False)
    else:
        std = 0.1 if name == "init" else 3.0
        logits = std * torch.randn((n, N_CLS, h, w), generator=gen, device=dev)
    grid = rng.integers(0, N_CLS + 1, (n, -(-h // 8), -(-w // 8)))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w]
    e, fg, _ = lovasz_rows(logits, torch.as_tensor(labels, device=dev))
    return e.contiguous(), fg.contiguous()


def _nvcc(src: pathlib.Path, include: pathlib.Path, so: pathlib.Path):
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{include}", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def registers(log: str) -> list[str]:
    """ptxas' 'Used N registers ...' lines of a build log."""
    return [line.split("ptxas info    : ")[-1] for line in log.splitlines()
            if "Used" in line and "registers" in line]


def shared_atomics(so: pathlib.Path) -> dict:
    """The library's shared-memory atomic instructions by SASS opcode
    (cuobjdump -sass), or a note where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or str(pathlib.Path(build._nvcc()).with_name("cuobjdump"))
    if not pathlib.Path(tool).exists():
        return {"cuobjdump": "not found"}
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True)
    ops = re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", out.stdout)
    return dict(collections.Counter(ops))


def build_variants(parent: pathlib.Path | None) -> tuple[dict, dict]:
    """nvcc every edited source (and the parent's) at once with the
    library's flags; ({name: handle}, {name: (registers, SASS atomics)}).
    Raises where an edit no longer matches the committed source."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "bucket_hist.cu").read_text()
    procs = {"full": _nvcc(build.CSRC / "bucket_hist.cu", build.CSRC,
                           out_dir / "bucket_hist_full.so")}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"bucket_hist_{name}.cu"
        cu.write_text(text)
        procs[name] = _nvcc(cu, build.CSRC, out_dir / f"bucket_hist_{name}.so")
    if parent is not None:
        csrc = parent / "miccai2021_cataract_semantic_segmentation_tpu_torch" / "kernels" / "csrc"
        procs["parent"] = _nvcc(csrc / "bucket_hist.cu", csrc, out_dir / "bucket_hist_parent.so")
    libs, info = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        so = out_dir / f"bucket_hist_{name}.so"
        libs[name] = ctypes.CDLL(str(so))
        info[name] = {"registers": registers(log), "shared_atomics": shared_atomics(so)}
        if name == "parent":
            vp = ctypes.c_void_p
            libs[name].bucket_hist_fwd.argtypes = [vp, vp, ctypes.c_int, ctypes.c_longlong,
                                                   vp, vp, ctypes.c_int, vp]
            libs[name].bucket_hist_fwd.restype = ctypes.c_int
        else:
            set_argtypes(libs[name])
    return libs, info


def _stats(lib, plan, e, fg):
    counts = torch.zeros((e.shape[0], 2, N_BUCKETS), dtype=torch.int32, device=e.device)
    sums = torch.zeros((e.shape[0], 2, N_BUCKETS), dtype=torch.int64, device=e.device)
    run_plan(lib, plan, e, fg, counts, sums)
    return counts, sums


def _parent_stats(lib, e, fg):
    """The parent's C entry: the same inputs, no plan."""
    counts = torch.zeros((e.shape[0], 2, N_BUCKETS), dtype=torch.int32, device=e.device)
    sums = torch.zeros((e.shape[0], 2, N_BUCKETS), dtype=torch.int64, device=e.device)
    err = lib.bucket_hist_fwd(_ptr(e), _ptr(fg), e.shape[0], e.shape[1], _ptr(counts),
                              _ptr(sums), e.device.index, stream_ptr(e.device))
    if err != 0:
        raise RuntimeError(f"parent bucket_hist failed with cudaError {err}")
    return counts, sums


def _median_ms(fn, reps: int) -> float:
    """The median over `reps` of one call's time in CUDA events: the C
    entry with its two output memsets, launch overhead included."""
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


def _kernel_ms(fn, reps: int) -> float:
    """The median over `reps` calls of the B3 kernel's own device time
    (torch.profiler), the memsets and the host's share left out."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and "bucket_hist_kernel" in ev.name]
    if len(times) != reps:
        raise RuntimeError(f"the profile holds {len(times)} B3 kernels, not {reps}")
    return statistics.median(times) / 1e3


def runners(libs, e, fg) -> dict:
    """Each variant's call at one input, and its plan (None for the parent)."""
    rows, p = e.shape
    dev = e.device.index
    out = {}
    for name, lib in libs.items():
        if name == "parent":
            out[name] = (lambda lib=lib: _parent_stats(lib, e, fg)), None
            continue
        plan = b3_plan(rows, p, *resident(lib, dev))
        out[name] = (lambda lib=lib, plan=plan: _stats(lib, plan, e, fg)), plan
    blocks, threads = resident(libs["full"], dev)
    for name, per_row in row_plans(rows, blocks).items():
        plan = b3_plan(rows, p, blocks, threads, per_row=per_row)
        out[name] = (lambda plan=plan: _stats(libs["full"], plan, e, fg)), plan
    return out


def hot_shares(counts: torch.Tensor) -> dict:
    """The share of pairs in each of the four hot bins."""
    total = int(counts.sum())
    return {f"{half}_{b}": int(counts[:, h, b].sum()) / total
            for h, half in enumerate(("bg", "fg")) for b in (0, N_BUCKETS - 1)}


def main(reps: int = 20, parent: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    _hist_lib()     # the committed library, built as the wrapper builds it
    libs, info = build_variants(pathlib.Path(parent) if parent else None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for name, item in info.items():
        print(f"build {name}: {json.dumps(item)}", flush=True)
    result = {"card": card, "builds": info}
    for case in CASES:
        e, fg = inputs(case, dev)
        _check(e, fg)
        calls = runners(libs, e, fg)
        ref = calls["full"][0]()
        plain = bucket_stats_plain(e, fg)
        if not (torch.equal(ref[0], plain[0]) and torch.equal(ref[1], plain[1])):
            raise AssertionError(f"{case}: the committed kernel differs from the plain version")
        for name, (fn, plan) in calls.items():
            got = fn()
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"{case} {name}: counts or sums differ from the "
                                     "committed kernel's")
            if plan is not None:
                print(f"{case} {name}: plan {plan}", flush=True)
        print(f"{case}: hot-bin shares {json.dumps(hot_shares(ref[0]))}", flush=True)
        order = list(calls) + list(calls)[::-1]
        times, kernel = {}, {}
        for name in order:
            times.setdefault(name, []).append(_median_ms(calls[name][0], reps))
        for name in order:
            kernel.setdefault(name, []).append(_kernel_ms(calls[name][0], reps))
        print(f"{case} call ms, C entry with output zeroing (CUDA events; two "
              f"turns): {json.dumps(times)}", flush=True)
        print(f"{case} kernel ms (profiler; two turns): {json.dumps(kernel)}",
              flush=True)
        result[case] = {"call_ms": times, "kernel_ms": kernel}
        del e, fg, ref, plain
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
