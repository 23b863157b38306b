"""Where B2's time goes on the card: the committed kernel beside edited
builds of the same source, other launch plans, and the parent commit's B2.

    git archive 46fed0c | tar -x -C build/parent    # once, for the parent
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation \\
        [--parent build/parent] [--sweep] [--out build/b2_ablation.json]

It builds kernels/csrc/fu_grad.cu as committed and edited copies into
build/kernels/ablation/ (a directory .gitignore lists), and the parent's
fu_grad.cu where --parent names a checkout of it:

    full          the committed kernel and its default plan;
    t512x2, t256x4  two blocks of 512 threads an SM, or four of 256,
                  instead of the plan's one of 1024 (narrower chunks);
    table_smem, table_global  the table staged in shared memory as bf16,
                  or read from global memory as float32 (at B 2048 the
                  table in shared memory takes half the threads);
    no_staging    the logits' taps read from global memory, the window
                  left unfilled (an edited build, the same plan);
    maxc24        the C 17 rows on the MAXC = 24 instance (an edited
                  build, one block of 512 threads: that instance's
                  register cap);
    column_lanes  the owners of neighbouring source columns in
                  neighbouring lanes (an edited build): their reads, one
                  upsampling step apart, conflict in the banks;
    halo_rows     each share recomputes the output rows above it instead
                  of the edge buffer (an edited build): the parent's
                  summation order too;
    blocks_x2, blocks_half  twice and half the blocks of one wave (shorter
                  shares, or idle SMs);
    no_pixels, no_width_taps  timing only, their gradients are not the
                  function's: every pixel takes the path of an ignored one
                  (no softmax, bucket id, gather or VJP), or no owner sums
                  width taps (edited builds): what is left is the rest of
                  the kernel;
    parent        the parent commit's B2 (two launches, the 71 MB row
                  buffer);
    --sweep adds the default plan at other block sizes and column chunks.

At the flagship's shape (N 8, 2 x 17 rows, 68 x 120 -> 544 x 960, B 1024,
align_corners=True), the UPerNet cell's (N 8, 17 rows, 136 x 240 -> 544 x
960, B 2048, align_corners=False), the flagship's with peaked logits and
the DeepLabv3 cell's (N 8, 17 rows, 68 x 120 -> 544 x 960, B 2048, one
scale, align_corners=True), with the table of a forward on the same inputs,
it holds every variant's gradient but the timing-only ones, the parent's
included, bit-equal to the committed kernel's (every plan keeps the
parent's summation order), then times them
in turns (the variants, then in reverse; CUDA events, median of `reps`),
then each build's kernels alone in the same turns (torch.profiler), and
prints each build's registers and spills (ptxas) and the float atomics
in its SASS (cuobjdump). It runs on the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (
    _grad_lib, b2_layout, b2_plan, resident_blocks, run_plan, set_argtypes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _check, _ptr, bucket_params, fu_mats, max_threads, stream_ptr)

# name: N, C, source (hs, ws), output (H, W), B, align_corners, scales, peaked
CASES = {
    "flagship": (8, 17, (68, 120), (544, 960), 1024, True, 2, False),
    "upernet_acf": (8, 17, (136, 240), (544, 960), 2048, False, 1, False),
    "peaked": (8, 17, (68, 120), (544, 960), 1024, True, 2, True),
    "deeplabv3": (8, 17, (68, 120), (544, 960), 2048, True, 1, False),
}
OWNER_AT = "owner_of(i, ncls, c, sl);\n"
# the logits' taps of a pixel from global memory, for no_staging
GLOBAL_TAPS = """\
            {
              const int plane = p.hs * p.ws;
              const int o00 = taps.r0 * p.ws + taps.s0;
              const int o10 = taps.r1 * p.ws + taps.s0;
              const int ds = taps.s1 - taps.s0;
#pragma unroll
              for (int c = 0; c < MAXC; ++c) {
                if (c < ncls) {
                  const float* lc = base + c * plane;
                  z[c] = fu::tap_combine(taps, __ldg(lc + o00), __ldg(lc + o10),
                                         __ldg(lc + o00 + ds), __ldg(lc + o10 + ds));
                }
              }
            }
"""
EDITS = {
    "maxc24": (("    if (n_cls == 17 && uniform) return fu_grad_kernel<17, true, true, false>;\n",
                ""),
               ("  if (n_cls == 17) return fu_grad_kernel<17, true, false, IDS>;\n", "")),
    "column_lanes": (("  sl = i / ncls;\n  c = i - sl * ncls;\n",
                      "  c = i / ns;\n  sl = i - c * ns;\n"),
                     ("void owner_of(int i, int ncls,", "void owner_of(int i, int ncls, int ns,"),
                     (OWNER_AT + "            const int u0",
                      OWNER_AT.replace("ncls,", "ncls, ns,") + "            const int u0"),
                     (OWNER_AT + "        float a",
                      OWNER_AT.replace("ncls,", "ncls, ns,") + "        float a")),
    "no_pixels": (("if (!__any_sync(kFull, lbl >= 0)) {", "if (true) {"),),
    "no_width_taps": (("const int u0 = xs[sl], cnt = xs[p.chunk_s + sl];",
                       "const int u0 = xs[sl], cnt = 0;"),),
    "no_staging": (("          if (lo_next != win_row) {\n", "          if (false) {\n"),
                   ("            const float* w00 = win + (taps.s0 - c_a) * cp;\n",
                    GLOBAL_TAPS + "            const float* w00 = win + (taps.s0 - c_a) * cp;\n"),
                   ("for (int c = 0; c < MAXC; c += 4) {\n              if (c < ncls) {",
                    "for (int c = 0; c < MAXC; c += 4) {\n              if (false) {")),
    "halo_rows": (("const bool edge_top = first && h0 > 0;", "const bool edge_top = false;"),
                  ("const bool edge_bot = r + (h1 - h0) == r_end && h1 < p.hs;",
                   "const bool edge_bot = false;"),
                  ("            const float t = __fmul_rn(hw0, d);\n",
                   "            if (lo < cc) {  // a row above the share, read by row cc\n"
                   "              acc[i] = __fadd_rn(a, __fmul_rn(hw1, d));\n"
                   "              continue;\n"
                   "            }\n"
                   "            const float t = __fmul_rn(hw0, d);\n"),
                  ("          cur = lo;\n", "          cur = max(cur, lo);\n")),
}
# (library, b2_layout keywords) of each variant; "full" is the default plan
VARIANTS = {
    "full": ("committed", {}),
    "t512x2": ("committed", dict(threads=512, per_sm=2)),
    "t256x4": ("committed", dict(threads=256, per_sm=4)),
    "table_smem": ("committed", dict(table_smem=True)),
    "table_global": ("committed", dict(table_smem=False)),
    "no_staging": ("no_staging", {}),
    "maxc24": ("maxc24", dict(threads=512, per_sm=1)),
    "column_lanes": ("column_lanes", {}),
    "halo_rows": ("halo_rows", {}),
    "blocks_x2": ("committed", dict(blocks=2.0)),
    "blocks_half": ("committed", dict(blocks=0.5)),
    "no_pixels": ("no_pixels", {}),
    "no_width_taps": ("no_width_taps", {}),
}
# diagnostic builds that leave work out: timed, their gradients not held
TIMING_ONLY = ("no_pixels", "no_width_taps")
SWEEP = {f"t{threads}_k{chunks}": ("committed", dict(threads=threads, chunks=chunks))
         for threads in (256, 512, 1024) for chunks in (1, 2, 4)}


def inputs(name: str, dev):
    """Seeded logits (N, S*C, hs, ws), the padded int32 labels, the taps and
    the bf16-rounded table of the loss (0.4 * interm + 1.0 * final over two
    scales; 1.0 * the loss over one) of a CASES row (labels blocky on 8 x 8
    tiles, C + 1 values)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fu_core_fwd, grad_table, losses_and_tables, pad_labels)

    n, c, (hs, ws), (h, w), nb, align, scales, peaked = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    logits = 3.0 * rng.standard_normal((n, scales, c, hs, ws))
    grid = rng.integers(0, c + 1, (n, -(-h // 8), -(-w // 8)))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w]
    if peaked:
        under = labels[:, ::8, ::8][:, :hs, :ws]
        logits += 15.0 * (under[:, None, None] == np.arange(c)[None, None, :, None, None])
    ls = torch.as_tensor(logits.reshape(n, scales * c, hs, ws), dtype=torch.float32,
                         device=dev)
    lbl = pad_labels(torch.as_tensor(labels, device=dev))
    mats = fu_mats(hs, ws, (h, w), lbl.shape[1], lbl.shape[2], align, dev)
    parts = list(ls.split(c, 1))
    _, gts, g_fg, g_bg = losses_and_tables(fu_core_fwd(parts, lbl, c, (h, w), nb, align))
    present = (gts > 0).float().reshape(scales, c)
    weights = torch.tensor([[0.4], [1.0]][2 - scales:], device=dev)
    ct = (weights * present / present.sum(1, keepdim=True).clamp_min(1.0)).reshape(-1)
    return ls, lbl, mats, grad_table(g_fg, g_bg, ct)


def _nvcc(src: pathlib.Path, include: pathlib.Path, so: pathlib.Path):
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{include}", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_variants(parent: pathlib.Path | None) -> tuple[dict, dict]:
    """nvcc every edited source (and the parent's) at once with the
    library's flags; their handles and ptxas logs. Raises where an edit no
    longer matches the committed source."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "fu_grad.cu").read_text()
    sources = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        sources[name] = out_dir / f"fu_grad_{name}.cu"
        sources[name].write_text(text)
    procs = {name: _nvcc(cu, build.CSRC, out_dir / f"fu_grad_{name}.so")
             for name, cu in sources.items()}
    if parent is not None:
        csrc = parent / "miccai2021_cataract_semantic_segmentation_tpu_torch" / "kernels" / "csrc"
        procs["parent"] = _nvcc(csrc / "fu_grad.cu", csrc, out_dir / "fu_grad_parent.so")
    libs, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        logs[name] = log
        libs[name] = ctypes.CDLL(str(out_dir / f"fu_grad_{name}.so"))
        if name == "parent":
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            libs[name].fu_grad_bwd.argtypes = [vp] * 16 + [i] * 12 + [f, i, i, f, i, vp]
            libs[name].fu_grad_bwd.restype = ctypes.c_int
        else:
            set_argtypes(libs[name])
    return libs, logs


def parent_call(lib, ls, lbl, mats, table, c, nb) -> torch.Tensor:
    """The parent's C entry (rows then columns, its (N, R, H_pad, ws) row
    buffer): the same inputs, uniform buckets, no dither."""
    n, r_rows, hs, ws = ls.shape
    h_pad, w_pad = lbl.shape[1:]
    half, shift, q0, e_min, seed32, inv_b = bucket_params(nb, "uniform", 0)
    rows = torch.empty((n, r_rows, h_pad, ws), dtype=torch.float32, device=ls.device)
    out = torch.empty((n, r_rows, hs, ws), dtype=torch.float32, device=ls.device)
    err = lib.fu_grad_bwd(
        _ptr(ls), _ptr(lbl), _ptr(mats.h_lo), _ptr(mats.h_w0), _ptr(mats.h_w1),
        _ptr(mats.h_beg), _ptr(mats.h_end), _ptr(mats.w_lo), _ptr(mats.w_w0),
        _ptr(mats.w_w1), _ptr(mats.w_beg), _ptr(mats.w_end), _ptr(table), _ptr(rows),
        _ptr(out), ctypes.c_void_p(None), n, r_rows // c, c, hs, ws, h_pad, w_pad, nb,
        0, half, shift, q0, e_min, 0, seed32, inv_b, ls.device.index,
        stream_ptr(ls.device))
    if err != 0:
        raise RuntimeError(f"parent fu_grad failed with cudaError {err}")
    return out


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


SPIN_CYCLES = 20_000_000    # about 10 ms of `torch.cuda._sleep` on an H100
PROFILE_TRIES = 4


def queued_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of `fn` from CUDA events around `reps`
    calls queued behind a spin kernel and `reps` more calls that warm the
    card up, so that the host's time per call is hidden: the device work
    of the calls and the short gaps between their launches. The spin grows
    fourfold until the host enqueues every call within it."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(PROFILE_TRIES):
        spin, spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        spin.record()
        torch.cuda._sleep(cycles)
        spun.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms < spin.elapsed_time(spun):
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError(f"the host took {enqueue_ms!r} ms to enqueue {2 * reps} calls, "
                       f"longer than a {spin.elapsed_time(spun)!r} ms spin")


def device_ms(fn, reps: int = 20, kernel: str = "fu_grad") -> float:
    """Device milliseconds per call of the kernels whose names hold `kernel`
    that `fn` launches (torch.profiler, the median of each kernel's
    launches, the parent's two summed): the kernels alone, without the
    call's host time. chip_smoke.py's phases 4 and 13 read B2's and B5-B8's
    shares with it.

    A profile is taken as the reading only where it agrees with the least
    `queued_ms` read so far, one before each profile (from 0.85 to 1.10 of
    it: the kernels are all but a few microseconds of a call's device
    work, under the profiler they run up to a few per cent slower, and a
    stall of the card inflates one queued reading, not the least): on the
    H100 the profiler now and then reports most of a session's kernels
    several times shorter than they run (B8's 0.0617 ms beside 0.39 by
    CUDA events), and now and then it records none of a session's kernel
    launches. Such a session is printed and profiled again, up to
    PROFILE_TRIES times."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    queued = float("inf")
    for _ in range(PROFILE_TRIES):
        queued = min(queued, queued_ms(fn, reps))
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times: dict = {}
        n_device = 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                n_device += 1
                if kernel in ev.name:
                    times.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        if not times or min(map(len, times.values())) < reps // 2:
            print(f"device_ms: a profile holds too few {kernel} launches "
                  f"({ {k: len(v) for k, v in times.items()} }, {n_device} device "
                  f"events in all)", flush=True)
            continue
        got = sum(statistics.median(v) for v in times.values()) / 1e3
        if 0.85 * queued <= got <= 1.10 * queued:
            return got
        print(f"device_ms: a profile of {kernel} read {got!r} ms against {queued!r} ms by "
              f"CUDA events over queued calls; its launches (us): {times}", flush=True)
    raise RuntimeError(f"{PROFILE_TRIES} profiles of {kernel} disagree with CUDA events "
                       f"({queued!r} ms) or hold too few of its launches")


def variant_layout(c: int, nb: int, columns: tuple, layout_kw: dict):
    """A variant's layout: `b2_layout` with its forced choices, and, where
    it forces the table into shared memory and the instance's full block
    leaves no room, half the threads."""
    layout_kw = {k: v for k, v in layout_kw.items() if k != "blocks"}
    try:
        return b2_layout(c, nb, columns, **layout_kw)
    except ValueError:
        if not layout_kw.get("table_smem") or "threads" in layout_kw:
            raise
        return b2_layout(c, nb, columns, threads=max_threads(c) // 2, **layout_kw)


def runners(libs, ls, lbl, mats, table, c, nb, sweep: bool) -> dict:
    """Each variant's call at one case, and its plan (None for the parent)."""
    n, r_rows, hs, _ = ls.shape
    dev = ls.device.index
    kw = dict(n_cls=c, n_buckets=nb, edges="uniform", seed=0, dither=False)

    def planned(lib, layout_kw):
        layout = variant_layout(c, nb, mats.columns, layout_kw)
        blocks = layout_kw.get("blocks", 1.0)
        resident = resident_blocks(lib, layout, dev)
        plan = b2_plan(layout, n, r_rows // c, hs, resident=max(int(resident * blocks), 1),
                       max_run=mats.row_run)
        return (lambda: run_plan(lib, plan, ls, lbl, mats, table, None, **kw)), plan

    variants = dict(VARIANTS, **(SWEEP if sweep else {}))
    out = {}
    for name, (lib, layout_kw) in variants.items():
        try:
            out[name] = planned(libs[lib], layout_kw)
        except ValueError as err:  # a sweep point that does not fit
            print(f"{name}: no plan ({err})", flush=True)
    if "parent" in libs:
        out["parent"] = (lambda: parent_call(libs["parent"], ls, lbl, mats, table, c, nb)), None
    return out


def registers(logs: dict) -> dict:
    """{build: {kernel instance: (registers, spill stores, spill loads)}}
    from the ptxas reports."""
    out = {}
    for name, log in logs.items():
        kernels, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur:
                kernels.setdefault(cur, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                kernels.setdefault(cur, [0, 0, 0])[0] = int(m.group(1))
        out[name] = {k: tuple(v) for k, v in kernels.items()}
    return out


def float_atomics(so: pathlib.Path) -> dict:
    """The float atomic and reduction instructions in a library's SASS, by
    opcode (cuobjdump -sass): RED/ATOM/ATOMG/ATOMS with an F32/F64/F16
    type."""
    tool = shutil.which("cuobjdump") or str(pathlib.Path(build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    ops = re.findall(r"\b((?:RED|ATOM|ATOMG|ATOMS)\.[A-Z0-9_.]*)", sass)
    return {op: ops.count(op) for op in sorted(set(ops))
            if re.search(r"F(16|32|64)|FADD|\.F\b", op)}


def main(reps: int = 20, parent: str | None = None, sweep: bool = False,
         cases=tuple(CASES)) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    committed = _grad_lib()
    libs, logs = build_variants(pathlib.Path(parent) if parent else None)
    libs["committed"] = committed
    logs["committed"] = build.lib_path("fu_grad").with_suffix(".log").read_text()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    regs = registers(logs)
    print(f"registers, spill stores, spill loads: {json.dumps(regs)}", flush=True)
    atomics = float_atomics(build.lib_path("fu_grad"))
    print(f"float atomics in the committed SASS: {json.dumps(atomics)}", flush=True)
    result = {"card": card, "registers": regs, "float_atomics": atomics}
    for case in cases:
        n, c, *_, nb = CASES[case][:5]
        ls, lbl, mats, table = inputs(case, dev)
        _check(ls, lbl, mats, c)
        calls = runners(libs, ls, lbl, mats, table, c, nb, sweep)
        ref = calls["full"][0]()
        for name, (fn, plan) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            rel = float((got - ref).norm() / ref.norm())
            print(f"{case} {name}: bit_equal={torch.equal(got, ref)} rel_l2={rel!r} "
                  f"plan {plan}", flush=True)
            if name not in TIMING_ONLY and not torch.equal(got, ref):
                raise AssertionError(f"{case} {name}: gradient differs from the "
                                     f"committed kernel's (relative L2 {rel})")
        order = list(calls) + list(calls)[::-1]
        times, alone = {}, {}
        for name in order:
            times.setdefault(name, []).append(_median_ms(calls[name][0], reps))
        for name in order:
            alone.setdefault(name, []).append(device_ms(calls[name][0], reps))
        print(f"{case} ms (two turns): {json.dumps(times)}", flush=True)
        print(f"{case} kernels alone, ms per call (profiler; two turns): "
              f"{json.dumps(alone)}", flush=True)
        result[case] = {"call_ms": times, "kernel_ms": alone}
        del ls, lbl, table, ref
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of the parent commit")
    parser.add_argument("--sweep", action="store_true",
                        help="also time other block sizes and column chunks")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", help="also write the result as JSON here")
    args = parser.parse_args()
    res = main(args.reps, args.parent, args.sweep)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
