"""Where B1's time goes on the card: the committed kernel beside edited
builds of the same source, other launch plans, and the parent commit's B1.

    git archive 72f9455 | tar -x -C build/parent    # once, for the parent
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_hist_ablation \\
        [--parent build/parent] [--sweep]

It builds kernels/csrc/fu_hist.cu as committed and edited copies into
build/kernels/ablation/ (a directory .gitignore lists), and the parent's
fu_hist.cu where --parent names a checkout of it:

    full              the committed kernel and its default plan;
    no_hot_bins       one shared atomic per (pixel, row): no register
                      counters for bucket 0 of the bg half;
    warp_aggregate    the register counters, and the other pairs' atomics
                      aggregated over the warp (__match_any_sync, one
                      leader adding its group's __popc);
    no_staging        the committed kernel without the staged source
                      window: every pixel reads its taps from global memory;
    split2_recompute  the rows of a scale split over two blocks that each
                      compute every pixel's softmax (the first design's
                      layout at B 2048);
    cluster2, cluster4  the rows shared by a cluster of 2 or 4 blocks, each
                      pixel computed once, partners' counts added into their
                      shared memory;
    parent            the parent commit's B1 (one block per SM, int32 bins,
                      a shared atomic per pair);
    --sweep adds the default layout at other block sizes and tile heights.

At the flagship's shape (N 8, 2 x 17 rows, 68 x 120 -> 544 x 960, B 1024,
align_corners=True), the UPerNet cell's (N 8, 17 rows, 136 x 240 -> 544 x
960, B 2048, align_corners=False) and the flagship's with peaked logits
(std 3 plus 15 on the class of the label under each source cell, as a net
that has learnt), it holds every variant's counts equal to the committed
kernel's, then times them in turns (the variants, then in reverse; CUDA
events, median of `reps`). It runs on the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    TILE_H, _check, _fu_lib, _ptr, b1_layout, b1_plan, b1_window, bucket_params,
    fu_mats, max_threads, resident_blocks, run_plan, set_argtypes, stream_ptr)

# name: N, C, source (hs, ws), output (H, W), B, align_corners, peaked
CASES = {
    "flagship": (8, 17, (68, 120), (544, 960), 1024, True, False),
    "upernet_acf": (8, 17, (136, 240), (544, 960), 2048, False, False),
    "peaked": (8, 17, (68, 120), (544, 960), 1024, True, True),
}
HOT = "constexpr bool kHotBins = true;"
ATOMIC = ("          atomicAdd(hist + (add ? (c - r_lo) * nb + (half >> 1) : words + lane), "
          "one);")
AGGREGATE = """          const unsigned peers = __match_any_sync(0xFFFFFFFFu, add ? half : -1);
          if (add && lane == __ffs(peers) - 1) {
            atomicAdd(hist + (c - r_lo) * nb + (half >> 1), __popc(peers) << ((half & 1) << 4));
          }"""
EDITS = {
    "no_hot_bins": ((HOT, HOT.replace("true", "false")),),
    "warp_aggregate": ((ATOMIC, AGGREGATE),),
}
# b1_layout's keywords of the layout variants, run on the committed build
# (stage=False: no window)
PLANS = {
    "no_staging": dict(stage=False),
    "split2_recompute": dict(groups=2, cluster=False),
    "cluster2": dict(groups=2),
    "cluster4": dict(groups=4),
}
SWEEP = {f"t{threads}_h{tile_h}": dict(threads=threads, tile_h=tile_h)
         for threads in (256, 512, 1024) for tile_h in (8, 16, 32)}


def inputs(name: str, dev):
    """Seeded logits (N, S*C, hs, ws), the padded int32 labels and the
    taps of a CASES row (labels blocky on 8 x 8 tiles, C + 1 values)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        pad_labels)

    n, c, (hs, ws), (h, w), _, align, peaked = CASES[name]
    scales = 2 if align else 1
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
    return ls, lbl, mats


def _nvcc(src: pathlib.Path, include: pathlib.Path, so: pathlib.Path):
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{include}", "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_variants(parent: pathlib.Path | None) -> dict[str, ctypes.CDLL]:
    """nvcc every edited source (and the parent's) at once with the
    library's flags; their handles. Raises where an edit no longer matches
    the committed source."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "fu_hist.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"fu_hist_{name}.cu"
        cu.write_text(text)
        procs[name] = _nvcc(cu, build.CSRC, out_dir / f"fu_hist_{name}.so")
    if parent is not None:
        csrc = parent / "miccai2021_cataract_semantic_segmentation_tpu_torch" / "kernels" / "csrc"
        procs["parent"] = _nvcc(csrc / "fu_hist.cu", csrc, out_dir / "fu_hist_parent.so")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"fu_hist_{name}.so"))
    for name, lib in libs.items():
        if name == "parent":
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.fu_hist_fwd.argtypes = [vp] * 9 + [i] * 12 + [f, i, i, f, i, vp]
            lib.fu_hist_fwd.restype = ctypes.c_int
        else:
            set_argtypes(lib)
    return libs


def _parent_call(lib, ls, lbl, mats, c, nb):
    """The parent's C entry: the same inputs, no plan."""
    n, r_rows, hs, ws = ls.shape
    half, shift, q0, e_min, seed32, inv_b = bucket_params(nb, "uniform", 0)
    out = torch.zeros((r_rows, 2, nb), dtype=torch.int32, device=ls.device)
    err = lib.fu_hist_fwd(
        _ptr(ls), _ptr(lbl), _ptr(mats.h_lo), _ptr(mats.h_w0), _ptr(mats.h_w1),
        _ptr(mats.w_lo), _ptr(mats.w_w0), _ptr(mats.w_w1), _ptr(out), n,
        r_rows // c, c, hs, ws, *lbl.shape[1:], nb, 0, half, shift, q0, e_min, 0,
        seed32, inv_b, ls.device.index, stream_ptr(ls.device))
    if err != 0:
        raise RuntimeError(f"parent fu_hist failed with cudaError {err}")
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


def runners(libs, committed, ls, lbl, mats, c, nb, sweep: bool) -> dict:
    """Each variant's call at one case, and its plan (None for the parent)."""
    n, r_rows = ls.shape[:2]
    dev = ls.device.index
    kw = dict(n_cls=c, n_buckets=nb, edges="uniform", seed=0, dither=False)

    def planned(lib, stage=True, tile_h=TILE_H, **layout_kw):
        window = b1_window(mats, tile_h) if stage else (0, 0)
        layout = b1_layout(c, nb, window, tile_h=tile_h, **layout_kw)
        plan = b1_plan(layout, n, r_rows // c, *lbl.shape[1:],
                       resident=resident_blocks(lib, layout, dev))
        return (lambda: run_plan(lib, plan, ls, lbl, mats, **kw)), plan

    out = {"full": planned(committed)}
    for name in EDITS:
        out[name] = planned(libs[name])
    for name, layout_kw in PLANS.items():
        out[name] = planned(committed, **layout_kw)
    if sweep:
        for name, layout_kw in SWEEP.items():
            if layout_kw["threads"] <= max_threads(c):
                out[name] = planned(committed, **layout_kw)
    if "parent" in libs:
        out["parent"] = (lambda: _parent_call(libs["parent"], ls, lbl, mats, c, nb)), None
    return out


def hot_shares(counts: torch.Tensor) -> dict:
    """The share of counted pairs in the two hottest bins of each half."""
    total = int(counts.sum())
    out = {}
    for half, name in enumerate(("bg", "fg")):
        per_bin = counts[:, half].sum(0)
        top = per_bin.topk(2)
        out[name] = {f"bin_{int(i)}": float(v) / total for v, i in zip(*top)}
    return out


def main(reps: int = 20, parent: str | None = None, sweep: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    committed = _fu_lib()
    libs = build_variants(pathlib.Path(parent) if parent else None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    result = {}
    for case, (n, c, _, _, nb, *_) in CASES.items():
        ls, lbl, mats = inputs(case, dev)
        _check(ls, lbl, mats, c)
        calls = runners(libs, committed, ls, lbl, mats, c, nb, sweep)
        ref = calls["full"][0]()
        for name, (fn, plan) in calls.items():
            got = fn()
            if not torch.equal(got, ref):
                raise AssertionError(f"{case} {name}: counts differ from the "
                                     "committed kernel's")
            if plan is not None:
                print(f"{case} {name}: plan {plan}", flush=True)
        print(f"{case}: hot-bin shares {json.dumps(hot_shares(ref))}", flush=True)
        order = list(calls) + list(calls)[::-1]
        times = {}
        for name in order:
            times.setdefault(name, []).append(_median_ms(calls[name][0], reps))
        print(f"{case} ms (two turns): {json.dumps(times)}", flush=True)
        result[case] = times
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of the parent commit")
    parser.add_argument("--sweep", action="store_true",
                        help="also time other block sizes and tile heights")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    main(args.reps, args.parent, args.sweep)
