"""Same-seed training twins: the exact sort Lovász against the bucket
Lovász (the port's counterpart of the repository's
tools/trajectory_twins.py).

The flagship recipe trains on the bucket approximation of the reference's
sort Lovász (losses/LovaszSoftmax.py:34-95). This tool runs two identical
trainings, the same initial weights, data and augmentation draws, that
differ only in `lovasz_impl` (sort or bucket), and reports how far their
loss trajectories and final weights drift apart after N steps. On the
card the bucket twin runs the fused stride-8 route (kernels B1 and B2, one
each a step); the sort twin runs no kernel.

The frames are learnable synthetic ones (colour-coded blobs whose colour
names the class), so both twins learn and the comparison covers a moving
loss surface, not a random-label plateau.

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.trajectory_twins \
        [--cpu-scale] [--steps N] [--buckets B] [--edges uniform|adaptive|adaptiveN] \
        [--dither] [--seed S] [--device cuda|cuda:N|cpu] [--out PATH]

The default is the bench workload (OCRNet-R50 os8, 540x960 frames padded
to 544x960, batch 8, bf16, 200 steps); `--cpu-scale` is the test-sized one
(OCRNet-R18, 64x128, batch 4, 30 steps). Both run on the card unless
`--device cpu` (the host runs float32). The report has the JAX tool's keys.
`run_twin` also takes a caller's initial weights and augmentation draws,
which is how tests/test_torch_trajectory_twins.py holds it against the
JAX tool.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    DeviceAugmentSpec)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step


def make_learnable_frames(rng: np.random.Generator, n: int, h: int, w: int,
                          num_classes: int):
    """(images u8 NHWC, labels u8 NHW): elliptical blobs whose colour
    identifies the class, learnable by any segmentation model."""
    palette = rng.integers(40, 255, (num_classes, 3)).astype(np.float32)
    imgs = np.zeros((n, h, w, 3), np.float32)
    lbls = np.zeros((n, h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        imgs[i] = palette[0]
        for _ in range(6):
            c = int(rng.integers(1, num_classes))
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(h / 10, h / 3), rng.uniform(w / 10, w / 3)
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            imgs[i][mask] = palette[c]
            lbls[i][mask] = c
    imgs += rng.normal(0, 8.0, imgs.shape)
    return np.clip(imgs, 0, 255).astype(np.uint8), lbls


def run_twin(impl: str, batches, *, backbone: str, n_steps: int, n_buckets: int,
             task: int = 2, lr: float = 1e-4, pad: bool = True, edges: str = "uniform",
             dither: bool = False, device: str | torch.device = "cuda",
             init: dict | None = None, draws=None, on_step=None):
    """One training run over `batches` ((images u8 NHWC, labels u8 NHW)
    pairs, in turn) on `device`: OCRNet at output stride 8 from the seed-0
    init, or from the state dict `init`; the JAX tool's two-scale Lovász
    (0.4 interm + 1.0 final); the device augmentation (pad, flip, blur,
    colour jitter) drawn by the train step, or `draws[i]` (an
    AugmentDraws) at step i; Adam at `lr` on the JAX tool's schedule; bf16
    on the card, float32 on the host. `on_step(i, metrics)`, where given,
    runs after each step. Returns (every step's loss, np.ndarray; the final
    parameters on the CPU: the JAX tool's `params`, BatchNorm's running
    statistics aside)."""
    dev = resolve_device(device)
    model = build_model({"model": "OCRNet", "backbone": backbone, "out_stride": 8},
                        task, device=dev)
    if init is not None:
        model.load_state_dict(init, strict=True)
    loss_fn = build_loss({"name": "TwoScaleLoss", "lovasz_impl": impl,
                          "lovasz_buckets": n_buckets, "lovasz_edges": edges,
                          "lovasz_dither": dither,
                          "interm": {"name": "LovaszSoftmax", "weight": 0.4},
                          "final": {"name": "LovaszSoftmax", "weight": 1.0}}, task, dev)
    spec = DeviceAugmentSpec(pad=pad, flip=True, blur=True, colorjitter=True)
    state = create_train_state(model, {}, make_schedule(
        {"epochs": 50, "learning_rate": lr}, 100))
    step = make_train_step(loss_fn, spec, task, device=dev,
                           precision="bf16" if dev.type == "cuda" else "fp32",
                           train_metrics="s8" if impl == "bucket" else "full", seed=1)
    losses = []
    for i in range(n_steps):
        images, labels = batches[i % len(batches)]
        m = step(state, images, labels, 0, draws=None if draws is None else draws[i])
        if on_step is not None:
            on_step(i, m)
        losses.append(m["loss"].detach())
    losses = torch.stack(losses).float().cpu().numpy()
    return losses, {k: v.detach().cpu().clone() for k, v in model.named_parameters()}


def rel_param_distance(a: dict, b: dict) -> float:
    """|a - b| / |a| over every tensor of two parameter dicts, in float64."""
    sq = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in a)
    nrm = sum(float((a[k].double() ** 2).sum()) for k in a)
    return float(np.sqrt(sq / max(nrm, 1e-30)))


def compare_twins(*, backbone: str, h: int, w: int, bs: int, n_pool: int,
                  n_steps: int, n_buckets: int, pad: bool = True, lr: float = 1e-4,
                  data_seed: int = 0, edges: str = "uniform", dither: bool = False,
                  device: str | torch.device = "cuda", on_step=None) -> dict:
    """Both twins from the same seed-0 init over the same learnable
    frames (`data_seed`), the dither on the bucket twin only; the JAX
    tool's report, with each twin's ms a step (host clock around the
    steps, synchronised) beside it. `on_step(impl, i, metrics)` runs
    after each step."""
    dev = resolve_device(device)
    rng = np.random.default_rng(data_seed)
    pool_i, pool_l = make_learnable_frames(rng, n_pool, h, w, 17)
    batches = [(pool_i[k:k + bs], pool_l[k:k + bs])
               for k in range(0, n_pool - bs + 1, bs)]
    results, ms = {}, {}
    for impl in ("sort", "bucket"):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        results[impl] = run_twin(
            impl, batches, backbone=backbone, n_steps=n_steps, n_buckets=n_buckets,
            pad=pad, lr=lr, edges=edges, dither=dither and impl == "bucket",
            device=dev, on_step=None if on_step is None else
            (lambda i, m, impl=impl: on_step(impl, i, m)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        ms[impl] = seconds * 1e3 / n_steps
        losses = results[impl][0]
        print(f"# {impl}: {n_steps} steps in {seconds:.0f}s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", file=sys.stderr)

    (l_sort, p_sort), (l_bucket, p_bucket) = results["sort"], results["bucket"]
    d = np.abs(l_sort - l_bucket)
    tail = max(1, n_steps // 10)
    return {
        "n_steps": n_steps,
        "n_buckets": n_buckets,
        "edges": edges,
        "dither": dither,
        "data_seed": data_seed,
        "device": str(dev),
        "loss_start_sort": float(l_sort[0]),
        "loss_final_sort": float(np.mean(l_sort[-tail:])),
        "loss_final_bucket": float(np.mean(l_bucket[-tail:])),
        "max_abs_loss_divergence": float(d.max()),
        "mean_abs_loss_divergence": float(d.mean()),
        "final_tail_divergence": float(abs(np.mean(l_sort[-tail:])
                                           - np.mean(l_bucket[-tail:]))),
        "rel_param_distance": rel_param_distance(p_sort, p_bucket),
        "ms_per_step_sort": ms["sort"],
        "ms_per_step_bucket": ms["bucket"],
        "losses_sort": [round(float(v), 5) for v in l_sort],
        "losses_bucket": [round(float(v), 5) for v in l_bucket],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu-scale", action="store_true",
                    help="tiny shapes (test-sized) instead of the bench workload")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--buckets", type=int, default=1024)
    ap.add_argument("--edges", type=str, default="uniform",
                    help="bucket-edge mode: uniform | adaptive | adaptiveN "
                         "(N = octave count, losses/bucket_edges.py)")
    ap.add_argument("--dither", action="store_true",
                    help="per-step stochastic bucket assignment on the bucket "
                         "twin (lovasz_dither, losses/bucket_edges.py)")
    ap.add_argument("--seed", type=int, default=0,
                    help="data seed (several seeds tighten the tail mean)")
    ap.add_argument("--device", default="cuda",
                    help="where both twins run (default: cuda; cpu for the host)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.cpu_scale:
        r = compare_twins(backbone="resnet18", h=64, w=128, bs=4, n_pool=8,
                          n_steps=args.steps or 30, n_buckets=args.buckets,
                          pad=False, lr=1e-3, edges=args.edges, data_seed=args.seed,
                          dither=args.dither, device=args.device)
    else:
        # the bench workload: OCRNet-R50 os8, 540x960 (padded 544), bs 8
        r = compare_twins(backbone="resnet50", h=540, w=960, bs=8, n_pool=32,
                          n_steps=args.steps or 200, n_buckets=args.buckets,
                          lr=1e-4, edges=args.edges, data_seed=args.seed,
                          dither=args.dither, device=args.device)
    out = json.dumps(r)
    print(out)
    if args.out:
        pathlib.Path(args.out).write_text(out + "\n")
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
