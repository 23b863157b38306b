"""Per-rank loss against one process: training twins over two gloo ranks,
or over a grid of data by model ranks (the port's counterpart of the
repository's tools/sharded_twins.py).

The train step over several ranks (train/steps.py, `group`) computes the
loss of each rank's rows and averages it over the ranks, as the JAX
package's step over a mesh does (`_sharded_loss`: DDP's semantics). The
reference's loss is the global batch's: its Lovász sort flattens the
whole batch. At one rank the two coincide; at N ranks the per-class
Lovász terms are computed over batch/N-sized shards and averaged, which is
not the same number (Lovász is not additive over partitions of a batch).

This tool runs two identical trainings, the same init, data and
augmentation draws, differing only in the ranks: one process, and two
gloo ranks (parallel/launch.py), both on the card (`--device`, cuda by
default; two ranks share it, as gloo allows) or with `--device cpu` on the
host. It reports the loss trajectories' and the parameters' distances
under the keys of the JAX tool's report:

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.sharded_twins \
        [--tiny] [--steps N] [--buckets B] [--device cuda|cuda:N|cpu] \
        [--grid D,M] [--out PATH]

`--grid D,M` runs the sharded arm on a grid of D data by M model ranks
(parallel/spatial.py: each model rank holds a band of every activation's
rows), the JAX tool's (4, 2) layout on the host, (1, 2) on one card; the
report then also holds the grid's largest loss difference from D data
ranks alone (`max_abs_grid_vs_data_ranks`), which run beside it.

The tiny path (OCRNet-R18, 64x128, batch 8) is tests/test_torch_parallel.py's
guard. `arm` and `sharded_arm` also run the port's side of that file's
float64 steps against the JAX package's steps over a 2-device mesh.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.dist import (
    DataGroup, init_from_env)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.spatial import Grid
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.trajectory_twins import (
    make_learnable_frames)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step

TASK = 2


def twin_config(backbone: str, n_buckets: int, lr: float = 1e-4) -> dict:
    """The JAX tool's run: OCRNet at output stride 8, the two-scale bucket
    Lovász, flip and colour jitter, Adam, float32."""
    return {"graph": {"model": "OCRNet", "backbone": backbone, "out_stride": 8},
            "loss": {"name": "TwoScaleLoss", "lovasz_impl": "bucket",
                     "lovasz_buckets": n_buckets,
                     "interm": {"name": "LovaszSoftmax", "weight": 0.4},
                     "final": {"name": "LovaszSoftmax", "weight": 1.0}},
            "transforms": ["flip", "colorjitter"],
            "train": {"epochs": 50, "learning_rate": lr}, "precision": "fp32"}


def arm(model: torch.nn.Module, cfg: dict, batches, n_steps: int, *,
        device: str | torch.device = "cuda", group: DataGroup | None = None,
        draws=None, seed: int = 1) -> dict:
    """Train `model` (on `device`) in place for `n_steps` steps over the
    global batches `batches` ((images, labels) pairs, in turn), each rank
    of `group` on its rows; `draws` (one AugmentDraws of the global batch a
    step) replace the step's own. Returns every step's loss, the first
    step's metrics and the final state dict, on the CPU."""
    loss_fn = build_loss(cfg["loss"], TASK, device)
    state = create_train_state(model, cfg["train"], make_schedule(
        cfg["train"], cfg.get("steps_per_epoch", 100)))
    step = make_train_step(loss_fn, device_spec(cfg["transforms"]), TASK, device=device,
                           precision=cfg["precision"], train_metrics="s8", seed=seed,
                           group=group, semi=cfg.get("semi"))
    losses, first = [], None
    for i in range(n_steps):
        images, labels = batches[i % len(batches)]
        rows = slice(None) if group is None else group.local_rows(len(images))
        m = step(state, images[rows], labels[rows], 0,
                 draws=None if draws is None else draws[i])
        losses.append(float(m["loss"]))
        if first is None:
            first = {k: v.detach().cpu() for k, v in m.items()}
    return {"losses": losses, "metrics": first,
            "state_dict": {k: v.detach().cpu().clone()
                           for k, v in model.state_dict().items()}}


def arm_on_rank(payload: dict) -> dict:
    """`arm` on this rank of the process group, from `payload` (cfg,
    state_dict, batches, n_steps, device; optional dtype, draws, seed,
    grid): the model built for cfg["graph"] on `device` in `dtype` with
    `state_dict` loaded, the data group over the global batch (its
    labelled half in semi mode), or the payload's (D, M) grid."""
    cfg, device = payload["cfg"], payload["device"]
    model = build_model(cfg["graph"], TASK, device=device).to(
        payload.get("dtype", torch.float32))
    model.load_state_dict(payload["state_dict"], strict=True)
    batch = len(payload["batches"][0][0]) // (2 if cfg.get("semi") else 1)
    world = init_from_env(device)
    group = Grid.of(world, payload["grid"]) if payload.get("grid") else \
        DataGroup.of(world, batch)
    return arm(model, cfg, payload["batches"], payload["n_steps"], device=device,
               group=group, draws=payload.get("draws"), seed=payload.get("seed", 1))


def _rank(rank: int, world: int, path: str) -> dict:
    return arm_on_rank(torch.load(path, weights_only=False))


def sharded_arms(payloads: list[tuple[dict, int]], timeout: float = 300.0) -> list:
    """`arm_on_rank` of each (payload, world) on its own `world` gloo ranks,
    all started together: each run's ranks' results (every rank on its
    payload's device)."""
    with tempfile.TemporaryDirectory(prefix="cadis_twins_") as tmp:
        runs = []
        try:
            for i, (payload, world) in enumerate(payloads):
                path = pathlib.Path(tmp) / f"payload{i}.pt"
                torch.save(payload, path)
                runs.append(Ranks("miccai2021_cataract_semantic_segmentation_tpu_torch."
                                  "tools.sharded_twins:_rank", world, path))
            return [r.results(timeout) for r in runs]
        finally:
            for r in runs:
                r.close()


def sharded_arm(payload: dict, world: int = 2, timeout: float = 300.0) -> list[dict]:
    """`arm_on_rank` on `world` gloo ranks: each rank's result."""
    return sharded_arms([(payload, world)], timeout)[0]


def compare_sharded(*, backbone: str, h: int, w: int, bs: int, n_pool: int,
                    n_steps: int, n_buckets: int = 1024, world: int = 2,
                    data_seed: int = 0, seed: int = 0,
                    device: str | torch.device = "cuda", grid=None) -> dict:
    """The one-process and the `world`-rank runs on `device` from the same
    seed-`seed` model over the same learnable frames; the JAX tool's
    report. With `grid` (D, M) the sharded arm runs on that grid, and D
    data ranks run beside it for `max_abs_grid_vs_data_ranks`."""
    device = str(resolve_device(device))
    rng = np.random.default_rng(data_seed)
    pool_i, pool_l = make_learnable_frames(rng, n_pool, h, w, 17)
    batches = [(pool_i[k:k + bs], pool_l[k:k + bs])
               for k in range(0, n_pool - bs + 1, bs)]
    cfg = twin_config(backbone, n_buckets)
    model = build_model(cfg["graph"], TASK, device=device, seed=seed)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    single = arm(model, cfg, batches, n_steps, device=device)
    t1 = time.perf_counter()
    payload = {"cfg": cfg, "state_dict": init, "batches": batches, "n_steps": n_steps,
               "device": device}
    if grid is None:
        sharded = sharded_arm(payload, world)
    else:
        world = int(grid[0])
        sharded, data_ranks = sharded_arms([(dict(payload, grid=list(grid)),
                                             int(grid[0]) * int(grid[1])),
                                            (payload, world)])
    t2 = time.perf_counter()
    print(f"# single: {n_steps} steps in {t1 - t0:.0f} s, loss {single['losses'][0]:.4f}"
          f" -> {single['losses'][-1]:.4f}; {world} ranks: {t2 - t1:.0f} s, loss "
          f"{sharded[0]['losses'][0]:.4f} -> {sharded[0]['losses'][-1]:.4f}",
          file=sys.stderr)
    l_1, l_n = np.asarray(single["losses"]), np.asarray(sharded[0]["losses"])
    d = np.abs(l_1 - l_n)
    p_1, p_n = single["state_dict"], sharded[0]["state_dict"]
    floats = [k for k, v in p_1.items() if v.is_floating_point()]
    sq = sum(float(((p_1[k].double() - p_n[k].double()) ** 2).sum()) for k in floats)
    nrm = sum(float((p_1[k].double() ** 2).sum()) for k in floats)
    tail = max(1, n_steps // 10)
    report = {
        "n_steps": n_steps, "n_buckets": n_buckets, "ranks": len(sharded), "device": device,
        "n_loss_shards": world,
        "step0_abs_divergence": float(d[0]),
        "loss_final_single": float(np.mean(l_1[-tail:])),
        "loss_final_sharded": float(np.mean(l_n[-tail:])),
        "final_tail_divergence": float(abs(np.mean(l_1[-tail:]) - np.mean(l_n[-tail:]))),
        "max_abs_loss_divergence": float(d.max()),
        "mean_abs_loss_divergence": float(d.mean()),
        "rel_param_distance": float(np.sqrt(sq / max(nrm, 1e-30))),
        "ranks_agree": all(s["losses"] == sharded[0]["losses"] for s in sharded),
        "losses_single": [round(v, 5) for v in l_1.tolist()],
        "losses_sharded": [round(v, 5) for v in l_n.tolist()],
    }
    if grid is not None:
        report["grid"] = [int(g) for g in grid]
        report["max_abs_grid_vs_data_ranks"] = float(
            np.abs(l_n - np.asarray(data_ranks[0]["losses"])).max())
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true", help="the test's shapes")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--buckets", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="where both arms run (default: cuda; cpu for the host)")
    ap.add_argument("--grid", default=None, metavar="D,M",
                    help="run the sharded arm on D data by M model ranks")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    grid = tuple(int(v) for v in args.grid.split(",")) if args.grid else None
    if args.tiny:
        r = compare_sharded(backbone="resnet18", h=64, w=128, bs=8, n_pool=16,
                            n_steps=args.steps or 30, n_buckets=args.buckets,
                            device=args.device, grid=grid)
    else:
        # the flagship's graph family at a CPU's size
        r = compare_sharded(backbone="resnet50", h=128, w=256, bs=8, n_pool=32,
                            n_steps=args.steps or 120, n_buckets=args.buckets,
                            device=args.device, grid=grid)
    out = json.dumps(r)
    print(out)
    if args.out:
        pathlib.Path(args.out).write_text(out + "\n")
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
