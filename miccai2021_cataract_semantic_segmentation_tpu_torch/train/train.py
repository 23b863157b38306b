"""Train steps over index batches from arrays in memory — the numeric
core of the Trainer's epoch loop (train/trainer.py:Trainer.train).

`train_steps` builds the loss, the device spec, the LR schedule, the
optimiser and the train step from a run config, runs the given index
batches through the step, accumulates the confusion matrix and the loss on
the device, and returns the epoch's train metrics. `Trainer.train` runs
the same step over the frames on disk, with the samplers, the schedule
over epochs, TensorBoard, validation, checkpoints and resume.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (
    mean_iou_breakdown, pixel_accuracy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step


def uses_bucket_lovasz(loss_cfg) -> bool:
    """True when any nested loss config selects the fused bucket Lovász."""
    if not isinstance(loss_cfg, dict):
        return False
    if loss_cfg.get("lovasz_impl") == "bucket":
        return True
    return any(uses_bucket_lovasz(v) for v in loss_cfg.values()
               if isinstance(v, dict))


def train_metrics_source(config: dict) -> str:
    """The Trainer's train-metric source: `train_metrics` when the config
    sets it, else "s8" with the fused bucket Lovász and "full" otherwise."""
    return config.get("train_metrics") or \
        ("s8" if uses_bucket_lovasz(config.get("loss") or {}) else "full")


def has_point_head(graph: dict) -> bool:
    """Whether a graph config has a PointRend decoder (the JAX Trainer's
    `has_points`): the PointRend shorthand, or an EncDec whose decoder is
    PointRend."""
    return graph.get("model") == "PointRend" or \
        (graph.get("decoder") or {}).get("model") == "PointRend"


def train_steps(model: torch.nn.Module, config: dict, images: np.ndarray,
                labels: np.ndarray, batches, *,
                device: str | torch.device = "cuda", seed: int = 0,
                epoch: int = 0) -> dict:
    """Train `model` in place on uint8 `images` (n, H, W, 3) and task-space
    uint8 `labels` (n, H, W), one step per index batch of `batches`, under
    `config` (graph/loss/data/train/precision keys of a run config). The
    LR schedule counts `len(batches)` steps per epoch.

    Returns the epoch's train metrics as the Trainer reports them (`loss`,
    the mean of the step losses; `miou` and `pa` of the summed confusion
    matrix), plus `step_losses`, `confusion_matrix` (int64), `seconds` and
    `frames_per_s` (host clock around the steps, ended by a device
    synchronise), and the `state` (train/state.py) after the last step."""
    dev = resolve_device(device)
    task = int(config["data"]["experiment"])
    loss_cfg = config.get("loss") or {"name": "CrossEntropyLoss"}
    loss_fn = build_loss(loss_cfg, task, dev)
    pipeline = build_transform_pipeline(config["data"].get("transforms", []),
                                        config["data"].get("transform_values", {}), task)
    if pipeline.host_train:
        raise ValueError("train_steps runs in-memory batches through the device "
                         "augmentation only; Trainer.train runs the host transforms")
    spec = pipeline.device
    state = create_train_state(model, config["train"],
                               make_schedule(config["train"], len(batches)))
    step = make_train_step(loss_fn, spec, task, device=dev,
                           precision=config.get("precision", "bf16"),
                           train_metrics=train_metrics_source(config),
                           seed=seed,
                           has_point_head=has_point_head(config.get("graph", {})))
    losses, cm_total = [], None
    n_frames = 0
    t0 = time.perf_counter()
    for idx in batches:
        m = step(state, images[idx], labels[idx], epoch)
        losses.append(m["loss"])
        cm_total = m["confusion_matrix"] if cm_total is None \
            else cm_total + m["confusion_matrix"]
        n_frames += len(idx)
    step_losses = torch.stack(losses).double().cpu().numpy()   # synchronises
    seconds = time.perf_counter() - t0
    cm = cm_total.cpu().numpy().astype(np.int64)
    bd = mean_iou_breakdown(cm, task)
    pa, _ = pixel_accuracy(cm)
    return {"epoch": epoch, "loss": float(step_losses.mean()),
            "miou": float(bd["miou"]), "pa": float(pa),
            "step_losses": step_losses.tolist(), "confusion_matrix": cm,
            "seconds": seconds, "frames_per_s": n_frames / seconds,
            "state": state}
