"""Batched validation — the numeric core of the JAX Trainer's `validate`.

Every record contributes to the confusion matrix at any batch size: the
tail batch is padded by repeating the last record and its padded rows are
masked with label 255 (counted nowhere). The validation loss is averaged
over the full batches only (the tail batch runs the eval step without the
loss); the matrix is accumulated in int64 on the host. `Trainer.validate`
(train/trainer.py) does the same from the frames on disk, with TensorBoard,
checkpoints and info.json.
"""
from __future__ import annotations

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device, taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import eval_batches
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (
    mean_iou_breakdown, pixel_accuracy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.dist import DataGroup
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import (  # noqa: F401
    load_config)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    eval_spec, make_eval_loss_step, make_eval_step)


def mask_tail_labels(labels: np.ndarray, n_real: int) -> np.ndarray:
    """Labels of a padded tail batch with the repeated rows set to 255."""
    lbl = np.asarray(labels).copy()
    lbl[n_real:] = 255
    return lbl


def sum_losses(losses: np.ndarray, n_pad: int) -> tuple[float, int]:
    """The sum, in batch order, of the batch losses of the full batches
    (all but a padded tail) and their number."""
    full = losses[:-1] if n_pad else losses
    total = 0.0
    for v in full:
        total += float(v)
    return total, len(full)


def validate(model, config: dict, images: np.ndarray, labels: np.ndarray,
             *, device: str | torch.device = "cuda",
             batch_size: int | None = None, epoch: int = 0,
             group: DataGroup | None = None) -> dict:
    """Validate `model` on uint8 `images` (n, H, W, 3) and task-space uint8
    `labels` (n, H, W) under `config` (graph/loss/data/precision keys of a
    run config). Returns the JAX Trainer's metric keys plus the int64
    `confusion_matrix`. Under a data group (parallel/dist.py) the batches
    go round the ranks, and the matrix and each batch's loss are summed
    over them: every rank returns the one-process metrics."""
    dev = resolve_device(device)
    task = int(config["data"]["experiment"])
    num_classes = taxonomy.TASK_NUM_CLASSES[task]
    spec = eval_spec(config["data"].get("transforms", []))
    precision = config.get("precision", "bf16")
    loss_fn = build_loss(config.get("loss") or {"name": "CrossEntropyLoss"},
                         task, dev)
    eval_step = make_eval_step(spec, num_classes, dev, precision)
    eval_loss_step = make_eval_loss_step(loss_fn, spec, dev, precision, num_classes)

    n = len(images)
    bs = min(batch_size or int(config.get("valid_batch_size") or 8), n)
    batches, n_pad = eval_batches(n, bs)
    group = group or DataGroup()
    cm_total = np.zeros((num_classes, num_classes), np.int64)
    losses = np.zeros(len(batches))
    for bi, idx in enumerate(batches):
        if not group.owns(bi):
            continue
        imgs, lbls = images[idx], labels[idx]
        if n_pad and bi == len(batches) - 1:
            _, _, cm = eval_step(model, imgs, mask_tail_labels(lbls, bs - n_pad))
        else:
            _, _, cm, loss = eval_loss_step(model, imgs, lbls, epoch)
            losses[bi] = float(loss)
        cm_total += cm.cpu().numpy().astype(np.int64)
    cm_total = group.sum_array(cm_total)
    loss_total, n_batches = sum_losses(group.sum_array(losses), n_pad)
    bd = mean_iou_breakdown(cm_total, task)
    pa, pac = pixel_accuracy(cm_total)
    return {
        "epoch": epoch, "valid_loss": loss_total / max(n_batches, 1),
        "miou": float(bd["miou"]),
        "miou_instruments": float(bd.get("miou_instruments", 0.0)),
        "miou_anatomies": float(bd.get("miou_anatomies", 0.0)),
        "miou_rare": float(bd.get("miou_rare", 0.0)),
        "pa": float(pa), "pac": float(pac),
        "per_class_iou": np.asarray(bd["per_class"]).tolist(),
        "confusion_matrix": cm_total,
    }
