"""Segmentation metrics: confusion matrix, PA/PAC, mIoU with category views,
the normalised matrix and single-class IoU.

Port of the JAX package's ops/metrics.py (all but `sliding_miou`); every
function but `confusion_matrix` works on a host (numpy) matrix. Rows index predictions, columns
ground truth. Labels take values 0..C (C = the ignore id of tasks 2/3): the
ignore column is dropped, and labels outside 0..C (such as the 255 that
masks padded eval rows) count nowhere. The matrix is counted in int64, so
it is exact at any size (the reference's bf16 one-hot matmul is exact only
below 2^24 per cell).
"""
from __future__ import annotations

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int | None = None) -> torch.Tensor:
    """CxC int64 confusion matrix from NCHW logits and NHW labels (C from
    the logits unless given)."""
    c = logits.shape[1] if num_classes is None else num_classes
    pred = logits.argmax(dim=1).reshape(-1)
    lbl = labels.reshape(-1).long()
    # labels 0..C land in column `lbl` (the ignore column C is then
    # dropped); any other label goes to one spare bin that is dropped too
    spare = c * (c + 1)
    ok = (lbl >= 0) & (lbl <= c)
    idx = torch.where(ok, pred * (c + 1) + lbl, torch.full_like(lbl, spare))
    cm = torch.bincount(idx, minlength=spare + 1)[:spare]
    return cm.reshape(c, c + 1)[:, :c]


def normalise_confusion_matrix(matrix, mode: str) -> np.ndarray:
    """Row- or column-normalised float32 matrix; zero marginals stay zero."""
    m = np.asarray(matrix).astype(np.float32)
    if mode == "row":
        s = m.sum(axis=1, keepdims=True)
    elif mode == "col":
        s = m.sum(axis=0, keepdims=True)
    else:
        raise ValueError("mode must be 'row' or 'col'")
    return m / np.where(s == 0, 1.0, s)


def pixel_accuracy(cm) -> tuple[np.float32, np.float32]:
    """(overall PA, per-predicted-class mean PAC) of a host matrix."""
    cm = np.asarray(cm)
    diag = np.diagonal(cm).astype(np.float32)
    acc = diag.sum() / cm.sum()
    row = cm.sum(axis=1).astype(np.float32)
    row = np.where(row == 0, 1.0, row)
    return acc, (diag / row).mean()


def iou_from_confusion(cm) -> np.ndarray:
    """Per-class IoU vector; classes with empty denominator get 0."""
    cm = np.asarray(cm)
    diag = np.diagonal(cm).astype(np.float32)
    row = cm.sum(axis=0).astype(np.float32)  # ground-truth marginal
    col = cm.sum(axis=1).astype(np.float32)  # prediction marginal
    denom = row + col - diag
    iou = diag / np.where(denom == 0, 1.0, denom)
    return np.where(denom == 0, 0.0, iou)


def mean_iou(cm, task: int, indices=None):
    """Mean IoU over `indices` (default: all real classes of `task`)."""
    iou = iou_from_confusion(cm)
    if indices is None:
        indices = tuple(range(taxonomy.TASK_NUM_CLASSES[task]))
    return iou[np.asarray(indices, dtype=np.int32)].mean()


def single_class_iou(cm, task: int, class_id: int):
    """IoU of one class; 255 means the ignore class (the last row)."""
    cm = np.asarray(cm)
    if class_id == taxonomy.IGNORE_VALUE:
        class_id = cm.shape[0] - 1
    tp = cm[class_id, class_id]
    fn = cm[:, class_id].sum() - tp
    n_real = min(taxonomy.TASK_NUM_CLASSES[task], cm.shape[0])
    others = [c for c in range(n_real) if c != class_id]
    fp = cm[class_id, np.asarray(others, dtype=np.int64)].sum()
    denom = np.float32(tp + fp + fn)
    return np.where(denom == 0, np.float32(0.0),
                    np.float32(tp) / np.where(denom == 0, np.float32(1.0), denom))


def mean_iou_breakdown(cm, task: int) -> dict:
    """Total / instruments / anatomies / rare mIoU."""
    iou = iou_from_confusion(cm)
    cats = taxonomy.CATEGORIES[task]
    out = {
        "miou": iou[: taxonomy.TASK_NUM_CLASSES[task]].mean(),
        "per_class": iou,
    }
    for name in ("instruments", "anatomies", "rare"):
        idx = np.asarray(cats[name], dtype=np.int32)
        if idx.size:
            out[f"miou_{name}"] = iou[idx].mean()
    return out
