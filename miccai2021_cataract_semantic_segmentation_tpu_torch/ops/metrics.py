"""Segmentation metrics: confusion matrix, PA/PAC, mIoU with category views,
the normalised matrix, single-class IoU and the sliding-window mIoU map.

Port of the JAX package's ops/metrics.py; every function but
`confusion_matrix` and `sliding_miou` works on a host (numpy) matrix. Rows index predictions, columns
ground truth. Labels take values 0..C (C = the ignore id of tasks 2/3): the
ignore column is dropped, and labels outside 0..C (such as the 255 that
masks padded eval rows) count nowhere. The matrix is counted in int64, so
it is exact at any size (the reference's bf16 one-hot matmul is exact only
below 2^24 per cell).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def sliding_miou(logits: torch.Tensor, labels: torch.Tensor,
                 kernel_size: int = 7, stride: int = 4,
                 original_size: bool = True) -> torch.Tensor:
    """Per-window mean IoU map (the reference's torch_utils.py:189-218): NCHW
    logits and NHW labels -> (N, H', W') float32, each window's IoU of the
    argmax and the labels averaged over the C classes (a class absent from
    both counts 1). The window sums are a grouped (depthwise) convolution
    with a ones kernel, exact in float32. `original_size` repeats each
    window `stride` times and pads the map with zeros back to H x W, the
    window's centre over its pixels."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel size must be odd")
    n, c, h, w = logits.shape
    cls = torch.arange(c, device=logits.device)[None, :, None, None]
    pred_oh = (logits.argmax(dim=1)[:, None] == cls).to(torch.float32)
    lbl_oh = (labels.to(torch.int64)[:, None] == cls).to(torch.float32)
    ones = torch.ones(c, 1, kernel_size, kernel_size, device=logits.device)

    def window_sum(x):
        return F.conv2d(x, ones, stride=stride, groups=c)

    inter = window_sum(pred_oh * lbl_oh)
    union = window_sum(torch.maximum(pred_oh, lbl_oh))
    empty = union == 0
    iou = torch.where(empty, torch.ones_like(inter),
                      inter / torch.where(empty, torch.ones_like(union), union))
    m = iou.mean(dim=1)
    if original_size:
        m = m.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)
        off = kernel_size // 2
        pad_b, pad_r = h - m.shape[1] - off, w - m.shape[2] - off
        if pad_b < 0 or pad_r < 0:
            raise ValueError(f"a {h}x{w} map has no room for windows of "
                             f"{kernel_size} at stride {stride}")
        m = F.pad(m, (off, pad_r, off, pad_b))
    return m
