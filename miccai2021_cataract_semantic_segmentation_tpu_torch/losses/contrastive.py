"""DenseContrastiveLoss (V1) and DenseContrastiveLossV2.

Port of the JAX package's losses/contrastive.py. The reference's
LossWrapper dispatches both over the projector features, but its release
does not contain the loss module, so the JAX package reconstructs it; this
port follows that reconstruction:
  * V1: pixel-to-class-prototype InfoNCE. The prototypes are the
    batch-wide masked means of the L2-normalised features; every valid
    feature pixel is attracted to its class's prototype and repelled from
    the other classes present in the batch;
  * V2: anchor-to-anchor supervised contrastive loss (SupCon) over a
    strided subsample of the feature pixels across the batch: positives
    share a label, negatives are all other valid anchors. Its N x N
    similarity is one product (4,080 anchors, 66 MB in float32, at the
    flagship's 68x120 grid, stride 4 and batch 8).
Features are NCHW (the JAX package's are NHWC) and computed in float32
(float64 for float64 features); pixels are ordered (n, h, w), as the JAX
package flattens them. Labels are nearest-downsampled to the feature grid;
the ignore class and any label beyond the task's classes are excluded from
anchors, prototypes and positives.
"""
from __future__ import annotations

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.misc import downsample_labels

_NEG = -1e9


def _normalise(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise with finite gradients at x == 0 (an absent class's
    prototype is the zero vector): x * rsqrt(|x|^2 + eps)."""
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def _pixels(features: torch.Tensor, labels: torch.Tensor, stride: int = 1):
    """(normalised (P, D) features, (P,) labels) of every `stride`-th row and
    column of the feature grid, pixels in (n, h, w) order."""
    f = features.to(torch.promote_types(features.dtype, torch.float32))
    d, h, w = f.shape[1:]
    lbl = downsample_labels(labels.to(torch.int64), (h, w))[:, ::stride, ::stride]
    f = f[:, :, ::stride, ::stride].permute(0, 2, 3, 1).reshape(-1, d)
    return _normalise(f), lbl.reshape(-1)


def dense_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                           task: int, temperature: float = 0.1) -> torch.Tensor:
    """V1: features (B, D, h, w), labels (B, H, W) in network ids at input
    resolution -> the mean InfoNCE over valid pixels."""
    num_classes = taxonomy.TASK_NUM_CLASSES[task]
    f, lbl = _pixels(features, labels)
    valid = lbl < num_classes
    cls = torch.arange(num_classes, device=f.device)
    onehot = (lbl[:, None] == cls[None, :]).to(f.dtype)          # (P, C)
    counts = onehot.sum(dim=0)
    protos = _normalise(onehot.t() @ f / torch.clamp(counts, min=1.0)[:, None])
    sims = f @ protos.t() / temperature                           # (P, C)
    sims = torch.where((counts > 0)[None, :], sims, torch.full_like(sims, _NEG))
    logp = torch.log_softmax(sims, dim=-1)
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    per_pixel = -torch.gather(logp, 1, safe[:, None])[:, 0]
    n_valid = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, per_pixel, torch.zeros_like(per_pixel)).sum() / n_valid


def dense_contrastive_loss_v2(features: torch.Tensor, labels: torch.Tensor,
                              task: int, temperature: float = 0.1,
                              anchor_stride: int = 4) -> torch.Tensor:
    """V2: for anchor i, L_i = -mean over positives p of
    log(exp(s_ip) / sum over k != i of exp(s_ik)), over the valid anchors
    on every `anchor_stride`-th row and column; anchors without another
    positive in the batch are skipped."""
    num_classes = taxonomy.TASK_NUM_CLASSES[task]
    f, lbl = _pixels(features, labels, anchor_stride)
    valid = lbl < num_classes
    sims = f @ f.t() / temperature                                # (N, N)
    not_self = ~torch.eye(sims.shape[0], dtype=torch.bool, device=f.device)
    pair_valid = valid[:, None] & valid[None, :] & not_self
    same = (lbl[:, None] == lbl[None, :]) & pair_valid
    logp = torch.log_softmax(
        torch.where(pair_valid, sims, torch.full_like(sims, _NEG)), dim=-1)
    n_pos = same.sum(dim=-1)
    per_anchor = -torch.where(same, logp, torch.zeros_like(logp)).sum(dim=-1) \
        / torch.clamp(n_pos, min=1)
    use = valid & (n_pos > 0)
    return torch.where(use, per_anchor, torch.zeros_like(per_anchor)).sum() \
        / torch.clamp(use.sum(), min=1)
