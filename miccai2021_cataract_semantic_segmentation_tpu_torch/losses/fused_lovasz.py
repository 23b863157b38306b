"""Fused two-scale bucket Lovász from stride-8 logits, forward and backward.

Port of the JAX package's losses/fused_lovasz.py (the v4 route behind
`lovasz_two_scale_s8`). The bilinear align_corners=True upsample of both
scales, the softmax, the errors and the bucket histogram run in kernel B1
(kernels/lovasz_hist.py), and the backward (the same probabilities and
bucket ids, the per-bucket gradient gather, the softmax VJP and the
transposed upsample) in kernel B2 (kernels/lovasz_grad.py): CUDA on the
card, their plain PyTorch versions on the CPU. The full-resolution logit
grids never exist on the card. The loss math on the counts runs in float32
as the JAX package does it: counts cast to f32, cumsums in descending
bucket order, and the error sums reconstructed from bucket midpoints.

The gradient is the JAX custom VJP (`_fu2_fwd`/`_fu2_bwd`), not autograd
through the plain version: the per-bucket gradients g_fg/g_bg of the
forward, scaled by the cotangent of each row's loss and rounded to bf16 as
the TPU kernel rounds its table, are gathered by bucket id per pixel.
"""
from __future__ import annotations

import functools
import warnings

import torch
import torch.nn.functional as F

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import fu_grad
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    fu_histogram, fu_mats)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_edges import (
    bucket_midpoints_np)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    grad_table, losses_and_tables)


def bucket_split(n_buckets: int) -> tuple[int, int]:
    """(hi, lo) factorisation the JAX kernels use; the port keeps it only
    to accept exactly the bucket counts the reference accepts."""
    hi = 128 if n_buckets > 2048 else (64 if n_buckets > 512 else 32)
    lo = n_buckets // hi
    if hi * lo != n_buckets or lo < 1 or 2 * lo > 128:
        raise ValueError(f"unsupported lovasz bucket count {n_buckets}")
    return hi, lo


@functools.lru_cache(maxsize=32)
def bucket_midpoints(n_buckets: int, edges: str,
                     device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(bucket_midpoints_np(n_buckets, edges),
                               device=device)


def fu_core_fwd(parts, labels, n_cls: int, out_hw: tuple[int, int],
                n_buckets: int, align: bool, edges: str = "uniform",
                seed: int = 0, dither: bool = False,
                histogram=fu_histogram) -> torch.Tensor:
    """[(N, C, hs, ws)] per scale + padded int32 labels -> (R, B, 4) f32
    [n_fg, n_bg, n_fg * mid, n_bg * mid] (the JAX `_fu_core_fwd` result).
    `histogram` is B1: its wrapper, or its plain version where a caller
    holds the kernel against it."""
    hs, ws = parts[0].shape[2:]
    h_pad, w_pad = labels.shape[1:]
    mats = fu_mats(hs, ws, tuple(out_hw), h_pad, w_pad, align, labels.device)
    ls = torch.cat(parts, dim=1).to(torch.float32).contiguous()
    counts = histogram(ls, labels, mats, n_cls=n_cls, n_buckets=n_buckets,
                       edges=edges, seed=seed,
                       dither=dither).to(torch.float32)
    n_bg, n_fg = counts[:, 0], counts[:, 1]
    mid = bucket_midpoints(n_buckets, edges, labels.device)
    return torch.stack([n_fg, n_bg, n_fg * mid, n_bg * mid], dim=-1)


def fu_core_bwd(parts, labels, table, n_cls: int, out_hw: tuple[int, int],
                n_buckets: int, align: bool, edges: str = "uniform",
                seed: int = 0, dither: bool = False):
    """The JAX `_fu_core_bwd` after its table build: (R, 2, B) float32
    table -> one float32 (N, C, hs, ws) gradient per scale, from B2."""
    hs, ws = parts[0].shape[2:]
    h_pad, w_pad = labels.shape[1:]
    mats = fu_mats(hs, ws, tuple(out_hw), h_pad, w_pad, align, labels.device)
    ls = torch.cat(parts, dim=1).to(torch.float32).contiguous()
    dls = fu_grad(ls, labels, mats, table, n_cls=n_cls, n_buckets=n_buckets,
                  edges=edges, seed=seed, dither=dither)
    return dls.split(n_cls, dim=1)


class _TwoScaleS8(torch.autograd.Function):
    """(per_row (2C,), gts (2C,)) of both scales, with the JAX custom VJP:
    B1 forward, B2 backward; `gts` and the labels get no gradient."""

    @staticmethod
    def forward(ctx, li, lf, lbl, opts):
        n_cls, out_hw, n_buckets, edges, seed, dither, histogram = opts
        per_row, gts, g_fg, g_bg = losses_and_tables(
            fu_core_fwd([li, lf], lbl, n_cls, out_hw, n_buckets, True, edges,
                        seed, dither, histogram))
        ctx.save_for_backward(li, lf, lbl, g_fg, g_bg)
        ctx.opts = opts
        ctx.mark_non_differentiable(gts)
        return per_row, gts

    @staticmethod
    def backward(ctx, ct, _):
        li, lf, lbl, g_fg, g_bg = ctx.saved_tensors
        n_cls, out_hw, n_buckets, edges, seed, dither, _ = ctx.opts
        dli, dlf = fu_core_bwd([li, lf], lbl, grad_table(g_fg, g_bg, ct),
                               n_cls, out_hw, n_buckets, True, edges, seed,
                               dither)
        return dli.to(li.dtype), dlf.to(lf.dtype), None, None


def norm_dither_seed(dither_seed) -> tuple[int, bool]:
    """(seed, dither flag): None disables dither; an int (or 0-dim tensor)
    enables it with that per-step seed."""
    if dither_seed is None:
        return 0, False
    return int(dither_seed), True


def pad_labels(labels: torch.Tensor,
               classes_to_ignore: int | None = None) -> torch.Tensor:
    """(N, H, W) labels -> B1's int32 (N, H_pad, W_pad) label grid: the
    ignored class folded to -1, rows padded to a multiple of 8 and lanes to
    a multiple of 128 with -1 (the JAX kernel's geometry, which the dither
    index runs over)."""
    h, w = labels.shape[1:]
    lbl = labels.to(torch.int32)
    if classes_to_ignore is not None:
        lbl = torch.where(lbl == classes_to_ignore, -1, lbl)
    h_pad = -(-h // 8) * 8
    w_pad = -(-w // 128) * 128
    return F.pad(lbl, (0, w_pad - w, 0, h_pad - h), value=-1).contiguous()


def fused_two_scale_bucket_lovasz_s8(interm_logits_s8, final_logits_s8,
                                     labels, w_interm: float, w_final: float,
                                     classes_to_ignore: int | None = None,
                                     n_buckets: int = 2048,
                                     edges: str = "uniform",
                                     dither_seed=None, *,
                                     histogram=fu_histogram) -> torch.Tensor:
    """TwoScaleLoss(Lovász, Lovász) at full label resolution from NCHW
    stride-8 logits with the align_corners=True upsample fused into B1 and
    its backward into B2.

    `labels` (N, H, W) integer, values 0..C (C = ignore id, background for
    every class unless it is `classes_to_ignore`). `histogram` as in
    `fu_core_fwd`. Returns a 0-dim f32 that back-propagates into both logit
    tensors."""
    bucket_split(n_buckets)
    if dither_seed is not None and edges != "uniform":
        warnings.warn(
            "lovasz dither with adaptive edges: the shift (d - 1/2)/B is sized "
            "for uniform buckets; computed as the JAX package computes it",
            stacklevel=2)
    h, w = labels.shape[1:]
    c = final_logits_s8.shape[1]
    lbl = pad_labels(labels, classes_to_ignore)
    seed, dither = norm_dither_seed(dither_seed)
    per_row, gts = _TwoScaleS8.apply(
        interm_logits_s8, final_logits_s8, lbl,
        (c, (h, w), n_buckets, edges, seed, dither, histogram))
    present = (gts > 0).to(torch.float32)
    pr_i, pr_f = present[:c], present[c:]
    loss_i = torch.sum(per_row[:c] * pr_i) / torch.clamp_min(torch.sum(pr_i), 1.0)
    loss_f = torch.sum(per_row[c:] * pr_f) / torch.clamp_min(torch.sum(pr_f), 1.0)
    return w_interm * loss_i + w_final * loss_f
