"""Fused bucket Lovász from stride-8 logits, forward and backward.

Port of the JAX package's losses/fused_lovasz.py: the two-scale route
behind `fused_two_scale_bucket_lovasz_s8` (OCRNet's TwoScaleLoss) and the
single-scale one behind `fused_bucket_lovasz_s8` (LovaszSoftmax on a model
that gives its pre-upsample logits, such as DeepLabv3/v3+), each in the
JAX package's two implementations, chosen as it chooses them by
CADIS_FUSED_V3 (`_USE_V3`, read when the loss runs):

  * v4, the default: the bilinear upsample of every scale, the softmax,
    the errors and the bucket histogram run in kernel B1
    (kernels/lovasz_hist.py), and the backward (the same probabilities and
    bucket ids, the per-bucket gradient gather, the softmax VJP and the
    transposed upsample) in kernel B2 (kernels/lovasz_grad.py). The
    full-resolution logit grids never exist on the card.
  * v3, under CADIS_FUSED_V3=1: `upsample_nchw` writes the full-resolution
    float32 grids with two matrix products (autograd gives their
    transpose), then kernels B5/B6 (two scales) or B7/B8 (one scale)
    (kernels/nchw_hist.py, kernels/nchw_grad.py) count and differentiate
    on them. Dither is refused there, as the JAX package refuses it.

The kernels are CUDA on the card and their plain PyTorch versions on the
CPU. The loss math on the counts runs in float32 as the JAX package does
it: counts cast to f32, cumsums in descending bucket order, and the error
sums reconstructed from bucket midpoints.

The gradient is the JAX custom VJP, not autograd through the plain
versions: the per-bucket gradients g_fg/g_bg of the forward, scaled by the
cotangent of each row's loss and rounded to bf16 as the TPU kernels round
their table, are gathered by bucket id per pixel.
"""
from __future__ import annotations

import functools
import os
import warnings

import torch
import torch.nn.functional as F

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import fu_grad
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    fu_histogram, fu_mats)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_grad import (
    nchw1_gradient, nchw_gradient)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    nchw1_histogram, nchw_histogram)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_edges import (
    bucket_midpoints_np)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    grad_table, losses_and_tables)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear

# The JAX package's A/B switch back to its v3 kernels; tests and the smoke
# run set it around a call, as the JAX package's tests do.
_USE_V3 = os.environ.get("CADIS_FUSED_V3") == "1"


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


def counts_to_hist(counts: torch.Tensor, n_buckets: int,
                   edges: str) -> torch.Tensor:
    """int32 (R, 2, B) [bg, fg] counts -> (R, B, 4) f32 [n_fg, n_bg,
    n_fg * mid, n_bg * mid] (the histograms the JAX loss math reads)."""
    counts = counts.to(torch.float32)
    n_bg, n_fg = counts[:, 0], counts[:, 1]
    mid = bucket_midpoints(n_buckets, edges, counts.device)
    return torch.stack([n_fg, n_bg, n_fg * mid, n_bg * mid], dim=-1)


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
    return counts_to_hist(histogram(ls, labels, mats, n_cls=n_cls,
                                    n_buckets=n_buckets, edges=edges,
                                    seed=seed, dither=dither),
                          n_buckets, edges)


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


class _FusedS8(torch.autograd.Function):
    """(per_row (S*C,), gts (S*C,)) of S stride-8 logit tensors with the
    JAX custom VJP of `lovasz_two_scale_s8` (S = 2) and `lovasz_single_s8`
    (S = 1): B1 forward, B2 backward; `gts` and the labels get no
    gradient."""

    @staticmethod
    def forward(ctx, lbl, opts, *parts):
        n_cls, out_hw, n_buckets, align, edges, seed, dither, histogram = opts
        per_row, gts, g_fg, g_bg = losses_and_tables(
            fu_core_fwd(parts, lbl, n_cls, out_hw, n_buckets, align, edges,
                        seed, dither, histogram))
        ctx.save_for_backward(lbl, g_fg, g_bg, *parts)
        ctx.opts = opts
        ctx.mark_non_differentiable(gts)
        return per_row, gts

    @staticmethod
    def backward(ctx, ct, _):
        lbl, g_fg, g_bg, *parts = ctx.saved_tensors
        n_cls, out_hw, n_buckets, align, edges, seed, dither, _ = ctx.opts
        grads = fu_core_bwd(parts, lbl, grad_table(g_fg, g_bg, ct), n_cls,
                            out_hw, n_buckets, align, edges, seed, dither)
        return (None, None, *(g.to(x.dtype) for g, x in zip(grads, parts)))


class _NchwLovasz(torch.autograd.Function):
    """(per_row (S*C,), gts (S*C,)) of S full-resolution (N, C, H_pad,
    W_pad) float32 grids with the JAX custom VJP of `lovasz_two_scale_nchw`
    (S = 2: B5 forward, B6 backward) and `lovasz_single_nchw` (S = 1: B7,
    B8)."""

    @staticmethod
    def forward(ctx, lbl, opts, *grids):
        n_buckets, edges, w_real = opts
        hist = (nchw1_histogram, nchw_histogram)[len(grids) - 1]
        counts = hist(grids, lbl, n_buckets=n_buckets, edges=edges,
                      w_real=w_real)
        per_row, gts, g_fg, g_bg = losses_and_tables(
            counts_to_hist(counts, n_buckets, edges))
        ctx.save_for_backward(lbl, g_fg, g_bg, *grids)
        ctx.opts = opts
        ctx.mark_non_differentiable(gts)
        return per_row, gts

    @staticmethod
    def backward(ctx, ct, _):
        lbl, g_fg, g_bg, *grids = ctx.saved_tensors
        n_buckets, edges, w_real = ctx.opts
        grad = (nchw1_gradient, nchw_gradient)[len(grids) - 1]
        return (None, None, *grad(grids, lbl, grad_table(g_fg, g_bg, ct),
                                  n_buckets=n_buckets, edges=edges,
                                  w_real=w_real))


def lovasz_two_scale_nchw(li, lf, labels, n_buckets: int = 2048,
                          edges: str = "uniform", w_real: int | None = None):
    """Two-scale bucket-Lovász core on (N, C, H_pad, W_pad) float32 grids
    (B5, B6). `labels` (N, H_pad, W_pad) int32, -1 where no count; lanes
    at or past `w_real` (default W_pad) count nowhere either. Returns
    (per_row (2C,), gts (2C,)): rows [0, C) interm, [C, 2C) final."""
    return _NchwLovasz.apply(labels, (n_buckets, edges, w_real or li.shape[3]),
                             li, lf)


def lovasz_single_nchw(lg, labels, n_buckets: int = 2048,
                       edges: str = "uniform", w_real: int | None = None):
    """Single-scale bucket-Lovász core on one (N, C, H_pad, W_pad) float32
    grid (B7, B8). Returns (per_class (C,), gts (C,))."""
    return _NchwLovasz.apply(labels, (n_buckets, edges, w_real or lg.shape[3]),
                             lg)


def upsample_nchw(logits_small: torch.Tensor, out_hw: tuple[int, int],
                  align_corners: bool = True, w_pad: int | None = None,
                  h_pad: int | None = None) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, H[_pad], W[_pad]) float32 bilinear upsample:
    `resize_bilinear`'s two matrix products, rows first, in >= f32 (f64
    logits stay f64 until the final cast, as in the JAX package), then
    zero pad rows and lanes, which the caller's -1 labels mask (the JAX
    package's zero-padded matrices give the same zeros)."""
    oh, ow = out_hw
    acc = torch.promote_types(logits_small.dtype, torch.float32)
    y = resize_bilinear(logits_small.to(acc), (oh, ow), align_corners)
    y = F.pad(y, (0, (w_pad or ow) - ow, 0, (h_pad or oh) - oh))
    return y.to(torch.float32).contiguous()


def norm_dither_seed(dither_seed) -> tuple[int, bool]:
    """(seed, dither flag): None disables dither; an int (or 0-dim tensor)
    enables it with that per-step seed. The v3 route refuses it, as the
    JAX package's `_norm_dither_seed` does."""
    if dither_seed is None:
        return 0, False
    if _USE_V3:
        raise ValueError("lovasz dither requires the v4 fused kernels "
                         "(unset CADIS_FUSED_V3)")
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


def _prepare(labels, classes_to_ignore, n_buckets: int, edges: str,
             dither_seed):
    """The entry points' shared preparation: the bucket count check, the
    padded labels and the dither (seed, flag)."""
    bucket_split(n_buckets)
    if dither_seed is not None and edges != "uniform":
        warnings.warn(
            "lovasz dither with adaptive edges: the shift (d - 1/2)/B is sized "
            "for uniform buckets; computed as the JAX package computes it",
            stacklevel=3)
    seed, dither = norm_dither_seed(dither_seed)
    return pad_labels(labels, classes_to_ignore), seed, dither


def fused_two_scale_bucket_lovasz_s8(interm_logits_s8, final_logits_s8,
                                     labels, w_interm: float, w_final: float,
                                     classes_to_ignore: int | None = None,
                                     n_buckets: int = 2048,
                                     edges: str = "uniform",
                                     dither_seed=None, *,
                                     histogram=fu_histogram) -> torch.Tensor:
    """TwoScaleLoss(Lovász, Lovász) at full label resolution from NCHW
    stride-8 logits with the align_corners=True upsample: fused into B1 and
    its backward into B2 (v4), or written out by `upsample_nchw` for B5/B6
    (v3, `_USE_V3`).

    `labels` (N, H, W) integer, values 0..C (C = ignore id, background for
    every class unless it is `classes_to_ignore`). `histogram` as in
    `fu_core_fwd` (the v4 route). Returns a 0-dim f32 that back-propagates
    into both logit tensors."""
    h, w = labels.shape[1:]
    c = final_logits_s8.shape[1]
    lbl, seed, dither = _prepare(labels, classes_to_ignore, n_buckets, edges,
                                 dither_seed)
    if _USE_V3:
        h_pad, w_pad = lbl.shape[1:]
        per_row, gts = lovasz_two_scale_nchw(
            upsample_nchw(interm_logits_s8, (h, w), True, w_pad, h_pad),
            upsample_nchw(final_logits_s8, (h, w), True, w_pad, h_pad),
            lbl, n_buckets, edges, w)
    else:
        per_row, gts = _FusedS8.apply(
            lbl, (c, (h, w), n_buckets, True, edges, seed, dither, histogram),
            interm_logits_s8, final_logits_s8)
    present = (gts > 0).to(torch.float32)
    pr_i, pr_f = present[:c], present[c:]
    loss_i = torch.sum(per_row[:c] * pr_i) / torch.clamp_min(torch.sum(pr_i), 1.0)
    loss_f = torch.sum(per_row[c:] * pr_f) / torch.clamp_min(torch.sum(pr_f), 1.0)
    return w_interm * loss_i + w_final * loss_f


def fused_bucket_lovasz_s8(logits_s8, labels, classes_to_consider=None,
                           classes_to_ignore: int | None = None,
                           n_buckets: int = 2048, align_corners: bool = True,
                           edges: str = "uniform", dither_seed=None, *,
                           histogram=fu_histogram) -> torch.Tensor:
    """Single-scale bucket Lovász-Softmax from NCHW pre-upsample logits,
    with the model's own final bilinear upsample (`align_corners` as the
    model does it) fused into B1/B2 (v4) or written out for B7/B8 (v3).

    `classes_to_consider`: None or "present" averages over the classes
    present in the labels, "all" over every class, or a list of class ids
    (those of them present). Other arguments as in
    `fused_two_scale_bucket_lovasz_s8`."""
    h, w = labels.shape[1:]
    c = logits_s8.shape[1]
    lbl, seed, dither = _prepare(labels, classes_to_ignore, n_buckets, edges,
                                 dither_seed)
    if _USE_V3:
        h_pad, w_pad = lbl.shape[1:]
        per_class, gts = lovasz_single_nchw(
            upsample_nchw(logits_s8, (h, w), align_corners, w_pad, h_pad),
            lbl, n_buckets, edges, w)
    else:
        per_class, gts = _FusedS8.apply(
            lbl, (c, (h, w), n_buckets, align_corners, edges, seed, dither,
                  histogram), logits_s8)
    if classes_to_consider in (None, "present", "all"):
        mask = torch.ones(c, device=gts.device)
    else:
        mask = torch.zeros(c, device=gts.device)
        mask[torch.as_tensor(classes_to_consider, device=gts.device).long()] = 1.0
    if classes_to_consider != "all":
        mask = mask * (gts > 0).to(torch.float32)
    return torch.sum(per_class * mask) / torch.clamp_min(torch.sum(mask), 1.0)
