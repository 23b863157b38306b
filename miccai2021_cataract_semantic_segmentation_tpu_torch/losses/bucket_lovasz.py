"""The generic bucket Lovász: a sort-free Lovász-Softmax on (R, P) rows.

Port of the JAX package's losses/bucket_lovasz.py. Each row's Lovász term
is an integral over error thresholds; quantising the errors into 2048
uniform buckets turns it into prefix sums over a per-row histogram of four
channels [n_fg, n_bg, se_fg, se_bg], where se are the TRUE sums of the
bf16-rounded errors (not bucket midpoints, as on the fused route). The
bucket count is fixed at 2048 here, whatever a config's `lovasz_buckets`
says, as on the JAX route.

The histogram is kernel B3 (kernels/bucket_hist.py) and the backward of
the per-row function kernel B4 (kernels/bucket_grad.py): CUDA on the card,
their plain PyTorch versions on the CPU. `losses_and_tables` and
`grad_table` are shared with the fused route (losses/fused_lovasz.py) and
with the Lovász-Softmax route on logits (losses/functional.py), whose
backward is kernel B4f.
"""
from __future__ import annotations

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_grad import bucket_gather
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    bucket_histogram)


def losses_and_tables(hist: torch.Tensor):
    """(R, B, 4) [n_fg, n_bg, se_fg, se_bg] -> per_row (R,), gts (R,),
    g_fg / g_bg (R, B) bucket gradients (JAX `_losses_and_tables`).

    Buckets are walked in descending error order; J's endpoints come from
    prefix counts; a bucket contributes its mean error times the change in
    J over its fg block, then its bg block (fg first, the sort route's tie
    order)."""
    n1 = hist[..., 0].flip(1)   # descending bucket order
    n0 = hist[..., 1].flip(1)
    se1 = hist[..., 2].flip(1)
    se0 = hist[..., 3].flip(1)
    g_total = n1.sum(dim=1, keepdim=True)
    cum_n = torch.cumsum(n1 + n0, dim=1)
    cum_f = torch.cumsum(n1, dim=1)
    s = cum_n - (n1 + n0)
    f = cum_f - n1

    def jacc(i, fo):
        union = g_total + i - fo
        pos = union > 0
        return 1.0 - torch.where(
            pos, (g_total - fo) / torch.where(pos, union, 1.0), 1.0)

    j_start = jacc(s, f)
    j_mid = jacc(s + n1, f + n1)
    j_end = jacc(s + n1 + n0, f + n1)
    g_fg = (j_mid - j_start) / torch.clamp_min(n1, 1.0)
    g_bg = (j_end - j_mid) / torch.clamp_min(n0, 1.0)
    per_row = torch.sum(se1 * g_fg + se0 * g_bg, dim=1)
    return per_row, g_total[:, 0], g_fg.flip(1), g_bg.flip(1)


def grad_table(g_fg: torch.Tensor, g_bg: torch.Tensor,
               ct: torch.Tensor) -> torch.Tensor:
    """(R, 2, B) [bg, fg] gradient table: the bucket gradients scaled by
    the cotangent of each row's loss, rounded to bf16 and back (the TPU
    kernels' `astype(bfloat16)` of their table, done here so kernel and
    plain version read the same float32 values)."""
    ct = ct.to(torch.float32)[:, None]
    table = torch.stack([g_bg * ct, g_fg * ct], dim=1)
    return table.to(torch.bfloat16).to(torch.float32).contiguous()


class _BucketLovasz(torch.autograd.Function):
    """per_row (R,) with the JAX custom VJP: B3 and the tables forward, B4
    on the cotangent-scaled tables backward; fg gets no gradient."""

    @staticmethod
    def forward(ctx, errors_t, fg_t, histogram):
        per_row, _, g_fg, g_bg = losses_and_tables(histogram(errors_t, fg_t))
        ctx.save_for_backward(errors_t, fg_t, g_fg, g_bg)
        return per_row

    @staticmethod
    def backward(ctx, ct):
        errors_t, fg_t, g_fg, g_bg = ctx.saved_tensors
        grad = bucket_gather(errors_t, fg_t, grad_table(g_fg, g_bg, ct))
        return grad.to(errors_t.dtype), None, None


def bucket_lovasz_per_class(errors_t: torch.Tensor, fg_t: torch.Tensor, *,
                            histogram=bucket_histogram) -> torch.Tensor:
    """(R, P) non-negative float32 errors + {0, 1} foreground flags (bool,
    or a number type: nonzero is foreground) -> (R,) per-row Lovász terms
    through the 2048-bucket histogram. `histogram` is B3: its wrapper, or
    its plain version where a caller holds the kernel against it."""
    fg = fg_t if fg_t.dtype == torch.bool else fg_t != 0
    return _BucketLovasz.apply(errors_t.to(torch.float32).contiguous(),
                               fg.contiguous(), histogram)
