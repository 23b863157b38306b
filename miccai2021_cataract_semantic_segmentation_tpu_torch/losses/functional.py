"""Cross-entropy, and Lovász-Softmax on full-resolution logits: the exact
sort route and the generic bucket route.

Port of `cross_entropy` and the Lovász section of the JAX package's
losses/functional.py.
Logits are NCHW (the JAX package's are NHWC) and labels NHW; the class
rows are built directly in the (C, P) layout with P ordered (n, h, w), the
order of the JAX package's flattened NHWC pixels. Pixels of
`classes_to_ignore` become (error 0, fg 0) entries, which add nothing to
either route's loss. The errors are computed in float32 from logits of any
float type, as the JAX package casts them.

Two per-row functions (R, P) -> (R,):
  * "sort" (the default): the exact Lovász extension. One descending sort
    of a packed key, fg in the least significant bit of the error's
    float32 bits (ties between equal errors put fg first), and a backward
    that scatters the sorted gradient back through the permutation (the
    JAX custom VJP). The sort is `torch.sort`, as the JAX package leaves
    its sort to `lax.sort`.
  * "bucket": the 2048-bucket histogram of losses/bucket_lovasz.py
    (kernel B3 forward). `lovasz_softmax` and `fused_two_scale_lovasz`
    take it straight from the logits (`_BucketFromLogits`): the errors are
    built without autograd, and the backward is kernel B4f, which writes
    d loss / d logits from the saved errors and flags in one pass; the
    per-row function `bucket_lovasz_per_class` keeps kernel B4 (the
    gather of d loss / d errors) behind the JAX package's custom VJP.
"""
from __future__ import annotations

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_grad import (
    bucket_dlogits)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    bucket_histogram)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    bucket_lovasz_per_class, grad_table, losses_and_tables)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1, class_weights=None) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss's mean over non-ignored pixels (a
    class-weighted mean with `class_weights`), from NCHW logits and NHW
    labels, in float32 whatever the logits' type. Labels are clipped to
    [0, C-1] before the gather, so a label out of range (the 255 that masks
    padded eval rows, where `ignore_index` is not 255) counts as class C-1,
    as the JAX package's does; `ignore_index` < 0 ignores nothing. The sum
    is divided by max(sum of weights, 1), so an all-ignored batch gives 0."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits.to(torch.float32), dim=1)
    lbl = labels.to(torch.int64)
    safe = lbl.clamp(0, c - 1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    w = (lbl != ignore_index).to(torch.float32) if ignore_index >= 0 \
        else torch.ones_like(nll)
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32,
                                device=logits.device)[safe]
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def lovasz_grad_from_sorted(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. errors sorted in descending
    order (Alg. 1): (..., P) sorted foreground indicators -> (..., P)."""
    gts = fg_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(fg_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - fg_sorted, dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def _pack_sort(errors_t: torch.Tensor, fg_t: torch.Tensor):
    """(sorted errors, sorted fg, permutation): one descending sort of the
    error's float32 bits with its least significant bit replaced by fg
    (held in int64, as torch sorts no uint32)."""
    bits = errors_t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    packed = (bits & 0xFFFFFFFE) | fg_t.to(torch.int64)
    key, perm = torch.sort(packed, dim=1, descending=True, stable=True)
    fg_sorted = (key & 1).to(torch.float32)
    e_sorted = (key & 0xFFFFFFFE).to(torch.int32).view(torch.float32)
    return e_sorted, fg_sorted, perm


class _SortedLovasz(torch.autograd.Function):
    """per_row (R,) of the exact Lovász extension; the backward scatters
    the sorted gradient back to pixel order, scaled by the cotangent."""

    @staticmethod
    def forward(ctx, errors_t, fg_t):
        e_sorted, fg_sorted, perm = _pack_sort(errors_t, fg_t)
        g = lovasz_grad_from_sorted(fg_sorted)
        ctx.save_for_backward(perm, g)
        return torch.sum(e_sorted * g, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        perm, g = ctx.saved_tensors
        g_orig = torch.empty_like(g).scatter_(1, perm, g)
        return g_orig * ct.to(g.dtype)[:, None], None


def sorted_lovasz_per_class(errors_t: torch.Tensor,
                            fg_t: torch.Tensor) -> torch.Tensor:
    """(R, P) non-negative errors + {0, 1} fg -> (R,) exact Lovász terms."""
    return _SortedLovasz.apply(errors_t, fg_t)


def per_class_fn(impl: str):
    if impl == "bucket":
        return bucket_lovasz_per_class
    if impl == "sort":
        return sorted_lovasz_per_class
    raise ValueError(f"lovasz_impl must be 'sort' or 'bucket', got '{impl}'")


def lovasz_rows(logits: torch.Tensor, labels: torch.Tensor,
                classes_to_ignore: int | None = None, per_image: bool = False):
    """(errors_t, fg_t, present) from NCHW logits and NHW labels
    (the JAX `lovasz_errors_from_logits`): float32 errors |fg - p| and bool
    fg, both zero on ignored pixels, and the float32 presence of each row's
    class. Rows are the C classes over all N·H·W pixels, or with
    `per_image` the N·C (image, class) pairs over each image's H·W pixels;
    the rows are independent, so one launch over (N·C, H·W) rows computes
    what the JAX package's vmap over images does."""
    n, c = logits.shape[:2]
    lt = logits.to(torch.float32)
    if per_image:
        lt, lbl = lt.reshape(n * c, -1), labels.reshape(n, -1)
    else:
        lt, lbl = lt.transpose(0, 1).reshape(c, -1), labels.reshape(1, -1)
    probs_t = torch.softmax(lt.reshape(-1, c, lt.shape[-1]), dim=1)
    cls = torch.arange(c, device=logits.device)[None, :, None]
    fg_t = lbl[:, None, :] == cls                    # (n or 1, C, P)
    if classes_to_ignore is not None:
        valid = lbl[:, None, :] != classes_to_ignore
        fg_t = fg_t & valid
        errors_t = torch.abs(fg_t.to(torch.float32) - probs_t) * valid
    else:
        errors_t = torch.abs(fg_t.to(torch.float32) - probs_t)
    present = fg_t.any(dim=2).to(torch.float32)
    return (errors_t.reshape(lt.shape), fg_t.reshape(lt.shape),
            present.reshape(-1))


def _dlogits(errors_t, fg_t, table, logits, per_image: bool) -> torch.Tensor:
    """B4f on one scale's rows. Logits of another type than bf16 or
    float32 (the float64 of the parity steps) go through B4f as float32,
    which is what `lovasz_rows` computes in, and come back in their type."""
    x = logits if logits.dtype in (torch.bfloat16, torch.float32) else logits.float()
    return bucket_dlogits(errors_t, fg_t, table, x.contiguous(),
                          per_image=per_image).to(logits.dtype)


class _BucketFromLogits(torch.autograd.Function):
    """The generic bucket route from the logits of one or more scales, their
    class rows stacked into one B3 launch: (per_row (R,), then each scale's
    presence). The forward builds the rows with `lovasz_rows` (no
    autograd), counts them (B3) and keeps the bucket gradients; the
    backward scales the table by the cotangent and runs B4f once per scale
    on its rows. It saves the logits, the errors, the flags and the bucket
    gradients, not the probabilities and fg - p that autograd through
    `lovasz_rows` keeps."""

    @staticmethod
    def forward(ctx, labels, classes_to_ignore, per_image, *logits):
        rows = [lovasz_rows(lg, labels, classes_to_ignore, per_image) for lg in logits]
        if len(rows) == 1:      # no copy
            errors_t, fg_t = rows[0][0].contiguous(), rows[0][1].contiguous()
        else:
            errors_t = torch.cat([r[0] for r in rows])
            fg_t = torch.cat([r[1] for r in rows])
        per_row, _, g_fg, g_bg = losses_and_tables(bucket_histogram(errors_t, fg_t))
        ctx.per_image = per_image
        ctx.save_for_backward(errors_t, fg_t, g_fg, g_bg, *logits)
        presents = [r[2] for r in rows]
        ctx.mark_non_differentiable(*presents)
        ctx.set_materialize_grads(False)    # no zeros for the presences
        return (per_row, *presents)

    @staticmethod
    def backward(ctx, ct, *_):
        errors_t, fg_t, g_fg, g_bg, *logits = ctx.saved_tensors
        if ct is None:
            return (None,) * (3 + len(logits))
        table = grad_table(g_fg, g_bg, ct)
        grads, r0 = [], 0
        for lg in logits:
            r1 = r0 + lg.shape[1] * (lg.shape[0] if ctx.per_image else 1)
            grads.append(_dlogits(errors_t[r0:r1], fg_t[r0:r1], table[r0:r1], lg,
                                  ctx.per_image))
            r0 = r1
        return (None, None, None, *grads)


def _mean_over(per_class, weight):
    return torch.sum(per_class * weight, dim=-1) / torch.clamp_min(
        torch.sum(weight, dim=-1), 1.0)


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor,
                   classes_to_consider=None,
                   classes_to_ignore: int | None = None,
                   per_image: bool = False, impl: str = "sort") -> torch.Tensor:
    """Multi-class Lovász-Softmax (reference losses/LovaszSoftmax.py).

    `classes_to_consider`: None/'present' (default) averages over the
    classes present in the labels; 'all' over every channel; or an explicit
    id list (averaged over those of its classes that are present).
    `classes_to_ignore`: a label value whose pixels are excluded entirely;
    without it, pixels of the task's ignore id count as background for
    every class. `per_image`: the loss of each image, then their mean.
    `impl`: 'sort' (exact) or 'bucket' (the 2048-bucket histogram). Returns
    a 0-dim float32 tensor."""
    n, c = logits.shape[:2]
    fn = per_class_fn(impl)
    if classes_to_consider in (None, "present", "all"):
        class_mask = torch.ones(c, device=logits.device)
    else:
        class_mask = torch.zeros(c, device=logits.device)
        class_mask[torch.as_tensor(classes_to_consider, dtype=torch.long)] = 1.0
    if impl == "bucket":
        per_class, present = _BucketFromLogits.apply(labels, classes_to_ignore,
                                                     per_image, logits)
    else:
        errors_t, fg_t, present = lovasz_rows(logits, labels, classes_to_ignore,
                                              per_image)
        per_class = fn(errors_t, fg_t)
    rows = n if per_image else 1
    weight = class_mask.repeat(rows)
    if classes_to_consider != "all":
        weight = weight * present
    losses = _mean_over(per_class.reshape(rows, c), weight.reshape(rows, c))
    return losses.mean()


def fused_two_scale_lovasz(interm_logits: torch.Tensor,
                           final_logits: torch.Tensor, labels: torch.Tensor,
                           w_interm: float, w_final: float,
                           classes_to_ignore: int | None = None,
                           impl: str = "sort") -> torch.Tensor:
    """TwoScaleLoss(Lovász, Lovász) at label resolution with both scales'
    class rows stacked into ONE (2C, P) call of the per-row function (on
    the bucket route one B3 launch, and one B4f per scale backward)."""
    c = final_logits.shape[1]
    fn = per_class_fn(impl)
    if impl == "bucket":
        per_class, pr_i, pr_f = _BucketFromLogits.apply(
            labels, classes_to_ignore, False, interm_logits, final_logits)
    else:
        e_i, f_i, pr_i = lovasz_rows(interm_logits, labels, classes_to_ignore)
        e_f, f_f, pr_f = lovasz_rows(final_logits, labels, classes_to_ignore)
        per_class = fn(torch.cat([e_i, e_f], dim=0), torch.cat([f_i, f_f], dim=0))
    loss_i = _mean_over(per_class[:c], pr_i)
    loss_f = _mean_over(per_class[c:], pr_f)
    return w_interm * loss_i + w_final * loss_f
