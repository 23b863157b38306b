"""Shared NCHW building blocks with the reference's torch layer semantics.

Port of the JAX package's models/layers.py. BatchNorm uses eps 1e-5 and
torch momentum 0.1 by default (flax momentum 0.9 is torch momentum 0.1;
HRNet's torch 0.01 is flax 0.99), and updates
its running variance in train mode with the biased batch variance, as
flax does (`BatchNorm2d`). Modules keep the reference's torch state-dict
names, so a published checkpoint loads with `load_state_dict(strict=True)`.
`Conv2d`, `ConvTranspose2d` and `MaxPool2d` are torch's, which under a
spatial grid (parallel/spatial.py, `grid`) work on this rank's band of
rows, as do `upsample_like`, `global_avg_pool` and `adaptive_avg_pool`
given the grid.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import (
    interp_matrix, resize_bilinear, resize_rows)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def torch_pad(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """'same-ish' padding as the reference computes it (ceil division)."""
    return (kernel_size + (kernel_size - 1) * (dilation - 1) - stride + 1) // 2


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: >= f32 (bf16 upcasts; f64 parity runs stay f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """Model outputs leave in at-least-f32 (bf16 forwards emit f32 logits)."""
    return x.to(acc_dtype(x))


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _check_out(module, grid, what: str, rows: int, cols: int, stride: int) -> list:
    """The bands at a window op's output `stride`; ValueError naming the
    layer unless its output over the whole activation, `rows` x `cols`,
    is the frame's at that stride and every band holds a row."""
    out = grid.bands(stride)
    if (rows, cols) != (out[-1][1], -(-grid.frame[1] // stride)) or \
            any(hi <= lo for lo, hi in out):
        raise ValueError(
            f"{module.site}: the {what} ({rows}x{cols} out) does not split over the grid "
            f"{grid.shape}: its bands of the {grid.frame} frame's rows would be {out} at "
            f"stride {stride}; the grid takes ops whose output over the whole "
            f"activation is the frame's at their stride, and bands of a row or more")
    return out


def band_forward(module: nn.Module, x: torch.Tensor, fill: float, op) -> torch.Tensor:
    """`op(rows)` of this rank's band `x` of a window op's input (kernel,
    stride, padding and dilation from `module`; the height's padding
    replaced by the rows the band's windows read, from whichever ranks own
    them, and `fill` beyond the image): this rank's band of the output
    (parallel/spatial.py, `Grid.bands`). Any window serves, centred or
    not, so long as its output over the whole activation,
    floor((H + 2p - d(k-1) - 1) / s) + 1 rows and as many columns by the
    width's terms, is the frame's at the output's stride (`_check_out`);
    ceil mode is refused."""
    (k, kw), (s, sw) = _pair(module.kernel_size), _pair(module.stride)
    (p, pw), (d, dw) = _pair(module.padding), _pair(module.dilation)
    grid, span = module.grid, d * (k - 1)
    stride, bands = grid.band_of(x, module.site)
    what = f"{k}x{k} window at stride {s}, dilation {d}, padding {p}"
    if getattr(module, "ceil_mode", False):
        raise ValueError(f"{module.site}: the {what} in ceil mode does not split over "
                         f"the grid {grid.shape}")
    out = _check_out(module, grid, what, (bands[-1][1] + 2 * p - span - 1) // s + 1,
                     (x.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1, stride * s)
    # the rows the band's windows span; at least down to the band's end,
    # which completes no further window and keeps the op's input whole
    needs = [(s * lo - p, max(s * (hi - 1) - p + span + 1, band[1]))
             for (lo, hi), band in zip(out, bands)]
    return op(grid.fetch_rows(x, bands, needs, fill))


class Conv2d(nn.Conv2d):
    """`nn.Conv2d`; under a spatial grid (`grid`, which
    parallel/spatial.py:`spatial_rows` sets for a block, `site` its name)
    a window taller than a row, or a strided one, convolves this rank's
    band of rows, the height's zero padding replaced by the rows its
    windows read from the other ranks; a pointwise one (1x1, stride 1)
    works on any rows as they are."""

    grid = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _), (p, _), (d, _) = (self.kernel_size, self.stride, self.padding,
                                          self.dilation)
        if self.grid is None or (k, s) == (1, 1):
            return super().forward(x)
        if (s, d) == (1, 1):
            # with the height padded as in one process and the p extra rows
            # at each end cropped: cuDNN's heuristics took an FFT algorithm
            # with a 3.7 GB workspace for the backward of a band padded in
            # width alone (PERF.md §6, PR 25)
            return band_forward(self, x, 0.0, lambda e: F.conv2d(
                e, self.weight, self.bias, 1, self.padding, 1,
                self.groups)[:, :, p:e.shape[2] + p - (k - 1)])
        return band_forward(self, x, 0.0, lambda e: F.conv2d(
            e, self.weight, self.bias, self.stride, (0, self.padding[1]),
            self.dilation, self.groups))


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d`; under a spatial grid (`grid`, as `Conv2d`'s)
    it gives this rank's band of the output, whose stride is the input's
    over the op's stride s: output row o takes input rows i with
    o = s·i - p + t, t in [0, k), so the band [lo, hi) reads input rows
    [ceil((lo + p - k + 1) / s), floor((hi - 1 + p) / s) + 1), fetched from
    their owners (zero beyond the image), transposed-convolved with no
    height padding and cropped to the band (the bias lands once on each
    output row). Its output over the whole activation, (H - 1)s - 2p + k
    rows and as many columns by the width's terms, must be the frame's at
    its stride (`_check_out`)."""

    grid = None

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        if self.grid is None:
            return super().forward(x, output_size)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        grid = self.grid
        stride, bands = grid.band_of(x, self.site)
        what = f"{k}x{k} transposed window at stride {s}, padding {p}"
        if output_size is not None or self.dilation[0] != 1 or \
                self.output_padding[0] or k < s or stride % s:
            raise ValueError(
                f"{self.site}: the {what} does not split over the grid {grid.shape} at "
                f"stride {stride}: the grid takes undilated transposed windows no "
                f"shorter than their stride, without an output size or padding, from "
                f"an input whose stride theirs divides")
        kw, sw, pw = self.kernel_size[1], self.stride[1], self.padding[1]
        out = _check_out(self, grid, what, (bands[-1][1] - 1) * s - 2 * p + k,
                         (x.shape[3] - 1) * sw - 2 * pw + kw, stride // s)
        needs = [(-(-(lo + p - k + 1) // s), (hi - 1 + p) // s + 1) for lo, hi in out]
        (lo, hi), (a, _) = out[grid.m], needs[grid.m]
        y = F.conv_transpose2d(grid.fetch_rows(x, bands, needs, 0.0), self.weight, self.bias,
                               self.stride, (0, self.padding[1]), (0, self.output_padding[1]),
                               self.groups, self.dilation)
        return y[:, :, lo - s * a + p:hi - s * a + p]


class MaxPool2d(nn.MaxPool2d):
    """`nn.MaxPool2d`; under a spatial grid, as `Conv2d`, with -inf beyond
    the image."""

    grid = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.grid is None:
            return super().forward(x)
        return band_forward(self, x, float("-inf"), lambda e: F.max_pool2d(
            e, self.kernel_size, self.stride, (0, _pair(self.padding)[1]),
            self.dilation, self.ceil_mode))


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update of `running_var` uses the
    biased batch variance, as flax's `BatchNorm` updates `batch_stats`.

    torch's update is running = (1 - m) running + m var * n / (n - 1) over
    the n values per channel; this one subtracts m var / (n - 1), which is
    (running_new - (1 - m) running_old) / n, after torch's fused kernel ran,
    so both modes keep cuDNN's kernel and the normalisation (which uses the
    biased variance in both frameworks) is untouched. The kernel updates a
    copy of the buffer, which autograd keeps for the backward; the buffer
    itself takes the corrected value.

    Under a data group of several ranks (`group`, which
    parallel/dist.py:`global_batch_norm` sets for a train step) train mode
    normalises over the global batch, as the JAX package's one GSPMD
    program does: see `_global_forward`. Eval mode, and train mode without
    a group, take the path above."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.group is not None:
            return self._global_forward(x)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(
                var - (var - (1.0 - self.momentum) * self.running_var) / n)
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BatchNorm over the group's global batch: each rank's
        per-channel sum and sum of squares of x - shift and its count, in
        at least float32 (`_ShiftedSums`), summed over the ranks by one
        all-reduce that carries the gradient (`DataGroup.sum_`); the global
        mean and biased variance normalise the local rows (`_Normalize`)
        and update the running statistics (the biased update, as above).
        The shift is the global batch's mean (one all-reduce of the sums,
        without gradient) rounded to bfloat16: within 2^-9 of the mean, so
        the sum of squares does not cancel where a channel's variance is
        small beside its mean (a map constant over each frame, as
        UPerNet's scale-1 pyramid branch; a float32 sum of squares about 0
        loses that variance), and the same however the batch is split
        over ranks (a grid's bands, the data ranks' frames), so those
        splits differ only in the order of their sums. Both steps keep
        only x for the backward, as cuDNN's BatchNorm does, not the centred
        copies."""
        acc = acc_dtype(x)
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=acc, device=x.device)
        with torch.no_grad():
            sums = self.group.all_reduce_(torch.cat([x.to(acc).sum(_NOT_CHANNEL), count]))
            shift = (sums[:c] / sums[c]).to(torch.bfloat16).to(acc)
        stats = self.group.sum_(torch.cat([*_ShiftedSums.apply(x, shift), count]))
        n = stats[2 * c]
        d = stats[:c] / n
        var = stats[c:2 * c] / n - d * d
        y = _Normalize.apply(x, shift + d, torch.rsqrt(var + self.eps),
                             self.weight.to(acc), self.bias.to(acc))
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(
                m * (shift + d).to(self.running_mean.dtype))
            self.running_var.mul_(1.0 - m).add_(m * var.to(self.running_var.dtype))
        return y


_CHANNEL = (1, -1, 1, 1)
_NOT_CHANNEL = (0, 2, 3)


class _ShiftedSums(torch.autograd.Function):
    """Per-channel sums of NCHW x - shift and of its square, in the
    shift's dtype; saves x alone (the backward recomputes x - shift)."""

    @staticmethod
    def forward(ctx, x, shift):
        ctx.save_for_backward(x, shift)
        xc = x.to(shift.dtype) - shift.view(_CHANNEL)
        return xc.sum(_NOT_CHANNEL), (xc * xc).sum(_NOT_CHANNEL)

    @staticmethod
    def backward(ctx, g1, g2):
        x, shift = ctx.saved_tensors
        xc = x.to(shift.dtype) - shift.view(_CHANNEL)
        dx = g1.view(_CHANNEL) + 2.0 * xc * g2.view(_CHANNEL)
        return dx.to(x.dtype), None


class _Normalize(torch.autograd.Function):
    """(x - mean) * invstd * weight + bias per channel of NCHW x, in the
    vectors' dtype, returned in x's; saves x and the vectors alone."""

    @staticmethod
    def forward(ctx, x, mean, invstd, weight, bias):
        ctx.save_for_backward(x, mean, invstd, weight)
        xc = x.to(mean.dtype) - mean.view(_CHANNEL)
        return (xc * (invstd * weight).view(_CHANNEL) + bias.view(_CHANNEL)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, invstd, weight = ctx.saved_tensors
        g = g.to(mean.dtype)
        xc = x.to(mean.dtype) - mean.view(_CHANNEL)
        g_xc = (g * xc).sum(_NOT_CHANNEL)
        d_bias = g.sum(_NOT_CHANNEL)
        dx = g * (invstd * weight).view(_CHANNEL)
        return (dx.to(x.dtype), -d_bias * invstd * weight, g_xc * weight,
                g_xc * invstd, d_bias)


def batch_norm(channels: int, momentum: float = BN_MOMENTUM,
               eps: float = BN_EPS) -> BatchNorm2d:
    """BatchNorm at torch `momentum` (1 - the flax momentum) and `eps`."""
    return BatchNorm2d(channels, eps=eps, momentum=momentum)


class ConvBN(nn.Sequential):
    """Conv -> BatchNorm -> ReLU as `Sequential(conv, bn, relu)`: the keys
    `<name>.0.weight`, `<name>.1.running_mean`, ... of the reference."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 bias: bool = False, bn_momentum: float = BN_MOMENTUM):
        p = torch_pad(kernel_size, stride, dilation)
        super().__init__(
            Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                      padding=p, dilation=dilation, bias=bias),
            batch_norm(out_channels, bn_momentum),
            nn.ReLU(inplace=True))


def global_avg_pool(x: torch.Tensor, grid=None) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) -> (N, C, 1, 1), averaged in >= f32 and returned
    in `x.dtype`, as the JAX package's `global_avg_pool`. Under a spatial
    `grid` `x` is this rank's band: its sum summed over the model ranks
    (with gradient) over the whole activation's count, the same on every
    model rank."""
    acc = acc_dtype(x)
    if grid is None:
        return x.to(acc).mean(dim=(2, 3), keepdim=True).to(x.dtype)
    _, bands = grid.band_of(x)
    total = grid.model_sum(x.to(acc).sum(dim=(2, 3), keepdim=True))
    return (total / (bands[-1][1] * x.shape[3])).to(x.dtype)


def upsample_like(x: torch.Tensor, ref_hw: tuple[int, int],
                  align_corners: bool = True, grid=None,
                  whole_source: bool = False) -> torch.Tensor:
    """Bilinear resize of NCHW `x` to `ref_hw`. Under a spatial `grid`
    `ref_hw` is the target band's size and `x` this rank's band of an
    activation: the band's rows of the whole resize, rows of the global
    interpolation matrix over the source rows they read, fetched from the
    ranks that own them (`Grid.fetch_rows`, whose backward returns their
    gradients). With `whole_source` `x` is whole on every model rank (a
    pooled map): the band's rows of the matrix over all of its rows, and
    nothing to fetch; each rank's gradient of `x` is then its band's part."""
    if grid is None:
        return resize_bilinear(x, ref_hw, align_corners=align_corners)
    dst = grid.bands(grid.stride_of(ref_hw[1]))
    lo, hi = dst[grid.m]
    if whole_source:
        mh = interp_matrix(x.shape[2], dst[-1][1], align_corners)
        return resize_rows(x, mh[lo:hi], ref_hw[1], align_corners)
    _, src = grid.band_of(x)
    mh = interp_matrix(src[-1][1], dst[-1][1], align_corners)
    needs = []
    for b_lo, b_hi in dst:
        cols = np.flatnonzero((mh[b_lo:b_hi] != 0).any(axis=0))
        needs.append((int(cols[0]), int(cols[-1]) + 1))
    a, b = needs[grid.m]
    return resize_rows(grid.fetch_rows(x, src, needs, 0.0), mh[lo:hi, a:b],
                       ref_hw[1], align_corners)


def _pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 averaging matrix of torch's adaptive bins
    [floor(i n_in / n_out), ceil((i + 1) n_in / n_out)), which overlap
    where n_out does not divide n_in."""
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        lo, hi = (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int], grid=None) -> torch.Tensor:
    """AdaptiveAvgPool2d(out_hw) of NCHW `x` as two small products over
    torch's bins (the JAX package's `adaptive_avg_pool`), accumulated in
    >= f32 and returned in `x.dtype`. Under a spatial `grid` `x` is this
    rank's band: its columns of the whole activation's height matrix
    (bins may straddle bands) times the band, summed over the model ranks
    (with gradient), so the pooled map is whole and alike on every model
    rank."""
    acc = acc_dtype(x)
    if grid is None:
        mh = _pool_matrix(x.shape[2], out_hw[0])
    else:
        _, bands = grid.band_of(x)
        lo, hi = bands[grid.m]
        mh = _pool_matrix(bands[-1][1], out_hw[0])[:, lo:hi]
    mh = torch.as_tensor(mh, dtype=acc, device=x.device)
    mw = torch.as_tensor(_pool_matrix(x.shape[3], out_hw[1]), dtype=acc,
                         device=x.device)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.matmul(torch.matmul(mh, x.to(acc)), mw.t())
    if grid is not None:
        y = grid.model_sum(y)
    return y.to(x.dtype)
