"""Shared NCHW building blocks with the reference's torch layer semantics.

Port of the JAX package's models/layers.py. BatchNorm uses eps 1e-5 and
torch momentum 0.1 by default (flax momentum 0.9 is torch momentum 0.1;
HRNet's torch 0.01 is flax 0.99), and updates
its running variance in train mode with the biased batch variance, as
flax does (`BatchNorm2d`). Modules keep the reference's torch state-dict
names, so a published checkpoint loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear

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


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update of `running_var` uses the
    biased batch variance, as flax's `BatchNorm` updates `batch_stats`.

    torch's update is running = (1 - m) running + m var * n / (n - 1) over
    the n values per channel; this one subtracts m var / (n - 1), which is
    (running_new - (1 - m) running_old) / n, after torch's fused kernel ran,
    so both modes keep cuDNN's kernel and the normalisation (which uses the
    biased variance in both frameworks) is untouched. The kernel updates a
    copy of the buffer, which autograd keeps for the backward; the buffer
    itself takes the corrected value."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(
                var - (var - (1.0 - self.momentum) * self.running_var) / n)
        return y


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
            nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                      padding=p, dilation=dilation, bias=bias),
            batch_norm(out_channels, bn_momentum),
            nn.ReLU(inplace=True))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) -> (N, C, 1, 1), averaged in >= f32 and returned
    in `x.dtype`, as the JAX package's `global_avg_pool`."""
    return x.to(acc_dtype(x)).mean(dim=(2, 3), keepdim=True).to(x.dtype)


def upsample_like(x: torch.Tensor, ref_hw: tuple[int, int],
                  align_corners: bool = True) -> torch.Tensor:
    return resize_bilinear(x, ref_hw, align_corners=align_corners)


def _pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 averaging matrix of torch's adaptive bins
    [floor(i n_in / n_out), ceil((i + 1) n_in / n_out)), which overlap
    where n_out does not divide n_in."""
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        lo, hi = (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """AdaptiveAvgPool2d(out_hw) of NCHW `x` as two small products over
    torch's bins (the JAX package's `adaptive_avg_pool`), accumulated in
    >= f32 and returned in `x.dtype`."""
    acc = acc_dtype(x)
    mh = torch.as_tensor(_pool_matrix(x.shape[2], out_hw[0]), dtype=acc,
                         device=x.device)
    mw = torch.as_tensor(_pool_matrix(x.shape[3], out_hw[1]), dtype=acc,
                         device=x.device)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.matmul(torch.matmul(mh, x.to(acc)), mw.t())
    return y.to(x.dtype)
