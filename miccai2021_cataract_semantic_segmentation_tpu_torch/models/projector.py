"""Projection head for the dense-contrastive losses.

Port of the JAX package's models/projector.py (the reference's
models/Projector.py): a stack of conv -> ReLU (-> BatchNorm) layers given
by `mlp` = [[k, c, s], ...], then a 1x1 convolution to `d` channels. The
JAX package's weight porter has no table for it, so the torch names
follow its flax names: `mlp_{i}` (the convolutions, without bias when
`use_bn`), `mlp_bn_{i}` (BatchNorm at flax momentum 0.9997, torch 0.0003)
and `out` (with bias).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import batch_norm

PROJECTOR_BN_MOMENTUM = 1.0 - 0.9997


class Projector(nn.Module):
    def __init__(self, in_channels: int, d: int = 128,
                 mlp: Sequence[Sequence[int]] = (), use_bn: bool = False):
        super().__init__()
        self.n_layers, self.use_bn = len(mlp), use_bn
        c_in = in_channels
        for i, (k, c, s) in enumerate(mlp):
            p = (k - s + 1) // 2            # the reference's Projector.py:34
            setattr(self, f"mlp_{i}", nn.Conv2d(c_in, c, k, stride=s, padding=p,
                                                bias=not use_bn))
            if use_bn:
                setattr(self, f"mlp_bn_{i}", batch_norm(c, PROJECTOR_BN_MOMENTUM))
            c_in = c
        self.out = nn.Conv2d(c_in, d, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"mlp_{i}")(x))
            if self.use_bn:
                x = getattr(self, f"mlp_bn_{i}")(x)
        return self.out(x)


def build_projector(cfg: dict | None, in_channels: int) -> Projector | None:
    """The graph's `projector` section on `in_channels` features, or None."""
    return None if cfg is None else Projector(in_channels, **cfg)
