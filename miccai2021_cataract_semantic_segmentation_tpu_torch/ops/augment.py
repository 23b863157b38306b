"""Eval-time preprocessing constants and the vertical reflect pad.

Port of the parts of the JAX package's ops/augment.py that the eval steps
use. The train augmentations (flip, blur, colorjitter) come with the
training slice.
"""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pad_reflect_hw(x: torch.Tensor, ver: int = 2) -> torch.Tensor:
    """(B,H,W,...) -> (B,H+2*ver,W,...) vertical reflect pad (numpy
    "reflect": the edge row is not repeated). Works on any dtype."""
    h = x.shape[1]
    idx = torch.cat([torch.arange(ver, 0, -1), torch.arange(h),
                     torch.arange(h - 2, h - 2 - ver, -1)]).to(x.device)
    return x.index_select(1, idx)
