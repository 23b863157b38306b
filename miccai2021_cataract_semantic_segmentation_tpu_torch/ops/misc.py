"""Small tensor utilities of the train step.

Port of `downsample_labels` from the JAX package's ops/misc.py.
"""
from __future__ import annotations

import torch


def downsample_labels(labels: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-sample (N, H, W) integer labels to a coarser grid (h, w) with
    centre-aligned indices floor((i + 0.5) * H / h): non-integer ratios stay
    aligned across the whole image, and h > H is defined. The indices are
    computed in float32 on the host, as the JAX package computes them."""
    _, big_h, big_w = labels.shape
    h, w = hw
    yi = torch.floor((torch.arange(h, dtype=torch.float32) + 0.5)
                     * (big_h / h)).long().to(labels.device)
    xi = torch.floor((torch.arange(w, dtype=torch.float32) + 0.5)
                     * (big_w / w)).long().to(labels.device)
    return labels[:, yi[:, None], xi[None, :]]
