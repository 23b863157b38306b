"""Small conv + FC discriminator (the reference's
models/simple_discriminator.py; no shipped config uses it).

Port of the JAX package's models/discriminator.py: three unpadded stride-2
convolutions (5x5 to d channels, 3x3 to 2d, 3x3 to 4d), each followed by
BatchNorm (torch momentum 0.1) and ReLU, then `fc1` (32 units, ReLU) and
`fc2` (1 unit, sigmoid); the forward returns the (N, 1) probabilities.

flax's Dense takes its input size from the first call. The port fixes it
at construction from `input_hw`, the (H, W) of the images the model will
see (544x960 unless the graph says otherwise): each convolution maps a
side s to (s - k) // 2 + 1, and fc1 reads 4d times the product of the two
final sides. A forward at another size raises. The features are flattened
in (H, W, C) order, as the JAX model flattens its NHWC maps, so that
`fc1`'s weight lines up with the flax kernel's rows.
"""
from __future__ import annotations

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import batch_norm

_CONVS = ((1, 5), (2, 3), (4, 3))        # (multiple of d, kernel)


def feature_hw(input_hw) -> tuple[int, int]:
    """The (H, W) of the last convolution's output for an `input_hw` input."""
    h, w = input_hw
    for _, k in _CONVS:
        h, w = (h - k) // 2 + 1, (w - k) // 2 + 1
    return h, w


class SimpleDiscriminator(nn.Module):
    def __init__(self, d: int = 64, input_hw=(544, 960)):
        super().__init__()
        self.input_hw = tuple(input_hw)
        c_in = 3
        for i, (m, k) in enumerate(_CONVS):
            setattr(self, f"conv{i + 1}", nn.Conv2d(c_in, m * d, k, stride=2))
            setattr(self, f"bn{i + 1}", batch_norm(m * d))
            c_in = m * d
        h, w = feature_hw(self.input_hw)
        if h < 1 or w < 1:
            raise ValueError(f"input_hw {self.input_hw} is too small for the "
                             "discriminator's three convolutions")
        self.fc1 = nn.Linear(h * w * c_in, 32)
        self.fc2 = nn.Linear(32, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != self.input_hw:
            raise ValueError(f"the discriminator was built for {self.input_hw} "
                             f"inputs, got {tuple(x.shape[2:])}")
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(x))))
