"""Inception-v3 encoder for EncDec.

Port of the JAX package's models/inception.py (the reference's
models/Inception.py): torchvision's inception_v3 up to Mixed_7c with its
module names (`Conv2d_1a_3x3.conv`, `Mixed_5b.branch1x1.bn`, ...), so a
torchvision checkpoint loads by name. Convolutions have no bias,
BatchNorm eps is 1e-3 (torch momentum 0.1). The stem and the reduction
convolutions are unpadded, so the maps have odd sizes (132x236 for
layer1 of a 544x960 input). Every branch's pool is torch's
avg_pool2d(3, stride 1, padding 1) with `count_include_pad=True`: zeros
padded and the window sum divided by 9 at the border too (JAX
`_avg_pool3`). The forward returns the reference's four cut points:
Conv2d_4a_3x3 (192 channels), Mixed_5d (288), Mixed_6e (768) and
Mixed_7c (2048) as `layer1`..`layer4`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import batch_norm

INCEPTION_CHANNELS = (192, 288, 768, 2048)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = batch_norm(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(3, stride 1, padding 1, count_include_pad=True)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(avg_pool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(avg_pool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _max_pool3(x)],
                         dim=1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(avg_pool3(x))], dim=1)


class InceptionV3Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        c1 = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3(x)))
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(_max_pool3(c1))))
        c2 = x
        x = self.Mixed_6a(x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        c3 = x
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return {"layer1": c1, "layer2": c2, "layer3": c3, "layer4": x}
