"""torchvision-compatible dilated ResNet backbones (BasicBlock ResNet-18/34,
Bottleneck ResNet-50/101, ResNeXt-50 32x4d / 101 32x8d and WideResNet-50/101
x2) and the residual blocks HRNet builds from.

Port of the JAX package's models/resnet.py with torchvision's module names
(`conv1`, `bn1`, `layer1.0.conv2`, `layer2.0.downsample.0`, ...), so the
reference checkpoints load directly. `dilate_stages` is torchvision's
`replace_stride_with_dilation` for (layer2, layer3, layer4); the first
block of a dilated layer keeps the previous dilation for its 3x3 conv.
`BasicBlock` also serves HRNet's branches. Both blocks take the torch
BatchNorm momentum of their graph (`bn_momentum`). ResNeXt and WideResNet
are Bottleneck ResNets whose 3x3 convolution is grouped (`groups`) and
`int(planes * base_width / 64) * groups` wide, as torchvision builds them;
their state-dict names are ResNet's.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    BN_MOMENTUM, Conv2d, MaxPool2d, batch_norm)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn1 = batch_norm(planes, bn_momentum)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = batch_norm(planes, bn_momentum)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            Conv2d(in_planes, planes, 1, stride=stride, bias=False),
            batch_norm(planes, bn_momentum)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 bn_momentum: float = BN_MOMENTUM, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        out = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2d(in_planes, width, 1, bias=False)
        self.bn1 = batch_norm(width, bn_momentum)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=dilation,
                               dilation=dilation, groups=groups, bias=False)
        self.bn2 = batch_norm(width, bn_momentum)
        self.conv3 = Conv2d(width, out, 1, bias=False)
        self.bn3 = batch_norm(out, bn_momentum)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            Conv2d(in_planes, out, 1, stride=stride, bias=False),
            batch_norm(out, bn_momentum)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


# name: (block, blocks per stage, groups, base width)
_ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}

# the reference EncDec's encoder names
ENCODER_ALIASES = {
    "ResNet18": "resnet18", "ResNet34": "resnet34",
    "ResNet50": "resnet50", "ResNet101": "resnet101",
    "ResNeXt50": "resnext50_32x4d", "ResNeXt101": "resnext101_32x8d",
    "WideResNet50": "wide_resnet50_2", "WideResNet101": "wide_resnet101_2",
}


def _check_arch(arch: str) -> None:
    if arch not in _ARCHS:
        raise ValueError(f"Unknown backbone '{arch}'")


def output_channels(arch: str) -> tuple[int, int, int, int]:
    """Output channels of layer1..layer4 of `arch`."""
    _check_arch(arch)
    block = _ARCHS[arch][0]
    return tuple(p * block.expansion for p in (64, 128, 256, 512))


class ResNetBackbone(nn.Module):
    """4-stage feature extractor returning {'layer1'..'layer4'}."""

    def __init__(self, arch: str = "resnet50",
                 dilate_stages: Sequence[bool] = (False, False, False)):
        super().__init__()
        _check_arch(arch)
        block, layer_sizes, groups, base_width = _ARCHS[arch]
        wide = {"groups": groups, "base_width": base_width} \
            if block is Bottleneck else {}
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d(3, stride=2, padding=1)
        dilation, in_planes = 1, 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layer_sizes)):
            stride = 1 if li == 0 else 2
            dilated = li > 0 and dilate_stages[li - 1]
            if dilated:
                dilation *= stride
                stride = 1
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                d = dilation // (2 if (bi == 0 and dilated) else 1)
                need_ds = bi == 0 and (s != 1 or
                                       in_planes != planes * block.expansion)
                layer.append(block(in_planes, planes, s, max(d, 1), need_ds,
                                   **wide))
                in_planes = planes * block.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*layer))
        # torchvision's initialisation (kaiming-normal fan-out convs)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        feats = {}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats[f"layer{i}"] = x
        return feats
