"""HRNetv2 backbone + segmentation head (reference models/HRNetv2.py).

Port of the JAX package's models/hrnet.py. Four stages of parallel
multi-resolution branches with full cross-resolution fusion after each
module; branch widths (w, 2w, 4w, 8w), BasicBlocks after the Bottleneck
stem stage, BatchNorm at torch momentum 0.01 (flax 0.99). Every fuse and
head upsample is bilinear with align_corners=False. The forward returns
full-resolution `logits` and nothing at stride 8, so the losses take
their full-resolution routes.

Under a spatial grid (parallel/spatial.py, `grid`) every branch holds this
rank's band of its rows: the convolutions are models/layers.py's `Conv2d`
(the strided fuse chains on bands of any height), the fuse layers'
upsamples and the head's concatenation read the source rows their band
needs from the other ranks (`upsample_like`), and `HRNetv2`'s forward
gives its band of the stride-4 logits as `logits_s4` and no
full-resolution output: the steps gather them whole and upsample them
with align_corners=False (`BAND_OUTPUTS`, `ALIGN_CORNERS`).

Modules carry the reference's torch state-dict names, which the JAX
package's train/port_torch.py:port_hrnet maps from: `conv1`/`bn1`,
`conv2`/`bn2`, `layer1.{b}`, `transition{t}.{i}.0/1` (a new branch:
`.0.0/.0.1`), `stage{s}.0.branches.{i}.{b}`,
`stage{s}.0.fuse_layers.{i}.{j}[.{k}].0/1` and `last_layer.0/1/3`. Entries
the reference leaves empty (a transition that keeps its branch, a fuse
layer from a branch to itself) are None, so the indices line up.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    Conv2d, batch_norm, to_f32, upsample_like)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck)

BN_MOMENTUM = 0.01  # torch momentum of the reference's HRNet (flax 0.99)


def _conv_bn(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
             relu: bool = True, bias: bool = False) -> nn.Sequential:
    """Sequential(conv, bn[, relu]): the reference's keys `.0` and `.1`."""
    mods = [Conv2d(in_ch, out_ch, kernel, stride=stride,
                   padding=kernel // 2, bias=bias),
            batch_norm(out_ch, BN_MOMENTUM)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


def _branch(in_ch: int, width: int, num_blocks: int = 4) -> nn.Sequential:
    """num_blocks BasicBlocks at constant width (a 1x1 projection on the
    first where the input width differs)."""
    return nn.Sequential(*[
        BasicBlock(in_ch if b == 0 else width, width,
                   downsample=b == 0 and in_ch != width,
                   bn_momentum=BN_MOMENTUM)
        for b in range(num_blocks)])


class _FuseModule(nn.Module):
    """One HighResolutionModule: per-branch blocks then full fusion
    (HRNetv2.py:116-260)."""

    grid = None          # a spatial grid (parallel/spatial.py:`spatial_rows`)

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(_branch(w, w) for w in widths)
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:    # lower resolution: 1x1 conv-bn, then upsample
                    row.append(_conv_bn(widths[j], widths[i], 1, relu=False))
                elif j < i:  # higher resolution: strided 3x3s
                    row.append(nn.Sequential(*[
                        _conv_bn(widths[j], widths[i] if k == i - j - 1
                                 else widths[j], 3, 2, relu=k < i - j - 1)
                        for k in range(i - j)]))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)
        self.relu = nn.ReLU()

    def forward(self, xs: list) -> list:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    z = xs[j]
                elif j > i:
                    z = upsample_like(layer(xs[j]), xs[i].shape[2:],
                                      align_corners=False, grid=self.grid)
                else:
                    z = layer(xs[j])
                y = z if y is None else y + z
            fused.append(self.relu(y))
        return fused


class HRNetTrunk(nn.Module):
    """Stem + stage 1 + stages 2-4 of HRNetv2; the forward returns the four
    branch maps (strides 4/8/16/32, widths w/2w/4w/8w) (JAX
    `hrnet_trunk`). A graph on HRNet subclasses it, so the trunk's modules
    keep their reference names at the graph's top level."""

    grid = None          # a spatial grid (parallel/spatial.py:`spatial_rows`)

    def __init__(self, width: int = 32):
        super().__init__()
        widths = [width, 2 * width, 4 * width, 8 * width]
        self.widths = widths
        # stem: two strided 3x3 convs (stride 4 in all)
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = batch_norm(64, BN_MOMENTUM)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = batch_norm(64, BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        # stage 1: 4 Bottlenecks of `width` planes (4 * width channels)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if b == 0 else 4 * width, width, downsample=b == 0,
                       bn_momentum=BN_MOMENTUM) for b in range(4)])
        chans = [4 * width]
        for stage in (2, 3, 4):
            trans = []
            for i in range(stage):
                if i < len(chans):   # existing branch: a 3x3 where widths differ
                    trans.append(_conv_bn(chans[i], widths[i])
                                 if chans[i] != widths[i] else None)
                else:                # new branch: strided 3x3 off the lowest
                    trans.append(nn.Sequential(
                        _conv_bn(chans[-1], widths[i], 3, 2)))
            self.add_module(f"transition{stage - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{stage}",
                            nn.Sequential(_FuseModule(widths[:stage])))
            chans = widths[:stage]

    def forward(self, x: torch.Tensor) -> list:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for stage in (2, 3, 4):
            trans = getattr(self, f"transition{stage - 1}")
            xs = [xs[i] if t is None and i < len(xs)
                  else t(xs[i] if i < len(xs) else xs[-1])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{stage}")[0](xs)
        return xs


def hrnet_concat(xs: list, align_corners: bool = False, grid=None) -> torch.Tensor:
    """Concat all branches at 1/4 resolution (HRNetv2.py:505-513); under a
    spatial `grid`, this rank's band of it."""
    hw = xs[0].shape[2:]
    return torch.cat([xs[0]] + [upsample_like(z, hw, align_corners=align_corners, grid=grid)
                                for z in xs[1:]], dim=1)


class HRNetv2(HRNetTrunk):
    # under a spatial grid: the band output whose whole upsample is each
    # full-resolution output, and the upsample's convention
    BAND_OUTPUTS = {"logits": "logits_s4"}
    ALIGN_CORNERS = False

    def __init__(self, task: int = 2, width: int = 32):
        super().__init__(width)
        num_classes = taxonomy.TASK_NUM_CLASSES[task]
        total = sum(self.widths)
        # the reference's last_layer keeps torch's default bias on both 1x1
        # convs (HRNetv2.py:285-292): Sequential(conv, bn, relu, cls)
        self.last_layer = nn.Sequential(
            nn.Conv2d(total, total, 1, bias=True),
            batch_norm(total, BN_MOMENTUM), nn.ReLU(inplace=True),
            nn.Conv2d(total, num_classes, 1, bias=True))

    def forward(self, x: torch.Tensor) -> dict:
        """NCHW input -> {"logits": NCHW >= f32 logits at input size}; under
        a spatial grid {"logits_s4": this rank's band of the stride-4
        logits}."""
        y = self.last_layer(hrnet_concat(super().forward(x), grid=self.grid))
        if self.grid is not None:
            return {"logits_s4": to_f32(y)}
        return {"logits": to_f32(upsample_like(y, x.shape[2:],
                                               align_corners=False))}
