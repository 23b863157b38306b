"""DeepLabv3 and DeepLabv3+ (atrous ResNet + ASPP [+ decoder]).

Port of the JAX package's models/deeplab.py with the reference's torch
module names: the ASPP's convolutions are bare modules `aspp.aspp1` ..
`aspp.aspp5` beside their BatchNorms `aspp.aspp1_bn` .. `aspp.aspp5_bn`,
the projection is `aspp.conv2` / `aspp.bn2`; the classifier is `conv_out`
(v3) or `decoder.conv_out` (v3+), whose decoder holds `conv_low`,
`conv_3x3_1`, `conv_3x3_2` and their `*_bn`.
  * ASPP rates 6/12/18 x mult (mult 2 below out_stride 16), an image-pool
    branch upsampled from 1x1 with align_corners=True, the 5-way concat,
    then the 1x1 projection;
  * v3+ adds the 48-channel layer-1 lateral (first in the concat) and two
    3x3 convolutions at stride 4;
  * the reference passes momentum 0.0003 positionally where torch's
    BatchNorm2d takes eps, so the ASPP and decoder BatchNorms run at
    eps 3e-4 and the default momentum.
Outputs: `logits_s8` (the classifier's output in >= f32: stride 8 for v3
at out_stride 8, stride 4 for v3+ whatever the name says), `deep_features`
(layer 4), `logits` (the align_corners=True upsample to the input size)
when `full_res` asks for it, and with a `projector` section
`proj_features`, the projection head (models/projector.py) on layer 4.
"""
from __future__ import annotations

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    batch_norm, global_avg_pool, to_f32, upsample_like)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.projector import (
    build_projector)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (
    ResNetBackbone, output_channels)

ASPP_BN_EPS = 3e-4   # the reference's momentum argument lands on eps


def dilate_stages(out_stride: int) -> tuple[bool, bool, bool]:
    """The reference's out_stride -> (layer2, layer3, layer4) dilation
    flags, including its all-True row for out_stride 32."""
    return {8: (False, True, True), 16: (False, False, True),
            32: (True, True, True)}[out_stride]


def _conv(c_in: int, c_out: int, k: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


class ASPP(nn.Module):
    def __init__(self, c_in: int, c_aspp: int = 256, mult: int = 1):
        super().__init__()
        self.aspp1 = _conv(c_in, c_aspp, 1)
        for i, rate in enumerate((6, 12, 18)):
            setattr(self, f"aspp{i + 2}", _conv(c_in, c_aspp, 3, rate * mult))
        self.aspp5 = _conv(c_in, c_aspp, 1)
        for i in range(1, 6):
            setattr(self, f"aspp{i}_bn", batch_norm(c_aspp, eps=ASPP_BN_EPS))
        self.conv2 = _conv(5 * c_aspp, c_aspp, 1)
        self.bn2 = batch_norm(c_aspp, eps=ASPP_BN_EPS)
        self.relu = nn.ReLU(inplace=True)

    def _branch(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.relu(getattr(self, f"aspp{i}_bn")(getattr(self, f"aspp{i}")(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self._branch(i, x) for i in range(1, 5)]
        pooled = self._branch(5, global_avg_pool(x))
        branches.append(upsample_like(pooled, x.shape[2:], align_corners=True))
        return self.relu(self.bn2(self.conv2(torch.cat(branches, dim=1))))


class Decoder(nn.Module):
    """DeepLabv3+'s decoder: the layer-1 lateral, two 3x3 convolutions and
    the classifier."""

    def __init__(self, c_low: int, c_aspp: int, num_classes: int,
                 c_low_reduced: int = 48, c_decoder: int = 256):
        super().__init__()
        self.conv_low = _conv(c_low, c_low_reduced, 1)
        self.conv_low_bn = batch_norm(c_low_reduced, eps=ASPP_BN_EPS)
        self.conv_3x3_1 = _conv(c_low_reduced + c_aspp, c_decoder, 3)
        self.conv_3x3_1_bn = batch_norm(c_decoder, eps=ASPP_BN_EPS)
        self.conv_3x3_2 = _conv(c_decoder, c_decoder, 3)
        self.conv_3x3_2_bn = batch_norm(c_decoder, eps=ASPP_BN_EPS)
        self.conv_out = nn.Conv2d(c_decoder, num_classes, 1, bias=True)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, y: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        lateral = self.relu(self.conv_low_bn(self.conv_low(low)))
        y = upsample_like(y, low.shape[2:], align_corners=True)
        y = torch.cat([lateral, y], dim=1)
        y = self.relu(self.conv_3x3_1_bn(self.conv_3x3_1(y)))
        y = self.relu(self.conv_3x3_2_bn(self.conv_3x3_2(y)))
        return self.conv_out(y)


class _DeepLab(nn.Module):
    """The dilated backbone and the ASPP; a subclass adds its head."""

    def __init__(self, backbone: str, out_stride: int, c_aspp: int,
                 projector: dict | None):
        super().__init__()
        self.backbone = ResNetBackbone(backbone, dilate_stages(out_stride))
        self.aspp = ASPP(output_channels(backbone)[3], c_aspp,
                         1 if out_stride >= 16 else 2)
        self.projector = build_projector(projector, output_channels(backbone)[3])

    def forward(self, x: torch.Tensor,
                full_res: tuple[str, ...] = ("logits",)) -> dict:
        """NCHW input -> output dict (NCHW, >= f32 logits). `full_res`
        names the full-size upsamples to compute (`logits` or none): a
        train step whose loss and metric read `logits_s8` leaves it out,
        as XLA drops it from the JAX program."""
        feats = self.backbone(x)
        logits = self.head(feats)
        out = {"logits_s8": to_f32(logits), "deep_features": feats["layer4"]}
        if "logits" in full_res:
            out["logits"] = to_f32(upsample_like(logits, x.shape[2:]))
        if self.projector is not None:
            out["proj_features"] = self.projector(feats["layer4"])
        return out


class DeepLabv3(_DeepLab):
    def __init__(self, task: int = 2, backbone: str = "resnet50",
                 out_stride: int = 16, c_aspp: int = 256,
                 projector: dict | None = None):
        super().__init__(backbone, out_stride, c_aspp, projector)
        self.conv_out = nn.Conv2d(c_aspp, taxonomy.TASK_NUM_CLASSES[task], 1,
                                  bias=True)

    def head(self, feats: dict) -> torch.Tensor:
        return self.conv_out(self.aspp(feats["layer4"]))


class DeepLabv3Plus(_DeepLab):
    def __init__(self, task: int = 2, backbone: str = "resnet50",
                 out_stride: int = 16, c_aspp: int = 256,
                 projector: dict | None = None):
        super().__init__(backbone, out_stride, c_aspp, projector)
        self.decoder = Decoder(output_channels(backbone)[0], c_aspp,
                               taxonomy.TASK_NUM_CLASSES[task])

    def head(self, feats: dict) -> torch.Tensor:
        return self.decoder(self.aspp(feats["layer4"]), feats["layer1"])
