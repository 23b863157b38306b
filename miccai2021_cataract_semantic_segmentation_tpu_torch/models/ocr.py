"""OCRNet — the flagship graph, on a dilated ResNet.

Port of the JAX package's models/ocr.py with the reference's torch module
names (`interm_prediction_head`, `conv_high_map`,
`spatial_ocr_head.object_context_block.f_pixel`, `conv_out`, ...):
  * intermediate soft-object-region head off layer3;
  * 3x3 conv to 512ch pixel features off layer4;
  * spatial gather: per-class spatial softmax of the interm logits pools
    the pixel features into K class-context vectors;
  * object attention: 1x1-conv Q/K/V attention of pixels over the K context
    vectors, scaled by key_channels**-0.5, then concat + 1x1 fuse;
  * 1x1 classifier + bilinear (align_corners=True) upsample to input size;
  * with a `projector` section, the projection head (models/projector.py)
    on layer 4 as `proj_features`.

The gather and attention products run with autocast off in >= f32, as the
JAX graph accumulates them, and leave in the features' dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    ConvBN, acc_dtype, batch_norm, to_f32, upsample_like)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.projector import (
    build_projector)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (
    ResNetBackbone, output_channels)


def spatial_gather(feats: torch.Tensor, probs_logits: torch.Tensor,
                   scale: float = 1.0) -> torch.Tensor:
    """(B,C,H,W) feats + (B,K,H,W) class logits -> (B,K,C) class context."""
    b, c = feats.shape[:2]
    k = probs_logits.shape[1]
    acc = acc_dtype(feats)
    with torch.autocast(feats.device.type, enabled=False):
        probs = torch.softmax(
            scale * probs_logits.reshape(b, k, -1).to(acc), dim=2)
        f = feats.reshape(b, c, -1).to(acc)
        ctx = torch.bmm(probs, f.transpose(1, 2))
    return ctx.to(feats.dtype)


def _qkv_stack(in_ch: int, features: int, n_layers: int) -> nn.Sequential:
    """n_layers x (1x1 conv -> BN -> ReLU): keys 0, 1, 3, 4 as the reference."""
    mods = []
    for i in range(n_layers):
        mods += [nn.Conv2d(in_ch if i == 0 else features, features, 1,
                           bias=False),
                 batch_norm(features), nn.ReLU(inplace=True)]
    return nn.Sequential(*mods)


class ObjectAttention(nn.Module):
    """Pixel-to-class-context attention (`object_context_block`)."""

    def __init__(self, in_channels: int, key_channels: int = 256):
        super().__init__()
        self.key_channels = key_channels
        self.f_pixel = _qkv_stack(in_channels, key_channels, 2)
        self.f_object = _qkv_stack(in_channels, key_channels, 2)
        self.f_down = _qkv_stack(in_channels, key_channels, 1)
        self.f_up = _qkv_stack(key_channels, in_channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        kc = self.key_channels
        ctx4 = context.transpose(1, 2)[..., None]        # (B,C,K,1)
        query = self.f_pixel(x)
        key = self.f_object(ctx4)
        value = self.f_down(ctx4)
        acc = acc_dtype(x)
        with torch.autocast(x.device.type, enabled=False):
            q = query.reshape(b, kc, h * w).transpose(1, 2).to(acc)
            sim = torch.bmm(q, key.reshape(b, kc, -1).to(acc))  # (B,HW,K)
            sim = torch.softmax(sim * kc ** -0.5, dim=-1)
            v = value.reshape(b, kc, -1).transpose(1, 2).to(acc)
            out = torch.bmm(sim, v)                            # (B,HW,kc)
        out = out.transpose(1, 2).reshape(b, kc, h, w).to(x.dtype)
        return self.f_up(out)


class SpatialOCR(nn.Module):
    """Attention + concat (context first) + 1x1 fuse."""

    def __init__(self, in_channels: int = 512, key_channels: int = 256,
                 out_channels: int = 512, dropout: float = 0.0):
        super().__init__()
        self.object_context_block = ObjectAttention(in_channels, key_channels)
        self.conv_bn_dropout = nn.Sequential(
            nn.Conv2d(2 * in_channels, out_channels, 1, bias=False),
            batch_norm(out_channels), nn.ReLU(inplace=True),
            nn.Dropout(dropout))

    def forward(self, feats: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        ctx = self.object_context_block(feats, context)
        return self.conv_bn_dropout(torch.cat([ctx, feats], dim=1))


# the full-size outputs a forward computes unless told otherwise
FULL_RES = ("logits", "interm_logits")


def _ocr_dilate_stages(out_stride: int) -> tuple[bool, bool, bool]:
    """The out-stride table of the Bottleneck backbones."""
    return {8: (False, True, True), 16: (False, False, True),
            32: (False, False, False)}[out_stride]


class OCRNet(nn.Module):
    def __init__(self, task: int = 2, backbone: str = "resnet50",
                 out_stride: int = 8, dropout: float = 0.0,
                 projector: dict | None = None):
        super().__init__()
        num_classes = taxonomy.TASK_NUM_CLASSES[task]
        if backbone in ("resnet18", "resnet34"):
            raise NotImplementedError(
                "OCRNet on ResNet-18/34 (never dilated, its soft object regions "
                "at half layer 4's size) is not ported yet (ROADMAP Queue A "
                "item 12)")
        self.backbone = ResNetBackbone(backbone, _ocr_dilate_stages(out_stride))
        c3, c4 = output_channels(backbone)[2:]
        # Sequential(conv, bn, relu, dropout, cls): the reference keeps
        # torch's default bias on both convs
        self.interm_prediction_head = nn.Sequential(
            nn.Conv2d(c3, 512, 3, padding=1, bias=True), batch_norm(512),
            nn.ReLU(inplace=True), nn.Dropout(dropout),
            nn.Conv2d(512, num_classes, 1, bias=True))
        self.conv_high_map = ConvBN(c4, 512, 3, bias=True)
        self.spatial_ocr_head = SpatialOCR(512, 256, 512, dropout)
        self.conv_out = nn.Conv2d(512, num_classes, 1, bias=True)
        self.projector = build_projector(projector, c4)

    def forward(self, x: torch.Tensor,
                full_res: tuple[str, ...] = FULL_RES) -> dict:
        """NCHW input -> output dict (NCHW, >= f32 logits).

        `full_res` names the full-size upsamples to compute, of `logits`
        and `interm_logits`. The eval steps leave out `interm_logits` (the
        fused loss consumes `interm_logits_s8`); a train step whose metrics
        read the stride-8 logits leaves out both, as XLA drops them from the
        JAX program. Everything else is the same."""
        in_hw = x.shape[2:]
        feats = self.backbone(x)
        interm_logits = self.interm_prediction_head(feats["layer3"])
        pix = self.conv_high_map(feats["layer4"])
        context = spatial_gather(pix, interm_logits)
        logits = self.conv_out(self.spatial_ocr_head(pix, context))
        out = {
            "logits_s8": to_f32(logits),
            "interm_logits_s8": to_f32(interm_logits),
            "deep_features": feats["layer4"],
        }
        for key, lg in (("logits", logits), ("interm_logits", interm_logits)):
            if key in full_res:
                out[key] = to_f32(upsample_like(lg, in_hw))
        if self.projector is not None:
            out["proj_features"] = self.projector(feats["layer4"])
        return out
