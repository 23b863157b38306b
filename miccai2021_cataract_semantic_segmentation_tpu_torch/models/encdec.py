"""The generic encoder-decoder composer: an undilated ResNet (ResNeXt,
WideResNet) or Inception-v3 encoder, and a UPerNet or PointRend decoder.

Port of the JAX package's models/encdec.py with the reference's torch
names: the encoder under `enc_model.` (torchvision's names), the decoder
under `dec_model.` (models/upernet.py, models/pointrend.py). The encoder's
channels come from the backbone table (Inception-v3: 192, 288, 768,
2048), so no probe forward is needed. UPerNet outputs: `logits_s8_acf`
(the decoder's pre-upsample logits, stride 4 whatever the name says; "_acf"
marks their align_corners=False upsample, which a loss may fuse),
`deep_features` (layer 4, or with a `projector` section the projection
head, models/projector.py, on layer 4 in its place), and `logits` (the
full-resolution upsample) when `full_res` asks for it: 4x the stride-4
grid, the input's size where 32 divides its sides (544x960), as in the
JAX package. The Inception encoder's unpadded convolutions leave a
stride-4 grid of 132x236 at 544x960, whose 4x (528x944) the JAX package
gives as `logits` and cannot hold against full-size labels; the port
resizes the UPerNet's logits to the input's size instead
(align_corners=False, one bilinear resize of the stride-4 logits), so
that validation and the full-resolution losses see the labels' grid.
Under a spatial grid (parallel/spatial.py, `grid`; a ResNet-family
encoder and UPerNet only) the encoder and decoder run on this rank's band
of rows and the forward gives no `logits`: `logits_s8_acf` and
`deep_features` are this rank's bands, and the steps gather the first and
upsample it whole at align_corners=False (`BAND_OUTPUTS`, `ALIGN_CORNERS`).
PointRend outputs `logits` at full resolution always (with `coarse_logits`,
`point_logits` and `point_coords` in train mode) and `deep_features`; its
config takes the reference's `pr_*` names and the JAX package's own.
"""
from __future__ import annotations

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.models.inception import (
    INCEPTION_CHANNELS, InceptionV3Encoder)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import upsample_like
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.pointrend import (
    PointDraws, PointRendDecoder)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.projector import (
    build_projector)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (
    ENCODER_ALIASES, ResNetBackbone, output_channels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.upernet import (
    UPerNetDecoder)

# the decoder config keys UPerNetDecoder takes
_UPERNET_KEYS = ("pool_scales", "ppm_num_ch", "fpn_num_ch", "fpn_num_lvl",
                 "interpolate_result_up")
# the reference's PointRend config names (PointRend.py:14-19) -> the
# decoder's, which are also accepted
_POINTREND_ALIASES = {"pr_train_num_pts": "num_points",
                      "pr_oversample_ratio": "oversample_ratio",
                      "pr_importance_sample_ratio": "importance_sample_ratio",
                      "pr_subdivision_num_pts": "subdivision_num_points"}
_POINTREND_KEYS = tuple(_POINTREND_ALIASES.values())


class EncDec(nn.Module):
    # under a spatial grid: the band output whose whole upsample is each
    # full-resolution output, and the upsample's convention
    BAND_OUTPUTS = {"logits": "logits_s8_acf"}
    ALIGN_CORNERS = False

    def __init__(self, task: int = 2, encoder: dict | None = None,
                 decoder: dict | None = None, projector: dict | None = None):
        super().__init__()
        enc_cfg = encoder or {"model": "ResNet50"}
        dec_cfg = dict(decoder or {"model": "UPerNet"})
        self.inception = enc_cfg["model"] in ("Inceptionv3", "InceptionV3")
        if self.inception:
            self.enc_model = InceptionV3Encoder()
            channels = INCEPTION_CHANNELS
        else:
            arch = ENCODER_ALIASES.get(enc_cfg["model"], enc_cfg["model"])
            self.enc_model = ResNetBackbone(arch, (False, False, False))
            channels = output_channels(arch)
        dec_name = dec_cfg.pop("model", "UPerNet")
        self.pointrend = dec_name == "PointRend"
        if self.pointrend:
            kw = {_POINTREND_ALIASES.get(k, k): v for k, v in dec_cfg.items()}
            self.dec_model = PointRendDecoder(
                channels, task=task,
                **{k: v for k, v in kw.items() if k in _POINTREND_KEYS})
        elif dec_name == "UPerNet":
            self.dec_model = UPerNetDecoder(
                channels, task=task, input_scales=(4, 8, 16, 32),
                **{k: v for k, v in dec_cfg.items() if k in _UPERNET_KEYS})
        else:
            raise ValueError(f"Unknown decoder '{dec_name}'")
        self.projector = build_projector(projector, channels[3])

    def forward(self, x: torch.Tensor, full_res: tuple[str, ...] = ("logits",),
                points: PointDraws | torch.Tensor | None = None) -> dict:
        """NCHW input -> output dict (NCHW, >= f32 logits). `full_res`
        names the full-size upsamples to compute (`logits` or none); the
        PointRend decoder always gives `logits` and takes the train step's
        `points` (models/pointrend.py)."""
        feats = self.enc_model(x)
        conv_out = [feats[f"layer{i}"] for i in (1, 2, 3, 4)]
        deep = feats["layer4"]
        deep = deep if self.projector is None else self.projector(deep)
        if self.pointrend:
            return {**self.dec_model(conv_out, points), "deep_features": deep}
        want_full = "logits" in full_res
        logits, small = self.dec_model(conv_out, full_res=want_full and not self.inception)
        if self.inception and want_full and self.dec_model.interpolate_result_up:
            logits = upsample_like(small, x.shape[2:], align_corners=False)
        out = {"logits_s8_acf": small, "deep_features": deep}
        if logits is not None:
            out["logits"] = logits
        return out
