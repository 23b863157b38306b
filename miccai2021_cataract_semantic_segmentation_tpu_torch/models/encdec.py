"""The generic encoder-decoder composer: an undilated ResNet encoder and a
UPerNet decoder.

Port of the JAX package's models/encdec.py with the reference's torch
names: the encoder under `enc_model.` (torchvision's names), the decoder
under `dec_model.` (models/upernet.py). The encoder's channels come from
the backbone table, so no probe forward is needed. Outputs: `logits_s8_acf`
(the decoder's pre-upsample logits, stride 4 whatever the name says; "_acf"
marks their align_corners=False upsample, which a loss may fuse),
`deep_features` (layer 4, or with a `projector` section the projection
head, models/projector.py, on layer 4 in its place), and `logits` (the
full-resolution upsample) when `full_res` asks for it: 4x the stride-4
grid, the input's size where 32 divides its sides (544x960), as in the
JAX package. The PointRend decoder and the Inception encoder come with
the remaining graphs.
"""
from __future__ import annotations

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.models.projector import (
    build_projector)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (
    ENCODER_ALIASES, ResNetBackbone, output_channels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.upernet import (
    UPerNetDecoder)

# the decoder config keys UPerNetDecoder takes
_UPERNET_KEYS = ("pool_scales", "ppm_num_ch", "fpn_num_ch", "fpn_num_lvl",
                 "interpolate_result_up")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                               "item 12: the remaining graphs)")


class EncDec(nn.Module):
    def __init__(self, task: int = 2, encoder: dict | None = None,
                 decoder: dict | None = None, projector: dict | None = None):
        super().__init__()
        enc_cfg = encoder or {"model": "ResNet50"}
        dec_cfg = dict(decoder or {"model": "UPerNet"})
        if enc_cfg["model"] in ("Inceptionv3", "InceptionV3"):
            raise _not_ported("the Inception-v3 encoder")
        dec_name = dec_cfg.pop("model", "UPerNet")
        if dec_name == "PointRend":
            raise _not_ported("the PointRend decoder")
        if dec_name != "UPerNet":
            raise ValueError(f"Unknown decoder '{dec_name}'")
        arch = ENCODER_ALIASES.get(enc_cfg["model"], enc_cfg["model"])
        self.enc_model = ResNetBackbone(arch, (False, False, False))
        self.dec_model = UPerNetDecoder(
            output_channels(arch), task=task, input_scales=(4, 8, 16, 32),
            **{k: v for k, v in dec_cfg.items() if k in _UPERNET_KEYS})
        self.projector = build_projector(projector, output_channels(arch)[3])

    def forward(self, x: torch.Tensor,
                full_res: tuple[str, ...] = ("logits",)) -> dict:
        """NCHW input -> output dict (NCHW, >= f32 logits). `full_res`
        names the full-size upsamples to compute (`logits` or none)."""
        feats = self.enc_model(x)
        logits, small = self.dec_model([feats[f"layer{i}"] for i in (1, 2, 3, 4)],
                                       full_res="logits" in full_res)
        deep = feats["layer4"]
        out = {"logits_s8_acf": small,
               "deep_features": deep if self.projector is None else self.projector(deep)}
        if logits is not None:
            out["logits"] = logits
        return out
