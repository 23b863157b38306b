"""UPerNet decoder: a pyramid pooling module over the deepest encoder
features, then an FPN top-down over the encoder's scales.

Port of the JAX package's models/upernet.py with the reference's torch
module names (the inverse of its train/port_torch.py `_upernet_table`):
`ppm_conv.{i}` and `ppm_last_conv` (ConvBN: `Sequential(conv, bn, relu)`),
`fpn_in.{i}`, `fpn_out.{i}.0` (one more `Sequential`), `conv_last.0` and
the classifier `conv_last.1`.
  * The PPM pools to each scale, upsamples to the deepest grid BEFORE its
    1x1 ConvBN (scale 1 upsamples from a 1x1 source), and concatenates the
    features with the four branches for `ppm_last_conv`.
  * The FPN adds each lateral `fpn_in` to the upsampled coarser feature
    and smooths it with `fpn_out`; the fusion concatenates the finest
    level with the coarser ones upsampled to it in the reference's order
    [P2, P5, P4, P3], so ported `conv_last` weights line up.
  * Every interpolation uses align_corners=False.
The forward returns (full-resolution logits, pre-upsample logits), both
in >= f32; `full_res=False` leaves out the final upsample (the first is
then None).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    ConvBN, adaptive_avg_pool, to_f32, upsample_like)


class UPerNetDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int], task: int = 2,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 input_scales: Sequence[int] = (4, 8, 16, 32),
                 ppm_num_ch: int = 512, fpn_num_ch: int = 512,
                 fpn_num_lvl: int | None = None,
                 interpolate_result_up: bool = True):
        super().__init__()
        n_lvl = max(1, min(fpn_num_lvl or len(input_scales), len(input_scales)))
        self.pool_scales = tuple(pool_scales)
        self.n_lvl = n_lvl
        self.up_scale = input_scales[-n_lvl]
        self.interpolate_result_up = interpolate_result_up
        c_top = in_channels[-1]
        self.ppm_conv = nn.ModuleList(ConvBN(c_top, ppm_num_ch, 1)
                                      for _ in self.pool_scales)
        self.ppm_last_conv = ConvBN(c_top + len(self.pool_scales) * ppm_num_ch,
                                    fpn_num_ch, 3)
        # fpn_in.k reads encoder level k + len - n_lvl, from the finest used
        offset = len(in_channels) - n_lvl
        self.fpn_in = nn.ModuleList(ConvBN(in_channels[k + offset], fpn_num_ch, 1)
                                    for k in range(n_lvl - 1))
        self.fpn_out = nn.ModuleList(nn.Sequential(ConvBN(fpn_num_ch, fpn_num_ch, 3))
                                     for _ in range(n_lvl - 1))
        self.conv_last = nn.Sequential(
            ConvBN(n_lvl * fpn_num_ch, fpn_num_ch, 3),
            nn.Conv2d(fpn_num_ch, taxonomy.TASK_NUM_CLASSES[task], 1, bias=True))

    def forward(self, conv_out: Sequence[torch.Tensor], full_res: bool = True):
        top = conv_out[-1]
        hw = top.shape[2:]
        ppm_out = [top]
        for scale, conv in zip(self.pool_scales, self.ppm_conv):
            p = adaptive_avg_pool(top, (scale, scale))
            ppm_out.append(conv(upsample_like(p, hw, align_corners=False)))
        feature = self.ppm_last_conv(torch.cat(ppm_out, dim=1))

        fpn_features = [feature]
        for i in range(2, self.n_lvl + 1):
            k = self.n_lvl - i
            lateral = self.fpn_in[k](conv_out[-i])
            feature = lateral + upsample_like(feature, lateral.shape[2:],
                                              align_corners=False)
            fpn_features.append(self.fpn_out[k](feature))
        fpn_features.reverse()                      # finest first

        out_hw = fpn_features[0].shape[2:]
        fusion = [fpn_features[0]] + [
            upsample_like(fpn_features[-i + 1], out_hw, align_corners=False)
            for i in range(2, self.n_lvl + 1)]      # [P2, P5, P4, P3]
        small = self.conv_last(torch.cat(fusion, dim=1))
        logits = None
        if not self.interpolate_result_up:
            logits = small
        elif full_res:
            s = self.up_scale
            logits = upsample_like(small, (out_hw[0] * s, out_hw[1] * s),
                                   align_corners=False)
        return (None if logits is None else to_f32(logits)), to_f32(small)
