"""Width-scalable FCN-8s and the minimal 4-level UNet.

Port of the JAX package's models/fcn_unet.py (the reference's
models/FCN.py and models/UNet.py). The JAX package's weight porter has no
table for either, so the torch names follow its flax names: FCN's
`conv1`..`conv8`, `p4_conv`, `p3_conv` and the transposed convolutions
`deconv32`, `deconv16`, `deconv8`; UNet's `down{i}_conv{j}`,
`up{i}_conv{j}` and `conv_last`. Every convolution keeps its bias.
  * FCN: five 3x3 conv + 2x2 max-pool stages, a 3x3 and two 1x1 convs to
    the classes, then learnt upsampling by `ConvTranspose2d` with the
    reference's padding (k - s + 1) // 2, which gives torch's 2x and 8x
    output sizes; each skip fuse resizes (bilinear, align_corners=False)
    where the upsample is a row or column off the skip's size (inputs
    that 32 does not divide), as the logits are resized to the input's.
  * UNet: double 3x3 convs at 64..512 channels, align_corners=True 2x
    upsamples concatenated with the skips. Its classifier has
    `taxonomy.num_label_values(task)` channels: the ignore channel is
    kept for tasks 2 and 3 (the reference's UNet.py:21 has no -1).
Both forwards return {"logits": NCHW >= f32 logits at the input's size}.
Under a spatial grid (parallel/spatial.py, `grid`) both run on this
rank's band of rows: the convolutions, pools and transposed convolutions
are models/layers.py's, the skips join bands of one stride, UNet's
upsamples are band resizes, and `logits` is this rank's band of the
full-resolution logits (`BAND_OUTPUTS`). A frame whose sides 32 (UNet: 8)
does not divide raises ValueError naming the first pool or layer that
would need a resize.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    Conv2d, ConvTranspose2d, MaxPool2d, to_f32, torch_pad, upsample_like)


def _resize_to(y: torch.Tensor, hw) -> torch.Tensor:
    """`y` bilinearly resized (align_corners=False) to `hw` where it
    differs (never under a spatial grid, whose pools and transposed
    convolutions take only frames whose sizes meet)."""
    return y if tuple(y.shape[2:]) == tuple(hw) else \
        upsample_like(y, tuple(hw), align_corners=False)


class FCN(nn.Module):
    grid = None          # a spatial grid (parallel/spatial.py:`spatial_rows`)
    # under a spatial grid: the band output whose whole upsample is each
    # full-resolution output (here the output itself), and its convention
    BAND_OUTPUTS = {"logits": "logits"}
    ALIGN_CORNERS = False

    def __init__(self, task: int = 1, width: float = 1.0):
        super().__init__()
        k = taxonomy.TASK_NUM_CLASSES[task]
        ch = [int(c) for c in np.round(np.array([64, 128, 256, 512, 512, 1024, 1024])
                                       * width).astype(int)]
        c_in = 3
        for i, (c, ks) in enumerate(zip(ch + [k], (3, 3, 3, 3, 3, 3, 1, 1))):
            setattr(self, f"conv{i + 1}", Conv2d(c_in, c, ks, padding=torch_pad(ks)))
            c_in = c
        self.p4_conv = Conv2d(ch[3], k, 1)
        self.p3_conv = Conv2d(ch[2], k, 1)
        for name, ks, s in (("deconv32", 4, 2), ("deconv16", 4, 2), ("deconv8", 16, 8)):
            setattr(self, name, ConvTranspose2d(k, k, ks, stride=s,
                                                padding=(ks - s + 1) // 2))
        self.pool = MaxPool2d(2, 2)

    def forward(self, x: torch.Tensor) -> dict:
        y, pools = x, []
        for i in range(1, 6):
            y = self.pool(torch.relu(getattr(self, f"conv{i}")(y)))
            pools.append(y)
        y = torch.relu(self.conv7(torch.relu(self.conv6(y))))
        y = self.conv8(y)
        p4, p3 = self.p4_conv(pools[3]), self.p3_conv(pools[2])
        y = _resize_to(self.deconv32(y), p4.shape[2:]) + p4
        y = _resize_to(self.deconv16(y), p3.shape[2:]) + p3
        return {"logits": to_f32(_resize_to(self.deconv8(y), x.shape[2:]))}


class UNet(nn.Module):
    grid = None          # a spatial grid (parallel/spatial.py:`spatial_rows`)
    BAND_OUTPUTS = {"logits": "logits"}      # as FCN's
    ALIGN_CORNERS = True

    def __init__(self, task: int = 1):
        super().__init__()
        widths = {"down1": (3, 64), "down2": (64, 128), "down3": (128, 256),
                  "down4": (256, 512), "up3": (512 + 256, 256),
                  "up2": (256 + 128, 128), "up1": (128 + 64, 64)}
        for name, (c_in, c) in widths.items():
            setattr(self, f"{name}_conv1", Conv2d(c_in, c, 3, padding=1))
            setattr(self, f"{name}_conv2", Conv2d(c, c, 3, padding=1))
        self.conv_last = Conv2d(64, taxonomy.num_label_values(task), 1)
        self.pool = MaxPool2d(2, 2)

    def _double(self, y: torch.Tensor, name: str) -> torch.Tensor:
        y = torch.relu(getattr(self, f"{name}_conv1")(y))
        return torch.relu(getattr(self, f"{name}_conv2")(y))

    def forward(self, x: torch.Tensor) -> dict:
        d1 = self._double(x, "down1")
        d2 = self._double(self.pool(d1), "down2")
        d3 = self._double(self.pool(d2), "down3")
        y = self._double(self.pool(d3), "down4")
        for name, skip in (("up3", d3), ("up2", d2), ("up1", d1)):
            # under a grid the 2x upsample's band is the skip's (the bands
            # of the next stride), which the concatenation needs anyway
            hw = (2 * y.shape[2], 2 * y.shape[3]) if self.grid is None else skip.shape[2:]
            y = upsample_like(y, hw, align_corners=True, grid=self.grid)
            y = self._double(torch.cat([y, skip], dim=1), name)
        return {"logits": to_f32(self.conv_last(y))}
