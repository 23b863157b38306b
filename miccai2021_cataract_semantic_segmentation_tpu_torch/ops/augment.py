"""On-device augmentation of the training recipe, and the eval pad.

Port of the JAX package's ops/augment.py. `augment_batch` takes the uint8
NHWC batch and applies, in the reference pipeline's order: the per-image
horizontal flip, the 2px vertical reflect pad, the gated Gaussian blur,
the per-image colour jitter (brightness, contrast, saturation, hue in that
fixed order, as the JAX package applies them) and the ImageNet normalise.
Images stay NHWC float32 in [0, 1] until the normalise, as in the JAX
package; the blur runs as two depthwise convolutions.

Random numbers: every draw of a batch (flip flags, blur flags and sigmas,
four jitter factors per image, the pseudo-jitter gate) is made up front by
`draw_augment` from an explicit `torch.Generator` into an `AugmentDraws`,
and `augment_batch` also takes such an object. This is an intended
difference from the JAX package: jax.random streams are not reproduced, so
the same seed gives other draws; the parity tests draw with jax.random as
`augment_batch` does there and pass the values to both sides. The blur's
batch-level gate (`lax.cond` on any image blurred) is a plain `if`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    DeviceAugmentSpec)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BLUR_RADIUS = 18   # 3 * max sigma (6); 37 taps
BLUR_P = 0.05      # transforms.py:242-251 of the reference
PSEUDO_JITTER_P = 0.7
JITTER_RANGES = ((2 / 3, 1.5), (2 / 3, 1.5), (2 / 3, 1.5), (-0.05, 0.05))


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] as the JAX package's compiled programs
    compute `u8 / 255.0`: XLA turns the division by a constant into a
    multiplication by float32(1/255), which rounds 126 of the 256 byte
    values differently from a division."""
    return images_u8.to(torch.float32) * np.float32(1.0 / 255.0)


def pad_reflect_hw(x: torch.Tensor, ver: int = 2) -> torch.Tensor:
    """(B,H,W,...) -> (B,H+2*ver,W,...) vertical reflect pad (numpy
    "reflect": the edge row is not repeated). Works on any dtype."""
    h = x.shape[1]
    idx = torch.cat([torch.arange(ver, 0, -1), torch.arange(h),
                     torch.arange(h - 2, h - 2 - ver, -1)]).to(x.device)
    return x.index_select(1, idx)


# ---------------------------------------------------------------------------
# Colour ops (torchvision functional semantics, [0,1] float RGB, NHWC).
# Factors are (N,) tensors, one per image.
# ---------------------------------------------------------------------------

def _per_image(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(-1, 1, 1, 1)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


def adjust_brightness(x, f):
    return torch.clamp(x * _per_image(f), 0.0, 1.0)


def adjust_contrast(x, f):
    mean = torch.mean(_grayscale(x), dim=(-3, -2, -1), keepdim=True)
    f = _per_image(f)
    return torch.clamp(x * f + mean * (1 - f), 0.0, 1.0)


def adjust_saturation(x, f):
    f = _per_image(f)
    return torch.clamp(x * f + _grayscale(x) * (1 - f), 0.0, 1.0)


def rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0))
    h = torch.where(d == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(x):
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    conds = [torch.stack([v, t, p], -1), torch.stack([q, v, p], -1),
             torch.stack([p, v, t], -1), torch.stack([p, q, v], -1),
             torch.stack([t, p, v], -1), torch.stack([v, p, q], -1)]
    out = conds[0]
    for k in range(1, 6):
        out = torch.where((i == k)[..., None], conds[k], out)
    return out


def adjust_hue(x, f):
    hsv = rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + f.reshape(-1, 1, 1), 1.0)
    return torch.clamp(hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], -1)),
                       0.0, 1.0)


def color_jitter(x, factors: torch.Tensor) -> torch.Tensor:
    """Jitter each image of the NHWC batch by its row of (N, 4) factors
    [brightness, contrast, saturation, hue], in that fixed order."""
    x = adjust_brightness(x, factors[:, 0])
    x = adjust_contrast(x, factors[:, 1])
    x = adjust_saturation(x, factors[:, 2])
    return adjust_hue(x, factors[:, 3])


# ---------------------------------------------------------------------------
# Blur
# ---------------------------------------------------------------------------

def gaussian_taps(sigma: torch.Tensor) -> torch.Tensor:
    """(N,) sigmas -> (N, 2R+1) normalised taps; sigma 0 gives the
    identity (delta) kernel."""
    r = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32,
                     device=sigma.device)
    sigma = sigma.to(torch.float32)[:, None]
    w = torch.exp(-0.5 * (r / torch.clamp_min(sigma, 1e-6)) ** 2)
    w = torch.where(sigma > 0, w, (r == 0).to(torch.float32))
    return w / torch.sum(w, dim=1, keepdim=True)


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable blur of each NHWC image by its own sigma (0 = no-op): a
    37-tap vertical then horizontal depthwise convolution over edge-padded
    images, as the JAX package's `gaussian_blur`."""
    n, h, w, c = x.shape
    k = 2 * BLUR_RADIUS + 1
    taps = gaussian_taps(sigma).to(x.dtype)                  # (N, k)
    # images as channels of one batch: depthwise weights (N*C, 1, kh, kw)
    y = x.permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    wgt = taps.repeat_interleave(c, dim=0)                   # (N*C, k)
    y = F.pad(y, (0, 0, BLUR_RADIUS, BLUR_RADIUS), mode="replicate")
    y = F.conv2d(y, wgt.reshape(n * c, 1, k, 1), groups=n * c)
    y = F.pad(y, (BLUR_RADIUS, BLUR_RADIUS, 0, 0), mode="replicate")
    y = F.conv2d(y, wgt.reshape(n * c, 1, 1, k), groups=n * c)
    return y.reshape(n, c, h, w).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Draws and the full pipeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AugmentDraws:
    """Every random value one `augment_batch` call uses, per image:
    flip (N,) bool; blur (N,) bool and sigma (N,) float32 in {3..6} (0
    where not blurred); jitter (N, 4) float32 [brightness, contrast,
    saturation, hue]; pseudo_gate (N,) bool, whether the pseudo colour
    jitter applies."""
    flip: torch.Tensor
    blur: torch.Tensor
    sigma: torch.Tensor
    jitter: torch.Tensor
    pseudo_gate: torch.Tensor

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(getattr(self, f).to(device) for f in
                              ("flip", "blur", "sigma", "jitter", "pseudo_gate")))


def jitter_ranges(spec: DeviceAugmentSpec):
    """The four (low, high) factor ranges of the spec's colour jitter."""
    if spec.colorjitter or spec.pseudo_colorjitter_strength is None:
        return JITTER_RANGES
    s = spec.pseudo_colorjitter_strength
    ext = (1 - s * 0.25, 1 + s * 0.25)
    return (ext, ext, ext, (-0.02 * s, 0.02 * s))


def draw_augment(spec: DeviceAugmentSpec, n: int,
                 generator: torch.Generator) -> AugmentDraws:
    """All draws of one batch of `n` images from `generator` (on the CPU),
    with the JAX package's distributions: flip with p 0.5, blur with p 0.05
    at an integer sigma U{3..6}, jitter factors uniform over
    `jitter_ranges`, the pseudo-jitter gate with p 0.7."""
    def u(*shape):
        return torch.rand(shape, generator=generator)

    flip = u(n) < 0.5
    blur = u(n) < BLUR_P
    sigma = torch.randint(3, 7, (n,), generator=generator).to(torch.float32)
    lo = torch.tensor([r[0] for r in jitter_ranges(spec)])
    hi = torch.tensor([r[1] for r in jitter_ranges(spec)])
    jitter = lo + (hi - lo) * u(n, 4)
    gate = u(n) < PSEUDO_JITTER_P
    return AugmentDraws(flip, blur, torch.where(blur, sigma, 0.0), jitter, gate)


def augment_batch(images_u8: torch.Tensor, labels: torch.Tensor,
                  spec: DeviceAugmentSpec, draws: AugmentDraws):
    """uint8 NHWC images + integer NHW labels -> (float32 NHWC images,
    int64 labels), on the images' device: the train-time augmentation
    (eval preprocessing is `train/steps.py:eval_preprocess`).

    Order matches the reference pipeline: flips first, then pad, then the
    blur and the per-image photometric ops, then normalise."""
    x = to_unit(images_u8)
    lbl = labels.to(torch.int64)
    # the blur gate reads the draws where they were made (the CPU, no sync)
    blur = spec.blur and bool(draws.blur.any())
    d = draws.to(x.device)
    if spec.flip:
        x = torch.where(d.flip[:, None, None, None], x.flip(2), x)
        lbl = torch.where(d.flip[:, None, None], lbl.flip(2), lbl)
    if spec.pad:
        x = pad_reflect_hw(x)
        lbl = pad_reflect_hw(lbl)
    if blur:
        x = gaussian_blur(x, d.sigma)
    if spec.colorjitter:
        x = color_jitter(x, d.jitter)
    elif spec.pseudo_colorjitter_strength is not None:
        x = torch.where(d.pseudo_gate[:, None, None, None],
                        color_jitter(x, d.jitter), x)
    if spec.normalise:
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
    return x, lbl
