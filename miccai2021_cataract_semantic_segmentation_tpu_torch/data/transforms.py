"""The transform vocabulary: the host transforms, the device augmentation
and the pipeline.

Port of the JAX package's data/transforms.py. The default recipe's
augmentation (pad, flip, blur, colorjitter, normalise) runs on the card
(ops/augment.py); the geometric transforms that change the frame run on
the host, per sample, before a batch is assembled: `AffineTransform` (a
random shift . rotation . shear homography, optionally cropped to its
largest valid rectangle) and `CropTransform` (a square crop snapped to a
multiple of 32, at random or weighted by inverse class frequency).

The JAX package warps with cv2, which the card's machine lacks, so the
warp here is the port's own, in numpy: OpenCV's `warpPerspective` as
OpenCV 5 computes it for uint8 (and float32) images with a constant-0
border. The matrix is inverted as cv::invert inverts a 3x3 (the cofactor
formula over the determinant, in float64); each destination pixel's
source coordinates are computed in float32, the row terms y*M1 + M2 with
two roundings and the column term as one fused multiply-add (emulated in
float64, where a float32 product is exact; the last width mod 16 pixels
of a row as OpenCV's scalar loop rounds them), then divided by the
projective term; bilinear taps are blended in float32 with fused
multiply-adds, rounded half to even and saturated; nearest sampling rounds
the coordinates half to even. Taps outside the source read 0. Against
cv2 5.0 on this repository's affine matrices the image and the label
warps are equal (tests/test_torch_host_transforms.py). `crop_to_fit`'s
`cv2.resize` is emulated the same way (11-bit fixed-point weights, the
vectorised vertical pass with its truncations; nearest by
floor(x * (1 / scale))), and is equal too.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy

_F32 = np.float32


# ---------------------------------------------------------------------------
# The warp (OpenCV's warpPerspective and resize, in numpy)
# ---------------------------------------------------------------------------

def _invert3(m: np.ndarray) -> np.ndarray:
    """cv::invert of a float64 3x3 (DECOMP_LU's closed form for n = 3), as
    nine values in row order."""
    m = np.asarray(m, np.float64)
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if det == 0:
        raise ValueError("the warp matrix is singular")
    d = 1.0 / det
    return np.array([
        (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
        (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
        (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d,
        (m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
        (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
        (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d,
        (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
        (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
        (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d])


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding: the product of two float32
    values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


# OpenCV's warp steps through a row 16 pixels at a time; the last
# (width mod 16) pixels take its scalar loop, which rounds the column and
# row terms otherwise
_WARP_STEP = 16


def _source_coords(minv: np.ndarray, out_hw: tuple[int, int]):
    """float32 (sx, sy) of every destination pixel under the inverse matrix:
    the row term y*M1 + M2 in two roundings and the column term fused onto
    it (fma(M0, x, row)), over the tail fma(x, M0, y*M1) + M2."""
    h, w = out_hw
    mf = minv.astype(_F32)
    x = np.arange(w, dtype=_F32)[None, :]
    y = np.arange(h, dtype=_F32)[:, None]
    tail = w - w % _WARP_STEP
    terms = []
    for i in (0, 3, 6):
        yt = y * mf[i + 1]                                   # float32 ops
        body = _fma32(mf[i], x[:, :tail], yt + mf[i + 2])
        end = _fma32(x[:, tail:], mf[i], yt) + mf[i + 2]
        terms.append(np.concatenate([body, end], axis=1))
    return terms[0] / terms[2], terms[1] / terms[2]


def warp_perspective(src: np.ndarray, matrix, out_wh: tuple[int, int],
                     nearest: bool = False) -> np.ndarray:
    """`cv2.warpPerspective(src, matrix, out_wh)` (bilinear; nearest with
    `nearest`, as flags=cv2.INTER_NEAREST) with a constant-0 border, for a
    uint8 or float32 (H, W) or (H, W, C) `src`."""
    w, h = out_wh
    sx, sy = _source_coords(_invert3(matrix), (h, w))
    sh, sw = src.shape[:2]
    if nearest:
        ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh)
        out = np.zeros((h, w) + src.shape[2:], src.dtype)
        out[inside] = src[iy[inside], ix[inside]]
        return out
    fx, fy = np.floor(sx), np.floor(sy)
    inside = ((fx >= -1) & (fx < sw) & (fy >= -1) & (fy < sh)).reshape(-1)
    # the source with a one-pixel zero frame, flat: every tap of an inside
    # pixel lies in it; a float32 a * b + c rounds once where a, b and c
    # are float32 and the sum is taken in float64
    chans = src.shape[2:]
    pad = np.zeros((sh + 2, sw + 2) + chans, _F32)
    pad[1:-1, 1:-1] = src
    flat = pad.reshape((-1,) + chans)
    tap = np.where(inside, ((fy + 1) * (sw + 2) + fx + 1).reshape(-1), 0).astype(np.intp)
    p00, p01 = flat.take(tap, axis=0), flat.take(tap + 1, axis=0)
    p10, p11 = flat.take(tap + sw + 2, axis=0), flat.take(tap + sw + 3, axis=0)
    lanes = (-1,) + (1,) * len(chans)
    ax = (sx - fx).astype(np.float64).reshape(lanes)      # exact in float32
    ay = (sy - fy).astype(np.float64).reshape(lanes)
    top = (ax * (p01 - p00) + p00).astype(_F32)
    bottom = (ax * (p11 - p10) + p10).astype(_F32)
    val = (ay * (bottom - top) + top).astype(_F32)
    val[~inside] = 0
    val = val.reshape((h, w) + chans)
    if src.dtype == np.uint8:
        return np.clip(np.rint(val), 0, 255).astype(np.uint8)
    return val.astype(src.dtype)


def _resize_taps(n_out: int, n_in: int, clamp_fraction: bool):
    """cv::resize's bilinear taps along one axis: (first source index,
    second, their 11-bit fixed-point weights). Along the width a tap
    before the first or past the last source pixel takes that pixel
    whole; along the height the fraction stays and both taps read the
    edge row."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = f - s
    if clamp_fraction:
        low, high = s < 0, s >= n_in - 1
        f[low | high] = 0
        s[low], s[high] = 0, n_in - 1
    w1 = np.rint(f * _F32(2048)).astype(np.int64)
    w0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize(src: np.ndarray, out_wh: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """`cv2.resize(src, out_wh)` of a uint8 image (bilinear, or nearest as
    interpolation=cv2.INTER_NEAREST)."""
    w, h = out_wh
    sh, sw = src.shape[:2]
    if nearest:
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
        return src[ys][:, xs]
    x0, x1, a0, a1 = _resize_taps(w, sw, True)
    y0, y1, b0, b1 = _resize_taps(h, sh, False)
    s = src.astype(np.int64)
    across = (1, w) + (1,) * (src.ndim - 2)
    down = (h,) + (1,) * (src.ndim - 1)
    rows = s[:, x0] * a0.reshape(across) + s[:, x1] * a1.reshape(across)
    val = ((((rows[y0] >> 4) * b0.reshape(down)) >> 16)
           + (((rows[y1] >> 4) * b1.reshape(down)) >> 16) + 2) >> 2
    return np.clip(val, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Affine (shift . rot . shear homography), optional crop-to-valid
# ---------------------------------------------------------------------------

def _shift_m(ver, hor):
    m = np.eye(3)
    m[0, 2], m[1, 2] = hor, ver
    return m


def _rot_m(cy, cx, deg):
    r = np.radians(deg)
    m = np.eye(3)
    m[:2, :2] = [[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]]
    return _shift_m(cy, cx) @ m @ _shift_m(-cy, -cx)


def _shear_m(cy, cx, sv, sh):
    m = np.eye(3)
    m[1, 0], m[0, 1] = sv, sh
    return _shift_m(cy, cx) @ m @ _shift_m(-cy, -cx)


def largest_valid_rect(valid: np.ndarray, aspect_hw: tuple[int, int],
                       scale: int = 16) -> tuple[int, int, int, int]:
    """The largest axis-aligned rectangle of the target aspect ratio inside
    a validity mask, by an exhaustive histogram-of-heights scan on a
    `scale`-downsampled grid; (v0, v1, h0, h1) in full-resolution pixels."""
    m = (valid[::scale, ::scale] > 0.5).astype(np.int32)
    rows, cols = m.shape
    ratio = aspect_hw[0] / aspect_hw[1]  # h = ratio * w
    heights = np.zeros(cols, np.int32)
    best = (0, 0, rows, cols)  # v0, h0, v1, h1 fallback: the whole grid
    best_area = -1.0
    for r in range(rows):
        heights = np.where(m[r] > 0, heights + 1, 0)
        stack: list[int] = []
        for c in range(cols + 1):
            hgt = heights[c] if c < cols else 0
            start = c
            while stack and heights[stack[-1]] >= hgt:
                top = stack.pop()
                height = heights[top]
                width = c - top
                w_fit = min(width, height / ratio)   # clip to the aspect ratio
                h_fit = w_fit * ratio
                area = w_fit * h_fit
                if area > best_area:
                    best_area = area
                    best = (r + 1 - int(h_fit), top, r + 1, top + int(w_fit))
                start = top
            stack.append(start)
    v0, h0, v1, h1 = best
    return v0 * scale, max(v1 * scale - 1, v0 * scale + 1), \
        h0 * scale, max(h1 * scale - 1, h0 * scale + 1)


@dataclass
class AffineTransform:
    """Joint warp of the image and the label through a random shift . rot .
    shear homography (the reference's AffineNP, transforms.py:23-99): the
    image bilinear, the label nearest, a constant-0 border;
    `crop_to_fit` warps onto twice the frame and resizes the largest valid
    rectangle of the frame's aspect back to its size."""
    rotation: float = 10.0
    rot_centre_offset: tuple = (0.25, 0.25)
    shift: float = 0.1
    shear: tuple = (0.1, 0.1)
    shear_centre_offset: tuple = (0.25, 0.25)
    crop_to_fit: bool = False

    def matrix(self, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
        """The homography of one draw: nine draws from `rng`, in the JAX
        package's order."""
        rot = self.rotation * (2 * rng.random() - 1)
        rcy = int(round(h * (0.5 + self.rot_centre_offset[0] * (2 * rng.random() - 1))))
        rcx = int(round(w * (0.5 + self.rot_centre_offset[1] * (2 * rng.random() - 1))))
        sv = int(round(h * self.shift * rng.random()))
        sh = int(round(w * self.shift * rng.random()))
        shv = self.shear[0] * (2 * rng.random() - 1)
        shh = self.shear[1] * (2 * rng.random() - 1)
        scy = int(round(h * (0.5 + self.shear_centre_offset[0] * (2 * rng.random() - 1))))
        scx = int(round(w * (0.5 + self.shear_centre_offset[1] * (2 * rng.random() - 1))))
        return _shift_m(sv, sh) @ _rot_m(rcy, rcx, rot) @ _shear_m(scy, scx, shv, shh)

    def __call__(self, img, lbl, rng: np.random.Generator):
        h, w = lbl.shape
        matrix = self.matrix(h, w, rng)
        out_size = (w * 2, h * 2) if self.crop_to_fit else (w, h)
        img_w = warp_perspective(img, matrix, out_size)
        lbl_w = warp_perspective(lbl, matrix, out_size, nearest=True)
        if not self.crop_to_fit:
            return img_w, lbl_w
        valid = warp_perspective(np.ones((h, w), _F32), matrix, out_size)
        v0, v1, h0, h1 = largest_valid_rect(valid, (h, w))
        return (resize(img_w[v0:v1, h0:h1], (w, h)),
                resize(lbl_w[v0:v1, h0:h1], (w, h), nearest=True))


@dataclass
class CropTransform:
    """Random or class-frequency-weighted square crop snapped to x32 (the
    reference's CropNP, transforms.py:254-303). The `freq` mode's window
    is `lbl[margin:h - margin, margin:h - margin]`, its columns bounded by
    the height, as the JAX package has it."""
    size: float = 0.4
    mode: str = "random"
    task: int = 2

    def __post_init__(self):
        sums = np.zeros(taxonomy.num_label_values(self.task))
        for task_id, canon_ids in taxonomy.TASK_GROUPS[self.task].items():
            col = len(sums) - 1 if task_id == taxonomy.IGNORE_VALUE else task_id
            sums[col] = taxonomy.CLASS_SUMS[list(canon_ids)].sum()
        self.class_frequencies = sums / sums.sum()

    def __call__(self, img, lbl, rng: np.random.Generator):
        h, w = lbl.shape
        crop = int(32 * ((self.size * h) // 32))
        if crop >= h or crop >= w:
            crop = min(h, w)
        if self.mode == "random":
            v = rng.integers(0, max(h - crop, 1))
            hh = rng.integers(0, max(w - crop, 1))
        elif self.mode == "freq":
            margin = crop // 2
            window = lbl[margin:h - margin, margin:h - margin]
            probs = 1.0 / self.class_frequencies[window]
            probs = probs / probs.sum()
            pick = rng.choice(probs.size, p=probs.ravel())
            v = pick // probs.shape[1]
            hh = pick % probs.shape[1]
        else:
            raise ValueError(f"crop mode '{self.mode}' not recognised")
        return (np.ascontiguousarray(img[v:v + crop, hh:hh + crop]),
                np.ascontiguousarray(lbl[v:v + crop, hh:hh + crop]))


# ---------------------------------------------------------------------------
# Pipeline parsing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceAugmentSpec:
    """What the on-device augmentation (ops/augment.py) does."""
    pad: bool = False
    flip: bool = False
    blur: bool = False
    colorjitter: bool = False
    pseudo_colorjitter_strength: int | None = None
    normalise: bool = False


def device_spec(transforms) -> DeviceAugmentSpec:
    """The train-time device spec of a config's `data.transforms` list, as
    the JAX package parses it (the reference's utils/utils.py:332-450
    vocabulary; names it does not know are ignored): the train pad only
    where "crop" is not listed."""
    names = [t for t in transforms if isinstance(t, str)]
    strength = None
    if "pseudo_colorjitter" in names:
        strength = 2
        for e in transforms:
            if isinstance(e, dict) and "strength" in e:
                strength = e["strength"]
    return DeviceAugmentSpec(
        pad="pad" in names and "crop" not in names,
        flip="flip" in names,
        blur="blur" in names,
        colorjitter="colorjitter" in names,
        pseudo_colorjitter_strength=strength,
        normalise="torchvision_normalise" in names)


@dataclass
class TransformPipeline:
    """The host transforms of a train sample (`host_train`, in order), the
    train-time device spec, and whether validation pads ("pad" listed)."""
    host_train: list = field(default_factory=list)
    device: DeviceAugmentSpec = field(default_factory=DeviceAugmentSpec)
    valid_pad: bool = False

    def apply_host(self, img, lbl, rng: np.random.Generator):
        for t in self.host_train:
            img, lbl = t(img, lbl, rng)
        return img, lbl


def build_transform_pipeline(transform_list, transform_values: dict,
                             task: int) -> TransformPipeline:
    """The pipeline of a config's `data.transforms`: "rot", "shift",
    "shear" and "affine" make one AffineTransform, "crop" a CropTransform
    (`transform_values`' `crop_size` and `crop_mode`), the rest the device
    spec."""
    p = TransformPipeline()
    names = [t for t in transform_list if isinstance(t, str)]
    rotation, shift, shear = 0.0, 0.0, (0.0, 0.0)
    rc_off = (0.2, 0.2)
    set_affine = False
    if "rot" in names:
        rotation, set_affine = 15.0, True
    if "shift" in names:
        shift, set_affine = 0.1, True
    if "shear" in names:
        shear, set_affine = (0.1, 0.1), True
    if "affine" in names:
        rotation, shear, rc_off, set_affine = 10.0, (0.1, 0.1), (0.1, 0.1), True
    if set_affine:
        p.host_train.append(AffineTransform(
            rotation=rotation, rot_centre_offset=rc_off, shift=shift,
            shear=shear, shear_centre_offset=(0.2, 0.2), crop_to_fit=False))
    if "crop" in names:
        p.host_train.append(CropTransform(
            size=transform_values.get("crop_size", 0.4),
            mode=transform_values.get("crop_mode", "random"), task=task))
    p.device = device_spec(transform_list)
    p.valid_pad = "pad" in names
    return p
