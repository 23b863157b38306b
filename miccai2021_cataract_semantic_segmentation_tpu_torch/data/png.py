"""PNG codec of the port's host data path (numpy, zlib and struct), the
counterpart of the JAX package's cv2 calls (data/dataset.py:32-43).

8-bit RGB and 8-bit gray, non-interlaced, in and out; in, also with an
alpha channel, which is dropped as cv2.imread drops it (8 of the repo's 40
relabelled/ PNGs are RGBA, 31 RGB). `read_png` parses the chunks (CRCs
checked), inflates the IDAT data with zlib and undoes the five row
filters; its result is the pixels cv2.imread gives after BGR -> RGB
(`channels=3`; a gray file replicated to three channels, as OpenCV does)
or with IMREAD_GRAYSCALE (`channels=1`; a colour file through libpng's
rgb_to_gray at OpenCV's weights). A palette, a bit depth other than 8 or
an interlaced image raises ValueError naming the path.

`read_png` undoes the filters in `unfilter_native`, a C++ loop
(csrc/png_unfilter.cpp) that kernels/build.py builds at first use with the
host compiler; where it does not build, `read_png` raises (the numpy
version is some 60 times slower a frame, so it never stands in).
`unfilter_plain` is that numpy version, equal byte for byte, kept as the
reference the tests hold the C++ one to: rows of filter types
None/Sub/Up one after another, each vectorised along the row; with an
Average or Paeth row present, every row at once along the anti-diagonals
of pixels, whose three neighbours an earlier diagonal holds.

`write_png` writes filter type 0, or any fixed filter (one type for every
row, or one per row), so that tests can write every filter type without
PIL or cv2.
"""
from __future__ import annotations

import ctypes
import pathlib
import struct
import zlib

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # gray, RGB, gray+alpha, RGBA
_UNFILTER_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "png_unfilter.cpp"
_UNFILTER_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")


def png_dimensions(path) -> tuple[int, int]:
    """(height, width) from the IHDR chunk without decoding."""
    with open(path, "rb") as f:
        header = f.read(24)
    if header[:8] != SIGNATURE or header[12:16] != b"IHDR":
        raise ValueError(f"not a PNG: {path}")
    w, h = struct.unpack(">II", header[16:24])
    return h, w


def _chunks(blob: bytes, path):
    pos = len(SIGNATURE)
    while pos + 12 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + row_bytes) filtered rows -> (h, row_bytes) uint8, in numpy."""
    types, raw = filtered[:, 0], filtered[:, 1:]
    h, row_bytes = raw.shape
    if types.max(initial=0) > 4:
        r = int(np.argmax(types > 4))
        raise ValueError(f"row {r} has filter type {types[r]}")
    out = np.zeros((h + 1, row_bytes), np.uint8)      # row 0: the zero prior
    if not np.isin(types, (3, 4)).any():
        for r in range(h):
            t, x = types[r], raw[r]
            if t == 0:
                out[r + 1] = x
            elif t == 1:                               # Sub: a running sum
                out[r + 1] = np.cumsum(x.reshape(-1, bpp), axis=0,
                                       dtype=np.uint8).reshape(-1)
            else:                                      # Up
                out[r + 1] = x + out[r]
        return out[1:]
    # Every type at once, one anti-diagonal of pixels a step: pixel (r, x)
    # reads its left (r, x-1), up (r-1, x) and upper-left (r-1, x-1)
    # neighbours, all on the two diagonals before its own.
    w = row_bytes // bpp
    px = np.zeros((h + 1, w + 1, bpp), np.int16)      # zero row and column
    rawp = raw.reshape(h, w, bpp).astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        t = types[r][:, None]
        a, b, c = px[r + 1, x], px[r, x + 1], px[r, x]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        px[r + 1, x + 1] = (rawp[r, x] + pred) & 255
    return px[1:, 1:].astype(np.uint8).reshape(h, row_bytes)


def _declare(lib) -> None:
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]


def unfilter_lib():
    """The C++ unfilter's library, built at first use; raises RuntimeError
    with the compiler's output where it does not build."""
    return build.load_host("png_unfilter", [_UNFILTER_SRC], _UNFILTER_FLAGS,
                           declare=_declare)


def unfilter_native(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """`unfilter_plain` in C++."""
    lib = unfilter_lib()
    filtered = np.ascontiguousarray(filtered, dtype=np.uint8)
    h, row_bytes = filtered.shape[0], filtered.shape[1] - 1
    out = np.empty((h, row_bytes), np.uint8)
    rc = lib.png_unfilter(filtered.ctypes.data, out.ctypes.data, h, row_bytes, bpp)
    if rc != 0:
        raise ValueError(f"row {-rc - 1} has filter type {filtered[-rc - 1, 0]}")
    return out


def read_png(path, channels: int = 3) -> np.ndarray:
    """Decode an 8-bit gray or RGB PNG to (H, W, 3) RGB uint8 (`channels=3`)
    or (H, W) gray uint8 (`channels=1`)."""
    if channels not in (1, 3):
        raise ValueError("channels must be 1 or 3")
    blob = pathlib.Path(path).read_bytes()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"not a PNG: {path}")
    ihdr, idat = None, []
    for kind, data in _chunks(blob, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind[0] & 0x20 == 0 and kind not in (b"IEND", b"PLTE"):
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = ihdr
    if depth != 8 or color not in _COLOR_CHANNELS or comp or filt or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {color}, interlace {interlace}); the decoder "
                         "reads 8-bit gray or RGB (alpha dropped), "
                         "non-interlaced")
    bpp = _COLOR_CHANNELS[color]
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {flat.size} bytes of image data, expected "
                         f"{h * (1 + w * bpp)}")
    filtered = flat.reshape(h, 1 + w * bpp)
    try:
        pixels = unfilter_native(filtered, bpp)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    pixels = pixels.reshape(h, w, bpp)[..., :3 if bpp > 2 else 1]  # alpha dropped
    if pixels.shape[2] == 1:
        return np.repeat(pixels, 3, axis=2) if channels == 3 else pixels[..., 0]
    return rgb_to_gray(pixels) if channels == 1 else np.ascontiguousarray(pixels)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's rgb_to_gray at OpenCV's weights (0.299, 0.587 in 15-bit
    fixed point, truncated), which cv2.IMREAD_GRAYSCALE applies to an RGB
    PNG: (9797 R + 19234 G + 3737 B) >> 15."""
    x = rgb.astype(np.uint32)
    return ((9797 * x[..., 0] + 19234 * x[..., 1] + 3737 * x[..., 2]) >> 15
            ).astype(np.uint8)


def filter_rows(pixels: np.ndarray, types) -> np.ndarray:
    """(h, row_bytes) uint8 rows, bpp bytes a pixel in the last axis of
    `pixels` -> (h, 1 + row_bytes) filtered rows of `types` (one filter
    type, or one a row)."""
    img = pixels if pixels.ndim == 3 else pixels[..., None]
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    types = np.broadcast_to(np.asarray(types, dtype=np.uint8), (h,))
    if types.max(initial=0) > 4:
        raise ValueError("filter types are 0..4")
    t = types[:, None]
    pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
        t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
    return np.concatenate([types[:, None], ((x - pred) & 255).astype(np.uint8)],
                          axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + \
        struct.pack(">I", zlib.crc32(kind + data))


def write_png(path, pixels: np.ndarray, filter_type=0, level: int = 6) -> None:
    """Write (H, W, 3) RGB or (H, W) gray uint8 `pixels` as an 8-bit,
    non-interlaced PNG with `filter_type` (0..4, or one a row) at zlib
    `level`."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or \
            (pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError("write_png takes (H, W, 3) or (H, W) uint8 pixels")
    h, w = pixels.shape[:2]
    color = 2 if pixels.ndim == 3 else 0
    body = filter_rows(pixels, filter_type).tobytes()
    blob = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(body, level))
            + _chunk(b"IEND", b""))
    pathlib.Path(path).write_bytes(blob)
