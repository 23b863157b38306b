"""ctypes bindings of the repo's native host data path, native/cadis_io.cpp
(libpng decode and the LUT remap of a whole batch on a std::thread pool).

The port's own loader of the library the JAX package binds in its
data/native_io.py: built at first use with native/Makefile's flags into
`build/native/` (kernels/build.py's `load_host`), never into `native/`.
`available()` says whether the build and load succeeded (they need g++ and
libpng). Once loaded, a decode that fails raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import png_dimensions
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "cadis_io.cpp"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")      # native/Makefile's CXXFLAGS
LIBS = ("-lpng", "-lpthread")                         # and LDLIBS


def _declare(lib) -> None:
    lib.cadis_decode_png.restype = ctypes.c_int
    lib.cadis_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.cadis_load_batch.restype = None
    lib.cadis_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]


def _lib():
    """The loaded library, built on first use; raises RuntimeError where it
    does not build or load (and at every later call, without building)."""
    return build.load_host("cadis_io", [SOURCE], FLAGS, LIBS, subdir="native",
                           declare=_declare)


def available() -> bool:
    return build_error() is None


def build_error() -> str | None:
    """Why the library did not build or load; None where it did."""
    try:
        _lib()
    except RuntimeError as exc:
        return str(exc)
    return None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_png(path, channels: int = 3) -> np.ndarray:
    """Decode one PNG to (H, W, 3) RGB or (H, W) gray uint8."""
    lib = _lib()
    h, w = png_dimensions(path)
    out = np.empty((h, w, 3) if channels == 3 else (h, w), np.uint8)
    gh, gw = ctypes.c_int(), ctypes.c_int()
    rc = lib.cadis_decode_png(str(path).encode(), _u8ptr(out), channels, h, w,
                              ctypes.byref(gh), ctypes.byref(gw))
    if rc != 0:
        raise IOError(f"PNG decode failed ({rc}): {path}")
    return out


def load_batch(img_paths, lbl_paths, h: int, w: int, lut: np.ndarray | None = None,
               n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Decode n (image, label) pairs in parallel into (n, h, w, 3) and
    (n, h, w) uint8, the labels remapped through the (256,) `lut`."""
    lib = _lib()
    n = len(img_paths)
    imgs = np.empty((n, h, w, 3), np.uint8)
    lbls = np.empty((n, h, w), np.uint8)
    status = np.zeros(n, np.int32)
    paths = ctypes.c_char_p * n
    img_arr = paths(*[str(p).encode() for p in img_paths])
    lbl_arr = paths(*[str(p).encode() for p in lbl_paths])
    lut_arr = None if lut is None else np.ascontiguousarray(lut, np.uint8)
    lut_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8)) if lut_arr is None \
        else _u8ptr(lut_arr)
    lib.cadis_load_batch(img_arr, lbl_arr, n, h, w, lut_ptr, _u8ptr(imgs),
                         _u8ptr(lbls),
                         status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                         n_threads)
    bad = np.nonzero(status)[0]
    if len(bad):
        raise IOError(f"batch decode failed for items {bad.tolist()} (status "
                      f"{status[bad].tolist()}), first: {img_paths[bad[0]]}")
    return imgs, lbls
