"""B1: the fused bucket-Lovász forward histogram — CUDA kernel wrapper and
its plain PyTorch version.

Both compute what the JAX package's `_fu_histogram` returns (Pallas kernel
`_fu_fwd_kernel`, losses/fused_lovasz.py:648) on the port's layout:

    ls      (N, R, hs, ws) float32 stride-8 logits, R = n_scales * n_cls
            class rows (scale-major: rows [s*C, (s+1)*C) are scale s);
    labels  (N, H_pad, W_pad) int32, -1 where a pixel gets no count
            (ignored class, row padding to a multiple of 8, lane padding to
            a multiple of 128: the geometry the dither index is taken over);
    mats    the `FuMats` of `fu_mats`: the zero-padded float32 `_fu_mats`
            interpolation matrices (the plain version's operands) and the
            two taps of each output row and column read from them (the
            kernel's operands);

and return int32 counts (R, 2, B): [row][bg, fg][bucket].

`fu_histogram` runs the CUDA kernel (csrc/fu_hist.cu) for CUDA tensors and
the plain version for CPU tensors; there is no fallback from one to the
other. Its `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_edges import (
    adaptive_params, dither_shift, make_bid_fn)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import interp_matrix

MAX_CLASSES = 32   # the kernel keeps a scale's logits in registers


@dataclass(frozen=True)
class FuMats:
    """Interpolation operands of B1 for one (source, target) geometry.

    mh (H_pad, hs) and mw (ws, W_pad) are the float32 matrices; h_lo/w_lo
    (int32) are the first source index of each output row/column and
    h_w0/h_w1, w_w0/w_w1 (float32) the matrix entries at that index and the
    next one: the only nonzero entries of a bilinear row. Pad rows and
    columns are all zero (taps 0, 0.0, 0.0). For the transposed
    interpolation of B2, h_beg/h_end (hs,) and w_beg/w_end (ws,) (int32)
    bound the output rows/columns with a nonzero entry in each source
    row/column (empty, 0 and 0, where none has)."""
    mh: torch.Tensor
    mw: torch.Tensor
    h_lo: torch.Tensor
    h_w0: torch.Tensor
    h_w1: torch.Tensor
    w_lo: torch.Tensor
    w_w0: torch.Tensor
    w_w1: torch.Tensor
    h_beg: torch.Tensor
    h_end: torch.Tensor
    w_beg: torch.Tensor
    w_end: torch.Tensor


def _taps(m: np.ndarray):
    """(lo, w0, w1) of each row of a float32 (n_out, n_in) bilinear matrix."""
    nz = m != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    rows = np.arange(m.shape[0])
    nxt = np.minimum(lo + 1, m.shape[1] - 1)
    w1 = np.where(nxt > lo, m[rows, nxt], np.float32(0))
    return lo.astype(np.int32), m[rows, lo], w1.astype(np.float32)


def _ranges(m: np.ndarray):
    """(beg, end) int32 per column of an (n_out, n_in) bilinear matrix: the
    rows with a nonzero entry in that column, which are contiguous."""
    nz = m != 0
    hit = nz.any(0)
    beg = np.where(hit, nz.argmax(0), 0)
    end = np.where(hit, m.shape[0] - nz[::-1].argmax(0), 0)
    if not all(nz[b:e, j].all() for j, (b, e) in enumerate(zip(beg, end))):
        raise ValueError("bilinear matrix with non-contiguous columns")
    return beg.astype(np.int32), end.astype(np.int32)


@functools.lru_cache(maxsize=32)
def fu_mats(hs: int, ws: int, out_hw: tuple[int, int], h_pad: int,
            w_pad: int, align: bool, device: torch.device) -> FuMats:
    """The `_fu_mats` coefficients (built in float64, cast once to float32)
    zero-padded to the label grid (H_pad, W_pad), and their taps."""
    oh, ow = out_hw
    mh = np.pad(interp_matrix(hs, oh, align),
                ((0, h_pad - oh), (0, 0))).astype(np.float32)
    mw_t = np.pad(interp_matrix(ws, ow, align),
                  ((0, w_pad - ow), (0, 0))).astype(np.float32)
    arrays = (mh, np.ascontiguousarray(mw_t.T), *_taps(mh), *_taps(mw_t),
              *_ranges(mh), *_ranges(mw_t))
    # built outside inference mode so the cached tensors are usable anywhere
    with torch.inference_mode(False):
        return FuMats(*(torch.as_tensor(a, device=device) for a in arrays))


def plain_fields(ls: torch.Tensor, labels: torch.Tensor, mats: FuMats, *,
                 n_cls: int, n_buckets: int, edges: str = "uniform",
                 seed: int = 0, dither: bool = False):
    """What B1 and B2 compute per (pixel, class row), in plain PyTorch:
    einsum interpolation (rows, then columns) and softmax -> p
    (N, S, C, H, W); fg (N, C, H, W) and keep = label >= 0 (N, H, W); the
    bucket ids (N, S, C, H, W) int64 of e = |fg - p * keep| (+ dither)."""
    n, r_rows = ls.shape[:2]
    n_scales = r_rows // n_cls
    h_pad, w_pad = labels.shape[1:]
    u = torch.einsum("yh,nrhw->nryw", mats.mh, ls)
    u = torch.einsum("nryw,wx->nryx", u, mats.mw)           # (N, R, H, W)
    p = torch.softmax(u.reshape(n, n_scales, n_cls, h_pad, w_pad), dim=2)
    lbl = labels.long()
    keep = lbl >= 0
    cls = torch.arange(n_cls, device=ls.device)
    fg = (lbl[:, None] == cls[:, None, None])                # (N, C, H, W)
    e = (fg.to(torch.float32)[:, None] - p * keep[:, None, None]).abs()
    if dither:
        idx = torch.arange(n * h_pad * w_pad, device=ls.device)
        e = e + dither_shift(idx, seed, n_buckets).reshape(n, 1, 1, h_pad, w_pad)
    bid = make_bid_fn(n_buckets, edges)(e).long()            # (N, S, C, H, W)
    return p, fg, keep, bid


def fu_histogram_plain(ls: torch.Tensor, labels: torch.Tensor, mats: FuMats,
                       *, n_cls: int, n_buckets: int, edges: str = "uniform",
                       seed: int = 0, dither: bool = False) -> torch.Tensor:
    """Plain PyTorch B1: `plain_fields`, then an int64 bincount over
    row*2B + fg*B + bid of the counted pixels."""
    _, fg, keep, bid = plain_fields(ls, labels, mats, n_cls=n_cls,
                                    n_buckets=n_buckets, edges=edges,
                                    seed=seed, dither=dither)
    return count_fields(fg, keep, bid, n_buckets)


def count_fields(fg, keep, bid, n_buckets: int) -> torch.Tensor:
    """int32 (R, 2, B) counts of the counted (pixel, row) pairs of the
    fields fg (N, C, H, W), keep (N, H, W) and bucket ids (N, S, C, H, W):
    an int64 bincount over row*2B + fg*B + bid."""
    _, n_scales, n_cls = bid.shape[:3]
    r_rows = n_scales * n_cls
    row = torch.arange(r_rows, device=bid.device).reshape(1, n_scales, n_cls, 1, 1)
    key = row * (2 * n_buckets) + fg[:, None].long() * n_buckets + bid
    key = key[keep[:, None, None].expand_as(key)]
    counts = torch.bincount(key, minlength=r_rows * 2 * n_buckets)
    return counts.to(torch.int32).reshape(r_rows, 2, n_buckets)


def bucket_params(n_buckets: int, edges: str, seed: int) -> tuple:
    """(half, shift, q0, e_min, seed as int32, 1/B as float32) of the
    kernels' bucket map."""
    if edges == "uniform":
        half, shift, q0, e_min = 0, 0, 0, 0.0
    else:
        half, shift, q0, e_min = adaptive_params(n_buckets, edges)
    seed32 = (int(seed) & 0xFFFFFFFF) - ((int(seed) & 0x80000000) << 1)
    return half, shift, q0, float(e_min), seed32, float(np.float32(1.0 / n_buckets))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class FuHistogram:
    """The B1 entry: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `launches` counts kernel launches (plain runs do not)."""

    name = "fu_hist"
    source = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
              "csrc/fu_hist.cu")
    replaces = ("miccai2021_cataract_semantic_segmentation_tpu/losses/"
                "fused_lovasz.py:648")

    def __init__(self):
        self.launches = 0

    def __call__(self, ls, labels, mats: FuMats, *, n_cls: int,
                 n_buckets: int, edges: str = "uniform", seed: int = 0,
                 dither: bool = False) -> torch.Tensor:
        kwargs = dict(n_cls=n_cls, n_buckets=n_buckets, edges=edges,
                      seed=seed, dither=dither)
        if ls.device.type == "cpu":
            return fu_histogram_plain(ls, labels, mats, **kwargs)
        return self._launch(ls, labels, mats, **kwargs)

    def _launch(self, ls, labels, mats, *, n_cls, n_buckets, edges, seed,
                dither):
        _check(ls, labels, mats, n_cls)
        n, r_rows, hs, ws = ls.shape
        h_pad, w_pad = labels.shape[1:]
        out = torch.zeros((r_rows, 2, n_buckets), dtype=torch.int32,
                          device=ls.device)
        half, shift, q0, e_min, seed32, inv_b = bucket_params(n_buckets,
                                                              edges, seed)
        lib = _fu_lib()
        err = lib.fu_hist_fwd(
            _ptr(ls), _ptr(labels), _ptr(mats.h_lo), _ptr(mats.h_w0),
            _ptr(mats.h_w1), _ptr(mats.w_lo), _ptr(mats.w_w0),
            _ptr(mats.w_w1), _ptr(out), n, r_rows // n_cls, n_cls, hs, ws,
            h_pad, w_pad, n_buckets, int(edges != "uniform"), half, shift,
            q0, e_min, int(dither), seed32, inv_b, ls.device.index,
            stream_ptr(ls.device))
        if err != 0:
            raise RuntimeError(f"fu_hist launch failed: "
                               f"{build.error_string(lib, err)} ({err})")
        self.launches += 1
        return out


def _check(ls, labels, mats, n_cls):
    """Raise on what the kernels (B1 and B2) do not take."""
    tensors = {"ls": ls, "labels": labels, "h_lo": mats.h_lo,
               "h_w0": mats.h_w0, "h_w1": mats.h_w1, "w_lo": mats.w_lo,
               "w_w0": mats.w_w0, "w_w1": mats.w_w1, "h_beg": mats.h_beg,
               "h_end": mats.h_end, "w_beg": mats.w_beg, "w_end": mats.w_end}
    for name, t in tensors.items():
        if t.device != ls.device:
            raise ValueError(f"{name} is on {t.device}, ls on {ls.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("ls", "h_w0", "h_w1", "w_w0", "w_w1"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    for name in ("labels", "h_lo", "w_lo", "h_beg", "h_end", "w_beg", "w_end"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if ls.dim() != 4 or labels.dim() != 3 or ls.shape[0] != labels.shape[0]:
        raise ValueError(f"shapes ls {tuple(ls.shape)} / labels "
                         f"{tuple(labels.shape)} do not match (N,R,hs,ws) / "
                         "(N,H_pad,W_pad)")
    if not 1 <= n_cls <= MAX_CLASSES or ls.shape[1] % n_cls:
        raise ValueError(f"the kernel takes 1..{MAX_CLASSES} classes and "
                         f"whole scales, got C={n_cls}, R={ls.shape[1]}")
    if tuple(mats.mh.shape) != (labels.shape[1], ls.shape[2]) or \
            tuple(mats.mw.shape) != (ls.shape[3], labels.shape[2]):
        raise ValueError("interpolation taps do not match the shapes")


def _fu_lib() -> ctypes.CDLL:
    lib = build.load("fu_hist")
    fn = lib.fu_hist_fwd
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 9 + [i] * 12 + [f, i, i, f, i, vp]
        fn.restype = ctypes.c_int
    return lib


fu_histogram = FuHistogram()
