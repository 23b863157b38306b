"""B5 and B7: the bucket-Lovász forward histogram on full-resolution NCHW
logit grids — CUDA kernel wrappers and their plain PyTorch version.

Both compute what the JAX package's `_nchw_histogram` (Pallas kernel
`_nchw_fwd_kernel`, losses/fused_lovasz.py:169, two scales: B5) and
`_nchw1_histogram` (`_nchw1_fwd_kernel`, :1119, one scale: B7) return, on
the port's layout:

    grids   S float32 (N, C, H_pad, W_pad) logit grids, the upsampled
            logits of each scale (S = 2 for B5, 1 for B7);
    labels  (N, H_pad, W_pad) int32, -1 where a pixel gets no count;
    w_real  the real label width: lanes at or past it get no count either;

and return int32 counts (S*C, 2, B): [row][bg, fg][bucket], rows
scale-major. No dither: the JAX package refuses it on this route.

`nchw_histogram` (B5) and `nchw1_histogram` (B7) run the one CUDA source
csrc/nchw_hist.cu for CUDA tensors and the plain version for CPU tensors;
there is no fallback from one to the other. Each counts its own launches.
"""
from __future__ import annotations

import ctypes

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    MAX_CLASSES, _ptr, bucket_params, count_fields, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_edges import (
    make_bid_fn)

SOURCE = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
          "csrc/nchw_hist.cu")
_JAX_FILE = "miccai2021_cataract_semantic_segmentation_tpu/losses/fused_lovasz.py"


def nchw_fields(grids, labels: torch.Tensor, *, n_buckets: int,
                edges: str = "uniform", w_real: int):
    """What B5-B8 compute per (pixel, class row), in plain PyTorch: the
    softmax over C of each grid -> p (N, S, C, H, W); fg (N, C, H, W) and
    keep = label >= 0 and lane < w_real (N, H, W); the bucket ids
    (N, S, C, H, W) int64 of e = |fg - p * keep|."""
    p = torch.stack([torch.softmax(g, dim=1) for g in grids], dim=1)
    lbl = labels.long()
    lane = torch.arange(labels.shape[2], device=labels.device)
    keep = (lbl >= 0) & (lane < w_real)
    cls = torch.arange(grids[0].shape[1], device=labels.device)
    fg = lbl[:, None] == cls[:, None, None]
    e = (fg.to(torch.float32)[:, None] - p * keep[:, None, None]).abs()
    bid = make_bid_fn(n_buckets, edges)(e).long()
    return p, fg, keep, bid


def nchw_histogram_plain(grids, labels: torch.Tensor, *, n_buckets: int,
                         edges: str = "uniform", w_real: int) -> torch.Tensor:
    """Plain PyTorch B5/B7: `nchw_fields`, then the counts."""
    _, fg, keep, bid = nchw_fields(grids, labels, n_buckets=n_buckets,
                                   edges=edges, w_real=w_real)
    return count_fields(fg, keep, bid, n_buckets)


def check_nchw(grids, labels, n_scales: int, w_real: int) -> None:
    """Raise on what the kernels (B5-B8) do not take."""
    if len(grids) != n_scales:
        raise ValueError(f"the kernel takes {n_scales} grid(s), got {len(grids)}")
    g0 = grids[0]
    for name, t in [(f"grid{i}", g) for i, g in enumerate(grids)] + [("labels", labels)]:
        if t.device != g0.device:
            raise ValueError(f"{name} is on {t.device}, grid0 on {g0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for i, g in enumerate(grids):
        if g.dtype != torch.float32:
            raise TypeError(f"grid{i} must be float32, got {g.dtype}")
        if g.dim() != 4 or g.shape != g0.shape:
            raise ValueError(f"grid{i} {tuple(g.shape)} is not (N, C, H_pad, "
                             f"W_pad) like grid0 {tuple(g0.shape)}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    n, n_cls, h_pad, w_pad = g0.shape
    if tuple(labels.shape) != (n, h_pad, w_pad):
        raise ValueError(f"labels {tuple(labels.shape)} do not match the grids' "
                         f"(N, H_pad, W_pad) = {(n, h_pad, w_pad)}")
    if not 1 <= n_cls <= MAX_CLASSES:
        raise ValueError(f"the kernel takes 1..{MAX_CLASSES} classes, got {n_cls}")
    if not 1 <= w_real <= w_pad:
        raise ValueError(f"w_real {w_real} outside 1..{w_pad}")


class NchwHistogram:
    """The B5 (two scales) or B7 (one scale) entry: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. `launches` counts
    kernel launches (plain runs do not)."""

    source = SOURCE

    def __init__(self, n_scales: int, name: str, replaces: str):
        self.n_scales, self.name, self.replaces = n_scales, name, replaces
        self.launches = 0

    def __call__(self, grids, labels, *, n_buckets: int,
                 edges: str = "uniform", w_real: int) -> torch.Tensor:
        if len(grids) != self.n_scales:
            raise ValueError(f"{self.name} takes {self.n_scales} grid(s), "
                             f"got {len(grids)}")
        if grids[0].device.type == "cpu":
            return nchw_histogram_plain(grids, labels, n_buckets=n_buckets,
                                        edges=edges, w_real=w_real)
        return self._launch(grids, labels, n_buckets, edges, w_real)

    def _launch(self, grids, labels, n_buckets, edges, w_real):
        if labels.device.type != "cuda":
            raise ValueError(f"{self.name} takes CUDA tensors, got {labels.device}")
        check_nchw(grids, labels, self.n_scales, w_real)
        n, n_cls, h_pad, w_pad = grids[0].shape
        out = torch.zeros((self.n_scales * n_cls, 2, n_buckets),
                          dtype=torch.int32, device=labels.device)
        half, shift, q0, e_min, _, _ = bucket_params(n_buckets, edges, 0)
        lib = _hist_lib()
        err = lib.nchw_hist_fwd(
            _ptr(grids[0]), _void(grids[1] if self.n_scales == 2 else None),
            _ptr(labels), _ptr(out), n, self.n_scales, n_cls, h_pad, w_pad,
            w_real, n_buckets, int(edges != "uniform"), half, shift, q0, e_min,
            labels.device.index, stream_ptr(labels.device))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{build.error_string(lib, err)} ({err})")
        self.launches += 1
        return out


def _void(t) -> ctypes.c_void_p:
    """A tensor's pointer, or NULL for None (the absent second scale)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _hist_lib() -> ctypes.CDLL:
    lib = build.load("nchw_hist")
    fn = lib.nchw_hist_fwd
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 4 + [i] * 11 + [f, i, vp]
        fn.restype = ctypes.c_int
    return lib


nchw_histogram = NchwHistogram(2, "nchw_hist", f"{_JAX_FILE}:169")
nchw1_histogram = NchwHistogram(1, "nchw1_hist", f"{_JAX_FILE}:1119")
