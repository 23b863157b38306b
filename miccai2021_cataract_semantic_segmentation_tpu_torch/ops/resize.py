"""Bilinear resize with exact PyTorch align_corners semantics, as matmuls.

Port of the JAX package's ops/resize.py: the 1-D interpolation weights are
built in float64 on the host (the same coefficients for both conventions)
and applied as two matmuls over NCHW tensors, height first, then width.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) float64 bilinear interpolation matrix (cast at use).
    Callers must not write to the returned (shared) array."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float64)
    out = np.arange(n_out, dtype=np.float64)
    if align_corners:
        pos = out * (n_in - 1) / max(n_out - 1, 1)
    else:
        pos = np.clip((out + 0.5) * n_in / n_out - 0.5, 0.0, n_in - 1)
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = pos - lo
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    mat[out.astype(np.int64), lo] += 1.0 - w_hi
    mat[out.astype(np.int64), hi] += w_hi
    return mat


@functools.lru_cache(maxsize=64)
def _interp_tensor(n_in: int, n_out: int, align_corners: bool,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # built outside inference mode so the cached tensor is usable anywhere
    with torch.inference_mode(False):
        return torch.as_tensor(interp_matrix(n_in, n_out, align_corners),
                               dtype=dtype, device=device)


def _interp(n_in: int, n_out: int, align_corners: bool, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The cached matrix, or under a trace (torch.export, torch.compile),
    whose tensors are fake, a new one that the cache does not keep."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return torch.as_tensor(interp_matrix(n_in, n_out, align_corners),
                               dtype=dtype, device=device)
    return _interp_tensor(n_in, n_out, align_corners, dtype, device)


def _apply(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """`mh @ x @ mw.T` over NCHW `x` in the matrices' dtype (>= float32)
    with autocast off, returned in `x.dtype`."""
    with torch.autocast(x.device.type, enabled=False):
        y = torch.matmul(mh, x.to(mh.dtype))         # (N, C, out_h, w)
        y = torch.matmul(y, mw.t())                  # (N, C, out_h, out_w)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear-resize NCHW `x` to spatial `size` = (H, W).

    Accumulates in >= float32 (bf16 inputs upcast, f64 stays f64) with
    autocast off, so the f64-built coefficients are never rounded to bf16,
    and returns `x.dtype`."""
    n, c, h, w = x.shape
    out_h, out_w = size
    if (h, w) == (out_h, out_w):
        return x
    acc = torch.promote_types(x.dtype, torch.float32)
    return _apply(x, _interp(h, out_h, align_corners, acc, x.device),
                  _interp(w, out_w, align_corners, acc, x.device))


def resize_rows(x: torch.Tensor, mh: np.ndarray, out_w: int,
                align_corners: bool) -> torch.Tensor:
    """`resize_bilinear` of NCHW `x` with the (out_h, h) float64 height
    matrix `mh` in place of the interpolation's (some rows of a global
    matrix, over the source rows they read) and the width's to `out_w`;
    returns `x.dtype`."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return _apply(x, torch.as_tensor(mh, dtype=acc, device=x.device),
                  _interp(x.shape[3], out_w, align_corners, acc, x.device))
