"""P1/P2: the prototype fused separable upsample and its transpose — CUDA
kernel wrappers and their plain PyTorch versions.

They compute what the prototype tools/proto_fused_upsample.py computes
with its Pallas TPU kernels (P1 `_fwd_kernel` :47 behind `fused_upsample`,
P2 `_bwd_kernel` :92 behind `fused_downsample`), on its layout:

    ls2d   (N, h_pad, R * ws_pad) float32: R class rows of stride-8 logits,
           each ws_pad lanes wide, stacked along the last axis;
    mhT    (H, h_pad) float32: the row interpolation matrix, zero-padded;
    mw     (ws_pad, W_pad) float32: the column interpolation matrix,
           zero-padded (mwT, its transpose, for P2);

P1 returns out[n, r] = mhT @ ls2d[n][:, r-th lane block] @ mw, float32
(N, R, H, W_pad); P2 maps d (N, R, H, W_pad) to mhT^T @ d[n, r] @ mwT,
float32 (N, R, h_pad, ws_pad). The matrices are inputs, so either
align_corners convention and any padding go through.

`fused_upsample` and `fused_downsample` run the CUDA kernels
(csrc/fused_upsample.cu: two launches each of one batched matrix product
on the tensor cores, float32 by three TF32 products) for CUDA tensors and
the plain versions (two `torch.einsum`s in the input's dtype) for CPU
tensors; there is no fallback from one to the other. Each wrapper's
`launches` counts its calls that launched the kernels, and its
`issued_flops` gives the float32 operations its tiles issue at a shape.
"""
from __future__ import annotations

import ctypes

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _ptr, stream_ptr)


def fused_upsample_plain(ls2d: torch.Tensor, mhT: torch.Tensor,
                         mw: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch P1: every class row's columns, then the rows."""
    n, h_pad, lanes = ls2d.shape
    ls = ls2d.reshape(n, h_pad, n_rows, lanes // n_rows)
    v = torch.einsum("nhrw,wW->nhrW", ls, mw)
    return torch.einsum("Hh,nhrW->nrHW", mhT, v)


def fused_downsample_plain(d: torch.Tensor, mhT: torch.Tensor,
                           mwT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch P2: the rows' product, then the columns'."""
    dh = torch.einsum("Hh,nrHW->nrhW", mhT, d)
    return torch.einsum("nrhW,Ww->nrhw", dh, mwT)


def _check(tensors: dict, device: torch.device) -> None:
    """Raise on what the kernels do not take: tensors off the card or off
    `device`, not float32, not contiguous."""
    if device.type != "cuda":
        raise ValueError(f"the P1/P2 kernels take CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _Wrapper:
    source = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
              "csrc/fused_upsample.cu")

    def __init__(self):
        self.launches = 0

    @staticmethod
    def _lib(fn_name: str) -> ctypes.CDLL:
        lib = build.load("fused_upsample")
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            vp, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp] * 5 + [i] * 7 + [vp]
            fn.restype = ctypes.c_int
        return lib

    def issued_flops(self, *args) -> float:
        """The operations (two per multiply-add, pads and partial tiles
        included) that the kernels' tiles issue for these arguments, as
        float32 work; the tensor cores do it three times in TF32."""
        lib = self._lib(self._entry)
        fn = lib.fused_upsample_issued_flops
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_int] * 7
            fn.restype = ctypes.c_double
        return fn(self._bwd, *self._dims(*args))

    def _run(self, fn_name: str, ptrs, dims, device) -> None:
        lib = self._lib(fn_name)
        err = getattr(lib, fn_name)(*map(_ptr, ptrs), *dims, device.index,
                                    stream_ptr(device))
        if err != 0:
            raise RuntimeError(f"{fn_name} launch failed: "
                               f"{build.error_string(lib, err)} ({err})")
        self.launches += 1


class FusedUpsample(_Wrapper):
    """The P1 entry: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. `launches` counts kernel launches (plain runs do not)."""

    name = "fused_upsample"
    replaces = "tools/proto_fused_upsample.py:47"
    _entry, _bwd = "fused_upsample_fwd", 0

    def __call__(self, ls2d, mhT, mw, n_rows: int):
        if ls2d.device.type == "cpu":
            return fused_upsample_plain(ls2d, mhT, mw, n_rows)
        return self._launch(ls2d, mhT, mw, n_rows)

    @staticmethod
    def _dims(ls2d, mhT, mw, n_rows):
        """(n, rows, H, h_pad, ws_pad, W_pad) of the C entry points."""
        n, h_pad, lanes = ls2d.shape
        h_out = mhT.shape[0]
        ws_pad, w_pad = mw.shape
        if mhT.shape[1] != h_pad or lanes != n_rows * ws_pad:
            raise ValueError(f"shapes ls2d {tuple(ls2d.shape)}, mhT "
                             f"{tuple(mhT.shape)}, mw {tuple(mw.shape)} do not "
                             f"match {n_rows} rows")
        return n, n_rows, h_out, h_pad, ws_pad, w_pad

    def _launch(self, ls2d, mhT, mw, n_rows):
        _check({"ls2d": ls2d, "mhT": mhT, "mw": mw}, ls2d.device)
        dims = n, _, h_out, h_pad, _, w_pad = self._dims(ls2d, mhT, mw, n_rows)
        v = torch.empty((n, h_pad, n_rows, w_pad), dtype=torch.float32,
                        device=ls2d.device)
        out = torch.empty((n, n_rows, h_out, w_pad), dtype=torch.float32,
                          device=ls2d.device)
        self._run(self._entry, (ls2d, mhT, mw, v, out), dims, ls2d.device)
        return out


class FusedDownsample(_Wrapper):
    """The P2 entry: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; `launches` as P1's."""

    name = "fused_downsample"
    replaces = "tools/proto_fused_upsample.py:92"
    _entry, _bwd = "fused_downsample_bwd", 1

    def __call__(self, d, mhT, mwT):
        if d.device.type == "cpu":
            return fused_downsample_plain(d, mhT, mwT)
        return self._launch(d, mhT, mwT)

    @staticmethod
    def _dims(d, mhT, mwT):
        """(n, rows, H, h_pad, ws_pad, W_pad) of the C entry points."""
        n, n_rows, h_out, w_pad = d.shape
        h_pad = mhT.shape[1]
        ws_pad = mwT.shape[1]
        if mhT.shape[0] != h_out or mwT.shape[0] != w_pad:
            raise ValueError(f"shapes d {tuple(d.shape)}, mhT {tuple(mhT.shape)}, "
                             f"mwT {tuple(mwT.shape)} do not match")
        return n, n_rows, h_out, h_pad, ws_pad, w_pad

    def _launch(self, d, mhT, mwT):
        _check({"d": d, "mhT": mhT, "mwT": mwT}, d.device)
        dims = n, n_rows, _, h_pad, ws_pad, w_pad = self._dims(d, mhT, mwT)
        dh = torch.empty((n, n_rows, h_pad, w_pad), dtype=torch.float32,
                         device=d.device)
        out = torch.empty((n, n_rows, h_pad, ws_pad), dtype=torch.float32,
                          device=d.device)
        self._run(self._entry, (d, mhT, mwT, dh, out), dims, d.device)
        return out


fused_upsample = FusedUpsample()
fused_downsample = FusedDownsample()
