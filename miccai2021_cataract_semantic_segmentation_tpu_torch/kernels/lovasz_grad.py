"""B2: the fused bucket-Lovász backward — CUDA kernel wrapper and its plain
PyTorch version.

Both compute what the JAX package's `_fu_grad` returns (Pallas kernel
`_fu_bwd_kernel`, losses/fused_lovasz.py:742) on the port's layout:

    ls      (N, R, hs, ws) float32 stride-8 logits, as B1 takes them;
    labels  (N, H_pad, W_pad) int32, -1 where a pixel gets no count;
    mats    B1's `FuMats` for the same geometry;
    table   (R, 2, B) float32 per-bucket gradients [row][bg, fg][bucket],
            already scaled by the cotangent of each row's loss and rounded
            to bf16 (as the TPU kernel rounds its table);

and return the float32 gradient (N, R, hs, ws). Per (pixel, row) they
recompute B1's probabilities and bucket ids, gather de from the table,
apply dp = (fg ? -de : de) on counted pixels and the softmax VJP, and
scatter back through the transposed interpolation (columns, then rows).

`fu_grad` runs the CUDA kernel (csrc/fu_grad.cu) for CUDA tensors and the
plain version for CPU tensors; there is no fallback from one to the other.
Its `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    FuMats, _check, _ptr, bucket_params, plain_fields, stream_ptr)


def fu_grad_plain(ls: torch.Tensor, labels: torch.Tensor, mats: FuMats,
                  table: torch.Tensor, *, n_cls: int, n_buckets: int,
                  edges: str = "uniform", seed: int = 0,
                  dither: bool = False) -> torch.Tensor:
    """Plain PyTorch B2: `plain_fields`, then `grad_from_fields`."""
    p, fg, keep, bid = plain_fields(ls, labels, mats, n_cls=n_cls,
                                    n_buckets=n_buckets, edges=edges,
                                    seed=seed, dither=dither)
    return grad_from_fields(p, fg, keep, bid, mats, table)


def softmax_vjp_from_fields(p, fg, keep, bid, table: torch.Tensor) -> torch.Tensor:
    """dz (N, S, C, H, W): the table gather de = table[row][fg][bid],
    dp = (fg ? -de : de) on kept pixels and 0 elsewhere, and the softmax
    VJP p * (dp - sum_c dp * p), from p (N, S, C, H, W), fg (N, C, H, W),
    keep (N, H, W) and bucket ids (any value where keep is False)."""
    _, n_scales, n_cls = p.shape[:3]
    n_buckets = table.shape[-1]
    fg5 = fg[:, None]                                        # (N, 1, C, H, W)
    row = torch.arange(n_scales * n_cls, device=p.device).reshape(
        1, n_scales, n_cls, 1, 1)
    idx = (row * 2 + fg5.long()) * n_buckets + bid.clamp_min(0)
    de = table.reshape(-1)[idx]
    dp = torch.where(fg5, -de, de) * keep[:, None, None]
    return p * (dp - (dp * p).sum(dim=2, keepdim=True))


def grad_from_fields(p, fg, keep, bid, mats: FuMats,
                     table: torch.Tensor) -> torch.Tensor:
    """`softmax_vjp_from_fields`, then the transposed interpolation as two
    einsums (mw, then mh), from `plain_fields`' p, fg, keep and ids."""
    n, n_scales, n_cls, h_pad, w_pad = p.shape
    dz = softmax_vjp_from_fields(p, fg, keep, bid, table).reshape(
        n, n_scales * n_cls, h_pad, w_pad)
    d = torch.einsum("nryx,wx->nryw", dz, mats.mw)
    return torch.einsum("yh,nryw->nrhw", mats.mh, d)


class FuGrad:
    """The B2 entry: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `launches` counts kernel launches (plain runs do not)."""

    name = "fu_grad"
    source = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
              "csrc/fu_grad.cu")
    replaces = ("miccai2021_cataract_semantic_segmentation_tpu/losses/"
                "fused_lovasz.py:742")

    def __init__(self):
        self.launches = 0

    def __call__(self, ls, labels, mats: FuMats, table, *, n_cls: int,
                 n_buckets: int, edges: str = "uniform", seed: int = 0,
                 dither: bool = False) -> torch.Tensor:
        kwargs = dict(n_cls=n_cls, n_buckets=n_buckets, edges=edges,
                      seed=seed, dither=dither)
        if ls.device.type == "cpu":
            return fu_grad_plain(ls, labels, mats, table, **kwargs)
        return self._launch(ls, labels, mats, table, None, **kwargs)

    def with_bucket_ids(self, ls, labels, mats: FuMats, table, **kwargs):
        """(gradient, int32 (N, R, H_pad, W_pad) bucket ids, -1 where the
        label is -1) from one kernel launch: the ids the backward used,
        for checking them against B1's counts on the card."""
        n, r_rows = ls.shape[:2]
        bids = torch.empty((n, r_rows, *labels.shape[1:]), dtype=torch.int32,
                           device=ls.device)
        return self._launch(ls, labels, mats, table, bids, **kwargs), bids

    def _launch(self, ls, labels, mats, table, bids, *, n_cls, n_buckets,
                edges, seed, dither):
        if ls.device.type != "cuda":
            raise ValueError(f"the B2 kernel takes CUDA tensors, got {ls.device}")
        _check(ls, labels, mats, n_cls)
        n, r_rows, hs, ws = ls.shape
        h_pad, w_pad = labels.shape[1:]
        if (table.device != ls.device or table.dtype != torch.float32
                or not table.is_contiguous()
                or tuple(table.shape) != (r_rows, 2, n_buckets)):
            raise ValueError(f"table must be a contiguous float32 "
                             f"({r_rows}, 2, {n_buckets}) tensor on {ls.device}")
        rows = torch.empty((n, r_rows, h_pad, ws), dtype=torch.float32,
                           device=ls.device)
        out = torch.empty((n, r_rows, hs, ws), dtype=torch.float32,
                          device=ls.device)
        half, shift, q0, e_min, seed32, inv_b = bucket_params(n_buckets,
                                                              edges, seed)
        lib = _grad_lib()
        err = lib.fu_grad_bwd(
            _ptr(ls), _ptr(labels), _ptr(mats.h_lo), _ptr(mats.h_w0),
            _ptr(mats.h_w1), _ptr(mats.h_beg), _ptr(mats.h_end),
            _ptr(mats.w_lo), _ptr(mats.w_w0), _ptr(mats.w_w1),
            _ptr(mats.w_beg), _ptr(mats.w_end), _ptr(table), _ptr(rows),
            _ptr(out), ctypes.c_void_p(None if bids is None else bids.data_ptr()),
            n, r_rows // n_cls, n_cls, hs, ws, h_pad, w_pad, n_buckets,
            int(edges != "uniform"), half, shift, q0, e_min, int(dither),
            seed32, inv_b, ls.device.index, stream_ptr(ls.device))
        if err != 0:
            raise RuntimeError(f"fu_grad launch failed: "
                               f"{build.error_string(lib, err)} ({err})")
        self.launches += 1
        return out


def _grad_lib() -> ctypes.CDLL:
    lib = build.load("fu_grad")
    fn = lib.fu_grad_bwd
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 16 + [i] * 12 + [f, i, i, f, i, vp]
        fn.restype = ctypes.c_int
    return lib


fu_grad = FuGrad()
