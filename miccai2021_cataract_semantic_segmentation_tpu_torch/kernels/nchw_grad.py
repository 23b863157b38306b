"""B6 and B8: the bucket-Lovász backward on full-resolution NCHW logit
grids — CUDA kernel wrappers and their plain PyTorch version.

Both compute what the JAX package's `_nchw_grad` (Pallas kernel
`_nchw_bwd_kernel`, losses/fused_lovasz.py:353, two scales: B6) and
`_nchw1_grad` (`_nchw1_bwd_kernel`, :1226, one scale: B8) return, both
through `_degrad_rows` (:307), on the port's layout:

    grids, labels, w_real   as B5/B7 take them (kernels/nchw_hist.py);
    table   (S*C, 2, B) float32 per-bucket gradients [row][bg, fg][bucket],
            already scaled by the cotangent of each row's loss and rounded
            to bf16 (as the TPU kernel rounds its table);

and return one float32 (N, C, H_pad, W_pad) gradient per scale. Per
(pixel, row) they recompute B5/B7's probabilities and bucket ids, gather
de from the table, apply dp = (fg ? -de : de) on counted pixels (0 where
the label is -1 or the lane is at or past w_real) and the softmax VJP.

`nchw_gradient` (B6) and `nchw1_gradient` (B8) run the one CUDA source
csrc/nchw_grad.cu for CUDA tensors and the plain version for CPU tensors;
there is no fallback from one to the other. Each counts its own launches.
"""
from __future__ import annotations

import ctypes

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (
    softmax_vjp_from_fields)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _ptr, bucket_params, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    _JAX_FILE, _void, check_nchw, nchw_fields)

SOURCE = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
          "csrc/nchw_grad.cu")


def nchw_grad_plain(grids, labels: torch.Tensor, table: torch.Tensor, *,
                    n_buckets: int, edges: str = "uniform",
                    w_real: int) -> list[torch.Tensor]:
    """Plain PyTorch B6/B8: `nchw_fields`, then `softmax_vjp_from_fields`."""
    p, fg, keep, bid = nchw_fields(grids, labels, n_buckets=n_buckets,
                                   edges=edges, w_real=w_real)
    dz = softmax_vjp_from_fields(p, fg, keep, bid, table)
    return [d.contiguous() for d in dz.unbind(1)]


class NchwGrad:
    """The B6 (two scales) or B8 (one scale) entry: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. `launches` counts
    kernel launches (plain runs do not)."""

    source = SOURCE

    def __init__(self, n_scales: int, name: str, replaces: str):
        self.n_scales, self.name, self.replaces = n_scales, name, replaces
        self.launches = 0

    def __call__(self, grids, labels, table, *, n_buckets: int,
                 edges: str = "uniform", w_real: int) -> list[torch.Tensor]:
        if len(grids) != self.n_scales:
            raise ValueError(f"{self.name} takes {self.n_scales} grid(s), "
                             f"got {len(grids)}")
        if grids[0].device.type == "cpu":
            return nchw_grad_plain(grids, labels, table, n_buckets=n_buckets,
                                   edges=edges, w_real=w_real)
        return self._launch(grids, labels, table, None, n_buckets, edges, w_real)

    def with_bucket_ids(self, grids, labels, table, *, n_buckets: int,
                        edges: str = "uniform", w_real: int):
        """(gradients, int32 (N, S*C, H_pad, W_pad) bucket ids, -1 where no
        count) from one kernel launch: the ids the backward used, for
        checking them against B5/B7's counts on the card."""
        n, n_cls, h_pad, w_pad = grids[0].shape
        bids = torch.empty((n, self.n_scales * n_cls, h_pad, w_pad),
                           dtype=torch.int32, device=labels.device)
        return self._launch(grids, labels, table, bids, n_buckets, edges,
                            w_real), bids

    def _launch(self, grids, labels, table, bids, n_buckets, edges, w_real):
        if labels.device.type != "cuda":
            raise ValueError(f"{self.name} takes CUDA tensors, got {labels.device}")
        check_nchw(grids, labels, self.n_scales, w_real)
        n, n_cls, h_pad, w_pad = grids[0].shape
        r_rows = self.n_scales * n_cls
        if (table.device != labels.device or table.dtype != torch.float32
                or not table.is_contiguous()
                or tuple(table.shape) != (r_rows, 2, n_buckets)):
            raise ValueError(f"table must be a contiguous float32 "
                             f"({r_rows}, 2, {n_buckets}) tensor on {labels.device}")
        outs = [torch.empty_like(g) for g in grids]
        half, shift, q0, e_min, _, _ = bucket_params(n_buckets, edges, 0)
        lib = _grad_lib()
        two = self.n_scales == 2
        err = lib.nchw_grad_bwd(
            _ptr(grids[0]), _void(grids[1] if two else None), _ptr(labels),
            _ptr(table), _ptr(outs[0]), _void(outs[1] if two else None),
            _void(bids), n, self.n_scales, n_cls, h_pad, w_pad, w_real,
            n_buckets, int(edges != "uniform"), half, shift, q0, e_min,
            labels.device.index, stream_ptr(labels.device))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{build.error_string(lib, err)} ({err})")
        self.launches += 1
        return outs


def _grad_lib() -> ctypes.CDLL:
    lib = build.load("nchw_grad")
    fn = lib.nchw_grad_bwd
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 7 + [i] * 11 + [f, i, vp]
        fn.restype = ctypes.c_int
    return lib


nchw_gradient = NchwGrad(2, "nchw_grad", f"{_JAX_FILE}:353")
nchw1_gradient = NchwGrad(1, "nchw1_grad", f"{_JAX_FILE}:1226")
