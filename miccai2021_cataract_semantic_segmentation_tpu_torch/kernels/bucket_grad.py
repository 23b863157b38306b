"""B4: the generic bucket-Lovász backward gather — CUDA kernel wrapper and
its plain PyTorch version.

Both compute what the JAX package's `_bucket_grad` returns (Pallas kernel
`_grad_kernel`, losses/bucket_lovasz.py:152) from

    errors_t  (R, P) float32 errors and fg_t (R, P) bool flags, as B3 takes
              them;
    table     (R, 2, 2048) float32 per-bucket gradients [row][bg, fg]
              [bucket], already scaled by the cotangent of each row's loss
              and rounded to bf16 (`losses/bucket_lovasz.py:grad_table`, as
              the TPU kernel rounds its table);

and return the float32 (R, P) gradient table[row][fg][bucket(e)], with B3's
bucket id and 0 where that id is negative. It is a gather, so the kernel
equals its plain version bit for bit.

`bucket_gather` runs the CUDA kernel (csrc/bucket_grad.cu) for CUDA tensors
and the plain version for CPU tensors; there is no fallback from one to the
other. Its `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    N_BUCKETS, _check, bucket_ids)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _ptr, stream_ptr)


def bucket_gather_plain(errors_t: torch.Tensor, fg_t: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch B4: one indexed read of the flattened table."""
    bid = bucket_ids(errors_t)
    row = torch.arange(errors_t.shape[0], device=errors_t.device)[:, None]
    idx = (row * 2 + fg_t.long()) * N_BUCKETS + bid.clamp_min(0)
    return torch.where(bid >= 0, table.reshape(-1)[idx], 0.0)


class BucketGather:
    """The B4 entry: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `launches` counts kernel launches (plain runs do not)."""

    name = "bucket_grad"
    source = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
              "csrc/bucket_grad.cu")
    replaces = ("miccai2021_cataract_semantic_segmentation_tpu/losses/"
                "bucket_lovasz.py:152")

    def __init__(self):
        self.launches = 0

    def __call__(self, errors_t: torch.Tensor, fg_t: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
        if errors_t.device.type == "cpu":
            return bucket_gather_plain(errors_t, fg_t, table)
        return self._launch(errors_t, fg_t, table)

    def _launch(self, errors_t, fg_t, table):
        if errors_t.device.type != "cuda":
            raise ValueError(f"the B4 kernel takes CUDA tensors, got "
                             f"{errors_t.device}")
        _check(errors_t, fg_t)
        r_rows, p = errors_t.shape
        if (table.device != errors_t.device or table.dtype != torch.float32
                or not table.is_contiguous()
                or tuple(table.shape) != (r_rows, 2, N_BUCKETS)):
            raise ValueError(f"table must be a contiguous float32 ({r_rows}, "
                             f"2, {N_BUCKETS}) tensor on {errors_t.device}")
        out = torch.empty_like(errors_t)
        lib = _grad_lib()
        err = lib.bucket_grad_bwd(_ptr(errors_t), _ptr(fg_t), _ptr(table),
                                  r_rows, p, _ptr(out), errors_t.device.index,
                                  stream_ptr(errors_t.device))
        if err != 0:
            raise RuntimeError(f"bucket_grad launch failed: "
                               f"{build.error_string(lib, err)} ({err})")
        self.launches += 1
        return out


def _grad_lib() -> ctypes.CDLL:
    lib = build.load("bucket_grad")
    fn = lib.bucket_grad_bwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_longlong, vp,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return lib


bucket_gather = BucketGather()
