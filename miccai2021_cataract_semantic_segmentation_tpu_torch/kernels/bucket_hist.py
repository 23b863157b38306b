"""B3: the generic bucket-Lovász histogram — CUDA kernel wrapper and its
plain PyTorch version.

Both compute what the JAX package's `_bucket_histogram` returns (Pallas
kernel `_hist_kernel`, losses/bucket_lovasz.py:78) from

    errors_t  (R, P) float32 non-negative errors, one row per class row;
    fg_t      (R, P) bool foreground flags;

as integer statistics per [row][bg, fg][bucket] over the fixed 2048
uniform buckets min(int(e * 2048), 2047) of the float32 error: int32
counts and int64 sums of the error rounded to bf16, in fixed point (units
of 2^-18 in buckets 1..2047, where every such bf16 value is a multiple of
2^-18, so the sum is exact; units of 2^-48, truncated, in bucket 0; see
csrc/bucket_hist.cu). `hist_from_stats` turns them into the float32
(R, 2048, 4) histogram [n_fg, n_bg, se_fg, se_bg] of the JAX function.
Being integers, the statistics do not depend on the order of the sums: the
kernel equals its plain version bit for bit. Nothing is masked: pixels a
caller excluded arrive as e = 0, fg = False and count as background in
bucket 0, as on the TPU.

`bucket_histogram` runs the CUDA kernel (csrc/bucket_hist.cu) for CUDA
tensors, on the launch plan `b3_plan` computes (one wave of resident
blocks, capped so that the kernel's 32-bit offset sums and 12-bit lane
counts cannot overflow), and the plain version for CPU tensors; there is
no fallback from one to the other. Its `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    _ptr, stream_ptr)

N_BUCKETS = 2048            # fixed on this route, whatever lovasz_buckets says
SUM_SHIFT = 18              # log2 of the fixed-point scale of buckets >= 1
SUM_SHIFT_0 = 48            # ... and of bucket 0
# The kernel's shared table sums, per bin of buckets 1..2046, the offsets
# bf16(e) * 2^18 - 128 b in 32 bits. An offset lies in [-OFFSET_MIN,
# OFFSET_MAX] (half a bf16 ulp below 1 is 512 units), so a block may take
# at most BLOCK_PIXELS pixels of a row (csrc/bucket_hist.cu kBlockPixels).
# A lane counts bucket 0 in 12 bits of a register: at most LANE_PIXELS
# pixels a lane (kLanePixels).
OFFSET_MIN, OFFSET_MAX = 512, 640
BLOCK_PIXELS = 1 << 21
LANE_PIXELS = 4095
EDGE_PIXELS = 6             # a block's head and tail pixels, 3 each at most


def bucket_ids(errors_t: torch.Tensor) -> torch.Tensor:
    """int32 min(int(e * 2048), 2047) of float32 errors (negative where
    e < -1/2048: counted nowhere, gradient 0)."""
    return torch.clamp_max((errors_t * N_BUCKETS).to(torch.int32), N_BUCKETS - 1)


def sum_units(errors_t: torch.Tensor, bid: torch.Tensor) -> torch.Tensor:
    """int64 fixed-point bf16(e): units of 2^-18, or 2^-48 in bucket 0
    (truncated toward zero, as the kernel's double-to-integer cast)."""
    v = errors_t.to(torch.bfloat16).to(torch.float64)
    scale = torch.where(bid == 0, 2.0 ** SUM_SHIFT_0, 2.0 ** SUM_SHIFT)
    return (v * scale).to(torch.int64)


def bucket_stats_plain(errors_t: torch.Tensor, fg_t: torch.Tensor):
    """Plain PyTorch B3: (int32 counts, int64 sums), both (R, 2, 2048)."""
    r_rows = errors_t.shape[0]
    bid = bucket_ids(errors_t)
    row = torch.arange(r_rows, device=errors_t.device)[:, None]
    key = (row * 2 + fg_t.long()) * N_BUCKETS + bid
    hit = bid >= 0
    key, units = key[hit], sum_units(errors_t, bid)[hit]
    bins = r_rows * 2 * N_BUCKETS
    counts = torch.bincount(key, minlength=bins).to(torch.int32)
    sums = torch.zeros(bins, dtype=torch.int64, device=errors_t.device)
    sums.index_add_(0, key, units)
    return (counts.reshape(r_rows, 2, N_BUCKETS),
            sums.reshape(r_rows, 2, N_BUCKETS))


@functools.lru_cache(maxsize=8)
def _sum_scale(device: torch.device) -> torch.Tensor:
    """The (B,) float64 value of a sum unit per bucket, made once a device."""
    scale = torch.full((N_BUCKETS,), 2.0 ** -SUM_SHIFT, dtype=torch.float64,
                       device=device)
    scale[0] = 2.0 ** -SUM_SHIFT_0
    return scale


@torch.no_grad()
def hist_from_stats(counts: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """(R, 2, B) counts and fixed-point sums -> float32 (R, B, 4)
    [n_fg, n_bg, se_fg, se_bg]: each sum scaled in float64, rounded once to
    float32."""
    se = (sums.to(torch.float64) * _sum_scale(sums.device)).to(torch.float32)
    n = counts.to(torch.float32)
    return torch.stack([n[:, 1], n[:, 0], se[:, 1], se[:, 0]], dim=-1)


def bucket_histogram_plain(errors_t: torch.Tensor,
                           fg_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch B3 as the (R, 2048, 4) float32 histogram."""
    return hist_from_stats(*bucket_stats_plain(errors_t, fg_t))


def _check(errors_t: torch.Tensor, fg_t: torch.Tensor) -> None:
    """Raise on what the kernels (B3 and B4) do not take."""
    if errors_t.dim() != 2 or tuple(fg_t.shape) != tuple(errors_t.shape):
        raise ValueError(f"errors {tuple(errors_t.shape)} and fg "
                         f"{tuple(fg_t.shape)} must be the same (R, P)")
    if errors_t.dtype != torch.float32 or fg_t.dtype != torch.bool:
        raise TypeError(f"errors must be float32 and fg bool, got "
                        f"{errors_t.dtype} and {fg_t.dtype}")
    if fg_t.device != errors_t.device:
        raise ValueError(f"fg is on {fg_t.device}, errors on {errors_t.device}")
    if not (errors_t.is_contiguous() and fg_t.is_contiguous()):
        raise ValueError("errors and fg must be contiguous")
    r_rows, p = errors_t.shape
    if not (1 <= r_rows <= 65535 and 1 <= p < 2 ** 26):
        raise ValueError(f"the kernels take 1..65535 rows of 1..2^26 pixels, "
                         f"got ({r_rows}, {p})")


@dataclass(frozen=True)
class B3Plan:
    """B3's grid: `per_row` blocks of `threads` over every row, each walking
    `chunk` float4 vectors of it (counted from the row's first 16-byte
    aligned error), a vector a lane at a time; the first block also takes
    the up to 3 pixels before that error, the last the up to 3 after the
    row's last whole vector, one a lane."""
    per_row: int
    chunk: int
    threads: int

    @property
    def block_pixels(self) -> int:
        """The most pixels of one row a block of this plan takes."""
        return 4 * self.chunk + EDGE_PIXELS

    @property
    def lane_pixels(self) -> int:
        """The most pixels a lane of this plan takes."""
        return 4 * -(-self.chunk // self.threads) + 1


def b3_plan(rows: int, p: int, resident: int, threads: int,
            per_row: int | None = None) -> B3Plan:
    """The rows spread over one wave of `resident` blocks, never more (a
    second, partial wave would run alone), or `per_row` blocks a row where
    given; at least a vector a lane, at most BLOCK_PIXELS pixels a block
    and LANE_PIXELS a lane."""
    n_vec = max(p // 4, 1)
    want = per_row or max(1, resident // rows)
    chunk = max(-(-n_vec // want), 1 if per_row else threads)
    chunk = min(chunk, (BLOCK_PIXELS - EDGE_PIXELS) // 4,
                (LANE_PIXELS - 1) // 4 * threads)
    return B3Plan(per_row=-(-n_vec // chunk), chunk=chunk, threads=threads)


class BucketHistogram:
    """The B3 entry: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `launches` counts kernel launches (plain runs do not)."""

    name = "bucket_hist"
    source = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
              "csrc/bucket_hist.cu")
    replaces = ("miccai2021_cataract_semantic_segmentation_tpu/losses/"
                "bucket_lovasz.py:78")

    def __init__(self):
        self.launches = 0

    def __call__(self, errors_t: torch.Tensor,
                 fg_t: torch.Tensor) -> torch.Tensor:
        """(R, 2048, 4) float32 [n_fg, n_bg, se_fg, se_bg]."""
        return hist_from_stats(*self.stats(errors_t, fg_t))

    def stats(self, errors_t: torch.Tensor, fg_t: torch.Tensor):
        """(int32 counts, int64 sums), both (R, 2, 2048)."""
        if errors_t.device.type == "cpu":
            return bucket_stats_plain(errors_t, fg_t)
        return self._launch(errors_t, fg_t)

    def _launch(self, errors_t, fg_t):
        if errors_t.device.type != "cuda":
            raise ValueError(f"the B3 kernel takes CUDA tensors, got "
                             f"{errors_t.device}")
        _check(errors_t, fg_t)
        r_rows, p = errors_t.shape
        counts = torch.zeros((r_rows, 2, N_BUCKETS), dtype=torch.int32,
                             device=errors_t.device)
        sums = torch.zeros((r_rows, 2, N_BUCKETS), dtype=torch.int64,
                           device=errors_t.device)
        dev = errors_t.device.index
        lib = _hist_lib()
        run_plan(lib, default_plan(r_rows, p, dev), errors_t, fg_t, counts, sums)
        self.launches += 1
        return counts, sums


def run_plan(lib, plan: B3Plan, errors_t, fg_t, counts, sums) -> None:
    """Launch `lib`'s B3 kernel on the current stream with `plan`."""
    r_rows, p = errors_t.shape
    err = lib.bucket_hist_fwd(_ptr(errors_t), _ptr(fg_t), r_rows, p,
                              plan.per_row, plan.chunk, _ptr(counts),
                              _ptr(sums), errors_t.device.index,
                              stream_ptr(errors_t.device))
    if err != 0:
        raise RuntimeError(f"bucket_hist launch failed: "
                           f"{build.error_string(lib, err)} ({err})")


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B3's C entries on `lib` (built from csrc/bucket_hist.cu)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bucket_hist_fwd.argtypes = [vp, vp, i, i, i, i, vp, vp, i, vp]
    lib.bucket_hist_fwd.restype = i
    lib.bucket_hist_resident.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.bucket_hist_resident.restype = i
    return lib


def _hist_lib() -> ctypes.CDLL:
    lib = build.load("bucket_hist")
    if lib.bucket_hist_fwd.argtypes is None:
        set_argtypes(lib)
    return lib


def resident(lib, device: int) -> tuple[int, int]:
    """(blocks the card holds at once, threads a block) of `lib`'s kernel
    (the CUDA occupancy query)."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.bucket_hist_resident(device, ctypes.byref(blocks),
                                   ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"bucket_hist occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return blocks.value, threads.value


@functools.lru_cache(maxsize=64)
def default_plan(rows: int, p: int, device: int) -> B3Plan:
    """The wrapper's plan for (rows, p) on this card (computed once)."""
    return b3_plan(rows, p, *resident(_hist_lib(), device))


bucket_histogram = BucketHistogram()
