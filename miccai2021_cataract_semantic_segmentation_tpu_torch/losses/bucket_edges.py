"""Bucket-edge maps for the bucket Lovász histogram.

The port's own copy of the JAX package's losses/bucket_edges.py (numpy
twins, bit-equal) plus the torch forms the plain B1 version uses.

The bucket Lovász quantises per-pixel errors e = |fg - p| in [0, 1] into B
buckets. UNIFORM edges: bid = min(int(e*B), B-1). ADAPTIVE edges spend
resolution logarithmically toward both ends: with u = min(e, 1-e), buckets
are per-octave linear in u (u from 2^-(octaves+1) to 0.5), mirrored around
e = 0.5, and the id is a shift of the float32 bit pattern:

    bid = (bitcast_i32(max(u, 2^-(octaves+1))) >> (23 - j)) - q0

DITHER (optional) shifts each error by (d - 1/2)/B before the uniform map,
with d = (fmix32(idx ^ seed) & 0xFFFF) / 65536 from the murmur3 finalizer
of the pixel's row-major index over the padded (N, H_pad, W_pad) grid.
Then E_d[bid] = e*B - 1/2 (not e*B), so the bucket midpoint (bid + 1/2)/B
is the unbiased estimate of e. The shift is sized for uniform buckets;
with adaptive edges it is computed all the same (as the JAX package does)
and the loss warns.
"""
from __future__ import annotations

import numpy as np
import torch

_OCTAVES = 16            # default u-octave count ("adaptive"); e_min = 2^-17


def _parse_mode(edges: str) -> int:
    """'adaptive' -> 16 octaves; 'adaptiveN' -> N octaves (power of two)."""
    if edges == "adaptive":
        return _OCTAVES
    if edges.startswith("adaptive"):
        n = int(edges[len("adaptive"):])
        if n < 1 or n & (n - 1):
            raise ValueError(f"octave count must be a power of two: '{edges}'")
        return n
    raise ValueError(f"unknown edges mode '{edges}'")


def _adaptive_split(n_buckets: int, octaves: int) -> tuple[int, int]:
    """(half, j): half buckets per side, 2^j sub-buckets per octave."""
    half = n_buckets // 2
    if half < octaves or 2 * half != n_buckets:
        raise ValueError(
            f"adaptive edges need n_buckets = 2 * {octaves} * 2^k, "
            f"got {n_buckets}")
    j = int(round(np.log2(half / octaves)))
    if octaves * (1 << j) != half:
        raise ValueError(
            f"adaptive edges need n_buckets = 2 * {octaves} * 2^k, "
            f"got {n_buckets}")
    return half, j


def adaptive_params(n_buckets: int, edges: str) -> tuple[int, int, int, float]:
    """(half, shift, q0, e_min) of the adaptive map."""
    octaves = _parse_mode(edges)
    half, j = _adaptive_split(n_buckets, octaves)
    return half, 23 - j, (127 - (octaves + 1)) << j, 2.0 ** -(octaves + 1)


def bucket_edges(n_buckets: int, edges: str = "uniform") -> np.ndarray:
    """(B+1,) float64 bucket edge array; edges[0] = 0, edges[B] = 1."""
    if edges == "uniform":
        return np.linspace(0.0, 1.0, n_buckets + 1)
    octaves = _parse_mode(edges)
    half, j = _adaptive_split(n_buckets, octaves)
    exp0 = 127 - (octaves + 1)         # f32 exponent field of u_min
    qs = np.arange(half + 1, dtype=np.int64)
    bits = ((exp0 << j) + qs) << (23 - j)
    lo = bits.astype(np.uint32).view(np.float32).astype(np.float64)
    lo[0] = 0.0        # bucket 0 absorbs u < 2^-(octaves+1); edge q=half is 0.5
    hi = 1.0 - lo[::-1]    # mirror for the e >= 0.5 side
    return np.concatenate([lo, hi[1:]])


def bucket_midpoints_np(n_buckets: int, edges: str = "uniform") -> np.ndarray:
    """(B,) f32 representative error per bucket (arithmetic midpoints of the
    edge pairs) for reconstructing the loss value from counts."""
    e = bucket_edges(n_buckets, edges)
    return (0.5 * (e[:-1] + e[1:])).astype(np.float32)


def bucket_id_np(e: np.ndarray, n_buckets: int,
                 edges: str = "uniform") -> np.ndarray:
    """Numpy form of the bucket-id map."""
    e = np.asarray(e, np.float32)
    if edges == "uniform":
        return np.minimum((e * n_buckets).astype(np.int32), n_buckets - 1)
    half, shift, q0, e_min = adaptive_params(n_buckets, edges)
    u = np.minimum(e, np.float32(1.0) - e)
    uc = np.maximum(u, np.float32(e_min))
    q = (uc.view(np.int32) >> shift) - q0
    q = np.minimum(q, half - 1)
    return np.where(e < 0.5, q, (n_buckets - 1) - q).astype(np.int32)


def fmix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on uint32 arrays (wraparound multiply)."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = h * np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h = h * np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def dither_unit_np(idx: np.ndarray, seed: int) -> np.ndarray:
    """d in [0, 1): 16-bit uniform from hash(global pixel index ^ seed)."""
    h = fmix32_np(idx.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF))
    return (h & np.uint32(0xFFFF)).astype(np.float32) * np.float32(1 / 65536)


def dithered_bucket_id_np(e: np.ndarray, idx: np.ndarray, seed: int,
                          n_buckets: int) -> np.ndarray:
    """Dithered uniform map: e' = e + (d - 1/2)/B through the uniform map
    (int32 truncation toward zero sends the e' < 0 tail to bucket 0)."""
    d = dither_unit_np(idx, seed)
    e2 = e.astype(np.float32) + (d - np.float32(0.5)) / np.float32(n_buckets)
    return np.minimum((e2 * n_buckets).astype(np.int32), n_buckets - 1)


# ---------------------------------------------------------------------------
# torch forms (uint32 arithmetic carried in int64, masked to 32 bits)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): 16-bit halves keep every
    partial product below 2^49, so int64 never overflows."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer; int64 tensor of uint32 values in and out."""
    h = h & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dither_shift(idx: torch.Tensor, seed: int, n_buckets: int) -> torch.Tensor:
    """f32 error shift (d - 1/2)/B for int64 pixel indices."""
    h = fmix32(idx ^ (seed & _MASK32))
    d = (h & 0xFFFF).to(torch.float32) * np.float32(1 / 65536)
    return (d - np.float32(0.5)) * np.float32(1.0 / n_buckets)


def make_bid_fn(n_buckets: int, edges: str = "uniform"):
    """f32 error tensor -> int32 bucket ids (the map of bucket_id_np)."""
    if edges == "uniform":
        def bid_uniform(e):
            return torch.clamp_max((e * n_buckets).to(torch.int32),
                                   n_buckets - 1)
        return bid_uniform
    half, shift, q0, e_min = adaptive_params(n_buckets, edges)

    def bid_adaptive(e):
        u = torch.minimum(e, 1.0 - e)
        uc = torch.clamp_min(u, e_min)
        q = (uc.view(torch.int32) >> shift) - q0
        q = torch.clamp_max(q, half - 1)
        return torch.where(e < 0.5, q, (n_buckets - 1) - q)

    return bid_adaptive
