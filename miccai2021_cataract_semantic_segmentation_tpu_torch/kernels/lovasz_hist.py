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
    # (rows, columns) of the largest source window of one of B1's tiles
    # (`tap_window`), for its launch plan
    window: tuple = (0, 0)
    # per source column (w_beg, w_end, w_lo[w_beg], w_lo[w_end - 1]) (all 0
    # where no output column reads it), for B2's launch plan
    columns: tuple = ()
    # the most output rows whose first tap is one source row, for B2's plan
    row_run: int = 0


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
    window = tap_window(mh, mw_t, TILE_H, TILE_W_LOG2)
    # built outside inference mode so the cached tensors are usable anywhere
    with torch.inference_mode(False):
        return FuMats(*(torch.as_tensor(a, device=device) for a in arrays), window,
                      column_facts(mw_t), row_run(mh))


def row_run(mh: np.ndarray) -> int:
    """The most real rows of the float32 (H_pad, hs) matrix whose first
    nonzero entry is the same source row."""
    lo = _taps(mh)[0][(mh != 0).any(1)]
    return int(np.bincount(lo).max()) if lo.size else 0


def column_facts(mw_t: np.ndarray) -> tuple:
    """((w_beg, w_end, w_lo[w_beg], w_lo[w_end - 1]), ...) per source
    column of the float32 (W_pad, ws) matrix, 0s where no output column
    reads it: what B2's launch plan needs of the column taps."""
    lo = _taps(mw_t)[0]
    return tuple((int(b), int(e), int(lo[b]) if e > b else 0, int(lo[e - 1]) if e > b else 0)
                 for b, e in zip(*_ranges(mw_t)))


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


# B1's launch plan. A block of the kernel (csrc/fu_hist.cu) holds, in
# dynamic shared memory, its class rows as 16-bit counters two to a 32-bit
# word ((2, B) counters, 4B bytes, per row), one spare word per lane, and
# two windows of source logits (the tile it is on and the next). Each lane
# counts bucket 0 of the bg half in 8-bit register counters.
SMEM_PER_BLOCK = 232_448   # the shared memory one block may opt into (H100)
SMEM_PER_SM = 233_472      # an SM's shared memory, 1 KB of it per block reserved
REGS_PER_SM = 65_536
STATIC_SMEM = 256          # the kernel's own table of row pointers
SPARE_WORDS = 32
COUNT_MAX = 0xFFFF         # a 16-bit counter: the most a table bin may receive
LANE_MAX = 0xFF            # an 8-bit register counter: the most pixels a lane counts
MAX_CLUSTER = 8            # the portable cluster size
TILE_W_LOG2 = 7            # tiles of 128 columns: four warps side by side
TILE_H = 16


def max_threads(n_cls: int) -> int:
    """The kernel instance's largest block (its __launch_bounds__): 1024
    threads at 64 registers up to 17 classes, else 512 at 128."""
    return 1024 if n_cls <= 17 else 512


def table_words(rows: int, n_buckets: int) -> int:
    """32-bit words of `rows` class rows of 16-bit (bg, fg) counters."""
    return rows * n_buckets


@dataclass(frozen=True)
class B1Layout:
    """What one block of a B1 launch holds. `groups` blocks share a scale's
    `n_cls` rows, `rows_per` each (the last may hold fewer). `cluster`: the
    groups are the blocks of a thread-block cluster, which count each pixel
    once and add into each other's tables; otherwise each group is a block
    of its own that computes every pixel again and counts its own rows (the
    old layout, which `b1_layout` makes only when asked). A block of
    `threads` threads walks tiles of tile_h x 2**tile_w_log2 pixels and
    stages each tile's win_h x win_w source logits (0 x 0: none)."""
    n_cls: int
    n_buckets: int
    groups: int
    rows_per: int
    cluster: bool
    threads: int
    tile_h: int
    tile_w_log2: int
    win_h: int
    win_w: int

    @property
    def softmax_passes(self) -> int:
        """How many times the grid computes each pixel's softmax per scale."""
        return 1 if self.cluster else self.groups

    @property
    def tile_px(self) -> int:
        return self.tile_h << self.tile_w_log2

    @property
    def win_off(self) -> int:
        """The window's offset in words: after the table and the spare
        words, at a 16-byte boundary."""
        return -(-(table_words(self.rows_per, self.n_buckets) + SPARE_WORDS) // 4) * 4

    @property
    def smem(self) -> int:
        """Dynamic shared memory per block, bytes: the table, the spare
        words and two windows (classes padded to 4)."""
        cp = -(-self.n_cls // 4) * 4
        return 4 * (self.win_off + 2 * self.win_h * self.win_w * cp)


def sm_threads(threads: int, smem: int, n_cls: int) -> int:
    """The threads an SM holds of blocks of `threads` threads and `smem`
    bytes: bounded by its shared memory and its registers (64 or 128 a
    thread, `max_threads`)."""
    by_smem = SMEM_PER_SM // (smem + STATIC_SMEM + 1024)
    by_regs = REGS_PER_SM // (64 if max_threads(n_cls) == 1024 else 128) // threads
    return min(by_smem, by_regs) * threads


def _span(m: np.ndarray, tile: int) -> int:
    """The source rows a tile of `tile` output rows of the bilinear matrix
    `m` (n_out, n_src) reads: from its first row's first tap to its last
    real row's second (pad rows, all zero, read from global memory)."""
    lo, _, _ = _taps(m)
    lo = np.where((m != 0).any(1), lo, -1).astype(np.int64)
    lo = np.pad(lo, (0, -len(lo) % tile), constant_values=-1).reshape(-1, tile)
    last = np.where(lo >= 0, np.minimum(lo + 1, m.shape[1] - 1), -1).max(1)
    return int(np.where(lo[:, 0] >= 0, last - lo[:, 0] + 1, 0).max())


def tap_window(mh: np.ndarray, mw_t: np.ndarray, tile_h: int,
               tile_w_log2: int) -> tuple[int, int]:
    """(rows, columns) of the largest source window of a tile of tile_h x
    2**tile_w_log2 pixels, from the float32 matrices mh (H_pad, hs) and
    mw_t (W_pad, ws): what B1 stages."""
    return _span(mh, tile_h), _span(mw_t, 1 << tile_w_log2)


def b1_window(mats: FuMats, tile_h: int = TILE_H,
              tile_w_log2: int = TILE_W_LOG2) -> tuple[int, int]:
    """`tap_window` of these taps at another tile (a device read where the
    matrices live on the card)."""
    if (tile_h, tile_w_log2) == (TILE_H, TILE_W_LOG2):
        return mats.window
    return tap_window(mats.mh.cpu().numpy(), mats.mw.T.cpu().numpy(), tile_h,
                      tile_w_log2)


def b1_layout(n_cls: int, n_buckets: int, window: tuple[int, int] = (0, 0), *,
              tile_h: int = TILE_H, tile_w_log2: int = TILE_W_LOG2,
              groups: int | None = None, cluster: bool = True,
              threads: int | None = None) -> B1Layout:
    """The fewest row groups whose share of the rows fits one block (a
    cluster of that many blocks); the source `window` staged where it fits
    beside the table; blocks of 256, 512 or 1024 threads, whichever lets an
    SM hold the most threads (the smaller on a tie). `groups`, `cluster`,
    `threads` and a window of (0, 0) force another layout (the
    ablation's)."""
    if not 1 <= n_cls <= MAX_CLASSES or n_buckets < 1:
        raise ValueError(f"B1 takes 1..{MAX_CLASSES} classes, got C={n_cls}, "
                         f"B={n_buckets}")

    def make(g, win, t=256):
        return B1Layout(n_cls, n_buckets, g, -(-n_cls // g), cluster and g > 1, t,
                        tile_h, tile_w_log2, *win)

    room = SMEM_PER_BLOCK - STATIC_SMEM
    if groups is None:
        groups = next((g for g in range(1, MAX_CLUSTER + 1)
                       if make(g, (0, 0)).smem <= room), None)
        if groups is None:
            raise ValueError(f"B={n_buckets} buckets of {n_cls} classes do not "
                             f"fit a cluster of {MAX_CLUSTER} blocks")
    if not 1 <= groups <= MAX_CLUSTER or make(groups, (0, 0)).smem > room:
        raise ValueError(f"{groups} groups of {n_cls} rows at B={n_buckets} "
                         "do not fit")
    if make(groups, window).smem > room:
        window = (0, 0)
    smem = make(groups, window).smem
    if threads is None:
        sizes = [t for t in (256, 512, 1024) if t <= max_threads(n_cls)]
        threads = max(sizes, key=lambda t: (sm_threads(t, smem, n_cls), -t))
    if not 32 <= threads <= max_threads(n_cls) or threads % 32:
        raise ValueError(f"{threads} threads: the C={n_cls} kernel takes 32.."
                         f"{max_threads(n_cls)}, a multiple of 32")
    if tile_w_log2 < 5:
        raise ValueError("tiles are at least one warp wide")
    return make(groups, window, threads)


@dataclass(frozen=True)
class B1Plan:
    """A B1 launch: `layout` on a grid of (ctas_x, n_scales) blocks. Block x
    of scale s is pixel stream x (cluster) or x // groups (no cluster), and
    stream j walks tiles j, j + streams, ... of the scale's
    n * tiles_h * tiles_w."""
    layout: B1Layout
    n: int
    n_scales: int
    h_pad: int
    w_pad: int
    ctas_x: int

    @property
    def tiles_h(self) -> int:
        return -(-self.h_pad // self.layout.tile_h)

    @property
    def tiles_w(self) -> int:
        return -(-self.w_pad >> self.layout.tile_w_log2)

    @property
    def n_tiles(self) -> int:
        return self.n * self.tiles_h * self.tiles_w

    @property
    def streams(self) -> int:
        return self.ctas_x if self.layout.cluster else self.ctas_x // self.layout.groups

    def stream_tiles(self, stream: int) -> range:
        return range(stream, self.n_tiles, self.streams)

    @property
    def lane_pixels(self) -> int:
        """The most pixels one thread counts."""
        layout = self.layout
        return -(-self.n_tiles // self.streams) * -(-layout.tile_px // layout.threads)

    @property
    def table_pixels(self) -> int:
        """The most pixels whose counts one block's table receives: its
        stream's, or its cluster's streams'."""
        per_stream = -(-self.n_tiles // self.streams) * self.layout.tile_px
        return per_stream * (self.layout.groups if self.layout.cluster else 1)


def b1_plan(layout: B1Layout, n: int, n_scales: int, h_pad: int, w_pad: int,
            *, resident: int) -> B1Plan:
    """One wave of the `resident` blocks the card holds, split over the
    scales, with more streams where a table would otherwise receive more
    than COUNT_MAX pixels or a lane count more than LANE_MAX; never more
    streams than tiles (a cluster's streams rounded up to whole
    clusters)."""
    g = layout.groups
    tiles = n * -(-h_pad // layout.tile_h) * -(-w_pad >> layout.tile_w_log2)
    share = g if layout.cluster else 1
    cap = min(COUNT_MAX // (share * layout.tile_px),
              LANE_MAX // -(-layout.tile_px // layout.threads))
    if cap < 1:
        raise ValueError("a tile is larger than the counters can count")
    per_scale = max(resident // n_scales // g, 1) * g
    streams = per_scale if layout.cluster else per_scale // g
    streams = min(max(streams, -(-tiles // cap)), tiles)
    if layout.cluster:
        streams = -(-streams // g) * g
    ctas_x = streams if layout.cluster else streams * g
    return B1Plan(layout, n, n_scales, h_pad, w_pad, ctas_x)


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
        lib = _fu_lib()
        n, r_rows = ls.shape[:2]
        plan = default_plan(n_cls, n_buckets, mats.window, n, r_rows // n_cls,
                            *labels.shape[1:], edges == "uniform" and not dither,
                            ls.device.index)
        out = run_plan(lib, plan, ls, labels, mats, n_cls=n_cls,
                       n_buckets=n_buckets, edges=edges, seed=seed,
                       dither=dither)
        self.launches += 1
        return out


def run_plan(lib, plan: B1Plan, ls, labels, mats, *, n_cls, n_buckets, edges,
             seed, dither) -> torch.Tensor:
    """Launch `lib`'s B1 (the committed library, or an edited build of the
    same source) with `plan` on checked CUDA tensors; the int32 counts."""
    n, r_rows, hs, ws = ls.shape
    h_pad, w_pad = labels.shape[1:]
    layout = plan.layout
    out = torch.zeros((r_rows, 2, n_buckets), dtype=torch.int32,
                      device=ls.device)
    half, shift, q0, e_min, seed32, inv_b = bucket_params(n_buckets, edges, seed)
    err = lib.fu_hist_fwd(
        _ptr(ls), _ptr(labels), _ptr(mats.h_lo), _ptr(mats.h_w0),
        _ptr(mats.h_w1), _ptr(mats.w_lo), _ptr(mats.w_w0), _ptr(mats.w_w1),
        _ptr(out), n, r_rows // n_cls, n_cls, hs, ws, h_pad, w_pad, n_buckets,
        int(edges != "uniform"), half, shift, q0, e_min, int(dither), seed32,
        inv_b, layout.tile_h, layout.tile_w_log2, layout.groups, layout.rows_per,
        int(layout.cluster), layout.win_h, layout.win_w, plan.ctas_x,
        layout.threads, layout.smem, ls.device.index, stream_ptr(ls.device))
    if err != 0:
        raise RuntimeError(f"fu_hist launch failed: "
                           f"{build.error_string(lib, err)} ({err})")
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


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B1's two C entries on `lib` (built from csrc/fu_hist.cu)."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fu_hist_fwd.argtypes = [vp] * 9 + [i] * 12 + [f, i, i, f] + [i] * 11 + [vp]
    lib.fu_hist_fwd.restype = ctypes.c_int
    lib.fu_hist_resident.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.fu_hist_resident.restype = ctypes.c_int
    return lib


def _fu_lib() -> ctypes.CDLL:
    lib = build.load("fu_hist")
    if lib.fu_hist_fwd.argtypes is None:
        set_argtypes(lib)
    return lib


def resident_blocks(lib, layout: B1Layout, device: int, uniform: bool = True) -> int:
    """How many blocks of `layout`'s kernel (the one compiled for uniform
    buckets without dither, or the general one) the card holds at once (the
    CUDA occupancy query; whole clusters where the layout has one)."""
    got = ctypes.c_int(0)
    err = lib.fu_hist_resident(layout.n_cls, layout.threads, layout.smem,
                               layout.groups, int(layout.cluster), int(uniform),
                               device, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"fu_hist occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return got.value


@functools.lru_cache(maxsize=64)
def default_plan(n_cls: int, n_buckets: int, window: tuple, n: int,
                 n_scales: int, h_pad: int, w_pad: int, uniform: bool,
                 device: int) -> B1Plan:
    """The wrapper's plan for these shapes on this card (computed once)."""
    layout = b1_layout(n_cls, n_buckets, window)
    return b1_plan(layout, n, n_scales, h_pad, w_pad,
                   resident=resident_blocks(_fu_lib(), layout, device, uniform))


fu_histogram = FuHistogram()
