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
The kernel's launch plan (`nchw_layout`, `nchw_plan`) is computed here, on
the host, from the shapes alone.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    COUNT_MAX, MAX_CLASSES, REGS_PER_SM, SMEM_PER_BLOCK, SMEM_PER_SM,
    SPARE_WORDS, _ptr, bucket_params, count_fields, stream_ptr)
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


# B5/B7's launch plan. A block of the kernel (csrc/nchw_hist.cu) holds, in
# dynamic shared memory, its class rows as int32 counters (2B words a row)
# where they fit one block, else as 16-bit counters two to a 32-bit word (B
# words a row), and one spare word per lane.
TILE_H = 16        # tiles of 16 rows x 128 columns: 2048 pixels
TILE_W_LOG2 = 7    # columns of a tile, as a power of two
MAX_GROUPS = 8
INT32_MAX = 0x7FFFFFFF   # an int32 counter: the most a table bin may receive


def instance_maxc(n_cls: int, groups: int = 1, uniform: bool = True) -> int:
    """The class-array size of the kernel instance a plan runs (the C
    entry's `pick`): C 17's own, else 8, 16, 24 or 32; 32 where the rows
    are split over blocks, except at C 17 with uniform buckets."""
    if groups > 1:
        return 17 if n_cls == 17 and uniform else 32
    if n_cls == 17:
        return 17
    return next(m for m in (8, 16, 24, 32) if n_cls <= m)


def max_threads(n_cls: int, groups: int = 1, uniform: bool = True) -> int:
    """The instance's largest block (its __launch_bounds__): 1024 threads at
    64 registers where a pixel's logits fit (MAXC <= 17), else 512 at 128."""
    return 1024 if instance_maxc(n_cls, groups, uniform) <= 17 else 512


@dataclass(frozen=True)
class NchwLayout:
    """What one block of a B5/B7 launch holds. `groups` blocks share a
    scale's `n_cls` rows, `rows_per` each (the last may hold fewer), and
    each computes every pixel of its stream (1: one block holds all rows,
    and each pixel's softmax is computed once per scale). `packed`: 16-bit
    counters two to a word, else int32. A block of `threads` threads walks
    tiles of tile_h x 2**tile_w_log2 pixels, one pixel a thread at a time."""
    n_cls: int
    n_buckets: int
    groups: int
    rows_per: int
    packed: bool
    threads: int
    tile_h: int
    tile_w_log2: int

    @property
    def softmax_passes(self) -> int:
        """How many times the grid computes each pixel's softmax per scale."""
        return self.groups

    @property
    def tile_px(self) -> int:
        return self.tile_h << self.tile_w_log2

    @property
    def table_words(self) -> int:
        return self.rows_per * self.n_buckets * (1 if self.packed else 2)

    @property
    def smem(self) -> int:
        """Dynamic shared memory per block, bytes: the table and the spare
        words."""
        return 4 * (self.table_words + SPARE_WORDS)


def sm_threads(threads: int, smem: int, regs: int) -> int:
    """The threads an SM holds of blocks of `threads` threads and `smem`
    bytes at `regs` registers a thread."""
    by_smem = SMEM_PER_SM // (smem + 1024)
    return min(by_smem, REGS_PER_SM // regs // threads) * threads


def nchw_layout(n_cls: int, n_buckets: int, *, uniform: bool = True,
                packed: bool | None = None, groups: int | None = None,
                threads: int | None = None, tile_h: int = TILE_H,
                tile_w_log2: int = TILE_W_LOG2) -> NchwLayout:
    """int32 counters where a scale's rows fit one block with them, else
    16-bit ones (measured on the H100: int32 is 12-15 % faster where it
    fits); the fewest row groups whose share of the rows fits one block
    (one up to C 28 at B 2048); blocks of 256, 512 or 1024 threads,
    whichever lets an SM hold the most threads (the smaller on a tie);
    tiles of TILE_H rows x 128 columns. `uniform`: the bucket map (it picks
    the instance). `packed`, `groups`, `threads` and the tile force another
    layout (the ablation's)."""
    if not 1 <= n_cls <= MAX_CLASSES or n_buckets < 1:
        raise ValueError(f"B5/B7 take 1..{MAX_CLASSES} classes, got C={n_cls}, "
                         f"B={n_buckets}")

    def make(g, pk, t=256):
        return NchwLayout(n_cls, n_buckets, g, -(-n_cls // g), pk, t, tile_h,
                          tile_w_log2)

    if packed is None:
        packed = make(groups or 1, False).smem > SMEM_PER_BLOCK
    if groups is None:
        groups = next((g for g in range(1, MAX_GROUPS + 1)
                       if make(g, packed).smem <= SMEM_PER_BLOCK), None)
        if groups is None:
            raise ValueError(f"B={n_buckets} buckets of {n_cls} classes do not "
                             f"fit {MAX_GROUPS} blocks")
    if not 1 <= groups <= MAX_GROUPS or make(groups, packed).smem > SMEM_PER_BLOCK:
        raise ValueError(f"{groups} groups of {n_cls} rows at B={n_buckets} "
                         "do not fit")
    top = max_threads(n_cls, groups, uniform)
    if threads is None:
        regs = 64 if top == 1024 else 128
        sizes = [t for t in (256, 512, 1024) if t <= top]
        smem = make(groups, packed).smem
        threads = max(sizes, key=lambda t: (sm_threads(t, smem, regs), -t))
    if not 32 <= threads <= top or threads % 32:
        raise ValueError(f"{threads} threads: this instance takes 32..{top}, "
                         "a multiple of 32")
    if not 5 <= tile_w_log2 <= 12 or tile_h < 1:
        raise ValueError("a tile row holds 32 to 4096 pixels, a whole number of warps")
    return make(groups, packed, threads)


@dataclass(frozen=True)
class NchwPlan:
    """A B5/B7 launch: `layout` on a grid of (ctas_x, n_scales) blocks.
    Block x of scale s walks, for row group x % groups, the tiles of pixel
    stream x // groups: j, j + streams, ... of the scale's n * tiles_h *
    tiles_w tiles (tiles up to w_real: columns past it never count)."""
    layout: NchwLayout
    n: int
    n_scales: int
    h_pad: int
    w_pad: int
    w_real: int
    ctas_x: int

    @property
    def tiles_h(self) -> int:
        return -(-self.h_pad // self.layout.tile_h)

    @property
    def tiles_w(self) -> int:
        return -(-self.w_real >> self.layout.tile_w_log2)

    @property
    def n_tiles(self) -> int:
        return self.n * self.tiles_h * self.tiles_w

    @property
    def streams(self) -> int:
        return self.ctas_x // self.layout.groups

    def stream_tiles(self, stream: int) -> range:
        return range(stream, self.n_tiles, self.streams)

    @property
    def table_pixels(self) -> int:
        """The most pixels whose counts one block's table receives."""
        return -(-self.n_tiles // self.streams) * self.layout.tile_px


def nchw_plan(layout: NchwLayout, n: int, n_scales: int, h_pad: int, w_pad: int,
              w_real: int, *, resident: int) -> NchwPlan:
    """One wave of the `resident` blocks the card holds, split over the
    scales and row groups; where a table would then receive more pixels
    than its counters hold (COUNT_MAX in a 16-bit table, INT32_MAX in an
    int32 one), as many whole waves as that takes; never more streams than
    tiles."""
    g = layout.groups
    if not 1 <= w_real <= w_pad:
        raise ValueError(f"w_real {w_real} outside 1..{w_pad}")
    tiles = n * -(-h_pad // layout.tile_h) * -(-w_real >> layout.tile_w_log2)
    cap = (COUNT_MAX if layout.packed else INT32_MAX) // layout.tile_px
    if cap < 1:
        raise ValueError("a tile is larger than the counters can count")
    wave = max(resident // n_scales // g, 1)
    waves = -(-tiles // (cap * wave))
    streams = min(waves * wave, tiles)
    return NchwPlan(layout, n, n_scales, h_pad, w_pad, w_real, streams * g)


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
        plan = default_plan(n_cls, n_buckets, n, self.n_scales, h_pad, w_pad, w_real,
                            edges == "uniform", labels.device.index)
        out = run_plan(_hist_lib(), plan, grids, labels, edges=edges)
        self.launches += 1
        return out


def run_plan(lib, plan: NchwPlan, grids, labels, *, edges: str) -> torch.Tensor:
    """Launch `lib`'s B5/B7 (the committed library, or an edited build of
    the same source) with `plan` on checked CUDA tensors; the int32
    counts."""
    layout = plan.layout
    out = torch.zeros((plan.n_scales * layout.n_cls, 2, layout.n_buckets),
                      dtype=torch.int32, device=labels.device)
    err = lib.nchw_hist_fwd(
        _ptr(grids[0]), _void(grids[1] if plan.n_scales == 2 else None), _ptr(labels),
        _ptr(out), *plan_args(plan, edges), labels.device.index, stream_ptr(labels.device))
    if err != 0:
        raise RuntimeError(f"nchw_hist launch failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return out


@functools.lru_cache(maxsize=64)
def plan_args(plan: NchwPlan, edges: str) -> tuple:
    """The C entry's arguments from n to smem: the shapes, the bucket map
    and the plan (computed once per plan)."""
    layout = plan.layout
    half, shift, q0, e_min, _, _ = bucket_params(layout.n_buckets, edges, 0)
    return (plan.n, plan.n_scales, layout.n_cls, plan.h_pad, plan.w_pad, plan.w_real,
            layout.n_buckets, int(edges != "uniform"), half, shift, q0, e_min,
            layout.tile_h, layout.tile_w_log2, layout.groups, layout.rows_per,
            int(layout.packed), plan.ctas_x, layout.threads, layout.smem)


def _void(t) -> ctypes.c_void_p:
    """A tensor's pointer, or NULL for None (the absent second scale)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B5/B7's two C entries on `lib` (built from csrc/nchw_hist.cu)."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nchw_hist_fwd.argtypes = [vp] * 4 + [i] * 11 + [f] + [i] * 9 + [vp]
    lib.nchw_hist_fwd.restype = ctypes.c_int
    lib.nchw_hist_resident.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.nchw_hist_resident.restype = ctypes.c_int
    return lib


def _hist_lib() -> ctypes.CDLL:
    lib = build.load("nchw_hist")
    if lib.nchw_hist_fwd.argtypes is None:
        set_argtypes(lib)
    return lib


def resident_blocks(lib, layout: NchwLayout, device: int, uniform: bool = True) -> int:
    """How many blocks of `layout`'s kernel (the one compiled for uniform
    buckets, or the general one) the card holds at once (the CUDA occupancy
    query)."""
    got = ctypes.c_int(0)
    err = lib.nchw_hist_resident(layout.n_cls, layout.threads, layout.smem,
                                 layout.groups, int(uniform), int(layout.packed),
                                 device, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"nchw_hist occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return got.value


@functools.lru_cache(maxsize=64)
def default_plan(n_cls: int, n_buckets: int, n: int, n_scales: int, h_pad: int,
                 w_pad: int, w_real: int, uniform: bool, device: int) -> NchwPlan:
    """The wrapper's plan for these shapes on this card (computed once)."""
    layout = nchw_layout(n_cls, n_buckets, uniform=uniform)
    return nchw_plan(layout, n, n_scales, h_pad, w_pad, w_real,
                     resident=resident_blocks(_hist_lib(), layout, device, uniform))


nchw_histogram = NchwHistogram(2, "nchw_hist", f"{_JAX_FILE}:169")
nchw1_histogram = NchwHistogram(1, "nchw1_hist", f"{_JAX_FILE}:1119")
