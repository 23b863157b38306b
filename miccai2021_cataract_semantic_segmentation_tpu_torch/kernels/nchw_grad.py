"""B6 and B8: the bucket-Lovász backward on full-resolution NCHW logit
grids — CUDA kernel wrappers and their plain PyTorch version.

Both compute what the JAX package's `_nchw_grad` (Pallas kernel
`_nchw_bwd_kernel`, losses/fused_lovasz.py:353, two scales: B6) and
`_nchw1_grad` (`_nchw1_bwd_kernel`, :1226, one scale: B8) return, both
through `_degrad_rows` (:307), on the port's layout:

    grids, labels, w_real   as B5/B7 take them (kernels/nchw_hist.py);
    table   (S*C, 2, B) float32 per-bucket gradients [row][bg, fg][bucket],
            already scaled by the cotangent of each row's loss and rounded
            to bf16 (as the TPU kernel rounds its table; the kernel keeps
            it as bf16, rounding to nearest, which leaves such a table as
            it is);

and return one float32 (N, C, H_pad, W_pad) gradient per scale. Per
(pixel, row) they recompute B5/B7's probabilities and bucket ids, gather
de from the table, apply dp = (fg ? -de : de) on counted pixels (0 where
the label is -1 or the lane is at or past w_real) and the softmax VJP.

`nchw_gradient` (B6) and `nchw1_gradient` (B8) run the one CUDA source
csrc/nchw_grad.cu for CUDA tensors and the plain version for CPU tensors;
there is no fallback from one to the other. Each counts its own launches.
The kernel's launch plan (`nchw_grad_layout`, `nchw_grad_plan`) is
computed here, on the host, from the shapes alone.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (
    softmax_vjp_from_fields)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    MAX_CLASSES, SMEM_PER_BLOCK, _ptr, bucket_params, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    _JAX_FILE, _void, check_nchw, nchw_fields, sm_threads)

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


# B6/B8's launch plan. A block of the kernel (csrc/nchw_grad.cu) works on
# one scale and holds, in dynamic shared memory, that scale's table rows as
# bf16 (C x 2 x B entries of 2 bytes) where they fit one block; else it
# gathers from the float32 table in global memory (the C 32 instance).
TILE_PX = 2048     # pixels a tile: whole rows of the padded grid up to 1024 wide


def grad_tile(w_pad: int) -> tuple[int, int]:
    """(tile_h, tile_w_log2) of the default tile: the padded row width
    rounded up to a power of two (32 to 1024 columns), and as many rows as
    make TILE_PX pixels. Whole rows measured 2-3 % faster on the H100 than
    16 x 128 tiles (tools/nchw_grad_ablation.py --sweep): a block's warps
    then read and write one contiguous run of each class plane."""
    log2 = min(max((w_pad - 1).bit_length(), 5), 10)
    return TILE_PX >> log2, log2


def table_fits(n_cls: int, n_buckets: int) -> bool:
    """One scale's bf16 table fits the shared memory a block may opt into."""
    return 4 * n_cls * n_buckets <= SMEM_PER_BLOCK


def instance_maxc(n_cls: int, table_smem: bool = True) -> int:
    """The class-array size of the kernel instance a plan runs (the C
    entry's `pick`): C 17's own, else 8, 16, 24 or 32 with the table in
    shared memory; 32 where it is gathered from global memory."""
    if not table_smem:
        return MAX_CLASSES
    if n_cls == 17:
        return 17
    return next(m for m in (8, 16, 24, 32) if n_cls <= m)


def max_threads(n_cls: int, table_smem: bool = True) -> int:
    """The instance's largest block (its __launch_bounds__): 1024 threads at
    64 registers where a pixel's logits and dp fit (MAXC <= 17), else 512
    at 128."""
    return 1024 if instance_maxc(n_cls, table_smem) <= 17 else 512


@dataclass(frozen=True)
class NchwGradLayout:
    """What one block of a B6/B8 launch holds and walks: the bf16 table of
    its scale's `n_cls` rows in shared memory (`table_smem`), or none; a
    block of `threads` threads walks tiles of tile_h x 2**tile_w_log2
    pixels, one pixel a thread at a time."""
    n_cls: int
    n_buckets: int
    table_smem: bool
    threads: int
    tile_h: int
    tile_w_log2: int

    @property
    def tile_px(self) -> int:
        return self.tile_h << self.tile_w_log2

    @property
    def smem(self) -> int:
        """Dynamic shared memory per block, bytes: the bf16 table, or 0."""
        return 4 * self.n_cls * self.n_buckets if self.table_smem else 0


def nchw_grad_layout(n_cls: int, n_buckets: int, w_pad: int, *,
                     table_smem: bool | None = None, threads: int | None = None,
                     tile_h: int | None = None,
                     tile_w_log2: int | None = None) -> NchwGradLayout:
    """The table in shared memory wherever a scale's rows fit one block (all
    but C > 28 at B 2048 of the sizes the loss uses), else the instance that
    gathers from global memory; blocks of 256, 512 or 1024 threads,
    whichever lets an SM hold the most threads (the larger on a tie: one
    table copy an SM, measured 2-5 % faster than two blocks of 512 at B
    1024); `grad_tile(w_pad)`'s tiles. `table_smem`, `threads` and the tile
    force another layout (the ablation's)."""
    if not 1 <= n_cls <= MAX_CLASSES or n_buckets < 1:
        raise ValueError(f"B6/B8 take 1..{MAX_CLASSES} classes, got C={n_cls}, "
                         f"B={n_buckets}")
    fits = table_fits(n_cls, n_buckets)
    if table_smem is None:
        table_smem = fits
    if table_smem and not fits:
        raise ValueError(f"a bf16 table of {n_cls} rows at B={n_buckets} does not "
                         "fit one block")
    default_h, default_log2 = grad_tile(w_pad)
    tile_h = default_h if tile_h is None else tile_h
    tile_w_log2 = default_log2 if tile_w_log2 is None else tile_w_log2
    top = max_threads(n_cls, table_smem)
    if threads is None:
        regs = 64 if top == 1024 else 128
        smem = NchwGradLayout(n_cls, n_buckets, table_smem, top, tile_h, tile_w_log2).smem
        sizes = [t for t in (256, 512, 1024) if t <= top]
        threads = max(sizes, key=lambda t: (sm_threads(t, smem, regs), t))
    if not 32 <= threads <= top or threads % 32:
        raise ValueError(f"{threads} threads: this instance takes 32..{top}, "
                         "a multiple of 32")
    if not 5 <= tile_w_log2 <= 12 or tile_h < 1:
        raise ValueError("a tile row holds 32 to 4096 pixels, a whole number of warps")
    return NchwGradLayout(n_cls, n_buckets, table_smem, threads, tile_h, tile_w_log2)


@dataclass(frozen=True)
class NchwGradPlan:
    """A B6/B8 launch: `layout` on a grid of (ctas_x, n_scales) blocks.
    Block x of scale s walks tiles x, x + ctas_x, ... of the scale's
    n * tiles_h * tiles_w tiles, which cover the whole padded grid (every
    gradient element is written)."""
    layout: NchwGradLayout
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
        return -(-self.w_pad >> self.layout.tile_w_log2)

    @property
    def n_tiles(self) -> int:
        return self.n * self.tiles_h * self.tiles_w

    def block_tiles(self, block: int) -> range:
        return range(block, self.n_tiles, self.ctas_x)


def nchw_grad_plan(layout: NchwGradLayout, n: int, n_scales: int, h_pad: int,
                   w_pad: int, w_real: int, *, resident: int) -> NchwGradPlan:
    """One wave of the `resident` blocks the card holds, split over the
    scales; never more blocks than tiles."""
    if not 1 <= w_real <= w_pad:
        raise ValueError(f"w_real {w_real} outside 1..{w_pad}")
    tiles = n * -(-h_pad // layout.tile_h) * -(-w_pad >> layout.tile_w_log2)
    return NchwGradPlan(layout, n, n_scales, h_pad, w_pad, w_real,
                        min(max(resident // n_scales, 1), tiles))


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
        plan = default_plan(n_cls, n_buckets, n, self.n_scales, h_pad, w_pad, w_real,
                            edges == "uniform", bids is not None, labels.device.index)
        outs = run_plan(_grad_lib(), plan, grids, labels, table, bids, edges=edges)
        self.launches += 1
        return outs


def run_plan(lib, plan: NchwGradPlan, grids, labels, table, bids=None, *,
             edges: str) -> list[torch.Tensor]:
    """Launch `lib`'s B6/B8 (the committed library, or an edited build of
    the same source) with `plan` on checked CUDA tensors; the gradients
    (and the bucket ids into `bids`, where given)."""
    outs = [torch.empty_like(g) for g in grids]
    two = plan.n_scales == 2
    err = lib.nchw_grad_bwd(
        _ptr(grids[0]), _void(grids[1] if two else None), _ptr(labels), _ptr(table),
        _ptr(outs[0]), _void(outs[1] if two else None), _void(bids),
        *plan_args(plan, edges), labels.device.index, stream_ptr(labels.device))
    if err != 0:
        raise RuntimeError(f"nchw_grad launch failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return outs


@functools.lru_cache(maxsize=64)
def plan_args(plan: NchwGradPlan, edges: str) -> tuple:
    """The C entry's arguments from n to smem: the shapes, the bucket map
    and the plan (computed once per plan)."""
    layout = plan.layout
    half, shift, q0, e_min, _, _ = bucket_params(layout.n_buckets, edges, 0)
    return (plan.n, plan.n_scales, layout.n_cls, plan.h_pad, plan.w_pad, plan.w_real,
            layout.n_buckets, int(edges != "uniform"), half, shift, q0, e_min,
            layout.tile_h, layout.tile_w_log2, int(layout.table_smem), plan.ctas_x,
            layout.threads, layout.smem)


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B6/B8's two C entries on `lib` (built from csrc/nchw_grad.cu)."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nchw_grad_bwd.argtypes = [vp] * 7 + [i] * 11 + [f] + [i] * 7 + [vp]
    lib.nchw_grad_bwd.restype = ctypes.c_int
    lib.nchw_grad_resident.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.nchw_grad_resident.restype = ctypes.c_int
    return lib


def _grad_lib() -> ctypes.CDLL:
    lib = build.load("nchw_grad")
    if lib.nchw_grad_bwd.argtypes is None:
        set_argtypes(lib)
    return lib


def resident_blocks(lib, layout: NchwGradLayout, device: int, uniform: bool = True,
                    bids: bool = False) -> int:
    """How many blocks of `layout`'s kernel (the instance for uniform
    buckets or the general one, with or without the bucket-id output) the
    card holds at once (the CUDA occupancy query)."""
    got = ctypes.c_int(0)
    err = lib.nchw_grad_resident(layout.n_cls, layout.threads, layout.smem, int(uniform),
                                 int(layout.table_smem), int(bids), device,
                                 ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"nchw_grad occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return got.value


@functools.lru_cache(maxsize=64)
def default_plan(n_cls: int, n_buckets: int, n: int, n_scales: int, h_pad: int,
                 w_pad: int, w_real: int, uniform: bool, bids: bool,
                 device: int) -> NchwGradPlan:
    """The wrapper's plan for these shapes on this card (computed once)."""
    layout = nchw_grad_layout(n_cls, n_buckets, w_pad)
    return nchw_grad_plan(layout, n, n_scales, h_pad, w_pad, w_real,
                          resident=resident_blocks(_grad_lib(), layout, device,
                                                   uniform, bids))


nchw_gradient = NchwGrad(2, "nchw_grad", f"{_JAX_FILE}:353")
nchw1_gradient = NchwGrad(1, "nchw1_grad", f"{_JAX_FILE}:1226")
