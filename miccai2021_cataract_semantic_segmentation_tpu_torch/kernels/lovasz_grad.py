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
Its `launches` counts kernel launches. The kernel's launch plan (`b2_layout`,
`b2_plan`) is computed here.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    MAX_CLASSES, SMEM_PER_BLOCK, SMEM_PER_SM, STATIC_SMEM, FuMats, _check, _ptr,
    bucket_params, max_threads, plain_fields, stream_ptr)


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


# B2's launch plan. A block of the kernel (csrc/fu_grad.cu) holds, in
# dynamic shared memory: the bf16 table of its scale's class rows (where it
# fits), dz of one output row of a column chunk (C x chunk_px float32, a
# class's row chunk_px rounded up to 32 plus one word), two running sums per (class,
# source column) of the chunk, the chunk's width-tap coefficients (max_taps
# per source column) with each column's first output column and tap count,
# and a window of two source rows of logits (win_w columns, the classes
# padded to 4) at a 16-byte boundary. `Layout` in the source computes the
# same offsets and refuses any other size.
MIN_LANE_USE = 0.75   # a chunk must keep this share of the pixel phase's lanes busy


@dataclass(frozen=True)
class B2Layout:
    """What one block of a B2 launch holds. The source columns go in
    n_chunks chunks of chunk_s (the last may be narrower), each read by at
    most chunk_px output columns and staged as at most win_w source
    columns."""
    n_cls: int
    n_buckets: int
    threads: int
    chunk_s: int
    n_chunks: int
    chunk_px: int
    max_taps: int
    win_w: int
    table_smem: bool
    per_sm: int = 1          # blocks an SM holds (shared memory and registers)

    @property
    def dz_stride(self) -> int:
        return -(-self.chunk_px // 32) * 32 + 1

    @property
    def words(self) -> int:
        """32-bit words of dynamic shared memory (the source's `layout`)."""
        c, s = self.n_cls, self.chunk_s
        off = c * self.n_buckets if self.table_smem else 0
        off += c * self.dz_stride + 2 * c * s + self.max_taps * s + 2 * s
        off = -(-off // 4) * 4
        return off + 2 * self.win_w * (-(-c // 4) * 4)

    @property
    def smem(self) -> int:
        return 4 * self.words


def chunk_geometry(columns: tuple, n_chunks: int):
    """(chunk_s, [(x_a, x_b, c_a, c_b) per chunk]): the output columns
    [x_a, x_b) whose taps reach each chunk of chunk_s source columns, and
    the source columns [c_a, c_b) those output columns read."""
    ws = len(columns)
    chunk_s = -(-ws // n_chunks)
    out = []
    for s_a in range(0, ws, chunk_s):
        hit = [col for col in columns[s_a:s_a + chunk_s] if col[1] > col[0]]
        if not hit:
            out.append((0, 0, 0, 0))
            continue
        c_b = min(hit[-1][3] + 1, ws - 1) + 1
        out.append((hit[0][0], hit[-1][1], hit[0][2], c_b))
    return chunk_s, out


def smem_budget(per_sm: int) -> int:
    """The dynamic shared memory a block may take when `per_sm` blocks
    share an SM (1 KB of the SM's reserved per block)."""
    return min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - 1024) - STATIC_SMEM


def b2_layout(n_cls: int, n_buckets: int, columns: tuple, *,
              threads: int | None = None, per_sm: int | None = None,
              table_smem: bool | None = None, chunks: int | None = None) -> B2Layout:
    """The first layout that fits the shared memory of `per_sm` blocks an
    SM (by default one block of the instance's most threads: 1024 up to 17
    classes, else 512), the table in shared memory before global memory,
    then the fewest column chunks that still keep MIN_LANE_USE of the pixel
    phase's lanes busy. `threads`, `per_sm`, `table_smem` and `chunks`
    force a choice (the ablation's)."""
    if not 1 <= n_cls <= MAX_CLASSES or n_buckets < 1 or not columns:
        raise ValueError(f"B2 takes 1..{MAX_CLASSES} classes, got C={n_cls}, "
                         f"B={n_buckets}, {len(columns)} source columns")
    ws = len(columns)
    max_taps = max(col[1] - col[0] for col in columns)
    tables = (True, False) if table_smem is None else (table_smem,)
    t, k = threads or max_threads(n_cls), per_sm or 1
    if t % 32 or not 32 <= t * k <= max_threads(n_cls):
        raise ValueError(f"{t} threads x {k} blocks: the C={n_cls} kernel holds "
                         f"32..{max_threads(n_cls)} threads an SM, a multiple of 32")
    for tbl in tables:
        for nch in (range(1, ws + 1) if chunks is None else (chunks,)):
            chunk_s, geo = chunk_geometry(columns, nch)
            chunk_px = max(max(g[1] - g[0] for g in geo), 1)
            if chunks is None and nch > 1:
                if chunk_px < MIN_LANE_USE * t:  # narrower chunks idle more lanes
                    break
                if chunk_px / (t * -(-chunk_px // t)) < MIN_LANE_USE:
                    continue
            win = max(max(g[3] - g[2] for g in geo), 1)
            layout = B2Layout(n_cls, n_buckets, t, chunk_s, -(-ws // chunk_s), chunk_px,
                              max_taps, win, tbl, k)
            if layout.smem <= smem_budget(k):
                return layout
    raise ValueError(f"no B2 layout fits C={n_cls}, B={n_buckets}, ws={ws} (threads "
                     f"{threads}, per_sm {per_sm}, table_smem {table_smem}, chunks {chunks})")


@dataclass(frozen=True)
class B2Plan:
    """A B2 launch: `layout` on a grid of (blocks, n_scales). Block b of a
    scale owns source rows [n*hs*b // blocks, n*hs*(b+1) // blocks) of the
    scale's n * hs, in image-major order (`share`). The edge buffer holds,
    per boundary, the block above's partial sum of the boundary row and up
    to `max_run` terms of it from the block below."""
    layout: B2Layout
    n: int
    n_scales: int
    hs: int
    blocks: int
    max_run: int = 0

    @property
    def edge_floats(self) -> int:
        """The edge buffer's float32 elements (the chunks' columns cover
        ws)."""
        layout = self.layout
        return self.n_scales * self.blocks * (1 + self.max_run) * layout.n_cls * layout.chunk_s \
            * layout.n_chunks

    def share(self, b: int) -> range:
        total = self.n * self.hs
        return range(total * b // self.blocks, total * (b + 1) // self.blocks)

    def pieces(self, b: int):
        """(image, h0, h1, first, last) of block b's share, split where an
        image ends (the kernel's walk)."""
        rows = self.share(b)
        r = rows.start
        while r < rows.stop:
            img, h0 = divmod(r, self.hs)
            h1 = min(self.hs, h0 + rows.stop - r)
            yield img, h0, h1, r == rows.start, r + h1 - h0 == rows.stop
            r += h1 - h0


def b2_plan(layout: B2Layout, n: int, n_scales: int, hs: int, *,
            resident: int, max_run: int = 0) -> B2Plan:
    """One wave: the `resident` blocks the card holds split over the
    scales, never more blocks than a scale has source rows; `max_run` is
    the taps' `FuMats.row_run`."""
    blocks = min(max(resident // n_scales, 1), n * hs)
    return B2Plan(layout, n, n_scales, hs, blocks, max_run)


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
        for checking them against B1's counts on the card. Pad rows and
        columns, which the kernel never visits, stay -1."""
        n, r_rows = ls.shape[:2]
        bids = torch.full((n, r_rows, *labels.shape[1:]), -1, dtype=torch.int32,
                          device=ls.device)
        return self._launch(ls, labels, mats, table, bids, **kwargs), bids

    def _launch(self, ls, labels, mats, table, bids, *, n_cls, n_buckets,
                edges, seed, dither):
        if ls.device.type != "cuda":
            raise ValueError(f"the B2 kernel takes CUDA tensors, got {ls.device}")
        _check(ls, labels, mats, n_cls)
        n, r_rows, hs, _ = ls.shape
        if (table.device != ls.device or table.dtype != torch.float32
                or not table.is_contiguous()
                or tuple(table.shape) != (r_rows, 2, n_buckets)):
            raise ValueError(f"table must be a contiguous float32 "
                             f"({r_rows}, 2, {n_buckets}) tensor on {ls.device}")
        plan = default_plan(n_cls, n_buckets, mats.columns, n, r_rows // n_cls, hs,
                            edges == "uniform" and not dither, ls.device.index, mats.row_run)
        out = run_plan(_grad_lib(), plan, ls, labels, mats, table, bids,
                       n_cls=n_cls, n_buckets=n_buckets, edges=edges, seed=seed,
                       dither=dither)
        self.launches += 1
        return out


def run_plan(lib, plan: B2Plan, ls, labels, mats, table, bids, *, n_cls,
             n_buckets, edges, seed, dither) -> torch.Tensor:
    """Launch `lib`'s B2 (the committed library, or an edited build of the
    same source) with `plan` on checked CUDA tensors; the gradient."""
    n, r_rows, hs, ws = ls.shape
    layout = plan.layout
    if plan.max_run < mats.row_run:
        raise ValueError("the plan's edge buffer does not fit these taps")
    out = torch.empty((n, r_rows, hs, ws), dtype=torch.float32, device=ls.device)
    edge = torch.empty(plan.edge_floats, dtype=torch.float32, device=ls.device)
    arrive = torch.zeros(plan.n_scales * plan.blocks, dtype=torch.int32, device=ls.device)
    half, shift, q0, e_min, seed32, inv_b = bucket_params(n_buckets, edges, seed)
    err = lib.fu_grad_bwd(
        _ptr(ls), _ptr(labels), _ptr(mats.h_lo), _ptr(mats.h_w0), _ptr(mats.h_w1),
        _ptr(mats.h_beg), _ptr(mats.h_end), _ptr(mats.w_lo), _ptr(mats.w_w0),
        _ptr(mats.w_w1), _ptr(mats.w_beg), _ptr(mats.w_end), _ptr(table), _ptr(out),
        None if bids is None else _ptr(bids), _ptr(edge), _ptr(arrive), n, r_rows // n_cls,
        n_cls, hs, ws, *labels.shape[1:], n_buckets, int(edges != "uniform"), half, shift,
        q0, e_min, int(dither), seed32, inv_b, layout.threads, plan.blocks, layout.chunk_s,
        layout.chunk_px, layout.max_taps, layout.win_w, int(layout.table_smem),
        plan.max_run, layout.smem, ls.device.index, stream_ptr(ls.device))
    if err != 0:
        raise RuntimeError(f"fu_grad launch failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return out


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B2's two C entries on `lib` (built from csrc/fu_grad.cu)."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fu_grad_bwd.argtypes = [vp] * 17 + [i] * 12 + [f, i, i, f] + [i] * 10 + [vp]
    lib.fu_grad_bwd.restype = ctypes.c_int
    lib.fu_grad_resident.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.fu_grad_resident.restype = ctypes.c_int
    return lib


def _grad_lib() -> ctypes.CDLL:
    lib = build.load("fu_grad")
    if lib.fu_grad_bwd.argtypes is None:
        set_argtypes(lib)
    return lib


def resident_blocks(lib, layout: B2Layout, device: int, uniform: bool = True) -> int:
    """How many blocks of `layout`'s kernel (the instance for uniform buckets
    without dither, or the general one) the card holds at once."""
    got = ctypes.c_int(0)
    err = lib.fu_grad_resident(layout.n_cls, layout.threads, layout.smem,
                               int(uniform), device, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"fu_grad occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return got.value


@functools.lru_cache(maxsize=64)
def default_plan(n_cls: int, n_buckets: int, columns: tuple, n: int, n_scales: int,
                 hs: int, uniform: bool, device: int, max_run: int) -> B2Plan:
    """The wrapper's plan for these shapes on this card (computed once)."""
    layout = b2_layout(n_cls, n_buckets, columns)
    return b2_plan(layout, n, n_scales, hs, max_run=max_run,
                   resident=resident_blocks(_grad_lib(), layout, device, uniform))


fu_grad = FuGrad()
