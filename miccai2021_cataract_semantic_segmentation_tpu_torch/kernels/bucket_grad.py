"""B4 and B4f: the generic bucket-Lovász backward — CUDA kernel wrappers,
their launch plans and their plain PyTorch versions.

B4, the gather, computes what the JAX package's `_bucket_grad` returns
(Pallas kernel `_grad_kernel`, losses/bucket_lovasz.py:152) from

    errors_t  (R, P) float32 errors and fg_t (R, P) bool flags, as B3 takes
              them;
    table     (R, 2, 2048) float32 per-bucket gradients [row][bg, fg]
              [bucket], scaled by the cotangent of each row's loss
              (`losses/bucket_lovasz.py:grad_table` rounds it to bf16);

and returns the float32 (R, P) gradient table[row][fg][bucket(e)], with B3's
bucket id and 0 where that id is negative, the table read as bf16 as the
TPU kernel reads it. It is a gather, so the kernel equals its plain version
bit for bit.

B4f computes d loss / d logits of the generic route in one pass, B4 and the
VJP of the error construction (softmax, |fg - p|, the transpose; the JAX
package leaves it to XLA, losses/functional.py:152-156) together, from the
errors and flags the forward saved, the table and the (N, C, H, W) logits:

    dp_c = e > 0 ? (fg ? -dE : dE) : 0,   dE = B4's gather of (e, fg)
    dz_c = p_c * (dp_c - sum_k p_k dp_k),  p = softmax_c(float32(logits))

(the sums over the classes in ascending order, in both versions), written
in the logits' layout and type. Rows are the C classes over all
N·H·W pixels, or with `per_image` the N·C (image, class) pairs over each
image's H·W pixels, as `losses/functional.py:lovasz_rows` builds them.

`bucket_gather` (B4) and `bucket_dlogits` (B4f) run the one CUDA source
csrc/bucket_grad.cu for CUDA tensors and their plain versions for CPU
tensors; there is no fallback from one to the other. Each counts its own
launches. Their launch plans (`b4_plan`, `b4f_layout`, `b4f_plan`) are
computed here, on the host, from the shapes alone.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    N_BUCKETS, _check, bucket_ids)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    MAX_CLASSES, _ptr, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import sm_threads

SOURCE = ("miccai2021_cataract_semantic_segmentation_tpu_torch/kernels/"
          "csrc/bucket_grad.cu")
_JAX = "miccai2021_cataract_semantic_segmentation_tpu/losses/"


def bucket_gather_plain(errors_t: torch.Tensor, fg_t: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch B4: one indexed read of the flattened table, as bf16."""
    bid = bucket_ids(errors_t)
    row = torch.arange(errors_t.shape[0], device=errors_t.device)[:, None]
    idx = (row * 2 + fg_t.long()) * N_BUCKETS + bid.clamp_min(0)
    flat = table.reshape(-1).to(torch.bfloat16).to(torch.float32)
    return torch.where(bid >= 0, flat[idx], 0.0)


def bucket_dlogits_plain(errors_t: torch.Tensor, fg_t: torch.Tensor,
                         table: torch.Tensor, logits: torch.Tensor,
                         per_image: bool = False) -> torch.Tensor:
    """Plain PyTorch B4f: the softmax, `bucket_gather_plain` and the softmax
    VJP in float32, cast to the logits' type. The softmax and the VJP's sum
    take the kernel's order (p = exp(z - max) / sum, both sums over the
    classes in ascending order), so that the kernel's float32 result is its
    own and a bf16 one differs by no more than its rounding: where a
    pixel's terms cancel, another order moves the float32 result by an ulp
    of the terms, many bf16 ulps of the result."""
    n, c, h, w = logits.shape
    z = logits.to(torch.float32)
    ez = torch.exp(z - z.amax(dim=1, keepdim=True))
    total = torch.zeros_like(ez[:, 0])
    for k in range(c):
        total = total + ez[:, k]
    p = ez / total[:, None]
    de = bucket_gather_plain(errors_t, fg_t, table)
    dp = torch.where(errors_t > 0, torch.where(fg_t, -de, de), 0.0)
    dp = dp.reshape(n, c, h, w) if per_image else dp.reshape(c, n, h, w).transpose(0, 1)
    s = torch.zeros_like(total)
    for k in range(c):
        s = s + dp[:, k] * p[:, k]
    return (p * (dp - s[:, None])).to(logits.dtype)


# ---------------------------------------------------------------------------
# B4's launch plan
# ---------------------------------------------------------------------------

GATHER_THREADS = 256


@dataclass(frozen=True)
class B4Plan:
    """B4's grid: `per_row` blocks of `threads` over every row, each taking
    `chunk` float4 vectors of the row's aligned body (a multiple of 32, so
    a warp's vectors start 512 bytes apart), kGatherVecs a thread at a time;
    block 0 also takes the row's head, the last block its tail. A row on
    the scalar path is cut into the same blocks at 4 * chunk pixels."""
    per_row: int
    chunk: int
    threads: int


def b4_plan(rows: int, p: int, resident: int, threads: int = GATHER_THREADS,
            per_row: int | None = None) -> B4Plan:
    """One wave of `resident` blocks spread over the rows (or `per_row`
    blocks a row where given), never fewer blocks than a row needs."""
    n_vec = -(-p // 4)
    want = per_row or max(1, resident // rows)
    chunk = -(-max(-(-n_vec // want), 1) // 32) * 32
    return B4Plan(per_row=-(-n_vec // chunk), chunk=chunk, threads=threads)


# ---------------------------------------------------------------------------
# B4f's launch plan
# ---------------------------------------------------------------------------

FUSED_TILE_PX = 2048       # pixels of one image a tile
SMEM_CLASSES = 25          # the most classes whose bf16 tables a block holds


def fused_instance_maxc(n_cls: int, table_smem: bool = True) -> int:
    """The class-array size of the B4f instance a plan runs (the C entry's
    `pick`): C 17's own, else 8, 16, 24 or 32 with the tables in shared
    memory; 32 where they are gathered from global memory."""
    if not table_smem:
        return MAX_CLASSES
    if n_cls == 17:
        return 17
    return next(m for m in (8, 16, 24, 32) if n_cls <= m)


def fused_max_threads(n_cls: int, table_smem: bool = True) -> int:
    """The instance's largest block (its __launch_bounds__): 1024 threads at
    64 registers where a pixel's probabilities and dp fit (MAXC <= 17), else
    512 at 128."""
    return 1024 if fused_instance_maxc(n_cls, table_smem) <= 17 else 512


@dataclass(frozen=True)
class B4fLayout:
    """What one block of a B4f launch holds and walks: the bf16 tables of
    one image's `n_cls` rows in shared memory (`table_smem`), or none; a
    block of `threads` threads walks tiles of `tile_px` pixels of one
    image, one pixel a thread at a time."""
    n_cls: int
    table_smem: bool
    threads: int
    tile_px: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory per block, bytes: the bf16 tables, or 0."""
        return 2 * 2 * N_BUCKETS * self.n_cls if self.table_smem else 0


def b4f_layout(n_cls: int, *, table_smem: bool | None = None,
               threads: int | None = None, tile_px: int = FUSED_TILE_PX) -> B4fLayout:
    """The tables in shared memory up to SMEM_CLASSES classes (205 KB at C
    25, the largest task's), else the instance that gathers from global
    memory; blocks of 256, 512 or 1024 threads, whichever lets an SM hold
    the most threads (the larger on a tie). `table_smem` and `threads`
    force another layout (the ablation's)."""
    if not 1 <= n_cls <= MAX_CLASSES:
        raise ValueError(f"B4f takes 1..{MAX_CLASSES} classes, got C={n_cls}")
    if table_smem is None:
        table_smem = n_cls <= SMEM_CLASSES
    if table_smem and n_cls > SMEM_CLASSES:
        raise ValueError(f"the tables of {n_cls} rows do not fit one block")
    top = fused_max_threads(n_cls, table_smem)
    if threads is None:
        regs = 64 if top == 1024 else 128
        smem = B4fLayout(n_cls, table_smem, top, tile_px).smem
        threads = max((t for t in (256, 512, 1024) if t <= top),
                      key=lambda t: (sm_threads(t, smem, regs), t))
    if not 32 <= threads <= top or threads % 32:
        raise ValueError(f"{threads} threads: this instance takes 32..{top}, "
                         "a multiple of 32")
    if tile_px < 32 or tile_px % 32:
        raise ValueError(f"a tile holds a whole number of warps, got {tile_px}")
    return B4fLayout(n_cls, table_smem, threads, tile_px)


@dataclass(frozen=True)
class B4fPlan:
    """A B4f launch: `layout` on `ctas` blocks. The pixels are cut into
    segments: the images (per image: each has its own table), else one
    segment of all N images. `per_seg` blocks walk a segment's tiles,
    block x taking tiles x % per_seg, + per_seg, ... of segments x //
    per_seg, + ctas // per_seg, ...; a tile is tile_px pixels of one image
    (the last of an image shorter), so every gradient element is written
    once."""
    layout: B4fLayout
    n: int
    hw: int
    per_image: bool
    ctas: int
    per_seg: int

    @property
    def tiles_per_img(self) -> int:
        return -(-self.hw // self.layout.tile_px)

    @property
    def n_segs(self) -> int:
        return self.n if self.per_image else 1

    @property
    def seg_tiles(self) -> int:
        return self.tiles_per_img * (1 if self.per_image else self.n)

    def block_work(self, block: int) -> list[tuple[int, int, int]]:
        """(segment, image, first pixel of the image) of each tile the block
        walks, in its order."""
        slots = self.ctas // self.per_seg
        out = []
        for seg in range(block // self.per_seg, self.n_segs, slots):
            for t in range(block % self.per_seg, self.seg_tiles, self.per_seg):
                img = seg if self.per_image else t // self.tiles_per_img
                first = (t - (0 if self.per_image else img * self.tiles_per_img))
                out.append((seg, img, first * self.layout.tile_px))
        return out


def b4f_plan(layout: B4fLayout, n: int, hw: int, per_image: bool, *, resident: int,
             per_seg: int | None = None) -> B4fPlan:
    """One wave of at most `resident` blocks. Per image: `per_seg` blocks an
    image (resident // n, at most its tiles, at least 1), each loading its
    image's tables once where the wave holds a block for every image, else
    once per image it walks; otherwise every block on the one table."""
    tiles = -(-hw // layout.tile_px)
    if not per_image:
        ctas = min(max(resident, 1), n * tiles)
        return B4fPlan(layout, n, hw, False, ctas, ctas)
    if per_seg is None:
        per_seg = min(max(resident // n, 1), tiles)
    slots = max(1, min(n, resident // per_seg))
    return B4fPlan(layout, n, hw, True, slots * per_seg, per_seg)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

class BucketGather:
    """The B4 entry: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `launches` counts kernel launches (plain runs do not)."""

    name = "bucket_grad"
    source = SOURCE
    replaces = f"{_JAX}bucket_lovasz.py:152"

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
        _check_table(table, r_rows, errors_t.device)
        lib = _grad_lib()
        out = run_gather_plan(lib, default_gather_plan(r_rows, p, errors_t.device.index),
                              errors_t, fg_t, table)
        self.launches += 1
        return out


class BucketDlogits:
    """The B4f entry: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. `launches` counts kernel launches (plain runs do
    not)."""

    name = "bucket_dlogits"
    source = SOURCE
    replaces = (f"{_JAX}bucket_lovasz.py:152 with the XLA VJP of "
                f"{_JAX}functional.py:152-156")

    def __init__(self):
        self.launches = 0

    def __call__(self, errors_t: torch.Tensor, fg_t: torch.Tensor, table: torch.Tensor,
                 logits: torch.Tensor, *, per_image: bool = False) -> torch.Tensor:
        if logits.device.type == "cpu":
            return bucket_dlogits_plain(errors_t, fg_t, table, logits, per_image)
        return self._launch(errors_t, fg_t, table, logits, per_image)

    def _launch(self, errors_t, fg_t, table, logits, per_image):
        if logits.device.type != "cuda":
            raise ValueError(f"the B4f kernel takes CUDA tensors, got {logits.device}")
        check_fused(errors_t, fg_t, table, logits, per_image)
        n, c, h, w = logits.shape
        plan = default_fused_plan(c, n, h * w, per_image, logits.dtype == torch.bfloat16,
                                  logits.device.index)
        out = run_fused_plan(_grad_lib(), plan, errors_t, fg_t, table, logits)
        self.launches += 1
        return out


def _check_table(table: torch.Tensor, r_rows: int, device) -> None:
    if (table.device != device or table.dtype != torch.float32
            or not table.is_contiguous()
            or tuple(table.shape) != (r_rows, 2, N_BUCKETS)):
        raise ValueError(f"table must be a contiguous float32 ({r_rows}, "
                         f"2, {N_BUCKETS}) tensor on {device}")


def check_fused(errors_t, fg_t, table, logits, per_image: bool) -> None:
    """Raise on what B4f does not take."""
    if logits.dim() != 4 or not logits.is_contiguous():
        raise ValueError(f"logits must be a contiguous (N, C, H, W) tensor, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"B4f takes bf16 or float32 logits, got {logits.dtype}")
    n, c, h, w = logits.shape
    if not 1 <= c <= MAX_CLASSES or n * c * h * w >= 2 ** 31:
        raise ValueError(f"B4f takes 1..{MAX_CLASSES} classes and fewer than 2^31 "
                         f"logits, got {tuple(logits.shape)}")
    _check(errors_t, fg_t)
    rows = (n * c, h * w) if per_image else (c, n * h * w)
    if tuple(errors_t.shape) != rows or errors_t.device != logits.device:
        raise ValueError(f"errors {tuple(errors_t.shape)} on {errors_t.device} do not "
                         f"match logits {tuple(logits.shape)} on {logits.device} "
                         f"(per_image={per_image}: rows {rows})")
    _check_table(table, rows[0], logits.device)


def run_gather_plan(lib, plan: B4Plan, errors_t, fg_t, table) -> torch.Tensor:
    """Launch `lib`'s B4 (the committed library, or an edited build of the
    same source) with `plan` on checked CUDA tensors."""
    r_rows, p = errors_t.shape
    out = torch.empty_like(errors_t)
    err = lib.bucket_grad_bwd(_ptr(errors_t), _ptr(fg_t), _ptr(table), r_rows, p,
                              plan.per_row, plan.chunk, plan.threads, _ptr(out),
                              errors_t.device.index, stream_ptr(errors_t.device))
    if err != 0:
        raise RuntimeError(f"bucket_grad launch failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return out


def run_fused_plan(lib, plan: B4fPlan, errors_t, fg_t, table, logits) -> torch.Tensor:
    """Launch `lib`'s B4f with `plan` on checked CUDA tensors."""
    n, c, h, w = logits.shape
    out = torch.empty_like(logits)
    layout = plan.layout
    err = lib.bucket_dlogits_bwd(
        _ptr(errors_t), _ptr(fg_t), _ptr(table), _ptr(logits), _ptr(out), n, c, h * w,
        int(plan.per_image), int(logits.dtype == torch.bfloat16), layout.tile_px,
        int(layout.table_smem), plan.ctas, plan.per_seg, layout.threads, layout.smem,
        logits.device.index, stream_ptr(logits.device))
    if err != 0:
        raise RuntimeError(f"bucket_dlogits launch failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return out


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B4's and B4f's C entries on `lib` (built from
    csrc/bucket_grad.cu)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bucket_grad_bwd.argtypes = [vp, vp, vp, i, i, i, i, i, vp, i, vp]
    lib.bucket_grad_bwd.restype = i
    lib.bucket_grad_resident.argtypes = [i, i, ctypes.POINTER(i)]
    lib.bucket_grad_resident.restype = i
    lib.bucket_dlogits_bwd.argtypes = [vp] * 5 + [i] * 12 + [vp]
    lib.bucket_dlogits_bwd.restype = i
    lib.bucket_dlogits_resident.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.bucket_dlogits_resident.restype = i
    return lib


def _grad_lib() -> ctypes.CDLL:
    lib = build.load("bucket_grad")
    if lib.bucket_grad_bwd.argtypes is None:
        set_argtypes(lib)
    return lib


def gather_resident(lib, threads: int, device: int) -> int:
    """How many B4 blocks of `threads` the card holds at once."""
    got = ctypes.c_int(0)
    err = lib.bucket_grad_resident(threads, device, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"bucket_grad occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return got.value


def fused_resident(lib, layout: B4fLayout, bf16: bool, device: int) -> int:
    """How many B4f blocks of `layout`'s kernel the card holds at once."""
    got = ctypes.c_int(0)
    err = lib.bucket_dlogits_resident(layout.n_cls, layout.threads, layout.smem,
                                      int(layout.table_smem), int(bf16), device,
                                      ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"bucket_dlogits occupancy query failed: "
                           f"{build.error_string(lib, err)} ({err})")
    return got.value


@functools.lru_cache(maxsize=64)
def default_gather_plan(rows: int, p: int, device: int) -> B4Plan:
    """The B4 wrapper's plan for (rows, p) on this card (computed once)."""
    return b4_plan(rows, p, gather_resident(_grad_lib(), GATHER_THREADS, device))


@functools.lru_cache(maxsize=64)
def default_fused_plan(n_cls: int, n: int, hw: int, per_image: bool, bf16: bool,
                       device: int) -> B4fPlan:
    """The B4f wrapper's plan for these shapes on this card (computed once)."""
    layout = b4f_layout(n_cls)
    return b4f_plan(layout, n, hw, per_image,
                    resident=fused_resident(_grad_lib(), layout, bf16, device))


bucket_gather = BucketGather()
bucket_dlogits = BucketDlogits()
