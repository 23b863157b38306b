"""The spatial 'model' rank axis: a grid of D data ranks by M model ranks,
each model rank holding a contiguous band of every activation's rows.

Port of the JAX package's parallel/mesh.py `make_mesh(("data", "model"))`
and `spatial_sharding` for PyTorch's idiom, one process a rank. A world of
D·M ranks is laid out as the JAX mesh lays devices out,
`np.asarray(ranks).reshape(D, M)`: rank r is data index d = r // M and
model index m = r % M.

- The D data ranks of one m (`Grid.data`) feed the global batch's rows as
  parallel/dist.py:`DataGroup` does; the gradient mean and the loss's mean
  run over them.
- The M model ranks of one d share that data shard's frames, and each
  holds the rows [m·H/M, (m+1)·H/M) of every activation from the trunk's
  input on (`rows`). A convolution or max-pool reads its neighbours' edge
  rows through `exchange_halo` (models/layers.py:`Conv2d`, `MaxPool2d`),
  the OCR head's softmax over all positions sums over the model ranks
  (`model_sum`, `model_max`), and the steps read the stride-8 logits
  whole through `gather_rows`.
- BatchNorm normalises over every rank of the grid (`Grid.norm`): a tensor
  that the model ranks hold alike (the OCR context) is counted M times in
  both its sums and its count, which leaves its statistics exact.

Gradients: each model rank computes its data shard's loss on the gathered
logits; `gather_rows`' backward keeps this rank's rows of the gradient, so
each parameter gradient is summed over the model ranks and averaged over
the data ranks (`mean_grads_`).

Every collective is an all-reduce (a zero-filled slot a rank, summed),
which gloo runs on CPU and CUDA tensors alike and NCCL runs too; NCCL
refuses two ranks on one card, where gloo serves. A (D, 1) grid is the
data-parallel path of parallel/dist.py; a (1, 1) grid is one process.

    grid = Grid.of(init_from_env("cuda"), (D, M))
    step = make_train_step(..., group=grid)        # train/steps.py
    with spatial_rows(model, grid): ...            # the layers' halos
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.dist import (
    DataGroup, SumGrad, World)

ROADMAP_REST = ("the spatial grid covers OCRNet on a ResNet trunk; the rest of "
                "ROADMAP item 18 (HRNet trunks, DeepLab, UPerNet, FCN, PointRend, "
                "UNet, the projector) is not ported")


def _comm_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor travels in: at least float32 (bf16 and f16 round
    trip exactly), float64 stays."""
    return torch.promote_types(dtype, torch.float32) if dtype.is_floating_point else dtype


def _all_reduce(t: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=pg)
    return t


class _Halo(torch.autograd.Function):
    """`top` rows from the rank above and `bottom` rows from the rank
    below on dim 2, `fill` at the image's global top and bottom; the
    backward sends each halo's gradient to the rank that owns its rows."""

    @staticmethod
    def forward(ctx, x, grid, top, bottom, fill):
        ctx.grid, ctx.top, ctx.bottom = grid, top, bottom
        m, n_m, r = grid.m, grid.m_size, x.shape[2]
        slots = x.new_zeros((n_m,) + x.shape[:2] + (top + bottom, x.shape[3]),
                            dtype=_comm_dtype(x.dtype))
        slots[m, :, :, :top] = x[:, :, r - top:]
        slots[m, :, :, top:] = x[:, :, :bottom]
        _all_reduce(slots, grid.model_pg)
        edge = x.shape[:2]
        up = slots[m - 1, :, :, :top].to(x.dtype) if m > 0 else \
            x.new_full(edge + (top, x.shape[3]), fill)
        down = slots[m + 1, :, :, top:].to(x.dtype) if m < n_m - 1 else \
            x.new_full(edge + (bottom, x.shape[3]), fill)
        return torch.cat([up, x, down], dim=2)

    @staticmethod
    def backward(ctx, g):
        grid, top, bottom = ctx.grid, ctx.top, ctx.bottom
        m, n_m = grid.m, grid.m_size
        r = g.shape[2] - top - bottom
        slots = g.new_zeros((n_m,) + g.shape[:2] + (top + bottom, g.shape[3]),
                            dtype=_comm_dtype(g.dtype))
        if m > 0:                   # the rows of rank m - 1's last `top`
            slots[m, :, :, :top] = g[:, :, :top]
        if m < n_m - 1:             # the rows of rank m + 1's first `bottom`
            slots[m, :, :, top:] = g[:, :, top + r:]
        _all_reduce(slots, grid.model_pg)
        dx = g[:, :, top:top + r].clone()
        if m < n_m - 1:
            dx[:, :, r - top:] += slots[m + 1, :, :, :top].to(g.dtype)
        if m > 0:
            dx[:, :, :bottom] += slots[m - 1, :, :, top:].to(g.dtype)
        return dx, None, None, None, None


class _Gather(torch.autograd.Function):
    """The model ranks' rows concatenated on dim 2; the backward keeps
    this rank's rows of the gradient (each model rank computes the same
    loss of the whole, so a sum would count it M times)."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid, ctx.r = grid, x.shape[2]
        slots = x.new_zeros((grid.m_size,) + x.shape, dtype=_comm_dtype(x.dtype))
        slots[grid.m] = x
        _all_reduce(slots, grid.model_pg)
        b, c, r, w = x.shape
        return slots.permute(1, 2, 0, 3, 4).reshape(b, c, grid.m_size * r, w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        m, r = ctx.grid.m, ctx.r
        return g[:, :, m * r:(m + 1) * r].contiguous(), None


@dataclass(frozen=True)
class Grid:
    """This rank's place in a (D, M) grid of `ranks` (world ranks, in grid
    order): its data group (`data`, the D ranks of its m), the group of
    every rank of the grid (`norm`: BatchNorm's statistics, the summed
    matrices, the gradients) and its model group's process group
    (`model_pg`, None where M is 1)."""
    rank: int
    shape: tuple[int, int]
    data: DataGroup
    norm: DataGroup
    model_pg: object = None

    @classmethod
    def of(cls, world: World, shape, ranks=None) -> "Grid | None":
        """The grid of `shape` (D, M) over `ranks` of `world` (all of them
        by default); None on a rank outside it. Every rank of the world
        calls this, in the same order for every grid it forms, since each
        process group is formed by all of them."""
        n_d, n_m = (int(s) for s in shape)
        ranks = list(range(world.size)) if ranks is None else [int(r) for r in ranks]
        if n_d < 1 or n_m < 1 or n_d * n_m != len(ranks):
            raise ValueError(f"a grid of {n_d}x{n_m} ranks does not fit {len(ranks)} ranks")

        def group(members):
            if len(members) == 1:
                return None
            return dist.group.WORLD if members == list(range(world.size)) else \
                dist.new_group(members)

        pgs = {}
        for d in range(n_d):
            pgs[("model", d)] = group(ranks[d * n_m:(d + 1) * n_m])
        for m in range(n_m):
            pgs[("data", m)] = group(ranks[m::n_m])
        pgs["norm"] = group(ranks)
        if world.rank not in ranks:
            return None
        r = ranks.index(world.rank)
        d, m = divmod(r, n_m)
        data = DataGroup(d, n_d, n_d, world.device, pgs[("data", m)])
        norm = DataGroup(r, n_d * n_m, n_d * n_m, world.device, pgs["norm"])
        return cls(r, (n_d, n_m), data, norm, pgs[("model", d)])

    @property
    def d_size(self) -> int:
        return self.shape[0]

    @property
    def m_size(self) -> int:
        return self.shape[1]

    @property
    def m(self) -> int:
        """This rank's model index."""
        return self.rank % self.m_size

    @property
    def spatial(self) -> bool:
        """Whether the rows are split (M > 1)."""
        return self.m_size > 1

    @property
    def chief(self) -> bool:
        """Rank 0 of the grid, which alone writes checkpoints."""
        return self.rank == 0

    def local_rows(self, n: int) -> slice:
        """This rank's data shard of a global batch of `n`."""
        return self.data.local_rows(n)

    def rows(self, h: int) -> slice:
        """This rank's band of `h` rows."""
        if h % self.m_size:
            raise ValueError(f"{h} rows do not split over {self.m_size} model ranks")
        k = h // self.m_size
        return slice(self.m * k, (self.m + 1) * k)

    def exchange_halo(self, x: torch.Tensor, top: int, bottom: int,
                      fill: float) -> torch.Tensor:
        """NCHW `x` (this rank's rows) with `top` rows of the rank above
        and `bottom` rows of the rank below (at most its rows), `fill`
        beyond the image."""
        return _Halo.apply(x, self, int(top), int(bottom), float(fill))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The model ranks' rows of NCHW `x`, whole (backward: this rank's
        rows of the gradient)."""
        return _Gather.apply(x, self) if self.spatial else x

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the model ranks, with gradient."""
        return SumGrad.apply(t, self.model_pg) if self.spatial else t

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest of `t` over the model ranks, without gradient."""
        t = t.detach().contiguous().clone()
        return _all_reduce(t, self.model_pg, dist.ReduceOp.MAX) if self.spatial else t

    def mean_grads_(self, tensors) -> None:
        """Gradients (of one dtype) summed over the model ranks and
        averaged over the data ranks, in place: one all-reduce over the
        grid, divided by D."""
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.norm.all_reduce_(flat)
        flat /= self.d_size
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def check_graph(model: torch.nn.Module) -> None:
    """The graphs the grid splits: OCRNet on a ResNet trunk, without a
    projector. Any other raises NotImplementedError."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import OCRNet
    if not isinstance(model, OCRNet) or model.on_hrnet or model.projector is not None:
        what = type(model).__name__
        if isinstance(model, OCRNet):
            what = "OCRNet on HRNet" if model.on_hrnet else "OCRNet with a projector"
        raise NotImplementedError(f"{what} under the spatial grid: {ROADMAP_REST}")


@contextlib.contextmanager
def spatial_rows(model: torch.nn.Module, grid: Grid | None):
    """The model's row-split layers (models/layers.py: `Conv2d`,
    `MaxPool2d`; the OCR head) work on the grid's model ranks for the
    block, each knowing its name for the shard checks' errors. A grid of
    one model rank, or none, changes nothing."""
    if grid is None or not grid.spatial:
        yield
        return
    check_graph(model)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
        Conv2d, MaxPool2d)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import OCRNet
    mods = [(n, m) for n, m in model.named_modules()
            if isinstance(m, (Conv2d, MaxPool2d, OCRNet))]
    for name, m in mods:
        m.grid, m.site = grid, name or type(m).__name__
    try:
        yield
    finally:
        for _, m in mods:
            m.grid = None
