"""The spatial 'model' rank axis: a grid of D data ranks by M model ranks,
each model rank holding a band of every activation's rows.

Port of the JAX package's parallel/mesh.py `make_mesh(("data", "model"))`
and `spatial_sharding` for PyTorch's idiom, one process a rank. A world of
D·M ranks is laid out as the JAX mesh lays devices out,
`np.asarray(ranks).reshape(D, M)`: rank r is data index d = r // M and
model index m = r % M.

- The D data ranks of one m (`Grid.data`) feed the global batch's rows as
  parallel/dist.py:`DataGroup` does; the gradient mean and the loss's mean
  run over them.
- The M model ranks of one d share that data shard's frames. Model rank m
  holds the frame's rows [m·H/M, (m+1)·H/M) (`rows`; M divides H) and,
  at every stride s of the graph, the band [ceil(m·H/M/s),
  ceil((m+1)·H/M/s)) (`bands`): the output rows whose window centre lies
  in its input band, since every window op of the split graphs is centred
  (padding d(k-1)/2) and lands output row o on input row s·o. So 17 rows
  over 2 ranks become 9 and 8 at the next stride; bands may differ in
  height, and none may be empty. An activation's stride is the power of
  two that takes the frame's width to its width (`stride_of`): the width
  is never split.
- A window op reads the rows its band's windows span, from any rank that
  owns them and `fill` beyond the image (`fetch_rows`: one all-reduce of
  a slot a rank, sized to the largest need, each owner writing the rows
  each rank needs; the backward returns every fetched row's gradient to
  its owner the same way). That serves convolutions and the max-pool
  (models/layers.py:`Conv2d`, `MaxPool2d`), halos taller than a band
  (DeepLab's ASPP), and bilinear resizes between strides, whose band
  rows are rows of the global interpolation matrix and read the few
  source rows they need (models/layers.py:`upsample_like`). Sums over
  all positions add the model ranks' band sums (`model_sum`, `model_max`:
  the OCR head's softmax, the ASPP's image pool), and the steps read the
  low-resolution logits whole through `gather_rows`.
- BatchNorm normalises over every rank of the grid (`Grid.norm`): a tensor
  that the model ranks hold alike (the OCR context, the ASPP's pooled
  map) is counted M times in both its sums and its count, which leaves
  its statistics exact.

Gradients: each model rank computes its data shard's loss on the gathered
logits (upsampled whole where the loss reads full resolution, as JAX's
`_sharded_loss` hands each device the logits whole over 'model');
`gather_rows`' backward keeps this rank's rows of the gradient, so each
parameter gradient is summed over the model ranks and averaged over the
data ranks (`mean_grads_`).

Every collective is an all-reduce (a zero-filled slot a rank, summed),
which gloo runs on CPU and CUDA tensors alike and NCCL runs too; NCCL
refuses two ranks on one card, where gloo serves. A (D, 1) grid is the
data-parallel path of parallel/dist.py; a (1, 1) grid is one process.

    grid = Grid.of(init_from_env("cuda"), (D, M))
    step = make_train_step(..., group=grid)        # train/steps.py
    with spatial_rows(model, grid, (H, W)) as framed: ...   # the bands
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.dist import (
    DataGroup, SumGrad, World)

ROADMAP_REST = ("the spatial grid covers HRNetv2, OCRNet on a ResNet or an HRNet "
                "trunk, DeepLabv3 and DeepLabv3+; the rest of ROADMAP item 18 "
                "(UPerNet, FCN, PointRend, UNet, the Ensemble, the projector) is "
                "not ported")


def _comm_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor travels in: at least float32 (bf16 and f16 round
    trip exactly), float64 stays."""
    return torch.promote_types(dtype, torch.float32) if dtype.is_floating_point else dtype


def _all_reduce(t: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=pg)
    return t


def _ranges(bands, needs, h):
    """Each rank's rows to fetch from the others, as the global row ranges
    above its band, [max(a, 0), min(lo, b)), and below it, [max(hi, a),
    min(b, h)), of its need [a, b); and the largest of each."""
    up = [(max(a, 0), min(lo, b)) for (lo, _), (a, b) in zip(bands, needs)]
    down = [(max(hi, a), min(b, h)) for (_, hi), (a, b) in zip(bands, needs)]
    return up, down, max(0, *(e - s for s, e in up)), max(0, *(e - s for s, e in down))


class _Fetch(torch.autograd.Function):
    """Rows [a, b) (`needs[m]`) of an activation of `h` rows whose band
    `bands[m]` this rank holds on dim 2, `fill` beyond the image: one
    all-reduce of a slot a rank, in which each owner writes the rows the
    slot's rank needs above and below its band. The backward writes the
    fetched rows' gradients into this rank's slot and each owner adds the
    rows it owns from every slot."""

    @staticmethod
    def forward(ctx, x, grid, bands, needs, h, fill):
        ctx.grid, ctx.bands, ctx.needs, ctx.h = grid, bands, needs, h
        m, (lo, hi), (a, b) = grid.m, bands[grid.m], needs[grid.m]
        up, down, n_up, n_down = _ranges(bands, needs, h)
        if n_up + n_down:
            slots = x.new_zeros((grid.m_size,) + x.shape[:2] + (n_up + n_down, x.shape[3]),
                                dtype=_comm_dtype(x.dtype))
            for j in range(grid.m_size):
                if j != m:
                    for (s, e), off in ((up[j], 0), (down[j], n_up)):
                        g0, g1 = max(s, lo), min(e, hi)
                        if g0 < g1:
                            slots[j, :, :, off + g0 - s:off + g1 - s] = x[:, :, g0 - lo:g1 - lo]
            _all_reduce(slots, grid.model_pg)
            mine = slots[m].to(x.dtype)
        edge = x.shape[:2]
        parts = [x.new_full(edge + (min(0, b) - a, x.shape[3]), fill)] if a < 0 else []
        if up[m][1] > up[m][0]:
            parts.append(mine[:, :, :up[m][1] - up[m][0]])
        parts.append(x[:, :, max(a, lo) - lo:max(min(b, hi) - lo, 0)])
        if down[m][1] > down[m][0]:
            parts.append(mine[:, :, n_up:n_up + down[m][1] - down[m][0]])
        if b > h:
            parts.append(x.new_full(edge + (b - max(h, a), x.shape[3]), fill))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        grid, bands, needs, h = ctx.grid, ctx.bands, ctx.needs, ctx.h
        m, (lo, hi), (a, b) = grid.m, bands[grid.m], needs[grid.m]
        up, down, n_up, n_down = _ranges(bands, needs, h)
        dx = g.new_zeros(g.shape[:2] + (hi - lo, g.shape[3]))
        o0, o1 = max(a, lo), min(b, hi)      # this rank's own rows of the need
        if o0 < o1:
            dx[:, :, o0 - lo:o1 - lo] = g[:, :, o0 - a:o1 - a]
        if n_up + n_down:
            slots = g.new_zeros((grid.m_size,) + g.shape[:2] + (n_up + n_down, g.shape[3]),
                                dtype=_comm_dtype(g.dtype))
            for (s, e), off in ((up[m], 0), (down[m], n_up)):
                if s < e:
                    slots[m, :, :, off:off + e - s] = g[:, :, s - a:e - a]
            _all_reduce(slots, grid.model_pg)
            for j in range(grid.m_size):
                if j != m:
                    for (s, e), off in ((up[j], 0), (down[j], n_up)):
                        g0, g1 = max(s, lo), min(e, hi)
                        if g0 < g1:
                            dx[:, :, g0 - lo:g1 - lo] += \
                                slots[j, :, :, off + g0 - s:off + g1 - s].to(g.dtype)
        return dx, None, None, None, None, None


class _Gather(torch.autograd.Function):
    """The model ranks' bands (`bands`) concatenated on dim 2; the backward
    keeps this rank's rows of the gradient (each model rank computes the
    same loss of the whole, so a sum would count it M times)."""

    @staticmethod
    def forward(ctx, x, grid, bands):
        ctx.band = bands[grid.m]
        slots = x.new_zeros((grid.m_size,) + x.shape[:2]
                            + (max(hi - lo for lo, hi in bands), x.shape[3]),
                            dtype=_comm_dtype(x.dtype))
        slots[grid.m, :, :, :x.shape[2]] = x
        _all_reduce(slots, grid.model_pg)
        return torch.cat([slots[j, :, :, :hi - lo] for j, (lo, hi) in enumerate(bands)],
                         dim=2).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.band
        return g[:, :, lo:hi].contiguous(), None, None


@dataclass(frozen=True)
class Grid:
    """This rank's place in a (D, M) grid of `ranks` (world ranks, in grid
    order): its data group (`data`, the D ranks of its m), the group of
    every rank of the grid (`norm`: BatchNorm's statistics, the summed
    matrices, the gradients), its model group's process group (`model_pg`,
    None where M is 1) and the (H, W) of the frames whose rows the bands
    split (`frame`: `spatial_rows` sets it for a forward, `framed`)."""
    rank: int
    shape: tuple[int, int]
    data: DataGroup
    norm: DataGroup
    model_pg: object = None
    frame: tuple[int, int] | None = None

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
        """This rank's band of a frame of `h` rows."""
        if h % self.m_size:
            raise ValueError(f"{h} rows do not split over {self.m_size} model ranks")
        k = h // self.m_size
        return slice(self.m * k, (self.m + 1) * k)

    def framed(self, hw) -> "Grid":
        """This grid with the frames of (H, W) `hw`, whose rows must split
        over the model ranks."""
        self.rows(int(hw[0]))
        return replace(self, frame=(int(hw[0]), int(hw[1])))

    def stride_of(self, width: int) -> int:
        """The stride of an activation `width` columns wide: the power of
        two s with ceil(W / s) = width for the frame's width W."""
        w, s = self.frame[1], 1
        while -(-w // s) > width:
            s *= 2
        if -(-w // s) != width:
            raise ValueError(f"{width} columns are no power-of-two stride of the "
                             f"frame's {w}")
        return s

    def bands(self, stride: int) -> list[tuple[int, int]]:
        """Every model rank's band [lo, hi) of the rows at `stride`: the
        rows o with s·o in its band of the frame's rows."""
        k = self.frame[0] // self.m_size
        return [(-(-j * k // stride), -(-(j + 1) * k // stride)) for j in range(self.m_size)]

    def band_of(self, x: torch.Tensor, site: str = "") -> tuple[int, list]:
        """The stride of NCHW `x`, this rank's band of an activation, and
        every model rank's band at it; ValueError (naming `site`) where
        `x` does not hold this rank's band."""
        stride = self.stride_of(x.shape[3])
        bands = self.bands(stride)
        lo, hi = bands[self.m]
        if x.shape[2] != hi - lo:
            raise ValueError(f"{site or 'an activation'}: {x.shape[2]} rows at stride "
                             f"{stride} are not model rank {self.m}'s band {bands[self.m]} "
                             f"of a {self.frame} frame (grid {self.shape})")
        return stride, bands

    def fetch_rows(self, x: torch.Tensor, bands, needs, fill: float) -> torch.Tensor:
        """Rows [a, b) = `needs[m]` of the activation whose bands are
        `bands` (this rank's `x`), from whichever ranks own them and
        `fill` beyond the image; `needs` holds every model rank's, since
        each rank writes the rows the others need (backward: each row's
        gradient to its owner)."""
        bands, needs = tuple(bands), tuple(needs)
        h = bands[-1][1]
        (lo, hi), (a, b) = bands[self.m], needs[self.m]
        _, _, n_up, n_down = _ranges(bands, needs, h)
        if n_up + n_down == 0 and 0 <= a and b <= h:
            return x[:, :, a - lo:b - lo]
        return _Fetch.apply(x, self, bands, needs, h, float(fill))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The model ranks' bands of NCHW `x`, whole (backward: this rank's
        rows of the gradient)."""
        if not self.spatial:
            return x
        return _Gather.apply(x, self, tuple(self.band_of(x)[1]))

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
    """The graphs the grid splits: HRNetv2, OCRNet on a ResNet or an HRNet
    trunk, DeepLabv3 and DeepLabv3+, each without a projector. Any other
    graph (UPerNet, FCN, PointRend, UNet, the Ensemble) and any projector
    raise NotImplementedError."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.deeplab import (
        DeepLabv3, DeepLabv3Plus)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.hrnet import HRNetv2
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import OCRNet
    what = type(model).__name__
    if getattr(model, "projector", None) is not None:
        what += " with a projector"
    elif type(model) in (HRNetv2, OCRNet, DeepLabv3, DeepLabv3Plus):
        return
    raise NotImplementedError(f"{what} under the spatial grid: {ROADMAP_REST}")


@contextlib.contextmanager
def spatial_rows(model: torch.nn.Module, grid: Grid | None, frame):
    """For the block, the model's row-split modules (every module whose
    class declares `grid`: models/layers.py's `Conv2d` and `MaxPool2d`,
    HRNet's fuse modules, the ASPP and decoder, the graphs) work on the
    grid's model ranks over frames of (H, W) `frame`, each knowing its
    name for the shard checks' errors; yields the grid with that frame
    (`Grid.framed`). A grid of one model rank, or none, changes nothing
    and is yielded as it is."""
    if grid is None or not grid.spatial:
        yield grid
        return
    check_graph(model)
    grid = grid.framed(frame)
    mods = [(n, m) for n, m in model.named_modules() if hasattr(type(m), "grid")]
    for name, m in mods:
        m.grid, m.site = grid, name or type(m).__name__
    try:
        yield grid
    finally:
        for _, m in mods:
            m.grid = None
