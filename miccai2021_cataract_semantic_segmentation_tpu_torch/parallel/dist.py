"""Data parallelism over processes: the process group, the ranks that take
part in the steps, and each rank's rows of a batch.

Port of the JAX package's parallel/mesh.py for PyTorch's idiom, one process
per GPU as torchrun launches them:

    torchrun --nproc_per_node N -m \
        miccai2021_cataract_semantic_segmentation_tpu_torch.main -c cfg.json

`init_from_env(device)` reads torchrun's WORLD_SIZE, RANK and LOCAL_RANK: on
"cuda" it pins cuda:LOCAL_RANK and forms an NCCL group, on "cpu" a gloo one.
Without torchrun's environment the world is one process and no group is
formed. A group the caller formed beforehand (the tests' gloo ranks, each
on a FileStore) is used as it is.

`DataGroup.of(world, batch)` is the JAX Trainer's data mesh (JAX
train/trainer.py:203-209): the first gcd(batch, world size) ranks take
part, rank r feeding the contiguous rows `local_rows(n)` of each batch of
n, as JAX `device_put_batch` feeds each process its slice; the other ranks
sit out. Its collectives run over the ranks that take part; with one rank
taking part every collective is skipped, so that rank runs the one-process
path. BatchNorm over the global batch (models/layers.py:`BatchNorm2d`, the
GSPMD semantics of the JAX step) reads the group that `global_batch_norm`
gives the model's BatchNorms.
"""
from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device

TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def under_torchrun() -> bool:
    """Whether torchrun's environment is set."""
    return all(v in os.environ for v in TORCHRUN_VARS)


@dataclass(frozen=True)
class World:
    """This process's rank among `size` processes and its device; `formed`
    when `init_from_env` formed the process group (`close` destroys it)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    formed: bool = False


def current_world(device: str | torch.device = "cuda") -> World:
    """The world of the process group formed beforehand, else a world of
    one process, on `device`; forms no group."""
    dev = resolve_device(torch.device(device))
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(), dev)
    return World(0, 1, dev)


def init_from_env(device: str | torch.device = "cuda") -> World:
    """The world this process belongs to (see the module's docstring),
    its group formed here under torchrun. A group that fails to form
    raises; no rank carries on alone."""
    dev = torch.device(device)
    if (dist.is_available() and dist.is_initialized()) or not under_torchrun():
        return current_world(dev)
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is not None and dev.index != local:
            raise ValueError(f"under torchrun this rank runs on cuda:{local} "
                             f"(LOCAL_RANK), not {dev}")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=size, device_id=dev)
    else:
        dev = resolve_device(dev)
        dist.init_process_group("gloo", rank=rank, world_size=size)
    return World(rank, size, dev, formed=True)


def close(world: World) -> None:
    """Destroy the process group where `init_from_env` formed it."""
    if world.formed and dist.is_initialized():
        dist.destroy_process_group()


def broadcast_object(world: World, obj):
    """Rank 0's `obj` on every rank of `world`."""
    if world.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class SumGrad(torch.autograd.Function):
    """The sum of a tensor over a process group (one `dist.all_reduce`);
    the backward sums the ranks' gradients the same way."""

    @staticmethod
    def forward(ctx, t, pg):
        ctx.pg = pg
        out = t.contiguous().clone()
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


@dataclass(frozen=True)
class DataGroup:
    """The ranks that take part in the steps: the first `n_use` of `size`.
    `pg` is their process group (None where `n_use` is 1)."""
    rank: int = 0
    size: int = 1
    n_use: int = 1
    device: torch.device = torch.device("cpu")
    pg: object = None

    @classmethod
    def of(cls, world: World, batch: int) -> "DataGroup":
        """The group of `world` for a batch of `batch` (the labelled half
        in semi mode): gcd(batch, world size) ranks. Every rank of the
        world calls this, those that sit out included."""
        n_use = math.gcd(int(batch), world.size)
        pg = None
        if n_use > 1:
            pg = dist.group.WORLD if n_use == world.size else \
                dist.new_group(list(range(n_use)))
        return cls(world.rank, world.size, n_use, world.device, pg)

    @property
    def active(self) -> bool:
        """Whether this rank takes part in the steps."""
        return self.rank < self.n_use

    @property
    def chief(self) -> bool:
        """Rank 0, which alone writes checkpoints and logs."""
        return self.rank == 0

    def local_rows(self, n: int) -> slice:
        """This rank's contiguous rows of a batch of `n`."""
        if n % self.n_use:
            raise ValueError(f"a batch of {n} does not split over {self.n_use} ranks")
        k = n // self.n_use
        return slice(self.rank * k, (self.rank + 1) * k)

    def owns(self, i: int) -> bool:
        """Whether this rank runs eval batch `i` (batches go round the ranks)."""
        return i % self.n_use == self.rank

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place (through a contiguous copy
        where `t` is a view with gaps, which the collective would misread)."""
        if self.n_use > 1:
            flat = t if t.is_contiguous() else t.contiguous()
            dist.all_reduce(flat, group=self.pg)
            if flat is not t:
                t.copy_(flat)
        return t

    def mean_(self, tensors) -> None:
        """Average `tensors` (of one dtype) over the ranks in place, through
        one all-reduce of their concatenation, in their order."""
        if self.n_use == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.pg)
        flat /= self.n_use
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, with gradient: the backward sums
        the ranks' gradients (global BatchNorm's statistics)."""
        if self.n_use == 1:
            return t
        return SumGrad.apply(t, self.pg)

    def sum_array(self, a: np.ndarray) -> np.ndarray:
        """A host array summed over the ranks (through the group's device)."""
        if self.n_use == 1:
            return a
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        dist.all_reduce(t, group=self.pg)
        return t.cpu().numpy()

    def gather(self, obj) -> list | None:
        """Every rank's `obj` in rank order on rank 0 (None elsewhere)."""
        if self.n_use == 1:
            return [obj]
        out = [None] * self.n_use if self.chief else None
        dist.gather_object(obj, out, dst=0, group=self.pg)
        return out

    def barrier(self) -> None:
        """Wait for the ranks that take part."""
        if self.n_use > 1:
            dist.barrier(group=self.pg)

    def world_barrier(self) -> None:
        """Wait for every rank of the world, those that sit out included."""
        if self.size > 1:
            dist.barrier()


@contextlib.contextmanager
def global_batch_norm(model: torch.nn.Module, group: DataGroup | None):
    """The model's BatchNorms normalise over the group's global batch in
    train mode for the block (models/layers.py:`BatchNorm2d`)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)] \
        if group is not None and group.n_use > 1 else []
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None
