"""Train state: the model, its optimiser, the LR schedule and the step count.

Port of the JAX package's train/state.py. `make_optimizer` builds what its
`make_optimizer` builds from a config's `train` section, as a torch
optimiser: Adam; AdamW when `weight_decay` > 0 (decoupled, as
`optax.adamw`: p <- p - lr (adam + wd p)); SGD with momentum; and, with
`grad_clip`, a clip of the global gradient norm before the update
(`optax.clip_by_global_norm`). The learning rate of an update is
`schedule(step)` read before the step count increments, as optax's count
is.
"""
from __future__ import annotations

import torch


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all tensors together (`optax.global_norm`)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """Scale `grads` in place by max_norm / norm when their global norm is
    not below max_norm (`optax.clip_by_global_norm`), without a host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_optimizer(train_cfg: dict, params) -> torch.optim.Optimizer:
    """The optimiser of a config's `train` section; its learning rate is
    set per update by `TrainState.apply_gradients`."""
    name = train_cfg.get("optimizer", "adam").lower()
    wd = float(train_cfg.get("weight_decay", 0.0))
    lr = float(train_cfg.get("learning_rate", 1e-4))
    if name == "adam":
        if wd == 0:
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(train_cfg.get("momentum", 0.9)))
    raise ValueError(f"optimizer '{name}' not recognised")


class TrainState:
    """What a train step reads and advances: `model` (its parameters and
    BatchNorm buffers), `optimizer`, `schedule(step) -> lr`, the optional
    global-norm `grad_clip`, and the int `step` (updates applied)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 schedule, grad_clip: float | None = None, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step = step

    def apply_gradients(self, grads) -> None:
        """One update from the gradients already on the parameters
        (`grads` are those tensors): clip, set the scheduled LR, step."""
        if self.grad_clip:
            clip_by_global_norm_(grads, float(self.grad_clip))
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: torch.nn.Module, train_cfg: dict,
                       schedule) -> TrainState:
    return TrainState(model, make_optimizer(train_cfg, model.parameters()),
                      schedule, train_cfg.get("grad_clip"))
