"""Checkpoints in the reference's layout, and the run's info.json.

The port's counterpart of the JAX package's train/checkpoint.py (orbax
there) and of the unwrapping in its train/port_torch.py. One format, the
reference's own:
    <log_path>/<run_id>/chkpts/chkpt_best.pt   best-mIoU checkpoint
    <log_path>/<run_id>/chkpts/chkpt_last.pt   most recent periodic save
    <log_path>/<run_id>/info.json              config + latest metrics
A checkpoint is a `torch.save`d dict: `model_state_dict` under the
reference's torch names (the port's modules use them, train/bridge.py),
`optimizer_state_dict` and `global_step` where a train state exists, and
`epoch`, `best_miou`, `best_loss`. It is written to a temporary file that
then replaces the checkpoint, so a crash mid-save leaves the previous one
whole. So the published run directories named by the inference configs'
`load_checkpoint` load unchanged, and so does a bare `.pt`.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch


def checkpoint_path(ckpt_dir, name: str) -> pathlib.Path:
    return pathlib.Path(ckpt_dir) / f"chkpt_{name}.pt"


def save_checkpoint(ckpt_dir, name: str, model: torch.nn.Module, epoch: int,
                    best_miou: float, best_loss: float, state=None) -> pathlib.Path:
    """Write `model` (and `state`, a train/state.py TrainState, where given)
    to <ckpt_dir>/chkpt_<name>.pt; returns the path."""
    path = checkpoint_path(ckpt_dir, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"model_state_dict": model.state_dict(), "epoch": int(epoch),
               "best_miou": float(best_miou), "best_loss": float(best_loss)}
    if state is not None:
        payload["optimizer_state_dict"] = state.optimizer.state_dict()
        payload["global_step"] = int(state.step)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def read_checkpoint(path) -> dict:
    """The dict a `.pt` file holds, its tensors on the CPU (weights only:
    no code runs while it is read)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def unwrap_state_dict(payload: dict) -> dict:
    """A checkpoint's model state dict: `model_state_dict`, else
    `state_dict`, else the bare dict."""
    return payload.get("model_state_dict", payload.get("state_dict", payload))


def load_torch_checkpoint(path) -> dict:
    """The model state dict of the `.pt` at `path`, unwrapped."""
    return unwrap_state_dict(read_checkpoint(path))


def load_model_state(model: torch.nn.Module, state_dict: dict, source="") -> None:
    """`model.load_state_dict(state_dict, strict=True)`, its error naming
    the missing and unexpected keys (and the shapes that differ)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    shapes = sorted(k for k in set(own) & set(state_dict)
                    if tuple(own[k].shape) != tuple(state_dict[k].shape))
    if missing or unexpected or shapes:
        raise RuntimeError(
            f"checkpoint {source} does not fit the model: missing keys "
            f"{missing}, unexpected keys {unexpected}, shapes differ at {shapes}")
    model.load_state_dict(state_dict, strict=True)


def restore_checkpoint(ckpt_dir, name: str, model: torch.nn.Module,
                       state=None) -> dict:
    """Load <ckpt_dir>/chkpt_<name>.pt into `model` (and `state`'s
    optimiser and step, where both are there); returns its `epoch`,
    `best_miou`, `best_loss` and `global_step` (0 where it has none)."""
    path = checkpoint_path(ckpt_dir, name)
    payload = read_checkpoint(path)
    load_model_state(model, unwrap_state_dict(payload), str(path))
    if state is not None and "optimizer_state_dict" in payload:
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
        state.step = int(payload.get("global_step", 0))
    return {"epoch": int(payload.get("epoch", 0)),
            "best_miou": float(payload.get("best_miou", 0.0)),
            "best_loss": float(payload.get("best_loss", float("inf"))),
            "global_step": int(payload.get("global_step", 0))}


def write_info_json(run_dir, config: dict, metrics: dict) -> None:
    """config + metrics snapshot, rewritten after every validation."""
    def clean(o):
        if isinstance(o, dict):
            return {str(k): clean(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [clean(v) for v in o]
        if isinstance(o, (np.ndarray, torch.Tensor)):
            return np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o).tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, (str, int, float, bool)) or o is None:
            return o
        return str(o)

    path = pathlib.Path(run_dir) / "info.json"
    with open(path, "w") as f:
        json.dump({"config": clean(config), "metrics": clean(metrics)}, f, indent=2)
