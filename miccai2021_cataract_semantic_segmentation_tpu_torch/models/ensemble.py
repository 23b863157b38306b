"""Bagging ensemble over independently trained members.

Port of the JAX package's models/ensemble.py (the reference's
models/Ensemble.py). An ensemble is a list of (model, needs_norm) pairs:
`ensemble_apply` runs each member on the un-normalised [0, 1] image (with
ImageNet normalisation first where the member was trained with it: the
UPerNet members, Ensemble.py:63-66), takes the softmax of its `logits` in
float32 and merges the members' probabilities by their mean or their
maximum. `Ensemble` is that function as a module whose forward gives the
merged probabilities as `logits` (the eval step's confusion matrix takes
their argmax). `build_ensemble` builds each member of a config's
`members` from its graph and restores it from the port's own
`<log_path>/<ckpt>/chkpts/chkpt_best.pt` (train/checkpoint.py). Members
run over the whole batch at once.
"""
from __future__ import annotations

import pathlib
from typing import Sequence

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import (
    IMAGENET_MEAN, IMAGENET_STD)


def normalise_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the channels of NCHW `x`."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - mean) / std


def ensemble_apply(members: Sequence[tuple[nn.Module, bool]], x: torch.Tensor,
                   merge: str = "mean") -> torch.Tensor:
    """NCHW [0, 1] `x` -> the members' merged float32 (>= f32) softmax
    probabilities, NCHW."""
    if merge not in ("mean", "max"):
        raise ValueError(f"merge must be 'mean' or 'max', got {merge!r}")
    probs = []
    for model, needs_norm in members:
        out = model(normalise_imagenet(x) if needs_norm else x)
        logits = out["logits"] if isinstance(out, dict) else out
        probs.append(torch.softmax(logits.to(torch.promote_types(logits.dtype,
                                                                 torch.float32)), dim=1))
    stacked = torch.stack(probs)
    return stacked.mean(0) if merge == "mean" else stacked.max(0).values


class Ensemble(nn.Module):
    def __init__(self, members: Sequence[nn.Module], needs_norm: Sequence[bool],
                 merge: str = "mean"):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.needs_norm = tuple(bool(n) for n in needs_norm)
        self.merge = merge

    def forward(self, x: torch.Tensor) -> dict:
        """{"logits": the merged probabilities} of NCHW [0, 1] `x`."""
        return {"logits": ensemble_apply(list(zip(self.members, self.needs_norm)),
                                         x, self.merge)}


def build_ensemble(config: dict, task: int, log_path="logs",
                   device: str | torch.device = "cuda") -> Ensemble:
    """The ensemble of `config["members"]` (member key -> graph config with
    an optional `ckpt` run id), in sorted key order, each restored from
    `<log_path>/<ckpt>/chkpts/chkpt_best.pt` where it names a run, merged
    by `config["merge"]` ("mean" unless given), in eval mode."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import (
        restore_checkpoint)

    members, needs_norm = [], []
    for key in sorted(config["members"]):
        mcfg = dict(config["members"][key])
        run_id = mcfg.pop("ckpt", None)
        model = build_model(mcfg, task, device=device)
        if run_id:
            restore_checkpoint(pathlib.Path(log_path) / run_id / "chkpts", "best", model)
        members.append(model)
        needs_norm.append(mcfg.get("model") == "UPerNet")
    return Ensemble(members, needs_norm, config.get("merge", "mean")).eval()
