"""Serving export: the whole inference program as one `torch.export`
artifact (port of the JAX package's train/export.py).

The program is uint8 preprocessing (the eval step's pad and ImageNet
normalise, `eval_preprocess`), the model's forward and the prediction head
(argmax and confidence), with the trained weights inside, and a symbolic
batch axis, so that one artifact serves any batch. `torch.export.load` of
the `.pt2` needs torch alone: not this package, the model code, the
checkpoint or the config.

Contract: input `(b, H, W, 3) uint8` RGB frames at dataset resolution
(540x960 for CaDIS); output `{"pred": (b, H', W') uint8 task-class ids,
"confidence": (b, H', W') float32}`, the largest softmax probability
(`1 / sum exp(l - lmax)`; with TTA or an Ensemble the largest merged
probability), where H' includes the 2-row reflect pad when the transform
list pads (540 -> 544; crop the two rows on the host if undesired).

The JAX package lowers for a list of platforms; here the artifact holds
the program traced on the device its weights sit on (the Trainer's), and
a `.pt2` runs on the device it was exported for: export on the card to
serve on the card. The sidecar names that device. Exporting for several
GPUs (the JAX package's `mesh`) is ROADMAP Queue A item 15.
"""
from __future__ import annotations

import json
import pathlib

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    TTA_SCALES, EvalSpec, _forward, eval_preprocess, tta_merged_probs)

SUFFIX = ".pt2"


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("serving over several GPUs (the JAX package's "
                                  "`mesh`) is not ported yet (ROADMAP Queue A "
                                  "item 15)")


class ServingModule(nn.Module):
    """uint8 frames -> {"pred", "confidence"} of one model, or of its
    flip x multi-scale TTA where `tta_scales` is given (the same merge as
    the Trainer's TTA step; the confidence is then the merged one)."""

    def __init__(self, model: nn.Module, spec: EvalSpec | None,
                 tta_scales=None, precision: str = "fp32"):
        super().__init__()
        self.model = model.eval()
        self.spec = spec
        self.tta_scales = None if tta_scales is None else tuple(float(s) for s in tta_scales)
        self.precision = precision

    def forward(self, images_u8: torch.Tensor) -> dict:
        x = eval_preprocess(images_u8, self.spec)

        def logits_of(xi):
            return _forward(self.model, xi, self.precision)["logits"]

        if self.tta_scales is None:
            logits = logits_of(x)
            logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
            lmax = logits.amax(dim=1, keepdim=True)
            conf = 1.0 / torch.exp(logits - lmax).sum(dim=1)
            return {"pred": logits.argmax(dim=1).to(torch.uint8),
                    "confidence": conf.float()}
        probs = tta_merged_probs(logits_of, x, self.tta_scales)
        return {"pred": probs.argmax(dim=1).to(torch.uint8),
                "confidence": probs.amax(dim=1).float()}


class EnsembleServingModule(nn.Module):
    """The Ensemble's serving program (the reference's Ensemble_Manager and
    BaseManager.infer): the pad alone as preprocessing, since the members
    normalise their own inputs, then the merged probabilities."""

    def __init__(self, ensemble: nn.Module, spec: EvalSpec | None,
                 precision: str = "fp32"):
        super().__init__()
        self.ensemble = ensemble.eval()
        self.spec = spec
        self.precision = precision

    def forward(self, images_u8: torch.Tensor) -> dict:
        x = eval_preprocess(images_u8, self.spec)
        probs = _forward(self.ensemble, x, self.precision)["logits"]
        return {"pred": probs.argmax(dim=1).to(torch.uint8),
                "confidence": probs.amax(dim=1).float()}


def make_serving_fn(model, spec, tta_scales=None, precision: str = "fp32") -> ServingModule:
    return ServingModule(model, spec, tta_scales, precision)


def make_ensemble_serving_fn(ensemble, spec, precision: str = "fp32") -> EnsembleServingModule:
    return EnsembleServingModule(ensemble, spec, precision)


def export_fn(serve: nn.Module, image_hw, *, batch: int | None = None, mesh=None):
    """`torch.export.export` of a serving module on its weights' device.

    batch=None exports a symbolic batch axis `b`, traced at batch 2 (an
    example batch of 1 would specialise it); an int pins the batch."""
    _no_mesh(mesh)
    h, w = image_hw
    device = next(serve.parameters()).device
    example = torch.zeros((2 if batch is None else int(batch), h, w, 3),
                          dtype=torch.uint8, device=device)
    dynamic = {"images_u8": {0: torch.export.Dim("b")}} if batch is None else None
    with torch.no_grad():
        return torch.export.export(serve, (example,), dynamic_shapes=dynamic)


def export_serving(model, spec, image_hw, *, batch=None, tta_scales=None,
                   precision: str = "fp32", mesh=None):
    """Export the single-model serving program (`make_serving_fn`)."""
    return export_fn(make_serving_fn(model, spec, tta_scales, precision), image_hw,
                     batch=batch, mesh=mesh)


def save_serving(exported, path) -> pathlib.Path:
    path = pathlib.Path(path)
    if path.suffix != SUFFIX:
        path = path.with_suffix(path.suffix + SUFFIX)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(path))
    return path


def load_serving(path):
    """The artifact as a callable module: images_u8 -> {"pred",
    "confidence"}; it needs torch alone."""
    return torch.export.load(str(path)).module()


def write_sidecar(path, trainer, *, image_hw, tta_scales=None, mesh=None) -> pathlib.Path:
    """`<artifact>.json`: what a consumer without this package needs to
    read the artifact: the input contract, the task's class names, the
    CaDIS colormap, and the device the artifact was exported for."""
    _no_mesh(mesh)
    task = trainer.task
    pad = trainer.pipeline.valid_pad
    h, w = image_hw
    names = list(taxonomy.TASK_CLASS_NAMES[task])
    if taxonomy.task_has_ignore(task):
        names = names + ["Ignore"]
    meta = {
        "input": {"shape": ["batch", h, w, 3], "dtype": "uint8",
                  "layout": "NHWC RGB"},
        "output": {"pred": ["batch", h + (4 if pad else 0), w],
                   "confidence": "float32 max softmax prob, same HxW",
                   "pad_rows": 2 if pad else 0},
        "task": task, "num_classes": taxonomy.TASK_NUM_CLASSES[task],
        "class_names": names,
        "colormap_rgb": taxonomy.task_colormap(task).tolist(),
        "tta_scales": list(tta_scales) if tta_scales else None,
        "mesh_devices": None,
        "run_id": trainer.run_id,
        "device": str(trainer.device),
    }
    sidecar = pathlib.Path(path).with_suffix(SUFFIX + ".json")
    sidecar.write_text(json.dumps(meta, indent=1))
    return sidecar


def export_trainer(trainer, path, *, batch=None, tta: bool = False, mesh=None) -> pathlib.Path:
    """Export a Trainer's inference state (after `load_checkpoint('best')`;
    an Ensemble restores its members when it is built) at the validation
    images' resolution, with `tta=True` the config's TTA recipe inside
    (`tta_scales`, default the reference's), at the Trainer's precision,
    and write the `.json` sidecar beside the artifact."""
    _no_mesh(mesh)
    _, lbl, _ = trainer.valid_set[0]
    h, w = lbl.shape
    tta_scales = None
    if trainer.ensemble:
        if tta:
            raise ValueError("TTA is a single-model recipe (BaseManager.infer)")
        serve = make_ensemble_serving_fn(trainer.model, trainer.eval_spec,
                                         trainer.precision)
    else:
        if tta:
            tta_scales = tuple(trainer.config.get("tta_scales", TTA_SCALES))
        serve = make_serving_fn(trainer.model, trainer.eval_spec, tta_scales,
                                trainer.precision)
    out = save_serving(export_fn(serve, (h, w), batch=batch), path)
    write_sidecar(out, trainer, image_hw=(h, w), tta_scales=tta_scales)
    return out
