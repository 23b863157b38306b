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
serve on the card. The sidecar names that device.

Serving over several GPUs (the JAX package's `mesh`, its data-parallel
artifact): `mesh` is a list of devices and the batch must be pinned and
divisible by their count. The `.pt2` then holds the program at the batch
of one shard, and `load_serving(path, mesh=devices)` (`MeshServing`)
serves one copy of it on each device (moved there with
`torch.export.passes.move_to_device_pass`), each on its contiguous shard
of the batch, the outputs concatenated in batch order on the first
device. The `.pt2` records the device count (`save_serving(..., mesh=)`)
and `load_serving` holds the caller's mesh to it: a mesh artifact loads
only over a mesh of that many devices, a one-device artifact over none.
The sidecar's `mesh_devices` is the device count and its `batch` the
batch the artifact serves (None where it is symbolic).
"""
from __future__ import annotations

import copy
import json
import pathlib

import torch
from torch import nn

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    TTA_SCALES, EvalSpec, _forward, eval_preprocess, tta_merged_probs)

SUFFIX = ".pt2"
# the artifact's own record of its mesh, an extra file of the .pt2
RECORD = "cadis_serving.json"


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
    example batch of 1 would specialise it); an int pins the batch. With
    `mesh` (a list of devices) the program is one shard's: the pinned
    batch over the device count (`MeshServing` serves the whole batch)."""
    if mesh is not None:
        n = len(mesh)
        if batch is None or int(batch) % n:
            raise ValueError(f"mesh export needs a pinned batch divisible by {n}")
        batch = int(batch) // n
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


def save_serving(exported, path, *, mesh=None) -> pathlib.Path:
    """Write `exported` as a `.pt2` that records `mesh`'s device count:
    pass the mesh it was exported over (`export_fn`), if any."""
    path = pathlib.Path(path)
    if path.suffix != SUFFIX:
        path = path.with_suffix(path.suffix + SUFFIX)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = {"mesh_devices": None if mesh is None else len(mesh)}
    torch.export.save(exported, str(path), extra_files={RECORD: json.dumps(record)})
    return path


class MeshServing:
    """A shard's program served over `mesh` (a list of devices): one copy
    on each distinct device, each on its contiguous shard of the batch;
    the outputs concatenated in batch order on the first device."""

    def __init__(self, program: torch.export.ExportedProgram, mesh):
        from torch.export.passes import move_to_device_pass
        self.devices = [torch.device(d) for d in mesh]
        self.shard = int(program.example_inputs[0][0].shape[0])
        self.copies = {d: move_to_device_pass(copy.deepcopy(program), d).module()
                       for d in dict.fromkeys(self.devices)}

    def __call__(self, images_u8: torch.Tensor) -> dict:
        n = self.shard * len(self.devices)
        if images_u8.shape[0] != n:
            raise ValueError(f"this artifact serves batches of {n} over "
                             f"{len(self.devices)} devices, got {images_u8.shape[0]}")
        outs = [self.copies[d](x.to(d, non_blocking=True)) for d, x in
                zip(self.devices, images_u8.split(self.shard))]
        return {k: torch.cat([o[k].to(self.devices[0]) for o in outs]) for k in outs[0]}


def load_serving(path, mesh=None):
    """The artifact as a callable module: images_u8 -> {"pred",
    "confidence"}; it needs torch alone. An artifact exported over a
    mesh of N devices serves its whole batch over `mesh`, a list of N
    devices (`MeshServing`), and loads over no other; a one-device
    artifact loads without a mesh."""
    record = {RECORD: ""}
    program = torch.export.load(str(path), extra_files=record)
    n = json.loads(record[RECORD] or "{}").get("mesh_devices")
    if n is None:
        if mesh is not None:
            raise ValueError(f"{path} was exported for one device, not over a mesh")
        return program.module()
    if mesh is None or len(mesh) != n:
        raise ValueError(f"{path} was exported over a mesh of {n} devices; load it "
                         f"with mesh= a list of {n} devices, not {mesh}")
    return MeshServing(program, mesh)


def write_sidecar(path, trainer, *, image_hw, tta_scales=None, mesh=None,
                  batch=None) -> pathlib.Path:
    """`<artifact>.json`: what a consumer without this package needs to
    read the artifact: the input contract, the task's class names, the
    CaDIS colormap, the device the artifact was exported for, the device
    count of its mesh (None without one) and the batch it serves (None
    where it is symbolic; over a mesh, the whole batch)."""
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
        "mesh_devices": None if mesh is None else len(mesh),
        "batch": None if batch is None else int(batch),
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
    and write the `.json` sidecar beside the artifact. `mesh` (a list of
    devices) exports for serving over them (`export_fn`)."""
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
    out = save_serving(export_fn(serve, (h, w), batch=batch, mesh=mesh), path, mesh=mesh)
    write_sidecar(out, trainer, image_hw=(h, w), tta_scales=tta_scales, mesh=mesh,
                  batch=batch)
    return out
