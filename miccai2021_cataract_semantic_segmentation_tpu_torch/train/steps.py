"""The eval steps: uint8 batch -> preprocessing -> forward -> (loss) ->
confusion matrix.

Port of `eval_preprocess`, `make_eval_step` and `make_eval_loss_step` from
the JAX package's train/steps.py. The steps are eager functions under
`torch.inference_mode()`. They take the JAX package's inputs — uint8 NHWC
images and uint8 NHW labels, numpy or torch — and return NCHW float32
logits. `precision="bf16"` (the JAX package's default) runs the forward
under bf16 autocast; any other value runs it in the model's parameter
dtype (float32, or float64 in the parity tests).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import (
    IMAGENET_MEAN, IMAGENET_STD, pad_reflect_hw)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import confusion_matrix


@dataclass(frozen=True)
class EvalSpec:
    """What eval preprocessing does beyond uint8 -> [0, 1]."""
    pad: bool = False
    normalise: bool = False


def eval_spec(transforms) -> EvalSpec | None:
    """The eval spec of a config's `data.transforms` list, as the JAX
    Trainer derives it: None without "pad"; the 2px reflect pad unless
    "crop" is also listed; ImageNet normalise with "torchvision_normalise"."""
    names = [t for t in transforms if isinstance(t, str)]
    if "pad" not in names:
        return None
    return EvalSpec(pad="crop" not in names,
                    normalise="torchvision_normalise" in names)


def eval_preprocess(images_u8: torch.Tensor, spec: EvalSpec | None,
                    labels_u8: torch.Tensor | None = None):
    """uint8 NHWC -> float32 NCHW in [0, 1], the 2px vertical reflect pad
    and ImageNet normalise per `spec`; labels (NHW) -> padded int64."""
    x = images_u8.to(torch.float32) / 255.0
    pad = spec is not None and spec.pad
    if pad:
        x = pad_reflect_hw(x)
    if spec is not None and spec.normalise:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
    x = x.permute(0, 3, 1, 2).contiguous()
    if labels_u8 is None:
        return x
    lbl = labels_u8.to(torch.int64)
    if pad:
        lbl = pad_reflect_hw(lbl)
    return x, lbl


def _forward(model, x, precision: str) -> dict:
    if precision == "bf16":
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            return model(x, full_res_interm=False)
    return model(x.to(next(model.parameters()).dtype), full_res_interm=False)


def _to_device(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(dev, non_blocking=True)


def make_eval_step(spec: EvalSpec | None, num_classes: int,
                   device: str | torch.device = "cuda",
                   precision: str = "bf16"):
    """step(model, images_u8, labels_u8) -> (logits, labels, cm)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(model, images_u8, labels_u8):
        x, lbl = eval_preprocess(_to_device(images_u8, dev), spec,
                                 _to_device(labels_u8, dev))
        logits = _forward(model, x, precision)["logits"]
        return logits, lbl, confusion_matrix(logits, lbl, num_classes)

    return step


def make_eval_loss_step(loss_fn, spec: EvalSpec | None,
                        device: str | torch.device = "cuda",
                        precision: str = "bf16"):
    """step(model, images_u8, labels_u8, epoch) -> (logits, labels, cm,
    loss): the eval step plus the validation loss."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(model, images_u8, labels_u8, epoch):
        x, lbl = eval_preprocess(_to_device(images_u8, dev), spec,
                                 _to_device(labels_u8, dev))
        outputs = _forward(model, x, precision)
        total, _ = loss_fn(outputs, lbl, epoch=epoch)
        logits = outputs["logits"]
        return logits, lbl, confusion_matrix(logits, lbl), total

    return step
