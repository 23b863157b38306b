"""Config-driven loss construction (the reference's string-keyed surface).

`build_loss(loss_config, task)` returns
    loss_fn(outputs: dict, labels, *, epoch=None, step=None) -> (total, terms)
as the JAX package's does. The total back-propagates into the stride-8
logits through kernel B2 when they require a gradient (the train step),
and runs forward only under `torch.inference_mode()` (the eval steps).
This slice ports the flagship route only: TwoScaleLoss with Lovász on
both scales, `lovasz_impl: bucket`, through the
fused stride-8 kernel (losses/fused_lovasz.py). Every other route raises
NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import warnings

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device


def _warn_bucket_dial(cfg: dict) -> None:
    """`lovasz_buckets` below 1024 leaves the recipe's verified envelope."""
    b = int(cfg.get("lovasz_buckets", 2048))
    if cfg.get("lovasz_impl") == "bucket" and b < 1024:
        warnings.warn(
            f"lovasz_buckets={b} < 1024 leaves the twin-verified envelope; "
            "use >=1024 for the verified recipe", stacklevel=2)


def _dither_seed_of(cfg: dict, step):
    """Per-step dither seed when `lovasz_dither` is on: the train step's
    counter, or 0 on paths with no step (eval loss). None disables dither."""
    if not cfg.get("lovasz_dither", False):
        return None
    return step if step is not None else 0


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                               f"{item})")


def build_two_scale(cfg: dict, task: int):
    """TwoScaleLoss: weighted interm + final Lovász pair on the fused
    stride-8 route (the only TwoScale route of this slice)."""
    _warn_bucket_dial(cfg)
    interm_cfg = dict(cfg.get("interm", {"name": "CrossEntropyLoss"}))
    final_cfg = dict(cfg.get("final", {"name": "CrossEntropyLoss"}))
    w_interm = interm_cfg.get("weight", 0.4)
    w_final = final_cfg.get("weight", 1.0)

    def _is_default_lovasz(c):
        return (c["name"] == "LovaszSoftmax"
                and c.get("classes_to_consider") in (None, "present")
                and not c.get("per_image", False))

    impl = cfg.get("lovasz_impl", interm_cfg.get("lovasz_impl", "sort"))
    if not (_is_default_lovasz(interm_cfg) and _is_default_lovasz(final_cfg)
            and impl == "bucket"):
        raise _not_ported("TwoScaleLoss other than the fused bucket Lovász",
                          "items 3 and 11 (main-path and remaining losses)")
    ign = interm_cfg.get("classes_to_ignore")

    def fused_fn(interm_logits, final_logits, labels,
                 interm_s8=None, final_s8=None, step=None):
        if interm_s8 is None or final_s8 is None:
            raise _not_ported("TwoScaleLoss without stride-8 logits",
                              "item 3 (the non-fused Lovász route)")
        from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
            fused_two_scale_bucket_lovasz_s8)
        return fused_two_scale_bucket_lovasz_s8(
            interm_s8, final_s8, labels, w_interm, w_final,
            classes_to_ignore=ign,
            n_buckets=int(cfg.get("lovasz_buckets", 2048)),
            edges=cfg.get("lovasz_edges", "uniform"),
            dither_seed=_dither_seed_of(cfg, step))

    return fused_fn


def build_loss(loss_config: dict, task: int,
               device: str | torch.device = "cuda"):
    """Top-level factory keyed by loss_config['name']; returns
    loss_fn(outputs, labels, epoch=None, step=None) -> (total, term_dict).
    `device` is where the loss's inputs must lie."""
    dev = resolve_device(device)
    name = loss_config.get("name") or \
        ("LossWrapper" if "losses" in loss_config else "CrossEntropyLoss")
    cfg = dict(loss_config)
    cfg.setdefault("experiment", task)
    if name != "TwoScaleLoss":
        raise _not_ported(f"loss '{name}'", "items 3 and 11 (losses)")
    ts = build_two_scale(cfg, task)

    def two_scale_fn(outputs, labels, epoch=None, step=None):
        if labels.device.type != dev.type:
            raise ValueError(f"labels on {labels.device}, loss built for {dev}")
        v = ts(outputs.get("interm_logits"), outputs.get("logits"), labels,
               interm_s8=outputs.get("interm_logits_s8"),
               final_s8=outputs.get("logits_s8"), step=step)
        return v, {"TwoScaleLoss": v}

    return two_scale_fn
