"""Config-driven loss construction (the reference's string-keyed surface).

`build_loss(loss_config, task)` returns
    loss_fn(outputs: dict, labels, *, epoch=None, step=None) -> (total, terms)
as the JAX package's does; `loss_fn.full_res` names the full-resolution
outputs the loss reads from a model that also gives stride-8 logits, so
that the steps ask the forward for them and for no others. The total
back-propagates into the logits it read when they require a gradient (the
train step) and runs forward only under `torch.inference_mode()` (the eval
steps). Routes of the port:
  * TwoScaleLoss with Lovász at default options on both scales and
    `lovasz_impl: bucket`: the fused stride-8 route (losses/fused_lovasz.py,
    kernels B1/B2) when the model gives stride-8 logits, else the generic
    bucket route on the full-resolution logits;
  * LovaszSoftmax at `lovasz_impl: bucket` without `per_image`: the fused
    single-scale route (`fused_bucket_lovasz_s8`, kernels B1/B2, or B7/B8
    under CADIS_FUSED_V3=1) when the model gives its pre-upsample logits
    (`logits_s8`, upsampled with align_corners=True, else `logits_s8_acf`,
    align_corners=False), else the generic bucket route on the
    full-resolution logits;
  * TwoScaleLoss with Lovász otherwise, and LovaszSoftmax otherwise: the
    exact sort route (the default `lovasz_impl`) or the generic bucket
    route (losses/bucket_lovasz.py, kernels B3/B4) on full-resolution
    logits;
  * CrossEntropyLoss (also what an empty loss section means, and the
    TwoScaleLoss's default pair), OhemCrossEntropy, FocalLoss,
    GenDiceLoss and SoftIoU: `losses/functional.py` on the
    full-resolution logits, with the JAX package's defaults (the task's
    ignore id or `ignore_index` for cross-entropy and OHEM, `thresh` 0.7,
    `min_kept` 100,000, `gamma` 2, Focal's own `ignore_index` -1); a
    TwoScaleLoss of any other pair sums its two terms;
  * the LossWrapper (`{"losses": {name: weight}}`, the EncDec configs'
    form): the weighted sum of its terms, each routed as above with its
    options from `cfg.get(name, cfg)`; the Lovász term zeroed while
    `epoch < dc_off_at_epoch`; DenseContrastiveLoss (zeroed from
    `dc_off_at_epoch` on) and DenseContrastiveLossV2 (never gated) on the
    model's `proj_features`, else its `deep_features` with a warning
    (losses/contrastive.py);
  * SemiSupervisedLoss: the named loss on the labelled first half of the
    batch and on the pseudo-labelled second half, below-threshold pseudo
    pixels (id = the task's class count) excluded; a TwoScaleLoss there
    reads the full-resolution logits of both scales, as the JAX package
    passes no stride-8 logits to it, so a bucket Lovász takes the generic
    route (B3, and B4f in the backward), one launch per half.
"""
from __future__ import annotations

import warnings

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device, taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear

# The loss modules import the kernels, which import this package's
# bucket_edges.py: the builders below import them where they run.


def _warn_bucket_dial(cfg: dict) -> None:
    """`lovasz_buckets` below 1024 leaves the recipe's verified envelope."""
    b = int(cfg.get("lovasz_buckets", 2048))
    if cfg.get("lovasz_impl") == "bucket" and b < 1024:
        warnings.warn(
            f"lovasz_buckets={b} < 1024 leaves the twin-verified envelope; "
            "use >=1024 for the verified recipe", stacklevel=3)


def _warn_dither_unused(cfg: dict) -> None:
    """`lovasz_dither` acts on the fused stride-8 route only."""
    if cfg.get("lovasz_dither", False):
        warnings.warn(
            "lovasz_dither does nothing on the sort and generic bucket Lovász "
            "routes; only the fused stride-8 route dithers", stacklevel=3)


def _dither_seed_of(cfg: dict, step):
    """Per-step dither seed when `lovasz_dither` is on: the train step's
    counter, or 0 on paths with no step (eval loss). None disables dither."""
    if not cfg.get("lovasz_dither", False):
        return None
    return step if step is not None else 0


def _at_label_size(logits, labels):
    """Bilinear align_corners=False upsample to the labels' size (torch
    F.upsample's default in the reference's TwoScaleLoss)."""
    hw = tuple(labels.shape[-2:])
    if tuple(logits.shape[2:]) != hw:
        logits = resize_bilinear(logits, hw, align_corners=False)
    return logits


def _fusable_single(name: str, cfg: dict) -> bool:
    """A single-scale loss that takes the fused route on a model with
    pre-upsample logits (JAX `_maybe_fused_single_lovasz`'s condition)."""
    return (name == "LovaszSoftmax" and cfg.get("lovasz_impl") == "bucket"
            and not cfg.get("per_image", False))


def _maybe_fused_single_lovasz(cfg: dict, outputs: dict, labels, step=None):
    """The fused single-scale bucket Lovász on the model's pre-upsample
    logits: `logits_s8` (align_corners=True), else `logits_s8_acf`
    (align_corners=False); None where the model gives neither (the caller
    takes the generic route). The step's counter seeds the dither."""
    s8, align = outputs.get("logits_s8"), True
    if s8 is None:
        s8, align = outputs.get("logits_s8_acf"), False
    if s8 is None:
        return None
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fused_bucket_lovasz_s8)
    return fused_bucket_lovasz_s8(
        s8, labels,
        classes_to_consider=cfg.get("classes_to_consider", "present"),
        classes_to_ignore=cfg.get("classes_to_ignore"),
        n_buckets=int(cfg.get("lovasz_buckets", 2048)),
        align_corners=align,
        edges=cfg.get("lovasz_edges", "uniform"),
        dither_seed=_dither_seed_of(cfg, step))


def _single_loss(name: str, cfg: dict, task: int):
    """A (logits, labels) -> scalar closure for one named loss."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import functional as fn
    # cfg["ignore_index"] overrides the task's ignore id (the semi-supervised
    # loss sets it to the pseudo-labels' ignore id, also on task 1)
    ign = cfg.get("ignore_index", taxonomy.ignore_index(task))
    if name == "CrossEntropyLoss":
        w = cfg.get("weights")
        return lambda lg, lb: fn.cross_entropy(lg, lb, ignore_index=ign,
                                               class_weights=w)
    if name == "LovaszSoftmax":
        _warn_bucket_dial(cfg)
        return lambda lg, lb: fn.lovasz_softmax(
            lg, lb,
            classes_to_consider=cfg.get("classes_to_consider", "present"),
            classes_to_ignore=cfg.get("classes_to_ignore"),
            per_image=cfg.get("per_image", False),
            impl=cfg.get("lovasz_impl", "sort"))
    if name == "OhemCrossEntropy":
        return lambda lg, lb: fn.ohem_cross_entropy(
            lg, lb, ignore_index=ign, thresh=cfg.get("thresh", 0.7),
            min_kept=max(1, cfg.get("min_kept", 100_000)))
    if name == "FocalLoss":
        return lambda lg, lb: fn.focal_loss(
            lg, lb, gamma=cfg.get("gamma", 2.0), alpha=cfg.get("alpha"),
            ignore_index=cfg.get("ignore_index", -1))
    if name == "GenDiceLoss":
        return lambda lg, lb: fn.generalized_dice(
            lg, lb, weights=cfg.get("weights"), naive=cfg.get("naive", False))
    if name == "SoftIoU":
        return lambda lg, lb: fn.soft_iou(lg, lb, naive=cfg.get("naive", False))
    raise ValueError(f"Loss '{name}' not recognised")


def build_two_scale(cfg: dict, task: int):
    """TwoScaleLoss: weighted interm + final same-loss pair
    (TwoScaleLoss.py:9-52)."""
    _warn_bucket_dial(cfg)
    interm_cfg = dict(cfg.get("interm", {"name": "CrossEntropyLoss"}))
    final_cfg = dict(cfg.get("final", {"name": "CrossEntropyLoss"}))
    w_interm = interm_cfg.get("weight", 0.4)
    w_final = final_cfg.get("weight", 1.0)

    def _is_default_lovasz(c):
        return (c["name"] == "LovaszSoftmax"
                and c.get("classes_to_consider") in (None, "present")
                and not c.get("per_image", False))

    if _is_default_lovasz(interm_cfg) and _is_default_lovasz(final_cfg):
        from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
            fused_two_scale_lovasz)
        ign = interm_cfg.get("classes_to_ignore")
        impl = cfg.get("lovasz_impl", interm_cfg.get("lovasz_impl", "sort"))
        if impl != "bucket":
            _warn_dither_unused(cfg)

        def fused_fn(interm_logits, final_logits, labels,
                     interm_s8=None, final_s8=None, step=None):
            if impl == "bucket" and interm_s8 is not None and final_s8 is not None:
                from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
                    fused_two_scale_bucket_lovasz_s8)
                return fused_two_scale_bucket_lovasz_s8(
                    interm_s8, final_s8, labels, w_interm, w_final,
                    classes_to_ignore=ign,
                    n_buckets=int(cfg.get("lovasz_buckets", 2048)),
                    edges=cfg.get("lovasz_edges", "uniform"),
                    dither_seed=_dither_seed_of(cfg, step))
            if impl == "bucket":
                _warn_dither_unused(cfg)
            return fused_two_scale_lovasz(
                _at_label_size(_interm(interm_logits), labels), final_logits,
                labels, w_interm, w_final, classes_to_ignore=ign, impl=impl)

        fused_fn.full_res = () if impl == "bucket" else ("interm_logits", "logits")
        return fused_fn

    interm_fn = _single_loss(interm_cfg["name"], interm_cfg, task)
    final_fn = _single_loss(final_cfg["name"], final_cfg, task)
    _warn_dither_unused(cfg)

    def loss_fn(interm_logits, final_logits, labels,
                interm_s8=None, final_s8=None, step=None):
        interm_logits = _at_label_size(_interm(interm_logits), labels)
        return (w_final * final_fn(final_logits, labels)
                + w_interm * interm_fn(interm_logits, labels))

    loss_fn.full_res = ("interm_logits", "logits")
    return loss_fn


def _interm(interm_logits):
    if interm_logits is None:
        raise ValueError("TwoScaleLoss off the fused route needs the model's "
                         "full-resolution 'interm_logits'")
    return interm_logits


def _single_term(name: str, cfg: dict, task: int):
    """fn(outputs, labels, step) of one single-scale loss: the fused route
    where `cfg` and the outputs allow it, else `name` on the
    full-resolution logits; with its `full_res`."""
    fusable = _fusable_single(name, cfg)
    single = _single_loss(name, cfg, task)

    def fn(outputs, labels, step=None):
        v = _maybe_fused_single_lovasz(cfg, outputs, labels, step) if fusable else None
        if v is None:
            _warn_dither_unused(cfg)
            v = single(outputs["logits"], labels)
        return v

    # a model with pre-upsample logits need not upsample for the fused
    # route; one without them gives its full-resolution logits anyway
    fn.full_res = () if fusable else ("logits",)
    return fn


def _gated(v: torch.Tensor, epoch, off_at, before: bool) -> torch.Tensor:
    """`v`, or 0 while `epoch < off_at` (`before`) or from `off_at` on (not
    `before`). Both sides are computed, as the JAX package's `jnp.where`
    computes them. A tensor `epoch` is compared where it lies; a Python one
    on the host, its flag then filled on the device (no host-to-device
    copy, so no sync)."""
    if isinstance(epoch, torch.Tensor):
        off = ((epoch < off_at) if before else (epoch >= off_at)).to(v.device)
    else:
        off = torch.full((), (epoch < off_at) == before, dtype=torch.bool,
                         device=v.device)
    return torch.where(off, torch.zeros_like(v), v)


_DC_NAMES = ("DenseContrastiveLoss", "DenseContrastiveLossV2")


def _dense_contrastive_term(name: str, cfg: dict, task: int):
    """fn(outputs, labels) of a dense-contrastive term on the projector's
    `proj_features` (the reference's OCRNet_Manager.py:82-84), else on the
    model's `deep_features` (its EncDec manager's), with a warning: the
    un-projected backbone features are another recipe."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.contrastive import (
        dense_contrastive_loss, dense_contrastive_loss_v2)

    def fn(outputs, labels):
        feats = outputs.get("proj_features")
        if feats is None:
            feats = outputs.get("deep_features")
            if feats is None:
                raise ValueError(f"{name} needs 'proj_features' or "
                                 "'deep_features' in the model outputs")
            warnings.warn(
                f"{name}: no 'proj_features' in model outputs — falling back "
                "to raw 'deep_features' (add a 'projector' section to the "
                "graph config for the projected recipe)", stacklevel=3)
        if name == "DenseContrastiveLoss":
            return dense_contrastive_loss(feats, labels, task,
                                          temperature=cfg.get("temperature", 0.1))
        return dense_contrastive_loss_v2(feats, labels, task,
                                         temperature=cfg.get("temperature", 0.1),
                                         anchor_stride=cfg.get("anchor_stride", 4))

    fn.full_res = ()
    return fn


def _loss_wrapper(cfg: dict, task: int, check):
    """The LossWrapper (losses/LossWrapper.py of the reference): the sum of
    weight * term over `cfg["losses"]`; the LovaszSoftmax term is zero
    while `epoch < dc_off_at_epoch`, DenseContrastiveLoss from
    `dc_off_at_epoch` on (ungated when either is None), and
    DenseContrastiveLossV2 is never gated (LossWrapper.py:45-58)."""
    weightings = cfg["losses"]
    dc_off_at = cfg.get("dc_off_at_epoch")
    terms = {}
    for lname in weightings:
        sub = cfg.get(lname, cfg)
        if lname == "TwoScaleLoss":
            terms[lname] = build_two_scale(sub, task)
        elif lname in _DC_NAMES:
            terms[lname] = _dense_contrastive_term(
                lname, sub if isinstance(sub, dict) else cfg, task)
        else:
            terms[lname] = _single_term(lname, sub, task)

    def wrapper_fn(outputs, labels, epoch=None, step=None):
        check(labels)
        total, vals = 0.0, {}
        for lname, weight in weightings.items():
            if lname == "TwoScaleLoss":
                v = terms[lname](outputs.get("interm_logits"), outputs.get("logits"),
                                 labels,
                                 interm_s8=outputs.get("interm_logits_s8"),
                                 final_s8=outputs.get("logits_s8"), step=step)
            elif lname in _DC_NAMES:
                v = terms[lname](outputs, labels)
                if lname == "DenseContrastiveLoss" and dc_off_at is not None \
                        and epoch is not None:
                    v = _gated(v, epoch, dc_off_at, before=False)
            else:
                v = terms[lname](outputs, labels, step)
                if lname == "LovaszSoftmax" and dc_off_at is not None \
                        and epoch is not None:
                    v = _gated(v, epoch, dc_off_at, before=True)
            vals[lname] = v * weight
            total = total + vals[lname]
        return total, vals

    wrapper_fn.full_res = tuple(dict.fromkeys(
        k for fn in terms.values() for k in fn.full_res))
    return wrapper_fn


def build_semi_supervised(cfg: dict, task: int):
    """SemiSupervisedLoss (the reference's losses/SemiSupervisedLoss.py):
    the `labeled` loss on the first half of the batch and the `unlabeled`
    one (the same name; `labeled`'s options unless given) on the second,
    with their weights; returns fn(outputs, labels, epoch, step) -> (total,
    {"labeled", "unlabeled"}) with its `full_res`. Below-threshold
    pseudo-label pixels carry the task's class count (ops/misc.py:
    `clipped_argmax`) and are excluded on every task: cross-entropy, OHEM
    and Focal take it as `ignore_index`, Lovász as `classes_to_ignore`, a
    TwoScaleLoss on both of its terms; GenDice and SoftIoU, which have no
    ignore mechanism, are refused."""
    lab_cfg = dict(cfg.get("labeled", {"name": "CrossEntropyLoss"}))
    ulab_cfg = dict(cfg.get("unlabeled", lab_cfg))
    num_classes = taxonomy.TASK_NUM_CLASSES[task]

    def set_pseudo_ignore(c: dict) -> None:
        name = c.get("name", "CrossEntropyLoss")
        if name in ("CrossEntropyLoss", "OhemCrossEntropy", "FocalLoss"):
            c.setdefault("ignore_index", num_classes)
        elif name == "LovaszSoftmax":
            c.setdefault("classes_to_ignore", num_classes)
        elif name == "TwoScaleLoss":
            for sub in ("interm", "final"):
                c[sub] = dict(c.get(sub, {"name": "LovaszSoftmax"}))
                set_pseudo_ignore(c[sub])
        else:
            raise NotImplementedError(
                f"SemiSupervisedLoss with '{name}' is unsupported: the loss "
                "has no ignore mechanism for below-threshold pseudo-label "
                "pixels")

    for c in (lab_cfg, ulab_cfg):
        set_pseudo_ignore(c)
    if lab_cfg["name"] != ulab_cfg["name"]:
        raise NotImplementedError(
            f"different labelled/unlabelled losses ({lab_cfg['name']} vs "
            f"{ulab_cfg['name']}) are not supported (SemiSupervisedLoss.py:37)")
    w_lab, w_ulab = lab_cfg.get("weight", 1.0), ulab_cfg.get("weight", 1.0)
    two_scale = lab_cfg["name"] == "TwoScaleLoss"
    if two_scale:
        lab_fn, ulab_fn = build_two_scale(lab_cfg, task), build_two_scale(ulab_cfg, task)
    else:
        lab_fn = _single_loss(lab_cfg["name"], lab_cfg, task)
        ulab_fn = _single_loss(ulab_cfg["name"], ulab_cfg, task)

    def semi_fn(outputs, labels, epoch=None, step=None):
        h = labels.shape[0] // 2
        if two_scale:
            interm, final = _interm(outputs.get("interm_logits")), outputs["logits"]
            v_lab = lab_fn(interm[:h], final[:h], labels[:h], step=step)
            v_ulab = ulab_fn(interm[h:], final[h:], labels[h:], step=step)
        else:
            lg = outputs["logits"]
            v_lab, v_ulab = lab_fn(lg[:h], labels[:h]), ulab_fn(lg[h:], labels[h:])
        return w_lab * v_lab + w_ulab * v_ulab, {"labeled": v_lab, "unlabeled": v_ulab}

    semi_fn.full_res = ("interm_logits", "logits") if two_scale else ("logits",)
    return semi_fn


def build_loss(loss_config: dict, task: int,
               device: str | torch.device = "cuda"):
    """Top-level factory keyed by loss_config['name']; returns
    loss_fn(outputs, labels, epoch=None, step=None) -> (total, term_dict)
    with its `full_res`. `device` is where the loss's inputs must lie."""
    dev = resolve_device(device)
    name = loss_config.get("name") or \
        ("LossWrapper" if "losses" in loss_config else "CrossEntropyLoss")
    cfg = dict(loss_config)
    cfg.setdefault("experiment", task)

    def check(labels):
        if labels.device.type != dev.type:
            raise ValueError(f"labels on {labels.device}, loss built for {dev}")

    if name == "TwoScaleLoss":
        ts = build_two_scale(cfg, task)

        def two_scale_fn(outputs, labels, epoch=None, step=None):
            check(labels)
            v = ts(outputs.get("interm_logits"), outputs.get("logits"), labels,
                   interm_s8=outputs.get("interm_logits_s8"),
                   final_s8=outputs.get("logits_s8"), step=step)
            return v, {"TwoScaleLoss": v}

        two_scale_fn.full_res = ts.full_res
        return two_scale_fn
    if name == "LossWrapper":
        return _loss_wrapper(cfg, task, check)
    if name == "SemiSupervisedLoss":
        semi = build_semi_supervised(cfg, task)

        def semi_loss_fn(outputs, labels, epoch=None, step=None):
            check(labels)
            return semi(outputs, labels, epoch=epoch, step=step)

        semi_loss_fn.full_res = semi.full_res
        return semi_loss_fn
    term = _single_term(name, cfg, task)

    def single_fn(outputs, labels, epoch=None, step=None):
        check(labels)
        v = term(outputs, labels, step)
        return v, {name: v}

    single_fn.full_res = term.full_res
    return single_fn
