"""The train step and the eval steps.

Port of `make_train_step`, `eval_preprocess`, `make_eval_step` and
`make_eval_loss_step` from the JAX package's train/steps.py. The steps are
eager functions; each puts the model in the mode it needs (train mode with
batch-statistics BatchNorm, or eval mode). They take the JAX package's
inputs — uint8 NHWC images and uint8 NHW labels, numpy or torch — and the
eval steps return NCHW float32 logits. `precision="bf16"` (the JAX
package's default) runs the forward under bf16 autocast; any other value
runs it in the model's parameter dtype (float32, or float64 in the parity
tests). The semi-supervised train step (`semi`) labels the unlabelled
half of its batch with `teacher_labels`, as the JAX package's does. With
a PointRend point head (`has_point_head`) the train step draws the
step's points from a generator seeded from (seed, step) (`step_points`)
and adds the point head's cross-entropy (`point_loss`) as the
`point_loss` term. The train, eval and eval-loss steps also run over a
spatial grid (parallel/spatial.py: `Grid`, its model ranks each holding a
band of rows).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device, taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    DeviceAugmentSpec)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
    cross_entropy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.pointrend import (
    PointDraws, PointRendDecoder, draw_points)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import (
    IMAGENET_MEAN, IMAGENET_STD, AugmentDraws, augment_batch, draw_augment,
    pad_reflect_hw, to_unit)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import confusion_matrix
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.misc import (
    clipped_argmax, downsample_labels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import (
    interp_matrix, resize_bilinear, resize_rows)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.dist import (
    DataGroup, global_batch_norm)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.spatial import (
    Grid, spatial_rows)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, global_norm)


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
    x = to_unit(images_u8)
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


def _forward(model, x, precision: str, full_res=("logits",), points=None) -> dict:
    """The model's outputs; `full_res` goes only to a model whose forward
    takes it (one that also gives stride-8 logits, such as OCRNet); the
    others always give their full-resolution logits. `points` (a train
    step's PointRend draws) goes to a model whose forward takes them."""
    params = inspect.signature(model.forward).parameters
    kwargs = ({"full_res": tuple(dict.fromkeys(full_res))}
              if "full_res" in params else {})
    if points is not None and "points" in params:
        kwargs["points"] = points
    if precision == "bf16":
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            return model(x, **kwargs)
    return model(x.to(next(model.parameters()).dtype), **kwargs)


def _loss_full_res(loss_fn) -> tuple[str, ...]:
    """The full-resolution outputs a loss reads (`build_loss` sets them)."""
    return tuple(getattr(loss_fn, "full_res", ()))


def _to_device(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(dev, non_blocking=True)


def _spatial_grid(group) -> Grid | None:
    """The spatial grid a step runs over, or None (a data group, no group,
    or a grid of one model rank, which runs the data-parallel path)."""
    return group if isinstance(group, Grid) and group.spatial else None


def band_logits(low: torch.Tensor, out_hw: tuple[int, int], rows: slice,
                align_corners: bool = True) -> torch.Tensor:
    """The `rows` of the bilinear upsample of whole low-resolution logits
    `low` to `out_hw` at `align_corners` (ops/resize.py's matrices: its
    rows of the height's, then the width's), at least float32; logits
    already at `out_hw` (FCN's, UNet's) are taken as they are."""
    low = low.to(torch.promote_types(low.dtype, torch.float32))
    if tuple(low.shape[2:]) == tuple(out_hw):
        return low[:, :, rows]
    mh = interp_matrix(low.shape[2], out_hw[0], align_corners)[rows]
    return resize_rows(low, mh, out_hw[1], align_corners)


def _upsampled(model, whole: dict, frame, precision: str, key: str = "logits",
               rows: slice = slice(None)) -> torch.Tensor:
    """The `rows` of full-resolution output `key` of a forward on the grid:
    the upsample of its whole band output (the model's `BAND_OUTPUTS`) at
    the model's `ALIGN_CORNERS`, rounded to bf16 under "bf16" as the
    model's own upsample leaves it."""
    y = band_logits(whole[model.BAND_OUTPUTS[key]], tuple(frame), rows, model.ALIGN_CORNERS)
    return y.to(torch.bfloat16).to(y.dtype) if precision == "bf16" else y


def _whole(model, outputs: dict, grid: Grid, frame, precision: str, full_res=()) -> dict:
    """`outputs` of a forward on the grid with its band outputs gathered
    whole (`BAND_OUTPUTS`) and the full-resolution outputs `full_res`
    upsampled whole from them, as JAX's `_sharded_loss` hands each device
    the logits whole over 'model'. A model whose forward takes no
    `full_res` gives all of them, as it does in one process (`_forward`)."""
    if "full_res" not in inspect.signature(model.forward).parameters:
        full_res = tuple(model.BAND_OUTPUTS)
    out = {**outputs, **{k: grid.gather_rows(outputs[k])
                         for k in model.BAND_OUTPUTS.values() if k in outputs}}
    out.update({k: _upsampled(model, out, frame, precision, k) for k in full_res})
    return out


def _spatial_eval(model, x, lbl, precision, grid: Grid, full_res=()):
    """An eval-mode forward of this rank's band of `x` on the grid: the
    outputs with the band outputs whole and `full_res` upsampled whole,
    this rank's rows of the full-resolution logits and of the labels."""
    frame = tuple(x.shape[2:])
    rows = grid.rows(frame[0])
    with spatial_rows(model, grid, frame) as framed:
        outputs = _forward(model, x[:, :, rows].contiguous(), precision, ())
    outputs = _whole(model, outputs, framed, frame, precision, full_res)
    return outputs, _upsampled(model, outputs, frame, precision, rows=rows), lbl[:, rows]


def make_eval_step(spec: EvalSpec | None, num_classes: int,
                   device: str | torch.device = "cuda",
                   precision: str = "bf16", group: Grid | None = None):
    """step(model, images_u8, labels_u8) -> (logits, labels, cm).

    Over a spatial grid (`group`) the images and labels are this rank's
    data shard of the global batch; each model rank runs its band of rows,
    gathers the low-resolution logits (the graph's `BAND_OUTPUTS`) and
    computes its rows of the full-resolution logits (`band_logits`, at the
    graph's `ALIGN_CORNERS`), which it returns with its rows of the labels;
    the matrix is summed over the grid (the global batch's)."""
    dev = resolve_device(device)
    grid = _spatial_grid(group)

    @torch.inference_mode()
    def step(model, images_u8, labels_u8):
        model.eval()
        x, lbl = eval_preprocess(_to_device(images_u8, dev), spec,
                                 _to_device(labels_u8, dev))
        if grid is not None:
            _, logits, lbl = _spatial_eval(model, x, lbl, precision, grid)
            cm = confusion_matrix(logits, lbl, num_classes)
            return logits, lbl, grid.norm.all_reduce_(cm)
        logits = _forward(model, x, precision)["logits"]
        return logits, lbl, confusion_matrix(logits, lbl, num_classes)

    return step


TTA_SCALES = (0.75, 1.0, 1.5, 1.75, 2.0)     # the reference's ttach recipe


def tta_merged_probs(forward, x: torch.Tensor, scales) -> torch.Tensor:
    """Test-time augmentation as the reference's ttach Compose(HFlip,
    Scale(scales)) (BaseManager.py:652-660): for each scale s the NCHW
    input resized to (round(h·s), round(w·s)), unflipped and flipped along
    the width; `forward(xi) -> logits` at that size, flipped back, resized
    to (h, w) (align_corners=False both ways) and softmaxed in at least
    float32; the mean over the 2·len(scales) probabilities."""
    h, w = x.shape[2:]
    probs = None
    for s in scales:
        xs = resize_bilinear(x, (int(round(h * s)), int(round(w * s))),
                             align_corners=False)
        for flip in (False, True):
            lg = forward(xs.flip(-1) if flip else xs)
            if flip:
                lg = lg.flip(-1)
            lg = lg.to(torch.promote_types(lg.dtype, torch.float32))
            p = torch.softmax(resize_bilinear(lg, (h, w), align_corners=False), dim=1)
            probs = p if probs is None else probs + p
    return probs / (2 * len(scales))


def make_tta_step(spec: EvalSpec | None, num_classes: int, scales=TTA_SCALES,
                  device: str | torch.device = "cuda", precision: str = "bf16"):
    """step(model, images_u8, labels_u8) -> (probs, labels, cm): the eval
    step with `tta_merged_probs` in place of the logits; the matrix counts
    the merged probabilities' argmax."""
    dev = resolve_device(device)
    scales = tuple(float(s) for s in scales)

    @torch.inference_mode()
    def step(model, images_u8, labels_u8):
        model.eval()
        x, lbl = eval_preprocess(_to_device(images_u8, dev), spec,
                                 _to_device(labels_u8, dev))
        probs = tta_merged_probs(lambda xi: _forward(model, xi, precision)["logits"],
                                 x, scales)
        return probs, lbl, confusion_matrix(probs, lbl, num_classes)

    return step


def make_eval_loss_step(loss_fn, spec: EvalSpec | None,
                        device: str | torch.device = "cuda",
                        precision: str = "bf16", num_classes: int | None = None,
                        group: Grid | None = None):
    """step(model, images_u8, labels_u8, epoch) -> (logits, labels, cm,
    loss): the eval step plus the validation loss. The matrix counts
    `num_classes` classes where given (the eval step's: a UNet's extra
    ignore channel is left out, as the eval step leaves it out), else the
    logits' channels. Over a spatial grid (`group`), as the eval step; the
    loss is each data shard's, from the gathered low-resolution logits (and
    their whole upsample where it reads full resolution) and the shard's
    labels, averaged over the data ranks."""
    dev = resolve_device(device)
    grid = _spatial_grid(group)

    @torch.inference_mode()
    def step(model, images_u8, labels_u8, epoch):
        model.eval()
        x, lbl = eval_preprocess(_to_device(images_u8, dev), spec,
                                 _to_device(labels_u8, dev))
        if grid is not None:
            outputs, logits, band = _spatial_eval(model, x, lbl, precision, grid,
                                                  _loss_full_res(loss_fn))
            total, _ = loss_fn(outputs, lbl, epoch=epoch)
            total = total.clone()
            grid.data.mean_([total])
            cm = grid.norm.all_reduce_(confusion_matrix(logits, band, num_classes))
            return logits, band, cm, total
        outputs = _forward(model, x, precision,
                           ("logits",) + _loss_full_res(loss_fn))
        total, _ = loss_fn(outputs, lbl, epoch=epoch)
        logits = outputs["logits"]
        return logits, lbl, confusion_matrix(logits, lbl, num_classes), total

    return step


def _grid_matrix(model, local: dict, whole: dict, lbl, grid: Grid, frame,
                 train_metrics: str, precision: str) -> torch.Tensor:
    """This rank's part of a train step's confusion matrix on the grid:
    its band of the stride-8 logits (`logits_s8`, else UPerNet's
    `logits_s8_acf`) against its rows of the downsampled labels
    (`train_metrics="s8"` and a graph that gives them), else its rows of
    the full-resolution logits against its rows of the labels, as the
    one-process step falls back for a graph without stride-8 logits."""
    s8 = local.get("logits_s8", local.get("logits_s8_acf")) \
        if train_metrics == "s8" else None
    if s8 is not None:
        _, bands = grid.band_of(s8)
        lo, hi = bands[grid.m]
        whole_lbl = downsample_labels(lbl, (bands[-1][1], s8.shape[3]))
        return confusion_matrix(s8, whole_lbl[:, lo:hi])
    rows = grid.rows(frame[0])
    return confusion_matrix(_upsampled(model, whole, frame, precision, rows=rows),
                            lbl[:, rows])


def step_draws(spec: DeviceAugmentSpec, n: int, seed: int,
               step: int) -> AugmentDraws:
    """The augmentation draws of train step `step`: a generator seeded from
    (seed, step) alone, so a step's draws do not depend on the steps before
    it (the role of the JAX step's `fold_in(rng, state.step)`)."""
    gen = torch.Generator().manual_seed(
        (int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF))
    return draw_augment(spec, n, gen)


def point_decoder(model) -> PointRendDecoder | None:
    """The model's PointRend decoder, or None."""
    return next((m for m in model.modules() if isinstance(m, PointRendDecoder)), None)


def step_points(decoder: PointRendDecoder, n: int, seed: int, step: int,
                device) -> PointDraws:
    """The PointRend draws of train step `step`: a generator seeded from
    (seed, step) alone, a stream apart from `step_draws`' (the JAX step's
    `points` key of `fold_in(rng, state.step)`)."""
    key = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF)) ^ 0x9E3779B97F4A7C15
    return draw_points(n, decoder.counts, torch.Generator().manual_seed(key), device)


def point_loss(outputs: dict, labels: torch.Tensor, task: int,
               ignore_override: int | None = None) -> torch.Tensor:
    """PointRend's auxiliary cross-entropy on the sampled points (the
    reference's EncDec_Manager.py:158-178): each point's label taken at
    cell (clip(floor(y h)), clip(floor(x w))), the (B, C, P) point logits'
    cross-entropy with the task's ignore id, or `ignore_override` (semi
    mode's pseudo-ignore id, which tasks 0 and 1 would otherwise train on)."""
    coords = outputs["point_coords"]
    n, h, w = labels.shape
    xi = torch.clamp(torch.floor(coords[..., 0] * w), 0, w - 1).long()
    yi = torch.clamp(torch.floor(coords[..., 1] * h), 0, h - 1).long()
    point_lbl = labels.reshape(n, h * w).gather(1, yi * w + xi)
    ign = taxonomy.ignore_index(task) if ignore_override is None else ignore_override
    return cross_entropy(outputs["point_logits"], point_lbl, ignore_index=ign)


def debug_batch(x: torch.Tensor, lbl: torch.Tensor, logits: torch.Tensor,
                spec: DeviceAugmentSpec) -> dict:
    """The debugging dump of a train batch: the augmented images `x` (NCHW
    float) as uint8 NHWC with ImageNet normalisation undone, the labels and
    the argmax of the full-resolution `logits`, all uint8."""
    img = x.permute(0, 2, 3, 1).float()
    if spec.normalise:
        img = (img * torch.tensor(IMAGENET_STD, device=img.device)
               + torch.tensor(IMAGENET_MEAN, device=img.device))
    return {"debug_img": (img.clamp(0.0, 1.0) * 255).to(torch.uint8),
            "debug_lbl": lbl.to(torch.uint8),
            "debug_pred": logits.argmax(dim=1).to(torch.uint8)}


def teacher_labels(model, x: torch.Tensor, precision: str, threshold: float,
                   ignore_id: int) -> torch.Tensor:
    """Pseudo-labels of the semi-supervised step: `clipped_argmax` of the
    softmax of an eval-mode forward of `model` on the augmented images `x`
    (NCHW) under `precision`, without gradient (the reference's
    torch_utils.py:7-21). BatchNorm normalises with its running statistics
    and leaves them as they were; the model is back in train mode after."""
    with torch.no_grad():
        model.eval()
        try:
            logits = _forward(model, x, precision)["logits"]
        finally:
            model.train()
        probs = torch.softmax(logits.to(torch.float32), dim=1)
        return clipped_argmax(probs, float(threshold), int(ignore_id))


def make_train_step(loss_fn, spec: DeviceAugmentSpec, task: int, *,
                    device: str | torch.device = "cuda",
                    precision: str = "bf16", train_metrics: str = "full",
                    seed: int = 0, debug_pred: bool = False,
                    has_point_head: bool = False, group: DataGroup | None = None,
                    semi: dict | None = None):
    """step(state, images_u8, labels_u8, epoch, draws=None, points=None)
    -> metrics.

    One update of `state` (train/state.py): the device augmentation of
    `spec` (draws from `step_draws(spec, n, seed, state.step)` unless
    given), the train-mode forward (bf16 autocast when `precision` is
    "bf16"), `loss_fn(outputs, labels, epoch=, step=state.step)` (the step
    seeds the Lovász dither), the backward, the optional global-norm clip
    and the optimiser update at `schedule(state.step)`; then `state.step`
    advances. Metrics, left on the device: `loss`, the loss's terms,
    `confusion_matrix` and `grad_norm` (the global L2 norm of the unclipped
    gradients). `train_metrics="s8"` counts the confusion matrix from the
    stride-8 logits (`logits_s8`, else `logits_s8_acf`) against
    `downsample_labels`, or from the full-resolution logits of a model that
    gives neither; "full" counts it from the full-resolution logits.
    `debug_pred` adds, for the debugging dumps, the augmented batch as
    uint8 NHWC (`debug_img`, ImageNet normalisation undone), its labels
    (`debug_lbl`) and the full-resolution argmax (`debug_pred`). The
    forward computes the full-resolution outputs that the loss
    (`loss_fn.full_res`) and the metrics read, and no others.

    `semi` ({"threshold", "ignore_id"}, and the JAX package's "n_shards",
    which must be the group's `n_use` where given) makes the step
    semi-supervised, as the JAX package's: each rank's block of the batch
    is [labelled half | unlabelled half] (the shard-blocked layout of JAX
    `_semi_part`), the unlabelled half's labels become `teacher_labels` of
    the augmented unlabelled images, the loss (SemiSupervisedLoss) splits
    the block the same way, and the confusion matrix counts the labelled
    halves only.

    `has_point_head` (a PointRend decoder) gives the forward the step's
    point draws (`step_points(decoder, n, seed, state.step)` unless
    `points` gives draws or the points themselves) and adds `point_loss`
    to the total and to the terms (with semi mode's `ignore_id`).

    `group` (parallel/dist.py:`DataGroup`) runs the step data-parallel, as
    the JAX step over a mesh (`_sharded_loss`): `images_u8` and `labels_u8`
    are this rank's rows of the global batch; the draws, given or drawn,
    are the global batch's, and the rank takes its rows of them; the
    BatchNorms normalise over the global batch; the loss is each rank's
    over its own rows, and the total and every term reported are their
    mean over the ranks; the gradients are averaged over the ranks (one
    all-reduce, in parameter order) before `grad_norm`, the clip and the
    update; the confusion matrix is summed over the ranks.

    `group` may also be a spatial grid (parallel/spatial.py:`Grid`, JAX's
    ("data", "model") mesh with images under P("data", "model")): each
    rank gets its data shard's whole frames, augments them with the global
    batch's draws and runs the forward on its band of the augmented rows
    (`spatial_rows`); it gathers the graph's low-resolution logits whole
    (its `BAND_OUTPUTS`: OCRNet's two stride-8 maps, stride 4 on HRNet;
    DeepLab's `logits_s8`; HRNetv2's stride-4 `logits_s4`; UPerNet's
    stride-4 `logits_s8_acf`; FCN's and UNet's full-resolution `logits`,
    taken as they are), upsamples them whole where the loss reads full
    resolution (at the graph's
    `ALIGN_CORNERS`, as JAX's `_sharded_loss` hands each device the
    logits whole over 'model') and computes its data shard's loss of them
    (the same on every model rank); the BatchNorms normalise over the
    whole grid; the gradients are summed over the model ranks and averaged
    over the data ranks; the matrix is counted from the band's rows (the
    stride-8 logits under "s8" where the graph gives them, else the
    full-resolution logits' rows) and summed over the grid. Semi mode, a
    point head and the debugging dumps stay off the grid
    (NotImplementedError). A grid of one model rank runs the data-parallel
    path over its data group."""
    grid = _spatial_grid(group)
    if isinstance(group, Grid):
        group = group.data
    if grid is not None and (semi is not None or has_point_head or debug_pred):
        raise NotImplementedError(
            "the spatial grid's train step runs without semi mode, a point head "
            "or debug_pred")
    group = group or DataGroup()
    if semi is not None and int(semi.get("n_shards", group.n_use)) != group.n_use:
        raise ValueError(f"the semi batch is laid out in {semi['n_shards']} shard "
                         f"blocks, but {group.n_use} ranks take part")
    if train_metrics not in ("s8", "full"):
        raise ValueError(f"train_metrics must be 's8' or 'full', got "
                         f"'{train_metrics}'")
    dev = resolve_device(device)
    full_res = _loss_full_res(loss_fn) + (
        () if train_metrics == "s8" and not debug_pred else ("logits",))

    def step(state: TrainState, images_u8, labels_u8, epoch,
             draws: AugmentDraws | None = None,
             points: PointDraws | torch.Tensor | None = None) -> dict:
        model = state.model
        images, labels = _to_device(images_u8, dev), _to_device(labels_u8, dev)
        n_global = images.shape[0] * group.n_use
        rows = group.local_rows(n_global)
        if draws is None:
            draws = step_draws(spec, n_global, seed, state.step)
        x, lbl = augment_batch(images, labels, spec, draws.select(rows))
        x = x.permute(0, 3, 1, 2)
        frame = tuple(x.shape[2:])
        band = grid.rows(frame[0]) if grid is not None else slice(None)
        x = x[:, :, band].contiguous()
        # the semi block's labelled samples: its first half
        half = x.shape[0] // 2 if semi is not None else x.shape[0]
        if semi is not None:
            pseudo = teacher_labels(model, x[half:], precision, semi["threshold"],
                                    semi["ignore_id"])
            lbl = torch.cat([lbl[:half], pseudo.to(lbl.dtype)])
        decoder = point_decoder(model) if has_point_head else None
        if decoder is not None and points is None:
            points = step_points(decoder, n_global, seed, state.step, dev)
        if points is not None:
            points = points.select(rows) if isinstance(points, PointDraws) \
                else points[rows]
        model.train()
        with global_batch_norm(model, group if grid is None else grid.norm), \
                spatial_rows(model, grid, frame) as framed:
            outputs = _forward(model, x, precision, full_res if grid is None else (),
                               points)
        local = outputs
        if grid is not None:
            outputs = _whole(model, outputs, framed, frame, precision,
                             _loss_full_res(loss_fn))
        total, terms = loss_fn(outputs, lbl, epoch=epoch, step=state.step)
        if has_point_head and "point_logits" in outputs:
            p_loss = point_loss(outputs, lbl, task,
                                None if semi is None else int(semi["ignore_id"]))
            terms = {**terms, "point_loss": p_loss}
            total = total + p_loss
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        with torch.no_grad():
            if grid is not None:
                grid.mean_grads_(grads)
            else:
                group.mean_(grads)
            grad_norm = global_norm(grads)
            state.apply_gradients(grads)
            s8 = outputs.get("logits_s8", outputs.get("logits_s8_acf"))
            if grid is not None:
                cm = grid.norm.all_reduce_(_grid_matrix(
                    model, local, outputs, lbl, framed, frame, train_metrics, precision))
            elif train_metrics == "s8" and s8 is not None:
                cm = group.all_reduce_(confusion_matrix(
                    s8[:half], downsample_labels(lbl[:half], s8.shape[2:])))
            else:
                cm = group.all_reduce_(confusion_matrix(outputs["logits"][:half],
                                                        lbl[:half]))
            scalars = [total.detach()] + [v.detach().to(total.dtype)
                                          for v in terms.values()]
            group.mean_(scalars)
        metrics = {"loss": scalars[0],
                   **{k: v.to(terms[k].dtype) for k, v in zip(terms, scalars[1:])},
                   "confusion_matrix": cm, "grad_norm": grad_norm}
        if debug_pred:
            with torch.no_grad():
                metrics.update(debug_batch(x, lbl, outputs["logits"], spec))
        return metrics

    return step
