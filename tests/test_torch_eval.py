"""The port's eval steps and `validate` against the JAX package's
`make_eval_loss_step` / `make_eval_step` and the arithmetic of its
`Trainer.validate` (tail padding, 255-masking of the padded rows, loss over
full batches only, int64 host accumulation, mIoU views, PA/PAC).

Weights: flax's OCRNet-R50-os8 parameter tree (shapes from
`jax.eval_shape` of its `init`), filled with numpy from a seed and bridged
to the port (train/bridge.py). Both sides run the model in float64 (JAX
under jax_enable_x64, precision "fp32" in the port on a float64 model), so
argmax ties cannot split them: the confusion matrices must be equal. The
loss runs in float32 inside both (B1's inputs are cast to float32) and
must agree to 1e-5; logits compare after the JAX side's NHWC -> NCHW
transpose, to 1e-6.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data.pipeline import (
    eval_batches as jax_eval_batches)
from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.ops import augment as jax_augment
from miccai2021_cataract_semantic_segmentation_tpu.ops import metrics as jax_metrics
from miccai2021_cataract_semantic_segmentation_tpu.train.state import TrainState
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_eval_loss_step as jax_eval_loss_step, make_eval_step as jax_eval_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import eval_batches
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (
    confusion_matrix, mean_iou_breakdown, pixel_accuracy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_ocrnet
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    eval_spec, make_eval_loss_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import (
    load_config, validate)

CONFIG = load_config(pathlib.Path(__file__).resolve().parents[1] / "configs"
                     / "OCRNet_rf_lvsz.json")
N_FRAMES, BS, H, W = 5, 2, 36, 64        # a padded tail batch of 1 + 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_variables(model, seed=0):
    """flax's parameter tree for `model`, filled from numpy (float64 values
    of float32 draws): lecun-normal conv kernels, non-trivial BatchNorm."""
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:                                    # bias, mean
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32).astype(np.float64)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def dataset(seed=3):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (N_FRAMES, H // 6 + 1, W // 8 + 1))
    labels = np.repeat(np.repeat(grid, 6, 1), 8, 2)[:, :H, :W].astype(np.uint8)
    images = rng.integers(0, 256, (N_FRAMES, H, W, 3), dtype=np.uint8)
    return images, labels


@pytest.fixture(scope="module")
def both():
    """JAX reference results (per-batch outputs and the validate
    arithmetic) and the port's model on the same weights."""
    graph, task = CONFIG["graph"], int(CONFIG["data"]["experiment"])
    model = jax_build_model(graph, task, dtype=jnp.float64)
    variables = numpy_variables(model)
    images, labels = dataset()
    spec = build_transform_pipeline(CONFIG["data"]["transforms"], {}, task).device
    jax.config.update("jax_enable_x64", True)
    try:
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=None, apply_fn=model.apply, tx=None)
        loss_step = jax_eval_loss_step(jax_build_loss(CONFIG["loss"], task), spec)
        plain_step = jax_eval_step(spec, 17)
        batches, n_pad = jax_eval_batches(N_FRAMES, BS)
        cm_total = np.zeros((17, 17), np.int64)
        loss_total, n_loss, first = 0.0, 0, None
        for bi, idx in enumerate(batches):
            imgs, lbls = images[idx], labels[idx]
            if n_pad and bi == len(batches) - 1:
                lbls = lbls.copy()
                lbls[BS - n_pad:] = 255          # Trainer._mask_tail_labels
                _, _, cm = plain_step(state, imgs, lbls)
            else:
                logits, lbl, cm, loss = loss_step(state, imgs, lbls, 0)
                loss_total += float(loss)
                n_loss += 1
                if first is None:
                    first = (np.asarray(logits), np.asarray(lbl),
                             np.asarray(cm), float(loss))
            cm_total += np.asarray(cm, np.int64)
    finally:
        jax.config.update("jax_enable_x64", False)
    bd = jax_metrics.mean_iou_breakdown(cm_total, task)
    pa, pac = jax_metrics.pixel_accuracy(cm_total)
    ref = {"valid_loss": loss_total / n_loss, "miou": float(bd["miou"]),
           "miou_instruments": float(bd["miou_instruments"]),
           "miou_anatomies": float(bd["miou_anatomies"]),
           "miou_rare": float(bd["miou_rare"]), "pa": float(pa),
           "pac": float(pac), "confusion_matrix": cm_total}

    port = build_model(graph, task, device="cpu").double()
    port.load_state_dict(bridge_ocrnet(variables["params"],
                                       variables["batch_stats"]), strict=True)
    return port, images, labels, first, ref


def test_eval_loss_step_matches_jax(both):
    port, images, labels, (logits_j, lbl_j, cm_j, loss_j), _ = both
    cfg = dict(CONFIG, precision="fp32")
    step = make_eval_loss_step(build_loss(cfg["loss"], 2, "cpu"),
                               eval_spec(cfg["data"]["transforms"]), "cpu",
                               cfg["precision"])
    logits, lbl, cm, loss = step(port, images[:BS], labels[:BS], 0)
    assert logits.dtype == torch.float64
    np.testing.assert_allclose(logits.numpy(), logits_j.transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lbl.numpy(), lbl_j)
    np.testing.assert_array_equal(cm.numpy(), cm_j)
    assert cm.dtype == torch.int64
    assert abs(float(loss) - loss_j) <= 1e-5


@pytest.fixture(scope="module")
def port_validate(both):
    port, images, labels, _, _ = both
    return validate(port, dict(CONFIG, precision="fp32"), images, labels,
                    device="cpu", batch_size=BS)


def test_validate_confusion_matrix_equals_jax(both, port_validate):
    ref = both[4]
    cm = port_validate["confusion_matrix"]
    assert cm.dtype == np.int64
    np.testing.assert_array_equal(cm, ref["confusion_matrix"])
    # every real (padded-label) pixel of the 5 frames is counted once
    lbl = pad_reflect_hw(torch.from_numpy(both[2]))
    assert cm.sum() == int((lbl < 17).sum())


@pytest.mark.parametrize("key", ["valid_loss", "miou", "miou_instruments",
                                 "miou_anatomies", "miou_rare", "pa", "pac"])
def test_validate_metrics_match_jax(both, port_validate, key):
    assert np.isfinite(port_validate[key])
    assert abs(port_validate[key] - both[4][key]) <= 1e-5


@pytest.mark.parametrize("n,bs", [(5, 2), (29, 8), (8, 8), (3, 8), (1, 1)])
def test_eval_batches_match_jax(n, bs):
    got, got_pad = eval_batches(n, bs)
    want, want_pad = jax_eval_batches(n, bs)
    np.testing.assert_array_equal(got, want)
    assert got_pad == want_pad


@pytest.mark.parametrize("transforms", [
    ["pad", "flip", "blur", "colorjitter"], ["flip"], ["pad", "crop"],
    ["pad", "torchvision_normalise"], ["crop", "torchvision_normalise"]])
def test_eval_spec_matches_the_trainer(transforms):
    p = build_transform_pipeline(transforms, {}, 2)
    spec = eval_spec(transforms)
    if not p.valid_pad:
        assert spec is None
    else:
        assert (spec.pad, spec.normalise) == (p.device.pad, p.device.normalise)


def test_confusion_matrix_and_scores_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 17, 11, 13)).astype(np.float32)
    labels = rng.integers(0, 18, (2, 11, 13))
    labels[0, 0] = 255                            # counted nowhere
    cm = confusion_matrix(torch.from_numpy(logits), torch.from_numpy(labels))
    want = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(labels)))
    np.testing.assert_array_equal(cm.numpy(), want)
    cm_big = rng.integers(0, 50, (17, 17)).astype(np.int64)
    cm_big[3] = 0                                 # an empty class
    np.testing.assert_array_equal(pixel_accuracy(cm_big),
                                  jax_metrics.pixel_accuracy(cm_big))
    got, want = mean_iou_breakdown(cm_big, 2), jax_metrics.mean_iou_breakdown(cm_big, 2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pad_reflect_matches_jax():
    x = np.arange(2 * 5 * 3 * 2).reshape(2, 5, 3, 2).astype(np.uint8)
    np.testing.assert_array_equal(pad_reflect_hw(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_augment.pad_reflect_hw(jnp.asarray(x))))
