"""The port's HRNetv2 slice against the JAX package: the graph through the
weight bridge, one whole train step with the single-scale `LovaszSoftmax`
at `lovasz_impl: bucket` (the generic route, B3 forward and B4 backward),
and the two faults this slice repaired in the train step and the loss.

One module-scoped JAX fixture builds HRNetv2 at width 4 in float64 from
numpy-filled weights (`numpy_variables`), runs its eval forward and one
JAX train step (Adam at the recipe's LR, pad-only augmentation) on a
2x64x96 batch. Tolerances: the float64 forward to 1e-6; the train step as
tests/test_torch_train.py holds the OCRNet step (the loss runs in float32
inside both: loss 1e-5, gradients 1e-5 relative L2, new parameters 1e-6,
a hundredth of lr, BatchNorm statistics 1e-6, the confusion matrix equal).
"""
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.ops.metrics import (
    confusion_matrix as jax_confusion_matrix)
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train.port_torch import port_state_dict
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
    cross_entropy, lovasz_softmax)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
    fused_bucket_lovasz_s8)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import lr_schedule as lr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_hrnet
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    make_eval_loss_step, make_train_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
    train_metrics_source, train_steps)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import (
    load_config, validate)
from test_torch_eval import numpy_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPH = {"model": "HRNetv2", "width": 4}
LOSS = {"name": "LovaszSoftmax", "lovasz_impl": "bucket"}
# the recipe of configs/DeepLabv3_rf_lvsz.json with the slice's graph and loss
CONFIG = dict(load_config(ROOT / "configs" / "DeepLabv3_rf_lvsz.json"),
              graph=GRAPH, loss=LOSS)
N_IMG, H, W = 2, 64, 96


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def batch(seed=8, h=H, w=W):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (N_IMG, h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    images = rng.integers(0, 256, (N_IMG, h, w, 3), dtype=np.uint8)
    return images, labels


@pytest.fixture(scope="module")
def jax_hrnet():
    """float64 JAX HRNetv2: its variables, the eval forward of one seeded
    input, and one train step (bucket Lovász, s8 train metrics as the
    Trainer picks them, which fall back to full resolution)."""
    model = jax_build_model(GRAPH, 2, dtype=jnp.float64)
    variables = numpy_variables(model, seed=2)
    x = np.random.default_rng(7).standard_normal((N_IMG, H, W, 3))
    images, labels = batch()
    spec = build_transform_pipeline(["pad"], {}, 2).device
    jax.config.update("jax_enable_x64", True)
    try:
        logits = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, jnp.asarray(x))["logits"])
        tx = jax_make_optimizer(CONFIG["train"], jlr.make_schedule(CONFIG["train"], 1))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              apply_fn=model.apply, tx=tx)
        step = jax_make_train_step(jax_build_loss(LOSS, 2), spec, 2, donate=False,
                                   train_metrics=train_metrics_source(CONFIG))
        new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                                  jax.random.PRNGKey(0), 0)
        mu = new_state.opt_state[0].mu          # (1 - b1) * g after one update
        result = {
            "metrics": jax.tree.map(np.asarray, metrics),
            "grads": jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), mu),
            "params": jax.tree.map(np.asarray, new_state.params),
            "stats": jax.tree.map(np.asarray, new_state.batch_stats),
        }
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, x, logits, images, labels, result


def _port(variables):
    port = build_model(GRAPH, 2, device="cpu").double()
    port.load_state_dict(bridge_hrnet(variables["params"],
                                      variables["batch_stats"]), strict=True)
    return port


def test_hrnet_eval_forward_matches_jax_f64(jax_hrnet):
    variables, x, want, *_ = jax_hrnet
    port = _port(variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
    assert set(got) == {"logits"} and got["logits"].dtype == torch.float64
    np.testing.assert_allclose(got["logits"].numpy(), want.transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    assert all(isinstance(m, BatchNorm2d) and m.momentum == 0.01
               for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d))


def test_hrnet_bridge_round_trips_through_port_state_dict(jax_hrnet):
    """The JAX package's own porter, applied to the bridge's output, gives
    back the flax tree on every leaf; the names are the reference's."""
    variables = jax_hrnet[0]
    sd = bridge_hrnet(variables["params"], variables["batch_stats"])
    for key in ("conv1.weight", "bn2.running_var", "layer1.0.downsample.0.weight",
                "transition1.0.0.weight", "transition1.1.0.1.running_mean",
                "stage3.0.branches.2.3.conv2.weight",
                "stage4.0.fuse_layers.0.3.1.weight",
                "stage4.0.fuse_layers.3.0.2.1.running_var",
                "last_layer.0.bias", "last_layer.3.weight"):
        assert key in sd, key
    zeros = jax.tree.map(np.zeros_like, (variables["params"], variables["batch_stats"]))
    p2, s2 = port_state_dict("HRNetv2", {k: v.numpy() for k, v in sd.items()}, *zeros)
    for want, got in ((variables["params"], p2), (variables["batch_stats"], s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, v in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), v,
                                          err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def port_step(jax_hrnet):
    variables, *_, images, labels, _ = jax_hrnet
    port = _port(variables)
    state = TrainState(port, make_optimizer(CONFIG["train"], port.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))
    step = make_train_step(build_loss(LOSS, 2, "cpu"), device_spec(["pad"]), 2,
                           device="cpu", precision="fp32",
                           train_metrics=train_metrics_source(CONFIG))
    reset_launches()
    metrics = step(state, images, labels, 0)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    return state, metrics


def test_hrnet_train_step_matches_jax(jax_hrnet, port_step):
    """Loss, term, grad_norm and the full-resolution confusion matrix; every
    parameter's gradient within 1e-5 relative L2; the new parameters to
    1e-6 and the new BatchNorm statistics (momentum 0.99 in flax) to 1e-6."""
    variables, *_, want = jax_hrnet
    state, got = port_step
    assert train_metrics_source(CONFIG) == "s8" and state.step == 1
    assert set(got) == {"loss", "LovaszSoftmax", "confusion_matrix", "grad_norm"}
    for key in ("loss", "LovaszSoftmax"):
        assert abs(float(got[key]) - float(want["metrics"][key])) <= 1e-5
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(),
                                  want["metrics"]["confusion_matrix"])
    assert int(got["confusion_matrix"].sum()) > 0
    assert abs(float(got["grad_norm"]) / float(want["metrics"]["grad_norm"]) - 1) <= 1e-5
    port = state.model
    want_grads = bridge_hrnet(want["grads"], {})
    scale = np.sqrt(sum(float((p.grad ** 2).sum()) for p in port.parameters()))
    for key, p in port.named_parameters():
        w = want_grads[key].numpy()
        if np.linalg.norm(w) > 1e-9 * scale:
            assert rel_l2(p.grad.numpy(), w) <= 1e-5, key
        else:       # a convolution bias that feeds a BatchNorm: exactly 0
            assert np.linalg.norm(p.grad.numpy() - w) <= 1e-9 * scale, key
    sd = port.state_dict()
    for key, v in bridge_hrnet(want["params"], want["stats"]).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)


def test_hrnet_train_steps_and_validate_run_the_slice():
    """`train_steps` and `validate` on HRNetv2 with the bucket Lovász: the
    loss falls on a repeated batch, every label is counted, and the CPU
    path launches no kernel."""
    images, labels = batch(9, 32, 48)
    model = build_model(GRAPH, 2, device="cpu")
    cfg = dict(CONFIG, precision="fp32")
    reset_launches()
    res = train_steps(model, cfg, images, labels, [np.array([0, 1])] * 4,
                      device="cpu", seed=1)
    assert res["state"].step == 4 and all(np.isfinite(res["step_losses"]))
    assert res["step_losses"][-1] < res["step_losses"][0]
    padded = np.pad(labels, ((0, 0), (2, 2), (0, 0)), mode="reflect")
    assert res["confusion_matrix"].sum() == 4 * int((padded < 17).sum())
    val = validate(model, cfg, images, labels, device="cpu", batch_size=1)
    assert np.isfinite(val["valid_loss"]) and val["confusion_matrix"].sum() > 0
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


class _LogitsOnly(torch.nn.Module):
    """A model whose outputs hold only full-resolution logits, though its
    forward takes `full_res` (it records what it was asked for)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 17, 1)
        self.asked = []

    def forward(self, x, full_res=("logits",)):
        self.asked.append(tuple(full_res))
        return {"logits": self.conv(x)}


def test_s8_train_metrics_fall_back_to_full_resolution():
    """Repair: `train_metrics="s8"` on a model without stride-8 logits
    counts the confusion matrix from the full-resolution logits, as the JAX
    step does (the parent raised KeyError on `logits_s8`)."""
    images, labels = batch(3)
    model = _LogitsOnly().double()
    state = TrainState(model, make_optimizer(CONFIG["train"], model.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))

    def loss_fn(outputs, lbl, epoch=None, step=None):
        v = outputs["logits"].float().square().mean()
        return v, {"l2": v}

    step = make_train_step(loss_fn, device_spec(["pad"]), 2, device="cpu",
                           precision="fp32", train_metrics="s8")
    with torch.no_grad():
        x = torch.from_numpy(np.pad(images, ((0, 0), (2, 2), (0, 0), (0, 0)),
                                    mode="reflect")).double() * (1.0 / 255.0)
        logits = model(x.permute(0, 3, 1, 2).contiguous())["logits"]
    lbl = np.pad(labels, ((0, 0), (2, 2), (0, 0)), mode="reflect")
    got = step(state, images, labels, 0)["confusion_matrix"].numpy()
    want = np.asarray(jax_confusion_matrix(
        jnp.asarray(logits.permute(0, 2, 3, 1).numpy()), jnp.asarray(lbl)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == int((lbl < 17).sum())
    assert model.asked[-1] == ()           # the s8 step asks for no upsample


@pytest.mark.parametrize("loss,train_metrics,asked", [
    # the fused TwoScale route reads the stride-8 logits only
    ({"name": "TwoScaleLoss", "lovasz_impl": "bucket",
      "interm": {"name": "LovaszSoftmax"}, "final": {"name": "LovaszSoftmax"}},
     "s8", ()),
    # the generic TwoScale routes read both full-resolution outputs
    ({"name": "TwoScaleLoss", "interm": {"name": "LovaszSoftmax"},
      "final": {"name": "LovaszSoftmax"}}, "s8", ("interm_logits", "logits")),
    ({"name": "TwoScaleLoss", "lovasz_impl": "bucket",
      "interm": {"name": "LovaszSoftmax", "per_image": True},
      "final": {"name": "LovaszSoftmax"}}, "full", ("interm_logits", "logits")),
    ({"name": "LovaszSoftmax"}, "s8", ("logits",)),
])
def test_train_step_asks_for_the_outputs_the_loss_reads(loss, train_metrics, asked):
    model = _LogitsOnly()
    step = make_train_step(build_loss(loss, 2, "cpu"), device_spec(["pad"]), 2,
                           device="cpu", precision="fp32",
                           train_metrics=train_metrics)
    state = TrainState(model, make_optimizer(CONFIG["train"], model.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))
    images, labels = batch(4, 16, 24)
    if "interm_logits" in asked or not asked:   # the stub has neither
        with pytest.raises(ValueError, match="interm_logits"):
            step(state, images, labels, 0)
    else:
        step(state, images, labels, 0)
    assert set(model.asked[-1]) == set(asked)


def test_dither_warns_on_the_routes_that_ignore_it():
    """Repair: `lovasz_dither` does nothing off the fused stride-8 route,
    and says so (the parent had no such route to warn on)."""
    x = torch.randn(1, 17, 8, 16)
    lbl = torch.randint(0, 18, (1, 8, 16))
    two = {"name": "TwoScaleLoss", "interm": {"name": "LovaszSoftmax"},
           "final": {"name": "LovaszSoftmax"}, "lovasz_dither": True}
    with pytest.warns(UserWarning, match="lovasz_dither does nothing"):
        build_loss(dict(two, lovasz_impl="sort"), 2, "cpu")
    fused = build_loss(dict(two, lovasz_impl="bucket"), 2, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a single loss warns when it runs
        sort = build_loss({"name": "LovaszSoftmax", "lovasz_dither": True}, 2, "cpu")
        single = build_loss(dict(LOSS, lovasz_dither=True), 2, "cpu")
    for loss, outputs in ((sort, {"logits": x, "logits_s8": x[..., ::8, ::8]}),
                          (fused, {"logits": x, "interm_logits": x}),
                          (single, {"logits": x})):
        with pytest.warns(UserWarning, match="lovasz_dither does nothing"):
            loss(outputs, lbl)
    s8 = torch.randn(1, 17, 2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # the fused routes dither
        fused({"logits_s8": s8, "interm_logits_s8": s8}, lbl, step=3)
        single({"logits": x, "logits_s8": s8}, lbl, step=3)
        build_loss(dict(LOSS), 2, "cpu")


def test_single_bucket_lovasz_on_stride8_logits_raises():
    """The single-scale bucket Lovász on a model with pre-upsample logits
    takes the fused route (it raised before that route was ported): from
    `logits_s8` with align_corners=True, else from `logits_s8_acf` with
    align_corners=False, never the generic route's different function.
    The LossWrapper form of the same loss takes the same route;
    cross-entropy (ported since) reads the full-resolution logits; the
    losses of later slices still raise."""
    x = torch.randn(1, 17, 16, 16)
    lbl = torch.randint(0, 18, (1, 16, 16))
    s8 = x[..., ::8, ::8].contiguous()
    loss = build_loss(LOSS, 2, "cpu")
    assert loss.full_res == ()
    for key, align in (("logits_s8", True), ("logits_s8_acf", False)):
        got = float(loss({"logits": x, key: s8}, lbl)[0])
        assert got == float(fused_bucket_lovasz_s8(s8, lbl, align_corners=align))
    generic = float(loss({"logits": x}, lbl)[0])
    assert generic == float(lovasz_softmax(x, lbl, impl="bucket"))
    per_image = build_loss(dict(LOSS, per_image=True), 2, "cpu")
    assert per_image.full_res == ("logits",)
    assert float(per_image({"logits": x, "logits_s8": s8}, lbl)[0]) == float(
        lovasz_softmax(x, lbl, per_image=True, impl="bucket"))
    with pytest.raises(NotImplementedError, match="item 11"):
        build_loss({"name": "SemiSupervisedLoss"}, 2, "cpu")
    ce = build_loss({"name": "CrossEntropyLoss"}, 2, "cpu")    # ported since
    assert ce.full_res == ("logits",)
    assert float(ce({"logits": x, "logits_s8": s8}, lbl)[0]) == float(
        cross_entropy(x, lbl, ignore_index=17))
    wrapper = build_loss({"losses": {"LovaszSoftmax": 1.0}, "lovasz_impl": "bucket"},
                         2, "cpu")
    assert wrapper.full_res == ()
    assert float(wrapper({"logits": x, "logits_s8_acf": s8}, lbl)[0]) == float(
        fused_bucket_lovasz_s8(s8, lbl, align_corners=False))
    with pytest.raises(NotImplementedError, match="item 11"):
        build_loss({"losses": {"DenseContrastiveLoss": 1.0}}, 2, "cpu")


def test_eval_loss_step_asks_for_the_outputs_the_loss_reads():
    model = _LogitsOnly()
    loss = build_loss({"name": "TwoScaleLoss", "interm": {"name": "LovaszSoftmax"},
                       "final": {"name": "LovaszSoftmax"}}, 2, "cpu")
    step = make_eval_loss_step(loss, None, "cpu", "fp32")
    images, labels = batch(5, 16, 24)
    with pytest.raises(ValueError, match="interm_logits"):
        step(model, images, labels, 0)
    assert set(model.asked[-1]) == {"logits", "interm_logits"}
