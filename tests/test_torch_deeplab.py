"""The port's DeepLabv3/v3+ slice against the JAX package: the graphs
through the weight bridge, one whole DeepLabv3 train step on the fused
single-scale bucket Lovász (B1 forward and B2 backward at R = C rows), the
single-scale loss itself over its options, and the loss's routing.

Module-scoped JAX fixtures build DeepLabv3 and DeepLabv3+ (ResNet-50,
out_stride 8) in float64 from numpy-filled weights (`numpy_variables`),
run their eval forwards and, for DeepLabv3, one JAX train step (Adam at
the recipe's LR, pad-only augmentation) on a 2x64x96 batch; the JAX
Pallas kernels run in interpret mode, as the JAX package's tests run them.
Tolerances: the float64 forwards to 1e-6; the train step as
tests/test_torch_hrnet.py holds HRNetv2's (the loss runs in float32 inside
both: loss 1e-5, gradients 1e-5 relative L2, new parameters to 1e-12 of
Adam's first step from the port's own gradient and to 1e-6 of JAX's
except where 0 < |g| <= Adam's eps, BatchNorm statistics 1e-6, the s8
confusion matrix equal); the single-scale loss to 1e-6 and its gradient to 1e-5 relative L2,
its counts exact where both sides compute the same probabilities and
within 1e-3 of the counted pairs (L1) elsewhere.
"""
import pathlib
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.losses import fused_lovasz as jfl
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models.deeplab import (
    _dilate_stages as jax_dilate_stages)
from miccai2021_cataract_semantic_segmentation_tpu.ops.resize import (
    _interp_matrix as jax_interp_matrix)
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
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import fused_lovasz as fl
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import lovasz_softmax
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.deeplab import (
    ASPP_BN_EPS, dilate_stages)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import interp_matrix
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import lr_schedule as lr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_deeplabv3, bridge_deeplabv3plus)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
    train_metrics_source)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
from test_torch_eval import numpy_variables
from test_torch_nchw import use_v3

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS = {"name": "LovaszSoftmax", "lovasz_impl": "bucket"}
# the recipe of configs/DeepLabv3_rf_lvsz.json with the bucket Lovász
CONFIG = dict(load_config(ROOT / "configs" / "DeepLabv3_rf_lvsz.json"), loss=LOSS)
BRIDGES = {"DeepLabv3": bridge_deeplabv3, "DeepLabv3Plus": bridge_deeplabv3plus}
N_IMG, H, W = 2, 64, 96


def graph(name):
    return {"model": name, "backbone": "resnet50", "out_stride": 8}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def batch(seed=8, h=H, w=W):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (N_IMG, h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    images = rng.integers(0, 256, (N_IMG, h, w, 3), dtype=np.uint8)
    return images, labels


def _jax_forward(name, seed):
    model = jax_build_model(graph(name), 2, dtype=jnp.float64)
    variables = numpy_variables(model, seed=seed)
    x = np.random.default_rng(7).standard_normal((N_IMG, H, W, 3))
    out = jax.jit(lambda v, x: model.apply(v, x, False))(variables, jnp.asarray(x))
    return model, variables, x, {k: np.asarray(out[k]) for k in ("logits", "logits_s8")}


@pytest.fixture(scope="module")
def jax_deeplab():
    """float64 JAX DeepLabv3 and DeepLabv3+: their variables and the eval
    forward of one seeded input; for DeepLabv3 also one train step (the
    fused single-scale bucket Lovász, s8 train metrics as the Trainer picks
    them)."""
    images, labels = batch()
    spec = build_transform_pipeline(["pad"], {}, 2).device
    jax.config.update("jax_enable_x64", True)
    try:
        runs = {name: _jax_forward(name, seed) for name, seed in
                (("DeepLabv3", 2), ("DeepLabv3Plus", 3))}
        model, variables, *_ = runs["DeepLabv3"]
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
        train = {
            "metrics": jax.tree.map(np.asarray, metrics),
            "grads": jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), mu),
            "params": jax.tree.map(np.asarray, new_state.params),
            "stats": jax.tree.map(np.asarray, new_state.batch_stats),
        }
    finally:
        jax.config.update("jax_enable_x64", False)
    return {name: run[1:] for name, run in runs.items()}, images, labels, train


def _port(name, variables):
    port = build_model(graph(name), 2, device="cpu").double()
    port.load_state_dict(BRIDGES[name](variables["params"],
                                       variables["batch_stats"]), strict=True)
    return port


@pytest.mark.parametrize("name", list(BRIDGES))
def test_deeplab_eval_forward_matches_jax_f64(jax_deeplab, name):
    """`logits` and the pre-upsample `logits_s8` (stride 8 for v3, stride
    4 for v3+) within 1e-6 of flax; `full_res=()` leaves out the
    full-resolution upsample and nothing else."""
    variables, x, want = jax_deeplab[0][name]
    port = _port(name, variables).eval()
    with torch.no_grad():
        got = port(nchw(x))
        s8_only = port(nchw(x), full_res=())
    assert set(got) == {"logits", "logits_s8", "deep_features"}
    assert set(s8_only) == {"logits_s8", "deep_features"}
    stride = 4 if name == "DeepLabv3Plus" else 8
    assert got["logits_s8"].shape == (N_IMG, 17, H // stride, W // stride)
    for key in ("logits", "logits_s8"):
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), want[key].transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-6, err_msg=key)
    assert torch.equal(s8_only["logits_s8"], got["logits_s8"])
    eps = {m.eps for key, m in port.named_modules() if isinstance(m, torch.nn.BatchNorm2d)
           and key.startswith(("aspp.", "decoder."))}
    assert eps == {ASPP_BN_EPS}
    assert all(isinstance(m, BatchNorm2d) for m in port.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("name", list(BRIDGES))
def test_deeplab_bridge_round_trips_through_port_state_dict(jax_deeplab, name):
    """The JAX package's own porter, applied to the bridge's output, gives
    back the flax tree on every leaf; the names are the reference's."""
    variables = jax_deeplab[0][name][0]
    sd = BRIDGES[name](variables["params"], variables["batch_stats"])
    keys = ["backbone.conv1.weight", "backbone.layer4.2.bn3.running_var",
            "aspp.aspp1.weight", "aspp.aspp4_bn.running_mean", "aspp.aspp5.weight",
            "aspp.conv2.weight", "aspp.bn2.bias"]
    keys += (["decoder.conv_low.weight", "decoder.conv_low_bn.running_var",
              "decoder.conv_3x3_1.weight", "decoder.conv_3x3_2_bn.weight",
              "decoder.conv_out.bias"] if name == "DeepLabv3Plus"
             else ["conv_out.weight", "conv_out.bias"])
    for key in keys:
        assert key in sd, key
    zeros = jax.tree.map(np.zeros_like, (variables["params"], variables["batch_stats"]))
    p2, s2 = port_state_dict(name, {k: v.numpy() for k, v in sd.items()}, *zeros)
    for want, got in ((variables["params"], p2), (variables["batch_stats"], s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, v in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), v,
                                          err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def port_step(jax_deeplab):
    variables, _, _ = jax_deeplab[0]["DeepLabv3"]
    _, images, labels, _ = jax_deeplab
    port = _port("DeepLabv3", variables)
    state = TrainState(port, make_optimizer(CONFIG["train"], port.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))
    step = make_train_step(build_loss(LOSS, 2, "cpu"), device_spec(["pad"]), 2,
                           device="cpu", precision="fp32",
                           train_metrics=train_metrics_source(CONFIG))
    reset_launches()
    metrics = step(state, images, labels, 0)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    return state, metrics


def test_deeplab_train_step_matches_jax(jax_deeplab, port_step):
    """Loss, term, grad_norm and the s8 confusion matrix; every parameter's
    gradient within 1e-5 relative L2; every new parameter to 1e-12 of
    Adam's first step from the port's own gradient, and to 1e-6 of JAX's
    except where 0 < |g| <= Adam's eps (at most 0.1 % of the elements);
    the new BatchNorm statistics to 1e-6, the image-pool branch's
    `aspp5_bn` (n = N values per channel) among them."""
    want = jax_deeplab[3]
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
    want_grads = bridge_deeplabv3(want["grads"], {})
    scale = np.sqrt(sum(float((p.grad ** 2).sum()) for p in port.parameters()))
    for key, p in port.named_parameters():
        w = want_grads[key].numpy()
        if np.linalg.norm(w) > 1e-9 * scale:
            assert rel_l2(p.grad.numpy(), w) <= 1e-5, key
        else:
            assert np.linalg.norm(p.grad.numpy() - w) <= 1e-9 * scale, key
    sd = port.state_dict()
    new = bridge_deeplabv3(want["params"], want["stats"])
    old = bridge_deeplabv3(*(jax_deeplab[0]["DeepLabv3"][0][k]
                             for k in ("params", "batch_stats")))
    assert "aspp.aspp5_bn.running_var" in new
    lr_ = state.optimizer.param_groups[0]["lr"]
    assert abs(lr_ / float(jlr.make_schedule(CONFIG["train"], 1)(0)) - 1) <= 1e-6
    params = dict(port.named_parameters())
    n_near = n_all = 0
    for key, v in new.items():
        if key.endswith("num_batches_tracked"):
            continue
        got, v = sd[key].numpy(), v.numpy()
        if key not in want_grads:               # BatchNorm statistics
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-6, err_msg=key)
            continue
        # Adam's first update is lr * g / (|g| + 1e-8): the port's own step
        # from its own gradient, to rounding
        g = params[key].grad.numpy()
        np.testing.assert_allclose(got, old[key].numpy() - lr_ * g / (np.abs(g) + 1e-8),
                                   rtol=0, atol=1e-12, err_msg=key)
        # against JAX's new parameters except where 0 < |g| <= 1e-8, Adam's
        # eps: there the step lr * g / (|g| + eps) follows the float32 loss's
        # rounding in g and may lie anywhere within lr (the gradient check
        # above holds those g); they are a few in ten thousand
        g_jax = want_grads[key].numpy()
        near_eps = (g_jax != 0) & (np.abs(g_jax) <= 1e-8)
        n_near, n_all = n_near + int(near_eps.sum()), n_all + near_eps.size
        np.testing.assert_allclose(got[~near_eps], v[~near_eps], rtol=0, atol=1e-6,
                                   err_msg=key)
    assert n_near <= 1e-3 * n_all, (n_near, n_all)


def test_deeplabv3plus_s8_metric_counts_the_stride4_grid():
    """The `s8` train metric counts v3+'s stride-4 `logits_s8` against the
    labels sampled to that grid, as the JAX step does; the step asks the
    model for no full-resolution upsample."""
    images, labels = batch(5, 32, 48)
    model = build_model(graph("DeepLabv3Plus"), 2, device="cpu")
    state = TrainState(model, make_optimizer(CONFIG["train"], model.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))
    step = make_train_step(build_loss(LOSS, 2, "cpu"), device_spec(["pad"]), 2,
                           device="cpu", precision="fp32", train_metrics="s8")
    cm = step(state, images, labels, 0)["confusion_matrix"].numpy()
    padded = np.pad(labels, ((0, 0), (2, 2), (0, 0)), mode="reflect")
    h, w = 9, 12                # 36 x 48 at stride 4, the stem rounding up
    yi = np.floor((np.arange(h) + 0.5) * (padded.shape[1] / h)).astype(int)
    xi = np.floor((np.arange(w) + 0.5) * (padded.shape[2] / w)).astype(int)
    assert cm.sum() == int((padded[:, yi][:, :, xi] < 17).sum())


@pytest.mark.parametrize("out_stride", [8, 16, 32])
def test_dilate_stages_match_jax(out_stride):
    assert dilate_stages(out_stride) == jax_dilate_stages(out_stride)


@pytest.mark.parametrize("n_out,align", [(1, True), (7, True), (7, False)])
def test_interp_matrix_from_one_matches_jax(n_out, align):
    """The image-pool branch upsamples from 1x1: every output copies the
    one input."""
    got = interp_matrix(1, n_out, align)
    np.testing.assert_array_equal(got, jax_interp_matrix(1, n_out, align))
    np.testing.assert_array_equal(got, np.ones((n_out, 1)))


# ---------------------------------------------------------------------------
# the single-scale fused bucket Lovász (v4; v3 under CADIS_FUSED_V3)
# ---------------------------------------------------------------------------

S1 = (2, 9, 16, 5, 68, 120)        # N, hs, ws, C, H, W
S17 = (2, 9, 12, 17, 67, 93)

SINGLE_CASES = {
    # shape, align, classes_to_consider, classes_to_ignore, dither, B, edges
    "c5-align-present-adaptive-dither5-1024": (S1, True, "present", None, 5, 1024,
                                               "adaptive"),
    "c5-acf-all-256": (S1, False, "all", None, None, 256, "uniform"),
    "c17-align-list-ignore3-2048": (S17, True, [0, 3, 5, 16], 3, None, 2048, "uniform"),
    "c17-acf-none-dither7-1024": (S17, False, None, None, 7, 1024, "uniform"),
}


def single_inputs(name):
    (n, hs, ws, c, h, w), *_ = SINGLE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    lg = (3.0 * rng.standard_normal((n, hs, ws, c))).astype(np.float32)
    grid = rng.integers(0, c + 1, (n, h // 4 + 1, w // 4 + 1))
    labels = np.repeat(np.repeat(grid, 4, 1), 4, 2)[:, :h, :w]
    labels[0, :3] = c
    return lg, labels.astype(np.uint8)


@pytest.mark.parametrize("v3", [False, True], ids=["v4", "v3"])
@pytest.mark.parametrize("name", list(SINGLE_CASES))
def test_single_scale_loss_and_gradient_match_jax(name, v3):
    """`fused_bucket_lovasz_s8` against the JAX package's, loss and
    jax.grad of its custom VJP, on the default route (B1/B2's plain
    versions) and the v3 one (B7/B8's); v3 refuses dither on both sides."""
    shape, align, consider, ignore, dseed, nb, edges = SINGLE_CASES[name]
    lg, labels = single_inputs(name)
    kw = dict(classes_to_consider=consider, classes_to_ignore=ignore,
              n_buckets=nb, align_corners=align, edges=edges, dither_seed=dseed)
    if v3 and dseed is not None:
        with use_v3(True):
            for fn, args in ((jfl.fused_bucket_lovasz_s8, (jnp.asarray(lg), labels)),
                             (fl.fused_bucket_lovasz_s8,
                              (nchw(lg), torch.from_numpy(labels)))):
                with pytest.raises(ValueError, match="CADIS_FUSED_V3"):
                    fn(*args, **kw)
        kw["dither_seed"] = None
    warns = kw["dither_seed"] is not None and edges != "uniform"

    def jloss(a):
        return jfl.fused_bucket_lovasz_s8(a, jnp.asarray(labels), **kw)

    with use_v3(v3), pytest.warns(UserWarning, match="adaptive") if warns \
            else nullcontext():
        want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(lg))
        want, want_g = float(want), np.asarray(want_g).transpose(0, 3, 1, 2)
        t = nchw(lg).requires_grad_(True)
        reset_launches()
        loss = fl.fused_bucket_lovasz_s8(t, torch.from_numpy(labels), **kw)
        loss.backward()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want) <= 1e-6
    assert rel_l2(t.grad.numpy(), want_g) <= 1e-5


def _counts(name_or_inputs, align, nb, edges="uniform", dither=None):
    """(port, JAX) (C, B, 4) single-scale histograms of one input."""
    lg, labels, ignore = name_or_inputs
    c = lg.shape[-1]
    h, w = labels.shape[1:]
    lbl = fl.pad_labels(torch.from_numpy(labels), ignore)
    got = fl.fu_core_fwd([nchw(lg)], lbl, c, (h, w), nb, align, edges,
                         dither or 0, dither is not None).numpy()
    want = np.asarray(jfl._fu_core_fwd(
        [jnp.asarray(lg)], jnp.asarray(lbl.numpy()), c,
        jfl._pick_bh(lbl.shape[1], jfl._FU_FWD_BH_CAP), (h, w), nb, align, edges,
        jnp.asarray([dither or 0], jnp.int32), dither is not None))
    return got, want, int((lbl >= 0).sum()) * c


@pytest.mark.parametrize("name", list(SINGLE_CASES))
def test_single_scale_counts_match_jax(name):
    """B1's plain version at R = C against the JAX `_fu_core_fwd`: row and
    foreground totals exact, L1 <= 1e-3 of the counted pairs."""
    _, align, _, ignore, dseed, nb, edges = SINGLE_CASES[name]
    lg, labels = single_inputs(name)
    got, want, pairs = _counts((lg, labels, ignore), align, nb, edges, dseed)
    assert got.shape == want.shape == (lg.shape[-1], nb, 4)
    np.testing.assert_array_equal(got[..., :2].sum((1, 2)), want[..., :2].sum((1, 2)))
    np.testing.assert_array_equal(got[..., 0].sum(1), want[..., 0].sum(1))
    assert np.abs(got[..., :2] - want[..., :2]).sum() <= 1e-3 * pairs


@pytest.mark.parametrize("nb,align", [(256, False), (1024, True), (2048, False)])
def test_single_scale_counts_equal_jax_on_equal_probabilities(nb, align):
    """Where both sides compute the same probabilities, the counts are
    equal: logits at the labels' own size (the upsample is the identity),
    each pixel's C logits a permutation of one vector whose softmax errors
    lie far from every bucket edge."""
    c, n, h, w = 5, 2, 16, 40
    vec = np.array([0.0, 0.5, 1.0, 1.5, 2.25], np.float32)
    p = np.exp(vec - vec.max()) / np.exp(vec - vec.max()).sum()
    frac = np.concatenate([p, 1 - p]) * nb
    assert np.abs(frac - np.round(frac)).min() > 1e-3       # the precondition
    rng = np.random.default_rng(nb + align)
    lg = np.stack([vec[rng.permutation(c)] for _ in range(n * h * w)])
    lg = lg.reshape(n, h, w, c)
    labels = rng.integers(0, c + 1, (n, h, w)).astype(np.uint8)
    got, want, pairs = _counts((lg, labels, None), align, nb)
    assert pairs > 0
    np.testing.assert_array_equal(got[..., :2], want[..., :2])


def test_build_loss_routes_deeplab_to_the_fused_route():
    """DeepLab's outputs take the fused route (its value is
    `fused_bucket_lovasz_s8`'s and the JAX `build_loss`'s), with the
    train step's counter as the dither seed; HRNetv2's (no pre-upsample
    logits) keep the generic bucket route."""
    rng = np.random.default_rng(11)
    s8 = (3.0 * rng.standard_normal((2, 9, 12, 17))).astype(np.float32)
    full = (3.0 * rng.standard_normal((2, 68, 96, 17))).astype(np.float32)
    labels = rng.integers(0, 18, (2, 68, 96)).astype(np.uint8)
    lbl = torch.from_numpy(labels)
    cfg = dict(LOSS, lovasz_dither=True, lovasz_buckets=1024)
    loss, jloss = build_loss(cfg, 2, "cpu"), jax_build_loss(cfg, 2)
    assert loss.full_res == ()
    got = float(loss({"logits_s8": nchw(s8), "logits": nchw(full)}, lbl, step=5)[0])
    want = float(jloss({"logits_s8": jnp.asarray(s8), "logits": jnp.asarray(full)},
                       jnp.asarray(labels), step=5)[0])
    assert got == float(fl.fused_bucket_lovasz_s8(nchw(s8), lbl, n_buckets=1024,
                                                  dither_seed=5))
    assert abs(got - want) <= 1e-6
    with pytest.warns(UserWarning, match="lovasz_dither does nothing"):
        generic = float(loss({"logits": nchw(full)}, lbl)[0])
    assert generic == float(lovasz_softmax(nchw(full), lbl, impl="bucket"))
