"""The port's EncDec-UPerNet slice against the JAX package: the graph
through the weight bridge, one whole train step on the LossWrapper's fused
single-scale bucket Lovász from the align_corners=False stride-4 logits
(B1 forward and B2 backward at R = C rows), `adaptive_avg_pool`, the
LossWrapper itself with its `dc_off_at_epoch` gate, and the EncDec graph
rule of the run config.

A module-scoped JAX fixture builds EncDec (ResNet-34 encoder, UPerNet
decoder) in float64 from numpy-filled weights (`numpy_variables`), with
the decoder narrowed from 512 to 32 channels (`ppm_num_ch`, `fpn_num_ch`:
a width reduction for the CPU's sake; the encoder is at full width), runs
its eval forward and one JAX train step (Adam at the recipe's LR,
pad-only augmentation) on a 2x64x96 batch; the JAX Pallas kernels run in
interpret mode, as the JAX package's tests run them. Tolerances: the
float64 forward to 1e-6; the train step as tests/test_torch_deeplab.py
holds DeepLabv3's (the loss runs in float32 inside both: loss 1e-5,
gradients 1e-5 relative L2, new parameters to 1e-12 of Adam's first step
from the port's own gradient and to 1e-6 of JAX's except where
0 < |g| <= Adam's eps, BatchNorm statistics 1e-6, the s8 confusion matrix
equal); the LossWrapper's value to 1e-6 and its gradient to 1e-5 relative
L2.
"""
import concurrent.futures
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models.layers import (
    adaptive_avg_pool as jax_adaptive_avg_pool)
from miccai2021_cataract_semantic_segmentation_tpu.models.resnet import (
    output_channels as jax_output_channels)
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train.config import parse_config
from miccai2021_cataract_semantic_segmentation_tpu.train.port_torch import port_state_dict
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    BatchNorm2d, adaptive_avg_pool)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import output_channels
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import lr_schedule as lr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_encdec_upernet)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import (
    load_config, with_encdec_graph)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
    train_metrics_source)
from test_torch_eval import numpy_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
UPN_CONFIG = ROOT / "configs" / "UPN_rf_lvsz.json"
# the cell's loss: the shipped LossWrapper sent to the fused route
LOSS = {"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"}
CONFIG = dict(load_config(UPN_CONFIG), loss=LOSS)
# the decoder narrowed from 512 to 32 channels (a width reduction)
GRAPH = {"model": "EncDec", "encoder": {"model": "ResNet34"},
         "decoder": {"model": "UPerNet", "ppm_num_ch": 32, "fpn_num_ch": 32}}
N_IMG, H, W = 2, 64, 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def jax_upernet():
    """float64 JAX EncDec-UPerNet-R34: its variables, the eval forward of
    one seeded input, and one train step on the LossWrapper (s8 train
    metrics, as the Trainer picks them for the bucket Lovász)."""
    images, labels = batch()
    spec = build_transform_pipeline(["pad"], {}, 2).device
    jax.config.update("jax_enable_x64", True)
    try:
        model = jax_build_model(GRAPH, 2, dtype=jnp.float64)
        variables = numpy_variables(model, seed=4)
        x = np.random.default_rng(7).standard_normal((N_IMG, H, W, 3))
        # the eval forward in a thread: its tracing and XLA's work overlap
        # the train step's
        pool = concurrent.futures.ThreadPoolExecutor(1)
        want = pool.submit(lambda: {k: np.asarray(v) for k, v in jax.jit(
            lambda v, x: model.apply(v, x, False))(variables, jnp.asarray(x)).items()
            if k in ("logits", "logits_s8_acf", "deep_features")})
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
        want = want.result()
        pool.shutdown()
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, x, want, images, labels, train


def _port(variables):
    port = build_model(GRAPH, 2, device="cpu").double()
    port.load_state_dict(bridge_encdec_upernet(variables["params"],
                                               variables["batch_stats"]), strict=True)
    return port


def test_upernet_eval_forward_matches_jax_f64(jax_upernet):
    """`logits` and the pre-upsample stride-4 `logits_s8_acf` within 1e-6
    of flax, `deep_features` (layer 4) too; `full_res=()` leaves out the
    full-resolution upsample and nothing else."""
    variables, x, want = jax_upernet[:3]
    port = _port(variables).eval()
    with torch.no_grad():
        got = port(nchw(x))
        s8_only = port(nchw(x), full_res=())
    assert set(got) == {"logits", "logits_s8_acf", "deep_features"}
    assert set(s8_only) == {"logits_s8_acf", "deep_features"}
    assert got["logits_s8_acf"].shape == (N_IMG, 17, H // 4, W // 4)
    assert got["logits"].shape == (N_IMG, 17, H, W)
    for key in ("logits", "logits_s8_acf", "deep_features"):
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), want[key].transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-6, err_msg=key)
    assert torch.equal(s8_only["logits_s8_acf"], got["logits_s8_acf"])
    assert all(isinstance(m, BatchNorm2d) for m in port.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


def test_upernet_bridge_round_trips_through_port_state_dict(jax_upernet):
    """The JAX package's own porter, applied to the bridge's output, gives
    back the flax tree on every leaf; the names are the reference's, the
    BasicBlocks' `downsample.0/1` among them."""
    variables = jax_upernet[0]
    sd = bridge_encdec_upernet(variables["params"], variables["batch_stats"])
    for key in ("enc_model.conv1.weight", "enc_model.layer2.0.downsample.0.weight",
                "enc_model.layer4.0.downsample.1.running_var",
                "enc_model.layer3.5.conv2.weight", "dec_model.ppm_conv.3.0.weight",
                "dec_model.ppm_conv.0.1.running_mean", "dec_model.ppm_last_conv.0.weight",
                "dec_model.fpn_in.2.1.bias", "dec_model.fpn_out.0.0.0.weight",
                "dec_model.fpn_out.2.0.1.running_var", "dec_model.conv_last.0.0.weight",
                "dec_model.conv_last.0.1.weight", "dec_model.conv_last.1.weight",
                "dec_model.conv_last.1.bias"):
        assert key in sd, key
    zeros = jax.tree.map(np.zeros_like, (variables["params"], variables["batch_stats"]))
    p2, s2 = port_state_dict("EncDec", {k: v.numpy() for k, v in sd.items()}, *zeros)
    for want, got in ((variables["params"], p2), (variables["batch_stats"], s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, v in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), v,
                                          err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def port_step(jax_upernet):
    variables, _, _, images, labels, _ = jax_upernet
    port = _port(variables)
    state = TrainState(port, make_optimizer(CONFIG["train"], port.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))
    loss = build_loss(LOSS, 2, "cpu")
    assert loss.full_res == ()
    step = make_train_step(loss, device_spec(["pad"]), 2, device="cpu",
                           precision="fp32", train_metrics=train_metrics_source(CONFIG))
    reset_launches()
    metrics = step(state, images, labels, 0)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    return state, metrics


def test_upernet_train_step_matches_jax(jax_upernet, port_step):
    """Loss, term, grad_norm and the stride-4 s8 confusion matrix; every
    parameter's gradient within 1e-5 relative L2; every new parameter to
    1e-12 of Adam's first step from the port's own gradient, and to 1e-6
    of JAX's except where 0 < |g| <= Adam's eps (at most 0.1 % of the
    elements); the new BatchNorm statistics to 1e-6, the PPM's (n = N
    values per channel at scale 1) among them."""
    variables, want = jax_upernet[0], jax_upernet[5]
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
    want_grads = bridge_encdec_upernet(want["grads"], {})
    scale = np.sqrt(sum(float((p.grad ** 2).sum()) for p in port.parameters()))
    for key, p in port.named_parameters():
        w = want_grads[key].numpy()
        if np.linalg.norm(w) > 1e-9 * scale:
            assert rel_l2(p.grad.numpy(), w) <= 1e-5, key
        else:
            assert np.linalg.norm(p.grad.numpy() - w) <= 1e-9 * scale, key
    sd = port.state_dict()
    new = bridge_encdec_upernet(want["params"], want["stats"])
    old = bridge_encdec_upernet(variables["params"], variables["batch_stats"])
    assert "dec_model.ppm_conv.0.1.running_var" in new
    lr_ = state.optimizer.param_groups[0]["lr"]
    assert abs(lr_ / float(jlr.make_schedule(CONFIG["train"], 1)(0)) - 1) <= 1e-6
    params = dict(port.named_parameters())
    n_near = n_all = 0
    for key, v in new.items():
        if key.endswith("num_batches_tracked"):
            continue
        got_v, v = sd[key].numpy(), v.numpy()
        if key not in want_grads:               # BatchNorm statistics
            np.testing.assert_allclose(got_v, v, rtol=0, atol=1e-6, err_msg=key)
            continue
        g = params[key].grad.numpy()
        np.testing.assert_allclose(got_v, old[key].numpy() - lr_ * g / (np.abs(g) + 1e-8),
                                   rtol=0, atol=1e-12, err_msg=key)
        # where 0 < |g| <= 1e-8 (Adam's eps) the step follows the float32
        # loss's rounding in g (tests/test_torch_deeplab.py says why)
        g_jax = want_grads[key].numpy()
        near_eps = (g_jax != 0) & (np.abs(g_jax) <= 1e-8)
        n_near, n_all = n_near + int(near_eps.sum()), n_all + near_eps.size
        np.testing.assert_allclose(got_v[~near_eps], v[~near_eps], rtol=0, atol=1e-6,
                                   err_msg=key)
    assert n_near <= 1e-3 * n_all, (n_near, n_all)


@pytest.mark.parametrize("scale", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax_and_torch(scale):
    """At 17 x 30 (the cell's layer 4) the bins overlap for scales 2, 3
    and 6; float64 equal to the JAX package's and torch's own pool."""
    x = np.random.default_rng(scale).standard_normal((2, 17, 30, 5))
    want = np.asarray(jax.jit(jax_adaptive_avg_pool, static_argnums=1)(
        jnp.asarray(x, jnp.float32), (scale, scale)))
    got = adaptive_avg_pool(nchw(x).float(), (scale, scale))
    assert got.dtype == torch.float32 and got.shape == (2, 5, scale, scale)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=0, atol=1e-6)
    got64 = adaptive_avg_pool(nchw(x), (scale, scale))
    ref = torch.nn.functional.adaptive_avg_pool2d(nchw(x), scale)
    np.testing.assert_allclose(got64.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    half = adaptive_avg_pool(nchw(x).bfloat16(), (scale, scale))
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50", "resnet101"])
def test_output_channels_match_jax(arch):
    assert output_channels(arch) == jax_output_channels(arch)


# ---------------------------------------------------------------------------
# the LossWrapper and its dc_off_at_epoch gate
# ---------------------------------------------------------------------------

DC_OFF_AT = 3


def wrapper_inputs():
    rng = np.random.default_rng(12)
    s4 = (3.0 * rng.standard_normal((2, 5, 6, 17))).astype(np.float32)
    full = (3.0 * rng.standard_normal((2, 20, 24, 17))).astype(np.float32)
    labels = rng.integers(0, 18, (2, 20, 24)).astype(np.uint8)
    return s4, full, labels


def wrapper_config(route):
    cfg = {"losses": {"LovaszSoftmax": 0.5}, "dc_off_at_epoch": DC_OFF_AT}
    if route == "fused":
        cfg["lovasz_impl"] = "bucket"
    return cfg


@functools.lru_cache(maxsize=None)
def jax_wrapper_grad(route, gated):
    """jit(value_and_grad) of the JAX LossWrapper in `x` (and the traced
    epoch when `gated`): one compile serves every epoch."""
    jloss, key = jax_build_loss(wrapper_config(route), 2), INPUT_KEY[route]

    def fn(a, labels, epoch):
        total, terms = jloss({key: a}, labels, epoch=epoch if gated else None)
        return total, terms["LovaszSoftmax"]

    return jax.jit(jax.value_and_grad(fn, has_aux=True))


INPUT_KEY = {"fused": "logits_s8_acf", "sort": "logits"}


@pytest.mark.parametrize("epoch", [None, 2, 3, 4])
@pytest.mark.parametrize("route", ["fused", "sort"])
def test_loss_wrapper_and_its_gate_match_jax(route, epoch):
    """The LossWrapper's total, term and gradient against JAX's
    `build_loss`: on the fused route (the bucket Lovász from
    `logits_s8_acf`, align_corners=False) and the sort route (full
    resolution), with the Lovász term zero before `dc_off_at_epoch` (its
    gradient too, though both sides still run its backward), ungated at and
    after it and with no epoch."""
    s4, full, labels = wrapper_inputs()
    key, x = INPUT_KEY[route], (s4 if route == "fused" else full)
    loss = build_loss(wrapper_config(route), 2, "cpu")
    assert loss.full_res == (() if route == "fused" else ("logits",))
    (want, want_term), want_g = jax_wrapper_grad(route, epoch is not None)(
        jnp.asarray(x), jnp.asarray(labels), jnp.int32(epoch or 0))
    t = nchw(x).requires_grad_(True)
    total, terms = loss({key: t}, torch.from_numpy(labels), epoch=epoch)
    total.backward()
    total = total.detach()
    assert set(terms) == {"LovaszSoftmax"} and total.dtype == torch.float32
    assert abs(float(total) - float(want)) <= 1e-6
    assert abs(float(terms["LovaszSoftmax"].detach()) - float(want_term)) <= 1e-6
    want_g = np.asarray(want_g).transpose(0, 3, 1, 2)
    if epoch is not None and epoch < DC_OFF_AT:
        assert float(total) == 0.0 and not t.grad.any() and not want_g.any()
    else:
        assert float(total) > 0.0
        assert rel_l2(t.grad.numpy(), want_g) <= 1e-5


def test_loss_wrapper_sums_its_terms_and_asks_for_their_outputs():
    """A TwoScaleLoss term beside the Lovász one: the total is the weighted
    sum of the terms, each as `build_loss` gives it alone, and `full_res` is
    the union of theirs; with a device tensor for the epoch the gate
    decides on the tensor."""
    s4, full, labels = wrapper_inputs()
    lbl = torch.from_numpy(labels)
    two = {"name": "TwoScaleLoss", "interm": {"name": "LovaszSoftmax"},
           "final": {"name": "LovaszSoftmax"}}
    cfg = {"losses": {"TwoScaleLoss": 0.25, "LovaszSoftmax": 2.0},
           "TwoScaleLoss": two, "LovaszSoftmax": {"lovasz_impl": "bucket"},
           "dc_off_at_epoch": DC_OFF_AT}
    loss = build_loss(cfg, 2, "cpu")
    assert set(loss.full_res) == {"interm_logits", "logits"}
    outputs = {"logits_s8_acf": nchw(s4), "logits": nchw(full),
               "interm_logits": nchw(full[:, ::-1].copy())}
    total, terms = loss(outputs, lbl, epoch=torch.tensor(DC_OFF_AT))
    want_two = build_loss(two, 2, "cpu")(outputs, lbl)[0]
    want_lv = build_loss({"name": "LovaszSoftmax", "lovasz_impl": "bucket"}, 2,
                         "cpu")(outputs, lbl)[0]
    assert float(terms["TwoScaleLoss"]) == float(0.25 * want_two)
    assert float(terms["LovaszSoftmax"]) == float(2.0 * want_lv)
    assert float(total) == float(terms["TwoScaleLoss"] + terms["LovaszSoftmax"])
    gated, gated_terms = loss(outputs, lbl, epoch=torch.tensor(DC_OFF_AT - 1))
    assert float(gated_terms["LovaszSoftmax"]) == 0.0
    assert float(gated) == float(terms["TwoScaleLoss"])


def test_encdec_graph_rule_matches_jax():
    """configs/UPN_rf_lvsz.json has its encoder and decoder at the top
    level: `load_config` gives it the JAX package's EncDec graph, which
    builds; a config with a graph keeps it."""
    cfg = load_config(UPN_CONFIG)
    assert cfg["graph"] == parse_config(str(UPN_CONFIG))["graph"]
    assert cfg["graph"] == {"model": "EncDec", "encoder": {"model": "ResNet34",
                                                           "pretrained": False},
                            "decoder": {"model": "UPerNet"}}
    model = build_model(cfg["graph"], 2, device="cpu")
    assert type(model.enc_model.layer1[0]).__name__ == "BasicBlock"
    assert len(model.enc_model.layer3) == 6
    graph = {"model": "OCRNet"}
    assert with_encdec_graph({"graph": graph, "encoder": {}})["graph"] is graph
    assert "graph" not in with_encdec_graph({"data": {}})


@pytest.mark.parametrize("graph,match", [
    ({"model": "EncDec", "decoder": {"model": "PointRend"}}, "PointRend"),
    ({"model": "EncDec", "encoder": {"model": "InceptionV3"}}, "Inception"),
    ({"model": "UPerNet", "encoder": {"model": "ResNeXt50"}}, "resnext50_32x4d"),
    ({"model": "OCRNet", "backbone": "resnet34"}, "ResNet-18/34"),
])
def test_later_parts_of_encdec_raise(graph, match):
    """Once raising, these parts now build (ROADMAP item 12): PointRend's
    decoder, the Inception encoder, ResNeXt's grouped blocks and OCRNet-R34's
    stride-2 interm head, each with the JAX model's output keys and shapes
    at 96 x 128 (the Inception encoder's logits at the input's size)."""
    model = build_model(graph, 2, device="cpu")
    part = {"PointRend": lambda: type(model.dec_model).__name__ == "PointRendDecoder",
            "Inception": lambda: type(model.enc_model).__name__ == "InceptionV3Encoder",
            "resnext50_32x4d": lambda: model.enc_model.layer1[0].conv2.groups == 32,
            "ResNet-18/34": lambda: model.interm_prediction_head[0].stride == (2, 2)}
    assert part[match]()
    jmodel = jax_build_model(graph, 2)
    x = jnp.zeros((1, 96, 128, 3), jnp.float32)
    want = jax.eval_shape(lambda x: jmodel.init_with_output(
        jax.random.PRNGKey(0), x, False)[0], x)
    with torch.no_grad():
        got = model(torch.zeros(1, 3, 96, 128))
    assert set(got) == set(want)
    for key, w in want.items():
        shape = (1, w.shape[3], *w.shape[1:3])
        if match == "Inception" and key == "logits":
            shape = (1, w.shape[3], 96, 128)
        assert tuple(got[key].shape) == shape, key


@pytest.mark.parametrize("name", ["DenseContrastiveLoss", "DenseContrastiveLossV2"])
def test_loss_wrapper_dense_contrastive_terms_raise(name):
    """A dense-contrastive term builds (ported since) and raises only where
    the model gives neither `proj_features` nor `deep_features`."""
    loss = build_loss({"losses": {"LovaszSoftmax": 1, name: 0.1}}, 2, "cpu")
    lbl = torch.randint(0, 18, (2, 16, 16))
    with pytest.raises(ValueError, match="proj_features"):
        loss({"logits": torch.randn(2, 17, 16, 16)}, lbl)
