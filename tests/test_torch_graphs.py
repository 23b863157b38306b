"""The port's remaining graphs against the JAX package: FCN-8s, UNet,
EncDec-UPerNet on Inception-v3, ResNeXt-50 and WideResNet-50, OCRNet on
ResNet-18/34 and on HRNet, and SimpleDiscriminator, each through its
weight bridge; and the loss each one's logits take on the Lovász routes.

Each JAX graph is built in float64 from numpy-filled weights
(`numpy_variables`: lecun-normal kernels, non-trivial BatchNorm, the tree's
shapes from an init at the test's input size, since the Inception encoder
and the discriminator's fc1 need it), bridged to the port
(train/bridge.py, strict load) and run in eval mode on one seeded input,
jitted; every output within 1e-6. Sizes are cut for the CPU: 2 x 64 x 96
inputs (FCN also at 72 x 100, which 32 does not divide, so that each of
its fuses resizes; UNet at 32 x 48; the Inception encoder at 80 x 96, near
its smallest input, 75), FCN at width 0.125, the UPerNet decoders at 32
channels, HRNet at width 4, the discriminator at d 8; the encoders and
the OCR heads at full width. The Inception-UPerNet's `logits` are the
port's resize of its stride-4 logits to the input's size, held against
the JAX package's `resize_bilinear` of JAX's `logits_s8_acf`
(models/encdec.py says why). Losses, in float32 on both sides from the
JAX forward's logits: the flagship's TwoScaleLoss on the fused route (B1
and B2's plain versions against JAX's Pallas kernels in interpret mode)
from OCRNet-R18/34's stride-32 logits and OCR-on-HRNet's stride-4 ones,
the LossWrapper's fused single-scale route from the Inception-UPerNet's
odd stride-4 grid, and the generic bucket route (B3, and B4f in the
backward) from FCN's logits and UNet's 18-channel ones: value within
1e-6 and gradient within 1e-5 relative L2 (the fused routes' tolerance in
tests/test_torch_deeplab.py), no kernel launch on the CPU.
"""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.ops.resize import (
    resize_bilinear as jax_resize)
from miccai2021_cataract_semantic_segmentation_tpu.train.port_torch import port_state_dict

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.discriminator import (
    feature_hw)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import hrnet_width
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import output_channels
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import bridge

ROOT = pathlib.Path(__file__).resolve().parents[1]
NARROW = {"ppm_num_ch": 32, "fpn_num_ch": 32}
# name: (graph, input (N, H, W), bridge, JAX porter name or None)
GRAPHS = {
    "fcn": ({"model": "FCN", "width": 0.125}, (2, 64, 96), bridge.bridge_flax_names, None),
    "fcn_72x100": ({"model": "FCN", "width": 0.125}, (2, 72, 100), bridge.bridge_flax_names, None),
    "unet": ({"model": "UNet"}, (2, 32, 48), bridge.bridge_flax_names, None),
    "inception_upernet": ({"model": "EncDec", "encoder": {"model": "InceptionV3"},
                           "decoder": {"model": "UPerNet", **NARROW}}, (2, 80, 96),
                          bridge.bridge_encdec_upernet, None),
    "resnext50_upernet": ({"model": "UPerNet", "encoder": {"model": "ResNeXt50"},
                           "decoder": NARROW}, (2, 64, 96),
                          bridge.bridge_encdec_upernet, "UPerNet"),
    "wide_resnet50_upernet": ({"model": "UPerNet", "encoder": {"model": "WideResNet50"},
                               "decoder": NARROW}, (2, 64, 96),
                              bridge.bridge_encdec_upernet, "UPerNet"),
    "ocrnet_r18": ({"model": "OCRNet", "backbone": "resnet18"}, (2, 64, 96),
                   bridge.bridge_ocrnet, "OCRNet"),
    "ocrnet_r34": ({"model": "OCRNet", "backbone": "resnet34"}, (2, 64, 96),
                   bridge.bridge_ocrnet, "OCRNet"),
    "ocrnet_hrnet_w4": ({"model": "OCRNet", "backbone": "hrnetv2_w4"}, (2, 64, 96),
                        bridge.bridge_ocrnet, None),
    "discriminator": ({"model": "SimpleDiscriminator", "d": 8, "input_hw": (64, 96)},
                      (2, 64, 96), bridge.bridge_flax_names, None),
}
FLAGSHIP_LOSS = json.loads((ROOT / "configs" / "OCRNet_rf_lvsz.json").read_text())["loss"]
# name: (loss config, the JAX outputs it reads)
LOSSES = {
    "ocrnet_r18": (FLAGSHIP_LOSS, ("logits_s8", "interm_logits_s8")),
    "ocrnet_r34": (FLAGSHIP_LOSS, ("logits_s8", "interm_logits_s8")),
    "ocrnet_hrnet_w4": (FLAGSHIP_LOSS, ("logits_s8", "interm_logits_s8")),
    "inception_upernet": ({"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"},
                          ("logits_s8_acf",)),
    "fcn": ({"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"}, ("logits",)),
    "unet": ({"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"}, ("logits",)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def numpy_variables(model, shape, seed=0):
    """flax's parameter tree for `model` at an NHWC `shape` input, filled
    from numpy (float64 values of float32 draws), as tests/test_torch_eval.py
    fills it at 16x16."""
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(int(np.prod(s.shape[:-1])))
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:                                    # bias, mean
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32).astype(np.float64)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_graph(name):
    """The JAX graph's float64 variables (numpy trees), one seeded input
    (NHWC) and its eval outputs (numpy, NHWC)."""
    graph, (n, h, w), *_ = GRAPHS[name]
    jax.config.update("jax_enable_x64", True)
    try:
        model = jax_build_model(graph, 2, dtype=jnp.float64)
        variables = numpy_variables(model, (1, h, w, 3), seed=len(name))
        x = np.random.default_rng(len(name) + 1).standard_normal((n, h, w, 3))
        out = jax.jit(lambda v, x: model.apply(v, x, False))(variables, jnp.asarray(x))
        out = jax.tree.map(np.asarray, out)
    finally:
        jax.config.update("jax_enable_x64", False)
    return jax.tree.map(np.asarray, variables), x, out


def port_graph(name):
    graph, _, bridge_fn, _ = GRAPHS[name]
    variables = jax_graph(name)[0]
    port = build_model(graph, 2, device="cpu").double()
    port.load_state_dict(bridge_fn(variables["params"], variables.get("batch_stats", {})),
                         strict=True)
    return port.eval()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_eval_forward_matches_jax_f64(name):
    """Every output of the eval forward within 1e-6 of flax's, with the
    JAX model's keys and shapes (NCHW for NHWC)."""
    _, x, want = jax_graph(name)
    with torch.no_grad():
        got = port_graph(name)(nchw(x))
    if name == "discriminator":
        assert got.shape == want.shape == (2, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        return
    if name == "inception_upernet":
        # the port's logits: the stride-4 logits resized to the input
        jax.config.update("jax_enable_x64", True)
        try:
            want = dict(want, logits=np.asarray(jax_resize(
                jnp.asarray(want["logits_s8_acf"]), x.shape[1:3], align_corners=False)))
        finally:
            jax.config.update("jax_enable_x64", False)
    assert set(got) == set(want), name
    for key, w in want.items():
        assert got[key].dtype == torch.float64, key
        assert tuple(got[key].shape) == w.transpose(0, 3, 1, 2).shape, key
        np.testing.assert_allclose(got[key].numpy(), w.transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-6, err_msg=f"{name} {key}")


def test_graph_shapes_at_the_cells_size():
    """Shapes the chip's cells meet at 544x960: the Inception encoder's
    odd maps (layer1 132x236), UNet's ignore channel, OCRNet-R18/34's
    stride-32 logits with the interm head at stride 2, OCR-on-HRNet at
    stride 4, the discriminator's fc1 input; the encoder's on the meta
    device."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.inception import (
        InceptionV3Encoder)
    with torch.no_grad():
        feats = InceptionV3Encoder().to("meta").eval()(
            torch.empty(1, 3, 544, 960, device="meta"))
    assert [tuple(f.shape[1:]) for f in feats.values()] == [
        (192, 132, 236), (288, 65, 117), (768, 32, 58), (2048, 15, 28)]
    assert taxonomy.num_label_values(2) == 18
    assert build_model({"model": "UNet"}, 2, device="cpu").conv_last.out_channels == 18
    ocr = build_model({"model": "OCRNet", "backbone": "resnet18"}, 2, device="cpu")
    assert ocr.interm_prediction_head[0].stride == (2, 2)
    assert not any(m.dilation[0] > 1 for m in ocr.backbone.modules()
                   if isinstance(m, torch.nn.Conv2d))
    assert hrnet_width("hrnetv2_18") == hrnet_width("hrnetv2_w18") == 18
    assert hrnet_width("hrnetv2") == 32
    for arch in ("resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
                 "wide_resnet101_2"):
        assert output_channels(arch) == (256, 512, 1024, 2048)
    assert feature_hw((544, 960)) == (66, 118)
    disc = build_model({"model": "SimpleDiscriminator"}, 2, device="cpu")
    assert disc.fc1.in_features == 66 * 118 * 256


def test_grouped_and_wide_bottlenecks_are_torchvision_s():
    """ResNeXt-50 32x4d's first 3x3 is 128 wide in 32 groups, WideResNet-50's
    128 wide in one, as torchvision builds them."""
    rx = build_model({"model": "UPerNet", "encoder": {"model": "ResNeXt50"}}, 2,
                     device="cpu").enc_model
    wr = build_model({"model": "UPerNet", "encoder": {"model": "WideResNet50"}}, 2,
                     device="cpu").enc_model
    assert rx.layer1[0].conv2.groups == 32 and rx.layer1[0].conv2.weight.shape == (128, 4, 3, 3)
    assert wr.layer1[0].conv2.groups == 1 and wr.layer1[0].conv2.weight.shape == (128, 128, 3, 3)
    assert rx.layer4[0].conv3.weight.shape == (2048, 1024, 1, 1)


@pytest.mark.parametrize("name", [k for k, v in GRAPHS.items() if v[3]])
def test_bridge_round_trips_through_port_state_dict(name):
    """The JAX package's own porter, applied to the bridge's output, gives
    back the flax tree on every leaf (grouped kernels included)."""
    _, _, bridge_fn, porter = GRAPHS[name]
    variables = jax_graph(name)[0]
    sd = bridge_fn(variables["params"], variables["batch_stats"])
    zeros = jax.tree.map(np.zeros_like, (variables["params"], variables["batch_stats"]))
    p2, s2 = port_state_dict(porter, {k: v.numpy() for k, v in sd.items()}, *zeros)
    for want, got in ((variables["params"], p2), (variables["batch_stats"], s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, v in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), v,
                                          err_msg=jax.tree_util.keystr(path))


def _labels(n, h, w, n_values, seed):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, n_values, (n, h // 8 + 1, w // 8 + 1))
    return np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)


@pytest.mark.parametrize("name", list(LOSSES))
def test_graph_loss_routes_match_jax(name):
    """The graph's logits through its loss route, value and gradient, on
    both sides in float32."""
    cfg, keys = LOSSES[name]
    _, x, out = jax_graph(name)
    n, h, w = x.shape[:3]
    labels = _labels(n, h, w, 18, 3)
    inputs = {k: out[k].astype(np.float32) for k in keys}
    # the JAX TwoScaleLoss reads the full-size logits even where it fuses
    const = {k: jnp.asarray(out[k], jnp.float32) for k in ("logits", "interm_logits")
             if k in out and k not in keys}
    jloss = jax_build_loss(cfg, 2)

    def f(a):
        return jloss({**const, **a}, jnp.asarray(labels))[0]

    want, want_g = jax.jit(jax.value_and_grad(f))({k: jnp.asarray(v)
                                                   for k, v in inputs.items()})
    loss = build_loss(cfg, 2, "cpu")
    got_in = {k: nchw(v).requires_grad_(True) for k, v in inputs.items()}
    reset_launches()
    total, _ = loss(got_in, torch.from_numpy(labels))
    total.backward()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert abs(float(total.detach()) - float(want)) <= 1e-6, name
    for k in keys:
        assert rel_l2(got_in[k].grad.numpy(),
                      np.asarray(want_g[k]).transpose(0, 3, 1, 2)) <= 1e-5, (name, k)
