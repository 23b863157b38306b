"""The port's OCRNet-R50-os8 against the JAX package's, through the weight
bridge, plus the numpy-level twins the model rests on (taxonomy, resize).

The flax model is initialised by flax; its BatchNorm scale/bias/mean/var
are then set to non-trivial values with numpy, the tree is bridged to the
port's state dict (train/bridge.py) and loaded with strict=True. Both sides
run in float64 (the JAX side under jax_enable_x64), so agreement to 1e-6
shows the two graphs compute the same function; float32 runs would differ
at ~1e-4 from accumulation order alone. Outputs compare after transposing
the JAX side's NHWC to the port's NCHW.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu import taxonomy as jax_taxonomy
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models.layers import torch_pad as jax_torch_pad
from miccai2021_cataract_semantic_segmentation_tpu.ops.resize import (
    _interp_matrix, resize_bilinear as jax_resize)
from miccai2021_cataract_semantic_segmentation_tpu.train.port_torch import port_state_dict

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import torch_pad
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import (
    interp_matrix, resize_bilinear)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_ocrnet

GRAPH = {"model": "OCRNet", "backbone": "resnet50", "out_stride": 8}
TOL = 1e-6        # float64 on both sides


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_ocrnet_variables(seed: int = 0, hw=(64, 96)):
    """flax-initialised OCRNet-R50-os8 params with numpy-set BN
    scale/bias/mean/var, as nested dicts of numpy arrays."""
    model = jax_build_model(GRAPH, 2, dtype=jnp.float64)
    variables = jax.jit(lambda k, x: model.init(k, x, False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3), jnp.float32))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def set_bn(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                set_bn(v)
            elif k == "scale":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            elif k == "bias" and "scale" in tree:
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif k == "mean":
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)

    params, stats = variables["params"], variables["batch_stats"]
    set_bn(params)
    set_bn(stats)
    return model, params, stats


@pytest.fixture(scope="module")
def ocr_pair():
    """(JAX outputs, port outputs, params, stats, port state dict) on one
    seeded 1x3x64x96 input, both in float64."""
    model, params, stats = flax_ocrnet_variables()
    x = np.random.default_rng(7).standard_normal((1, 64, 96, 3))
    # every leaf in float64 too: flax takes BatchNorm's rsqrt(var + eps) in
    # the statistics' own dtype
    variables = jax.tree.map(lambda a: a.astype(np.float64),
                             {"params": params, "batch_stats": stats})
    jax.config.update("jax_enable_x64", True)
    try:
        ref = jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, jnp.asarray(x, jnp.float64))
        ref = jax.tree.map(np.asarray, ref)
    finally:
        jax.config.update("jax_enable_x64", False)
    sd = bridge_ocrnet(params, stats)
    port = build_model(GRAPH, 2, device="cpu")
    port.load_state_dict(sd, strict=True)
    port = port.double()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
    return ref, got, params, stats, sd


@pytest.mark.parametrize("key", ["logits", "interm_logits", "logits_s8",
                                 "interm_logits_s8", "deep_features"])
def test_ocrnet_matches_jax_f64(ocr_pair, key):
    ref, got, *_ = ocr_pair
    want = ref[key].transpose(0, 3, 1, 2)          # NHWC -> NCHW
    assert got[key].dtype == torch.float64
    assert tuple(got[key].shape) == want.shape
    np.testing.assert_allclose(got[key].numpy(), want, rtol=0, atol=TOL)


def test_full_res_interm_is_left_out_on_request(ocr_pair):
    ref, _, params, stats, sd = ocr_pair
    port = build_model(GRAPH, 2, device="cpu")
    port.load_state_dict(sd, strict=True)
    x = torch.zeros(1, 3, 32, 48)
    with torch.no_grad():
        out = port(x, full_res=("logits",))
        s8_only = port(x, full_res=())
    assert "interm_logits" not in out
    assert {"logits", "logits_s8", "interm_logits_s8", "deep_features"} <= set(out)
    assert set(s8_only) == {"logits_s8", "interm_logits_s8", "deep_features"}
    for key in s8_only:
        assert torch.equal(s8_only[key], out[key])


def test_bridge_round_trips_through_port_state_dict(ocr_pair):
    """The JAX package's own porter, applied to the bridge's output, gives
    back the flax tree on every leaf."""
    _, _, params, stats, sd = ocr_pair
    zeros = jax.tree.map(np.zeros_like, (params, stats))
    p2, s2 = port_state_dict("OCRNet", {k: v.numpy() for k, v in sd.items()},
                             *zeros)
    for want, got in ((params, p2), (stats, s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, v in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), v,
                                          err_msg=jax.tree_util.keystr(path))


def test_bridge_uses_the_reference_torch_names(ocr_pair):
    sd = ocr_pair[4]
    for key in ("backbone.layer1.0.conv1.weight",
                "backbone.layer2.0.downsample.0.weight",
                "backbone.layer4.2.bn3.running_var",
                "conv_high_map.0.weight", "conv_high_map.1.running_mean",
                "spatial_ocr_head.object_context_block.f_pixel.0.weight",
                "spatial_ocr_head.object_context_block.f_pixel.4.running_var",
                "spatial_ocr_head.conv_bn_dropout.1.weight",
                "interm_prediction_head.4.weight", "conv_out.weight"):
        assert key in sd, key
    assert sd["conv_out.weight"].shape == (17, 512, 1, 1)


@pytest.mark.parametrize("name", ["IGNORE_VALUE", "CANONICAL_NAMES",
                                  "TASK_GROUPS", "TASK_CLASS_NAMES",
                                  "TASK_NUM_CLASSES", "REMAP_LUTS",
                                  "REMAP_LUTS_NETWORK", "CATEGORIES",
                                  "DATA_SPLITS", "OVERSAMPLING_PRESETS",
                                  "CLASS_FREQUENCIES", "CLASS_SUMS",
                                  "CADIS_COLORMAP"])
def test_taxonomy_copy_equals_the_jax_package(name):
    _assert_same(getattr(taxonomy, name), getattr(jax_taxonomy, name), name)


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("task", [1, 2, 3])
def test_taxonomy_functions_equal(task):
    for fn in ("task_has_ignore", "ignore_index", "num_label_values"):
        assert getattr(taxonomy, fn)(task) == getattr(jax_taxonomy, fn)(task)
    np.testing.assert_array_equal(taxonomy.task_colormap(task),
                                  jax_taxonomy.task_colormap(task))


@pytest.mark.parametrize("n_in,n_out", [(68, 544), (120, 960), (9, 67),
                                        (544, 68), (5, 5)])
@pytest.mark.parametrize("align", [True, False])
def test_interp_matrix_bit_equal(n_in, n_out, align):
    np.testing.assert_array_equal(interp_matrix(n_in, n_out, align),
                                  _interp_matrix(n_in, n_out, align))


@pytest.mark.parametrize("align", [True, False])
def test_resize_bilinear_matches_jax(align):
    x = np.random.default_rng(3).standard_normal((2, 9, 13, 4)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), (31, 50), align_corners=align))
    got = resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous(),
                          (31, 50), align_corners=align)
    # float32 on both sides: two matmuls of <= 2 nonzero taps each
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)


def test_torch_pad_matches():
    for k, s, d in [(3, 1, 1), (3, 2, 1), (7, 2, 1), (3, 1, 2), (3, 1, 4), (1, 1, 1)]:
        assert torch_pad(k, s, d) == jax_torch_pad(k, s, d)


@pytest.mark.parametrize("graph", [{"model": "UNet"},
                                   {"model": "PointRend"},
                                   {"model": "FCN"},
                                   {"model": "OCRNet", "backbone": "hrnetv2_w18"},
                                   {"model": "OCRNet", "backbone": "resnet18"}])
def test_graphs_of_later_slices_raise(graph):
    """Once raising, these graphs now build (ROADMAP item 12): the port's
    eval outputs have the JAX model's keys and shapes (NCHW for NHWC)."""
    assert_outputs_like_jax(graph)


def assert_outputs_like_jax(graph, hw=(64, 96)):
    """Build `graph` in both packages (task 2); the port's eval forward
    on a 2 x hw input gives the keys and shapes of the JAX model's."""
    model = jax_build_model(graph, 2)
    x = jnp.zeros((2, *hw, 3), jnp.float32)
    want = jax.eval_shape(lambda x: model.init_with_output(
        jax.random.PRNGKey(0), x, False)[0], x)
    port = build_model(graph, 2, device="cpu")
    with torch.no_grad():
        got = port(torch.zeros(2, 3, *hw))
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == (w.shape[0], w.shape[3], *w.shape[1:3]), key
