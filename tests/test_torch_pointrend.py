"""The port's PointRend against the JAX package: `point_sample`, the
train-time selection from JAX's own uniform draws, the tie and
duplicate-index rules, the eval-time subdivision through the whole graph,
the point loss, and one PointRend train step.

The graph is EncDec with a ResNet-18 encoder and the PointRend decoder
(its coarse UPerNet at the JAX package's fixed 512 channels), in float64
from numpy-filled weights (`numpy_variables`), carried by
`bridge_encdec_pointrend`, on 2x64x96 inputs. The train step runs the
cell's LossWrapper ({"LovaszSoftmax": 1}, bucket): PointRend gives no
pre-upsample logits, so it takes the generic bucket route (JAX's Pallas
kernels in interpret mode, the port's B3/B4f plain versions) and adds the
point loss. The JAX step draws its points inside flax (`make_rng`); the
test takes them from a JAX forward with the step's `points` key and
injects them into the port's step. The eval forward runs op by op on the
JAX side (see `jax_pointrend`). Tolerances: float64 forwards to 1e-6;
the step's loss to 1e-5 and its gradients to 1e-5 relative L2 (its loss
runs in float32 inside both), as tests/test_torch_upernet.py holds
UPerNet's; the selected points and the rules exactly.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models import pointrend as jpr
from miccai2021_cataract_semantic_segmentation_tpu.ops.augment import (
    augment_batch as jax_augment_batch)
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train import steps as jax_steps
from miccai2021_cataract_semantic_segmentation_tpu.train.port_torch import port_state_dict
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import pointrend as pr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import lr_schedule as lr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_encdec_pointrend)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    make_train_step, point_loss, step_points)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import has_point_head
from test_torch_eval import numpy_variables
from test_torch_upernet import CONFIG, LOSS, batch, nchw, rel_l2

GRAPH = {"model": "PointRend", "encoder": {"model": "ResNet18"}}
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


class x64:
    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


# ------------------------------------------------------------- the pieces

def test_point_sample_matches_jax_and_grid_sample():
    """float64 samples at uniform points, at points on cell centres and
    edges, and outside the map's half-cell border (zero padding): equal to
    JAX's within 1e-12 and to torch's grid_sample (align_corners=False)."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 5, 7, 9))
    coords = np.concatenate([rng.random((2, 40, 2)),
                             np.array([[[0.0, 0.0], [1.0, 1.0], [0.5 / 9, 0.5 / 7],
                                        [0.999, 0.001]]] * 2)], axis=1)
    with x64():
        want = np.asarray(jpr.point_sample(jnp.asarray(nhwc(feats)), jnp.asarray(coords)))
    got = pr.point_sample(torch.from_numpy(feats), torch.from_numpy(coords))
    assert got.shape == (2, 5, 44)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 2, 1), rtol=0, atol=1e-12)
    grid = torch.from_numpy(coords * 2 - 1)[:, :, None]
    ref = torch.nn.functional.grid_sample(torch.from_numpy(feats), grid,
                                          align_corners=False)[..., 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_selection_from_jax_draws_matches_jax():
    """JAX's `sample_uncertain_points` and the port's fed the same uniforms
    (JAX's own draws from its key) pick the same points in the same order."""
    rng = np.random.default_rng(1)
    coarse = 2.0 * rng.standard_normal((2, 17, 16, 24))
    key = jax.random.PRNGKey(5)
    sampled, uncertain, random = pr.point_counts(196, 3.0, 0.75)
    with x64():
        want = np.asarray(jpr.sample_uncertain_points(
            key, jnp.asarray(nhwc(coarse)), 196, 3.0, 0.75))
        r1, r2 = jax.random.split(key)
        over = np.array(jax.random.uniform(r1, (2, sampled, 2)))
        rand = np.array(jax.random.uniform(r2, (2, random, 2)))
    got = pr.sample_uncertain_points(
        torch.from_numpy(coarse), pr.PointDraws(torch.from_numpy(over),
                                                torch.from_numpy(rand)), uncertain)
    assert got.shape == (2, 196, 2) and (sampled, uncertain, random) == (588, 147, 49)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_ties_take_the_lower_index_first():
    """On repeated values the port picks JAX's `lax.top_k` indices (torch's
    own topk does not), and `uncertain_points_on_grid` on a blocky map,
    full of equal uncertainties, selects JAX's cells and points."""
    v = np.tile(np.array([0, 1, 1, 0, 1, 0, 1, 1], np.float32), 8)[None]
    want = np.asarray(jax.lax.top_k(jnp.asarray(v), 5)[1])
    got = pr.top_k_first(torch.from_numpy(v), 5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [1, 2, 4, 6, 7])
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 3, (2, 17, 4, 6)).astype(np.float32)
    logits = np.repeat(np.repeat(blocks, 8, 2), 8, 3)          # 32 x 48, ties
    idx_w, coords_w = jpr.uncertain_points_on_grid(jnp.asarray(nhwc(logits)), 300)
    idx, coords = pr.uncertain_points_on_grid(torch.from_numpy(logits), 300)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(coords_w))
    assert coords.dtype == torch.float32


def test_duplicate_points_last_wins_value_and_gradient():
    """Points landing on one cell: the last one's value is written and only
    it receives the gradient, as JAX's scatter-set and its gradient on the
    CPU; cells hit once and cells never hit as JAX's."""
    rng = np.random.default_rng(3)
    seg = rng.standard_normal((2, 3, 4, 5))
    idx = np.array([[1, 7, 1, 19, 7, 1, 0, 12], [3, 3, 3, 3, 2, 18, 18, 5]])
    vals = rng.standard_normal((2, 3, 8))
    weight = rng.standard_normal((2, 3, 4, 5))

    def jax_scatter(s, v):
        flat = s.reshape(2, 3, 20).transpose(0, 2, 1)            # (B, HW, C)
        out = jax.vmap(lambda f, i, u: f.at[i].set(u))(flat, jnp.asarray(idx),
                                                       v.transpose(0, 2, 1))
        return out.transpose(0, 2, 1).reshape(2, 3, 4, 5)

    with x64():
        want = np.asarray(jax_scatter(jnp.asarray(seg), jnp.asarray(vals)))
        gs, gv = jax.grad(lambda s, v: jnp.sum(jax_scatter(s, v) * weight),
                          argnums=(0, 1))(jnp.asarray(seg), jnp.asarray(vals))
    s = torch.tensor(seg, requires_grad=True)
    v = torch.tensor(vals, requires_grad=True)
    got = pr.scatter_points(s, torch.from_numpy(idx), v)
    (got * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(got.detach().numpy()[0, :, 0, 1], vals[0, :, 5])
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(gv))
    np.testing.assert_array_equal(s.grad.numpy(), np.asarray(gs))
    assert (v.grad.numpy()[0, :, [0, 2]] == 0).all()        # overwritten points


def test_point_loss_matches_jax():
    """Labels at clip(floor(c * side)), cross-entropy with the task's
    ignore id, or semi mode's override: JAX's value within 1e-6."""
    rng = np.random.default_rng(4)
    logits = 3.0 * rng.standard_normal((2, 17, 50))
    coords = np.concatenate([rng.random((2, 48, 2)), [[[1.0, 1.0], [0.0, 0.9999]]] * 2], 1)
    labels = rng.integers(0, 18, (2, 30, 40))
    for override in (None, 17, 5):
        with x64():
            want = float(jax_steps._point_loss(
                {"point_coords": jnp.asarray(coords),
                 "point_logits": jnp.asarray(logits.transpose(0, 2, 1))},
                jnp.asarray(labels), 2, override))
        got = float(point_loss({"point_coords": torch.from_numpy(coords),
                                "point_logits": torch.from_numpy(logits)},
                               torch.from_numpy(labels), 2, override))
        assert abs(got - want) <= 1e-6, override


def test_step_points_are_a_function_of_seed_and_step():
    dec = pr.PointRendDecoder((8, 8, 8, 8), num_points=10, oversample_ratio=2.0)
    a, b = step_points(dec, 3, 0, 5, "cpu"), step_points(dec, 3, 0, 5, "cpu")
    c = step_points(dec, 3, 0, 6, "cpu")
    assert a.over.shape == (3, 20, 2) and a.rand.shape == (3, 3, 2)
    assert torch.equal(a.over, b.over) and torch.equal(a.rand, b.rand)
    assert not torch.equal(a.over, c.over)
    assert has_point_head(GRAPH) and has_point_head(
        {"model": "EncDec", "decoder": {"model": "PointRend"}})
    assert not has_point_head({"model": "UPerNet"})


def test_pr_config_aliases():
    model = build_model({"model": "EncDec", "encoder": {"model": "ResNet18"},
                         "decoder": {"model": "PointRend", "pr_train_num_pts": 50,
                                     "pr_oversample_ratio": 2,
                                     "pr_importance_sample_ratio": 0.5,
                                     "pr_subdivision_num_pts": 100}}, 2, device="cpu")
    assert model.dec_model.counts == (100, 25, 25)
    assert model.dec_model.subdivision_num_points == 100


# ------------------------------------------------------- the whole graph

@pytest.fixture(scope="module")
def jax_pointrend():
    """float64 JAX EncDec-PointRend-R18: its variables, its eval forward
    of one seeded input, and one train step on the LossWrapper with the
    points its forward drew under the step's key."""
    images, labels = batch()
    spec = build_transform_pipeline(["pad"], {}, 2).device
    with x64(), concurrent.futures.ThreadPoolExecutor(2) as pool:
        model = jax_build_model(GRAPH, 2, dtype=jnp.float64)
        variables = numpy_variables(model, seed=6)
        x = np.random.default_rng(7).standard_normal((N_IMG, H, W, 3))
        # eagerly: under jit XLA contracts the f32 cell-centre arithmetic
        # (c / w + 0.5 / w, then c * w - 0.5) into fused multiply-adds,
        # which moves the float32 points by an ulp and the samples by ~4e-5;
        # op by op JAX rounds each operation as the port does. It runs in a
        # thread beside the train step's compile, as does the train-mode
        # forward below
        want = pool.submit(lambda: np.asarray(
            model.apply(variables, jnp.asarray(x), False)["logits"]))
        key = jax.random.PRNGKey(0)
        # the step's own keys: fold_in(key, step 0), then aug / points / dropout
        aug_key, points_key, dropout_key = jax.random.split(jax.random.fold_in(key, 0), 3)
        xa, _ = jax_augment_batch(aug_key, jnp.asarray(images), jnp.asarray(labels),
                                  spec, True)
        # the points the step draws: a jitted train-mode forward under the
        # step's keys (the step draws them under jit too)
        coords = pool.submit(lambda: np.asarray(jax.jit(
            lambda v, xa: model.apply(v, xa, True, mutable=["batch_stats"],
                                      rngs={"points": points_key,
                                            "dropout": dropout_key})[0]["point_coords"])(
            variables, xa)))
        tx = jax_make_optimizer(CONFIG["train"], jlr.make_schedule(CONFIG["train"], 1))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              apply_fn=model.apply, tx=tx)
        step = jax_steps.make_train_step(jax_build_loss(LOSS, 2), spec, 2,
                                         has_point_head=True, donate=False,
                                         train_metrics="full")
        new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels), key, 0)
        train = {"metrics": jax.tree.map(np.asarray, metrics),
                 "grads": jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9),
                                       new_state.opt_state[0].mu),
                 "stats": jax.tree.map(np.asarray, new_state.batch_stats),
                 "coords": coords.result()}
        want = want.result()
    return variables, x, want, images, labels, train


def _port(variables):
    port = build_model(GRAPH, 2, device="cpu").double()
    port.load_state_dict(bridge_encdec_pointrend(variables["params"],
                                                 variables["batch_stats"]), strict=True)
    return port


def test_pointrend_eval_subdivision_matches_jax_f64(jax_pointrend):
    """The eval forward (the coarse UPerNet, then two 2x subdivision steps
    of 784 points each) within 1e-6 of flax's."""
    variables, x, want = jax_pointrend[:3]
    port = _port(variables).eval()
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == {"logits", "deep_features"}
    assert got["logits"].shape == (N_IMG, 17, H, W) and got["logits"].dtype == torch.float64
    np.testing.assert_allclose(got["logits"].numpy(), want.transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


def test_pointrend_bridge_round_trips_through_port_state_dict(jax_pointrend):
    """The JAX package's porter (`port_encdec_pointrend`) applied to the
    bridge's output gives back the flax tree on every leaf."""
    variables = jax_pointrend[0]
    sd = bridge_encdec_pointrend(variables["params"], variables["batch_stats"])
    for key in ("dec_model.point_head.fc1.weight", "dec_model.point_head.predictor.bias",
                "dec_model.partial_upernet.ppm_conv.0.0.weight",
                "dec_model.partial_upernet.conv_last.1.weight", "enc_model.layer4.1.bn2.bias"):
        assert key in sd, key
    assert sd["dec_model.point_head.fc1.weight"].shape == (256, 512 + 256 + 128 + 64 + 17, 1)
    zeros = jax.tree.map(np.zeros_like, (variables["params"], variables["batch_stats"]))
    p2, s2 = port_state_dict("PointRend", {k: v.numpy() for k, v in sd.items()}, *zeros)
    for want, got in ((variables["params"], p2), (variables["batch_stats"], s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, v in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), v,
                                          err_msg=jax.tree_util.keystr(path))


def test_pointrend_train_step_matches_jax_at_injected_points(jax_pointrend):
    """One step at JAX's points: the total, the Lovász term and the
    point loss within 1e-5 of JAX's, the full-resolution confusion matrix
    equal, every parameter's gradient within 1e-5 relative L2, the new
    BatchNorm statistics within 1e-6; no kernel launches on the CPU."""
    variables, _, _, images, labels, want = jax_pointrend
    port = _port(variables)
    state = TrainState(port, make_optimizer(CONFIG["train"], port.parameters()),
                       lr.make_schedule(CONFIG["train"], 1))
    loss = build_loss(LOSS, 2, "cpu")
    step = make_train_step(loss, device_spec(["pad"]), 2, device="cpu", precision="fp32",
                           train_metrics="full", has_point_head=True)
    reset_launches()
    got = step(state, images, labels, 0, points=torch.from_numpy(want["coords"]))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert set(got) == {"loss", "LovaszSoftmax", "point_loss", "confusion_matrix",
                        "grad_norm"}
    for key in ("loss", "LovaszSoftmax", "point_loss"):
        assert abs(float(got[key]) - float(want["metrics"][key])) <= 1e-5, key
    assert float(got["point_loss"]) > 0
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(),
                                  want["metrics"]["confusion_matrix"])
    want_grads = bridge_encdec_pointrend(want["grads"], {})
    scale = np.sqrt(sum(float((p.grad ** 2).sum()) for p in port.parameters()))
    for key, p in port.named_parameters():
        w = want_grads[key].numpy()
        if np.linalg.norm(w) > 1e-9 * scale:
            assert rel_l2(p.grad.numpy(), w) <= 1e-5, key
        else:
            assert np.linalg.norm(p.grad.numpy() - w) <= 1e-9 * scale, key
    new_stats = bridge_encdec_pointrend({}, want["stats"])
    sd = port.state_dict()
    for key, v in new_stats.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=key)
    # the step's own draws: its points are a function of (seed, step)
    port2 = _port(variables)
    state2 = TrainState(port2, make_optimizer(CONFIG["train"], port2.parameters()),
                        lr.make_schedule(CONFIG["train"], 1))
    drawn = step(state2, images, labels, 0)
    assert np.isfinite(float(drawn["point_loss"]))
