"""The port's train slice against the JAX package: BatchNorm's train-mode
running statistics, the device augmentation, `downsample_labels`, the LR
tables, the optimisers, and one whole train step.

Inputs are made with numpy from a seed; random augmentation values are
drawn with jax.random exactly as the JAX `augment_batch` draws them and
handed to the port as an `AugmentDraws` (the port's own generator gives
other numbers by design). Tolerances:
  * float64 on both sides (BatchNorm statistics, the model, the
    optimisers): 1e-6 on activations and statistics, 1e-12 on optimiser
    updates of the same gradients;
  * float32 augmentation: 1e-6 on the colour ops, 1e-5 after the 37-tap
    blur (two 37-term sums in another order);
  * the train step: the loss runs in float32 inside both (the fused
    bucket Lovász casts its inputs), so loss and terms agree to 1e-5 and
    gradients to a relative L2 of 1e-5 (measured 1.1e-7); Adam's first
    update is about lr * sign(g), so new parameters are held to 1e-6, a
    hundredth of lr; the s8 confusion matrix is equal. The port turns
    uint8 into [0, 1] as XLA compiles `u8 / 255.0` (ops/augment.py
    `to_unit`): with a true division the inputs differ in the last bit,
    and at random weights and this tiny size the train-mode network
    amplifies that to about 1 % in the parameter gradients.
"""
import concurrent.futures
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.losses.fused_lovasz import (
    fused_two_scale_bucket_lovasz_s8 as jax_fused_loss)
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models.ocr import (
    ObjectAttention as JaxObjectAttention)
from miccai2021_cataract_semantic_segmentation_tpu.ops import augment as jaug
from miccai2021_cataract_semantic_segmentation_tpu.ops.misc import (
    downsample_labels as jax_downsample_labels)
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    DeviceAugmentSpec, device_spec)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS, reset_launches
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import ObjectAttention
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops import augment as aug
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.misc import downsample_labels
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import DataGroup
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import lr_schedule as lr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_ocrnet
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    make_train_step, step_draws)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
    train_metrics_source, train_steps)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
from test_torch_eval import numpy_variables

CONFIG = load_config(pathlib.Path(__file__).resolve().parents[1] / "configs"
                     / "OCRNet_rf_lvsz.json")
PAD_ONLY = ["pad"]


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
    """jax_enable_x64 for the block (the JAX side of the float64 runs)."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


# ---------------------------------------------------------------------------
# BatchNorm: train-mode running statistics as flax updates them
# ---------------------------------------------------------------------------

def test_batchnorm_running_stats_match_flax():
    """One train-mode forward of ObjectAttention, float64, from the same
    weights and non-trivial running statistics: the output and every new
    running mean and variance match flax's `mutable=["batch_stats"]` to
    1e-6. With torch's own BatchNorm2d the variances of the f_object and
    f_down stacks (n = B * K = 34 values per channel) are 3 % off."""
    c, kc, k = 16, 8, 17
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, c))
    ctx = rng.standard_normal((2, k, c))
    jmod = JaxObjectAttention(key_channels=kc, out_channels=c, dtype=jnp.float64)
    with x64():
        variables = jax.tree.map(np.asarray, jmod.init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx), False))
        params, stats = variables["params"], variables["batch_stats"]
        for tree in (params, stats):
            for stack in tree.values():
                for name, leaves in stack.items():
                    for leaf in leaves:
                        if leaf in ("scale", "var"):
                            leaves[leaf] = rng.uniform(0.5, 1.5, leaves[leaf].shape)
                        elif leaf in ("mean", "bias"):
                            leaves[leaf] = 0.1 * rng.standard_normal(leaves[leaf].shape)
        want, mutated = jmod.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), jnp.asarray(ctx), True,
                                   mutable=["batch_stats"])
        want = np.asarray(want)
        new_stats = jax.tree.map(np.asarray, mutated["batch_stats"])
    prefix = "spatial_ocr_head.object_context_block."
    sd = bridge_ocrnet({"ocr": {"attn": params}}, {"ocr": {"attn": stats}})
    port = ObjectAttention(c, kc).double()
    port.load_state_dict({key[len(prefix):]: v for key, v in sd.items()},
                         strict=True)
    port.train()
    got = port(nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), want.transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    want_sd = bridge_ocrnet({"ocr": {"attn": params}},
                            {"ocr": {"attn": new_stats}})
    n_checked = 0
    for key, v in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[prefix + key].numpy(),
                                       rtol=0, atol=1e-6, err_msg=key)
            n_checked += 1
    assert n_checked == 12                     # 6 BatchNorms x mean, var
    assert all(isinstance(m, BatchNorm2d) for m in port.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


def test_batchnorm_eval_mode_is_torchs():
    bn = BatchNorm2d(4).double()
    ref = torch.nn.BatchNorm2d(4).double()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 3, 5)))
    for m in (bn, ref):
        m.running_mean.fill_(0.2)
        m.running_var.fill_(1.5)
        m.eval()
    assert torch.equal(bn(x), ref(x))
    bn.train()
    ref.train()
    assert torch.allclose(bn(x), ref(x), rtol=0, atol=1e-12)
    assert torch.equal(bn.running_mean, ref.running_mean)
    n = x.numel() // 4                           # unbiased -> biased variance
    want = 0.9 * 1.5 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(bn.running_var, want, rtol=0, atol=1e-12)
    assert not torch.allclose(ref.running_var, want, rtol=0, atol=1e-4 / n)
    assert int(bn.num_batches_tracked) == 1


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

def _images(seed=0, shape=(3, 9, 11, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue"])
def test_color_op_matches_jax(op):
    x = _images()
    f = np.asarray([0.7, 1.0, 1.4] if op != "hue" else [-0.05, 0.01, 0.049],
                   np.float32)
    jfn = getattr(jaug, f"adjust_{op}")
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(x), jnp.asarray(f)))
    got = getattr(aug, f"adjust_{op}")(torch.from_numpy(x), torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_hsv_round_trip_matches_jax():
    x = _images(1, (2, 13, 17, 3))
    x[0, 0, :6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                   [0, 1, 0], [0, 0, 1]]               # grey, primaries
    hsv = aug.rgb_to_hsv(torch.from_numpy(x))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug.rgb_to_hsv(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    back = aug.hsv_to_rgb(hsv)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jaug.hsv_to_rgb(jaug.rgb_to_hsv(jnp.asarray(x)))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sigma", [3, 4, 5, 6])
def test_gaussian_blur_matches_jax(sigma):
    x = _images(2, (2, 40, 45, 3))
    sig = np.asarray([sigma, 0], np.float32)            # the second: identity
    np.testing.assert_allclose(
        aug.gaussian_taps(torch.from_numpy(sig)).numpy(),
        np.stack([np.asarray(jaug._gaussian_taps(jnp.float32(s))) for s in sig]),
        rtol=0, atol=1e-7)
    want = np.asarray(jax.vmap(jaug.gaussian_blur)(jnp.asarray(x), jnp.asarray(sig)))
    got = aug.gaussian_blur(torch.from_numpy(x), torch.from_numpy(sig))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), x[1], rtol=0, atol=1e-6)


def jax_draws(key, n: int, spec: DeviceAugmentSpec) -> aug.AugmentDraws:
    """The values the JAX `augment_batch(key, ...)` draws, key for key."""
    rngs = jax.random.split(key, n + 2)
    flip = np.asarray(jax.random.uniform(rngs[0], (n,)) < 0.5)
    kp, ks = jax.random.split(rngs[1])
    do = np.asarray(jax.random.uniform(kp, (n,)) < 0.05)
    sigma = np.asarray(jax.random.randint(ks, (n,), 3, 7)).astype(np.float32)
    jitter, gate = [], []
    for i in range(n):
        kf, kj = jax.random.split(rngs[2 + i], 2)
        keys = jax.random.split(kj, 4)
        jitter.append([float(jax.random.uniform(k, minval=lo, maxval=hi))
                       for k, (lo, hi) in zip(keys, aug.jitter_ranges(spec))])
        gate.append(bool(jax.random.uniform(kf) < 0.7))
    return aug.AugmentDraws(
        torch.from_numpy(flip), torch.from_numpy(do),
        torch.from_numpy(np.where(do, sigma, 0.0).astype(np.float32)),
        torch.tensor(jitter, dtype=torch.float32), torch.tensor(gate))


def _key_with_blur(n: int):
    """The first PRNG key (by seed) whose draws blur at least one image."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        kp = jax.random.split(jax.random.split(key, n + 2)[1])[0]
        if bool(jnp.any(jax.random.uniform(kp, (n,)) < 0.05)):
            return key
    raise AssertionError("no key blurs")


@pytest.mark.parametrize("transforms", [
    ["pad", "flip", "blur", "colorjitter"],
    ["pad", "flip", "blur", "colorjitter", "torchvision_normalise"],
    ["flip", "blur", "pseudo_colorjitter", {"strength": 3}],
    ["flip"], ["torchvision_normalise"], ["pad"]])
def test_augment_batch_matches_jax(transforms):
    n = 4
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (n, 30, 41, 3), dtype=np.uint8)
    labels = rng.integers(0, 18, (n, 30, 41), dtype=np.uint8)
    jspec = build_transform_pipeline(transforms, {}, 2).device
    spec = device_spec(transforms)
    assert spec == DeviceAugmentSpec(**vars(jspec))
    key = _key_with_blur(n)
    draws = jax_draws(key, n, spec)
    assert bool(draws.blur.any()) and bool(draws.flip.any())
    assert not bool(draws.flip.all())
    want_x, want_l = jaug.augment_batch(key, jnp.asarray(images),
                                        jnp.asarray(labels), jspec, True)
    got_x, got_l = aug.augment_batch(torch.from_numpy(images),
                                     torch.from_numpy(labels), spec, draws)
    assert got_x.dtype == torch.float32 and got_l.dtype == torch.int64
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-5 if spec.blur else 1e-6)


def test_draws_follow_the_seed_and_step():
    spec = device_spec(CONFIG["data"]["transforms"])
    a, b = step_draws(spec, 8, 0, 5), step_draws(spec, 8, 0, 5)
    c = step_draws(spec, 8, 0, 6)
    for f in ("flip", "blur", "sigma", "jitter", "pseudo_gate"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.jitter, c.jitter)
    many = aug.draw_augment(spec, 4000, torch.Generator().manual_seed(0))
    assert abs(float(many.flip.float().mean()) - 0.5) < 0.03
    assert abs(float(many.blur.float().mean()) - 0.05) < 0.015
    assert set(many.sigma[many.blur].tolist()) == {3.0, 4.0, 5.0, 6.0}
    assert float(many.sigma[~many.blur].abs().max()) == 0.0
    for i, (lo, hi) in enumerate(aug.JITTER_RANGES):
        assert lo <= float(many.jitter[:, i].min()) < float(many.jitter[:, i].max()) <= hi


def test_host_transforms_raise():
    """The device spec of a list with a host transform is the JAX
    package's (the train pad off where "crop" is listed); `train_steps`,
    which feeds in-memory batches to the device augmentation alone,
    refuses such a list."""
    for name in ("rot", "shift", "shear", "affine", "crop"):
        want = build_transform_pipeline(["pad", name], {}, 2).device
        assert device_spec(["pad", name]) == DeviceAugmentSpec(**vars(want))
        assert device_spec(["pad", name]).pad == (name != "crop")
    with pytest.raises(ValueError, match="host transforms"):
        train_steps(None, {**CONFIG, "data": {**CONFIG["data"], "transforms": ["crop"]}},
                    None, None, [], device="cpu")


@pytest.mark.parametrize("big,small", [((544, 960), (68, 120)), ((68, 96), (9, 12)),
                                       ((540, 960), (68, 120)), ((5, 7), (9, 11))])
def test_downsample_labels_bit_equal(big, small):
    labels = np.random.default_rng(4).integers(0, 18, (2, *big)).astype(np.int32)
    want = np.asarray(jax_downsample_labels(jnp.asarray(labels), small))
    got = downsample_labels(torch.from_numpy(labels), small)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# LR schedules and optimisers
# ---------------------------------------------------------------------------

LR_FORMS = {
    "static": {},
    "piecewise_static": {"lr_params": {"piecewise_static_schedule": [[1, 1.0], [4, 0.3]]}},
    "exponential": {"lr_params": 0.9},
    "polynomial": {},
    "cosine": {"lr_restart_vals": [0.5, 0.25]},
}


@pytest.mark.parametrize("batchwise", [False, True])
@pytest.mark.parametrize("form", list(LR_FORMS))
def test_lr_table_matches_jax(form, batchwise):
    cfg = {"learning_rate": 3e-4, "epochs": 7, "lr_fct": form,
           "lr_restarts": [3, 5], "lr_restart_vals": 0.5,
           "lr_batchwise": batchwise, **LR_FORMS[form]}
    np.testing.assert_array_equal(lr.build_multiplier_table(cfg, 11),
                                  jlr.build_multiplier_table(cfg, 11))
    for steps_per_epoch in (4, [2, 5, 3]):
        want = np.asarray(jlr.make_schedule(cfg, steps_per_epoch)(jnp.arange(-2, 40)))
        sched = lr.make_schedule(cfg, steps_per_epoch)
        got = np.asarray([sched(s) for s in range(-2, 40)], np.float32)
        np.testing.assert_array_equal(got, want)


OPTIMISERS = {
    "adam": {},
    "adamw": {"weight_decay": 0.05},
    "sgd": {"optimizer": "sgd", "momentum": 0.8},
    "adam-clip": {"grad_clip": 2.0},
    "sgd-clip": {"optimizer": "sgd", "grad_clip": 2.0},
}


@pytest.mark.parametrize("name", list(OPTIMISERS))
def test_optimizer_matches_optax(name):
    """Three updates in float64 from the same parameters and gradients, at
    a batchwise exponential schedule (the LR of update t is schedule(t))."""
    cfg = {"learning_rate": 0.1, "epochs": 3, "lr_fct": "exponential",
           "lr_params": 0.5, "lr_batchwise": True, **OPTIMISERS[name]}
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.standard_normal(s) for s in shapes]
    grads = [[(1.5 if t == 1 else 0.3) * rng.standard_normal(s) for s in shapes]
             for t in range(3)]                        # step 1 is clipped
    with x64():
        tx = jax_make_optimizer(cfg, jlr.make_schedule(cfg, 1))
        jp = [jnp.asarray(a) for a in p0]
        st = tx.init(jp)
        for g in grads:
            upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
            jp = [p + u for p, u in zip(jp, upd)]
        want = [np.asarray(p) for p in jp]
    params = [torch.tensor(a, requires_grad=True) for a in p0]
    state = TrainState(None, make_optimizer(cfg, params),
                       lr.make_schedule(cfg, 1), cfg.get("grad_clip"))
    for g in grads:
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        state.apply_gradients([p.grad for p in params])
    assert state.step == 3
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# One whole train step against the JAX step
# ---------------------------------------------------------------------------

N_IMG, H, W = 2, 64, 96


def step_batch(seed=8, h=H, w=W):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (N_IMG, h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    images = rng.integers(0, 256, (N_IMG, h, w, 3), dtype=np.uint8)
    return images, labels


@pytest.fixture(scope="module")
def jax_step():
    """The JAX train step (Adam at the flagship LR, TwoScale bucket Lovász,
    s8 train metrics, pad-only augmentation) from numpy-filled float64
    weights on one 2x64x96 batch, and the train-mode forward's stride-8
    logits with the loss's gradient with respect to them."""
    graph, task = CONFIG["graph"], 2
    model = jax_build_model(graph, task, dtype=jnp.float64)
    variables = numpy_variables(model, seed=2)
    images, labels = step_batch()
    spec = build_transform_pipeline(PAD_ONLY, {}, task).device
    lcfg = CONFIG["loss"]
    with x64():
        schedule = jlr.make_schedule(CONFIG["train"], 1)
        tx = jax_make_optimizer(CONFIG["train"], schedule)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              apply_fn=model.apply, tx=tx)
        step = jax_make_train_step(jax_build_loss(lcfg, task), spec, task,
                                   donate=False, train_metrics="s8")
        x, lbl = jaug.augment_batch(jax.random.PRNGKey(0), jnp.asarray(images),
                                    jnp.asarray(labels), spec, True)

        def s8_and_grads(v, x):
            out, _ = model.apply(v, x, True, mutable=["batch_stats"])
            s8 = (out["interm_logits_s8"], out["logits_s8"])
            loss, grads = jax.value_and_grad(
                lambda a, b: jax_fused_loss(a, b, lbl, lcfg["interm"]["weight"],
                                            lcfg["final"]["weight"],
                                            n_buckets=lcfg["lovasz_buckets"]),
                argnums=(0, 1))(*s8)
            return s8, loss, grads

        # the s8 forward and its loss gradient in a thread: its tracing and
        # XLA's work overlap the train step's
        pool = concurrent.futures.ThreadPoolExecutor(1)
        s8_out = pool.submit(jax.jit(s8_and_grads), variables, x)
        new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                                  jax.random.PRNGKey(0), 0)
        mu = new_state.opt_state[0].mu          # (1 - b1) * g after one update
        grads = jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), mu)
        s8, loss, s8_grads = jax.block_until_ready(s8_out.result())
        pool.shutdown()
        result = {
            "metrics": jax.tree.map(np.asarray, metrics),
            "params": jax.tree.map(np.asarray, new_state.params),
            "stats": jax.tree.map(np.asarray, new_state.batch_stats),
            "grads": grads, "step": int(new_state.step), "loss": float(loss),
            "s8": [np.asarray(t) for t in s8],
            "s8_grads": [np.asarray(g) for g in s8_grads],
        }
    return variables, images, labels, result


def _port_model(variables):
    port = build_model(CONFIG["graph"], 2, device="cpu").double()
    port.load_state_dict(bridge_ocrnet(variables["params"],
                                       variables["batch_stats"]), strict=True)
    return port


@pytest.fixture(scope="module")
def port_step(jax_step):
    variables, images, labels, _ = jax_step
    port = _port_model(variables)
    cfg = dict(CONFIG, precision="fp32")
    state = TrainState(port, make_optimizer(cfg["train"], port.parameters()),
                       lr.make_schedule(cfg["train"], 1))
    step = make_train_step(build_loss(cfg["loss"], 2, "cpu"),
                           device_spec(PAD_ONLY), 2, device="cpu",
                           precision="fp32", train_metrics=train_metrics_source(cfg))
    reset_launches()
    metrics = step(state, images, labels, 0)
    assert {k: v.launches for k, v in KERNELS.items()} == dict.fromkeys(KERNELS, 0)
    return state, metrics


def test_train_step_loss_and_metrics_match_jax(jax_step, port_step):
    want = jax_step[3]
    state, got = port_step
    assert state.step == want["step"] == 1
    assert set(got) == {"loss", "TwoScaleLoss", "confusion_matrix", "grad_norm"}
    for key in ("loss", "TwoScaleLoss"):
        assert abs(float(got[key]) - float(want["metrics"][key])) <= 1e-5
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(),
                                  want["metrics"]["confusion_matrix"])
    assert int(got["confusion_matrix"].sum()) > 0
    assert abs(float(got["grad_norm"]) / float(want["metrics"]["grad_norm"]) - 1) <= 1e-6


def test_train_step_grads_params_and_stats_match_jax(jax_step, port_step):
    """Every parameter's gradient within a relative L2 of 1e-5 (the two
    convolution biases that feed a BatchNorm have an exact gradient of 0:
    they are held at 1e-9 of the global norm instead), the new parameters
    to 1e-6 (a hundredth of lr) and the new BatchNorm statistics to 1e-6."""
    variables, *_, want = jax_step
    port = port_step[0].model
    grads = {k: p.grad for k, p in port.named_parameters()}
    want_grads = bridge_ocrnet(want["grads"], {})
    scale = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    for key, g in grads.items():
        w = want_grads[key].numpy()
        if np.linalg.norm(w) > 1e-9 * scale:
            assert rel_l2(g.numpy(), w) <= 1e-5, key
        else:
            assert np.linalg.norm(g.numpy() - w) <= 1e-9 * scale, key
    sd = port.state_dict()
    for key, v in bridge_ocrnet(want["params"], want["stats"]).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)
    # every parameter moved by about lr (Adam's first update)
    before = _port_model(variables).state_dict()
    moved = max(float((sd[k] - before[k]).abs().max()) for k in grads)
    assert 0.5e-4 < moved <= 1.01e-4


def test_train_forward_and_s8_gradients_match_jax(jax_step):
    """The train-mode forward's stride-8 logits, and the fused loss's
    gradient with respect to them (B2's plain version)."""
    variables, images, labels, want = jax_step
    port = _port_model(variables).train()
    x, lbl = aug.augment_batch(torch.from_numpy(images), torch.from_numpy(labels),
                               device_spec(PAD_ONLY), step_draws(
                                   device_spec(PAD_ONLY), N_IMG, 0, 0))
    out = port(x.permute(0, 3, 1, 2).double(), full_res=())
    # leaves of their own: in float64 `interm_logits_s8` is the tensor that
    # also feeds the OCR head
    s8 = {k: out[k].detach().clone().requires_grad_(True)
          for k in ("interm_logits_s8", "logits_s8")}
    for got, w in zip(s8.values(), want["s8"]):
        np.testing.assert_allclose(got.detach().numpy(), w.transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-6)
    total, _ = build_loss(CONFIG["loss"], 2, "cpu")(s8, lbl, epoch=0, step=0)
    total.backward()
    assert abs(float(total) - want["loss"]) <= 1e-5
    for t, w in zip(s8.values(), want["s8_grads"]):
        assert rel_l2(t.grad.numpy(), w.transpose(0, 3, 1, 2)) <= 1e-5


def test_train_steps_runs_the_epoch_core():
    """`train_steps` on a tiny set: one step per batch, the loss falls on
    a repeated batch, the matrix counts every stride-8 label, and the CPU
    path launches no kernel."""
    images, labels = step_batch(9, 32, 48)
    model = build_model(CONFIG["graph"], 2, device="cpu")
    reset_launches()
    res = train_steps(model, dict(CONFIG, precision="fp32"), images, labels,
                      [np.array([0, 1])] * 4, device="cpu", seed=1)
    assert res["state"].step == 4 and len(res["step_losses"]) == 4
    assert all(np.isfinite(res["step_losses"]))
    assert res["step_losses"][-1] < res["step_losses"][0]
    s8 = downsample_labels(aug.pad_reflect_hw(torch.from_numpy(labels)), (5, 6))
    assert res["confusion_matrix"].sum() == 4 * int((s8 < 17).sum())
    assert res["frames_per_s"] > 0 and np.isfinite(res["miou"])
    assert {k: v.launches for k, v in KERNELS.items()} == dict.fromkeys(KERNELS, 0)
    assert model.training


@pytest.mark.parametrize("kwargs,item", [
    # the ids are the ones these cases had while the semi step (item 11)
    # and the steps over several GPUs (item 15) raised; each now builds
    pytest.param({"semi": {"threshold": 0.9, "ignore_id": 17, "n_shards": 2},
                  "group": DataGroup(rank=0, size=2, n_use=2)}, "15",
                 id="kwargs0-11"),
    pytest.param({"has_point_head": True}, "12", id="kwargs1-12"),
    pytest.param({"group": DataGroup()}, "15", id="kwargs2-15")])
def test_train_step_paths_of_later_slices_raise(kwargs, item):
    """The paths of later slices build a step: the point head (item 12;
    tests/test_torch_pointrend.py runs it), the semi step over two shard
    blocks and the step under a data group (item 15;
    tests/test_torch_parallel.py runs them). A semi layout of other shard
    blocks than the group's ranks is refused."""
    assert callable(make_train_step(None, device_spec(PAD_ONLY), 2, device="cpu",
                                    **kwargs))
    if "semi" in kwargs:
        with pytest.raises(ValueError, match="2 shard blocks, but 1 ranks"):
            make_train_step(None, device_spec(PAD_ONLY), 2, device="cpu",
                            semi=kwargs["semi"])

