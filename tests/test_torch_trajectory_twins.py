"""The port's sort-vs-bucket training twins (tools/trajectory_twins.py of
the port package) against the repository's JAX tool:

  * `make_learnable_frames` bit-equal to the JAX tool's for seeds 0-2;
  * each twin's first-step loss equal to the JAX tool's `run_twin` (one
    step, its model in float32 instead of bf16) within 1e-5: the port's
    twin starts from the JAX tool's flax init, bridged
    (train/bridge.py:bridge_ocrnet), and takes the augmentation the JAX
    step draws from its key (fold_in(PRNGKey(1), 0)), so the two compute
    the same float32 function (XLA and torch sum in other orders);
  * the JAX tool's short-horizon properties at CPU scale
    (tests/test_trajectory_twins.py) on the port's own init and draws: the
    plain bucket twin (B 1024) and the dithered one (B 256) each against
    the sort twin over 8 steps.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miccai2021_cataract_semantic_segmentation_tpu.models as jax_models
import miccai2021_cataract_semantic_segmentation_tpu.train.state as jax_state
from tools import trajectory_twins as jax_twins

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import DeviceAugmentSpec
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import AugmentDraws
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import trajectory_twins
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_ocrnet
from test_torch_train import jax_draws

# the JAX tool's CPU scale (tests/test_trajectory_twins.py)
SCALE = dict(backbone="resnet18", n_buckets=1024, pad=False, lr=1e-3)
H, W, BS, POOL = 64, 128, 4, 8
FIRST_HW = (32, 64)     # the first-step check's frames: smaller, quicker JAX compiles
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pool(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    images, labels = trajectory_twins.make_learnable_frames(rng, POOL, h, w, 17)
    return [(images[k:k + BS], labels[k:k + BS]) for k in range(0, POOL - BS + 1, BS)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_learnable_frames_bit_equal_jax(seed):
    got = trajectory_twins.make_learnable_frames(np.random.default_rng(seed), 3, 40, 56, 17)
    want = jax_twins.make_learnable_frames(np.random.default_rng(seed), 3, 40, 56, 17)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.fixture(scope="module")
def jax_first_steps():
    """The JAX tool's run_twin, one step of each twin in float32, and the
    flax init both trained from (made by create_train_state)."""
    batches = [(jnp.asarray(i), jnp.asarray(lb)) for i, lb in pool(0, *FIRST_HW)]
    build = jax_models.build_model
    graph = {"model": "OCRNet", "backbone": SCALE["backbone"], "out_stride": 8}
    model = build(graph, 2, dtype=jnp.float32)
    sample = jnp.zeros((BS, *FIRST_HW, 3))        # run_twin's, without the pad
    # flax's init jitted (eager, tens of seconds on a CPU), once for both
    # twins: its values are the eager init's; numpy, as the step donates
    # the state's buffers
    init = jax.tree.map(np.asarray, jax.jit(lambda r, x: model.init(
        {"params": r, "points": r, "dropout": r}, x, False))(jax.random.PRNGKey(0), sample))

    def build_f32(graph, task, dtype=None):
        return build(graph, task, dtype=jnp.float32)

    def create_train_state(model, rng, x, train_cfg, schedule, train=False):
        assert x.shape == sample.shape and not train
        assert np.array_equal(np.asarray(rng), np.asarray(jax.random.PRNGKey(0)))
        variables = jax.tree.map(jnp.asarray, init)
        tx = jax_state.make_optimizer(train_cfg, schedule)
        return jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
            apply_fn=model.apply, tx=tx)

    def first_loss(impl):
        losses, _ = jax_twins.run_twin(impl, batches, h=FIRST_HW[0], w=FIRST_HW[1],
                                       n_steps=1, **SCALE)
        return float(losses[0])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_models, "build_model", build_f32)
        mp.setattr(jax_state, "create_train_state", create_train_state)
        # the two twins' train steps compile at once (XLA's compiler runs
        # outside the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(2) as threads:
            out = dict(zip(("sort", "bucket"), threads.map(first_loss, ("sort", "bucket"))))
    return out, bridge_ocrnet(init["params"], init["batch_stats"])


def _jax_step_draws(n):
    """The draws of the JAX step's augmentation at step 0 under key 1."""
    spec = DeviceAugmentSpec(pad=False, flip=True, blur=True, colorjitter=True)
    aug_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0), 3)[0]
    return jax_draws(aug_key, n, spec)


@pytest.mark.parametrize("impl", ["sort", "bucket"])
def test_first_step_loss_equals_jax(jax_first_steps, impl):
    want, init = jax_first_steps
    draws = _jax_step_draws(BS)
    assert isinstance(draws, AugmentDraws)
    losses, _ = trajectory_twins.run_twin(
        impl, pool(0, *FIRST_HW), n_steps=1, device="cpu", init=init, draws=[draws],
        **SCALE)
    assert abs(float(losses[0]) - want[impl]) <= LOSS_TOL, (losses[0], want[impl])


@pytest.fixture(scope="module")
def port_twins():
    """The sort twin and the two bucket twins on the port's own init and
    draws, 8 steps at the JAX tool's CPU scale."""
    batches = pool()
    runs = {"sort": dict(impl="sort"), "bucket": dict(impl="bucket"),
            "dither": dict(impl="bucket", n_buckets=256, dither=True)}
    return {name: trajectory_twins.run_twin(
        kw.pop("impl"), batches, n_steps=8, device="cpu", **{**SCALE, **kw})[0]
        for name, kw in runs.items()}


@pytest.mark.parametrize("arm,first_gap,max_gap", [("bucket", 1e-3, 0.06),
                                                   ("dither", 4e-3, 0.08)])
def test_short_horizon_twins(port_twins, arm, first_gap, max_gap):
    """tests/test_trajectory_twins.py's bars: the first-step losses within
    the bucket quantisation's envelope, the twins within a few percent
    over 8 steps, both learning."""
    l_sort, l_bucket = port_twins["sort"], port_twins[arm]
    assert abs(l_sort[0] - l_bucket[0]) < first_gap
    assert np.abs(l_sort - l_bucket).max() < max_gap, (l_sort, l_bucket)
    assert min(l_sort[4:]) < l_sort[0] - 0.01
    assert min(l_bucket[4:]) < l_bucket[0] - 0.01


def test_cpu_scale_report_has_the_jax_keys():
    """`main --cpu-scale --device cpu` (one step) reports the JAX tool's
    keys, and the ms a step of each twin."""
    jax_keys = {"n_steps", "n_buckets", "edges", "dither", "data_seed", "loss_start_sort",
                "loss_final_sort", "loss_final_bucket", "max_abs_loss_divergence",
                "mean_abs_loss_divergence", "final_tail_divergence",
                "rel_param_distance", "losses_sort", "losses_bucket"}
    r = trajectory_twins.main(["--cpu-scale", "--steps", "1", "--device", "cpu"])
    assert jax_keys <= set(r) and r["n_steps"] == 1 and len(r["losses_bucket"]) == 1
    assert r["ms_per_step_sort"] > 0 and r["ms_per_step_bucket"] > 0
    assert r["losses_sort"][0] == pytest.approx(r["losses_bucket"][0], abs=1e-3)
