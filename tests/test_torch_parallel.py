"""Training and serving over several ranks (parallel/, ROADMAP item 15)
against the JAX package over a mesh of CPU devices, and against one
process.

The port's side runs on two gloo ranks, each a process of its own with one
intra-op thread and the port alone imported (parallel/launch.py, a
FileStore in a temporary directory; tests/torch_parallel_jobs.py). One
module fixture starts them for the steps and the Trainer, and the JAX
side compiles in this process while they run.

- Global BatchNorm: the two ranks' forward, input gradients, summed
  parameter gradients and running statistics equal one process's
  BatchNorm over the concatenated batch (float64, 1e-12), with the biased
  running variance.
- The flagship's loss over two ranks: OCRNet-R18 with the flagship's
  two-scale bucket Lovász (B1/B2's plain versions here; the Pallas kernels
  in interpret mode under shard_map there), pad and flip, a global batch
  of 4 at 64x96, Adam, float64 weights: the 2-rank step against JAX
  `make_train_step(mesh=<2 devices>)`, its flips drawn by JAX for the
  global batch and sliced by each rank. The loss and its term, the summed
  confusion matrix, grad_norm, the parameters after Adam and the
  BatchNorm statistics, on both ranks, within 1e-6; the one-process step
  lies further than that from it. This step is `tools/sharded_twins.py`'s
  `arm` at float64, so the twin's per-rank loss at step 0 is JAX's
  2-shard number.
- The semi step over two shard blocks (EncDec-UPerNet-R18 narrowed,
  cross-entropy, pad, float64) against JAX's at n_shards 2, within 1e-6.
- The Trainer at world 2 on a synthetic PNG tree (HRNetv2-W4, bucket
  Lovász, pad and flip, batch 4): each rank feeds its half of every index
  batch (default and adaptive loaders); the epoch metrics, validation and
  weights are equal on both ranks, and validation equals the one-process
  `validate` of the same weights; rank 1 writes no checkpoint, info.json
  or ind_dist.npz; a world-2 resume is bit-equal to the uninterrupted
  world-2 run; a labelled batch of 3 leaves rank 1 out and rank 0's run is
  the one-process run. Every loader's index stream at world 2 is the
  one-process stream, and a semi Trainer's shard-blocked batches at world
  2 equal the JAX Trainer's over a 2-device mesh.
- The twins: `tools/sharded_twins.py`'s tiny path (one process against two
  ranks, 8 steps) within the JAX twins test's bars.
- The serving export over a mesh of two CPU devices at batch 4.
"""
import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from miccai2021_cataract_semantic_segmentation_tpu.data import ArrayDataset as JaxArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu.data import dataframe as jax_df
from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.parallel import make_mesh
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import sharded_twins
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_encdec_upernet, bridge_ocrnet)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import EvalSpec
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
from test_torch_eval import numpy_variables
from test_torch_train import jax_draws, x64
from test_torch_trainer_train import write_frames
import torch_parallel_jobs as jobs

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
FLAGSHIP = load_config(ROOT / "configs" / "OCRNet_rf_lvsz.json")
R18 = {"model": "OCRNet", "backbone": "resnet18"}
STEP_TRANSFORMS = ["pad", "flip"]
SEMI_GRAPH = {"model": "EncDec", "encoder": {"model": "ResNet18"},
              "decoder": {"model": "UPerNet", "ppm_num_ch": 16, "fpn_num_ch": 16}}
SEMI_LOSS = {"name": "SemiSupervisedLoss", "labeled": {"name": "CrossEntropyLoss"},
             "unlabeled": {"name": "CrossEntropyLoss", "weight": 0.5}}
SEMI = {"threshold": 0.12, "ignore_id": 17, "n_shards": 2}
STEPS_PER_EPOCH = 100                  # the LR schedule's, on both sides
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocky(n, h, w, seed):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (n, h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8), labels


def jax_mesh_step(graph, loss_cfg, images, labels, seed, semi=None):
    """One float64 JAX train step over a mesh of two CPU devices from
    numpy-filled weights: its metrics, new parameters and BatchNorm
    statistics."""
    model = jax_build_model(graph, 2, dtype=jnp.float64)
    variables = numpy_variables(model, seed=seed)
    spec = build_transform_pipeline(STEP_TRANSFORMS if semi is None else ["pad"], {},
                                    2).device
    train = FLAGSHIP["train"]
    with x64():
        tx = jax_make_optimizer(train, jlr.make_schedule(train, STEPS_PER_EPOCH))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              apply_fn=model.apply, tx=tx)
        mesh = make_mesh(devices=jax.devices()[:2])
        step = jax_make_train_step(jax_build_loss(loss_cfg, 2), spec, 2, donate=False,
                                   train_metrics="s8", mesh=mesh, semi=semi,
                                   sharded_loss_check_vma=semi is not None)
        rows = NamedSharding(mesh, P("data"))
        new_state, metrics = step(jax.device_put(state, NamedSharding(mesh, P())),
                                  jax.device_put(jnp.asarray(images), rows),
                                  jax.device_put(jnp.asarray(labels), rows),
                                  jax.random.PRNGKey(0), 0)
        return {"metrics": jax.tree.map(np.asarray, metrics),
                "params": jax.tree.map(np.asarray, new_state.params),
                "stats": jax.tree.map(np.asarray, new_state.batch_stats)}


# ---------------------------------------------------------------------------
# the steps: BatchNorm, the flagship's loss, the semi step
# ---------------------------------------------------------------------------

def _bn_payload():
    rng = np.random.default_rng(0)
    bn = BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(5)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(5)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
    return {"x": torch.from_numpy(3 * rng.standard_normal((4, 5, 6, 7)) + 2),
            "cot": torch.from_numpy(rng.standard_normal((4, 5, 6, 7))),
            "state": {k: v.clone() for k, v in bn.state_dict().items()}}


def _steps_payload(tmp):
    """The steps' payload (written to `tmp`) and what the JAX side needs."""
    flag_images, flag_labels = blocky(4, 64, 96, 8)
    semi_images, semi_labels = blocky(8, 48, 64, 6)
    # shard-blocked: each rank's block of 4 is [2 labelled | 2 unlabelled]
    semi_labels[[2, 3, 6, 7]] = 17
    flag_vars = numpy_variables(jax_build_model(R18, 2, dtype=jnp.float64), seed=2)
    semi_vars = numpy_variables(jax_build_model(SEMI_GRAPH, 2, dtype=jnp.float64), seed=5)
    with x64():
        # the JAX step's flips of the global batch: its augmentation key
        # is the first of split(fold_in(rng, step), 3)
        spec = build_transform_pipeline(STEP_TRANSFORMS, {}, 2).device
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), 3)[0]
        draws = jax_draws(key, 4, spec)
    assert 0 < int(draws.flip.sum()) < 4
    cfg = {"graph": R18, "loss": FLAGSHIP["loss"], "transforms": STEP_TRANSFORMS,
           "train": FLAGSHIP["train"], "precision": "fp32",
           "steps_per_epoch": STEPS_PER_EPOCH}
    flagship = {"cfg": cfg, "dtype": torch.float64, "n_steps": 1, "device": "cpu",
                "state_dict": bridge_ocrnet(flag_vars["params"], flag_vars["batch_stats"]),
                "batches": [(flag_images, flag_labels)], "draws": [draws]}
    semi = {"cfg": dict(cfg, graph=SEMI_GRAPH, loss=SEMI_LOSS, transforms=["pad"],
                        semi=SEMI),
            "dtype": torch.float64, "n_steps": 1, "device": "cpu",
            "state_dict": bridge_encdec_upernet(semi_vars["params"],
                                                semi_vars["batch_stats"]),
            "batches": [(semi_images, semi_labels)]}
    path = tmp / "payload.pt"
    torch.save({"bn": _bn_payload(), "runs": ["flagship", "semi"],
                "flagship": flagship, "semi": semi}, path)
    return path, (flag_images, flag_labels, semi_images, semi_labels, cfg, flagship, draws)


def _steps_jax_side(path, prep):
    """The JAX steps over a 2-device mesh and the port's one-process step."""
    flag_images, flag_labels, semi_images, semi_labels, cfg, flagship, draws = prep
    want = jax_mesh_step(R18, FLAGSHIP["loss"], flag_images, flag_labels, 2)
    want_semi = jax_mesh_step(SEMI_GRAPH, SEMI_LOSS, semi_images, semi_labels, 5, semi=SEMI)
    # the same step in one process: the global batch's loss
    model = build_model(R18, 2, device="cpu").double()
    model.load_state_dict(flagship["state_dict"], strict=True)
    single = sharded_twins.arm(model, cfg, flagship["batches"], 1, device="cpu",
                               draws=[draws])
    return {"want": want, "want_semi": want_semi, "single": single,
            "bn": torch.load(path, weights_only=False)["bn"]}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One set of two ranks for the steps and the Trainer at world 2
    (started first: they build their weights from the JAX side's numpy
    fill, which needs no compile), while the JAX side compiles its steps
    over a 2-device mesh and the port's one-process step runs here."""
    steps_path, prep = _steps_payload(tmp_path_factory.mktemp("steps"))
    root, world2_path, payload = _world2_payload(tmp_path_factory.mktemp("world2"))
    ranks = Ranks("torch_parallel_jobs:both_job", 2, f"{steps_path}|{world2_path}",
                  paths=[TESTS])
    try:
        here = _steps_jax_side(steps_path, prep)
        jax_semi = _jax_semi_batches(root, payload["semi"])
    finally:
        got = ranks.results(timeout=540)
    return here, [r["steps"] for r in got], (root, payload, [r["world2"] for r in got],
                                             jax_semi)


@pytest.fixture(scope="module")
def steps(both):
    """The JAX steps over a 2-device mesh, the port's over two ranks and
    the port's one-process step."""
    here, got, _ = both
    return {"got": got, **here}


def test_global_batch_norm_equals_one_process(steps):
    p = steps["bn"]
    bn = BatchNorm2d(5).double()
    bn.load_state_dict(p["state"])
    x = p["x"].clone().requires_grad_(True)
    y = bn.train()(x)
    (y * p["cot"]).sum().backward()
    ranks = [r["bn"] for r in steps["got"]]
    for r, res in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(res["y"].numpy(), y[rows].detach().numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(res["dx"].numpy(), x.grad[rows].numpy(),
                                   rtol=0, atol=1e-12)
        for key, v in bn.state_dict().items():
            np.testing.assert_allclose(res["state"][key].numpy(), v.numpy(),
                                       rtol=0, atol=1e-12, err_msg=key)
        assert res["group"] is None                   # the block ends the global mode
    for name, want in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
        np.testing.assert_allclose((ranks[0][name] + ranks[1][name]).numpy(),
                                   want.numpy(), rtol=0, atol=1e-12)
    # the biased running variance (flax's update), not torch's unbiased one
    var = p["x"].var(dim=(0, 2, 3), unbiased=False)
    want_var = 0.9 * p["state"]["running_var"] + 0.1 * var
    np.testing.assert_allclose(ranks[0]["state"]["running_var"].numpy(),
                               want_var.numpy(), rtol=0, atol=1e-12)


def _held_to_jax(got, want, bridge, terms):
    """One rank's step (first-step metrics, new state dict) against the
    JAX step over the mesh."""
    m, wm = got["metrics"], want["metrics"]
    for key in ("loss",) + terms:
        assert abs(float(m[key]) - float(wm[key])) <= TOL, (key, float(m[key]),
                                                            float(wm[key]))
    np.testing.assert_array_equal(m["confusion_matrix"].numpy(), wm["confusion_matrix"])
    assert int(m["confusion_matrix"].sum()) > 0
    assert abs(float(m["grad_norm"]) - float(wm["grad_norm"])) <= TOL
    sd = got["state_dict"]
    for key, v in bridge(want["params"], want["stats"]).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=0, atol=TOL,
                                       err_msg=key)


def test_two_rank_flagship_loss_step_equals_jax_mesh_step(steps):
    for got in steps["got"]:
        _held_to_jax(got["flagship"], steps["want"], bridge_ocrnet, ("TwoScaleLoss",))
    a, b = (r["flagship"]["state_dict"] for r in steps["got"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_two_rank_step_is_not_the_one_process_step(steps):
    """The mean of the ranks' Lovász losses differs from the global batch's
    by far more than the tolerance the 2-rank step meets, so the test above
    tells a per-rank loss from a global one."""
    two = float(steps["got"][0]["flagship"]["metrics"]["loss"])
    one = float(steps["single"]["metrics"]["loss"])
    assert abs(two - one) > 100 * TOL, (two, one)
    assert abs(one - float(steps["want"]["metrics"]["loss"])) > 100 * TOL


def test_two_rank_semi_step_equals_jax_mesh_step(steps):
    for got in steps["got"]:
        _held_to_jax(got["semi"], steps["want_semi"], bridge_encdec_upernet,
                     ("labeled", "unlabeled"))
        assert float(got["semi"]["metrics"]["unlabeled"]) > 0


# ---------------------------------------------------------------------------
# the Trainer at world 2
# ---------------------------------------------------------------------------

TRAINER = {"name": "w2", "mode": "training", "seed": 0, "precision": "f32",
           "graph": {"model": "HRNetv2", "width": 4},
           "loss": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"},
           "data": {"experiment": 2, "split": 2, "batch_size": 4, "blacklist": False,
                    "transforms": ["pad", "flip"]},
           "train": {"epochs": 2, "learning_rate": 1e-3},
           "valid_batch_size": 2, "max_valid_imgs": 3, "log_every_n_epochs": 1,
           "log_every_n_steps": 1}
STREAMS = {"oversampling": [1, 2], "weighted_random": [2, 3], "repeat_factor": [3, 4],
           "adaptive_batching": [4], "repeat_factor_freq_thresh": 0.15}
SEMI_TRAINER = {"name": "semi", "mode": "training", "seed": 3, "precision": "f32",
                "graph": {"model": "HRNetv2", "width": 4},
                "loss": {"name": "SemiSupervisedLoss",
                         "labeled": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"},
                         "unlabeled": {"name": "LovaszSoftmax", "lovasz_impl": "bucket",
                                       "weight": 0.5}},
                "data": {"experiment": 2, "batch_size": 8, "transforms": ["pad"],
                         "blacklist": True, "repeat_factor_freq_thresh": 0.15,
                         "oversampling_frac": 0.1, "oversampling": [1, 2],
                         "repeat_factor": [2, 4]},
                "train": {"epochs": 5, "learning_rate": 1e-3}}


def _cfg(base, root, run_id, **changes):
    cfg = json.loads(json.dumps(base))
    data = dict(cfg.pop("data"), **changes.pop("data", {}))
    cfg.update(data=data, log_path=str(root / "logs"), run_id=run_id, **changes)
    if (root / "data").is_dir():
        cfg["data_path"] = str(root / "data")
    return cfg


def _world2_payload(root):
    write_frames(root / "data", n_train=8, n_valid=5, h=48, w=64)
    streams = _cfg(TRAINER, root, "streams", data=STREAMS,
                   train={"epochs": 5, "learning_rate": 1e-3})
    payload = {"a": _cfg(TRAINER, root, "a"), "b": _cfg(TRAINER, root, "b"),
               "adaptive": _cfg(TRAINER, root, "adaptive",
                                data={"adaptive_batching": [0]}),
               "solo": _cfg(TRAINER, root, "solo", data={"batch_size": 3}),
               "streams": dict(streams, data_path=None),
               "semi": _cfg(SEMI_TRAINER, root, "semi"), "semi_epochs": 5}
    for key in ("streams", "semi"):           # over data/data.csv, not the tree
        payload[key].pop("data_path", None)
    path = root / "payload.pt"
    torch.save(payload, path)
    return root, path, payload


@pytest.fixture(scope="module")
def world2(both):
    return both[2]


class _Writer:
    def __init__(self, *a, **k):
        pass

    def __getattr__(self, name):
        return lambda *a, **k: None


def _jax_semi_batches(root, cfg):
    """The JAX Trainer's semi batches over a mesh of two CPU devices (its
    own __init__ without its model, train state and writers)."""
    df = jax_df.split_dataframes(jax_df.load_frame_table(), 2, blacklist=False)[0]
    arrays = JaxArrayDataset(np.zeros((len(df), 1, 1, 3), np.uint8),
                             np.zeros((len(df), 1, 1), np.uint8))
    two = jax.devices()[:2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "TBLogger", _Writer)
        mp.setattr(jax_trainer, "build_model", lambda *a, **k: None)
        mp.setattr(jax_trainer, "create_train_state",
                   lambda *a, **k: types.SimpleNamespace(params={}))
        mp.setattr(jax_trainer, "make_mesh", lambda *a, **k: make_mesh(devices=two))
        jt = jax_trainer.Trainer(dict(cfg, log_path=str(root / "jax_logs")),
                                 (arrays, arrays, df, df, np.zeros((37, 1, 1, 3), np.uint8)))
    assert jt.mesh.shape["data"] == 2
    rng = np.random.default_rng(int(cfg["seed"]))
    return [jt._epoch_batches(e, rng) for e in range(cfg["train"]["epochs"])]


def _one_process(monkeypatch, cfg, **kw):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    return jobs._train(cfg, **kw)


def _fed_rows(run, rank):
    """Each step's indices this rank fed, and its half of the epochs'
    batches, in order."""
    half = slice(2 * rank, 2 * rank + 2)
    want = [b[half] for e in sorted(run["batches"]) for b in run["batches"][e]]
    return run["fed"], want


@pytest.mark.parametrize("name", ["a", "adaptive"])
def test_each_rank_feeds_its_half_of_every_batch(world2, name):
    _, _, got, _ = world2
    assert [r[name]["n_use"] for r in got] == [2, 2]
    for e in got[0][name]["batches"]:
        np.testing.assert_array_equal(got[0][name]["batches"][e], got[1][name]["batches"][e])
    for rank in (0, 1):
        fed, want = _fed_rows(got[rank][name], rank)
        assert len(fed) == len(want) > 0
        for f, w in zip(fed, want):
            np.testing.assert_array_equal(f, w)


def test_ranks_hold_equal_metrics_and_weights(world2):
    _, _, got, _ = world2
    for name in ("a", "adaptive"):
        r0, r1 = got[0][name], got[1][name]
        assert r0["valid"] == r1["valid"] and r0["returned"] == r1["returned"]
        strip = [{k: v for k, v in t.items() if k not in ("seconds", "ms_per_step",
                                                          "frames_per_s")}
                 for t in r0["train"]]
        assert strip == [{k: v for k, v in t.items() if k not in (
            "seconds", "ms_per_step", "frames_per_s")} for t in r1["train"]]
        assert all(torch.equal(v, r1["state_dict"][k]) for k, v in r0["state_dict"].items())


def test_validation_equals_the_one_process_validate(world2, monkeypatch):
    """validate(1) of the world-2 run's last weights in one process gives
    the metrics both ranks computed, batches shared between them. Built
    outside `main` under torchrun's environment, the Trainer forms no
    process group (`main` forms and closes the world) and runs alone."""
    import torch.distributed as dist
    root, payload, got, _ = world2
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for var, value in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, value)
    t = Trainer(_cfg(TRAINER, root, "a_alone"), device="cpu")
    assert t.world.size == 1 and t.group.n_use == 1 and not dist.is_initialized()
    t.load_checkpoint("last", run_id="a")
    metrics = t.validate(1)
    t.close()
    assert metrics == got[0]["a"]["valid"][-1]
    assert len(metrics["confusion_matrix"]) == 17 and metrics["valid_loss"] > 0


def test_rank_zero_alone_writes(world2):
    root, _, got, _ = world2
    assert got[1]["writes"] == {"checkpoint": 0, "info_json": 0, "ind_dist": 0}
    assert all(v > 0 for v in got[0]["writes"].values())
    run = root / "logs" / "a"
    assert sorted(p.name for p in (run / "chkpts").iterdir()) == ["chkpt_best.pt",
                                                                   "chkpt_last.pt"]
    assert (run / "info.json").is_file() and (run / "ind_dist.npz").is_file()
    lines = (run / "train" / "scalars.jsonl").read_text().splitlines()
    steps = sum(len(b) for b in got[0]["a"]["batches"].values())
    assert len([ln for ln in lines if '"metrics/loss"' in ln]) == steps


def test_world2_resume_is_bit_equal(world2):
    _, _, got, _ = world2
    for r in got:
        assert r["b_stopped"]["returned"] is None and len(r["b_stopped"]["valid"]) == 1
        assert r["b"]["valid"] == r["a"]["valid"][1:]
        assert all(torch.equal(v, r["a"]["state_dict"][k])
                   for k, v in r["b"]["state_dict"].items())


def test_a_batch_of_three_leaves_rank_one_out(world2, monkeypatch):
    root, payload, got, _ = world2
    r0, r1 = got[0]["solo"], got[1]["solo"]
    assert r0["n_use"] == r1["n_use"] == 1
    assert r1["returned"] == {} and r1["fed"] == [] and r1["valid"] == []
    alone = _one_process(monkeypatch, _cfg(TRAINER, root, "solo_alone",
                                           data={"batch_size": 3}))
    assert r0["valid"] == alone["valid"] and len(r0["valid"]) == 2
    assert all(torch.equal(v, alone["state_dict"][k]) for k, v in r0["state_dict"].items())
    for f, w in zip(r0["fed"], alone["fed"]):
        np.testing.assert_array_equal(f, w)


def test_index_streams_of_every_loader_equal_one_process(world2, monkeypatch):
    _, payload, got, _ = world2
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    t = Trainer(payload["streams"], device="cpu")
    assert [t.train_schedule[e] for e in range(5)] == [
        "default", "oversampling", "weighted_random", "repeat_factor", "adaptive_batching"]
    rng = np.random.default_rng(int(payload["streams"]["seed"]))
    want = [t._epoch_batches(e, rng) for e in range(5)]
    t.close()
    for r in got:
        for a, b in zip(r["streams"], want):
            np.testing.assert_array_equal(a, b)


def test_semi_batches_at_world2_equal_jax_mesh_trainer(world2):
    _, _, got, jax_semi = world2
    for r in got:
        assert len(r["semi"]) == len(jax_semi) == 5
        for a, b in zip(r["semi"], jax_semi):
            np.testing.assert_array_equal(a, b)
            # each rank's block of 4: [2 labelled | 2 unlabelled]
            blocks = a.reshape(len(a), 2, 4)
            assert (blocks[:, :, :2] < blocks[:, :, 2:].min()).all()


# ---------------------------------------------------------------------------
# torchrun's environment, with no fallback
# ---------------------------------------------------------------------------

def _torchrun_env(monkeypatch):
    for var, value in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, value)


def test_under_torchrun_no_cpu_path_runs_without_the_card(monkeypatch):
    """Under torchrun a rank asks for cuda:LOCAL_RANK; without CUDA it
    raises and forms no process group (no rank carries on alone); -d is
    refused."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import (
        init_from_env, under_torchrun)
    import torch.distributed as dist
    assert not under_torchrun()
    assert init_from_env("cpu").size == 1 and not dist.is_initialized()
    _torchrun_env(monkeypatch)
    assert under_torchrun()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_from_env("cuda")
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="-d does not apply under torchrun"):
        port_main.main(["-c", str(ROOT / "configs" / "OCRNet_pretrained_t2.json"),
                        "-d", "0"])
    assert not dist.is_initialized()


def test_data_group_rows():
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import DataGroup
    group = DataGroup(rank=1, size=3, n_use=3)
    assert group.local_rows(6) == slice(2, 4) and group.active and not group.chief
    assert [i for i in range(7) if group.owns(i)] == [1, 4]
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        group.local_rows(4)
    assert not DataGroup(rank=2, size=3, n_use=2).active


# ---------------------------------------------------------------------------
# the twins, and the export over a mesh
# ---------------------------------------------------------------------------

def test_sharded_twins_tiny_path():
    """The JAX twins test's bars (tests/test_sharded_twins.py) on two ranks."""
    r = sharded_twins.compare_sharded(backbone="resnet18", h=64, w=128, bs=8,
                                      n_pool=16, n_steps=8, device="cpu")
    assert r["ranks_agree"] and r["n_loss_shards"] == 2
    assert 0 < r["step0_abs_divergence"] < 0.05, r
    assert r["max_abs_loss_divergence"] < 0.1, r
    assert min(r["losses_single"][4:]) < r["losses_single"][0] - 0.005
    assert min(r["losses_sharded"][4:]) < r["losses_sharded"][0] - 0.005


def test_export_over_a_mesh_of_two_devices(tmp_path):
    """Batch 4 over two CPU devices: each device serves its shard of 2, bit
    for bit the one-device artifact's at batch 2, and the whole batch is
    the batch-4 artifact's (pred equal, confidence within 1e-6: the
    convolutions round otherwise at another batch); an undivisible batch
    is refused with the JAX package's message."""
    model = build_model({"model": "FCN", "width": 0.125}, 2, device="cpu", seed=3)
    serve = export.make_serving_fn(model, EvalSpec(pad=True, normalise=True))
    x = torch.from_numpy(blocky(4, 30, 40, 1)[0])
    path = export.save_serving(export.export_fn(serve, (30, 40), batch=4,
                                                mesh=["cpu", "cpu"]), tmp_path / "mesh",
                               mesh=["cpu", "cpu"])
    mesh = export.load_serving(path, mesh=["cpu", "cpu"])
    one_path = export.save_serving(export.export_fn(serve, (30, 40)), tmp_path / "one")
    one = export.load_serving(one_path)
    # the artifact holds a caller's mesh to the one it was exported over
    for bad in (None, ["cpu"] * 4):
        with pytest.raises(ValueError, match="exported over a mesh of 2 devices"):
            export.load_serving(path, mesh=bad)
    with pytest.raises(ValueError, match="exported for one device"):
        export.load_serving(one_path, mesh=["cpu", "cpu"])
    with torch.no_grad():
        got = mesh(x)
        shards = [one(x[:2]), one(x[2:])]
        whole = one(x)
    for k in ("pred", "confidence"):
        assert torch.equal(got[k], torch.cat([s[k] for s in shards])), k
    assert torch.equal(got["pred"], whole["pred"])
    assert float((got["confidence"] - whole["confidence"]).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="serves batches of 4"):
        mesh(x[:2])
    with pytest.raises(ValueError, match="mesh export needs a pinned batch divisible by 4"):
        export.export_fn(serve, (30, 40), batch=6, mesh=["cpu"] * 4)
