"""Training through the port's Trainer and CLI against the JAX package.

(a) The JAX `Trainer.train` and the port's on one synthetic CaDIS tree
(tools/synthetic_tree.py) from the same weights (the JAX package's flax
init bridged with train/bridge.py): HRNetv2-W4, the bucket `LovaszSoftmax`
(B3/B4f's plain versions here, the Pallas kernels in interpret mode
there), pad only (no augmentation draw, so none differs between
jax.random and torch), batch 2, two epochs of repeat-factor sampling,
Adam at 1e-4. Both models run in float64 (the loss's bucket route in
float32 inside both): in float32 the two trajectories part from the
second step on (the first step's gradients differ by about 1.6e-3
relative at this width, and the difference grows about 25 times a step),
so only float64 can hold a trajectory to a tight tolerance. Exact: each
epoch's batches, `ind_counts`, `global_step` and the LR of every step.
Within tolerances: each epoch's train loss (1e-6) and mIoU (1e-4), each
validation's loss (1e-6) and metrics (1e-4), and the final parameters,
whose distance from the JAX ones must stay under 1e-3 of the distance
they moved (relative L2).
(b) The flagship config (configs/OCRNet_rf_lvsz.json: OCRNet-R50, bf16,
pad/flip/blur/colorjitter, repeat factor at 0.15) through the port's CLI
on the CPU, on a tiny tree (60x96 frames, batch 2, two epochs): the last
checkpoint (optimiser state, step), info.json, ind_dist.npz, the profile
trace; the CLI without a device refuses a machine without CUDA.
(c) A port run interrupted at epoch 2's validation and resumed from
`last` through the CLI is bit-equal to the uninterrupted run on the CPU.
"""
import concurrent.futures
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.train import config as jax_config
from miccai2021_cataract_semantic_segmentation_tpu.train import state as jax_state
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.samplers import (
    RepeatFactorSampler)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    load_frame_table, split_dataframes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_hrnet
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import trainer as trainer_module
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from test_torch_eval import numpy_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_VIDEOS = taxonomy.DATA_SPLITS[2][0]
VALID_VIDEOS = taxonomy.DATA_SPLITS[2][1]
METRICS = ("miou", "miou_instruments", "miou_anatomies", "miou_rare", "pa", "pac")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_frames(root, n_train: int, n_valid: int, h: int, w: int, seed: int = 0):
    """A CaDIS tree of seeded frames: blocky labels of the common task-2
    classes, with classes 14, 15 and 16 each in one or two training frames
    only, so that those frames repeat (r(I) > 1)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_valid
    grid = rng.integers(0, 14, (n, h // 6 + 1, w // 8 + 1))
    net = np.repeat(np.repeat(grid, 6, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    net[:, -6:, -8:] = 17                          # the ignore class in every frame
    for frame, cls in ((0, 14), (1, 15), (2, 15), (3, 16)):
        net[frame, :12, :16] = cls
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    videos = [TRAIN_VIDEOS[i % len(TRAIN_VIDEOS)] for i in range(n_train)] + \
        [VALID_VIDEOS[i % len(VALID_VIDEOS)] for i in range(n_valid)]
    write_tree(root, images, canonical_from_network(net, 2), videos)
    return root


TINY = {"name": "tiny", "mode": "training", "seed": 0, "precision": "f32",
        "graph": {"model": "HRNetv2", "width": 4},
        "loss": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"},
        "data": {"experiment": 2, "split": 2, "batch_size": 2, "blacklist": False,
                 "transforms": ["pad"], "repeat_factor": [0],
                 "repeat_factor_freq_thresh": 0.3},
        "train": {"epochs": 2, "learning_rate": 1e-4},
        "valid_batch_size": 2, "max_valid_imgs": 1, "log_every_n_epochs": 1,
        "log_every_n_steps": 1}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    write_frames(root / "data", n_train=8, n_valid=2, h=60, w=64)
    return root


def _config(root, run_id, **changes):
    cfg = json.loads(json.dumps(TINY))
    cfg.update(data_path=str(root / "data"), log_path=str(root / "logs"),
               run_id=run_id, **changes)
    return cfg


def _recording(trainer, record):
    """Record each epoch's batches, train metrics and validation metrics."""
    batches, validate = trainer._epoch_batches, trainer.validate

    def epoch_batches(epoch, rng):
        out = batches(epoch, rng)
        record["batches"].append(np.array(out))
        return out

    def validating(epoch):
        record["train"].append(dict(trainer.train_metrics))
        out = validate(epoch)
        record["valid"].append(dict(trainer.metrics))
        return out

    trainer._epoch_batches, trainer.validate = epoch_batches, validating


def _f64_train_state(model, rng, sample, train_cfg, schedule, train=False):
    """The JAX Trainer's `create_train_state` from flax's parameter tree for
    the model filled from numpy (`numpy_variables`: lecun-normal kernels,
    non-trivial BatchNorm), in float64; no init is compiled."""
    variables = numpy_variables(model, seed=int(rng[-1]))
    tx = jax_state.make_optimizer(train_cfg, schedule)
    return jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)


@pytest.fixture(scope="module")
def trained(tree):
    """Both Trainers' `train()` on one tree from one set of weights, their
    models in float64; the JAX one on one device (no mesh), as the port
    trains."""
    path = tree / "tiny.json"
    path.write_text(json.dumps(_config(tree, "unused")))
    config = jax_config.parse_config(str(path))
    build = jax_trainer.build_model
    mp = pytest.MonkeyPatch()
    # the confusion-matrix figures are logging, not compared, and slow here
    for module in (jax_trainer, trainer_module):
        mp.setattr(module, "confusion_matrix_figure", lambda *a: None)
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as jmp:
            jmp.setattr(jax_trainer, "create_train_state", _f64_train_state)
            jmp.setattr(jax_trainer, "make_mesh", lambda *a, **k: None)
            jmp.setattr(jax_trainer, "build_model",
                        lambda graph, task, dtype: build(graph, task, dtype=jnp.float64))
            jt = jax_trainer.Trainer(dict(config, run_id="jax"))
        assert jt.mesh is None
        init = bridge_hrnet(jax.tree.map(np.asarray, jt.state.params),
                            jax.tree.map(np.asarray, jt.state.batch_stats))
        assert init["conv1.weight"].dtype == torch.float64
        want = {"batches": [], "train": [], "valid": []}
        _recording(jt, want)
        # the port's run in a thread, beside the JAX step's compile and run
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(_port_train, config, init)
            jt.train()
            got = port.result()
        want.update(global_step=jt.global_step, ind_counts=jt.ind_counts.copy(),
                    lr=[float(jt.schedule(s)) for s in range(jt.global_step + 1)],
                    params=bridge_hrnet(jax.tree.map(np.asarray, jt.state.params),
                                        jax.tree.map(np.asarray, jt.state.batch_stats)))
    finally:
        jax.config.update("jax_enable_x64", False)
        mp.undo()
    return init, want, got


def _port_train(config, init) -> dict:
    """The port's Trainer.train from the JAX Trainer's initial weights."""
    pt = Trainer(dict(config, run_id="port"), device="cpu")
    pt.model.double()          # in place: the optimiser keeps its parameters
    ckpt.load_model_state(pt.model, init)
    got = {"batches": [], "train": [], "valid": []}
    _recording(pt, got)
    reset_launches()
    pt.train()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    pt.close()
    got.update(global_step=pt.global_step, ind_counts=pt.ind_counts,
               lr=[pt.schedule(s) for s in range(pt.global_step + 1)],
               params=pt.model.state_dict(), trainer=pt)
    return got


def test_train_batches_counts_steps_and_lr_equal_jax(trained):
    _, want, got = trained
    assert len(got["batches"]) == len(want["batches"]) == 2
    for g, w in zip(got["batches"], want["batches"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["ind_counts"], want["ind_counts"])
    steps = sum(len(b) for b in got["batches"])
    assert got["global_step"] == want["global_step"] == steps
    assert int(got["ind_counts"].sum()) == 2 * steps and got["ind_counts"].max() > 1
    assert got["lr"] == want["lr"]
    pt = got["trainer"]
    assert pt.state.step == steps
    assert pt.state.optimizer.param_groups[0]["lr"] == got["lr"][steps - 1]


def test_train_metrics_and_validation_match_jax(trained):
    _, want, got = trained
    for g, w in zip(got["train"], want["train"]):
        assert g["epoch"] == w["epoch"]
        assert abs(g["loss"] - w["loss"]) <= 1e-6, (g, w)
        assert abs(g["miou"] - w["miou"]) <= 1e-4 and abs(g["pa"] - w["pa"]) <= 1e-4
    assert len(got["valid"]) == len(want["valid"]) == 2
    for g, w in zip(got["valid"], want["valid"]):
        assert abs(g["valid_loss"] - w["valid_loss"]) <= 1e-6, (g, w)
        for k in METRICS:
            assert abs(g[k] - w[k]) <= 1e-4, k


def test_final_parameters_match_jax(trained):
    """Each float entry's distance from JAX's under 1e-3 of the distance the
    whole model moved from the common init (relative L2)."""
    init, want, got = trained
    keys = [k for k, v in init.items() if v.dtype.is_floating_point]
    flat = {name: torch.cat([d[k].reshape(-1).double() for k in keys])
            for name, d in (("init", init), ("want", want["params"]),
                            ("got", got["params"]))}
    moved = float(torch.linalg.vector_norm(flat["want"] - flat["init"]))
    apart = float(torch.linalg.vector_norm(flat["got"] - flat["want"]))
    assert moved > 0 and apart <= 1e-3 * moved, (apart, moved)


def test_train_writes_checkpoint_index_counts_and_info(trained, tree):
    _, _, got = trained
    run = tree / "logs" / "port"
    payload = ckpt.read_checkpoint(run / "chkpts" / "chkpt_last.pt")
    assert payload["global_step"] == got["global_step"] and payload["epoch"] == 1
    assert len(payload["optimizer_state_dict"]["state"]) == len(list(
        got["trainer"].model.parameters()))
    dist = np.load(run / "ind_dist.npz")
    np.testing.assert_array_equal(dist["ind_counts"], got["ind_counts"])
    for e, b in enumerate(got["batches"]):
        np.testing.assert_array_equal(dist[f"batches_e{e:03d}"], b)
    info = json.loads((run / "info.json").read_text())
    assert info["metrics"]["epoch"] == 1 and info["config"]["run_id"] == "port"


# ---------------------------------------------------- (b) the flagship's CLI

@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    root = tmp_path_factory.mktemp("flagship")
    write_frames(root / "data", n_train=8, n_valid=2, h=60, w=96, seed=1)
    cfg = json.loads((ROOT / "configs" / "OCRNet_rf_lvsz.json").read_text())
    cfg["train"]["epochs"] = 2
    cfg.update(log_path=str(root / "logs"), run_id="flagship",
               log_every_n_epochs=1, profile_epoch=1)
    (root / "flagship.json").write_text(json.dumps(cfg))
    argv = ["-c", str(root / "flagship.json"), "-dp", str(root / "data"), "-bs", "2"]
    reset_launches()
    metrics = main(argv, device="cpu")
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    return root, argv, metrics


def test_flagship_trains_through_the_cli(flagship):
    root, _, metrics = flagship
    run = root / "logs" / "flagship"
    dist = np.load(run / "ind_dist.npz")
    batches = [dist[f"batches_e{e:03d}"] for e in range(2)]
    steps = sum(len(b) for b in batches)
    assert int(dist["ind_counts"].sum()) == steps * 2 and all(b.shape[1] == 2 for b in batches)
    # the index streams are the port's repeat-factor sampler's, seed + 1
    df = split_dataframes(load_frame_table(data_path=str(root / "data")), 2,
                          blacklist=False)[0]
    sampler = RepeatFactorSampler(df, 0.15, 2, blacklist=False, seed=1)
    assert sampler.repeat_factors.max() > 1
    for b in batches:
        np.testing.assert_array_equal(b, sampler.epoch_batches(2))
    payload = ckpt.read_checkpoint(run / "chkpts" / "chkpt_last.pt")
    assert payload["global_step"] == steps and payload["epoch"] == 1
    assert payload["optimizer_state_dict"]["state"]
    info = json.loads((run / "info.json").read_text())
    assert info["metrics"]["miou"] == metrics["miou"] and np.isfinite(metrics["valid_loss"])
    assert info["config"]["data"]["batch_size"] == 2
    trace = (run / "profile" / "trace.json").read_text()
    assert "aten::convolution" in trace


def test_cli_training_refuses_a_machine_without_cuda(flagship):
    root, argv, _ = flagship
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


# ------------------------------------------------------------ (c) resume

class _Interrupt(Exception):
    pass


def test_resume_through_the_cli_is_bit_equal(tmp_path):
    """Run A uninterrupted; run B stopped entering epoch 2's validation
    (its epoch-1 `last` checkpoint written) and resumed from `last` by the
    CLI: the same global step, index counts, epoch batches and parameters,
    bit for bit."""
    tree = tmp_path
    write_frames(tree / "data", n_train=4, n_valid=2, h=60, w=64, seed=2)
    epochs = {"epochs": 3, "learning_rate": 1e-3}
    a = Trainer(_config(tree, "resume_a", train=epochs), device="cpu")
    a.train()
    a.close()
    b = Trainer(_config(tree, "resume_b", train=epochs), device="cpu")
    validate = b.validate

    def interrupted(epoch):
        if epoch == 2:
            raise _Interrupt()
        return validate(epoch)

    b.validate = interrupted
    with pytest.raises(_Interrupt):
        b.train()
    b.close()
    cfg = _config(tree, "resume_b", train=epochs, load_checkpoint="resume_b")
    (tree / "resume.json").write_text(json.dumps(cfg))
    main(["-c", str(tree / "resume.json")], device="cpu")

    logs = tree / "logs"
    want = ckpt.read_checkpoint(logs / "resume_a" / "chkpts" / "chkpt_last.pt")
    got = ckpt.read_checkpoint(logs / "resume_b" / "chkpts" / "chkpt_last.pt")
    assert got["global_step"] == want["global_step"] == a.global_step > 0
    assert got["epoch"] == want["epoch"] == 2
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    for k, v in want["optimizer_state_dict"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["optimizer_state_dict"]["state"][k][name], v[name])
    dist_a = np.load(logs / "resume_a" / "ind_dist.npz")
    dist_b = np.load(logs / "resume_b" / "ind_dist.npz")
    assert sorted(dist_a.files) == sorted(dist_b.files)
    for k in dist_a.files:
        np.testing.assert_array_equal(dist_b[k], dist_a[k])
    assert int(dist_a["ind_counts"].sum()) == 2 * a.global_step


def test_debugging_dumps_each_train_batch(tree):
    """`debugging: true` writes an img|gt|pred triptych of every sample of
    every train batch (the augmented, padded frame) under <run_dir>/debug/,
    as the JAX Trainer does."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import read_png

    t = Trainer(_config(tree, "debug", debugging=True,
                        train={"epochs": 1, "learning_rate": 1e-4}), device="cpu")
    t.train()
    t.close()
    dumps = sorted((t.run_dir / "debug").glob("e000_b*_*.png"))
    assert len(dumps) == 2 * t.global_step > 0
    assert read_png(dumps[0], 3).shape == (64, 3 * 64, 3)
    assert list((t.run_dir / "debug").glob("valid_e000_*.png"))
