"""The port's semi-supervised self-training and MoCo initialisation against
the JAX package, from seeded numpy inputs.

Bit-equal: the semi data views (data/semi.py), the video file layout and
the labelled-frame exclusions of data/data.csv (pandas on the JAX side,
the port's FrameTable on the other), the semi Trainer's epoch index
streams (labelled batches from the loader, the unlabelled half drawn
after them from the run's generator) and its labelled-only index counts,
the MoCo tensors copied into the backbone. One semi train step of
EncDec-UPerNet on a ResNet-18 encoder, its decoder narrowed to 16
channels (a width cut for the CPU's sake), in float64 (cross-entropy on
both halves, pad only) against the JAX step: the labels [labelled half |
pseudo-labels of the eval-mode teacher] equal, the loss and both halves'
terms to 1e-6 (the loss runs in float32 inside both), the labelled
half's confusion matrix equal, the new BatchNorm statistics (the
student's alone: the teacher leaves them) to 1e-6. A semi Trainer run of
the same graph on the bucket Lovász (B3 and B4f's plain versions),
interrupted after epoch 0 and resumed, ends bit-equal to the
uninterrupted one.
"""
import concurrent.futures
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data import ArrayDataset as JaxArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu.data import dataframe as jax_df
from miccai2021_cataract_semantic_segmentation_tpu.data import semi as jax_semi
from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train import port_torch
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data import semi
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    load_frame_table, split_dataframes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import ArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import ResNetBackbone
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import lr_schedule as lr
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import trainer as trainer_module
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_encdec_upernet)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
    TrainState, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

from test_torch_eval import numpy_variables

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEMI_LOSS = {"name": "SemiSupervisedLoss",
             "labeled": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"},
             "unlabeled": {"name": "LovaszSoftmax", "lovasz_impl": "bucket", "weight": 0.5},
             "pseudo_threshold": 0.1}


def _arrays(n, h, w, seed):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (n, h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8), labels


class _Writer:
    """A stand-in for both packages' TBLogger (tensorboard's import is slow
    here)."""

    def __init__(self, log_dir):
        pass

    def __getattr__(self, name):
        return lambda *a, **k: None


# ------------------------------------------------------------- data helpers

def test_semi_views_equal_jax():
    images, labels = _arrays(5, 16, 24, 0)
    pool, _ = _arrays(3, 16, 24, 1)
    port = semi.SemiSupervisedView(ArrayDataset(images, labels), pool, 17)
    jview = jax_semi.SemiSupervisedView(JaxArrayDataset(images, labels), pool, 17)
    assert len(port) == len(jview) == 8
    for i in range(8):
        (gi, gl, gm), (wi, wl, wm) = port[i], jview[i]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gm == wm
    assert port.load_batch([0, 6]) is None        # no native decode: per sample

    class Native(ArrayDataset):
        def load_batch(self, indices):
            return self.images[indices], self.labels[indices]

    class JaxNative(JaxArrayDataset):
        def load_batch(self, indices):
            return self.images[indices], self.labels[indices]

    port = semi.SemiSupervisedView(Native(images, labels), pool, 17)
    jview = jax_semi.SemiSupervisedView(JaxNative(images, labels), pool, 17)
    for idx in ([0, 6, 2, 7], [5, 6, 7], [1, 2]):
        for g, w in zip(port.load_batch(idx), jview.load_batch(idx)):
            np.testing.assert_array_equal(g, w)
    both = semi.BalancedConcatDataset(ArrayDataset(images, labels), pool)
    jboth = jax_semi.BalancedConcatDataset(JaxArrayDataset(images, labels), pool)
    assert len(both) == len(jboth) == 5
    np.testing.assert_array_equal(both[4][1], jboth[4][1])
    sub = semi._IndexSubset(pool, [2, 0])
    assert len(sub) == 2 and np.array_equal(sub[0], pool[2])


def test_video_files_and_excluded_frames_equal_jax():
    port_df = load_frame_table()
    jax_frame = jax_df.load_frame_table()
    for ids, debug in (([1, 3, 6, 9, 25], False), ([1, 2, 3, 6], True), (list(range(1, 26)), False)):
        assert semi.video_files_from_split(ids, debug) == \
            jax_semi.video_files_from_split(ids, debug)
    for videos in ([1, 3, 4], list(range(1, 26))):
        got = semi.excluded_frames_from_df(port_df, videos)
        want = jax_semi.excluded_frames_from_df(jax_frame, videos)
        assert list(got.items()) == list(want.items())
        assert sum(map(len, got.values())) > 100


def test_the_video_pool_raises_naming_its_item(tmp_path):
    """Without the training split's videos the pool raises naming what it
    looked for, as the JAX package's does (the pool from videos is held
    against JAX's in tests/test_torch_video.py)."""
    with pytest.raises(FileNotFoundError, match=r"train_1/train01\.mp4"):
        semi.unlabeled_from_videos(tmp_path, load_frame_table())
    with pytest.raises(FileNotFoundError, match=r"train_1/train01\.mp4"):
        jax_semi.unlabeled_from_videos(tmp_path, jax_df.load_frame_table())


# ---------------------------------------------------- epoch index streams

SCHEDULE = {"oversampling": [1, 2], "repeat_factor": [2, 4]}
EPOCHS = 5


def _semi_config(tmp_path, name, **data):
    return {"name": "semi", "mode": "training", "run_id": name, "seed": 3,
            "log_path": str(tmp_path), "precision": "f32",
            "graph": {"model": "HRNetv2", "width": 4}, "loss": SEMI_LOSS,
            "data": {"experiment": 2, "batch_size": 8, "transforms": ["pad"],
                     "blacklist": True, "repeat_factor_freq_thresh": 0.15,
                     "oversampling_frac": 0.1, **data},
            "train": {"epochs": EPOCHS, "learning_rate": 1e-3}}


def test_semi_epoch_batches_equal_jax(tmp_path):
    """Both Trainers' own __init__ on split 2's frames (the JAX one without
    its model, train state, mesh and writers) and a pool of 37 frames:
    the labelled batch size, each epoch's [labelled | unlabelled] batches
    from generators seeded alike, and the labelled-only index counts."""
    port_df = split_dataframes(load_frame_table(), 2, blacklist=False)[0]
    jax_frame = jax_df.split_dataframes(jax_df.load_frame_table(), 2, blacklist=False)[0]
    n = len(port_df)
    images, labels = np.zeros((n, 1, 1, 3), np.uint8), np.zeros((n, 1, 1), np.uint8)
    pool = np.zeros((37, 1, 1, 3), np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_module, "TBLogger", _Writer)
        arrays = ArrayDataset(images, labels)
        pt = Trainer(_semi_config(tmp_path, "port", **SCHEDULE),
                     (arrays, arrays, port_df, port_df, pool), device="cpu")
        mp.setattr(jax_trainer, "TBLogger", _Writer)
        mp.setattr(jax_trainer, "build_model", lambda *a, **k: None)
        mp.setattr(jax_trainer, "create_train_state",
                   lambda *a, **k: types.SimpleNamespace(params={}))
        mp.setattr(jax_trainer, "make_mesh", lambda *a, **k: None)
        arrays = JaxArrayDataset(images, labels)
        jt = jax_trainer.Trainer(_semi_config(tmp_path, "jax", **SCHEDULE),
                                 (arrays, arrays, jax_frame, jax_frame, pool))
    assert pt.semi and jt.semi and pt.lab_batch_size == jt.lab_batch_size == 4
    assert pt.steps_per_epoch == jt.steps_per_epoch == n // 4
    assert pt.epoch_steps == jt.epoch_steps
    assert len(pt._iter_set) == len(jt._iter_set) == n + 37
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for e in range(EPOCHS):
        got, want = pt._epoch_batches(e, rng_p), jt._epoch_batches(e, rng_j)
        np.testing.assert_array_equal(got, want)
        assert (got[:, :4] < n).all() and (got[:, 4:] >= n).all()
        pt._count_inds(e, got)
        jt._count_inds(want)
    np.testing.assert_array_equal(pt.ind_counts, jt.ind_counts)
    assert int(pt.ind_counts.sum()) == 4 * sum(map(len, pt.epoch_batches.values()))
    assert rng_p.random() == rng_j.random()


def test_semi_trainer_refuses_what_the_jax_trainer_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "TBLogger", _Writer)
    images, labels = _arrays(4, 16, 16, 0)
    df = load_frame_table().take(np.arange(4))
    arrays = ArrayDataset(images, labels)
    with pytest.raises(ValueError, match="even"):
        Trainer(_semi_config(tmp_path, "odd", batch_size=3),
                (arrays, arrays, df, df, images), device="cpu")
    with pytest.raises(FileNotFoundError, match="no training-split videos"):
        Trainer(_semi_config(tmp_path, "videos"), (arrays, arrays, df, df), device="cpu")


# ----------------------------------------------------------- one semi step

STEP_GRAPH = {"model": "EncDec", "encoder": {"model": "ResNet18"},
              "decoder": {"model": "UPerNet", "ppm_num_ch": 16, "fpn_num_ch": 16}}
STEP_LOSS = {"name": "SemiSupervisedLoss", "labeled": {"name": "CrossEntropyLoss"},
             "unlabeled": {"name": "CrossEntropyLoss", "weight": 0.5}}
TRAIN = {"learning_rate": 1e-4, "epochs": 1}


@pytest.fixture(scope="module")
def semi_steps():
    """One float64 semi train step on both sides from the same
    numpy-filled weights and batch (labelled half first); the threshold
    lies between the teacher's quantiles, so it cuts some pixels."""
    model = jax_build_model(STEP_GRAPH, 2, dtype=jnp.float64)
    variables = numpy_variables(model, seed=5)
    images, labels = _arrays(4, 48, 64, 6)
    labels[2:] = 17                                  # the view's unlabelled planes
    spec = build_transform_pipeline(["pad"], {}, 2).device
    semi_spec = {"threshold": 0.12, "ignore_id": 17, "n_shards": 1}

    def port_step():
        port = build_model(STEP_GRAPH, 2, device="cpu").double()
        port.load_state_dict(bridge_encdec_upernet(variables["params"],
                                                   variables["batch_stats"]), strict=True)
        pstate = TrainState(port, make_optimizer(TRAIN, port.parameters()),
                            lr.make_schedule(TRAIN, 1))
        pstep = make_train_step(build_loss(STEP_LOSS, 2, "cpu"), device_spec(["pad"]), 2,
                                device="cpu", precision="fp32", train_metrics="s8",
                                debug_pred=True,
                                semi={"threshold": semi_spec["threshold"], "ignore_id": 17})
        reset_launches()
        got = pstep(pstate, images, labels, 0)
        return got, pstate, launch_counts()

    # the port's step in a thread, beside the JAX step
    pool = concurrent.futures.ThreadPoolExecutor(1)
    port = pool.submit(port_step)
    jax.config.update("jax_enable_x64", True)
    try:
        tx = jax_make_optimizer(TRAIN, jlr.make_schedule(TRAIN, 1))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              apply_fn=model.apply, tx=tx)
        step = jax_make_train_step(jax_build_loss(STEP_LOSS, 2), spec, 2, donate=False,
                                   train_metrics="s8", debug_pred=True, semi=semi_spec)
        new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                                  jax.random.PRNGKey(0), 0)
        want = {"metrics": jax.tree.map(np.asarray, metrics),
                "stats": jax.tree.map(np.asarray, new_state.batch_stats)}
    finally:
        jax.config.update("jax_enable_x64", False)
        got, pstate, launches = port.result()
        pool.shutdown()
    assert launches == dict.fromkeys(KERNELS, 0)
    return want, got, pstate


def test_semi_step_labels_and_loss_equal_jax(semi_steps):
    want, got, _ = semi_steps
    wm = want["metrics"]
    np.testing.assert_array_equal(got["debug_lbl"].numpy(), wm["debug_lbl"])
    pseudo = wm["debug_lbl"][2:]
    assert 0 < (pseudo == 17).mean() < 1            # the threshold cuts some pixels
    for key in ("loss", "labeled", "unlabeled"):
        assert abs(float(got[key]) - float(wm[key])) <= 1e-6, key
    assert float(got["unlabeled"]) > 0
    np.testing.assert_array_equal(got["confusion_matrix"].numpy(), wm["confusion_matrix"])
    # the labelled half only: 2 padded 52x64 frames (stride 4), ignore dropped
    assert 0 < int(got["confusion_matrix"].sum()) <= int((got["debug_lbl"][:2] < 17).sum())


def test_semi_step_teacher_leaves_batchnorm_and_train_mode(semi_steps):
    want, _, pstate = semi_steps
    model = pstate.model
    assert model.training
    sd = model.state_dict()
    for key, v in bridge_encdec_upernet({}, want["stats"]).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[key].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=key)
    counts = {m.num_batches_tracked.item() for m in model.modules()
              if isinstance(m, torch.nn.BatchNorm2d)}
    assert counts == {1}                             # the student's forward alone


# ------------------------------------------------------- semi Trainer runs

def _trainer_sets():
    images, labels = _arrays(4, 32, 48, 11)
    valid = _arrays(2, 32, 48, 12)
    pool, _ = _arrays(5, 32, 48, 13)
    df = load_frame_table().take(np.arange(4))
    return (ArrayDataset(images, labels), ArrayDataset(*valid), df, df, pool)


def _run_config(tmp_path, run_id, loss=SEMI_LOSS):
    return {"name": "semi", "mode": "training", "run_id": run_id, "seed": 2,
            "log_path": str(tmp_path), "precision": "f32", "valid_batch_size": 1,
            "log_every_n_epochs": 1, "max_valid_imgs": 0, "graph": STEP_GRAPH, "loss": loss,
            "data": {"experiment": 2, "batch_size": 4, "split": 0,
                     "transforms": ["pad", "flip"]},
            "train": {"epochs": 2, "learning_rate": 1e-3}}


def test_semi_trainer_resume_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "TBLogger", _Writer)
    sets = _trainer_sets()
    full = Trainer(_run_config(tmp_path, "full"), sets, device="cpu")
    assert full.epoch_steps == [2, 2]
    metrics = full.train()
    assert int(full.ind_counts.sum()) == 2 * 2 * 2
    stopped = Trainer(_run_config(tmp_path, "resumed"), sets, device="cpu")
    stopped.epochs = 1
    stopped.train()
    resumed = Trainer(_run_config(tmp_path, "resumed"), sets, device="cpu")
    resumed.load_checkpoint("last")
    resumed.train()
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for e in range(2):
        np.testing.assert_array_equal(resumed.epoch_batches[e], full.epoch_batches[e])
    # the validation loss is the labelled loss alone: a Trainer with that loss
    # and the same weights validates alike, one frame a batch
    labelled = Trainer(_run_config(tmp_path, "labelled", SEMI_LOSS["labeled"]),
                       sets[:4], device="cpu")
    labelled.model.load_state_dict(full.model.state_dict())
    assert labelled.validate(1)["valid_loss"] == metrics["valid_loss"]


# ------------------------------------------------------------- MoCo init

def _moco_checkpoint(path, arch="resnet50", seed=3):
    """A MoCo-v2 style checkpoint: the query encoder's ResNet under
    `module.encoder_q.` with its fc head, the key encoder's queue."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = ResNetBackbone(arch)
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                torch.nn.init.uniform_(m.weight, 0.5, 1.5)
                torch.nn.init.normal_(m.running_mean, 0, 0.1)
    sd = {f"module.encoder_q.{k}": v for k, v in enc.state_dict().items()}
    sd["module.encoder_q.fc.0.weight"] = torch.ones(2048, 2048)
    sd["module.encoder_q.fc.2.weight"] = torch.ones(128, 2048)
    sd["module.queue"] = torch.zeros(128, 4)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": sd, "epoch": 800, "arch": arch},
               path / "moco_v2_800ep_pretrain.pth.tar")
    return sd


@pytest.mark.parametrize("graph,prefix", [
    ({"model": "OCRNet", "backbone": "resnet50"}, "backbone"),
    ({"model": "EncDec", "encoder": {"model": "ResNet50"},
      "decoder": {"model": "UPerNet", "ppm_num_ch": 16, "fpn_num_ch": 16}}, "enc_model")])
def test_moco_init_copies_what_the_jax_package_copies(tmp_path, monkeypatch, graph, prefix):
    """The tensors the JAX package's porter takes from the checkpoint
    (`strip_moco_prefix`, then `_resnet_flax_path`) are the ones the port
    copies, bit for bit, into the backbone; the rest of the model keeps
    its seeded initialisation."""
    monkeypatch.setattr(trainer_module, "TBLogger", _Writer)
    sd = _moco_checkpoint(tmp_path / "ss" / "moco")
    images, labels = _arrays(2, 32, 32, 0)
    df = load_frame_table().take(np.arange(2))
    arrays = ArrayDataset(images, labels)
    cfg = dict(_run_config(tmp_path, "moco", {"name": "CrossEntropyLoss"}),
               graph=dict(graph, ss_pretrained="moco"), ss_pretrained_path=str(tmp_path / "ss"))
    t = Trainer(cfg, (arrays, arrays, df, df), device="cpu")
    plain = build_model(graph, 2, device="cpu", seed=2).state_dict()
    stripped = port_torch.strip_moco_prefix({k: v.numpy() for k, v in sd.items()})
    ported = {f"{prefix}.{k}" for k in stripped if port_torch._resnet_flax_path(k)}
    got = t.model.state_dict()
    assert len(ported) == 265
    for key, value in got.items():
        if key in ported:
            assert torch.equal(value, sd[f"module.encoder_q.{key[len(prefix) + 1:]}"]), key
        else:
            assert torch.equal(value, plain[key]), key
    bad = dict(cfg, ss_pretrained_path=str(tmp_path / "r18"))
    _moco_checkpoint(tmp_path / "r18" / "moco", arch="resnet18")
    with pytest.raises(ValueError, match="shape"):
        Trainer(bad, (arrays, arrays, df, df), device="cpu")
    with pytest.raises(ValueError, match="moco only"):
        Trainer(dict(cfg, graph=dict(graph, ss_pretrained="simclr")),
                (arrays, arrays, df, df), device="cpu")
