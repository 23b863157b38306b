"""The port's samplers (data/samplers.py) and the Trainer's per-epoch batch
schedule against the JAX package's, on the repo's frame table
(data/data.csv: pandas on the JAX side, the port's FrameTable on the
other). Every index stream, frequency and weight must be bit-equal for
equal seeds: the samplers are numpy on both sides, with the same
generators drawn in the same order.
"""
import types

import numpy as np
import pandas as pd
import pytest

from miccai2021_cataract_semantic_segmentation_tpu import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu.data import ArrayDataset as JaxArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu.data import dataframe as jax_df
from miccai2021_cataract_semantic_segmentation_tpu.data import samplers as jax_samplers
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer

from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
    ArrayDataset, FrameTable, load_frame_table, split_dataframes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import samplers
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import trainer as trainer_module
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer


@pytest.fixture(scope="module")
def frames():
    """Split 2's training frames with their blacklisted rows kept (the
    samplers drop them where asked), as both packages read them."""
    port = split_dataframes(load_frame_table(), 2, blacklist=False)[0]
    jax = jax_df.split_dataframes(jax_df.load_frame_table(), 2, blacklist=False)[0]
    assert len(port) == len(jax) > 1000 and (port["blacklisted"] == 1).sum() > 0
    return port, jax


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("blacklist", [True, False])
@pytest.mark.parametrize("thresh", [0.15, 0.3])
@pytest.mark.parametrize("task", [1, 2, 3])
def test_repeat_factor_sampler_equals_jax(frames, task, thresh, blacklist, seed):
    port_df, jax_frame = frames
    got = samplers.RepeatFactorSampler(port_df, thresh, task, blacklist, seed)
    want = jax_samplers.RepeatFactorSampler(jax_frame, thresh, task, blacklist, seed)
    for key in ("class_freqs", "class_rfs", "repeat_factors"):
        _equal(getattr(got, key), getattr(want, key))
    assert len(got.repeat_factors) == len(port_df) - blacklist * int(
        (port_df["blacklisted"] == 1).sum())
    assert (got.repeat_factors > 1).any() and got.class_rfs.max() > 1
    for _ in range(3):
        _equal(got.epoch_batches(8), want.epoch_batches(8))


@pytest.mark.parametrize("frac", [0.05, 0.2])
@pytest.mark.parametrize("task", [1, 2, 3])
@pytest.mark.parametrize("preset", sorted(taxonomy.OVERSAMPLING_PRESETS))
def test_oversample_indices_equal_jax(frames, preset, task, frac):
    port_df, jax_frame = frames
    got = samplers.oversample_indices(port_df, task, preset, frac)
    _equal(got, jax_samplers.oversample_indices(jax_frame, task, preset, frac))
    assert len(got) >= int(len(port_df) * frac)


@pytest.mark.parametrize("mode", ["v1", "v2"])
@pytest.mark.parametrize("task", [1, 2, 3])
def test_weighted_random_equals_jax(frames, task, mode):
    port_df, jax_frame = frames
    w = samplers.weighted_random_weights(port_df, task, mode)
    _equal(w, jax_samplers.weighted_random_weights(jax_frame, task, mode))
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for n in (len(w), 17):
        _equal(samplers.weighted_random_epoch(w, n, rng_p),
               jax_samplers.weighted_random_epoch(w, n, rng_j))
    with pytest.raises(ValueError, match="v3"):
        samplers.weighted_random_weights(port_df, task, "v3")


def _tiny_frames(n=5):
    """n frames with random class counts: fewer frames than an adaptive
    batch's draws, so the sampler draws with replacement."""
    rng = np.random.default_rng(4)
    cols = {"vid_num": np.ones(n, np.int64), "blacklisted": np.zeros(n, np.int64)}
    counts = rng.integers(0, 1000, (n, taxonomy.NUM_CANONICAL))
    counts[:, 5] = 0                      # a class in no frame
    for i, name in enumerate(taxonomy.CANONICAL_NAMES):
        cols[name] = counts[:, i]
    return FrameTable(cols), pd.DataFrame(cols)


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("dist_type", ["1/", "1-", "1-**2"])
def test_adaptive_batch_sampler_equals_jax(frames, dist_type, tiny):
    """Streams across `update_iou` calls (EMA at 0.7); the tiny set draws
    with replacement."""
    port_df, jax_frame = _tiny_frames() if tiny else frames
    bs = 4 if tiny else 8
    got = samplers.AdaptiveBatchSampler(port_df, 2, bs, 10, dist_type, 0.7, seed=2)
    want = jax_samplers.AdaptiveBatchSampler(jax_frame, 2, bs, 10, dist_type, 0.7,
                                             seed=2)
    _equal(got.sort_orders, want.sort_orders)
    rng = np.random.default_rng(9)
    for _ in range(3):
        _equal(got.epoch_batches(), want.epoch_batches())
        iou = rng.random(17).astype(np.float32)
        iou[rng.integers(0, 17)] = 0.0
        got.update_iou(iou)
        want.update_iou(iou)
        _equal(got.iou_values, want.iou_values)
    if tiny:        # every class with a quota draws at least sel_size > n
        assert got.sel_size > got.n
    with pytest.raises(KeyError, match="dist_type"):
        samplers.AdaptiveBatchSampler(port_df, 2, bs, dist_type="x").next_batch()


# ------------------------------------------------------ the Trainer's schedule

EPOCHS = 10
# successive loader ranges: adaptive batching, oversampling, weighted
# random, repeat factor, and the default loader in the last epoch
SCHEDULE = {"adaptive_batching": [0, 2], "oversampling": [2, 4],
            "weighted_random": [4, 6], "repeat_factor": [6, 9]}


def _config(tmp_path, name):
    return {"name": "sched", "mode": "training", "run_id": name, "seed": 3,
            "log_path": str(tmp_path), "precision": "f32",
            "graph": {"model": "HRNetv2", "width": 4},
            "loss": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"},
            "data": {"experiment": 2, "batch_size": 8, "transforms": ["pad"],
                     "blacklist": True, "repeat_factor_freq_thresh": 0.15,
                     "weighted_random_mode": "v2", "oversampling_frac": 0.1,
                     "adaptive_iou_update": 0.5, **SCHEDULE},
            "train": {"epochs": EPOCHS, "learning_rate": 1e-3,
                      "lr_fct": "polynomial", "lr_restarts": [5]}}


class _Writer:
    """A stand-in for both packages' TBLogger: the schedule writes nothing,
    and tensorboard's import is slow here."""

    def __init__(self, log_dir):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def trainers(frames, tmp_path_factory):
    """The port's Trainer and the JAX Trainer, built by their own __init__
    on the same frames; the JAX one without its model, train state, mesh
    and writers, which its loader schedule, epoch steps and LR schedule do
    not read (images 1x1: the schedule reads the set's length and the
    frame table)."""
    port_df, jax_frame = frames
    tmp = tmp_path_factory.mktemp("sched")
    n = len(port_df)
    images = np.zeros((n, 1, 1, 3), np.uint8)
    labels = np.zeros((n, 1, 1), np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_module, "TBLogger", _Writer)
        arrays = ArrayDataset(images, labels)
        pt = Trainer(_config(tmp, "port"), (arrays, arrays, port_df, port_df),
                     device="cpu")
        mp.setattr(jax_trainer, "TBLogger", _Writer)
        mp.setattr(jax_trainer, "build_model", lambda *a, **k: None)
        mp.setattr(jax_trainer, "create_train_state",
                   lambda *a, **k: types.SimpleNamespace(params={}))
        mp.setattr(jax_trainer, "make_mesh", lambda *a, **k: None)
        arrays = JaxArrayDataset(images, labels)
        jt = jax_trainer.Trainer(_config(tmp, "jax"), (arrays, arrays, jax_frame,
                                                       jax_frame))
    return pt, jt


def test_trainer_schedule_and_lr_equal_jax(trainers):
    pt, jt = trainers
    assert pt.train_schedule == jt.train_schedule
    assert set(pt.train_schedule.values()) == set(SCHEDULE) | {"default"}
    assert pt.epoch_steps == jt.epoch_steps and len(set(pt.epoch_steps)) > 1
    assert pt.steps_per_epoch == jt.steps_per_epoch == len(pt.train_set) // 8
    total = sum(pt.epoch_steps)
    got = [pt.schedule(s) for s in range(total + 2)]
    want = [float(jt.schedule(s)) for s in range(total + 2)]
    assert got == want and len(set(got)) > 2
    assert pt.state.schedule is pt.schedule


def test_trainer_epoch_batches_equal_jax(trainers):
    """`_epoch_batches` epoch by epoch from generators seeded alike, the
    adaptive sampler fed the same IoU between its epochs, and the index
    counts of every epoch."""
    pt, jt = trainers
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    iou = np.random.default_rng(5).random((EPOCHS, 17)).astype(np.float32)
    lengths = {}
    for e in range(EPOCHS):
        got, want = pt._epoch_batches(e, rng_p), jt._epoch_batches(e, rng_j)
        _equal(got, want)
        assert got.shape[1] == 8
        lengths.setdefault(pt.train_schedule[e], []).append(len(got))
        pt._count_inds(e, got)
        jt._count_inds(want)
        if pt.adaptive_sampler is not None:
            pt.adaptive_sampler.update_iou(iou[e])
            jt.adaptive_sampler.update_iou(iou[e])
    _equal(pt.ind_counts, jt.ind_counts)
    assert sorted(pt.epoch_batches) == list(range(EPOCHS))
    assert int(pt.ind_counts.sum()) == 8 * sum(map(len, pt.epoch_batches.values()))
    assert lengths["oversampling"][0] > lengths["default"][0]


def test_an_epoch_without_a_full_batch_raises(frames, tmp_path, monkeypatch):
    """Fewer training frames than a batch give no epoch to run: the port
    says so where the epoch is drawn."""
    monkeypatch.setattr(trainer_module, "TBLogger", _Writer)
    port_df = frames[0].take(np.arange(5))
    arrays = ArrayDataset(np.zeros((5, 1, 1, 3), np.uint8), np.zeros((5, 1, 1), np.uint8))
    pt = Trainer(_config(tmp_path, "tiny"), (arrays, arrays, port_df, port_df),
                 device="cpu")
    with pytest.raises(ValueError, match="epoch 9 .default. has no full batch of 8"):
        pt._epoch_batches(9, np.random.default_rng(0))
