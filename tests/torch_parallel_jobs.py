"""What tests/test_torch_parallel.py runs on two gloo ranks
(parallel/launch.py:spawn). Each job takes the path of a `torch.save`d
payload and returns what the test compares; the module imports the port
alone, so the ranks start without jax. Tensorboard is made absent in the
ranks (the Trainer then logs scalars to scalars.jsonl), which spares each
rank its import of TensorFlow."""
import contextlib
import sys

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    load_frame_table, split_dataframes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import ArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import (
    DataGroup, global_batch_norm, init_from_env)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.sharded_twins import arm_on_rank
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import trainer as trainer_module
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer


def _batch_norm(p):
    """One train-mode forward and backward of a global-mode BatchNorm on
    this rank's rows of the payload's batch, with the cotangent's rows."""
    x = p["x"]
    group = DataGroup.of(init_from_env("cpu"), len(x))
    rows = group.local_rows(len(x))
    bn = BatchNorm2d(x.shape[1]).double()
    bn.load_state_dict(p["state"])
    bn.train()
    xl = x[rows].clone().requires_grad_(True)
    with global_batch_norm(bn, group):
        y = bn(xl)
    (y * p["cot"][rows]).sum().backward()
    return {"y": y.detach(), "dx": xl.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "state": bn.state_dict(), "group": bn.group}


def steps_job(rank, world, path):
    """Global BatchNorm, then the train steps of `tools/sharded_twins.py:arm`
    for each of the payload's runs (the flagship loss, the semi step)."""
    p = torch.load(path, weights_only=False)
    return {"bn": _batch_norm(p["bn"]),
            **{name: arm_on_rank(p[name]) for name in p["runs"]}}


class _Writes:
    """Counts this rank's checkpoint, info.json and ind_dist.npz writes."""

    def __init__(self):
        self.counts = {"checkpoint": 0, "info_json": 0, "ind_dist": 0}

    @contextlib.contextmanager
    def counting(self):
        ckpt, np_mod = trainer_module.ckpt, trainer_module.np
        save, info, savez = ckpt.save_checkpoint, ckpt.write_info_json, np_mod.savez

        def wrap(key, fn):
            def counted(*a, **k):
                self.counts[key] += 1
                return fn(*a, **k)
            return counted

        ckpt.save_checkpoint = wrap("checkpoint", save)
        ckpt.write_info_json = wrap("info_json", info)
        np_mod.savez = wrap("ind_dist", savez)
        try:
            yield
        finally:
            ckpt.save_checkpoint, ckpt.write_info_json, np_mod.savez = save, info, savez


class _Stopped(Exception):
    pass


def _train(cfg, stop_at=None, resume=False):
    """Trainer.train of `cfg` on the CPU: each epoch's batches, the index
    rows this rank fed its steps, the train and validation metrics of each
    epoch, what train returned and the final state dict. `stop_at` stops
    the run entering that epoch's validation; `resume` loads the run's
    `last` checkpoint first."""
    fed, train, valid = [], [], []
    iterate = trainer_module.epoch_iterator

    def recording(*a, **k):
        for item in iterate(*a, **k):
            if "rows" in k:          # the train loop's batches, not validation's
                fed.append(item[2].numpy().copy())
            yield item

    trainer_module.epoch_iterator = recording
    trainer = Trainer(cfg, device="cpu")
    validate = trainer.validate

    def validating(epoch):
        if epoch == stop_at:
            raise _Stopped
        train.append(dict(trainer.train_metrics))
        out = validate(epoch)
        valid.append(dict(trainer.metrics))
        return out

    trainer.validate = validating
    try:
        if resume:
            trainer.load_checkpoint("last")
        returned = trainer.train()
    except _Stopped:
        returned = None
    finally:
        trainer_module.epoch_iterator = iterate
        trainer.close()
    return {"batches": dict(trainer.epoch_batches), "fed": fed, "train": train,
            "valid": valid, "returned": returned, "n_use": trainer.group.n_use,
            "state_dict": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def semi_batches(cfg, epochs):
    """The index batches of a semi Trainer over the repository's data.csv
    (split 2, no pixels) and a pool of 37 frames, epoch by epoch."""
    df = split_dataframes(load_frame_table(), 2, blacklist=False)[0]
    arrays = ArrayDataset(np.zeros((len(df), 1, 1, 3), np.uint8),
                          np.zeros((len(df), 1, 1), np.uint8))
    trainer = Trainer(cfg, (arrays, arrays, df, df, np.zeros((37, 1, 1, 3), np.uint8)),
                      device="cpu")
    rng = np.random.default_rng(int(cfg["seed"]))
    out = [trainer._epoch_batches(e, rng) for e in range(epochs)]
    trainer.close()
    return out


def trainer_job(rank, world, path):
    """The Trainer at world 2: run A (uninterrupted), run B (stopped at
    epoch 1's validation) and its resume, an adaptive run, a run whose
    labelled batch of 3 leaves rank 1 out, the index streams of every
    loader and a semi Trainer's batches."""
    sys.modules["torch.utils.tensorboard"] = None
    p = torch.load(path, weights_only=False)
    writes = _Writes()
    out = {}
    with writes.counting():
        out["a"] = _train(p["a"])
        out["b_stopped"] = _train(p["b"], stop_at=1)
        out["b"] = _train(p["b"], resume=True)
        out["adaptive"] = _train(p["adaptive"])
        out["solo"] = _train(p["solo"])
    streams = Trainer(p["streams"], device="cpu")
    rng = np.random.default_rng(int(p["streams"]["seed"]))
    out["streams"] = [streams._epoch_batches(e, rng) for e in range(streams.epochs)]
    streams.close()
    out["semi"] = semi_batches(p["semi"], p["semi_epochs"])
    out["writes"] = writes.counts
    return out
