"""The port's test-time augmentation against the JAX package.

`tta_merged_probs` (flip x multi-scale, softmax mean) with the reference's
five scales, from one seeded input through a fixed stride-2 convolution
on both sides, float64: within 1e-6 (it agrees to ~1e-15). Then the
Trainer: `infer(tta=True)` of the JAX Trainer and of the port's on one
synthetic PNG tree (tools/synthetic_tree.py), FCN at width 0.125 with the
same numpy-filled weights on both sides (the JAX Trainer's
`create_train_state` replaced, the weights bridged by
`bridge_flax_names`), float32, scales (0.75, 1.25) to keep the JAX
compile short: the confusion matrices equal but for at most 1e-4 of the
counted pixels (float32 argmax ties, the bound of tests/test_torch_trainer.py)
and the metrics within 1e-4. The CLI with `"tta": true` gives the
in-process matrix, and the Ensemble refuses TTA.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import config as jax_config
from miccai2021_cataract_semantic_segmentation_tpu.train import state as jax_state
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    tta_merged_probs as jax_tta_merged_probs)

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_flax_names
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    TTA_SCALES, tta_merged_probs)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from test_torch_eval import numpy_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hw", [(30, 40), (27, 33)])
def test_tta_merged_probs_matches_jax_in_float64(hw):
    rng = np.random.default_rng(sum(hw))
    x = rng.standard_normal((2, *hw, 3))
    kernel = rng.standard_normal((3, 3, 3, 5)) / 5           # HWIO

    def jax_forward(xi):
        return jax.lax.conv_general_dilated(
            xi, jnp.asarray(kernel), (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax_tta_merged_probs(jax_forward, jnp.asarray(x), TTA_SCALES))
    finally:
        jax.config.update("jax_enable_x64", False)
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    got = tta_merged_probs(lambda xi: torch.nn.functional.conv2d(xi, w, stride=2, padding=1),
                           torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), TTA_SCALES)
    assert got.dtype == torch.float64 and got.shape == (2, 5, *hw)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-12)


GRAPH = {"model": "FCN", "width": 0.125}
N_FRAMES, H, W = 7, 60, 64
VIDEOS = [2, 12, 22, 2, 1, 22, 5]          # 5 in split 2's test videos
SCALES = [0.75, 1.25]


@pytest.fixture(scope="module")
def tta_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tta")
    rng = np.random.default_rng(13)
    grid = rng.integers(0, 18, (N_FRAMES, H // 6 + 1, W // 8 + 1))
    net = np.repeat(np.repeat(grid, 6, 1), 8, 2)[:, :H, :W].astype(np.uint8)
    images = rng.integers(0, 256, (N_FRAMES, H, W, 3), dtype=np.uint8)
    write_tree(root / "data", images, canonical_from_network(net, 2), VIDEOS)
    cfg = json.loads((ROOT / "configs" / "OCRNet_pretrained_t2.json").read_text())
    cfg.update(graph=GRAPH, precision="f32", valid_batch_size=2, max_valid_imgs=1,
               tta=True, tta_scales=SCALES, data_path=str(root / "data"),
               log_path=str(root / "logs"))
    cfg.pop("load_checkpoint")
    (root / "cfg.json").write_text(json.dumps(cfg))
    config = jax_config.parse_config(str(root / "cfg.json"))
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        numpy_variables(jax_build_model(GRAPH, 2, dtype=jnp.float32), seed=4))

    def create_train_state(model, rng, sample, train_cfg, schedule, train=False):
        tx = jax_state.make_optimizer(train_cfg, schedule)
        return jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables.get("batch_stats", {}),
            opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "create_train_state", create_train_state)
        jt = jax_trainer.Trainer(dict(config, run_id="jax"))
    cms = []
    make = jt._make_tta_step

    def recording_tta_step():
        step = make()

        def wrapped(*args):
            out = step(*args)
            cms.append(np.asarray(out[2], np.int64))
            return out
        return wrapped

    jt._make_tta_step = recording_tta_step
    jax_infer = jt.infer()
    jt.train_writer.close()
    jt.valid_writer.close()

    sd = bridge_flax_names(variables["params"], variables.get("batch_stats"))
    pt = Trainer(dict(config, run_id="port"), device="cpu")
    ckpt.load_model_state(pt.model, sd)
    reset_launches()
    port_infer = pt.infer()
    launches = launch_counts()
    pt.close()
    published = root / "logs" / "published" / "chkpts"
    published.mkdir(parents=True)
    torch.save({"model_state_dict": sd}, published / "chkpt_best.pt")
    return root, config, jax_infer, sum(cms[1:]), port_infer, launches


METRICS = ("miou", "miou_instruments", "miou_anatomies", "miou_rare", "pa", "pac")


def test_trainer_tta_infer_matches_jax(tta_runs):
    _, _, jax_infer, jax_cm, port_infer, launches = tta_runs
    got = np.asarray(port_infer["confusion_matrix"])
    assert port_infer["tta"] is True
    assert got.sum() == jax_cm.sum() > 0
    assert np.abs(got - jax_cm).sum() <= 1e-4 * jax_cm.sum()
    for k in METRICS:
        assert abs(port_infer[k] - jax_infer[k]) <= 1e-4, k
    assert launches == dict.fromkeys(KERNELS, 0)


def test_cli_tta_gives_the_in_process_matrix(tta_runs):
    root, config, _, _, port_infer, _ = tta_runs
    cfg = json.loads((root / "cfg.json").read_text())
    cfg.update(load_checkpoint="published", run_id="cli")
    (root / "cli.json").write_text(json.dumps(cfg))
    res = main(["-c", str(root / "cli.json")], device="cpu")
    assert res["tta"] is True
    assert res["confusion_matrix"] == port_infer["confusion_matrix"]
    # without TTA the matrix is the eval step's, another one
    plain = Trainer(dict(config, run_id="plain", tta=False), device="cpu")
    ckpt.restore_checkpoint(root / "logs" / "published" / "chkpts", "best", plain.model)
    no_tta = plain.infer()
    plain.close()
    assert no_tta["tta"] is False
    assert no_tta["confusion_matrix"] != port_infer["confusion_matrix"]
    assert np.asarray(no_tta["confusion_matrix"]).sum() == \
        np.asarray(port_infer["confusion_matrix"]).sum()


def test_ensemble_refuses_tta(tta_runs):
    root, config, *_ = tta_runs
    members = {"a": dict(GRAPH, ckpt="published")}
    cfg = dict(config, run_id="ens", graph={"model": "Ensemble", "members": members})
    t = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="single-model"):
        t.infer(tta=True)
    t.close()
