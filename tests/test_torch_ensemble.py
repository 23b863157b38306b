"""The port's Ensemble against the JAX package: `ensemble_apply` with mean
and max merge over two members (OCRNet-R18, and a UPerNet-R18 whose
inputs are ImageNet-normalised first), float64 through the weight
bridges, probabilities within 1e-6 (the JAX package takes each member's
softmax in float32, the port in at least float32); and the Trainer's
inference-only Ensemble mode from members saved as `chkpt_best.pt`, its
confusion matrix equal to the port's functional `ensemble_apply` on the
same frames, through the Trainer and through the CLI, with both merges.
Sizes are cut for the CPU: 2 x 64 x 96 inputs, the UPerNet decoder at 32
channels, a synthetic tree of 7 frames of 60 x 64.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.models.ensemble import (
    ensemble_apply as jax_ensemble_apply)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import assemble_batch
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import (
    Ensemble, build_ensemble, build_model, ensemble_apply)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import confusion_matrix
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_encdec_upernet, bridge_ocrnet)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, eval_preprocess)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from test_torch_eval import numpy_variables

MEMBERS = {"a_ocr": {"model": "OCRNet", "backbone": "resnet18"},
           "b_upn": {"model": "UPerNet", "encoder": {"model": "ResNet18"},
                     "decoder": {"ppm_num_ch": 32, "fpn_num_ch": 32}}}
BRIDGES = {"a_ocr": bridge_ocrnet, "b_upn": bridge_encdec_upernet}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_members():
    """The two members' float64 JAX variables, one [0, 1] input and the
    JAX ensemble's merged probabilities by mean and by max."""
    x = np.random.default_rng(3).random((2, 64, 96, 3))
    jax.config.update("jax_enable_x64", True)
    try:
        members, variables = [], {}
        for i, key in enumerate(sorted(MEMBERS)):
            model = jax_build_model(MEMBERS[key], 2, dtype=jnp.float64)
            variables[key] = jax.tree.map(np.asarray, numpy_variables(model, seed=i))
            members.append((jax.jit(lambda v, x, m=model: m.apply(v, x, False)),
                            variables[key], MEMBERS[key]["model"] == "UPerNet"))
        want = {merge: np.asarray(jax_ensemble_apply(members, jnp.asarray(x), merge))
                for merge in ("mean", "max")}
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, x, want


def port_members(variables):
    out = []
    for key in sorted(MEMBERS):
        model = build_model(MEMBERS[key], 2, device="cpu").double()
        model.load_state_dict(BRIDGES[key](variables[key]["params"],
                                           variables[key]["batch_stats"]), strict=True)
        out.append((model.eval(), MEMBERS[key]["model"] == "UPerNet"))
    return out


@pytest.mark.parametrize("merge", ["mean", "max"])
def test_ensemble_apply_matches_jax(jax_members, merge):
    variables, x, want = jax_members
    members = port_members(variables)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = ensemble_apply(members, xt, merge)
        module = Ensemble([m for m, _ in members], [n for _, n in members], merge)(xt)
    assert got.shape == (2, 17, 64, 96) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want[merge].transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    assert torch.equal(module["logits"], got)
    if merge == "mean":
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-12)
    with pytest.raises(ValueError, match="merge"):
        ensemble_apply(members, xt, "median")


N_FRAMES, H, W = 7, 60, 64
VIDEOS = [2, 12, 22, 2, 1, 22, 5]          # split 2's test videos are 2, 12, 22


@pytest.fixture(scope="module")
def saved_members(tmp_path_factory):
    """A synthetic tree and the two members saved as `chkpt_best.pt` of
    their runs (seeded random weights)."""
    root = tmp_path_factory.mktemp("ensemble")
    rng = np.random.default_rng(5)
    grid = rng.integers(0, 18, (N_FRAMES, H // 6 + 1, W // 8 + 1))
    net = np.repeat(np.repeat(grid, 6, 1), 8, 2)[:, :H, :W].astype(np.uint8)
    images = rng.integers(0, 256, (N_FRAMES, H, W, 3), dtype=np.uint8)
    write_tree(root / "data", images, canonical_from_network(net, 2), VIDEOS)
    members = {}
    for i, key in enumerate(sorted(MEMBERS)):
        model = build_model(MEMBERS[key], 2, device="cpu", seed=10 + i)
        ckpt.save_checkpoint(root / "logs" / f"run_{key}" / "chkpts", "best", model,
                             0, 0.5, 1.0)
        members[key] = dict(MEMBERS[key], ckpt=f"run_{key}")
    return root, members


def config(root, members, merge, run_id):
    return {"name": "ensemble", "mode": "inference", "manager": "Ensemble",
            "graph": {"model": "Ensemble", "members": members, "merge": merge},
            "data": {"experiment": 2, "split": 2, "transforms": ["pad"],
                     "blacklist": False, "batch_size": 1},
            "train": {}, "loss": {}, "precision": "f32", "seed": 0,
            "valid_batch_size": 2, "max_valid_imgs": 1, "run_id": run_id,
            "data_path": str(root / "data"), "log_path": str(root / "logs")}


def functional_matrix(root, members, merge, valid_set) -> np.ndarray:
    """The port's `ensemble_apply` over the validation frames in the
    Trainer's batches of 2 (the tail padded with its last frame, masked),
    its members restored by hand from their checkpoints."""
    models = []
    for key in sorted(members):
        m = build_model(MEMBERS[key], 2, device="cpu")
        ckpt.restore_checkpoint(root / "logs" / f"run_{key}" / "chkpts", "best", m)
        models.append((m.eval(), MEMBERS[key]["model"] == "UPerNet"))
    n = len(valid_set)
    cm = np.zeros((17, 17), np.int64)
    for start in range(0, n, 2):
        idx = np.minimum(np.arange(start, start + 2), n - 1)
        images, labels, _ = assemble_batch(valid_set, idx)
        labels = np.array(labels)
        labels[idx != np.arange(start, start + 2)] = 255
        x, lbl = eval_preprocess(torch.as_tensor(images), EvalSpec(pad=True),
                                 torch.as_tensor(labels))
        with torch.inference_mode():
            cm += confusion_matrix(ensemble_apply(models, x, merge), lbl, 17).numpy()
    return cm


@pytest.mark.parametrize("merge", ["mean", "max"])
def test_trainer_ensemble_inference_from_saved_members(saved_members, merge):
    """`Trainer.infer` in Ensemble mode (members restored from their runs'
    chkpt_best.pt, the pad alone as preprocessing) counts the same matrix
    as the functional ensemble; the CLI gives the same metrics."""
    root, members = saved_members
    t = Trainer(config(root, members, merge, f"trainer_{merge}"), device="cpu")
    assert isinstance(t.model, Ensemble) and t.model.needs_norm == (False, True)
    assert t.state is None and t.model.merge == merge
    res = t.infer()
    t.close()
    want = functional_matrix(root, members, merge, t.valid_set)
    assert len(t.valid_set) == 5 and want.sum() > 0
    np.testing.assert_array_equal(np.asarray(res["confusion_matrix"]), want)
    path = root / f"cli_{merge}.json"
    path.write_text(json.dumps(config(root, members, merge, f"cli_{merge}")))
    cli = main(["-c", str(path)], device="cpu")
    assert cli["confusion_matrix"] == res["confusion_matrix"]
    assert cli["miou"] == res["miou"]


def test_ensemble_builds_from_a_top_level_member_list_and_refuses_training(saved_members):
    root, members = saved_members
    ens = build_ensemble({"members": members}, 2, root / "logs", device="cpu")
    assert ens.merge == "mean" and len(ens.members) == 2 and not ens.training
    cfg = config(root, members, "mean", "top")
    cfg.pop("graph")
    cfg.update(members=members, merge="max")
    t = Trainer(cfg, device="cpu")
    assert isinstance(t.model, Ensemble) and t.model.merge == "max"
    t.close()
    with pytest.raises(ValueError, match="inference mode only"):
        Trainer(dict(config(root, members, "mean", "train"), mode="training"),
                device="cpu")
