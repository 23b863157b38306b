"""The port's paper-reproduction harness (tools/reproduce_paper.py of the
port package) against the repository's JAX one (tools/reproduce_paper.py)
on one synthetic CaDIS tree and one synthetic reference-layout .pt
(tests/test_reproduce_paper.py's): OCRNet-R18, task 1, 5 test frames,
valid batch 2, without and with --tta. Both harnesses run their configs in
float32 (the shipped configs say bf16; a wrapper of each tool's
`parse_config` sets "precision"), each its own Trainer's `infer`: both
exit 1 (random weights miss the paper's band; TensorBoard writers and the
JAX init, which the .pt overwrites, stubbed), their tables and last JSON
lines agree, the confusion matrices differ on at most 1e-4 of the counted
pixels (float32 argmax ties) and the mIoU by at most 1e-4. Then the
port's `--dry-table`, its exit 2 when no task ran, and its refusal to run
on a missing card unless given `--device cpu`.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import miccai2021_cataract_semantic_segmentation_tpu.train as jax_train
from miccai2021_cataract_semantic_segmentation_tpu.train import state as jax_state
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer
from test_reproduce_paper import _write_fake_cadis, _write_fake_checkpoint
from tools import reproduce_paper as jax_reproduce

from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import reproduce_paper
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import config as port_config
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import trainer as port_trainer
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.loggers import NullLogger

CM_SHARE, MIOU_TOL = 1e-4, 1e-4
METRICS = ("miou", "miou_instruments", "miou_anatomies", "miou_rare", "pa", "pac")
jax_breakdown = jax_trainer.mean_iou_breakdown


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX harness test's tree and .pt, the .pt completed to a whole
    reference state dict (the port loads strictly): the two convolution
    biases it leaves out drawn from a seed, BatchNorm's counters 0."""
    root = tmp_path_factory.mktemp("reproduce")
    csv = _write_fake_cadis(root, videos=[1, 2, 12, 22], h=32, w=48)   # 9 test frames
    pt = root / "chkpt_best.pt"
    _write_fake_checkpoint(pt, n_cls=8)                     # a task-1 head
    sd = torch.load(pt)["model_state_dict"]
    own = build_model({"model": "OCRNet", "backbone": "resnet18", "out_stride": 8}, 1,
                      device="cpu").state_dict()
    rng = np.random.default_rng(7)
    for key in sorted(set(own) - set(sd)):
        sd[key] = torch.zeros_like(own[key]) if key.endswith("num_batches_tracked") else \
            torch.from_numpy(rng.normal(size=own[key].shape).astype(np.float32))
    torch.save({"model_state_dict": sd}, pt)
    return root, csv, pt


def harness(module, parse_module, tree, tta: bool, device=None):
    """`module.main` on the tree in float32: (exit code, Trainer.infer's
    results, the printed table and JSON line)."""
    root, csv, pt = tree
    argv = ["--data-root", str(root), "--ckpt", f"1={pt}", "--backbone", "resnet18",
            "--data-csv", str(csv), "--max-frames", "5", "--valid-batch-size", "2",
            "--log-path", str(root / f"logs_{module.__name__.split('.')[-1]}_{tta}")]
    argv += ["--tta"] * tta + (["--device", device] if device else [])
    parse, run_task = parse_module.parse_config, module.run_task
    results, cms = [], []

    def recorded(*args):
        results.append(run_task(*args))
        results[-1].setdefault("confusion_matrix", cms[-1] if cms else None)
        return results[-1]

    def breakdown(cm, task):          # the JAX infer's matrix, which it does not return
        cms.append(np.asarray(cm))
        return jax_breakdown(cm, task)

    def create_train_state(model, rng, sample, train_cfg, schedule, train=False):
        """The JAX Trainer's state with zeros for the initial values (flax's
        init takes tens of seconds on a CPU): the .pt overwrites every
        parameter and statistic, so the init's values never reach
        inference."""
        variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(
            lambda r, x: model.init({"params": r, "points": r, "dropout": r}, x, train),
            rng, sample))
        tx = jax_state.make_optimizer(train_cfg, schedule)
        return jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
            apply_fn=model.apply, tx=tx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parse_module, "parse_config",
                   lambda *a: dict(parse(*a), precision="f32"))
        mp.setattr(module, "run_task", recorded)
        mp.setattr(jax_trainer, "mean_iou_breakdown", breakdown)
        mp.setattr(jax_trainer, "create_train_state", create_train_state)
        # no TensorBoard writers (their import of TensorFlow takes many seconds)
        mp.setattr(jax_trainer, "TBLogger", NullLogger)
        mp.setattr(port_trainer, "TBLogger", NullLogger)
        printed = io.StringIO()
        with pytest.raises(SystemExit) as exit_, contextlib.redirect_stdout(printed):
            module.main(argv)
    return exit_.value.code, results[0], printed.getvalue().strip().splitlines()[-6:]


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "tta"])
def both(request, tree):
    tta = request.param
    return {"jax": harness(jax_reproduce, jax_train, tree, tta),
            "port": harness(reproduce_paper, port_config, tree, tta, device="cpu")}


def test_exit_and_metrics_match_jax(both):
    (j_code, j_res, _), (p_code, p_res, _) = both["jax"], both["port"]
    assert j_code == p_code == 1
    want, got = np.asarray(j_res["confusion_matrix"]), np.asarray(p_res["confusion_matrix"])
    assert got.sum() == want.sum() > 0
    assert np.abs(got - want).sum() <= CM_SHARE * want.sum()
    for k in METRICS:
        assert abs(p_res[k] - j_res[k]) <= MIOU_TOL, k


def test_table_and_json_line_match_jax(both):
    """The printed table and JSON line, the mIoU aside."""
    lines = {side: both[side][2] for side in ("jax", "port")}
    rows = {side: json.loads(v[-1])["results"] for side, v in lines.items()}
    for r_port, r_jax in zip(rows["port"], rows["jax"]):
        assert set(r_port) == set(r_jax)
        for k in ("task", "paper_miou", "status"):
            assert r_port[k] == r_jax[k]
        if r_jax["miou"] is not None:
            assert abs(r_port["miou"] - r_jax["miou"]) <= 100 * MIOU_TOL
    assert "FAIL" in rows["port"][0]["status"]
    assert rows["port"][1]["status"].startswith("skipped")
    # the title, header and skipped rows verbatim; the first row's numbers aside
    assert lines["port"][:2] == lines["jax"][:2]
    assert lines["port"][3:-1] == lines["jax"][3:-1]
    assert lines["port"][2].split()[:2] == lines["jax"][2].split()[:2]


def test_dry_table_and_nothing_run(capsys):
    reproduce_paper.main(["--data-root", "/nonexistent", "--dry-table"])
    out = capsys.readouterr().out
    for v in ("86.40", "79.40", "71.94"):
        assert v in out
    jax_reproduce.main(["--data-root", "/nonexistent", "--dry-table"])
    assert capsys.readouterr().out == out
    with pytest.raises(SystemExit) as e:
        reproduce_paper.main(["--data-root", "/nonexistent"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        reproduce_paper.main(["--data-root", "/x", "--ckpt", "4=/x.pt"])
    assert "task must be 1-3" in str(e.value.code)


def test_refuses_a_missing_card(tree):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    root, csv, pt = tree
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reproduce_paper.main(["--data-root", str(root), "--ckpt", f"1={pt}",
                              "--data-csv", str(csv), "--log-path", str(root / "logs")])
