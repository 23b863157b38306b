"""The port's served path against the JAX package: cross-entropy, the
config parser and CLI overrides, reference-layout checkpoints, and the
Trainer's `infer()` and `validate(0)` and the CLI from PNGs on disk; then
the full-size OCRNet check.

The slice as a whole: a synthetic CaDIS tree (tools/synthetic_tree.py) is
read by the JAX Trainer (pandas, cv2) and by the port's (data/png.py or
the native decoder), both in float32, OCRNet-R50 os8 with the JAX
Trainer's own flax init (jitted once for the module, the values its eager
init gives) bridged to the port (train/bridge.py). Their confusion
matrices may differ on at most 1e-4 of the counted pixels (float32
argmax ties), the metrics by 1e-4, the validation loss by 1e-5.
"""
import argparse
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from miccai2021_cataract_semantic_segmentation_tpu.losses.functional import (
    cross_entropy as jax_cross_entropy)
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import config as jax_config
from miccai2021_cataract_semantic_segmentation_tpu.train import state as jax_state
from miccai2021_cataract_semantic_segmentation_tpu.train import trainer as jax_trainer

from miccai2021_cataract_semantic_segmentation_tpu_torch.data import video_io
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import cross_entropy
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import build_argparser, main
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_ocrnet
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import (
    apply_cli_overrides, parse_config)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.json")
                 if p.name != "path_info.json")


# ------------------------------------------------------------ cross-entropy

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ce_case(name):
    rng = np.random.default_rng(len(name))
    logits = rng.standard_normal((2, 17, 6, 7)) * 3
    labels = rng.integers(0, 18, (2, 6, 7))
    ignore, weights = 17, None
    if name == "weights":
        weights = rng.uniform(0.2, 2.0, 17)
    elif name == "label_255":            # masked tail rows: class C-1 here
        labels[1] = 255
    elif name == "all_ignored":
        labels[:] = 17
    elif name == "no_ignore":
        ignore, labels = -1, labels % 17
    return logits, labels, ignore, weights


@pytest.mark.parametrize("name", ["plain", "weights", "label_255", "all_ignored",
                                  "no_ignore"])
def test_cross_entropy_value_and_gradient_equal_jax(name):
    logits, labels, ignore, weights = _ce_case(name)
    jax.config.update("jax_enable_x64", True)
    try:
        def f(lg):
            return jax_cross_entropy(lg, jnp.asarray(labels), ignore, weights)
        want, want_g = jax.value_and_grad(f)(jnp.asarray(logits.transpose(0, 2, 3, 1)))
        want, want_g = float(want), np.asarray(want_g).transpose(0, 3, 1, 2)
    finally:
        jax.config.update("jax_enable_x64", False)
    x = torch.tensor(logits, dtype=torch.float64, requires_grad=True)
    got = cross_entropy(x, torch.as_tensor(labels), ignore, weights)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-5, atol=1e-8)
    if name == "all_ignored":
        assert float(got.detach()) == 0.0 and float(x.grad.abs().max()) == 0.0


def test_empty_loss_section_is_cross_entropy():
    rng = np.random.default_rng(0)
    x = torch.randn(1, 8, 5, 6)
    lbl = torch.as_tensor(rng.integers(0, 8, (1, 5, 6)))
    loss = build_loss({}, 1, "cpu")
    assert loss.full_res == ("logits",)
    total, terms = loss({"logits": x}, lbl)
    assert float(total) == float(cross_entropy(x, lbl)) and set(terms) == {"CrossEntropyLoss"}
    weighted = build_loss({"name": "CrossEntropyLoss", "weights": [1.0] * 7 + [3.0],
                           "ignore_index": 2}, 1, "cpu")
    assert float(weighted({"logits": x}, lbl)[0]) == float(
        cross_entropy(x, lbl, 2, [1.0] * 7 + [3.0]))


# ------------------------------------------------------------------ config

_OVERRIDES = {"none": [], "user": ["-u", "example_user", "-d", "1"],
              "all": ["-u", "example_user", "-t", "3", "-bs", "4", "-dp", "/data",
                      "-bl", "-rl"]}


@pytest.mark.parametrize("flags", sorted(_OVERRIDES))
@pytest.mark.parametrize("name", CONFIGS)
def test_parse_config_and_overrides_equal_jax(name, flags):
    argv = ["-c", str(ROOT / "configs" / name)] + _OVERRIDES[flags]
    args = build_argparser().parse_args(argv)
    assert vars(args) == vars(jax_main.build_argparser().parse_args(argv))
    got = apply_cli_overrides(parse_config(args.config, args.user, args.device), args)
    want = jax_config.apply_cli_overrides(
        jax_config.parse_config(args.config, args.user, args.device), args)
    assert got == want


# ------------------------------------------------------------- checkpoints

GRAPH = {"model": "HRNetv2", "width": 4}


@pytest.mark.parametrize("wrapper", ["model_state_dict", "state_dict", "bare"])
def test_torch_checkpoint_wrappers_load_strictly(tmp_path, wrapper):
    src = build_model(GRAPH, 2, device="cpu", seed=1)
    sd = src.state_dict()
    torch.save(sd if wrapper == "bare" else {wrapper: sd, "epoch": 4}, tmp_path / "w.pt")
    dst = build_model(GRAPH, 2, device="cpu", seed=2)
    ckpt.load_model_state(dst, ckpt.load_torch_checkpoint(tmp_path / "w.pt"))
    for k, v in dst.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_checkpoint_round_trip_and_wrong_keys(tmp_path):
    src = build_model(GRAPH, 2, device="cpu", seed=1)
    path = ckpt.save_checkpoint(tmp_path / "run" / "chkpts", "best", src, 3, 0.25, 0.5)
    assert path.name == "chkpt_best.pt" and not list(path.parent.glob("*.tmp"))
    payload = ckpt.read_checkpoint(path)
    assert set(payload) == {"model_state_dict", "epoch", "best_miou", "best_loss"}
    dst = build_model(GRAPH, 2, device="cpu", seed=2)
    meta = ckpt.restore_checkpoint(path.parent, "best", dst)
    assert meta == {"epoch": 3, "best_miou": 0.25, "best_loss": 0.5, "global_step": 0}
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in dst.state_dict().items())
    sd = dict(src.state_dict())
    sd["head.extra.weight"] = sd.pop("last_layer.3.weight")
    with pytest.raises(RuntimeError, match=r"missing keys \['last_layer.3.weight'\], "
                       r"unexpected keys \['head.extra.weight'\]"):
        ckpt.load_model_state(dst, sd)
    other = build_model(GRAPH, 3, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="shapes differ at .*last_layer.3.weight"):
        ckpt.load_model_state(dst, other)


def test_checkpoint_keeps_the_train_state(tmp_path):
    """Where a train state exists, its optimiser state and step go in the
    checkpoint as `optimizer_state_dict` and `global_step`, and come back."""
    def state_after_one_update(seed):
        model = build_model(GRAPH, 2, device="cpu", seed=seed)
        state = create_train_state(model, {"learning_rate": 1e-3}, lambda step: 1e-3)
        grads = []
        for p in model.parameters():
            p.grad = torch.full_like(p, 0.5)
            grads.append(p.grad)
        state.apply_gradients(grads)
        return state

    src = state_after_one_update(1)
    ckpt.save_checkpoint(tmp_path, "last", src.model, 7, 0.1, 0.2, src)
    assert ckpt.read_checkpoint(tmp_path / "chkpt_last.pt")["global_step"] == 1
    dst = create_train_state(build_model(GRAPH, 2, device="cpu", seed=2),
                             {"learning_rate": 1e-3}, lambda step: 1e-3)
    meta = ckpt.restore_checkpoint(tmp_path, "last", dst.model, dst)
    assert meta["global_step"] == dst.step == 1 and meta["epoch"] == 7
    want, got = src.optimizer.state_dict(), dst.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for k, v in want["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["state"][k][name], v[name])


# ---------------------------------------------------------- the whole slice

OCR = {"model": "OCRNet", "backbone": "resnet50", "out_stride": 8}
N_FRAMES, H, W = 7, 60, 64
VIDEOS = [2, 12, 22, 2, 1, 22, 5]          # 5 in split 2's test videos


@pytest.fixture(scope="module")
def ocr_init():
    """flax's OCRNet-R50 os8 init (task 2) at the Trainer's sample shape
    (1, 64, 64, 3), jitted: what `create_train_state` computes eagerly."""
    model = jax_build_model(OCR, 2, dtype=jnp.float32)
    init = jax.jit(lambda r, x: model.init({"params": r, "points": r, "dropout": r},
                                           x, False))
    return model, init


@pytest.fixture(scope="module")
def served(tmp_path_factory, ocr_init):
    """Both Trainers on one tree and one set of weights: infer(), then
    validate(0), each eval step's confusion matrices recorded."""
    root = tmp_path_factory.mktemp("served")
    rng = np.random.default_rng(11)
    grid = rng.integers(0, 18, (N_FRAMES, H // 6 + 1, W // 8 + 1))
    net = np.repeat(np.repeat(grid, 6, 1), 8, 2)[:, :H, :W].astype(np.uint8)
    images = rng.integers(0, 256, (N_FRAMES, H, W, 3), dtype=np.uint8)
    write_tree(root / "data", images, canonical_from_network(net, 2), VIDEOS)
    cfg = json.loads((ROOT / "configs" / "OCRNet_pretrained_t2.json").read_text())
    cfg.update(graph=OCR, precision="f32", valid_batch_size=2, max_valid_imgs=2,
               data_path=str(root / "data"), log_path=str(root / "logs"))
    cfg.pop("load_checkpoint")
    (root / "cfg.json").write_text(json.dumps(cfg))
    config = jax_config.parse_config(str(root / "cfg.json"))

    _, init = ocr_init

    def create_train_state(model, rng, sample, train_cfg, schedule, train=False):
        assert sample.shape == (1, 64, 64, 3) and not train
        variables = init(rng, sample)
        tx = jax_state.make_optimizer(train_cfg, schedule)
        return jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "create_train_state", create_train_state)
        jt = jax_trainer.Trainer(dict(config, run_id="jax"))
    cms = {"infer": [], "validate": []}

    def recording(step, key):
        def wrapped(*args):
            out = step(*args)
            cms[key].append(np.asarray(out[2], np.int64))
            return out
        return wrapped

    eval_step, eval_loss_step = jt.eval_step, jt.eval_loss_step
    jt.eval_step = recording(eval_step, "infer")
    jax_infer = jt.infer()
    jt.eval_step = recording(eval_step, "validate")
    jt.eval_loss_step = recording(eval_loss_step, "validate")
    jt.validate(0)
    jax_valid = dict(jt.metrics)
    jax_cms = {"infer": sum(cms["infer"][1:]),       # [0] is the warm-up batch
               "validate": sum(cms["validate"])}
    jt.train_writer.close()
    jt.valid_writer.close()

    sd = bridge_ocrnet(jax.tree.map(np.asarray, jt.state.params),
                       jax.tree.map(np.asarray, jt.state.batch_stats))
    pt = Trainer(dict(config, run_id="port"), device="cpu")
    ckpt.load_model_state(pt.model, sd)
    port_infer = pt.infer()
    port_valid = pt.validate(0)
    pt.close()
    torch.save({"model_state_dict": sd}, root / "published.pt")
    return root, config, jax_infer, jax_valid, jax_cms, port_infer, port_valid


def _close(got_cm, want_cm, got, want, keys):
    got_cm = np.asarray(got_cm)
    assert got_cm.sum() == want_cm.sum() > 0
    assert np.abs(got_cm - want_cm).sum() <= 1e-4 * want_cm.sum()
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-4, k


METRICS = ("miou", "miou_instruments", "miou_anatomies", "miou_rare", "pa", "pac")


def test_infer_from_pngs_matches_jax(served):
    root, _, jax_infer, _, jax_cms, port_infer, _ = served
    _close(port_infer["confusion_matrix"], jax_cms["infer"], port_infer, jax_infer,
           METRICS)
    assert port_infer["decoded"]["native"] + port_infer["decoded"]["png"] == 3
    info = json.loads((root / "logs" / "port" / "info.json").read_text())
    assert info["metrics"]["miou"] == port_infer["miou"]
    assert info["config"]["graph"] == OCR


def test_validate_from_pngs_matches_jax(served):
    root, _, _, jax_valid, jax_cms, _, port_valid = served
    _close(port_valid["confusion_matrix"], jax_cms["validate"], port_valid, jax_valid,
           METRICS)
    assert abs(port_valid["valid_loss"] - jax_valid["valid_loss"]) <= 1e-5
    assert np.allclose(port_valid["per_class_iou"], jax_valid["per_class_iou"], atol=1e-4)
    # best mIoU at epoch 0: the reference-layout checkpoint, and info.json
    payload = ckpt.read_checkpoint(root / "logs" / "port" / "chkpts" / "chkpt_best.pt")
    assert payload["epoch"] == 0 and payload["best_miou"] == port_valid["miou"]
    info = json.loads((root / "logs" / "port" / "info.json").read_text())
    assert info["metrics"]["valid_loss"] == port_valid["valid_loss"]


def test_cli_serves_a_published_run(served):
    """The CLI loads <log_path>/<load_checkpoint>/chkpts/chkpt_best.pt and
    writes info.json with the inference metrics."""
    root, config, *_, port_infer, _ = served
    run = root / "logs" / "published_run" / "chkpts"
    run.mkdir(parents=True)
    (root / "published.pt").rename(run / "chkpt_best.pt")
    cfg = json.loads((root / "cfg.json").read_text())
    cfg.update(load_checkpoint="published_run", run_id="cli")
    (root / "cli.json").write_text(json.dumps(cfg))
    res = main(["-c", str(root / "cli.json"), "-dp", str(root / "data")], device="cpu")
    info = json.loads((root / "logs" / "cli" / "info.json").read_text())
    assert info["metrics"]["confusion_matrix"] == port_infer["confusion_matrix"]
    for k in METRICS:
        assert info["metrics"][k] == res[k] == port_infer[k]
    # the video mode: workflow/test/<id>.mp4 beside the dataset root, the
    # best checkpoint of `load_checkpoint`, one colour-mapped video out
    frames = np.random.default_rng(2).integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    (root / "workflow" / "test").mkdir(parents=True)
    writer = video_io.AviWriter(root / "workflow" / "test" / "dev01.mp4", 25, (W, H))
    for f in frames:
        writer.write(f)
    writer.release()
    (root / "video.json").write_text(json.dumps(dict(
        cfg, mode="video_inference", run_id="video", video_ids=["dev01"],
        video_height=H, video_width=W)))
    res = main(["-c", str(root / "video.json"), "-dp", str(root / "data")], device="cpu")
    assert res["frames"] == 3 and not res["side_by_side"]
    assert res["outputs"] == [str(root / "logs" / "video" / "dev01_OCRNet.avi")]
    assert video_io.open_reader(res["outputs"][0]).frame_count == 3


def test_trainer_refuses_what_is_not_ported(served):
    """TTA and the semi mode's pool of the training videos are ported
    (tests/test_torch_tta.py, test_torch_video.py): TTA at the identity
    scale alone (flip and no flip) counts the same pixels as `infer`; the
    semi mode refuses a tree without the training split's videos."""
    root, config, *_, port_infer, _ = served
    t = Trainer(dict(config, run_id="tta", tta=True, tta_scales=[1.0]), device="cpu")
    res = t.infer()
    t.close()
    assert res["tta"] is True
    assert np.asarray(res["confusion_matrix"]).sum() == \
        np.asarray(port_infer["confusion_matrix"]).sum()
    with pytest.raises(FileNotFoundError, match="no training-split videos"):
        Trainer(dict(config, run_id="x", loss={"name": "SemiSupervisedLoss"},
                     mode="training", data=dict(config["data"], batch_size=2)),
                device="cpu")
    # the Ensemble (item 12) is ported: one member, the served run's best
    # checkpoint, counts what the served Trainer's infer() counted
    ens = Trainer(dict(config, run_id="ensemble", graph={
        "model": "Ensemble", "members": {"a": dict(OCR, ckpt="port")}}), device="cpu")
    _close(ens.infer()["confusion_matrix"], np.asarray(port_infer["confusion_matrix"]),
           {}, {}, ())
    ens.close()
    with pytest.raises(FileNotFoundError, match="moco_v2_800ep_pretrain"):
        Trainer(dict(config, run_id="x", graph=dict(OCR, ss_pretrained="moco"),
                     ss_pretrained_path=str(root / "no_moco")), device="cpu")


# ------------------------------------------------------- full-size OCRNet

def test_ocrnet_r50_full_size_matches_jax(ocr_init):
    """Flax-initialised OCRNet-R50 os8 bridged to the port, one 544x960
    input, float32: argmax agreement above 0.999, logits within atol 5e-4,
    rtol 1e-2 (ROADMAP item 2's last check)."""
    model, init = ocr_init
    variables = init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3), jnp.float32))
    x = np.random.default_rng(0).random((1, 544, 960, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False)["logits"])(
        variables, x)).transpose(0, 3, 1, 2)
    port = build_model(OCR, 2, device="cpu")
    port.load_state_dict(bridge_ocrnet(jax.tree.map(np.asarray, variables["params"]),
                                       jax.tree.map(np.asarray, variables["batch_stats"])),
                         strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())["logits"].numpy()
    assert got.shape == want.shape == (1, 17, 544, 960)
    assert (got.argmax(1) == want.argmax(1)).mean() > 0.999
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-2)


def test_argparser_flags():
    args = build_argparser().parse_args(["-c", "x.json", "-d", "2", "-t", "1"])
    assert isinstance(args, argparse.Namespace) and (args.device, args.task) == (2, 1)
