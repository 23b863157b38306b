"""The port's serving export (train/export.py) against the JAX package's.

- One artifact with a symbolic batch serves batches 1, 2 and 3 after a
  `torch.export.save`/`load` round trip, equal to JAX `make_serving_fn`
  (FCN at width 0.125, the same numpy-filled weights, float64 on both
  sides, the JAX package under x64): pred equal, confidence within 1e-6;
  so do the TTA variant (the reference's five scales) and the Ensemble
  (two FCN members, one ImageNet-normalised, mean and max merge).
- Every graph that `build_model` builds exports once at a small size and
  its exported program gives the eager serving module's outputs (float32:
  pred equal, confidence within 1e-6); a pinned batch stays pinned.
- `export_trainer` and the port's `tools/export_serving.py` write the
  artifact and its sidecar (the JAX sidecar's keys and the device) from a
  Trainer on a synthetic PNG tree, the served outputs equal to the
  Trainer's eval step; the artifact loads and serves in a subprocess with
  the port package and jax blocked; the same Trainer exports over a mesh
  of two CPU devices (`export_trainer`, `export_fn` and the tool's
  `--mesh 2`), serving equal to the one-device artifact, and an
  undivisible batch is refused.
"""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import export as jax_export

from miccai2021_cataract_semantic_segmentation_tpu_torch.models import Ensemble, build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import export_serving
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_flax_names
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    TTA_SCALES, EvalSpec)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from test_torch_eval import numpy_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
FCN = {"model": "FCN", "width": 0.125}
H, W = 30, 40
SPEC = EvalSpec(pad=True, normalise=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(b, seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def fcn_pair():
    """Two FCNs' float64 numpy weights, their JAX apply functions and the
    bridged float64 port models."""
    jax.config.update("jax_enable_x64", True)
    try:
        model = jax_build_model(FCN, 2, dtype=jnp.float64)
        out = []
        for seed in (1, 2):
            variables = jax.tree.map(np.asarray, numpy_variables(model, seed=seed))
            port = build_model(FCN, 2, device="cpu").double()
            ckpt.load_model_state(port, bridge_flax_names(variables["params"]))
            out.append((variables, port.eval()))
    finally:
        jax.config.update("jax_enable_x64", False)
    return model.apply, out


def jax_serve(fn, x):
    jax.config.update("jax_enable_x64", True)
    try:
        res = jax.jit(fn)(jnp.asarray(x))
        return {k: np.asarray(v) for k, v in res.items()}
    finally:
        jax.config.update("jax_enable_x64", False)


def served(module, x):
    with torch.no_grad():
        res = module(torch.from_numpy(x))
    return {k: v.numpy() for k, v in res.items()}


def _equal(got, want, tol=1e-6):
    assert got["pred"].dtype == np.uint8 and got["confidence"].dtype == np.float32
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=0, atol=tol)


def test_one_artifact_serves_batches_1_2_3_as_jax(fcn_pair, tmp_path):
    apply_fn, [(variables, port), _] = fcn_pair
    ep = export.export_serving(port, SPEC, (H, W))
    path = export.save_serving(ep, tmp_path / "fcn")
    assert path.name == "fcn.pt2"
    loaded = export.load_serving(path)
    spec = type("Spec", (), {"pad": True, "normalise": True})()
    for b in (1, 2, 3):
        x = images(b, seed=b)
        want = jax_serve(jax_export.make_serving_fn(apply_fn, variables, spec), x)
        got = served(loaded, x)
        assert got["pred"].shape == (b, H + 4, W)
        _equal(got, want)


def test_tta_artifact_matches_jax(fcn_pair, tmp_path):
    apply_fn, [(variables, port), _] = fcn_pair
    # FCN's five pools need the 0.75 scale's side to stay above 32
    loaded = export.load_serving(export.save_serving(
        export.export_serving(port, SPEC, (60, 64), tta_scales=TTA_SCALES), tmp_path / "tta"))
    spec = type("Spec", (), {"pad": True, "normalise": True})()
    x = images(2, seed=7, h=60, w=64)
    want = jax_serve(jax_export.make_serving_fn(apply_fn, variables, spec,
                                                tta_scales=TTA_SCALES), x)
    _equal(served(loaded, x), want)


@pytest.mark.parametrize("merge", ["mean", "max"])
def test_ensemble_artifact_matches_jax(fcn_pair, tmp_path, merge):
    apply_fn, [(va, pa), (vb, pb)] = fcn_pair
    members = [(lambda v, x: apply_fn(v, x, False), va, False),
               (lambda v, x: apply_fn(v, x, False), vb, True)]
    spec = type("Spec", (), {"pad": True, "normalise": False})()
    x = images(3, seed=11)
    want = jax_serve(jax_export.make_ensemble_serving_fn(members, merge, spec), x)
    ens = Ensemble([pa, pb], [False, True], merge)
    ep = export.export_fn(export.make_ensemble_serving_fn(ens, EvalSpec(pad=True)), (H, W))
    loaded = export.load_serving(export.save_serving(ep, tmp_path / f"ens_{merge}"))
    _equal(served(loaded, x), want)


NARROW = {"ppm_num_ch": 32, "fpn_num_ch": 32}
GRAPHS = {
    "ocrnet_r50_os8": ({"model": "OCRNet", "backbone": "resnet50", "out_stride": 8}, (32, 48)),
    "ocrnet_r18": ({"model": "OCRNet", "backbone": "resnet18"}, (32, 48)),
    "ocrnet_hrnet_w4": ({"model": "OCRNet", "backbone": "hrnetv2_w4"}, (32, 48)),
    "hrnetv2_w4": ({"model": "HRNetv2", "width": 4}, (32, 48)),
    "deeplabv3": ({"model": "DeepLabv3", "backbone": "resnet50", "out_stride": 8}, (32, 48)),
    "deeplabv3plus": ({"model": "DeepLabv3Plus", "backbone": "resnet50", "out_stride": 8},
                      (32, 48)),
    "upernet_r34": ({"model": "EncDec", "encoder": {"model": "ResNet34"},
                     "decoder": {"model": "UPerNet", **NARROW}}, (60, 64)),
    "pointrend_r18": ({"model": "PointRend", "encoder": {"model": "ResNet18"}}, (60, 64)),
    "fcn": (FCN, (30, 40)),
    "unet": ({"model": "UNet"}, (60, 64)),       # 16 divides the padded sides
    "inception_upernet": ({"model": "EncDec", "encoder": {"model": "InceptionV3"},
                           "decoder": {"model": "UPerNet", **NARROW}}, (78, 96)),
    "resnext50_upernet": ({"model": "UPerNet", "encoder": {"model": "ResNeXt50"},
                           "decoder": NARROW}, (60, 64)),
    "wide_resnet50_upernet": ({"model": "UPerNet", "encoder": {"model": "WideResNet50"},
                               "decoder": NARROW}, (60, 64)),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_every_graph_exports(name):
    graph, (h, w) = GRAPHS[name]
    torch.manual_seed(0)
    module = export.make_serving_fn(build_model(graph, 2, device="cpu", seed=3),
                                    EvalSpec(pad=True), precision="f32")
    program = export.export_fn(module, (h, w)).module()
    for b in (1, 3):
        x = images(b, seed=b, h=h, w=w)
        _equal(served(program, x), served(module, x))
    pinned = export.export_fn(module, (h, w), batch=1).module() if name == "fcn" else None
    if pinned is not None:
        _equal(served(pinned, images(1, h=h, w=w)), served(module, images(1, h=h, w=w)))
        with pytest.raises(Exception):
            served(pinned, images(2, h=h, w=w))


N_FRAMES, TH, TW = 5, 60, 64


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 18, (N_FRAMES, TH, TW)).astype(np.uint8)
    write_tree(root / "data", rng.integers(0, 256, (N_FRAMES, TH, TW, 3), dtype=np.uint8),
               canonical_from_network(labels, 2), [2, 12, 22, 1, 2])
    model = build_model(FCN, 2, device="cpu", seed=5)
    ckpt.save_checkpoint(root / "logs" / "pub" / "chkpts", "best", model, 0, 0.0, 0.0)
    cfg = json.loads((ROOT / "configs" / "OCRNet_pretrained_t2.json").read_text())
    cfg.update(graph=FCN, precision="f32", log_path=str(root / "logs"),
               load_checkpoint="pub", data_path=str(root / "data"), run_id="exp")
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root, cfg


def test_export_trainer_writes_the_artifact_and_its_sidecar(published, tmp_path):
    root, cfg = published
    t = Trainer(cfg, device="cpu")
    t.load_checkpoint("best", run_id="pub")
    path = export.export_trainer(t, tmp_path / "serving")
    meta = json.loads(path.with_suffix(".pt2.json").read_text())
    jax_keys = {"input", "output", "task", "num_classes", "class_names", "colormap_rgb",
                "tta_scales", "mesh_devices", "run_id"}
    assert set(meta) == jax_keys | {"device", "batch"} and meta["device"] == "cpu"
    assert meta["batch"] is None and meta["mesh_devices"] is None
    assert meta["output"]["pred"] == ["batch", TH + 4, TW] and meta["num_classes"] == 17
    x = images(2, seed=3, h=TH, w=TW)
    got = served(export.load_serving(path), x)
    logits, _, _ = t.eval_step(t.model, x, np.zeros((2, TH, TW), np.uint8))
    np.testing.assert_array_equal(got["pred"], logits.argmax(1).numpy())
    conf = torch.softmax(logits, 1).amax(1).numpy()
    np.testing.assert_allclose(got["confidence"], conf, rtol=0, atol=1e-6)
    # over a mesh each device runs one image: bit-equal to the one-device
    # artifact image by image; its batch-2 convolutions round otherwise
    mesh_path = export.export_trainer(t, tmp_path / "m", batch=2, mesh=["cpu", "cpu"])
    meta = json.loads(mesh_path.with_suffix(".pt2.json").read_text())
    assert (meta["mesh_devices"], meta["batch"]) == (2, 2)
    on_mesh = served(export.load_serving(mesh_path, mesh=["cpu", "cpu"]), x)
    one = [served(export.load_serving(path), x[i:i + 1]) for i in range(2)]
    _equal(on_mesh, {k: np.concatenate([o[k] for o in one]) for k in got}, tol=0)
    _equal(on_mesh, got)
    with pytest.raises(ValueError, match="pinned batch divisible by 2"):
        export.export_fn(export.make_serving_fn(t.model, None), (TH, TW), mesh=["cpu"] * 2)
    t.close()
    tool = export_serving.main(["-c", str(root / "cfg.json"), "--device", "cpu",
                                "--batch", "2", "-o", str(tmp_path / "tool")])
    meta = json.loads(tool.with_suffix(".pt2.json").read_text())
    assert tool.name == "tool.pt2" and meta["tta_scales"] is None
    _equal(served(export.load_serving(tool), x), got, tol=0)
    tool = export_serving.main(["-c", str(root / "cfg.json"), "--device", "cpu",
                                "--mesh", "2", "--batch", "4", "-o", str(tmp_path / "mesh")])
    meta = json.loads(tool.with_suffix(".pt2.json").read_text())
    assert (meta["mesh_devices"], meta["batch"]) == (2, 4)
    x4 = images(4, seed=5, h=TH, w=TW)
    one = [served(export.load_serving(path), x4[i:i + 2]) for i in (0, 2)]
    _equal(served(export.load_serving(tool, mesh=["cpu", "cpu"]), x4),
           {k: np.concatenate([o[k] for o in one]) for k in got}, tol=0)


_LOAD = """
import json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                  "miccai2021_cataract_semantic_segmentation_tpu",
                                  "miccai2021_cataract_semantic_segmentation_tpu_torch"):
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)
x = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    out = torch.export.load(sys.argv[1]).module()(x)
np.savez(sys.argv[3], pred=out["pred"].numpy(), confidence=out["confidence"].numpy())
print(json.dumps(sorted(m for m in sys.modules if m.startswith("miccai"))))
"""


def test_artifact_loads_and_serves_without_the_port_or_jax(fcn_pair, tmp_path):
    _, [(_, port), _] = fcn_pair
    path = export.save_serving(export.export_serving(port.float(), SPEC, (H, W)),
                               tmp_path / "alone")
    port.double()
    x = images(3, seed=5)
    np.save(tmp_path / "x.npy", x)
    out = subprocess.run([sys.executable, "-c", _LOAD, str(path), str(tmp_path / "x.npy"),
                          str(tmp_path / "out.npz")], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    got = dict(np.load(tmp_path / "out.npz"))
    _equal(got, served(export.load_serving(path), x), tol=0)
