"""The port stands alone: it imports nothing of JAX, flax, optax or the JAX
package (its validation and train paths, OCRNet's and HRNetv2's,
DeepLabv3's forward with both single-scale fused Lovász routes,
EncDec-UPerNet's validation on the LossWrapper, the prototype fused
upsample's checks and the CLI's inference and training from a PNG tree
on disk, and in a second process the affine and crop host transforms in
a batch, OCRNet's projector on a LossWrapper with both dense-contrastive
terms, a semi-supervised train step and the offline data tools' mains
(build_frame_table, class_analysis, add_blacklist), and in a third the video path on
the port's own AVI, both video modes through the CLI and the serving
export, and in a fourth a train step over two gloo ranks and the export
over a mesh, run with them blocked), nor pandas, cv2, PIL, matplotlib or
tensorboard, which the card's machine lacks (blocked in the same run; a
source may import them only inside a `try` that catches ImportError), its
entry points refuse to run on a missing card unless asked for the CPU,
and its CPU path launches no kernel."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS, reset_launches
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    eval_spec, make_eval_loss_step, make_eval_step, make_train_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.reproduce_paper import (
    main as reproduce_paper_main)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.sharded_twins import (
    main as sharded_twins_main)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.trajectory_twins import (
    main as trajectory_twins_main)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import train_steps
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import (
    load_config, validate)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "miccai2021_cataract_semantic_segmentation_tpu_torch"
CONFIG = load_config(ROOT / "configs" / "OCRNet_rf_lvsz.json")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "miccai2021_cataract_semantic_segmentation_tpu")
# absent on the card's machine; optional in the port (TBLogger, the figure)
CARD_ABSENT = ("pandas", "cv2", "PIL", "matplotlib", "tensorboard")

_SUBPROCESS = """
import importlib, json, pkgutil, sys
BLOCKED, ABSENT = %r, %r
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED + ABSENT:
        del sys.modules[name]
for name in ABSENT:             # as if not installed: import fails, find_spec is None
    sys.modules[name] = None

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)        # the suite runs in several processes at once
import miccai2021_cataract_semantic_segmentation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    eval_spec, make_eval_loss_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
cfg = load_config("configs/OCRNet_rf_lvsz.json")
model = build_model(cfg["graph"], 2, device="cpu")
step = make_eval_loss_step(build_loss(cfg["loss"], 2, "cpu"),
                           eval_spec(cfg["data"]["transforms"]), "cpu", "fp32")
rng = np.random.default_rng(0)
images = rng.integers(0, 256, (2, 30, 40, 3), dtype=np.uint8)
labels = rng.integers(0, 18, (2, 30, 40), dtype=np.uint8)
_, _, cm, loss = step(model, images[:1], labels[:1], 0)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import train_steps
res = train_steps(model, dict(cfg, precision="fp32"), images, labels,
                  [np.array([0, 1])], device="cpu")
hr_cfg = dict(load_config("configs/DeepLabv3_rf_lvsz.json"), precision="fp32",
              graph={"model": "HRNetv2", "width": 4},
              loss={"name": "LovaszSoftmax", "lovasz_impl": "bucket"})
hr = build_model(hr_cfg["graph"], 2, device="cpu")
hr_res = train_steps(hr, hr_cfg, images, labels, [np.array([0, 1])], device="cpu")
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate
hr_val = validate(hr, hr_cfg, images, labels, device="cpu", batch_size=2)
import torch
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import fused_lovasz
dl = build_model({"model": "DeepLabv3", "backbone": "resnet50", "out_stride": 8},
                 2, device="cpu")
dl_loss = build_loss({"name": "LovaszSoftmax", "lovasz_impl": "bucket"}, 2, "cpu")
with torch.no_grad():
    dl_out = dl(torch.rand(1, 3, 30, 40), full_res=dl_loss.full_res)
dl_labels = torch.as_tensor(labels[:1])
dl_v4 = float(dl_loss(dl_out, dl_labels)[0])
fused_lovasz._USE_V3 = True
dl_v3 = float(dl_loss(dl_out, dl_labels)[0])
fused_lovasz._USE_V3 = False
upn_cfg = dict(load_config("configs/UPN_rf_lvsz.json"), precision="fp32",
               loss={"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"})
upn = build_model(upn_cfg["graph"], 2, device="cpu")
# frames whose padded height and width UPerNet's stride 32 divides, as 540x960's
upn_images = rng.integers(0, 256, (2, 60, 64, 3), dtype=np.uint8)
upn_labels = rng.integers(0, 18, (2, 60, 64), dtype=np.uint8)
upn_val = validate(upn, upn_cfg, upn_images, upn_labels, device="cpu", batch_size=2)
import pathlib, tempfile
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint
tmp_dir = tempfile.TemporaryDirectory()
tmp = pathlib.Path(tmp_dir.name)
write_tree(tmp / "data", upn_images, canonical_from_network(upn_labels, 2), [2, 12])
cli_cfg = dict(json.load(open("configs/OCRNet_pretrained_t2.json")),
               graph=hr_cfg["graph"], log_path=str(tmp / "logs"), run_id="cli",
               load_checkpoint="published", valid_batch_size=2)
save_checkpoint(tmp / "logs" / "published" / "chkpts", "best", hr, 0, 0.0, 0.0)
(tmp / "cli.json").write_text(json.dumps(cli_cfg))
cli = main(["-c", str(tmp / "cli.json"), "-dp", str(tmp / "data")], device="cpu")
cli_info = json.loads((tmp / "logs" / "cli" / "info.json").read_text())["metrics"]
cli_jsonl = (tmp / "logs" / "cli" / "valid" / "scalars.jsonl").is_file()
train_images = np.concatenate([upn_images, upn_images])
write_tree(tmp / "train_data", train_images,
           canonical_from_network(np.concatenate([upn_labels, upn_labels]), 2),
           [1, 3, 5, 7])
train_cfg = dict(hr_cfg, mode="training", log_path=str(tmp / "logs"), run_id="train",
                 valid_batch_size=2, profile_epoch=0,
                 data=dict(hr_cfg["data"], batch_size=2),
                 train=dict(hr_cfg["train"], epochs=1))
(tmp / "train.json").write_text(json.dumps(train_cfg))
trained = main(["-c", str(tmp / "train.json"), "-dp", str(tmp / "train_data")],
               device="cpu")
run = tmp / "logs" / "train"
train_files = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
train_steps_taken = int(np.load(run / "ind_dist.npz")["ind_counts"].sum()) // 2
tmp_dir.cleanup()
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
cli_expected = int((pad_reflect_hw(torch.as_tensor(upn_labels)) < 17).sum())
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import proto_fused_upsample
proto = proto_fused_upsample.main("cpu", n=1, n_time=0, h=5, ws=6, c=2,
                                  out_hw=(40, 48), h_pad=8, ws_pad=8, w_pad=128)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ABSENT
                and sys.modules[m] is not None)
print(json.dumps({"modules": names, "loss": float(loss), "cm": int(cm.sum()),
                  "train_loss": res["loss"], "hr_train_loss": hr_res["loss"],
                  "hr_valid_loss": hr_val["valid_loss"],
                  "dl_outputs": sorted(dl_out), "dl_v4": dl_v4, "dl_v3": dl_v3,
                  "upn_valid_loss": upn_val["valid_loss"],
                  "cli_miou": [cli["miou"], cli_info["miou"]],
                  "cli_pixels": int(np.asarray(cli_info["confusion_matrix"]).sum()),
                  "cli_expected": cli_expected,
                  "cli_decoded": cli["decoded"], "jsonl": cli_jsonl,
                  "trained_miou": trained["miou"], "train_files": train_files,
                  "train_steps": train_steps_taken,
                  "proto_errors": [proto["fwd_max_abs_err"], proto["bwd_rel"]],
                  "launches": {k: v.launches for k, v in KERNELS.items()},
                  "leaked": leaked}))
"""


def test_port_imports_and_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS % (BLOCKED, CARD_ABSENT)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) >= 20
    assert np.isfinite(res["loss"]) and res["cm"] > 0
    assert np.isfinite(res["train_loss"])
    assert np.isfinite(res["hr_train_loss"]) and np.isfinite(res["hr_valid_loss"])
    assert res["dl_outputs"] == ["deep_features", "logits_s8"]
    assert np.isfinite(res["dl_v4"]) and abs(res["dl_v3"] - res["dl_v4"]) <= 1e-5
    assert np.isfinite(res["upn_valid_loss"]) and res["upn_valid_loss"] > 0
    assert res["proto_errors"][0] < 1e-4 and res["proto_errors"][1] < 1e-5
    assert np.isfinite(res["cli_miou"][0]) and res["cli_miou"][0] == res["cli_miou"][1]
    assert res["cli_pixels"] == res["cli_expected"] > 0
    assert sum(res["cli_decoded"].values()) == 1 and res["jsonl"]
    assert np.isfinite(res["trained_miou"]) and res["train_steps"] >= 1
    for name in ("chkpts/chkpt_last.pt", "ind_dist.npz", "info.json",
                 "profile/trace.json", "train/scalars.jsonl", "valid/scalars.jsonl"):
        assert name in res["train_files"], name
    assert res["launches"] == dict.fromkeys(KERNELS, 0)
    assert res["leaked"] == []


# the blocking prelude of _SUBPROCESS, then the paths of the training
# vocabulary: host transforms, the dense-contrastive LossWrapper, a semi step
_TRAINING_VOCABULARY = _SUBPROCESS[:_SUBPROCESS.index("import miccai2021")] + """
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import ArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import assemble_batch
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    build_transform_pipeline, device_spec)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
rng = np.random.default_rng(0)
images = rng.integers(0, 256, (2, 60, 64, 3), dtype=np.uint8)
labels = rng.integers(0, 18, (2, 60, 64), dtype=np.uint8)
host = build_transform_pipeline(["affine", "crop", "flip"], {"crop_size": 0.6}, 2)
host_batch = assemble_batch(ArrayDataset(images, labels), [0, 1], host,
                            np.random.default_rng(0))
cfg = load_config("configs/OCRNet_rf_lvsz.json")
dc_loss = build_loss({"losses": {"TwoScaleLoss": 1, "DenseContrastiveLoss": 0.1,
                                 "DenseContrastiveLossV2": 0.1},
                      "TwoScaleLoss": cfg["loss"], "dc_off_at_epoch": 1}, 2, "cpu")
proj = build_model(dict(cfg["graph"], projector={"d": 8, "mlp": [[1, 16, 1]], "use_bn": True}),
                   2, device="cpu")
with torch.no_grad():
    dc_out = proj(torch.rand(2, 3, 32, 32))
dc_terms = {k: float(v) for k, v in dc_loss(
    dc_out, torch.as_tensor(labels[:, :32, :32]), epoch=0)[1].items()}
hr_train = {"learning_rate": 1e-4, "epochs": 1}
hr = build_model({"model": "HRNetv2", "width": 4}, 2, device="cpu")
semi_loss = build_loss({"name": "SemiSupervisedLoss",
                        "labeled": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"}}, 2, "cpu")
semi_step = make_train_step(semi_loss, device_spec(["pad"]), 2, device="cpu", precision="fp32",
                            semi={"threshold": 0.1, "ignore_id": 17})
semi_m = semi_step(create_train_state(hr, hr_train, make_schedule(hr_train, 1)),
                   images[:, :30, :40], labels[:, :30, :40], 0)
import contextlib, io, pathlib, tempfile
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import (
    add_blacklist, build_frame_table, class_analysis)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
tools_dir = tempfile.TemporaryDirectory()
tree = pathlib.Path(tools_dir.name)
write_tree(tree / "data", images, canonical_from_network(labels, 2), [2, 12])
table = str(tree / "table.csv")
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    build_frame_table.main(["-p", str(tree / "data"), "-o", table])
    class_analysis.main(["--csv", table])
    class_analysis.main(["--csv", table, "--check-labels", str(tree / "data"), "--task", "2"])
    add_blacklist.main(["--label-table", table, "--csv", table, "-o", str(tree / "lt.csv")])
tools_out = printed.getvalue().splitlines()
tools_dir.cleanup()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ABSENT
                and sys.modules[m] is not None)
print(json.dumps({"host_shape": list(host_batch[0].shape), "dc_terms": dc_terms,
                  "semi": [float(semi_m[k]) for k in ("labeled", "unlabeled")],
                  "tools": tools_out,
                  "launches": {k: v.launches for k, v in KERNELS.items()},
                  "leaked": leaked}))
"""


def test_training_vocabulary_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _TRAINING_VOCABULARY % (BLOCKED, CARD_ABSENT)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["host_shape"] == [2, 32, 32, 3]
    assert all(np.isfinite(v) for v in res["dc_terms"].values())
    assert res["dc_terms"]["DenseContrastiveLoss"] > 0
    assert all(np.isfinite(v) for v in res["semi"])
    tools = res["tools"]
    assert tools[0].startswith("2 frames x 2 videos -> ")
    assert "--- task 3 class distribution ---" in tools
    assert "test_frames: 2" in tools and "wrote 2 overlay images" in tools
    assert tools[-1].startswith("2 rows -> ")
    assert res["launches"] == dict.fromkeys(KERNELS, 0)
    assert res["leaked"] == []


# the blocking prelude, then the video path (the port's own AVI written
# and read, a video pool, both video modes through the CLI) and the
# serving export, which must work without cv2
_VIDEO_AND_EXPORT = _SUBPROCESS[:_SUBPROCESS.index("import miccai2021")] + """
import pathlib, tempfile
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import video_io
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import load_frame_table
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import VideoDataset
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.semi import unlabeled_from_videos
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import EvalSpec
tmp_dir = tempfile.TemporaryDirectory()
tmp = pathlib.Path(tmp_dir.name)
rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (5, 60, 64, 3), dtype=np.uint8)
(tmp / "cadis" / "workflow" / "test").mkdir(parents=True)
(tmp / "pool" / "train_1").mkdir(parents=True)
for path in (tmp / "cadis" / "workflow" / "test" / "dev01.mp4",
             tmp / "pool" / "train_1" / "train01.mp4"):
    w = video_io.open_writer(path, 25, (64, 60))
    for f in frames:
        w.write(f)
    w.release()
ds = VideoDataset([str(tmp / "pool" / "train_1" / "train01.mp4")], 60, 64)
round_trip = all(np.array_equal(ds[i][0], frames[i]) for i in range(5))
table = load_frame_table()
pool = unlabeled_from_videos(tmp / "pool", table.take(np.flatnonzero(
    np.asarray(table["vid_num"]) == 1)), 60, 64)
graph = {"model": "FCN", "width": 0.125}
model = build_model(graph, 2, device="cpu")
labels = rng.integers(0, 18, (3, 60, 64)).astype(np.uint8)
write_tree(tmp / "cadis" / "data", frames[:3], canonical_from_network(labels, 2), [2, 12, 22])
save_checkpoint(tmp / "logs" / "pub" / "chkpts", "best", model, 0, 0.0, 0.0)
outs = {}
for mode in ("video_inference", "demo_video_inference"):
    cfg = dict(json.load(open("configs/OCRNet_pretrained_t2.json")), graph=graph,
               precision="f32", mode=mode, run_id=mode, log_path=str(tmp / "logs"),
               load_checkpoint="pub", video_ids=["dev01"], video_height=60, video_width=64)
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    res = main(["-c", str(tmp / "cfg.json"), "-dp", str(tmp / "cadis" / "data")],
               device="cpu")
    r = video_io.open_reader(res["outputs"][0])
    outs[mode] = [res["frames"], res["codec"], r.frame_count, list(r.shape)]
serve = export.make_serving_fn(model, EvalSpec(pad=True))
path = export.save_serving(export.export_fn(serve, (60, 64)), tmp / "serving")
with torch.no_grad():
    got = export.load_serving(path)(torch.as_tensor(frames[:2]))
    want = serve(torch.as_tensor(frames[:2]))
tmp_dir.cleanup()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ABSENT
                and sys.modules[m] is not None)
print(json.dumps({"round_trip": round_trip, "pool": len(pool), "outs": outs,
                  "writers": video_io.WRITERS, "readers": video_io.READERS,
                  "served": bool(torch.equal(got["pred"], want["pred"])
                                 and torch.equal(got["confidence"], want["confidence"])),
                  "launches": {k: v.launches for k, v in KERNELS.items()},
                  "leaked": leaked}))
"""


def test_video_and_export_run_with_jax_and_cv2_blocked():
    out = subprocess.run([sys.executable, "-c", _VIDEO_AND_EXPORT % (BLOCKED, CARD_ABSENT)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["round_trip"] and res["pool"] == 5          # video 1 labels frames 90+
    assert res["outs"] == {"video_inference": [5, ["avi_raw"], 5, [60, 64]],
                           "demo_video_inference": [5, ["avi_raw"], 5, [60, 128]]}
    assert res["writers"] == {"xvid": 0, "avi_raw": 4} and res["readers"]["cv2"] == 0
    assert res["served"]
    assert res["launches"] == dict.fromkeys(KERNELS, 0)
    assert res["leaked"] == []


# the blocking prelude as a sitecustomize module, so that the ranks the
# launcher starts (processes of their own) block what this one blocks
_SITECUSTOMIZE = _SUBPROCESS[:_SUBPROCESS.index("import numpy")]
_PARALLEL = """
import json, sys
from sitecustomize import ABSENT, BLOCKED
try:
    import jax
    blocked = False
except ImportError:
    blocked = True
import numpy as np
import torch
torch.set_num_threads(1)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import spatial
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import sharded_twins
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import EvalSpec
# the (1, 2) grid's arm and, beside it, one data rank's
twins = sharded_twins.compare_sharded(backbone="resnet18", h=64, w=32, bs=2, n_pool=2,
                                      n_steps=1, device="cpu", grid=(1, 2))
serve = export.make_serving_fn(build_model({"model": "FCN", "width": 0.125}, 2,
                                           device="cpu"), EvalSpec(pad=True))
x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 30, 40, 3),
                                                        dtype=np.uint8))
mesh = export.MeshServing(export.export_fn(serve, (30, 40), batch=4,
                                           mesh=["cpu", "cpu"]), ["cpu", "cpu"])
with torch.no_grad():
    got, want = mesh(x), serve(x)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ABSENT
                and sys.modules[m] is not None)
print(json.dumps({"blocked": blocked, "twins": [twins["ranks"], twins["ranks_agree"],
                            twins["losses_sharded"], twins["n_loss_shards"],
                            twins["max_abs_grid_vs_data_ranks"], spatial.Grid.__name__],
                  "served": bool(torch.equal(got["pred"], want["pred"])),
                  "launches": {k: v.launches for k, v in KERNELS.items()},
                  "leaked": leaked}))
"""


def test_parallel_step_and_mesh_export_run_with_jax_blocked(tmp_path):
    """A train step over a (1, 2) grid of two ranks, one data rank's beside
    it (the sharded twins' arms with `--grid 1,2`; each rank a process of
    its own, which loads the same blocking prelude as its sitecustomize)
    and the serving export over a mesh of two CPU devices."""
    (tmp_path / "sitecustomize.py").write_text(_SITECUSTOMIZE % (BLOCKED, CARD_ABSENT))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["blocked"]
    ranks, agree, losses, data_ranks, grid_gap, grid_cls = res["twins"]
    assert ranks == 2 and data_ranks == 1 and grid_cls == "Grid"
    assert agree and len(losses) == 1 and np.isfinite(losses[0]) and grid_gap < 1e-5
    assert res["served"]
    assert res["launches"] == dict.fromkeys(KERNELS, 0)
    assert res["leaked"] == []


def _port_sources():
    return sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) \
        + ["chip_smoke.py"]


def _catches_import_error(handler) -> bool:
    names = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    return any(isinstance(n, ast.Name) and n.id in ("ImportError", "ModuleNotFoundError")
               for n in names)


@pytest.mark.parametrize("path", _port_sources())
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    guarded = {id(sub) for node in ast.walk(tree) if isinstance(node, ast.Try)
               and any(_catches_import_error(h) for h in node.handlers)
               for stmt in node.body for sub in ast.walk(stmt)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(BLOCKED), f"{path}:{node.lineno}"
        if set(roots) & set(CARD_ABSENT):
            assert id(node) in guarded, f"{path}:{node.lineno} outside try/except ImportError"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")


@pytest.mark.parametrize("entry", ["build_model", "build_loss",
                                   "make_eval_step", "make_eval_loss_step",
                                   "validate", "make_train_step", "train_steps",
                                   "Trainer", "main", "sharded_twins",
                                   "sharded_twins_grid", "trajectory_twins",
                                   "reproduce_paper"])
def test_default_device_raises_without_cuda(entry):
    _no_card()
    spec = eval_spec(CONFIG["data"]["transforms"])
    rng = np.random.default_rng(0)
    calls = {
        "make_train_step": lambda: make_train_step(
            build_loss(CONFIG["loss"], 2, "cpu"),
            device_spec(CONFIG["data"]["transforms"]), 2),
        "train_steps": lambda: train_steps(
            build_model(CONFIG["graph"], 2, device="cpu"), CONFIG,
            rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
            rng.integers(0, 18, (2, 8, 8), dtype=np.uint8), [np.array([0, 1])]),
        "build_model": lambda: build_model(CONFIG["graph"], 2),
        "build_loss": lambda: build_loss(CONFIG["loss"], 2),
        "make_eval_step": lambda: make_eval_step(spec, 17),
        "make_eval_loss_step": lambda: make_eval_loss_step(
            build_loss(CONFIG["loss"], 2, "cpu"), spec),
        "validate": lambda: validate(
            build_model(CONFIG["graph"], 2, device="cpu"), CONFIG,
            np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 8, 8), np.uint8)),
        "Trainer": lambda: Trainer(CONFIG),
        "main": lambda: main(["-c", str(ROOT / "configs" / "OCRNet_pretrained_t2.json")]),
        "sharded_twins": lambda: sharded_twins_main(["--tiny", "--steps", "1"]),
        "sharded_twins_grid": lambda: sharded_twins_main(["--tiny", "--steps", "1",
                                                          "--grid", "2,2"]),
        "trajectory_twins": lambda: trajectory_twins_main(["--cpu-scale", "--steps", "1"]),
        "reproduce_paper": lambda: reproduce_paper_main([
            "--data-root", str(ROOT / "data"), "--ckpt", "2=unread.pt"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_cpu_path_launches_no_kernel():
    reset_launches()
    model = build_model(CONFIG["graph"], 2, device="cpu")
    rng = np.random.default_rng(1)
    res = validate(model, CONFIG, rng.integers(0, 256, (3, 30, 40, 3), dtype=np.uint8),
                   rng.integers(0, 18, (3, 30, 40), dtype=np.uint8),
                   device="cpu", batch_size=2)
    assert np.isfinite(res["valid_loss"])
    assert {k: v.launches for k, v in KERNELS.items()} == dict.fromkeys(KERNELS, 0)


def test_chip_smoke_fails_without_a_card(tmp_path):
    _no_card()
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
