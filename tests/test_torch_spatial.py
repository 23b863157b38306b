"""The spatial 'model' rank axis (parallel/spatial.py, ROADMAP item 18)
against one process and against the JAX package's ("data", "model") mesh.

The port's side runs on four gloo ranks (parallel/launch.py:Ranks, one
intra-op thread each; tests/torch_spatial_jobs.py), started by one module
fixture before the JAX side compiles in this process. The grids over them:
(2, 2) and (1, 4) over all four, (1, 2) over ranks 0-1 and over ranks 2-3,
(1, 1) over each rank alone, (2, 1) over ranks 1 and 3.

- Units at M = 4 and M = 2, float64, within 1e-12 of the same op in one
  process, forward and backward (input gradients; weight gradients summed
  over the ranks): the band convolution at kernel 1, 3 and 7, stride 1 and
  2, dilation 1, 2 and 4; the band max-pool; `spatial_gather`; BatchNorm
  over the grid on a sharded tensor and on one replicated over the model
  ranks through `model_sum`; `gather_rows`; the upsample's band rows.
- The (2, 2) grid's step against JAX `make_train_step(mesh=<2x2
  ("data", "model")>)` with images and labels under P("data", "model"):
  OCRNet-R18, the flagship's two-scale bucket Lovász (B1/B2's plain
  versions here, the Pallas kernels in interpret mode there), pad and flip
  with JAX's draws, a global batch of 4 frames of 60x96 (64 rows once
  padded: 32 a model rank, which R18's stride 32 divides), Adam, float64
  weights from the flax init: loss and term, confusion matrix and
  BatchNorm statistics within 1e-6 on all four ranks; grad_norm, the
  gradients and the parameters after Adam against the port's (2, 1) path,
  since JAX's step on this layout moves its gradients (ROADMAP Queue C).
- The (1, 2) grid's step against the one-process step on the same batch,
  weights and draws: loss and gradients within 1e-9, parameters within
  1e-6; hooks see (B, C, H/8/2, W/8) at layer4 and at the stride-8 logits.
  OCRNet-R50 at output stride 8 (64x64, batch 1) the same, which runs the
  dilation-4 halo. A (1, 1) grid is bit-equal to the plain step.
- The (2, 2) eval step: the confusion matrix equal to one process's, each
  rank's logits rows within 1e-12; the eval-loss step's loss the mean of
  one process's over the two data shards.
- Checkpoints over the (2, 2) grid: rank 0 alone writes; a restore on every
  rank is bit-equal.
- The twins' tiny path with --grid 2,2 within the JAX twins test's bars,
  its losses within 1e-5 of the two data ranks'.
- Refusals: a frame the model ranks cannot split or a stride that leaves a
  rank no rows raises ValueError naming the layer; a projector, UPerNet,
  FCN, PointRend and UNet raise NotImplementedError (the other graphs:
  tests/test_torch_spatial_graphs.py).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import spatial_gather
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import DataGroup, Grid
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.spatial import (
    check_graph, spatial_rows)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_ocrnet
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, make_eval_loss_step, make_eval_step, make_train_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
from test_torch_eval import numpy_variables
from test_torch_train import jax_draws, x64
import torch_spatial_jobs as jobs

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
FLAGSHIP = load_config(ROOT / "configs" / "OCRNet_rf_lvsz.json")
R18 = {"model": "OCRNet", "backbone": "resnet18"}
R50 = {"model": "OCRNet", "backbone": "resnet50", "out_stride": 8}
TRANSFORMS = ["pad", "flip"]
CFG = {"loss": FLAGSHIP["loss"], "transforms": TRANSFORMS, "train": FLAGSHIP["train"],
       "precision": "fp32", "steps_per_epoch": 100}
TOL = 1e-6           # against JAX, as tests/test_torch_parallel.py
UNIT_TOL = 1e-12
STEP_TOL = 1e-9      # the (1, 2) grid against one process: loss and gradients


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocky(n, h, w, seed):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 18, (n, h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w].astype(np.uint8)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8), labels


def _units_payload():
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))       # noqa: E731
    convs = [jobs.conv_module(k, s, d).double() for k, s, d in jobs.CONV_CASES]
    for c in convs:
        with torch.no_grad():
            for q in c.parameters():
                q.copy_(t(*q.shape))
    bn = BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
        bn.bias.copy_(t(5))
        bn.running_mean.copy_(t(5))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
    return {"x": t(2, 3, 16, 7), "cot": {1: t(2, 4, 16, 7), 2: t(2, 4, 8, 4)},
            "conv_states": [c.state_dict() for c in convs],
            "x_pool": t(2, 3, 16, 7), "cot_pool": t(2, 3, 8, 4),
            "feats": t(2, 6, 16, 7), "probs": 3 * t(2, 5, 16, 7), "ctx_cot": t(4, 2, 5, 6),
            "bn_x": 3 * t(2, 5, 16, 7) + 2, "bn_cot": t(2, 5, 16, 7),
            "bn_state": {k: v.clone() for k, v in bn.state_dict().items()},
            "rep_x": 3 * t(2, 5, 4, 1) + 1, "rep_cot": t(4, 2, 5, 4, 1),
            "s8": t(2, 5, 8, 12), "s8_cot": t(2, 5, 8, 12), "up_hw": (64, 96)}


def jax_grid_step(images, labels, variables):
    """One float64 JAX train step over a (2, 2) ("data", "model") mesh of
    CPU devices, images and labels under P("data", "model") as the JAX dry
    run lays them out; the caller enables x64."""
    model = jax_build_model(R18, 2, dtype=jnp.float64)
    spec = build_transform_pipeline(TRANSFORMS, {}, 2).device
    train = FLAGSHIP["train"]
    tx = jax_make_optimizer(train, jlr.make_schedule(train, CFG["steps_per_epoch"]))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          apply_fn=model.apply, tx=tx)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    step = jax_make_train_step(jax_build_loss(FLAGSHIP["loss"], 2), spec, 2,
                               donate=False, train_metrics="s8", mesh=mesh,
                               sharded_loss_check_vma=False)
    sharded = NamedSharding(mesh, P("data", "model"))
    new_state, metrics = step(jax.device_put(state, NamedSharding(mesh, P())),
                              jax.device_put(jnp.asarray(images), sharded),
                              jax.device_put(jnp.asarray(labels), sharded),
                              jax.random.PRNGKey(0), 0)
    return {"metrics": jax.tree.map(np.asarray, metrics),
            "params": jax.tree.map(np.asarray, new_state.params),
            "stats": jax.tree.map(np.asarray, new_state.batch_stats)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, JAX's (2, 2) mesh step, and the payload."""
    tmp = tmp_path_factory.mktemp("spatial")
    # the twins' tiny path through the tool's CLI, a process of its own
    twins = subprocess.Popen(
        [sys.executable, "-m",
         "miccai2021_cataract_semantic_segmentation_tpu_torch.tools.sharded_twins",
         "--tiny", "--steps", "3", "--grid", "2,2", "--device", "cpu",
         "--out", str(tmp / "twins.json")],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    images, labels = blocky(4, 60, 96, 8)
    variables = numpy_variables(jax_build_model(R18, 2, dtype=jnp.float64), seed=2)
    with x64():
        # the JAX step's flips of the global batch: its augmentation key is
        # the first of split(fold_in(PRNGKey(0), step 0), 3)
        spec = build_transform_pipeline(TRANSFORMS, {}, 2).device
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), 3)[0]
        draws = jax_draws(key, 4, spec)
    assert 0 < int(draws.flip.sum()) < 4
    payload = {"cfg": CFG, "graph": R18, "units": _units_payload(),
               "flagship": {"state_dict": bridge_ocrnet(variables["params"],
                                                        variables["batch_stats"]),
                            "batch": (images, labels), "draws": draws},
               "r50": {"graph": R50, "seed": 4, "batch": blocky(1, 64, 64, 5)},
               "ckpt_dir": str(tmp / "chkpts")}
    path = tmp / "payload.pt"
    torch.save(payload, path)
    started = Ranks("torch_spatial_jobs:spatial_job", 4, path, paths=[TESTS])
    try:
        with x64():
            want = jax_grid_step(images, labels, variables)
    finally:
        got = started.results(timeout=300)
        out = twins.communicate(timeout=300)[0]
    assert twins.returncode == 0, out[-4000:]
    return {"got": got, "want": want, "payload": payload,
            "twins": json.loads((tmp / "twins.json").read_text())}


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _close(a, b, tol=UNIT_TOL, what=""):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert float((a - b).abs().max()) <= tol, (what, float((a - b).abs().max()))


def _bands(results, key, m_size, field):
    """The ranks' `field` of unit `key`, concatenated on the rows."""
    return torch.cat([r[key][field] for r in results[:m_size]], dim=2)


def _unit_results(ranks, m_size):
    got = ranks["got"]
    return [r["units4"] for r in got] if m_size == 4 else [r["units2"] for r in got[:2]]


def _one_process(module, x, cot):
    x = x.clone().requires_grad_(True)
    y = module(x)
    (y * cot).sum().backward()
    return y.detach(), x.grad, {n: q.grad for n, q in module.named_parameters()}


@pytest.mark.parametrize("m_size", [2, 4])
@pytest.mark.parametrize("case", jobs.CONV_CASES, ids=lambda c: "k{}s{}d{}".format(*c))
def test_band_conv_equals_one_process(ranks, m_size, case):
    p = ranks["payload"]["units"]
    k, s, d = case
    conv = jobs.conv_module(k, s, d).double()
    conv.load_state_dict(p["conv_states"][jobs.CONV_CASES.index(case)])
    y, dx, dw = _one_process(conv, p["x"], p["cot"][s])
    res = _unit_results(ranks, m_size)
    key = f"conv{k}-{s}-{d}"
    _close(_bands(res, key, m_size, "y"), y, what="y")
    _close(_bands(res, key, m_size, "dx"), dx, what="dx")
    for name, g in dw.items():
        _close(sum(r[key]["dw"][name] for r in res), g, what=name)


@pytest.mark.parametrize("m_size", [2, 4])
def test_band_maxpool_equals_one_process(ranks, m_size):
    p = ranks["payload"]["units"]
    y, dx, _ = _one_process(torch.nn.MaxPool2d(3, 2, 1), p["x_pool"], p["cot_pool"])
    res = _unit_results(ranks, m_size)
    _close(_bands(res, "maxpool", m_size, "y"), y)
    _close(_bands(res, "maxpool", m_size, "dx"), dx)


@pytest.mark.parametrize("m_size", [2, 4])
def test_spatial_gather_over_model_ranks_equals_one_process(ranks, m_size):
    p = ranks["payload"]["units"]
    f = p["feats"].clone().requires_grad_(True)
    lg = p["probs"].clone().requires_grad_(True)
    ctx = spatial_gather(f, lg)
    (ctx * p["ctx_cot"][:m_size].sum(0)).sum().backward()
    res = _unit_results(ranks, m_size)
    for r in res:
        _close(r["gather"]["ctx"], ctx.detach())
    _close(torch.cat([r["gather"]["df"] for r in res], 2), f.grad)
    _close(torch.cat([r["gather"]["dl"] for r in res], 2), lg.grad)


def _bn(p):
    bn = BatchNorm2d(5).double()
    bn.load_state_dict(p["bn_state"])
    return bn.train()


@pytest.mark.parametrize("m_size", [2, 4])
def test_batch_norm_over_the_grid_equals_one_process(ranks, m_size):
    """On a tensor whose rows the model ranks split, and on one they hold
    alike (the OCR context's), reached through `model_sum`: the statistics
    are the one tensor's and each rank's gradient is the whole one."""
    p = ranks["payload"]["units"]
    res = _unit_results(ranks, m_size)
    bn = _bn(p)
    x = p["bn_x"].clone().requires_grad_(True)
    y = bn(x)
    (y * p["bn_cot"]).sum().backward()
    _close(_bands(res, "bn", m_size, "y"), y.detach())
    _close(_bands(res, "bn", m_size, "dx"), x.grad)
    _close(sum(r["bn"]["dw"] for r in res), bn.weight.grad)
    _close(sum(r["bn"]["db"] for r in res), bn.bias.grad)
    for r in res:
        for key, v in bn.state_dict().items():
            _close(r["bn"]["state"][key], v, what=key)
    rep = _bn(p)
    x = p["rep_x"].clone().requires_grad_(True)
    y = rep(x)
    (y * p["rep_cot"][:m_size].sum(0)).sum().backward()
    for r in res:
        _close(r["bn_replicated"]["y"], y.detach())
        _close(r["bn_replicated"]["dpart"], x.grad)
        for key, v in rep.state_dict().items():
            _close(r["bn_replicated"]["state"][key], v, what=key)
    _close(sum(r["bn_replicated"]["dw"] for r in res), rep.weight.grad)
    _close(sum(r["bn_replicated"]["db"] for r in res), rep.bias.grad)


@pytest.mark.parametrize("m_size", [2, 4])
def test_gather_rows_and_band_upsample(ranks, m_size):
    p = ranks["payload"]["units"]
    res = _unit_results(ranks, m_size)
    for r in res:
        assert torch.equal(r["gather_rows"]["whole"], p["s8"])
    # each rank's loss of the whole counts once: its rows of the cotangent
    assert torch.equal(torch.cat([r["gather_rows"]["ds8"] for r in res], 2), p["s8_cot"])
    full = resize_bilinear(p["s8"], p["up_hw"], align_corners=True)
    _close(torch.cat([r["band_logits"] for r in res], 2), full)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def test_grid_layout_is_the_jax_mesh_layout(ranks):
    # rank r: data index r // M, model index r % M (np.reshape(devices, (D, M)))
    assert [r["grid22"] for r in ranks["got"]] == [
        (0, (2, 2), 0, 0), (1, (2, 2), 1, 0), (2, (2, 2), 0, 1), (3, (2, 2), 1, 1)]


def _max_diff(a, b) -> float:
    return float((torch.as_tensor(np.asarray(a)) - torch.as_tensor(np.asarray(b))).abs().max())


def test_grid_2x2_flagship_loss_step_equals_jax_mesh_step(ranks):
    """The loss, its term, the matrix and the BatchNorm statistics against
    JAX's step; the gradients and the parameters after Adam against the
    port's (2, 1) grid, the data-parallel path, which
    tests/test_torch_parallel.py holds to JAX's 2-device mesh (see the
    next test for why)."""
    want = ranks["want"]
    data_ranks = ranks["got"][1]["step21"]
    for got in ranks["got"]:
        m = got["step22"]["metrics"]
        for key in ("loss", "TwoScaleLoss"):
            assert abs(float(m[key]) - float(want["metrics"][key])) <= TOL, key
        np.testing.assert_array_equal(m["confusion_matrix"].numpy(),
                                      want["metrics"]["confusion_matrix"])
        assert int(m["confusion_matrix"].sum()) > 0
        sd = got["step22"]["state_dict"]
        for key, v in bridge_ocrnet(want["params"], want["stats"]).items():
            if key.endswith(("running_mean", "running_var")):
                _close(sd[key], v, TOL, key)
        assert abs(float(m["grad_norm"]) - float(data_ranks["metrics"]["grad_norm"])) <= TOL
        for key, g in data_ranks["grads"].items():
            _close(got["step22"]["grads"][key], g, STEP_TOL, key)
        for key, v in data_ranks["state_dict"].items():
            _close(sd[key], v, TOL, key)
    first = ranks["got"][0]["step22"]["state_dict"]
    assert all(all(torch.equal(v, r["step22"]["state_dict"][k]) for k, v in first.items())
               for r in ranks["got"][1:])


def test_jax_model_axis_layout_moves_its_gradients(ranks):
    """JAX's step over the (2, 2) mesh with the frames under P("data",
    "model") gives the loss, matrix and BatchNorm statistics above, but
    gradients of another function: its fused loss's shard_map (in_specs
    P("data"), sharded_loss_check_vma=False, which the Pallas kernels need)
    transposes wrongly once the logits are split over "model". The same
    JAX step with the frames under P("data") over the same mesh gives the
    port's grad_norm (checked when this test was written), and so do the
    (2, 1) and (1, 2) meshes. This test fails once the JAX package's step
    is repaired; the test above then holds the gradients to it too."""
    jax_norm = float(ranks["want"]["metrics"]["grad_norm"])
    port_norm = float(ranks["got"][0]["step22"]["metrics"]["grad_norm"])
    assert abs(float(ranks["want"]["metrics"]["loss"])
               - float(ranks["got"][0]["step22"]["metrics"]["loss"])) <= TOL
    assert abs(jax_norm - port_norm) > 1.0, (jax_norm, port_norm)


def _held_to_one_process(got, single, shapes, b, c, h, w):
    assert abs(got["losses"][0] - single["losses"][0]) <= STEP_TOL
    for key, g in single["grads"].items():
        _close(got["grads"][key], g, STEP_TOL, key)
    for key, v in single["state_dict"].items():
        _close(got["state_dict"][key], v, TOL, key)
    assert got["shapes"] == {"layer4": (b, c, h, w), "logits_s8": (b, 17, h, w)}, shapes


def test_model_axis_alone_changes_nothing(ranks):
    """The (1, 2) grid's step is the one-process step (rank 0's, alone);
    each rank's layer4 and stride-8 logits hold half of the rows (64
    padded rows: 2 at stride 32, R18's)."""
    single = ranks["got"][0]["plain"]
    assert single["shapes"]["layer4"] == (4, 512, 2, 3)
    for got in ranks["got"][:2]:
        _held_to_one_process(got["step12"], single, single["shapes"], 4, 512, 1, 3)


def test_r50_os8_dilated_halos_change_nothing(ranks):
    """OCRNet-R50 at output stride 8 on the (1, 2) grid, 64x64, batch 1:
    layer4's 3x3s at dilation 4 read 4 halo rows of a band of 4."""
    single = ranks["got"][2]["r50_plain"]
    assert single["shapes"]["layer4"] == (1, 2048, 8, 8)
    for got in ranks["got"][2:]:
        _held_to_one_process(got["r50"], single, single["shapes"], 1, 2048, 4, 8)


def test_grid_1x1_is_the_plain_step(ranks):
    got, plain = ranks["got"][1]["step11"], ranks["got"][0]["plain"]
    assert got["losses"] == plain["losses"]
    for key in ("grads", "state_dict"):
        a, b = got[key], plain[key]
        assert all(torch.equal(v, b[k]) for k, v in a.items()), key


def test_grid_2x2_eval_step_equals_one_process(ranks):
    got = ranks["got"]
    model = build_model(R18, 2, device="cpu").double()
    model.load_state_dict(got[0]["step22"]["state_dict"])
    images, labels = ranks["payload"]["flagship"]["batch"]
    logits, lbl, cm = make_eval_step(EvalSpec(pad=True), 17, device="cpu",
                                     precision="fp64")(model, images, labels)
    for r in got:
        assert torch.equal(r["eval22"]["cm"], cm)
    assert int(cm.sum()) == int((lbl < 17).sum()) > 0
    for d in (0, 1):            # data index d: frames 2d, 2d + 1; model ranks' rows
        band = torch.cat([got[2 * d + m]["eval22"]["logits"] for m in (0, 1)], 2)
        _close(band, logits[2 * d:2 * d + 2])
        assert torch.equal(torch.cat([got[2 * d + m]["eval22"]["labels"] for m in (0, 1)], 1),
                           lbl[2 * d:2 * d + 2])


def test_grid_2x2_eval_loss_step_equals_one_process_shards(ranks):
    """The eval-loss step over the grid: the matrix and each rank's logits
    rows as the eval step's; the loss the mean of one process's eval-loss
    steps over the two data shards (each shard's loss of the gathered
    stride-8 logits: B1's plain version here)."""
    got = ranks["got"]
    model = build_model(R18, 2, device="cpu").double()
    model.load_state_dict(got[0]["step22"]["state_dict"])
    images, labels = ranks["payload"]["flagship"]["batch"]
    step = make_eval_loss_step(build_loss(FLAGSHIP["loss"], 2, "cpu"), EvalSpec(pad=True),
                               device="cpu", precision="fp64", num_classes=17)
    shards = [step(model, images[k:k + 2], labels[k:k + 2], 0) for k in (0, 2)]
    want = (float(shards[0][3]) + float(shards[1][3])) / 2
    for r in got:
        assert torch.equal(r["eval_loss22"]["cm"], r["eval22"]["cm"])
        assert torch.equal(r["eval_loss22"]["logits"], r["eval22"]["logits"])
        assert abs(r["eval_loss22"]["loss"] - want) <= TOL, (r["eval_loss22"]["loss"], want)
    assert torch.equal(got[0]["eval22"]["cm"], shards[0][2] + shards[1][2])


def test_grid_checkpoint_rank0_writes_and_restores_bit_equal(ranks):
    got = ranks["got"]
    assert [r["ckpt22"]["wrote"] for r in got] == [True, False, False, False]
    assert got[0]["ckpt_files"] == ["chkpt_last.pt"]
    for r in got:
        c = r["ckpt22"]
        assert c["model_equal"] and c["optimizer_equal"] and c["step"], c
        assert c["meta"]["epoch"] == 1 and c["meta"]["global_step"] == 1


# ---------------------------------------------------------------------------
# the twins, the refusals
# ---------------------------------------------------------------------------

def test_sharded_twins_grid_tiny_path(ranks):
    """`tools/sharded_twins.py --tiny --grid 2,2 --device cpu` (3 steps):
    the JAX twins test's bars (tests/test_sharded_twins.py) on a (2, 2)
    grid; the grid's losses are the two data ranks' to float32 rounding."""
    r = ranks["twins"]
    assert r["ranks_agree"] and r["n_loss_shards"] == 2 and r["grid"] == [2, 2]
    assert 0 < r["step0_abs_divergence"] < 0.05, r
    assert r["max_abs_loss_divergence"] < 0.1, r
    assert r["max_abs_grid_vs_data_ranks"] < 1e-5, r


def _fake_grid(shape=(1, 2)):
    """A grid whose collectives are never reached: the refusals raise first."""
    return Grid(0, shape, DataGroup(), DataGroup(), None)


def test_misaligned_and_small_bands_raise():
    """Bands may be odd and shorter than a halo (tests/test_torch_spatial_graphs.py);
    a frame the model ranks cannot split, a stride that leaves a rank no
    rows, or an input that is not the rank's band raise ValueError naming
    the layer."""
    model = build_model(R18, 2, device="cpu")
    grid = _fake_grid()
    with pytest.raises(ValueError, match="do not split over 2 model ranks"):
        grid.rows(63)
    for frame, rows, what in (
            ((2, 32), 1, r"backbone.conv1: the 7x7 window at stride 2.*\[\(0, 1\), \(1, 1\)\]"),
            ((64, 32), 20, "backbone.conv1: 20 rows at stride 1 are not model rank 0's band")):
        with pytest.raises(ValueError, match=what), spatial_rows(model, grid, frame), \
                torch.no_grad():
            model(torch.zeros(1, 3, rows, 32), full_res=())


def test_deeper_misalignment_names_its_layer(ranks):
    """32 rows on two ranks leave rank 1 no row at R18's stride 32."""
    for r in ranks["got"][:2]:
        assert r["errors"].startswith("backbone.layer4.0.downsample.0: the 1x1 window "
                                      "at stride 2"), r["errors"]


@pytest.mark.parametrize("graph", [
    {"model": "OCRNet", "backbone": "resnet18",
     "projector": {"d": 8, "mlp": [[1, 8, 1]], "use_bn": True}},
    {"model": "FCN", "width": 0.125},
    {"model": "EncDec", "encoder": {"model": "ResNet18"},
     "decoder": {"model": "UPerNet", "ppm_num_ch": 32, "fpn_num_ch": 32}},
    {"model": "PointRend", "encoder": {"model": "ResNet18"}},
    {"model": "UNet"}], ids=["projector", "fcn", "upernet", "pointrend", "unet"])
def test_other_graphs_raise_not_implemented(graph):
    model = build_model(graph, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 18"):
        check_graph(model)
    with pytest.raises(NotImplementedError, match="ROADMAP item 18"), \
            spatial_rows(model, _fake_grid(), (64, 64)):
        pass


def test_grid_step_refuses_full_resolution_losses_and_metrics():
    """A full-resolution loss and "full" train metrics run on the grid (the
    logits gathered and upsampled whole, the matrix from the band's rows);
    semi mode, a point head and the debugging dumps stay refused."""
    def loss(outputs, labels, **kw):
        return None

    loss.full_res = ("logits",)
    for metrics in ("s8", "full"):
        make_train_step(loss, None, 2, device="cpu", train_metrics=metrics,
                        group=_fake_grid())
        make_eval_loss_step(loss, None, device="cpu", group=_fake_grid())
    for kwargs in ({"semi": {"threshold": 0.9, "ignore_id": 255}},
                   {"has_point_head": True}, {"debug_pred": True}):
        with pytest.raises(NotImplementedError, match="semi mode, a point head or debug_pred"):
            make_train_step(loss, None, 2, device="cpu", group=_fake_grid(), **kwargs)
        # a grid of one model rank is the data-parallel path, which takes them
        make_train_step(loss, None, 2, device="cpu", group=_fake_grid((1, 1)), **kwargs)
