"""The spatial grid (parallel/spatial.py, ROADMAP item 18) on HRNetv2,
OCRNet on HRNet, DeepLabv3 and DeepLabv3+, against one process and against
the JAX package's ("data", "model") mesh.

The port's side runs on four gloo ranks (parallel/launch.py:Ranks, one
intra-op thread each; tests/torch_spatial_graphs_jobs.py), started by one
module fixture before the JAX side compiles in this process. The grids
over them: (2, 2) and (1, 4) over all four, (1, 2) over ranks 0-1 and over
ranks 2-3, (2, 1) over ranks 1 and 3.

- Units at M = 4 and M = 2, float64, within 1e-12 of the same op in one
  process, forward and backward (input gradients; weight gradients summed
  over the ranks): the band resize at align_corners False and True, up by
  2, 4 and 8 from stride 16 (2/1/2/1 rows a rank at M = 4) and DeepLabv3+'s
  stride 8 -> 4; a dilation-5 3x3 on 3-row bands (its halo spans two
  ranks); a strided 3x3, 1x1 and max-pool off odd bands; `global_avg_pool`
  over the model ranks. The bands' arithmetic at 544 rows (17 -> 9/8).
- The four graphs at width 4 (HRNetv2-W4, OCRNet on `hrnetv2_w4`) or on
  ResNet-18 at output stride 8 with 32 ASPP channels (DeepLabv3/v3+),
  float64 weights, a global batch of 4 frames of 92x64 (96 rows once
  padded: HRNet's stride-32 branch splits 2/1 over two ranks, DeepLab's
  6-row bands at stride 8 meet the ASPP's halos of 12, 24 and 36 rows),
  pad and flip, Adam. HRNetv2 and DeepLabv3/v3+ take the bucket
  `LovaszSoftmax` (HRNetv2 its full-resolution route, B3/B4f's plain
  versions; DeepLab the single-scale fused route, B1/B2's), OCRNet the
  flagship's two-scale loss.
  - The (1, 2) grid's step against the one-process step on the same
    batch, weights and draws: loss and gradients within 1e-9, parameters
    after Adam within 1e-6, BatchNorm statistics within 1e-12, the matrix
    equal.
  - The (2, 2) grid's step against the port's (2, 1) grid, the
    data-parallel path (tests/test_torch_parallel.py holds it to JAX's
    2-device mesh): the same bars.
  - The (2, 2) eval step: the matrix equal to one process's, each rank's
    rows of the logits within 1e-12; the eval-loss step's loss the mean of
    one process's over the two data shards, its matrix the eval step's.
- HRNetv2's and DeepLabv3's (2, 2) eval-loss step against JAX's eval-loss
  step over a 2x2 ("data", "model") mesh, frames under P("data",
  "model"), its loss per data shard as JAX's train step takes it
  (`_sharded_loss`; the Pallas kernels in interpret mode): loss within
  1e-6, the matrix equal. The gradients are held to the (2, 1) path
  above, since JAX's own step on this layout moves its gradients (ROADMAP
  Queue C).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from miccai2021_cataract_semantic_segmentation_tpu.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu.losses import build_loss as jax_build_loss
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import lr_schedule as jlr
from miccai2021_cataract_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    _sharded_loss, make_eval_loss_step as jax_make_eval_loss_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import global_avg_pool
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import DataGroup, Grid
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_deeplabv3, bridge_hrnet)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, make_eval_loss_step, make_eval_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import load_config
from test_torch_eval import numpy_variables
from test_torch_train import x64
import torch_spatial_graphs_jobs as jobs

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
FLAGSHIP = load_config(ROOT / "configs" / "OCRNet_rf_lvsz.json")
LOSS = {"name": "LovaszSoftmax", "lovasz_impl": "bucket"}
DEEPLAB = {"backbone": "resnet18", "out_stride": 8, "aspp": {"channels": 32}}
GRAPHS = {"hrnet": {"model": "HRNetv2", "width": 4},
          "ocr_hrnet": {"model": "OCRNet", "backbone": "hrnetv2_w4"},
          "deeplabv3": {"model": "DeepLabv3", **DEEPLAB},
          "deeplabv3plus": {"model": "DeepLabv3Plus", **DEEPLAB}}
LOSSES = {"hrnet": LOSS, "ocr_hrnet": FLAGSHIP["loss"], "deeplabv3": LOSS,
          "deeplabv3plus": LOSS}
# the graphs JAX's mesh step runs, the bridges of their numpy-filled weights
JAX_GRAPHS = {"hrnet": (bridge_hrnet, 3), "deeplabv3": (bridge_deeplabv3, 4)}
TRANSFORMS = ["pad", "flip"]
N, H, W = 4, 92, 64
TOL = 1e-6           # against JAX; parameters after Adam
UNIT_TOL = 1e-12     # units; BatchNorm statistics
STEP_TOL = 1e-9      # loss and gradients against one process


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
    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))       # noqa: E731
    convs = [jobs.conv_module(k, s, d).double() for k, s, d in jobs.CONV_CASES]
    for c in convs:
        with torch.no_grad():
            for q in c.parameters():
                q.copy_(t(*q.shape))
    h, w = jobs.RESIZE_FRAME
    return {"x": t(2, 3, *jobs.UNIT_FRAME), "cot": {1: t(2, 4, 12, 7), 2: t(2, 4, 6, 4)},
            "conv_states": [c.state_dict() for c in convs],
            "resize_x": {s: t(2, 3, h // s, w // s) for s in (8, 16)},
            "resize_cot": {(s, a): t(2, 3, h // s, w // s) for s in (8, 4, 2)
                           for a in (False, True)},
            "pool_x": t(2, 3, 6, 7), "pool_cot": t(4, 2, 3, 1, 1)}


def _state_dicts():
    """Float64 weights of the four graphs: HRNetv2's and DeepLabv3's from
    numpy-filled flax variables (JAX's mesh step takes the same), the
    others from the port's seeds; and those variables."""
    variables, sds = {}, {}
    for name, (bridge, seed) in JAX_GRAPHS.items():
        variables[name] = numpy_variables(
            jax_build_model(GRAPHS[name], 2, dtype=jnp.float64), seed=seed)
        sds[name] = bridge(variables[name]["params"], variables[name]["batch_stats"])
    for name, seed in (("ocr_hrnet", 5), ("deeplabv3plus", 6)):
        sds[name] = build_model(GRAPHS[name], 2, device="cpu", seed=seed).double().state_dict()
    return sds, variables


def jax_mesh_eval_loss(name, variables, images, labels):
    """JAX's float64 eval-loss step over a 2x2 ("data", "model") mesh of
    CPU devices, frames under P("data", "model"), the loss of each data
    shard averaged over 'data' (`_sharded_loss`, as its train step takes
    it); the caller enables x64."""
    model = jax_build_model(GRAPHS[name], 2, dtype=jnp.float64)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    sharded = _sharded_loss(jax_build_loss(LOSSES[name], 2), mesh, "data", check_vma=False)
    step = jax_make_eval_loss_step(lambda o, lbl, epoch: sharded(o, lbl, epoch, 0),
                                   build_transform_pipeline(TRANSFORMS, {}, 2).device)
    tx = jax_make_optimizer(FLAGSHIP["train"], jlr.make_schedule(FLAGSHIP["train"], 100))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), apply_fn=model.apply, tx=tx)
    frames = NamedSharding(mesh, P("data", "model"))
    _, _, cm, loss = step(jax.device_put(state, NamedSharding(mesh, P())),
                          jax.device_put(jnp.asarray(images), frames),
                          jax.device_put(jnp.asarray(labels), frames), 0)
    return {"cm": np.asarray(cm), "loss": float(loss)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, JAX's mesh eval-loss steps, the payload."""
    tmp = tmp_path_factory.mktemp("spatial_graphs")
    images, labels = blocky(N, H, W, 9)
    sds, variables = _state_dicts()
    payload = {"cfg": {"transforms": TRANSFORMS, "train": FLAGSHIP["train"]},
               "graphs": GRAPHS, "losses": LOSSES, "state_dicts": sds,
               "batch": (images, labels), "units": _units_payload()}
    path = tmp / "payload.pt"
    torch.save(payload, path)
    started = Ranks("torch_spatial_graphs_jobs:graphs_job", 4, path, paths=[TESTS])
    try:
        with x64():
            want = {name: jax_mesh_eval_loss(name, variables[name], images, labels)
                    for name in JAX_GRAPHS}
    finally:
        got = started.results(timeout=600)
    return {"got": got, "want": want, "payload": payload}


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _close(a, b, tol=UNIT_TOL, what=""):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert float((a - b).abs().max()) <= tol, (what, float((a - b).abs().max()))


def _unit_results(ranks, m_size):
    got = ranks["got"]
    return [r["units4"] for r in got] if m_size == 4 else [r["units2"] for r in got[:2]]


def _cat(res, key, field):
    return torch.cat([r[key][field] for r in res], dim=2)


def _one_process(module, x, cot):
    x = x.clone().requires_grad_(True)
    y = module(x)
    (y * cot).sum().backward()
    return y.detach(), x.grad


def test_bands_split_unevenly_at_coarse_strides():
    """Each stride's bands from the frame's: rank m keeps the rows o with
    s·o in its band, so HRNet's 17 stride-16 rows a rank at 544 rows on
    two ranks become 9 and 8 at stride 32, and 96 rows give 2 and 1."""
    def bands(m_size, frame, stride):
        return Grid(0, (1, m_size), DataGroup(), DataGroup()).framed(frame).bands(stride)

    assert bands(2, (544, 960), 16) == [(0, 17), (17, 34)]
    assert bands(2, (544, 960), 32) == [(0, 9), (9, 17)]
    assert bands(4, (544, 960), 8) == [(0, 17), (17, 34), (34, 51), (51, 68)]
    assert bands(4, (544, 960), 16) == [(0, 9), (9, 17), (17, 26), (26, 34)]
    assert bands(2, (96, 64), 32) == [(0, 2), (2, 3)]
    grid = Grid(0, (1, 2), DataGroup(), DataGroup()).framed((544, 960))
    assert [grid.stride_of(w) for w in (960, 240, 120, 60, 30)] == [1, 4, 8, 16, 32]
    with pytest.raises(ValueError, match="no power-of-two stride"):
        grid.stride_of(100)


@pytest.mark.parametrize("m_size", [2, 4])
@pytest.mark.parametrize("case", jobs.CONV_CASES, ids=lambda c: "k{}s{}d{}".format(*c))
def test_band_conv_equals_one_process(ranks, m_size, case):
    """At M = 4 each rank holds 3 of the 12 rows: the dilation-5 halo
    reads two ranks each way, the strided windows start off odd bands."""
    p = ranks["payload"]["units"]
    k, s, d = case
    conv = jobs.conv_module(k, s, d).double()
    conv.load_state_dict(p["conv_states"][jobs.CONV_CASES.index(case)])
    x = p["x"].clone().requires_grad_(True)
    y = conv(x)
    (y * p["cot"][s]).sum().backward()
    res = _unit_results(ranks, m_size)
    key = f"conv{k}-{s}-{d}"
    _close(_cat(res, key, "y"), y.detach(), what="y")
    _close(_cat(res, key, "dx"), x.grad, what="dx")
    for name, q in conv.named_parameters():
        _close(sum(r[key]["dw"][name] for r in res), q.grad, what=name)


@pytest.mark.parametrize("m_size", [2, 4])
def test_band_maxpool_off_odd_bands_equals_one_process(ranks, m_size):
    p = ranks["payload"]["units"]
    y, dx = _one_process(lambda t: F.max_pool2d(t, 3, 2, 1), p["x"], p["cot"][2][:, :3])
    res = _unit_results(ranks, m_size)
    _close(_cat(res, "maxpool", "y"), y)
    _close(_cat(res, "maxpool", "dx"), dx)


@pytest.mark.parametrize("m_size", [2, 4])
@pytest.mark.parametrize("align", [False, True], ids=["half_pixel", "align_corners"])
@pytest.mark.parametrize("case", jobs.RESIZE_CASES, ids=lambda c: "s{}to{}".format(*c))
def test_band_resize_equals_one_process(ranks, m_size, align, case):
    """The band's rows of the global interpolation matrix, the source rows
    they read fetched from their owners; the backward returns their
    gradients to them."""
    p = ranks["payload"]["units"]
    s_in, s_out = case
    h, w = jobs.RESIZE_FRAME
    y, dx = _one_process(
        lambda t: resize_bilinear(t, (h // s_out, w // s_out), align_corners=align),
        p["resize_x"][s_in], p["resize_cot"][(s_out, align)])
    res = _unit_results(ranks, m_size)
    key = f"resize{s_in}-{s_out}-{align}"
    _close(_cat(res, key, "y"), y)
    _close(_cat(res, key, "dx"), dx)


@pytest.mark.parametrize("m_size", [2, 4])
def test_global_avg_pool_over_model_ranks_equals_one_process(ranks, m_size):
    """Each rank's pooled map is the whole activation's (its band's sum
    summed over the model ranks); with each rank's own use of it, the
    input gradient is the one process's with the uses summed."""
    p = ranks["payload"]["units"]
    y, dx = _one_process(global_avg_pool, p["pool_x"], p["pool_cot"][:m_size].sum(0))
    res = _unit_results(ranks, m_size)
    for r in res:
        _close(r["pool"]["y"], y)
    _close(_cat(res, "pool", "dx"), dx)


# ---------------------------------------------------------------------------
# the graphs' steps
# ---------------------------------------------------------------------------

def _held(got, want, what):
    """A grid step's record held to the reference step's."""
    for key in want["scalars"]:
        tol = STEP_TOL if key != "grad_norm" else STEP_TOL * max(1.0, want["scalars"][key])
        assert abs(got["scalars"][key] - want["scalars"][key]) <= tol, (what, key)
    assert torch.equal(got["cm"], want["cm"]), what
    assert int(want["cm"].sum()) > 0
    assert got["grads"].keys() == want["grads"].keys()
    for key, g in want["grads"].items():
        _close(got["grads"][key], g, STEP_TOL, f"{what} grad {key}")
    for key, v in want["state_dict"].items():
        tol = UNIT_TOL if key.endswith(("running_mean", "running_var")) else TOL
        _close(got["state_dict"][key], v, tol, f"{what} {key}")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_grid_1x2_step_equals_one_process(ranks, name):
    pair = next(i for i, pr in enumerate(jobs.PAIRS) if name in pr)
    single = ranks["got"][2 * pair]["plain"][name]
    for got in ranks["got"][2 * pair:2 * pair + 2]:
        _held(got["step12"][name], single, name)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_grid_2x2_step_equals_data_parallel_path(ranks, name):
    """The (2, 2) grid's step, whose loss is each data shard's, against the
    (2, 1) grid of ranks 1 and 3 on the same data shards; every rank of
    the grid ends with the same weights."""
    want = ranks["got"][1]["step21"][name]
    for got in ranks["got"]:
        _held(got["step22"][name], want, name)


def test_uneven_bands_and_halos_taller_than_a_band(ranks):
    """On the (1, 2) grid at 96 padded rows: HRNet's branches hold 12, 6,
    3 rows a rank and the stride-32 branch 2 and 1; DeepLab's layer 4
    holds 6 rows a rank, below the ASPP's halos of 12, 24 and 36 rows."""
    got = ranks["got"]
    for name in ("hrnet", "ocr_hrnet"):
        assert [b[2] for b in got[0]["step12"][name]["shapes"]["bands"]] == [12, 6, 3, 2]
        assert [b[2] for b in got[1]["step12"][name]["shapes"]["bands"]] == [12, 6, 3, 1]
        assert [b[2] for b in got[0]["plain"][name]["shapes"]["bands"]] == [24, 12, 6, 3]
    for name in ("deeplabv3", "deeplabv3plus"):
        for r in got[2:]:
            assert r["step12"][name]["shapes"]["bands"][0][2:] == (6, 8)


def _one_process_evals(ranks, name):
    p = ranks["payload"]
    model = build_model(GRAPHS[name], 2, device="cpu").double()
    model.load_state_dict(p["state_dicts"][name])
    images, labels = p["batch"]
    logits, lbl, cm = make_eval_step(EvalSpec(pad=True), 17, device="cpu",
                                     precision="fp64")(model, images, labels)
    step = make_eval_loss_step(build_loss(LOSSES[name], 2, "cpu"), EvalSpec(pad=True),
                               device="cpu", precision="fp64", num_classes=17)
    shards = [step(model, images[k:k + 2], labels[k:k + 2], 0) for k in (0, 2)]
    return logits, lbl, cm, (float(shards[0][3]) + float(shards[1][3])) / 2


@pytest.mark.parametrize("name", list(GRAPHS))
def test_grid_2x2_eval_steps_equal_one_process(ranks, name):
    got = [r["eval22"][name] for r in ranks["got"]]
    logits, lbl, cm, loss = _one_process_evals(ranks, name)
    for r in got:
        assert torch.equal(r["cm"], cm) and torch.equal(r["loss_cm"], cm)
        assert abs(r["loss"] - loss) <= TOL, (r["loss"], loss)
    assert int(cm.sum()) == int((lbl < 17).sum()) > 0
    for d in (0, 1):            # data index d: frames 2d, 2d + 1; model ranks' rows
        band = torch.cat([got[2 * d + m]["logits"] for m in (0, 1)], 2)
        _close(band, logits[2 * d:2 * d + 2])
        assert torch.equal(torch.cat([got[2 * d + m]["labels"] for m in (0, 1)], 1),
                           lbl[2 * d:2 * d + 2])
        for m in (0, 1):
            assert torch.equal(got[2 * d + m]["loss_logits"], got[2 * d + m]["logits"])


@pytest.mark.parametrize("name", list(JAX_GRAPHS))
def test_grid_2x2_eval_loss_step_equals_jax_mesh_step(ranks, name):
    want = ranks["want"][name]
    for r in ranks["got"]:
        got = r["eval22"][name]
        assert abs(got["loss"] - want["loss"]) <= TOL, (got["loss"], want["loss"])
        np.testing.assert_array_equal(got["cm"].numpy(), want["cm"])
    assert int(want["cm"].sum()) > 0
