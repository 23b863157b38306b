"""The spatial grid (parallel/spatial.py, ROADMAP item 18 parts 3, 4 and 6)
on UPerNet, FCN and UNet, against one process and against the JAX
package's ("data", "model") mesh.

The port's side runs on four gloo ranks (parallel/launch.py:Ranks, one
intra-op thread each; tests/torch_spatial_decoders_jobs.py), started by
one module fixture before the JAX side compiles in this process. The grids
over them: (2, 2) and (1, 4) over all four, (1, 2) over ranks 0-1 and over
ranks 2-3, (2, 1) over ranks 1 and 3.

- Units at M = 4 and M = 2, float64, within 1e-12 of the same op in one
  process, forward and backward (input gradients; weight gradients summed
  over the ranks): UPerNet's pyramid pool (the band's columns of the
  adaptive pool's bins, summed over the model ranks, then upsampled whole
  to each band) at scales 1, 2, 3 and 6 over 17 and 3 rows, the bins
  straddling the bands; FCN's and UNet's 2x2 max-pool off odd and uneven
  bands; FCN's transposed convolutions (4x4 stride 2, 16x16 stride 8)
  across band edges and the image's edges.
- The graphs, float64 weights bridged from numpy-filled flax variables:
  UPerNet on ResNet-18 with a 32-channel decoder and FCN at width 0.125
  on 4 frames of 92x64 (96 rows once padded: the stride-32 maps split 2/1
  over two ranks), UNet on 4 frames of 36x48 (40 padded rows: its stride-8
  map splits 3/2); pad and flip, Adam, the UPerNet recipe's LossWrapper
  bucket Lovász (UPerNet: the single-scale fused route, B1/B2's plain
  versions; FCN and UNet: the full-resolution route, B3/B4f's).
  - The (1, 2) grid's step against the one-process step on the same
    batch, weights and draws: loss and gradients within 1e-9, parameters
    after Adam within 1e-6, BatchNorm statistics within 1e-12, the matrix
    equal.
  - The (2, 2) grid's step against the port's (2, 1) grid, the
    data-parallel path: the same bars.
  - The (2, 2) eval step: the matrix equal to one process's, each rank's
    rows of the logits within 1e-12; the eval-loss step's loss the mean of
    one process's over the two data shards, its matrix the eval step's.
- FCN's (2, 2) eval-loss step against JAX's over a 2x2 ("data", "model")
  mesh, frames under P("data", "model"), the loss per data shard
  (`_sharded_loss`; the Pallas kernels in interpret mode): loss within
  1e-6, the matrix equal. FCN is the graph the JAX package's own
  multi-chip test runs on this mesh. The gradients are held to the (2, 1)
  path, since JAX's step on this layout moves its gradients (ROADMAP
  Queue C).
- The global BatchNorm (every grid's and data group's) on a float32 map
  constant over each frame, UPerNet's scale-1 pyramid branch: within 1e-4
  of float64.
- Refusals: a window whose output over the whole activation misses the
  bands' rows, a frame that FCN or UNet cannot split, and UPerNet configs
  outside the grid raise with the layer or the key named.
"""
import pathlib
import re

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

from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    BatchNorm2d, MaxPool2d)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import DataGroup, Grid
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.spatial import check_graph
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import (
    bridge_encdec_upernet, bridge_flax_names)
from test_torch_graphs import numpy_variables
from test_torch_spatial_graphs import FLAGSHIP, _close, _held, blocky
from test_torch_train import x64
import torch_spatial_decoders_jobs as jobs

TESTS = pathlib.Path(__file__).resolve().parent
LOSS = {"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"}
# name: (graph, the frames' raw (H, W), bridge)
GRAPHS = {"upernet": ({"model": "UPerNet", "encoder": {"model": "ResNet18"},
                       "decoder": {"ppm_num_ch": 32, "fpn_num_ch": 32}}, (92, 64),
                      bridge_encdec_upernet),
          "fcn": ({"model": "FCN", "width": 0.125}, (92, 64), bridge_flax_names),
          "unet": ({"model": "UNet"}, (36, 48), bridge_flax_names)}
# the module each graph's deepest map enters, and its rows a rank on the
# (1, 2) grid: UPerNet's and FCN's stride-32 maps of 3 rows, UNet's
# stride-8 map of 5
DEEPEST = {"upernet": ("dec_model.ppm_last_conv", [2, 1]), "fcn": ("conv6", [2, 1]),
           "unet": ("down4_conv1", [3, 2])}
TRANSFORMS = ["pad", "flip"]
N = 4
TOL = 1e-6           # against JAX; parameters after Adam
UNIT_TOL = 1e-12     # units; BatchNorm statistics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _units_payload():
    rng = np.random.default_rng(25)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))       # noqa: E731
    deconvs = {k: jobs.deconv_module(k, s, p).double() for k, s, p, _ in jobs.DECONV_CASES}
    for c in deconvs.values():
        with torch.no_grad():
            for q in c.parameters():
                q.copy_(t(*q.shape))
    ppm = {name: (-(-h // s), -(-w // s)) for name, ((h, w), s) in jobs.PPM_CASES.items()}
    ph, pw = jobs.POOL_FRAME
    dh, dw = jobs.DECONV_FRAME
    return {"ppm_x": {k: t(2, 3, *hw) for k, hw in ppm.items()},
            "ppm_cot": {k: t(2, 3, *hw) for k, hw in ppm.items()},
            "pool_x": {s: t(2, 3, ph // s, pw // s) for s in (2, 4)},
            "pool_cot": {s: t(2, 3, ph // s // 2, pw // s // 2) for s in (2, 4)},
            "deconv_states": {k: c.state_dict() for k, c in deconvs.items()},
            "deconv_x": {s: t(2, 3, dh // s, dw // s) for s in (32, 16, 8)},
            "deconv_cot": {s: t(2, 3, dh // s, dw // s) for s in (16, 8, 1)}}


def _variables():
    """Each graph's float64 flax variables filled from numpy (numpy trees)."""
    out = {}
    for seed, (name, (graph, (h, w), _)) in enumerate(GRAPHS.items()):
        model = jax_build_model(graph, 2, dtype=jnp.float64)
        out[name] = jax.tree.map(np.asarray, numpy_variables(model, (1, h + 4, w, 3), seed))
    return out


def jax_fcn_mesh_eval_loss(variables, images, labels):
    """JAX's float64 eval-loss step of FCN over a 2x2 ("data", "model") mesh
    of CPU devices, frames under P("data", "model"), the loss of each data
    shard averaged over 'data' (`_sharded_loss`, as its train step takes
    it); the caller enables x64."""
    model = jax_build_model(GRAPHS["fcn"][0], 2, dtype=jnp.float64)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    sharded = _sharded_loss(jax_build_loss(LOSS, 2), mesh, "data", check_vma=False)
    step = jax_make_eval_loss_step(lambda o, lbl, epoch: sharded(o, lbl, epoch, 0),
                                   build_transform_pipeline(TRANSFORMS, {}, 2).device)
    tx = jax_make_optimizer(FLAGSHIP["train"], jlr.make_schedule(FLAGSHIP["train"], 100))
    params, stats = variables["params"], variables.get("batch_stats", {})
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    frames = NamedSharding(mesh, P("data", "model"))
    _, _, cm, loss = step(jax.device_put(state, NamedSharding(mesh, P())),
                          jax.device_put(jnp.asarray(images), frames),
                          jax.device_put(jnp.asarray(labels), frames), 0)
    return {"cm": np.asarray(cm), "loss": float(loss)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, JAX's FCN mesh eval-loss step, the payload."""
    tmp = tmp_path_factory.mktemp("spatial_decoders")
    with x64():
        variables = _variables()
    batches = {name: blocky(N, h, w, 25 + i)
               for i, (name, (_, (h, w), _)) in enumerate(GRAPHS.items())}
    sds = {name: bridge(variables[name]["params"], variables[name].get("batch_stats", {}))
           for name, (_, _, bridge) in GRAPHS.items()}
    payload = {"cfg": {"transforms": TRANSFORMS, "train": FLAGSHIP["train"]},
               "graphs": {name: g for name, (g, _, _) in GRAPHS.items()},
               "losses": dict.fromkeys(GRAPHS, LOSS), "state_dicts": sds,
               "batches": batches, "deepest": {k: v[0] for k, v in DEEPEST.items()},
               "units": _units_payload()}
    path = tmp / "payload.pt"
    torch.save(payload, path)
    started = Ranks("torch_spatial_decoders_jobs:decoders_job", 4, path, paths=[TESTS])
    try:
        with x64():
            want = jax_fcn_mesh_eval_loss(variables["fcn"], *batches["fcn"])
    finally:
        got = started.results(timeout=600)
    return {"got": got, "want": want, "payload": payload}


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _unit_results(ranks, m_size):
    got = ranks["got"]
    return [r["units4"] for r in got] if m_size == 4 else [r["units2"] for r in got[:2]]


def _cat(res, key, field):
    return torch.cat([r[key][field] for r in res], dim=2)


def _one_process(fn, x, cot):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * cot).sum().backward()
    return y.detach(), x.grad


@pytest.mark.parametrize("m_size", [2, 4])
@pytest.mark.parametrize("scale", jobs.PPM_SCALES)
@pytest.mark.parametrize("case", list(jobs.PPM_CASES))
def test_band_pyramid_pool_equals_one_process(ranks, m_size, scale, case):
    """Each rank's pooled map is the whole activation's (its band's
    columns of the bins, summed over the model ranks; scale 6's bins over
    17 rows, [0, 3), [2, 6), [5, 9), ..., straddle the 9/8 bands), and its
    upsample to the band is the band's rows of one process's; the input
    gradient sums every rank's use of the pooled map. At M = 4 the 3-row
    activation leaves the last rank an empty band."""
    p = ranks["payload"]["units"]
    x = p["ppm_x"][case]
    pooled = F.adaptive_avg_pool2d(x, scale)
    y, dx = _one_process(lambda t: resize_bilinear(F.adaptive_avg_pool2d(t, scale),
                                                   tuple(x.shape[2:]), align_corners=False),
                         x, p["ppm_cot"][case])
    res = _unit_results(ranks, m_size)
    key = f"ppm-{case}-{scale}"
    for r in res:
        _close(r[key]["pooled"], pooled, what="pooled")
    _close(_cat(res, key, "y"), y, what="y")
    _close(_cat(res, key, "dx"), dx, what="dx")


@pytest.mark.parametrize("m_size, stride", [(2, 2), (2, 4), (4, 2)])
def test_band_maxpool_2x2_equals_one_process(ranks, m_size, stride):
    """The 2x2 stride-2 window is not centred: from 3-row bands (M = 4, and
    M = 2 at stride 4) rank 0's last output row reads rank 1's first row."""
    p = ranks["payload"]["units"]
    y, dx = _one_process(lambda t: F.max_pool2d(t, 2, 2), p["pool_x"][stride],
                         p["pool_cot"][stride])
    res = _unit_results(ranks, m_size)
    _close(_cat(res, f"maxpool{stride}", "y"), y, what="y")
    _close(_cat(res, f"maxpool{stride}", "dx"), dx, what="dx")


@pytest.mark.parametrize("m_size, case", [(m, c) for m in (2, 4) for c in jobs.deconv_cases(m)],
                         ids=lambda v: "k{}s{}from{}".format(v[0], v[1], v[3])
                         if isinstance(v, tuple) else f"m{v}")
def test_band_transposed_conv_equals_one_process(ranks, m_size, case):
    """Each output band reads the input rows whose windows reach it, from
    any rank, zeros beyond the image; the bias lands once a row. At M = 4
    the stride-32 map of 3 rows would leave a rank no row, so it runs at
    M = 2 alone."""
    k, s, pad, stride = case
    p = ranks["payload"]["units"]
    conv = jobs.deconv_module(k, s, pad).double()
    conv.load_state_dict(p["deconv_states"][k])
    y, dx = _one_process(conv, p["deconv_x"][stride], p["deconv_cot"][stride // s])
    res = _unit_results(ranks, m_size)
    key = f"deconv{k}-{stride}"
    _close(_cat(res, key, "y"), y, what="y")
    _close(_cat(res, key, "dx"), dx, what="dx")
    for name, q in conv.named_parameters():
        _close(sum(r[key]["dw"][name] for r in res), q.grad, what=name)


def _fake_grid(m_size=2):
    """A grid whose collectives are never reached: the refusals raise first."""
    return Grid(0, (1, m_size), DataGroup(), DataGroup(), None)


def test_windows_that_miss_the_bands_raise():
    """The count check: a 2x2 pool of 5 rows gives 2, where the bands at
    the next stride of a 20-row frame hold 3; a transposed window shorter
    than its stride."""
    pool = MaxPool2d(2, 2)
    pool.grid, pool.site = _fake_grid().framed((20, 16)), "pool"
    with pytest.raises(ValueError, match=r"pool: the 2x2 window at stride 2.*\(2x2 out\)"):
        pool(torch.zeros(1, 1, 3, 4))
    deconv = jobs.deconv_module(2, 4, 0)
    deconv.grid, deconv.site = _fake_grid().framed((64, 64)), "deconv"
    with pytest.raises(ValueError, match="deconv: the 2x2 transposed window at stride 4"):
        deconv(torch.zeros(1, 3, 2, 4))


@pytest.mark.parametrize("case", range(len(jobs.MISFITS)),
                         ids=["fcn_80x64", "fcn_64x80", "unet_36x48"])
def test_frames_the_graphs_cannot_split_name_the_layer(ranks, case):
    """FCN on frames whose sides 32 does not divide, UNet on one whose
    rows 8 does not: the first pool whose output misses the bands raises
    on every rank, before any rank waits on another."""
    want = {0: r"pool: the 2x2 window .*\(2x2 out\).*at stride 32",
            1: r"pool: the 2x2 window .*\(2x2 out\).*at stride 32",
            2: r"pool: the 2x2 window .*\(4x6 out\).*at stride 8"}[case]
    for r in ranks["got"]:
        assert re.search(want, r["errors"][case]), r["errors"][case]


def test_global_batch_norm_keeps_a_near_constant_channel():
    """UPerNet's scale-1 pyramid branch is constant over each frame, so its
    channels' variance is small beside their mean. The global BatchNorm
    (here over a group of one rank, as every grid and data group runs it)
    normalises such a float32 map within 1e-4 of float64, as torch's own
    BatchNorm does, and its gradient within 1e-4 relative: its shift sits
    at the batch's mean, not at the running mean (0 at the first step),
    about which a float32 sum of squares loses the variance."""
    rng = np.random.default_rng(25)
    a = rng.uniform(-1.0, 1.0, 64)
    x = np.stack([a, a + 0.02 * rng.standard_normal(64)])[:, :, None, None]
    x = torch.from_numpy(np.ascontiguousarray(x.repeat(9, 2).repeat(30, 3)))
    cot = torch.from_numpy(rng.standard_normal(x.shape))
    want, want_dx = _one_process(lambda t: F.batch_norm(t, None, None, training=True,
                                                         eps=1e-5), x, cot)
    bn = BatchNorm2d(64).train()
    bn.group = DataGroup()
    y, dx = _one_process(bn, x.float(), cot.float())
    assert float((y.double() - want).abs().max()) <= 1e-4
    assert float((dx.double() - want_dx).norm() / want_dx.norm()) <= 1e-4
    np.testing.assert_allclose(bn.running_mean.double().numpy(),
                               0.1 * x.mean((0, 2, 3)).numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("graph, refused", [
    ({"model": "UPerNet", "encoder": {"model": "ResNet18"},
      "decoder": {"fpn_num_lvl": 3, "ppm_num_ch": 8, "fpn_num_ch": 8}}, "fpn_num_lvl 3"),
    ({"model": "UPerNet", "encoder": {"model": "ResNet18"},
      "decoder": {"interpolate_result_up": False, "ppm_num_ch": 8, "fpn_num_ch": 8}},
     "interpolate_result_up false"),
    ({"model": "EncDec", "encoder": {"model": "ResNet18"},
      "decoder": {"model": "UPerNet", "ppm_num_ch": 8, "fpn_num_ch": 8}}, None),
    ({"model": "UPerNet", "encoder": {"model": "ResNeXt50"},
      "decoder": {"ppm_num_ch": 8, "fpn_num_ch": 8}}, None),
    ({"model": "FCN", "width": 0.125}, None), ({"model": "UNet"}, None)],
    ids=["fpn3", "no_upsample", "encdec_r18", "resnext50", "fcn", "unet"])
def test_check_graph_takes_the_decoders(graph, refused):
    """UPerNet on a ResNet-family encoder (as EncDec or the alias), FCN and
    UNet split; a UPerNet whose logits are not the stride-4 map's whole
    upsample to the frame is refused, naming its key."""
    model = build_model(graph, 2, device="cpu")
    if refused is None:
        check_graph(model)
    else:
        with pytest.raises(NotImplementedError, match=f"{refused}.*ROADMAP item 18"):
            check_graph(model)


# ---------------------------------------------------------------------------
# the graphs' steps
# ---------------------------------------------------------------------------

def _pair_of(name):
    return next(i for i, pr in enumerate(jobs.PAIRS) if name in pr)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_grid_1x2_step_equals_one_process(ranks, name):
    pair = _pair_of(name)
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


@pytest.mark.parametrize("name", list(GRAPHS))
def test_deepest_bands_split_unevenly(ranks, name):
    """On the (1, 2) grid the deepest map splits unevenly: 2/1 of the 3
    stride-32 rows of 96 (UPerNet's pyramid, FCN's pool 5), 3/2 of UNet's
    5 stride-8 rows of 40."""
    pair = _pair_of(name)
    got = ranks["got"][2 * pair:2 * pair + 2]
    assert [r["step12"][name]["deepest"] for r in got] == DEEPEST[name][1]
    assert got[0]["plain"][name]["deepest"] == sum(DEEPEST[name][1])


@pytest.mark.parametrize("name", list(GRAPHS))
def test_grid_2x2_eval_steps_equal_one_process(ranks, name):
    got = [r["eval22"][name] for r in ranks["got"]]
    one = ranks["got"][2 * _pair_of(name)]["eval1"][name]
    logits, lbl, cm = one["logits"], one["labels"], one["cm"]
    for r in got:
        assert torch.equal(r["cm"], cm) and torch.equal(r["loss_cm"], cm)
        assert abs(r["loss"] - one["loss"]) <= TOL, (r["loss"], one["loss"])
    assert int(cm.sum()) == int((lbl < 17).sum()) > 0
    for d in (0, 1):            # data index d: frames 2d, 2d + 1; model ranks' rows
        band = torch.cat([got[2 * d + m]["logits"] for m in (0, 1)], 2)
        _close(band, logits[2 * d:2 * d + 2])
        assert torch.equal(torch.cat([got[2 * d + m]["labels"] for m in (0, 1)], 1),
                           lbl[2 * d:2 * d + 2])
        for m in (0, 1):
            assert torch.equal(got[2 * d + m]["loss_logits"], got[2 * d + m]["logits"])


def test_fcn_grid_2x2_eval_loss_step_equals_jax_mesh_step(ranks):
    want = ranks["want"]
    for r in ranks["got"]:
        got = r["eval22"]["fcn"]
        assert abs(got["loss"] - want["loss"]) <= TOL, (got["loss"], want["loss"])
        np.testing.assert_array_equal(got["cm"].numpy(), want["cm"])
    assert int(want["cm"].sum()) > 0
