"""What tests/test_torch_spatial_decoders.py runs on four gloo ranks
(parallel/launch.py:Ranks). `decoders_job` forms every grid of the file on
each rank, in the same order, and returns what the tests compare; the
module imports the port alone, so the ranks start without jax.

Grids over the four ranks: (2, 2) and (1, 4) over all of them, (1, 2)
over ranks 0-1 and over ranks 2-3, (2, 1) over ranks 1 and 3."""
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    ConvTranspose2d, MaxPool2d, adaptive_avg_pool, upsample_like)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import Grid, init_from_env
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.spatial import spatial_rows
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, make_eval_loss_step, make_eval_step, make_train_step)
from torch_spatial_graphs_jobs import _band, _graph_model

TASK = 2
# the pyramid pool units: (frame, stride) of an activation of 17 rows
# (544 / 32: 9/8 at M = 2, 5/4/4/4 at M = 4) and of 3 rows (96 / 32: 2/1,
# and 1/1/1/0 at M = 4), pooled to each scale, its bins straddling the
# bands, and upsampled whole to each rank's band
PPM_CASES = {"r17": ((544, 64), 32), "r3": ((96, 64), 32)}
PPM_SCALES = (1, 2, 3, 6)
# the 2x2 max-pool units on a 24x16 frame, from stride 2 at M = 4 (3 rows
# a rank, odd, to 2/1/2/1) and from strides 2 and 4 at M = 2 (6/6 to 3/3,
# 3/3 to 2/1)
POOL_FRAME = (24, 16)
POOL_STRIDES = {2: (2, 4), 4: (2,)}
# the transposed convolutions on a 96x64 frame: (kernel, stride, padding,
# input stride); FCN's 2x from strides 32 (M = 2 only: 2/1 rows) and 16
# (3/3; 2/1/2/1 at M = 4) and its 8x from stride 8 to the frame's rows
DECONV_CASES = [(4, 2, 1, 32), (4, 2, 1, 16), (16, 8, 4, 8)]
DECONV_FRAME = (96, 64)
# each (1, 2) grid's graphs: ranks 0-1 UPerNet and FCN, ranks 2-3 UNet
PAIRS = (("upernet", "fcn"), ("unet",))


def deconv_module(k, s, p, c=3):
    return ConvTranspose2d(c, c, k, stride=s, padding=p)


def deconv_cases(m_size):
    return [c for c in DECONV_CASES if m_size == 2 or c[3] < 32]


def _unit(grid, module, x, cot, frame, in_stride, out_stride):
    """`module`'s forward and backward on this rank's band of `x` (at
    `in_stride` of a `frame`) with its band of `cot` (at `out_stride`):
    its output and input gradient rows, its weight gradients."""
    xl = _band(grid, x, frame, in_stride).clone().requires_grad_(True)
    module.grid, module.site = grid.framed(frame), "unit"
    y = module(xl)
    module.grid = None
    (y * _band(grid, cot, frame, out_stride)).sum().backward()
    return {"y": y.detach(), "dx": xl.grad,
            "dw": {n: q.grad.clone() for n, q in module.named_parameters()}}


def units(grid, p):
    """Every unit of the payload on this rank's band (see the test)."""
    out = {}
    for name, (frame, stride) in PPM_CASES.items():
        framed = grid.framed(frame)
        for scale in PPM_SCALES:
            x = _band(grid, p["ppm_x"][name], frame, stride).clone().requires_grad_(True)
            pooled = adaptive_avg_pool(x, (scale, scale), grid=framed)
            y = upsample_like(pooled, tuple(x.shape[2:]), align_corners=False, grid=framed,
                              whole_source=True)
            (y * _band(grid, p["ppm_cot"][name], frame, stride)).sum().backward()
            out[f"ppm-{name}-{scale}"] = {"pooled": pooled.detach(), "y": y.detach(),
                                          "dx": x.grad}
    for stride in POOL_STRIDES[grid.m_size]:
        out[f"maxpool{stride}"] = _unit(grid, MaxPool2d(2, 2), p["pool_x"][stride],
                                        p["pool_cot"][stride], POOL_FRAME, stride, 2 * stride)
    for k, s, pad, stride in deconv_cases(grid.m_size):
        conv = deconv_module(k, s, pad).double()
        conv.load_state_dict(p["deconv_states"][k])
        out[f"deconv{k}-{stride}"] = _unit(grid, conv, p["deconv_x"][stride],
                                           p["deconv_cot"][stride // s], DECONV_FRAME,
                                           stride, stride // s)
    return out


# the frames FCN and UNet cannot split over two model ranks, each refused
# where its first op's output misses the bands (the same op on every rank)
MISFITS = (("fcn", (80, 64)), ("fcn", (64, 80)), ("unet", (36, 48)))


def misfits(grid, p):
    """Each misfit frame's forward on this rank's band: the error's text."""
    errors = []
    for name, frame in MISFITS:
        model = _graph_model(p, name)
        try:
            with spatial_rows(model, grid, frame), torch.no_grad():
                model(torch.zeros(1, 3, frame[0] // grid.m_size, frame[1], dtype=torch.float64))
            errors.append("")
        except ValueError as exc:
            errors.append(str(exc))
    return errors


def train_step(grid, p, name):
    """One train step of graph `name` (the LossWrapper's bucket Lovász,
    Adam) over `grid` (None: one process) on the graph's global batch: its
    scalars, matrix, gradients and state dict, and the rows of its deepest
    map (the input of module `p["deepest"][name]`)."""
    model = _graph_model(p, name)
    seen = {}

    def deepest(module, inputs):
        seen.setdefault("rows", inputs[0].shape[2])

    model.get_submodule(p["deepest"][name]).register_forward_pre_hook(deepest)
    cfg = p["cfg"]
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 100))
    step = make_train_step(build_loss(p["losses"][name], TASK, "cpu"),
                           device_spec(cfg["transforms"]), TASK, device="cpu",
                           precision="fp32", train_metrics="s8", seed=1, group=grid)
    images, labels = p["batches"][name]
    rows = slice(None) if grid is None else grid.local_rows(len(images))
    m = step(state, images[rows], labels[rows], 0)
    return {"scalars": {k: float(v) for k, v in m.items() if v.ndim == 0},
            "cm": m["confusion_matrix"],
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()
                      if q.grad is not None},
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "deepest": seen["rows"]}


def eval_steps(grid, p, name):
    """The eval step's and the eval-loss step's results over `grid` on this
    rank's data shard of the graph's batch; with no grid, one process's on
    the whole batch, its loss the mean of the two data shards'."""
    model = _graph_model(p, name)
    images, labels = p["batches"][name]
    spec = EvalSpec(pad=True)
    step = make_eval_loss_step(build_loss(p["losses"][name], TASK, "cpu"), spec,
                               device="cpu", precision="fp64", num_classes=17, group=grid)
    if grid is None:
        logits, lbl, cm = make_eval_step(spec, 17, device="cpu", precision="fp64")(
            model, images, labels)
        half = len(images) // 2
        loss = sum(float(step(model, images[k:k + half], labels[k:k + half], 0)[3])
                   for k in (0, half)) / 2
        return {"logits": logits, "labels": lbl, "cm": cm, "loss": loss}
    rows = grid.local_rows(len(images))
    logits, lbl, cm = make_eval_step(spec, 17, device="cpu", precision="fp64",
                                     group=grid)(model, images[rows], labels[rows])
    l_logits, _, l_cm, loss = step(model, images[rows], labels[rows], 0)
    return {"logits": logits, "labels": lbl, "cm": cm, "loss_cm": l_cm,
            "loss_logits": l_logits, "loss": float(loss)}


def decoders_job(rank, world, path):
    p = torch.load(path, weights_only=False)
    w = init_from_env("cpu")
    g22 = Grid.of(w, (2, 2))
    g14 = Grid.of(w, (1, 4))
    g12 = [Grid.of(w, (1, 2), ranks=[0, 1]), Grid.of(w, (1, 2), ranks=[2, 3])][rank // 2]
    g21 = Grid.of(w, (2, 1), ranks=[1, 3])
    out = {"units4": units(g14, p["units"]), "units2": units(g12, p["units"]),
           "errors": misfits(g12, p)}
    pair = PAIRS[rank // 2]
    out["step12"] = {name: train_step(g12, p, name) for name in pair}
    if rank in (0, 2):       # one process, while ranks 1 and 3 run the (2, 1) grid
        out["plain"] = {name: train_step(None, p, name) for name in pair}
        out["eval1"] = {name: eval_steps(None, p, name) for name in pair}
    else:
        out["step21"] = {name: train_step(g21, p, name) for pr in PAIRS for name in pr}
    names = [name for pr in PAIRS for name in pr]
    out["step22"] = {name: train_step(g22, p, name) for name in names}
    out["eval22"] = {name: eval_steps(g22, p, name) for name in names}
    return out
