"""What tests/test_torch_spatial_graphs.py runs on four gloo ranks
(parallel/launch.py:Ranks). `graphs_job` forms every grid of the file on
each rank, in the same order, and returns what the tests compare; the
module imports the port alone, so the ranks start without jax.

Grids over the four ranks: (2, 2) and (1, 4) over all of them, (1, 2)
over ranks 0-1 and over ranks 2-3, (2, 1) over ranks 1 and 3."""
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    Conv2d, MaxPool2d, global_avg_pool, upsample_like)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import Grid, init_from_env
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, make_eval_loss_step, make_eval_step, make_train_step)

TASK = 2
# the window units on a 12-row frame (3 rows a rank at M = 4): (kernel,
# stride, dilation); a dilation-5 halo spans two ranks, the strided ones
# start off odd bands
CONV_CASES = [(3, 1, 5), (3, 2, 1), (1, 2, 1)]
UNIT_FRAME = (12, 7)
# the resize units on a 96x64 frame: (stride in, stride out), up by 2, 4
# and 8 from stride 16 (2/1/2/1 rows a rank at M = 4) and DeepLabv3+'s
# decoder, stride 8 to 4; each at align_corners False and True
RESIZE_CASES = [(16, 8), (16, 4), (16, 2), (8, 4)]
RESIZE_FRAME = (96, 64)
# the pool unit: an activation at stride 2 of a 12x14 frame
POOL_FRAME = (12, 14)
# each graph's (1, 2) grid: ranks 0-1 run the HRNet trunks, ranks 2-3 DeepLab
PAIRS = (("hrnet", "ocr_hrnet"), ("deeplabv3", "deeplabv3plus"))


def conv_module(k, s, d, c_in=3, c_out=4):
    return Conv2d(c_in, c_out, k, stride=s, padding=d * (k // 2), dilation=d, bias=True)


def _band(grid, t, frame, stride=1):
    """This rank's band of the whole activation `t` at `stride`."""
    lo, hi = grid.framed(frame).bands(stride)[grid.m]
    return t[:, :, lo:hi]


def _unit(grid, module, x, cot, frame, out_stride):
    """`module`'s forward and backward on this rank's band of `x` (a
    `frame`) with its band of `cot` (at `out_stride`): its output and
    input gradient rows, its weight gradients."""
    xl = _band(grid, x, frame).clone().requires_grad_(True)
    module.grid, module.site = grid.framed(frame), "unit"
    y = module(xl)
    module.grid = None
    (y * _band(grid, cot, frame, out_stride)).sum().backward()
    return {"y": y.detach(), "dx": xl.grad,
            "dw": {n: p.grad.clone() for n, p in module.named_parameters()}}


def units(grid, p):
    """Every unit of the payload on this rank's band (see the test)."""
    out = {}
    for (k, s, d), st in zip(CONV_CASES, p["conv_states"]):
        conv = conv_module(k, s, d).double()
        conv.load_state_dict(st)
        out[f"conv{k}-{s}-{d}"] = _unit(grid, conv, p["x"], p["cot"][s], UNIT_FRAME, s)
    pool = MaxPool2d(3, stride=2, padding=1)
    out["maxpool"] = _unit(grid, pool, p["x"], p["cot"][2][:, :3], UNIT_FRAME, 2)
    framed = grid.framed(RESIZE_FRAME)
    for s_in, s_out in RESIZE_CASES:
        for align in (False, True):
            x = _band(grid, p["resize_x"][s_in], RESIZE_FRAME, s_in).clone().requires_grad_(True)
            lo, hi = framed.bands(s_out)[grid.m]
            y = upsample_like(x, (hi - lo, -(-RESIZE_FRAME[1] // s_out)), align, grid=framed)
            cot = p["resize_cot"][(s_out, align)]
            (y * cot[:, :, lo:hi]).sum().backward()
            out[f"resize{s_in}-{s_out}-{align}"] = {"y": y.detach(), "dx": x.grad}
    # the image pool: each rank uses the pooled map for its own rows
    framed = grid.framed(POOL_FRAME)
    x = _band(grid, p["pool_x"], POOL_FRAME, 2).clone().requires_grad_(True)
    pooled = global_avg_pool(x, framed)
    (pooled * p["pool_cot"][grid.m]).sum().backward()
    out["pool"] = {"y": pooled.detach(), "dx": x.grad}
    return out


def _graph_model(p, name):
    model = build_model(p["graphs"][name], TASK, device="cpu").double()
    model.load_state_dict(p["state_dicts"][name], strict=True)
    return model


class _Shapes:
    """The shapes the graph's bands take where they are uneven or short:
    HRNet's four branches out of its last fuse module, DeepLab's layer 4
    (the ASPP's input)."""

    def __init__(self, model):
        trunk = model if hasattr(model, "stage4") else model.backbone
        self.seen = {}
        (trunk.stage4[0] if hasattr(trunk, "stage4") else trunk.layer4).register_forward_hook(self)

    def __call__(self, module, inputs, output):
        outs = output if isinstance(output, list) else [output]
        self.seen.setdefault("bands", [tuple(o.shape) for o in outs])


def train_step(grid, p, name):
    """One train step of graph `name` (its loss, Adam) over `grid` (None:
    one process) on the payload's global batch: its scalars, matrix,
    gradients, state dict and band shapes."""
    model = _graph_model(p, name)
    shapes = _Shapes(model)
    cfg = p["cfg"]
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 100))
    step = make_train_step(build_loss(p["losses"][name], TASK, "cpu"),
                           device_spec(cfg["transforms"]), TASK, device="cpu",
                           precision="fp32", train_metrics="s8", seed=1, group=grid)
    images, labels = p["batch"]
    rows = slice(None) if grid is None else grid.local_rows(len(images))
    m = step(state, images[rows], labels[rows], 0)
    return {"scalars": {k: float(v) for k, v in m.items() if v.ndim == 0},
            "cm": m["confusion_matrix"],
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()
                      if q.grad is not None},
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "shapes": shapes.seen}


def eval_steps(grid, p, name):
    """The eval step's and the eval-loss step's results over `grid` on this
    rank's data shard of the batch, from the payload's weights."""
    model = _graph_model(p, name)
    images, labels = p["batch"]
    rows = grid.local_rows(len(images))
    spec = EvalSpec(pad=True)
    logits, lbl, cm = make_eval_step(spec, 17, device="cpu", precision="fp64",
                                     group=grid)(model, images[rows], labels[rows])
    step = make_eval_loss_step(build_loss(p["losses"][name], TASK, "cpu"), spec,
                               device="cpu", precision="fp64", num_classes=17, group=grid)
    l_logits, _, l_cm, loss = step(model, images[rows], labels[rows], 0)
    return {"logits": logits, "labels": lbl, "cm": cm, "loss_cm": l_cm,
            "loss_logits": l_logits, "loss": float(loss)}


def graphs_job(rank, world, path):
    p = torch.load(path, weights_only=False)
    w = init_from_env("cpu")
    g22 = Grid.of(w, (2, 2))
    g14 = Grid.of(w, (1, 4))
    g12 = [Grid.of(w, (1, 2), ranks=[0, 1]), Grid.of(w, (1, 2), ranks=[2, 3])][rank // 2]
    g21 = Grid.of(w, (2, 1), ranks=[1, 3])
    out = {"units4": units(g14, p["units"]), "units2": units(g12, p["units"])}
    pair = PAIRS[rank // 2]
    out["step12"] = {name: train_step(g12, p, name) for name in pair}
    if rank in (0, 2):       # one process, while ranks 1 and 3 run the (2, 1) grid
        out["plain"] = {name: train_step(None, p, name) for name in pair}
    else:
        out["step21"] = {name: train_step(g21, p, name) for pr in PAIRS for name in pr}
    names = [name for pr in PAIRS for name in pr]
    out["step22"] = {name: train_step(g22, p, name) for name in names}
    out["eval22"] = {name: eval_steps(g22, p, name) for name in names}
    return out
