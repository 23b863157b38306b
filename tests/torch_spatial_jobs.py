"""What tests/test_torch_spatial.py runs on four gloo ranks
(parallel/launch.py:Ranks). `spatial_job` forms every grid of the file on
each rank, in the same order, and returns what the tests compare; the
module imports the port alone, so the ranks start without jax.

Grids over the four ranks: (2, 2) and (1, 4) over all of them, (1, 2)
over ranks 0-1 and over ranks 2-3, (1, 1) over each rank alone and (2, 1)
over ranks 1 and 3."""
import pathlib

import torch
import torch.distributed as dist

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.layers import (
    BatchNorm2d, Conv2d, MaxPool2d)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import spatial_gather
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import (
    Grid, global_batch_norm, init_from_env, spatial_rows)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.sharded_twins import TASK
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, band_logits, make_eval_loss_step, make_eval_step, make_train_step)

# the window ops of the units: (kernel, stride, dilation); padding as the
# trunk pads them (the stem's 7x7 at 3, 3x3 at its dilation)
CONV_CASES = [(1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (7, 2, 1)]


def conv_module(k, s, d, c_in=3, c_out=4):
    p = 3 if k == 7 else (d if k == 3 else 0)
    return Conv2d(c_in, c_out, k, stride=s, padding=p, dilation=d, bias=True)


class _Site:
    """A module's grid and name for the block (as `spatial_rows` sets them)."""

    def __init__(self, grid, *mods):
        self.grid, self.mods = grid, mods

    def __enter__(self):
        for i, m in enumerate(self.mods):
            m.grid, m.site = self.grid, f"unit{i}"

    def __exit__(self, *exc):
        for m in self.mods:
            m.grid = None


def _band_grads(module, x, cot, grid):
    """`module`'s forward and backward on this rank's band of `x` with the
    band of `cot`: its output and input gradient rows, its weight
    gradients."""
    rows = grid.rows(x.shape[2])
    xl = x[:, :, rows].clone().requires_grad_(True)
    with _Site(grid.framed(x.shape[2:]), module):
        y = module(xl)
    (y * cot[:, :, grid.rows(cot.shape[2])]).sum().backward()
    return {"y": y.detach(), "dx": xl.grad,
            "dw": {n: p.grad.clone() for n, p in module.named_parameters()}}


def units(grid, p):
    """Every unit of the payload on this rank's band (see the test)."""
    out = {}
    for (k, s, d), st in zip(CONV_CASES, p["conv_states"]):
        conv = conv_module(k, s, d).double()
        conv.load_state_dict(st)
        out[f"conv{k}-{s}-{d}"] = _band_grads(conv, p["x"], p["cot"][s], grid)
    pool = MaxPool2d(3, stride=2, padding=1)
    out["maxpool"] = _band_grads(pool, p["x_pool"], p["cot_pool"], grid)
    # spatial_gather: the context of this rank's rows, summed over the model ranks
    rows = grid.rows(p["feats"].shape[2])
    f = p["feats"][:, :, rows].clone().requires_grad_(True)
    lg = p["probs"][:, :, rows].clone().requires_grad_(True)
    ctx = spatial_gather(f, lg, 1.0, grid=grid)
    # each rank uses the context for its own rows: a cotangent of its own
    (ctx * p["ctx_cot"][grid.m]).sum().backward()
    out["gather"] = {"ctx": ctx.detach(), "df": f.grad, "dl": lg.grad}
    # BatchNorm over the grid: a sharded tensor, and one replicated through a sum
    bn = BatchNorm2d(p["bn_x"].shape[1]).double()
    bn.load_state_dict(p["bn_state"])
    bn.train()
    xl = p["bn_x"][:, :, rows].clone().requires_grad_(True)
    with global_batch_norm(bn, grid.norm):
        y = bn(xl)
    (y * p["bn_cot"][:, :, rows]).sum().backward()
    out["bn"] = {"y": y.detach(), "dx": xl.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                 "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    bn = BatchNorm2d(p["rep_x"].shape[1]).double()
    bn.load_state_dict(p["bn_state"])
    bn.train()
    part = p["rep_x"] * (grid.m + 1) / (grid.m_size * (grid.m_size + 1) / 2)
    part = part.clone().requires_grad_(True)
    with global_batch_norm(bn, grid.norm):
        y = bn(grid.model_sum(part))
    (y * p["rep_cot"][grid.m]).sum().backward()
    out["bn_replicated"] = {"y": y.detach(), "dpart": part.grad, "dw": bn.weight.grad,
                            "db": bn.bias.grad,
                            "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    # gather_rows and the upsample's rows
    s8 = p["s8"][:, :, grid.rows(p["s8"].shape[2])].clone().requires_grad_(True)
    whole = grid.framed(p["s8"].shape[2:]).gather_rows(s8)
    (whole * p["s8_cot"]).sum().backward()
    out["gather_rows"] = {"whole": whole.detach(), "ds8": s8.grad}
    out["band_logits"] = band_logits(p["s8"], p["up_hw"], grid.rows(p["up_hw"][0]))
    return out


def _model(graph, state_dict, dtype=torch.float64):
    model = build_model(graph, TASK, device="cpu").to(dtype)
    model.load_state_dict(state_dict, strict=True)
    return model


def _step_with_grads(grid, p, graph, state_dict, batch, draws, transforms):
    """One train step (the flagship's loss, Adam) over `grid` on the
    batch, as tools/sharded_twins.py:`arm` runs it: its metrics,
    gradients, state dict and the shapes that hooks on layer4 and on the
    stride-8 logits saw; the model and train state under "kept" (not
    returned to the test)."""
    cfg = p["cfg"]
    model = _model(graph, state_dict)
    seen = {}

    def hook(key):
        def record(module, inputs, output):
            seen.setdefault(key, tuple(output.shape))
        return record

    model.backbone.layer4.register_forward_hook(hook("layer4"))
    model.conv_out.register_forward_hook(hook("logits_s8"))
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 100))
    step = make_train_step(build_loss(cfg["loss"], TASK, "cpu"), device_spec(transforms),
                           TASK, device="cpu", precision="fp32", train_metrics="s8",
                           seed=1, group=grid)
    images, labels = batch
    rows = slice(None) if grid is None else grid.local_rows(len(images))
    m = step(state, images[rows], labels[rows], 0, draws=draws)
    return {"losses": [float(m["loss"])], "metrics": {k: v.detach() for k, v in m.items()},
            "grads": {n: q.grad.clone() for n, q in model.named_parameters()
                      if q.grad is not None},
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "shapes": seen, "kept": (model, state)}


def _checkpoint(grid, p, kept, directory):
    """Rank 0 of the grid saves the (2, 2) step's model and train state
    (Adam's moments and step); every rank restores them into a fresh model
    and state, which must equal its own."""
    cfg, fl = p["cfg"], p["flagship"]
    model, state = kept
    wrote = False
    if grid.chief:
        ckpt.save_checkpoint(directory, "last", model, 1, 0.5, 1.0, state)
        wrote = True
    dist.barrier()
    fresh = _model(p["graph"], fl["state_dict"])
    fresh_state = create_train_state(fresh, cfg["train"], make_schedule(cfg["train"], 100))
    meta = ckpt.restore_checkpoint(directory, "last", fresh, fresh_state)
    same_model = all(torch.equal(v, fresh.state_dict()[k])
                     for k, v in model.state_dict().items())
    a, b = state.optimizer.state_dict(), fresh_state.optimizer.state_dict()
    same_opt = a["param_groups"] == b["param_groups"] and all(
        torch.equal(a["state"][i][k], b["state"][i][k]) for i in a["state"]
        for k in a["state"][i])
    dist.barrier()
    return {"wrote": wrote, "model_equal": same_model, "optimizer_equal": same_opt,
            "step": fresh_state.step == state.step == 1, "meta": meta}


def _errors(grid12, p):
    """A stride that leaves a rank no rows deeper in the trunk raises
    ValueError on both ranks (naming the layer)."""
    model = _model(p["graph"], p["flagship"]["state_dict"])
    x = torch.zeros(1, 3, 32, 64, dtype=torch.float64)
    try:
        with spatial_rows(model, grid12, x.shape[2:]), torch.no_grad():
            model(x[:, :, grid12.rows(32)], full_res=())
    except ValueError as exc:
        return str(exc)
    return None


def spatial_job(rank, world, path):
    p = torch.load(path, weights_only=False)
    w = init_from_env("cpu")
    g22 = Grid.of(w, (2, 2))
    g14 = Grid.of(w, (1, 4))
    g12 = [Grid.of(w, (1, 2), ranks=[0, 1]), Grid.of(w, (1, 2), ranks=[2, 3])][rank // 2]
    g11 = Grid.of(w, (1, 1), ranks=[rank])
    g21 = Grid.of(w, (2, 1), ranks=[1, 3])
    out = {"grid22": (g22.rank, g22.shape, g22.m, g22.data.rank),
           "units4": units(g14, p["units"]), "units2": units(g12, p["units"])}
    # (2, 2): the flagship's loss step of OCRNet-R18, the eval step, checkpoints
    fl = p["flagship"]
    out["step22"] = _step_with_grads(g22, p, p["graph"], fl["state_dict"], fl["batch"],
                                     fl["draws"], p["cfg"]["transforms"])
    model = _model(p["graph"], out["step22"]["state_dict"])
    eval_step = make_eval_step(EvalSpec(pad=True), 17, device="cpu", precision="fp64",
                               group=g22)
    images, labels = fl["batch"]
    rows = g22.local_rows(len(images))
    logits, lbl, cm = eval_step(model, images[rows], labels[rows])
    out["eval22"] = {"logits": logits, "labels": lbl, "cm": cm}
    eval_loss = make_eval_loss_step(build_loss(p["cfg"]["loss"], TASK, "cpu"),
                                    EvalSpec(pad=True), device="cpu", precision="fp64",
                                    num_classes=17, group=g22)
    logits, lbl, cm, loss = eval_loss(model, images[rows], labels[rows], 0)
    out["eval_loss22"] = {"logits": logits, "cm": cm, "loss": float(loss)}
    directory = pathlib.Path(p["ckpt_dir"])
    out["ckpt22"] = _checkpoint(g22, p, out["step22"].pop("kept"), directory)
    out["ckpt_files"] = sorted(q.name for q in directory.iterdir())
    # (1, 2): ranks 0-1 the R18 step, ranks 2-3 R50-os8's; each against
    # one process's step (rank 0 and rank 2, after the grid's)
    r50 = p["r50"]
    if rank >= 2:           # the seed's weights, built where they are used
        r50["state_dict"] = build_model(r50["graph"], TASK, device="cpu",
                                        seed=r50["seed"]).double().state_dict()
    if rank < 2:
        out["step12"] = _step_with_grads(g12, p, p["graph"], fl["state_dict"], fl["batch"],
                                         fl["draws"], p["cfg"]["transforms"])
        out["errors"] = _errors(g12, p)
    else:
        out["r50"] = _step_with_grads(g12, p, r50["graph"], r50["state_dict"],
                                      r50["batch"], None, ["flip"])
    if rank == 0:
        out["plain"] = _step_with_grads(None, p, p["graph"], fl["state_dict"], fl["batch"],
                                        fl["draws"], p["cfg"]["transforms"])
    if rank == 2:
        out["r50_plain"] = _step_with_grads(None, p, r50["graph"], r50["state_dict"],
                                            r50["batch"], None, ["flip"])
    # (1, 1) over each rank alone: the plain step's path
    if rank == 1:
        out["step11"] = _step_with_grads(g11, p, p["graph"], fl["state_dict"], fl["batch"],
                                         fl["draws"], p["cfg"]["transforms"])
    # (2, 1) over ranks 1 and 3: the data-parallel path of the (2, 2) step
    if g21 is not None:
        out["step21"] = _step_with_grads(g21, p, p["graph"], fl["state_dict"], fl["batch"],
                                         fl["draws"], p["cfg"]["transforms"])
    for r in out.values():
        if isinstance(r, dict):
            r.pop("kept", None)
    return out
