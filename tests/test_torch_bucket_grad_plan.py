"""B4 and B4f (kernels/bucket_grad.py, csrc/bucket_grad.cu) and the generic
bucket route's fused backward (losses/functional.py `_BucketFromLogits`).

The kernels run only on the card; what surrounds them is held here:
  * the route (B3 forward, B4f's plain version backward) against JAX
    `value_and_grad` of `lovasz_softmax(impl="bucket")` at every bucket
    case of test_torch_bucket.py's LOVASZ and more, and of
    `fused_two_scale_lovasz`, as test_torch_bucket.py runs them (Pallas in
    interpret mode under `jax.jit`): values within 1e-5, gradients within a
    relative L2 of 1e-5 (float32 softmax and sums in another order); the
    backward goes through B4f once per scale and never through B4;
  * the route against the parent commit's composition (autograd through
    `lovasz_rows` into `bucket_lovasz_per_class`) on the same logits:
    float32 gradients within a relative L2 of 1e-6 (the softmax and the
    VJP's sum in another order), bf16 ones within that and one bf16 ulp,
    float64 ones those of the float32 route; and it keeps fewer bytes from
    the forward;
  * a float32 model of B4f's walk (its plan's tiles and segments, the
    errors and flags it reads, the bf16 table, dp as bf16, the ascending
    sums): every gradient element written once, the bucket ids it reads
    equal to B3's `bucket_ids`, the gradient within float32 rounding of
    `bucket_dlogits_plain` (which takes the kernel's order: in bf16 within
    one bf16 ulp);
  * a model of B4's walk (scalar head, float4 vectors, tail, or the scalar
    path) at every alignment of a row's errors, flags and gradient and
    every P mod 4: every pixel written once, equal to `bucket_gather_plain`;
  * both plans at every phase-9/10 shape of chip_smoke.py and over C 1..32,
    N up to 64: one wave, the instance by C, shared memory within the
    232,448 bytes a block may opt into, every tile walked once;
  * the ctypes declarations of the four C entries, the CPU wrappers and
    what they refuse, and the ablation tool's edits.
"""
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.losses.functional import (
    fused_two_scale_lovasz as jax_two_scale, lovasz_softmax as jax_lovasz_softmax)

import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    build, bucket_dlogits, bucket_dlogits_plain, bucket_gather_plain, launch_counts)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import bucket_grad as bg
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    bucket_histogram_plain, bucket_ids)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import bucket_lovasz, functional
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    grad_table, losses_and_tables)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
    fused_two_scale_lovasz, lovasz_rows, lovasz_softmax)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import bucket_grad_ablation

SMEM_OPT_IN = 232_448
# blocks the card may hold at once: a small count that makes each block
# walk many tiles or images, and an H100's 132 SMs at one to eight blocks
RESIDENT = (1, 7, 132, 264, 1056)
N, C, H, W = 2, 5, 24, 40

BUCKET_CASES = [
    # classes_to_consider, classes_to_ignore, per_image: test_torch_bucket.py's
    # bucket LOVASZ cases, then two more
    ("present", None, False),
    ("all", C, True),
    ([1, 3], C, False),
    ("present", None, True),
    ([0, 2, 4], None, True),
    ("all", None, False),
]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def seg_inputs(seed=0, n=N, c=C, h=H, w=W, std=2.0):
    """NHWC float32 logits and NHW uint8 labels with the ignore id c, and a
    class absent from image 1."""
    rng = np.random.default_rng(seed)
    logits = (std * rng.standard_normal((n, h, w, c))).astype(np.float32)
    grid = rng.integers(0, c + 1, (n, -(-h // 4), -(-w // 4)))
    labels = np.repeat(np.repeat(grid, 4, 1), 4, 2)[:, :h, :w].astype(np.uint8)
    labels[0, :4] = c
    if n > 1:
        labels[1, :, :8] = min(3, c - 1)
    return logits, labels


def nchw(t: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t.transpose(0, 3, 1, 2)))


@pytest.fixture
def spy(monkeypatch):
    """Counts the route's calls of B4f and B4 (the wrappers' CPU paths)."""
    calls = {"bucket_dlogits": 0, "bucket_grad": 0}

    def dlogits(*args, **kwargs):
        calls["bucket_dlogits"] += 1
        return bucket_dlogits(*args, **kwargs)

    def gather(*args, **kwargs):
        calls["bucket_grad"] += 1
        return bucket_gather_plain(*args, **kwargs)

    monkeypatch.setattr(functional, "bucket_dlogits", dlogits)
    monkeypatch.setattr(bucket_lovasz, "bucket_gather", gather)
    return calls


def parent_lovasz_softmax(x, labels, **kw):
    """The parent commit's generic bucket route (chip_smoke.py's copy)."""
    return chip_smoke.parent_lovasz_softmax(x, labels, **kw)


# The float32 route's own error in its gradient: the route makes discrete
# choices from float32 values (a pixel's bucket, each bucket gradient's
# bf16 rounding, where many lie on a rounding tie) and another float32
# evaluation may choose otherwise where a value sits within a few ulps of a
# boundary; one such choice moves the gradient's relative L2 by 1e-5 to
# 2e-4. Against `route64`, the same route in float64, the port's and the
# JAX package's float32 gradients both read 8.7e-5 to 4.24e-4 at the six
# BUCKET_CASES (each choice they share with each other, and not with
# float64); the gate is that reading rounded up.
ROUTE_F32_REL = 5e-4


def route64(logits, labels, consider, ignore, per_image) -> np.ndarray:
    """The generic bucket route's gradient in float64 (NCHW): float64
    softmax and errors, their 2048-bucket ids, counts and bucket gradients
    (`losses_and_tables`, dtype-generic), the loss's cotangent, the
    table rounded to bf16 once, the gather and the softmax VJP."""
    x = torch.from_numpy(logits.astype(np.float64)).permute(0, 3, 1, 2)
    lbl = torch.from_numpy(labels).long()
    n, c, h, w = x.shape
    if per_image:
        lt, lb = x.reshape(n, c, -1), lbl.reshape(n, 1, -1)
    else:
        lt, lb = x.transpose(0, 1).reshape(1, c, -1), lbl.reshape(1, 1, -1)
    p = torch.softmax(lt, dim=1)
    fg = lb == torch.arange(c)[None, :, None]
    valid = torch.ones_like(fg) if ignore is None else (lb != ignore).expand_as(fg)
    fg = fg & valid
    e = ((fg.double() - p).abs() * valid).reshape(-1, lt.shape[-1])
    fg = fg.reshape(e.shape)
    rows = torch.arange(len(e))[:, None]
    key = (rows * 2 + fg.long()) * 2048 + torch.clamp_max((e * 2048).long(), 2047)
    cnt = torch.bincount(key.reshape(-1), minlength=len(e) * 4096).double().reshape(-1, 2, 2048)
    zero = torch.zeros_like(cnt[:, 0])
    _, _, g_fg, g_bg = losses_and_tables(torch.stack([cnt[:, 1], cnt[:, 0], zero, zero], -1))
    present = fg.any(1).double().reshape(-1, c)
    weight = torch.ones(c, dtype=torch.float64)
    if consider not in (None, "present", "all"):
        weight = torch.zeros(c, dtype=torch.float64)
        weight[list(consider)] = 1.0
    weight = weight * (present if consider != "all" else torch.ones_like(present))
    ct = (weight / weight.sum(-1, keepdim=True).clamp_min(1.0) / len(weight)).reshape(-1)
    table = (torch.stack([g_bg, g_fg], 1) * ct[:, None, None]).to(torch.bfloat16).double()
    de = table.reshape(-1)[key]
    dp = torch.where(e > 0, torch.where(fg, -de, de), 0.0).reshape(p.shape)
    grad = p * (dp - (p * dp).sum(1, keepdim=True))
    return (grad.reshape(n, c, h, w) if per_image else
            grad.reshape(c, n, h, w).transpose(0, 1)).numpy()


@pytest.mark.parametrize("consider,ignore,per_image", BUCKET_CASES)
def test_route_matches_jax_value_and_grad(consider, ignore, per_image, spy):
    """Values within 1e-5 of JAX's; the port's and JAX's float32 gradients
    each within ROUTE_F32_REL of the float64 route's (read against each
    other they agree to 1.5e-7 where they make every choice alike, and a
    state of the process moved the port's once by 1.24e-5)."""
    logits, labels = seg_inputs()
    kw = dict(classes_to_consider=consider, classes_to_ignore=ignore,
              per_image=per_image, impl="bucket")
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda lg: jax_lovasz_softmax(lg, jnp.asarray(labels), **kw)))(jnp.asarray(logits))
    x = nchw(logits).requires_grad_(True)
    v = lovasz_softmax(x, torch.from_numpy(labels), **kw)
    v.backward()
    assert spy == {"bucket_dlogits": 1, "bucket_grad": 0}
    assert abs(float(v) - float(want_v)) <= 1e-5
    ref = route64(logits, labels, consider, ignore, per_image)
    assert rel_l2(x.grad.numpy(), ref) <= ROUTE_F32_REL
    assert rel_l2(np.asarray(want_g).transpose(0, 3, 1, 2), ref) <= ROUTE_F32_REL


@pytest.mark.parametrize("ignore", [None, C])
def test_two_scale_route_matches_jax(ignore, spy):
    li, labels = seg_inputs(1)
    lf, _ = seg_inputs(2)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda a, b: jax_two_scale(a, b, jnp.asarray(labels), 0.4, 1.0,
                                   classes_to_ignore=ignore, impl="bucket"),
        argnums=(0, 1)))(jnp.asarray(li), jnp.asarray(lf))
    a, b = (nchw(t).requires_grad_(True) for t in (li, lf))
    v = fused_two_scale_lovasz(a, b, torch.from_numpy(labels), 0.4, 1.0,
                               classes_to_ignore=ignore, impl="bucket")
    v.backward()
    assert spy == {"bucket_dlogits": 2, "bucket_grad": 0}
    assert abs(float(v) - float(want_v)) <= 1e-5
    for t, w in ((a, want_g[0]), (b, want_g[1])):
        assert rel_l2(t.grad.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= 1e-5


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.float() - want.float()).abs() / chip_smoke.bf16_ulp(want)).max())


def within_bf16(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Two float32 VJPs of another order of operations, each rounded to
    bf16: within the float32 gate (1e-5 of the largest element) and one
    bf16 ulp. Where a pixel's terms cancel, an ulp of the terms is many
    bf16 ulps of the result."""
    err = (got.float() - want.float()).abs()
    return bool((err <= chip_smoke.bf16_ulp(want) + 1e-5 * want.float().abs().max()).all())


@pytest.mark.parametrize("consider,ignore,per_image", BUCKET_CASES)
def test_route_matches_the_parents_composition(consider, ignore, per_image):
    logits, labels = seg_inputs(4)
    lbl = torch.from_numpy(labels)
    kw = dict(classes_to_consider=consider, classes_to_ignore=ignore, per_image=per_image)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, fn in (("new", lambda x: lovasz_softmax(x, lbl, impl="bucket", **kw)),
                         ("parent", lambda x: parent_lovasz_softmax(x, lbl, **kw))):
            x = nchw(logits).to(dtype).requires_grad_(True)
            v = fn(x)
            v.backward()
            grads[name, dtype] = (float(v), x.grad)
    (v_new, g_new), (v_par, g_par) = grads["new", torch.float32], grads["parent", torch.float32]
    assert v_new == v_par
    assert g_new.dtype == torch.float32 and rel_l2(g_new.numpy(), g_par.numpy()) <= 1e-6
    (v_new, g_new), (v_par, g_par) = grads["new", torch.bfloat16], grads["parent", torch.bfloat16]
    assert v_new == v_par and g_new.dtype == torch.bfloat16
    assert within_bf16(g_new, g_par)


def test_float64_logits_take_the_float32_route():
    """Logits of another type go through B4f as float32, which the errors
    are computed in, and their gradient comes back in their type."""
    logits, labels = seg_inputs(5)
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = nchw(logits).to(dtype).requires_grad_(True)
        lovasz_softmax(x, torch.from_numpy(labels), impl="bucket").backward()
        out[dtype] = x.grad
    assert out[torch.float64].dtype == torch.float64
    assert torch.equal(out[torch.float64], out[torch.float32].double())


def saved_bytes(fn, x: torch.Tensor) -> int:
    """Bytes autograd keeps for the backward of fn()'s graph besides the
    logits `x` (every saved tensor counted once by storage)."""
    seen = {}

    def pack(t):
        if t.untyped_storage().data_ptr() != x.untyped_storage().data_ptr():
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_route_keeps_two_fewer_float32_row_tensors():
    """The parent's autograd through `lovasz_rows` keeps the probabilities
    and fg - p, two float32 (R, P) tensors, besides what the new route
    keeps besides the logits (the errors, flags and bucket gradients)."""
    logits, labels = seg_inputs(6, n=2, c=5, h=48, w=80)
    lbl = torch.from_numpy(labels)
    x = nchw(logits).requires_grad_(True)
    new = saved_bytes(lambda: lovasz_softmax(x, lbl, impl="bucket"), x)
    parent = saved_bytes(lambda: parent_lovasz_softmax(x, lbl), x)
    r_p = 5 * 2 * 48 * 80
    assert parent - new >= 2 * 4 * r_p


# ---------------------------------------------------------------------------
# B4f: a model of the kernel's walk
# ---------------------------------------------------------------------------

def b4f_walk(plan: bg.B4fPlan, errors_t, fg_t, table, logits):
    """B4f as the kernel computes it, block by block and tile by tile, in
    float32: (the gradient, how often each element was written, the bucket
    id read at each (row, column), how often each error was read)."""
    n, c, h, w = logits.shape
    hw = h * w
    z_all = logits.float().reshape(n, c, hw)
    tbl = table.to(torch.bfloat16).view(torch.int16).reshape(-1, 2, 2048)
    out = torch.zeros(n, c, hw, dtype=torch.float32)
    writes = torch.zeros(n, c, hw, dtype=torch.int64)
    ids = torch.full(errors_t.shape, -9, dtype=torch.int32)
    reads = torch.zeros(errors_t.shape, dtype=torch.int64)
    for block in range(plan.ctas):
        for seg, img, first in plan.block_work(block):
            px = torch.arange(first, min(first + plan.layout.tile_px, hw))
            rows = torch.arange(c) + (seg * c if plan.per_image else 0)
            cols = px if plan.per_image else img * hw + px
            e = errors_t[rows[:, None], cols[None, :]]
            f = fg_t[rows[:, None], cols[None, :]]
            b = torch.clamp_max((e * np.float32(2048)).to(torch.int32), 2047)
            ids[rows[:, None], cols[None, :]] = b
            reads[rows[:, None], cols[None, :]] += 1
            bits = tbl[rows[:, None], f.long(), b.clamp_min(0).long()].int() & 0xFFFF
            h16 = torch.where((e > 0) & (b >= 0), bits ^ torch.where(f, 0x8000, 0),
                              0).to(torch.int32)
            dp = (h16 << 16).view(torch.float32)
            z = z_all[img][:, px]
            m = z.max(0).values
            ez = torch.exp(z - m)
            s_exp = torch.zeros_like(m)
            for k in range(c):          # the kernel's ascending sums
                s_exp = s_exp + ez[k]
            p = ez / s_exp
            s = torch.zeros_like(m)
            for k in range(c):
                s = s + dp[k] * p[k]
            out[img][:, px] = p * (dp - s)
            writes[img][:, px] += 1
    return out.reshape(n, c, h, w).to(logits.dtype), writes, ids, reads


def route_inputs(n, c, h, w, per_image, ignore, dtype, seed=7):
    logits, labels = seg_inputs(seed, n, c, h, w, std=3.0)
    x = nchw(logits).to(dtype)
    lbl = torch.from_numpy(labels)
    e, fg, present = lovasz_rows(x, lbl, ignore, per_image)
    e, fg = e.contiguous(), fg.contiguous()
    _, _, g_fg, g_bg = losses_and_tables(bucket_histogram_plain(e, fg))
    ct = chip_smoke.loss_cotangent(present, n, per_image)
    return e, fg, grad_table(g_fg, g_bg, ct), x


@pytest.mark.parametrize("c,per_image,dtype,tile_px,resident", [
    (5, False, torch.float32, 64, 7),
    (5, True, torch.float32, 96, 1),
    (5, True, torch.bfloat16, 64, 132),
    (17, False, torch.bfloat16, 128, 264),
    (17, True, torch.float32, 32, 5),
    (27, True, torch.float32, 64, 3),      # the global-memory instance
])
def test_fused_walk_model_matches_plain(c, per_image, dtype, tile_px, resident):
    n, h, w = 3, 20, 36
    e, fg, table, x = route_inputs(n, c, h, w, per_image, c, dtype)
    layout = bg.b4f_layout(c, tile_px=tile_px)
    assert layout.table_smem == (c <= bg.SMEM_CLASSES)
    plan = bg.b4f_plan(layout, n, h * w, per_image, resident=resident)
    got, writes, ids, reads = b4f_walk(plan, e, fg, table, x)
    assert (writes == 1).all() and (reads == 1).all()
    assert torch.equal(ids, bucket_ids(e))
    want = bucket_dlogits_plain(e, fg, table, x, per_image)
    if dtype == torch.float32:
        assert rel_l2(got.numpy(), want.numpy()) <= 1e-6
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        assert bf16_ulps(got, want) <= 1.0
    # ignored pixels (label c) have no gradient
    lbl = torch.from_numpy(seg_inputs(7, n, c, h, w)[1])
    assert not got.float().permute(1, 0, 2, 3)[:, lbl == c].any()


@pytest.mark.parametrize("case", chip_smoke.B4F_CASES)
def test_fused_plan_at_every_phase10_shape(case):
    n, h, w = chip_smoke.B3_CELL
    if case == "classes_to_ignore":
        n, h, w = n // 4, h // 2, w // 2
    per_image = case == "per_image_136"
    layout = bg.b4f_layout(17)
    assert (layout.table_smem, layout.threads, layout.smem) == (True, 1024, 139_264)
    assert bg.fused_instance_maxc(17) == 17
    for resident in RESIDENT:
        plan = bg.b4f_plan(layout, n, h * w, per_image, resident=resident)
        check_fused_plan(plan, resident)


def check_fused_plan(plan: bg.B4fPlan, resident: int):
    layout = plan.layout
    assert layout.smem <= SMEM_OPT_IN and layout.threads % 32 == 0
    assert layout.threads <= bg.fused_max_threads(layout.n_cls, layout.table_smem)
    assert 1 <= plan.ctas <= max(resident, 1) and plan.ctas % plan.per_seg == 0
    if not plan.per_image:
        assert plan.per_seg == plan.ctas and plan.n_segs == 1
    seen = np.zeros((plan.n, plan.tiles_per_img), np.int64)
    for block in range(plan.ctas):
        work = plan.block_work(block)
        assert work
        for seg, img, first in work:
            assert first % layout.tile_px == 0 and 0 <= first < plan.hw
            if plan.per_image:
                assert seg == img
            seen[img, first // layout.tile_px] += 1
        # per image, a block loads one table per image it walks, and one in
        # all where the wave holds a block for every image
        if plan.per_image and plan.ctas // plan.per_seg >= plan.n:
            assert len({seg for seg, _, _ in work}) <= 1
    assert (seen == 1).all()


@pytest.mark.parametrize("per_image", (False, True))
def test_fused_plan_sweep(per_image):
    for c in range(1, 33):
        layout = bg.b4f_layout(c)
        assert layout.table_smem == (c <= 25)
        maxc = bg.fused_instance_maxc(c, layout.table_smem)
        assert maxc == (32 if not layout.table_smem else 17 if c == 17
                        else next(m for m in (8, 16, 24, 32) if c <= m))
        assert layout.threads == (1024 if maxc <= 17 else 512)
        for n in (1, 8, 64):
            for resident in RESIDENT:
                check_fused_plan(bg.b4f_plan(layout, n, 37 * 53, per_image,
                                             resident=resident), resident)
    with pytest.raises(ValueError):
        bg.b4f_layout(26, table_smem=True)
    with pytest.raises(ValueError):
        bg.b4f_layout(17, threads=2048)
    with pytest.raises(ValueError):
        bg.b4f_layout(33)


def test_model_shapes_take_one_wave():
    """At the cell on an H100 (132 SMs, one 139 KB block of 1024 threads
    each): 132 blocks over the 8 x 255 tiles; per image 16 blocks an image,
    128 in all, each loading its image's table once."""
    layout = bg.b4f_layout(17)
    plan = bg.b4f_plan(layout, 8, 544 * 960, False, resident=132)
    assert (plan.ctas, plan.per_seg, plan.tiles_per_img) == (132, 132, 255)
    plan = bg.b4f_plan(layout, 8, 544 * 960, True, resident=132)
    assert (plan.ctas, plan.per_seg) == (128, 16)
    assert all(len({s for s, _, _ in plan.block_work(b)}) == 1 for b in range(plan.ctas))
    g = bg.b4_plan(17, 8 * 544 * 960, 1056)
    assert (g.per_row, g.chunk, g.threads) == (62, 16_864, 256)


# ---------------------------------------------------------------------------
# B4: a model of the gather's walk
# ---------------------------------------------------------------------------

def gather_walk(plan: bg.B4Plan, p: int, a_e: int, a_f: int, a_o: int):
    """The pixels each block of a row takes, as csrc/bucket_grad.cu's
    `bucket_gather_kernel` walks them:
    {block: [(first pixel, pixel count, kind)]} with kind "vector" (a run
    of whole float4 vectors), "head", "tail" or "scalar". `a_e`, `a_o`:
    the row's errors and gradient addresses in floats mod 4; `a_f`: its
    flags' address in bytes mod 4."""
    aligned = a_e == a_o == a_f
    head = min((4 - a_e) & 3, p) if aligned else 0
    n_vec = (p - head) >> 2
    out = {}
    for b in range(plan.per_row):
        first = b * plan.chunk
        runs = []
        if aligned:
            v_end = min(first + plan.chunk, n_vec)
            if v_end > first:
                runs.append((head + 4 * first, 4 * (v_end - first), "vector"))
            if b == 0 and head:
                runs.append((0, head, "head"))
            tail = p - head - 4 * n_vec
            if b == plan.per_row - 1 and tail:
                runs.append((head + 4 * n_vec, tail, "tail"))
        else:
            hi = min(4 * (first + plan.chunk), p)
            if hi > 4 * first:
                runs.append((4 * first, hi - 4 * first, "scalar"))
        out[b] = runs
    return out


def gather_model(plan: bg.B4Plan, e, fg, table, offsets):
    """B4 as the kernel walks each row of a contiguous (R, P) view whose
    errors, flags and gradient start `offsets` = (floats, bytes, floats)
    into 16-byte aligned storage: (the gradient, writes per pixel, the set
    of paths taken)."""
    r_rows, p = e.shape
    tbl = table.to(torch.bfloat16).to(torch.float32)
    out = torch.full(e.shape, float("nan"))
    writes = torch.zeros(e.shape, dtype=torch.int64)
    kinds = set()
    for r in range(r_rows):
        a_e, a_f, a_o = ((o + r * p) % 4 for o in offsets)
        for runs in gather_walk(plan, p, a_e, a_f, a_o).values():
            for first, count, kind in runs:
                kinds.add(kind)
                if kind == "vector":
                    assert (a_e + first) % 4 == 0 and count % 4 == 0
                    assert (a_f + first) % 4 == 0 and (a_o + first) % 4 == 0
                sl = slice(first, first + count)
                b = bucket_ids(e[r, sl])
                out[r, sl] = torch.where(b >= 0, tbl[r, fg[r, sl].long(), b.clamp_min(0).long()],
                                         0.0)
                writes[r, sl] += 1
    return out, writes, kinds


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8, 129, 130, 131, 132, 1001])
def test_gather_walk_at_every_alignment(p):
    rng = np.random.default_rng(p)
    r_rows = 3
    e = torch.from_numpy(rng.random((r_rows, p), dtype=np.float32) * 1.1 - 0.01)
    fg = torch.from_numpy(rng.random((r_rows, p)) < 0.3)
    table = torch.from_numpy(rng.standard_normal((r_rows, 2, 2048)).astype(np.float32))
    want = bucket_gather_plain(e, fg, table)
    plans = {bg.b4_plan(r_rows, p, res) for res in (1, 3, 64)}
    plans.add(bg.b4_plan(r_rows, p, 0, per_row=3))
    all_kinds = set()
    for plan in plans:
        assert 4 * plan.per_row * plan.chunk >= p and plan.chunk % 32 == 0
        for offsets in itertools.product(range(4), repeat=3):
            got, writes, kinds = gather_model(plan, e, fg, table, offsets)
            assert (writes == 1).all(), (plan, offsets)
            assert torch.equal(got, want), (plan, offsets)
            if len(set(offsets)) > 1:    # no row's three line up
                assert kinds == {"scalar"}
            all_kinds |= kinds
    assert "scalar" in all_kinds and ("vector" in all_kinds) == (p >= 4)


@pytest.mark.parametrize("case", chip_smoke.B3_CASES)
def test_gather_plan_at_every_phase9_shape(case):
    """One wave at every B3 case's (R, P) on an H100 (1056 resident blocks
    of 256 threads, 8 an SM) and other counts; 32-bit in-row indices; and
    phase 10's views reach the paths they are there for: `misaligned` the
    scalar path, `p_odd` heads of every length and tails."""
    if case in chip_smoke.B4F_CASES:
        n, h, w = chip_smoke.B3_CELL
        if case == "classes_to_ignore":
            n, h, w = 2, h // 2, w // 2
        r_rows, p = (n * 17, h * w) if case == "per_image_136" else (17, n * h * w)
    else:
        r_rows, p = chip_smoke.B3_ROWS.get(case, chip_smoke.B3_ROWS["other"])
    for resident in RESIDENT:
        plan = bg.b4_plan(r_rows, p, resident)
        assert 4 * plan.per_row * plan.chunk >= p > 4 * (plan.per_row - 1) * plan.chunk
        assert 4 * plan.per_row * plan.chunk < 2 ** 31 and plan.chunk % 32 == 0
        if resident >= r_rows:
            assert plan.per_row * r_rows <= resident
    plan = bg.b4_plan(r_rows, p, 1056)
    if case == "misaligned":        # errors 1 float, flags 2 bytes into storage
        assert all(run[2] == "scalar" for r in range(r_rows)
                   for runs in gather_walk(plan, p, (1 + r * p) % 4, (2 + r * p) % 4,
                                              (r * p) % 4).values() for run in runs)
    if case == "p_odd":
        heads = {min((4 - r * p % 4) & 3, p) for r in range(r_rows)}
        assert heads == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# the C entries, the wrappers and the ablation
# ---------------------------------------------------------------------------

CTYPE = {"int": "c_int", "float": "c_float", "void*": "c_void_p"}


@pytest.mark.parametrize("entry", ["bucket_grad_bwd", "bucket_grad_resident",
                                   "bucket_dlogits_bwd", "bucket_dlogits_resident"])
def test_ctypes_declarations_match_the_c_entries(entry):
    import ctypes

    src = (build.CSRC / "bucket_grad.cu").read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    want = []
    for param in params.split(","):
        words = param.replace("*", " * ").split()
        if "*" in words:
            want.append("ptr" if param.strip().startswith("int*") else "c_void_p")
        else:
            want.append(CTYPE[words[-2]])

    class Fake:
        pass

    for name in ("bucket_grad_bwd", "bucket_grad_resident", "bucket_dlogits_bwd",
                 "bucket_dlogits_resident"):
        setattr(Fake, name, type("F", (), {})())
    bg.set_argtypes(Fake)
    got = [t.__name__ if t is not ctypes.POINTER(ctypes.c_int) else "ptr"
           for t in getattr(Fake, entry).argtypes]
    assert got == want


def test_cpu_wrappers_are_the_plain_versions():
    e, fg, table, x = route_inputs(2, 5, 8, 12, True, None, torch.float32)
    before = launch_counts()
    assert torch.equal(bucket_dlogits(e, fg, table, x, per_image=True),
                       bucket_dlogits_plain(e, fg, table, x, True))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        bucket_dlogits._launch(e, fg, table, x, True)


def test_fused_checks_refuse_what_the_kernel_does_not_take():
    e, fg, table, x = route_inputs(2, 5, 8, 12, False, None, torch.float32)
    bg.check_fused(e, fg, table, x, False)
    bg.check_fused(e, fg, table, x.bfloat16(), False)
    with pytest.raises(TypeError):
        bg.check_fused(e, fg, table, x.double(), False)
    with pytest.raises(ValueError):
        bg.check_fused(e, fg, table, x.transpose(2, 3), False)
    with pytest.raises(ValueError):
        bg.check_fused(e, fg, table, x, True)               # (N*C, HW) rows expected
    with pytest.raises(ValueError):
        bg.check_fused(e, fg, table[:, :, :1024].contiguous(), x, False)
    with pytest.raises(ValueError):
        bg.check_fused(e, fg, table, x[:, :4].contiguous(), False)


def test_plain_gather_reads_the_table_as_bf16():
    """As the TPU kernel (`tbl_ref.astype(bfloat16)`) and the CUDA kernel's
    shared copy do: a float32 table gathers its bf16 rounding, and the
    loss's table (`grad_table`) is bf16-valued already."""
    e = torch.tensor([[0.0, 0.5, 0.9999, -0.25]])
    fg = torch.tensor([[False, True, True, False]])
    table = torch.full((1, 2, 2048), 1.0 + 2.0 ** -12)
    assert torch.equal(bucket_gather_plain(e, fg, table), torch.tensor([[1.0, 1.0, 1.0, 0.0]]))
    g = torch.randn(1, 2048)
    t = grad_table(g, g, torch.ones(1))
    assert torch.equal(t.to(torch.bfloat16).float(), t)


def test_ablation_edits_match_the_source():
    texts = bucket_grad_ablation.edited_sources()
    assert set(texts) == set(bucket_grad_ablation.EDITS)
    src = (build.CSRC / "bucket_grad.cu").read_text()
    for name, text in texts.items():
        assert text != src
        for o, c in ("{}", "()"):     # the edits keep the source's balance
            assert text.count(o) - text.count(c) == src.count(o) - src.count(c), name
    assert "fill_table(tbl, gtbl, bk::kBins);" not in texts["table_global"]
    assert "constexpr int kGatherVecs = 1;" in texts["one_vector"]
    assert "z[c] = prob;" not in texts["reread_logits"]
    # the model path's instance: exact C 17 with the tables in shared memory
    assert "bucket_dlogits_kernel<17, true, true, T>" in src
