"""B6/B8's launch plan (kernels/nchw_grad.py `nchw_grad_layout`,
`nchw_grad_plan`) and a float32 torch model of the kernel's walk
(csrc/nchw_grad.cu).

The kernel runs only on the card; what surrounds it is held here:
  * at every NCHW_CASES shape of chip_smoke.py, and over C 1..32 x B {256,
    512, 1024, 2048} x one or two scales x N up to 64: the table sits in
    shared memory wherever a scale's bf16 rows fit the 232,448 bytes a
    block may opt into, and the instance that gathers from global memory
    runs exactly where they do not (C > 28 at B 2048); the block's shared
    memory fits; each (image, tile) of the whole padded grid is walked by
    exactly one block per scale, and the tiles cover every pixel once;
  * the walk: the tiles of each block, warps of 32 pixels none of which
    counts writing zeros and loading no logit, the bf16 table, dp as bf16,
    the sum over the classes in ascending order and the softmax VJP: equal
    bit for bit to `nchw_grad_plain` on seeded fields, with labels live in
    the pad lanes past w_real, an all-ignored image, adaptive edges, B 256
    and the global-memory instance;
  * a `grad_table` output survives the kernel's bf16 copy unchanged;
  * the ctypes declarations match the C entries' parameter lists, the
    per-pixel loop divides no 64-bit index, and the ablation tool's edits
    still match the committed source.
"""
import re

import numpy as np
import pytest
import torch

import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import nchw_grad as ng
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    nchw_fields)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    grad_table, losses_and_tables)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
    counts_to_hist)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import nchw_grad_ablation

SMEM_OPT_IN = 232_448
# blocks the card may hold at once: an H100's 132 SMs at one to eight
# blocks each, and a small count that makes each block walk many tiles
RESIDENT = (7, 132, 264, 396, 1056)


def padded(h, w):
    return -(-h // 8) * 8, -(-w // 128) * 128


def check_plan(plan: ng.NchwGradPlan, n_cls: int, walk: bool = True):
    layout = plan.layout
    fits = 4 * n_cls * layout.n_buckets <= SMEM_OPT_IN
    if layout.table_smem:
        assert fits and layout.smem == 4 * n_cls * layout.n_buckets
    else:
        assert layout.smem == 0
    assert layout.smem <= SMEM_OPT_IN
    assert layout.threads % 32 == 0
    assert layout.threads <= ng.max_threads(n_cls, layout.table_smem)
    assert layout.tile_px % 32 == 0 and (1 << layout.tile_w_log2) >= 32
    assert 1 <= plan.ctas_x <= plan.n_tiles
    # the tiles cover the whole padded grid
    assert plan.tiles_h * layout.tile_h >= plan.h_pad > (plan.tiles_h - 1) * layout.tile_h
    tile_w = 1 << layout.tile_w_log2
    assert plan.tiles_w * tile_w >= plan.w_pad > (plan.tiles_w - 1) * tile_w
    if walk:
        tiles = np.concatenate([np.asarray(plan.block_tiles(j), dtype=np.int64)
                                for j in range(plan.ctas_x)])
        np.testing.assert_array_equal(np.sort(tiles), np.arange(plan.n_tiles))


@pytest.mark.parametrize("case", chip_smoke.NCHW_CASES, ids=lambda c: c[0])
def test_plan_at_every_nchw_case(case):
    name, scales, n, c, _, (h, w), nb, *_ = case
    h_pad, w_pad = padded(h, w)
    layout = ng.nchw_grad_layout(c, nb, w_pad)
    assert layout.table_smem                        # every case's table fits
    for s in scales:
        for resident in RESIDENT:
            plan = ng.nchw_grad_plan(layout, n, s, h_pad, w_pad, w, resident=resident)
            check_plan(plan, c)
            # every pixel of the padded grid lies in exactly one tile
            covered = np.zeros((n, plan.tiles_h * layout.tile_h,
                                plan.tiles_w << layout.tile_w_log2), np.int64)
            per_img = plan.tiles_h * plan.tiles_w
            for t in range(plan.n_tiles):
                img, rem = divmod(t, per_img)
                ty, tx = divmod(rem, plan.tiles_w)
                covered[img, ty * layout.tile_h:(ty + 1) * layout.tile_h,
                        tx << layout.tile_w_log2:(tx + 1) << layout.tile_w_log2] += 1
            assert (covered == 1).all()


@pytest.mark.parametrize("scales", (1, 2))
@pytest.mark.parametrize("n_buckets", (256, 512, 1024, 2048))
def test_plan_sweep(n_buckets, scales):
    for c in range(1, 33):
        layout = ng.nchw_grad_layout(c, n_buckets, 1024)
        assert layout.table_smem == (4 * c * n_buckets <= SMEM_OPT_IN)
        for n in (1, 8, 64):
            for resident in RESIDENT:
                plan = ng.nchw_grad_plan(layout, n, scales, 544, 1024, 960,
                                         resident=resident)
                check_plan(plan, c, walk=n == 1)
                assert plan.ctas_x == min(max(resident // scales, 1), plan.n_tiles)
    # only C > 28 at B 2048 gathers from global memory, on the C 32 instance
    glob = {c for c in range(1, 33) if not ng.nchw_grad_layout(c, n_buckets, 1024).table_smem}
    assert glob == (set(range(29, 33)) if n_buckets == 2048 else set())
    for c in glob:
        assert ng.instance_maxc(c, False) == 32 and ng.max_threads(c, False) == 512


def test_model_shapes_take_one_wave():
    """The flagship (two scales, B 1024: a 70 KB table, one block of 1024
    an SM) and the DeepLabv3 cell (one scale, B 2048: 139 KB, one block of
    1024) on the C 17 instance, one wave over 8 x 272 tiles of two whole
    rows a scale."""
    b1024 = ng.nchw_grad_layout(17, 1024, 1024)
    assert (b1024.table_smem, b1024.threads, b1024.smem) == (True, 1024, 69_632)
    assert ng.instance_maxc(17) == 17 and ng.max_threads(17) == 1024
    assert (b1024.tile_h, b1024.tile_w_log2) == (2, 10)        # two whole rows
    plan = ng.nchw_grad_plan(b1024, 8, 2, 544, 1024, 960, resident=132)
    assert plan.ctas_x == 66 and plan.n_tiles == 8 * 272
    b2048 = ng.nchw_grad_layout(17, 2048, 1024)
    assert (b2048.table_smem, b2048.threads, b2048.smem) == (True, 1024, 139_264)
    plan = ng.nchw_grad_plan(b2048, 8, 1, 544, 1024, 960, resident=132)
    assert plan.ctas_x == 132
    # columns past w_real are walked too: their gradient is written (zeros)
    assert plan.tiles_w == 1 and plan.tiles_h * b2048.tile_h == 544
    tiny = ng.nchw_grad_plan(ng.nchw_grad_layout(17, 2048, 128), 1, 2, 8, 128, 125,
                             resident=264)
    assert tiny.ctas_x == tiny.n_tiles == 1


def test_default_tiles_are_whole_rows():
    assert ng.grad_tile(1024) == (2, 10)
    assert ng.grad_tile(256) == (8, 8) and ng.grad_tile(128) == (16, 7)
    assert ng.grad_tile(1920) == (2, 10)        # two tiles a row
    assert ng.grad_tile(32) == (64, 5) and ng.grad_tile(1) == (64, 5)
    for w_pad in (32, 96, 128, 256, 640, 1024, 1920, 4096):
        h, log2 = ng.grad_tile(w_pad)
        assert h << log2 == ng.TILE_PX
        assert (1 << log2) >= min(w_pad, 1024) and (log2 == 5 or (1 << log2) < 2 * w_pad)


def test_layout_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(33, 1024, 1024)
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(17, 0, 1024)
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(32, 2048, 1024, table_smem=True)      # 262 KB in one block
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(25, 1024, 1024, threads=1024)         # the C 32 instance: 512
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(17, 1024, 1024, table_smem=False, threads=1024)
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(17, 1024, 1024, threads=48)
    with pytest.raises(ValueError):
        ng.nchw_grad_layout(17, 1024, 1024, tile_w_log2=4)        # a tile row under a warp
    with pytest.raises(ValueError):
        ng.nchw_grad_plan(ng.nchw_grad_layout(5, 256, 1024), 1, 1, 8, 128, 130, resident=4)
    assert ng.nchw_grad_layout(17, 1024, 1024, table_smem=False).smem == 0


def walk_model(grids, labels, table, plan: ng.NchwGradPlan, edges: str):
    """What the kernel computes, step by step in float32 torch: per scale
    and block, the tiles of its stream and their pixels; a warp of 32
    pixels none of which counts writes zeros and loads nothing; a live
    warp's counted pixels gather de from the bf16 copy of their scale's
    table rows, keep dp as bf16 bits, sum dp * p over the classes in
    ascending order and write p * (dp - sum); its other pixels write 0.
    Returns the gradients, how many times each element was written, and
    the logits loaded and zero-written dead warps."""
    layout = plan.layout
    n, n_cls, h_pad, w_pad = grids[0].shape
    nb, w_real = layout.n_buckets, plan.w_real
    p, fg, keep, bid = nchw_fields(grids, labels, n_buckets=nb, edges=edges,
                                   w_real=w_real)
    copy = table.to(torch.bfloat16)                        # the shared copy
    outs = [torch.full_like(g, float("nan")) for g in grids]
    writes = [torch.zeros(g.shape, dtype=torch.int64) for g in grids]
    k = torch.arange(layout.tile_px)
    slot_y = k >> layout.tile_w_log2
    slot_x = k & ((1 << layout.tile_w_log2) - 1)
    loads = dead_warps = 0
    for s in range(plan.n_scales):
        rows = copy[s * n_cls:(s + 1) * n_cls]             # (C, 2, B)
        for block in range(plan.ctas_x):
            for t in plan.block_tiles(block):
                img, rem = divmod(t, plan.tiles_h * plan.tiles_w)
                ty, tx = divmod(rem, plan.tiles_w)
                y = ty * layout.tile_h + slot_y
                x = (tx << layout.tile_w_log2) + slot_x
                inside = (y < h_pad) & (x < w_pad)
                yc, xc = y.clamp(max=h_pad - 1), x.clamp(max=w_pad - 1)
                lbl = torch.where((y < h_pad) & (x < w_real), labels[img, yc, xc].long(),
                                  torch.tensor(-1))
                counted = lbl >= 0
                live = counted.reshape(-1, 32).any(1).repeat_interleave(32)
                dead_warps += int((~counted.reshape(-1, 32).any(1)).sum())
                loads += int(counted.sum()) * n_cls
                # dead warps and uncounted lanes write zeros
                zero = inside & ~(live & counted)
                outs[s][img, :, y[zero], x[zero]] = 0.0
                writes[s][img, :, y[zero], x[zero]] += 1
                yy, xx = y[counted], x[counted]
                pp = p[img, s, :, yy, xx]                   # (C, P)
                f = fg[img, :, yy, xx]
                b = bid[img, s, :, yy, xx]
                cls = torch.arange(n_cls)[:, None]
                de_bits = rows[cls, f.long(), b].view(torch.int16)
                dp_bits = torch.where(f, de_bits ^ torch.tensor(-0x8000, dtype=torch.int16),
                                      de_bits)                  # the sign bit flipped
                dp = dp_bits.view(torch.bfloat16).float()
                acc = torch.zeros(pp.shape[1])
                for c in range(n_cls):
                    acc = acc + dp[c] * pp[c]
                outs[s][img, :, yy, xx] = pp * (dp - acc)
                writes[s][img, :, yy, xx] += 1
    return outs, writes, loads, dead_warps


WALK_CASES = {
    # N, C, (H, W_pad), w_real, B, edges, scales, layout keywords, resident;
    # labels live in the pad lanes past w_real
    "live_pad_w125": (2, 5, (13, 128), 125, 256, "uniform", 2, {}, 5),
    "live_pad_w96": (2, 7, (9, 128), 96, 512, "uniform", 1, {}, 4),
    "all_ignore_image": (2, 5, (13, 128), 128, 256, "uniform", 2, {}, 6),
    "adaptive": (1, 7, (9, 64), 61, 512, "adaptive", 2, {}, 6),
    "b256_c17": (1, 17, (6, 64), 64, 256, "uniform", 2, {}, 6),
    "c17_one_scale": (2, 17, (5, 64), 50, 1024, "uniform", 1, {}, 3),
    "global_instance": (1, 7, (9, 64), 61, 256, "uniform", 2, dict(table_smem=False), 12),
}


@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_model_equals_nchw_grad_plain(name):
    n, c, (h, w_pad), w_real, nb, edges, scales, layout_kw, resident = WALK_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    lbl = rng.integers(-1, c + 1, (n, h, w_pad)).astype(np.int32)
    lbl[:, ::3, :32] = -1                   # warps none of whose pixels counts
    if name == "all_ignore_image":
        lbl[0] = -1
    logits = 3.0 * rng.standard_normal((scales, n, c, h, w_pad))
    peak = (lbl[:, None] == np.arange(c)[None, :, None, None]) & (rng.random((n, 1, h, w_pad)) < 0.5)
    logits += 15.0 * peak[None]
    grids = [torch.as_tensor(g, dtype=torch.float32) for g in logits]
    labels = torch.as_tensor(lbl)
    counts = torch.as_tensor(rng.integers(0, 50, (scales * c, 2, nb)), dtype=torch.int32)
    _, gts, g_fg, g_bg = losses_and_tables(counts_to_hist(counts, nb, edges))
    table = grad_table(g_fg, g_bg, torch.linspace(0.1, 1.0, scales * c))
    layout = ng.nchw_grad_layout(c, nb, w_pad, **dict(dict(threads=64, tile_h=2, tile_w_log2=5),
                                               **layout_kw))
    plan = ng.nchw_grad_plan(layout, n, scales, h, w_pad, w_real, resident=resident)
    check_plan(plan, c)
    assert plan.ctas_x > 1 and plan.n_tiles > plan.ctas_x     # blocks walk many tiles
    got, writes, loads, dead = walk_model(grids, labels, table, plan, edges)
    want = ng.nchw_grad_plain(grids, labels, table, n_buckets=nb, edges=edges,
                              w_real=w_real)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # every element written once; no logit loaded for a pixel that does not
    # count; zeros on every uncounted pixel
    assert all(bool((wr == 1).all()) for wr in writes)
    _, _, keep, _ = nchw_fields(grids, labels, n_buckets=nb, edges=edges, w_real=w_real)
    assert loads == scales * c * int(keep.sum())
    assert dead > 0
    for g in got:
        assert float(g.abs().sum(1)[~keep].sum()) == 0.0


def test_grad_table_survives_the_bf16_copy():
    """The kernel keeps the table as bf16 (rounding to nearest): on a
    `grad_table` output that copy is the identity."""
    rng = np.random.default_rng(12)
    for nb, rows in ((256, 10), (1024, 34), (2048, 17)):
        counts = torch.as_tensor(rng.integers(0, 3000, (rows, 2, nb)), dtype=torch.int32)
        _, _, g_fg, g_bg = losses_and_tables(counts_to_hist(counts, nb, "uniform"))
        table = grad_table(g_fg, g_bg, torch.as_tensor(rng.random(rows), dtype=torch.float32))
        assert table.abs().sum() > 0
        assert torch.equal(table.to(torch.bfloat16).to(torch.float32), table)


CTYPE = {"int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("entry", ("nchw_grad_bwd", "nchw_grad_resident"))
def test_ctypes_declarations_match_the_c_entries(entry):
    import ctypes

    src = (build.CSRC / "nchw_grad.cu").read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    want = []
    for param in params.split(","):
        ctype = param.split()[-2] if len(param.split()) > 2 else param.split()[0]
        want.append("c_void_p" if "*" in param and entry == "nchw_grad_bwd"
                    else "ptr" if "*" in param else CTYPE[ctype])

    class Fake:
        nchw_grad_bwd = type("F", (), {})()
        nchw_grad_resident = type("F", (), {})()

    ng.set_argtypes(Fake)
    got = [t.__name__ if t is not ctypes.POINTER(ctypes.c_int) else "ptr"
           for t in getattr(Fake, entry).argtypes]
    assert got == want


def test_per_pixel_loop_has_no_64_bit_division():
    """The committed walk divides 32-bit tile coordinates once per tile; the
    parent's 64-bit grid-stride index is only the ablation's edit."""
    src = (build.CSRC / "nchw_grad.cu").read_text()
    body = src[src.index("__device__ __forceinline__ void pixel_grad"):src.index("using Kernel")]
    assert not re.search(r"long long i\b", body) and "% p.w_pad" not in body
    assert not re.search(r"\bi / p(\.)?lane\b", body)
    # the model paths' instance: exact C 17, uniform buckets, shared table
    assert "nchw_grad_kernel<17, true, true, true, BIDS>" in src


def test_ablation_edits_match_the_source():
    texts = nchw_grad_ablation.edited_sources()
    assert set(texts) == set(nchw_grad_ablation.EDITS)
    src = (build.CSRC / "nchw_grad.cu").read_text()
    for name, text in texts.items():
        assert text != src
        assert text.count("{") == text.count("}"), name
        assert text.count("(") == text.count(")"), name
    assert "i % p.w_pad" in texts["grid_stride64"]
    assert "fill_table(tbl, gtbl, rows);" not in texts["table_global"]
    assert "return bf16_bits(__ldg(gtbl + at));" in texts["table_global"]
    assert "reinterpret_cast<const float*>(tbl)[at]" in texts["table_f32"]
    assert "dim3(static_cast<unsigned>(ctas_x), 1u)" in texts["both_scales"]
    assert "__stcs" not in texts["plain_stores"] and "__ldcs" in texts["evict_first_loads"]
    # the variants' layouts: twice the table's bytes, the MAXC 24 instance's
    # 512 threads, the global-memory instance at C 17
    wide = nchw_grad_ablation.WideLayout(17, 1024, True, 1024, 16, 7, 2)
    assert wide.smem == 2 * ng.nchw_grad_layout(17, 1024, 1024).smem <= SMEM_OPT_IN
    assert 2 * ng.nchw_grad_layout(17, 2048, 1024).smem > SMEM_OPT_IN    # B 1024 only
    assert ng.nchw_grad_layout(17, 1024, 1024, threads=512).threads == 512
    assert not ng.nchw_grad_layout(17, 1024, 1024, table_smem=False).table_smem
    for layout_kw in (*nchw_grad_ablation.PLANS.values(), *nchw_grad_ablation.SWEEP.values()):
        layout = ng.nchw_grad_layout(17, 2048, 1024, **layout_kw)
        check_plan(ng.nchw_grad_plan(layout, 8, 1, 544, 1024, 960, resident=132), 17)
