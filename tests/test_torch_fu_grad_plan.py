"""B2's launch plan (kernels/lovasz_grad.py `b2_layout`, `b2_plan`) and a
float64 model of how the kernel (csrc/fu_grad.cu) walks and sums.

The kernel runs only on the card; what surrounds it is held here:
  * at every B1_CASES shape of chip_smoke.py, and over C 1..32 x B {256,
    1024, 2048} x one or two scales: a block's shared memory fits the
    232,448 bytes a block may opt into and its threads the SM's registers
    at the instance's cap; the column chunks cover every source column
    once, each chunk's output columns fit its dz tile and its source
    columns the staged window, which every layout has; the shares cover every source row of a
    scale once, in pieces inside one image, and each piece's output rows
    hold every height tap that reaches it (h_beg/h_end of `fu_mats`);
  * the model: per block, share, piece and chunk, the output rows in
    ascending order, the width taps of each source column, two running
    sums per source column and their flushes, the edge buffer (the upper
    partial sum and at most `row_run` lower terms of each boundary row)
    and the merge at the shares' boundaries, in float64, writes every
    gradient element once and equals `grad_from_fields` within 1e-12
    relative at small shapes of both aligns;
  * the ctypes declarations match the C entries' parameter lists, and the
    ablation tool's edits and variants still match the committed source
    and plan.
"""
import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import lovasz_grad as lg
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import lovasz_hist as lh
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
    pad_labels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import fu_grad_ablation

CPU = torch.device("cpu")
# blocks the card may hold at once: an H100's 132 SMs at one block each,
# and small counts that make shares cross images
RESIDENT = (1, 7, 132, 264)
REGS_PER_SM = 65_536


def padded(h, w):
    return -(-h // 8) * 8, -(-w // 128) * 128


def reach(beg, end, a, b):
    """The kernel's `reach`: output indices [lo, hi) with a tap into the
    source indices [a, b)."""
    f = a
    while f < b and end[f] == 0:
        f += 1
    last = b - 1
    while last >= f and end[last] == 0:
        last -= 1
    return (int(beg[f]), int(end[last])) if f < b else (0, 0)


def check_layout(layout: lg.B2Layout, mats: lh.FuMats):
    ws = len(mats.columns)
    assert layout.smem + lh.STATIC_SMEM <= 232_448
    assert layout.per_sm * (layout.smem + lh.STATIC_SMEM + 1024) <= lh.SMEM_PER_SM
    assert layout.threads % 32 == 0
    assert layout.threads * layout.per_sm <= lh.max_threads(layout.n_cls)
    regs = 64 if lh.max_threads(layout.n_cls) == 1024 else 128
    assert layout.threads * layout.per_sm * regs <= REGS_PER_SM
    assert layout.dz_stride % 32 == 1 and layout.dz_stride > layout.chunk_px
    w_beg, w_end = mats.w_beg.numpy(), mats.w_end.numpy()
    w_lo = mats.w_lo.numpy()
    assert layout.max_taps >= int((w_end - w_beg).max())
    owned = np.zeros(ws, np.int64)
    for k in range(layout.n_chunks):
        s_a = k * layout.chunk_s
        ns = min(ws, s_a + layout.chunk_s) - s_a
        assert ns >= 1
        owned[s_a:s_a + ns] += 1
        x_a, x_b = reach(w_beg, w_end, s_a, s_a + ns)
        assert x_b - x_a <= layout.chunk_px
        for s in range(s_a, s_a + ns):  # every owner's taps lie in the tile
            if w_end[s] > w_beg[s]:
                assert x_a <= w_beg[s] and w_end[s] <= x_b
        assert layout.win_w >= 1  # the kernel always stages its taps
        if x_b > x_a:
            c_a, c_b = w_lo[x_a], min(w_lo[x_b - 1] + 1, ws - 1) + 1
            assert c_b - c_a <= layout.win_w
            taps = np.concatenate([w_lo[x_a:x_b], np.minimum(w_lo[x_a:x_b] + 1, ws - 1)])
            assert c_a <= taps.min() and taps.max() < c_b
    np.testing.assert_array_equal(owned, 1)


def check_plan(plan: lg.B2Plan, mats: lh.FuMats):
    h_beg, h_end, h_lo = mats.h_beg.numpy(), mats.h_end.numpy(), mats.h_lo.numpy()
    hs = plan.hs
    real = (mats.mh != 0).any(1).numpy()
    assert plan.max_run == np.bincount(h_lo[real]).max()  # the edge buffer's terms
    assert 1 <= plan.blocks <= plan.n * hs
    rows = np.concatenate([np.asarray(plan.share(b)) for b in range(plan.blocks)])
    np.testing.assert_array_equal(rows, np.arange(plan.n * hs))
    for b in range(plan.blocks):
        pieces = list(plan.pieces(b))
        assert sum(h1 - h0 for _, h0, h1, _, _ in pieces) == len(plan.share(b))
        for img, h0, h1, _, _ in pieces:
            assert 0 <= img < plan.n and 0 <= h0 < h1 <= hs
            y0, y1 = reach(h_beg, h_end, h0, h1)
            for h in range(h0, h1):  # every height tap into the piece
                if h_end[h] > h_beg[h]:
                    assert y0 <= h_beg[h] and h_end[h] <= y1
            if y1 > y0:  # the walk's running sums: rows cur - 1 .. cur + 1
                assert h_lo[y0] >= h0 - 1 and h_lo[y1 - 1] <= h1 - 1


@pytest.mark.parametrize("case", chip_smoke.B1_CASES, ids=lambda c: c[0])
def test_plan_at_every_b1_case(case):
    name, n, c, (hs, ws), (h, w), nb, *_, align = case
    scales = chip_smoke.b1_scales(case)
    mats = lh.fu_mats(hs, ws, (h, w), *padded(h, w), align, CPU)
    layout = lg.b2_layout(c, nb, mats.columns)
    check_layout(layout, mats)
    if c <= 17:  # the model shapes keep an SM full of threads
        assert layout.threads * layout.per_sm == 1024
    for resident in RESIDENT:
        check_plan(lg.b2_plan(layout, n, scales, hs, resident=resident,
                              max_run=mats.row_run), mats)


@pytest.mark.parametrize("scales", (1, 2))
@pytest.mark.parametrize("n_buckets", (256, 1024, 2048))
def test_plan_sweep(n_buckets, scales):
    mats = lh.fu_mats(68, 120, (544, 960), 544, 1024, scales == 2, CPU)
    for c in range(1, 33):
        layout = lg.b2_layout(c, n_buckets, mats.columns)
        check_layout(layout, mats)
        assert (layout.threads, layout.per_sm) == (lh.max_threads(c), 1)
        # the table stays in shared memory where it fits beside the tiles
        bare = lg.b2_layout(c, n_buckets, mats.columns, table_smem=False)
        if 4 * c * n_buckets + bare.smem <= lg.smem_budget(bare.per_sm) - 20_000:
            assert layout.table_smem
        for resident in (1, 132):
            check_plan(lg.b2_plan(layout, 8, scales, 68, resident=resident,
                                  max_run=mats.row_run), mats)


def test_layout_forced_choices():
    mats = lh.fu_mats(136, 240, (544, 960), 544, 1024, False, CPU)
    acf = lg.b2_layout(17, 2048, mats.columns)
    assert acf.win_w > 0 and not acf.table_smem and acf.threads == 1024
    dl = lh.fu_mats(68, 120, (544, 960), 544, 1024, True, CPU)  # DeepLabv3's taps
    assert not lg.b2_layout(17, 2048, dl.columns).table_smem
    for columns in (dl.columns, mats.columns):  # the 139 KB table: half the threads
        with pytest.raises(ValueError):
            lg.b2_layout(17, 2048, columns, table_smem=True)
        assert fu_grad_ablation.variant_layout(17, 2048, columns, {"table_smem": True}) \
            == lg.b2_layout(17, 2048, columns, table_smem=True, threads=512)
    dl_table = lg.b2_layout(17, 2048, dl.columns, table_smem=True, threads=512)
    assert dl_table.table_smem
    check_layout(dl_table, dl)
    table = lg.b2_layout(17, 2048, mats.columns, table_smem=True, threads=512)
    assert table.table_smem and table.win_w > 0
    for layout in (acf, table):
        check_layout(layout, mats)
    assert lg.b2_layout(17, 1024, mats.columns, chunks=3).n_chunks == 3
    with pytest.raises(ValueError):
        lg.b2_layout(33, 1024, mats.columns)
    with pytest.raises(ValueError):
        lg.b2_layout(32, 1024, mats.columns, threads=1024)   # the 128-register cap
    with pytest.raises(ValueError):
        lg.b2_layout(17, 2048, mats.columns, table_smem=True, threads=1024,
                     chunks=1)                               # 139 KB + a 1024-px row


def kernel_model(dz: np.ndarray, mats: lh.FuMats, plan: lg.B2Plan) -> np.ndarray:
    """What the kernel writes, step by step, in float64 from dz (N, S, C,
    H_pad, W_pad): per scale, block, piece and chunk, the output rows in
    ascending order, each source column's width taps, the running sums of
    rows cur and cur + 1 and their flushes, the upper partial sums and the
    lower terms in the edge buffer, and their merge. Every gradient element
    must be written exactly once."""
    layout = plan.layout
    n, n_scales, n_cls = dz.shape[:3]
    hs, ws = plan.hs, len(mats.columns)
    h_lo, h_beg, h_end = (mats.h_lo.numpy(), mats.h_beg.numpy(), mats.h_end.numpy())
    h_w0, h_w1 = mats.h_w0.double().numpy(), mats.h_w1.double().numpy()
    w_lo, w_beg, w_end = (mats.w_lo.numpy(), mats.w_beg.numpy(), mats.w_end.numpy())
    w_w0, w_w1 = mats.w_w0.double().numpy(), mats.w_w1.double().numpy()
    out = np.full((n, n_scales * n_cls, hs, ws), np.nan)
    writes = np.zeros(out.shape, np.int64)
    edge = {}

    def tap_weight(lo, w0, w1, s):
        return w0 if lo == s else (w1 if lo + 1 == s else 0.0)

    for scale in range(n_scales):
        rows = slice(scale * n_cls, (scale + 1) * n_cls)
        for b in range(plan.blocks):
            for img, h0, h1, first, last in plan.pieces(b):
                edge_top = first and h0 > 0
                edge_bot = last and h1 < hs
                y0, y1 = reach(h_beg, h_end, h0, h1)
                while edge_top and y0 < y1 and h_lo[y0] < h0:
                    y0 += 1
                for k in range(layout.n_chunks):
                    s_a = k * layout.chunk_s
                    ns = min(ws, s_a + layout.chunk_s) - s_a
                    cols = slice(s_a, s_a + ns)

                    def put(h, v):
                        if not (edge_top and h == h0):  # else the merge writes it
                            out[img, rows, h, cols] = v
                            writes[img, rows, h, cols] += 1

                    acc_a = np.zeros((n_cls, ns))
                    acc_b = np.zeros((n_cls, ns))
                    cur = h0
                    for y in range(y0, y1):
                        lo = h_lo[y]
                        d = np.zeros((n_cls, ns))
                        for sl in range(ns):  # the width taps, ascending x
                            s = s_a + sl
                            for x in range(w_beg[s], w_end[s]):
                                d[:, sl] += (tap_weight(w_lo[x], w_w0[x], w_w1[x], s)
                                             * dz[img, scale, :, y, x])
                        assert lo >= cur  # no row above the share
                        while cur < lo:  # the rows passed source row cur
                            put(cur, acc_a)
                            acc_a, acc_b = acc_b, np.zeros_like(acc_b)
                            cur += 1
                        if edge_top and cur == h0:  # a term for the merge
                            assert y - y0 < plan.max_run
                            terms = edge.setdefault((scale, b, 1), np.zeros((n_cls, ws)))
                            terms[:, cols] += h_w0[y] * d
                        else:
                            acc_a = acc_a + h_w0[y] * d
                        acc_b = acc_b + h_w1[y] * d
                    while cur < h1:
                        put(cur, acc_a)
                        acc_a, acc_b = acc_b, np.zeros_like(acc_b)
                        cur += 1
                    if edge_bot:
                        edge.setdefault((scale, b + 1, 0), np.zeros((n_cls, ws)))[:, cols] = acc_a
    for scale in range(n_scales):
        rows = slice(scale * n_cls, (scale + 1) * n_cls)
        for bnd in range(1, plan.blocks):
            img, h = divmod(plan.share(bnd).start, hs)
            if h:
                lower = edge.get((scale, bnd, 1), np.zeros((n_cls, ws)))
                out[img, rows, h] = edge[(scale, bnd, 0)] + lower
                writes[img, rows, h] += 1
    np.testing.assert_array_equal(writes, 1)
    return out


MODEL_CASES = {
    # n, C, s8, out, align, scales, layout keywords, resident
    "align_2scales": (3, 5, (5, 9), (37, 70), True, 2, {}, 8),
    "acf_chunks3": (2, 4, (6, 11), (23, 44), False, 1, dict(chunks=3), 5),
    "align_row_shares": (2, 3, (4, 7), (30, 53), True, 1, dict(chunks=2), 8),
    "acf_one_block": (2, 3, (5, 8), (19, 31), False, 2, {}, 2),
}


@pytest.mark.parametrize("name", MODEL_CASES)
def test_kernel_model_equals_grad_from_fields(name):
    n, c, (hs, ws), (h, w), align, scales, layout_kw, resident = MODEL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    ls = torch.as_tensor(3.0 * rng.standard_normal((n, scales * c, hs, ws)),
                         dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, c + 2, (n, h, w)))
    labels[:, :3] = c + 1                                  # ignored rows
    lbl = pad_labels(labels, c + 1)
    mats = lh.fu_mats(hs, ws, (h, w), *lbl.shape[1:], align, CPU)
    nb = 64
    table = torch.as_tensor(rng.standard_normal((scales * c, 2, nb)), dtype=torch.float32)
    table = table.to(torch.bfloat16).to(torch.float32)
    p, fg, keep, bid = lh.plain_fields(ls, lbl, mats, n_cls=c, n_buckets=nb)
    dz = lg.softmax_vjp_from_fields(p.double(), fg, keep, bid, table.double())
    mats64 = dataclasses.replace(mats, mh=mats.mh.double(), mw=mats.mw.double())
    want = lg.grad_from_fields(p.double(), fg, keep, bid, mats64, table.double()).numpy()
    layout = lg.b2_layout(c, nb, mats.columns, **layout_kw)
    plan = lg.b2_plan(layout, n, scales, hs, resident=resident, max_run=mats.row_run)
    check_layout(layout, mats)
    check_plan(plan, mats)
    if name in ("align_2scales", "acf_chunks3"):  # shares that cross an image's end
        assert any(len(list(plan.pieces(b))) > 1 for b in range(plan.blocks))
    got = kernel_model(dz.numpy(), mats, plan)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_model_walks_shares_of_one_row_and_one_block():
    """The two extreme plans: as many blocks as source rows (every share
    one row, all of it edges), and one block a scale."""
    name = "align_row_shares"
    n, c, (hs, ws), (h, w), align, scales, _, _ = MODEL_CASES[name]
    rng = np.random.default_rng(5)
    mats = lh.fu_mats(hs, ws, (h, w), *padded(h, w), align, CPU)
    dz = rng.standard_normal((n, scales, c, *padded(h, w)))
    mh, mw = mats.mh.double().numpy(), mats.mw.double().numpy()
    want = np.einsum("yh,nsryx,wx->nsrhw", mh, dz, mw).reshape(n, scales * c, hs, ws)
    layout = lg.b2_layout(c, 64, mats.columns)
    for resident, blocks in ((n * hs * scales, n * hs), (1, 1)):
        plan = lg.b2_plan(layout, n, scales, hs, resident=resident, max_run=mats.row_run)
        assert plan.blocks == blocks
        got = kernel_model(dz, mats, plan)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


CTYPE = {"int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("entry", ("fu_grad_bwd", "fu_grad_resident"))
def test_ctypes_declarations_match_the_c_entries(entry):
    src = (build.CSRC / "fu_grad.cu").read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    want = []
    for param in params.split(","):
        words = param.replace("*", " * ").split()
        if "*" in words:
            want.append("c_void_p" if entry == "fu_grad_bwd" else "ptr")
        else:
            want.append(CTYPE[words[-2]])

    class Fake:
        fu_grad_bwd = type("F", (), {})()
        fu_grad_resident = type("F", (), {})()

    lg.set_argtypes(Fake)
    got = [t.__name__ if t is not ctypes.POINTER(ctypes.c_int) else "ptr"
           for t in getattr(Fake, entry).argtypes]
    assert got == want


def test_ablation_edits_and_variants_match():
    src = (build.CSRC / "fu_grad.cu").read_text()
    for edits in fu_grad_ablation.EDITS.values():
        for old, new in edits:
            assert src.count(old) == 1 and old != new
    assert {"full", "halo_rows", "no_staging"} <= set(fu_grad_ablation.VARIANTS)


@pytest.mark.parametrize("case", fu_grad_ablation.CASES)
def test_ablation_variants_plan(case):
    n, c, (hs, ws), (h, w), nb, align, scales, _ = fu_grad_ablation.CASES[case]
    mats = lh.fu_mats(hs, ws, (h, w), *padded(h, w), align, CPU)
    for name, (lib, kw) in {**fu_grad_ablation.VARIANTS, **fu_grad_ablation.SWEEP}.items():
        assert lib == "committed" or lib in fu_grad_ablation.EDITS
        try:
            layout = fu_grad_ablation.variant_layout(c, nb, mats.columns, kw)
        except ValueError:
            assert name in fu_grad_ablation.SWEEP  # a sweep point may not fit
            continue
        check_layout(layout, mats)
        if name == "full":
            assert layout == lg.b2_layout(c, nb, mats.columns)
