"""B1's launch plan (kernels/lovasz_hist.py `b1_layout`, `b1_plan`) and a
numpy model of how the kernel (csrc/fu_hist.cu) merges its counts.

The kernel runs only on the card; what surrounds it is held here:
  * at every B1_CASES shape of chip_smoke.py, and over C 1..32 x B {256,
    512, 1024, 2048} x one or two scales: each (image, output tile) is
    walked by exactly one block per scale, each class row is owned by
    exactly one block of its cluster, a block's shared memory fits the
    232,448 bytes a block may opt into, a cluster has at most 8 blocks, no
    plan computes a pixel's softmax more than once per scale, and no table
    receives more pixels than a 16-bit counter holds;
  * the merge: bucket 0 of the bg half counted apart (the kernel's
    per-lane registers, summed over a warp at the flush), every other pair
    added into the packed 16-bit table of the block that owns its row,
    the tables flushed into int32 counts, equals `count_fields` exactly on
    seeded fields, the dither and adaptive maps included;
  * the ctypes declarations match the C entries' parameter lists, and the
    ablation tool's edits still match the committed source.
"""
import re

import numpy as np
import pytest
import torch

import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import lovasz_hist as lh
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
    pad_labels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import fu_hist_ablation

# blocks the card may hold at once: an H100's 132 SMs at one to eight
# blocks each, and a small count that makes each stream walk many tiles
RESIDENT = (7, 132, 264, 396, 1056)


def padded(h, w):
    return -(-h // 8) * 8, -(-w // 128) * 128


def check_plan(plan: lh.B1Plan, n_cls: int):
    layout = plan.layout
    # rows: contiguous shares, each class owned by exactly one group
    owners = [c // layout.rows_per for c in range(n_cls)]
    assert sorted(set(owners)) == list(range(layout.groups))
    assert layout.groups * layout.rows_per >= n_cls > (layout.groups - 1) * layout.rows_per
    assert layout.smem + lh.STATIC_SMEM <= 232_448
    assert layout.smem >= 4 * (layout.rows_per * layout.n_buckets + 32)
    assert 1 <= layout.groups <= 8
    assert layout.cluster == (layout.groups > 1)
    assert layout.softmax_passes == 1
    assert layout.threads % 32 == 0 and layout.threads <= lh.max_threads(n_cls)
    # tiles: every tile of a scale walked by exactly one block
    assert plan.ctas_x % layout.groups == 0
    assert plan.streams == (plan.ctas_x if layout.cluster else plan.ctas_x // layout.groups)
    walked = np.concatenate([np.asarray(plan.stream_tiles(j), dtype=np.int64)
                             for j in range(plan.streams)])
    np.testing.assert_array_equal(np.sort(walked), np.arange(plan.n_tiles))
    assert layout.tile_px % 32 == 0
    # the kernel's counters: 16 bits in shared memory, 8 bits a lane
    assert plan.table_pixels <= 0xFFFF and plan.lane_pixels <= 0xFF


@pytest.mark.parametrize("case", chip_smoke.B1_CASES, ids=lambda c: c[0])
def test_plan_at_every_b1_case(case):
    name, n, c, (hs, ws), (h, w), nb, *_, align = case
    scales = chip_smoke.b1_scales(case)
    mats = lh.fu_mats(hs, ws, (h, w), *padded(h, w), align, torch.device("cpu"))
    window = lh.b1_window(mats)
    layout = lh.b1_layout(c, nb, window)
    assert layout.cluster == (c > 28 and nb == 2048)  # else one block holds them
    assert (layout.win_h, layout.win_w) == window  # the window is staged
    for resident in RESIDENT:
        check_plan(lh.b1_plan(layout, n, scales, *padded(h, w), resident=resident), c)


@pytest.mark.parametrize("align", (True, False))
@pytest.mark.parametrize("hw", ((68, 120), (136, 240), (9, 16)))
def test_window_holds_every_real_tap_of_each_tile(hw, align):
    """The kernel stages rows h_lo[y0] .. + win_h (and the columns alike)
    of a tile starting at y0: every real row's two taps must lie there."""
    hs, ws = hw
    h, w = (67, 125) if hs == 9 else (540, 960)
    mats = lh.fu_mats(hs, ws, (h, w), *padded(h, w), align, torch.device("cpu"))
    assert lh.b1_window(mats) == mats.window
    for tile_h in (8, 16):
        win = lh.b1_window(mats, tile_h)
        if tile_h == lh.TILE_H:
            assert win == mats.window
        for lo, m, n_src, tile, size in ((mats.h_lo, mats.mh, hs, tile_h, win[0]),
                                         (mats.w_lo, mats.mw.T, ws, 128, win[1])):
            lo = np.where((m != 0).any(1).numpy(), lo.numpy(), -1)
            for start in range(0, lo.size, tile):
                part = lo[start:start + tile]
                if part[0] < 0:
                    continue
                real = part[part >= 0]
                assert real.min() == part[0]
                assert np.minimum(real + 1, n_src - 1).max() - part[0] < size


@pytest.mark.parametrize("scales", (1, 2))
@pytest.mark.parametrize("n_buckets", (256, 512, 1024, 2048))
def test_plan_sweep(n_buckets, scales):
    for c in range(1, 33):
        layout = lh.b1_layout(c, n_buckets)
        for resident in RESIDENT:
            check_plan(lh.b1_plan(layout, 8, scales, 544, 1024, resident=resident), c)
    # only C > 28 at B 2048 needs a cluster, of two
    clusters = {c: lh.b1_layout(c, n_buckets).groups for c in range(1, 33)}
    want = {c: 2 if n_buckets == 2048 and c > 28 else 1 for c in range(1, 33)}
    assert clusters == want


def test_plan_grows_the_grid_to_keep_counts_in_16_bits():
    layout = lh.b1_layout(17, 1024, tile_h=8)
    plan = lh.b1_plan(layout, 64, 2, 544, 1024, resident=2)
    assert plan.streams == -(-plan.n_tiles // (lh.COUNT_MAX // 1024))
    assert plan.table_pixels <= lh.COUNT_MAX
    forced = lh.b1_layout(32, 2048, groups=4)
    plan = lh.b1_plan(forced, 64, 1, 544, 1024, resident=8)
    assert forced.cluster and plan.ctas_x % 4 == 0
    check_plan(plan, 32)


def test_layout_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        lh.b1_layout(33, 1024)
    with pytest.raises(ValueError):
        lh.b1_layout(32, 32768)                    # 8 blocks cannot hold it
    with pytest.raises(ValueError):
        lh.b1_layout(17, 4096, groups=1)           # 278 KB in one block
    assert lh.b1_layout(17, 2048, groups=2, cluster=False).softmax_passes == 2


def merge_model(fg, keep, bid, n_buckets, plan: lh.B1Plan) -> torch.Tensor:
    """What the kernel computes from the fields, step by step in numpy:
    per block, the hot counts and its packed table of owned rows, then the
    flush of every block of every scale into int32 (R, 2, B)."""
    fg, keep, bid = fg.numpy(), keep.numpy(), bid.numpy()
    n, n_scales, n_cls, h_pad, w_pad = bid.shape
    layout = plan.layout
    rows_per, nb = layout.rows_per, n_buckets
    out = np.zeros((n_scales * n_cls, 2, nb), np.int64)
    img, y, x = np.meshgrid(np.arange(n), np.arange(h_pad), np.arange(w_pad),
                            indexing="ij")
    tile = ((img * plan.tiles_h + y // layout.tile_h) * plan.tiles_w
            + (x >> layout.tile_w_log2))
    stream = tile % plan.streams
    for s in range(n_scales):
        for cluster in range(plan.ctas_x // layout.groups):
            tables = np.zeros((layout.groups, rows_per * nb), np.uint32)
            members = range(cluster * layout.groups, (cluster + 1) * layout.groups)
            for block in members:
                # the pixels this block computes: its stream's (a cluster
                # block's own, or its group's stream without a cluster)
                j = block if layout.cluster else block // layout.groups
                mine = (stream == j) & keep
                for c in range(n_cls):
                    owner = c // rows_per
                    if not layout.cluster and owner != block % layout.groups:
                        continue
                    f, b = fg[:, c][mine], bid[:, s, c][mine]
                    hot = ~f & (b == 0)
                    half = f.astype(np.int64)[~hot] * nb + b[~hot]
                    row = (c % rows_per) * nb
                    np.add.at(tables[owner], row + (half >> 1),
                              (np.uint32(1) << (16 * (half & 1)).astype(np.uint32)))
                    tables[owner][row] += np.uint32(hot.sum())
            for g, table in enumerate(tables):
                lo = table & 0xFFFF
                hi = table >> 16
                counts = np.stack([lo, hi], 1).reshape(-1)[: 2 * rows_per * nb]
                rows = min(rows_per, n_cls - g * rows_per)
                r0 = s * n_cls + g * rows_per
                out[r0:r0 + rows] += counts[: rows * 2 * nb].reshape(rows, 2, nb)
    return torch.as_tensor(out.astype(np.int32))


MERGE_CASES = {
    # n, C, s8, out, B, edges, dither seed, align, layout keywords, resident
    "uniform": (2, 5, (5, 8), (36, 61), 256, "uniform", None, True, {}, 6),
    "adaptive_dither": (2, 5, (5, 8), (36, 61), 512, "adaptive", 9, True, {}, 5),
    "dither_acf": (1, 7, (9, 16), (33, 64), 256, "uniform", 4, False, {}, 2),
    "cluster3": (2, 7, (5, 8), (36, 61), 256, "uniform", 3, True, dict(groups=3), 6),
    "split2": (1, 7, (5, 8), (36, 61), 256, "uniform", None, True,
               dict(groups=2, cluster=False), 8),
}


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_model_equals_count_fields(name):
    n, c, (hs, ws), (h, w), nb, edges, dseed, align, layout_kw, resident = MERGE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    scales = 2 if align else 1
    ls = torch.as_tensor(3.0 * rng.standard_normal((n, scales * c, hs, ws)),
                         dtype=torch.float32)
    # peaked on the label of each source cell for half the classes, so that
    # bucket 0 of the bg half is hot, as for a net that has learnt
    labels = torch.as_tensor(rng.integers(0, c + 2, (n, h, w)))
    labels[:, :4] = c + 1                           # ignored below
    lbl = pad_labels(labels, c + 1)
    mats = lh.fu_mats(hs, ws, (h, w), *lbl.shape[1:], align, torch.device("cpu"))
    seed, dither = (0, False) if dseed is None else (dseed, True)
    _, fg, keep, bid = lh.plain_fields(ls, lbl, mats, n_cls=c, n_buckets=nb,
                                       edges=edges, seed=seed, dither=dither)
    want = lh.count_fields(fg, keep, bid, nb)
    assert int(((bid == 0) & ~fg[:, None] & keep[:, None, None]).sum()) > 0
    layout = lh.b1_layout(c, nb, lh.b1_window(mats, 4, 5), threads=64, tile_h=4,
                          tile_w_log2=5, **layout_kw)
    plan = lh.b1_plan(layout, n, scales, *lbl.shape[1:], resident=resident)
    if layout.softmax_passes == 1:
        check_plan(plan, c)
    assert plan.streams > 1
    torch.testing.assert_close(merge_model(fg, keep, bid, nb, plan), want,
                               rtol=0, atol=0)


CTYPE = {"int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("entry", ("fu_hist_fwd", "fu_hist_resident"))
def test_ctypes_declarations_match_the_c_entries(entry):
    import ctypes

    src = (build.CSRC / "fu_hist.cu").read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    want = []
    for param in params.split(","):
        ctype = param.split()[-2] if len(param.split()) > 2 else param.split()[0]
        want.append("c_void_p" if "*" in param and entry == "fu_hist_fwd"
                    else "ptr" if "*" in param else CTYPE[ctype])

    class Fake:
        fu_hist_fwd = type("F", (), {})()
        fu_hist_resident = type("F", (), {})()

    lh.set_argtypes(Fake)
    got = [t.__name__ if t is not ctypes.POINTER(ctypes.c_int) else "ptr"
           for t in getattr(Fake, entry).argtypes]
    assert got == want


def test_ablation_edits_match_the_source():
    src = (build.CSRC / "fu_hist.cu").read_text()
    for edits in fu_hist_ablation.EDITS.values():
        for old, new in edits:
            assert src.count(old) == 1 and old != new
    for layout_kw in fu_hist_ablation.PLANS.values():
        stage = layout_kw.get("stage", True)
        kw = {k: v for k, v in layout_kw.items() if k != "stage"}
        layout = lh.b1_layout(17, 2048, (6, 34) if stage else (0, 0), **kw)
        assert (layout.win_h > 0) == stage
    for layout_kw in fu_hist_ablation.SWEEP.values():
        lh.b1_layout(17, 1024, (4, 18), **layout_kw)
