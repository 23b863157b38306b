"""B5/B7's launch plan (kernels/nchw_hist.py `nchw_layout`, `nchw_plan`) and
a numpy model of the kernel's walk (csrc/nchw_hist.cu).

The kernel runs only on the card; what surrounds it is held here:
  * at every NCHW_CASES shape of chip_smoke.py, and over C 1..32 x B {256,
    512, 1024, 2048} x one or two scales x N up to 64: each (image, tile)
    is walked by exactly one block per scale and row group, a block's
    shared memory fits the 232,448 bytes a block may opt into, the table
    is int32 where that fits one block and 16-bit pairs otherwise, no
    table receives more pixels than its counters hold, and up to C 28 at
    B 2048 (so at every C <= 17) each pixel's softmax is computed once per
    scale;
  * the walk: tiles of the stream, warps of 32 pixels skipped where none
    of them counts (so no logit is loaded for them), every pair added into
    the int32 or packed 16-bit table of its block, the tables flushed into
    int32 counts: equal to `count_fields` exactly on seeded fields, with
    labels live in the pad lanes past w_real, an all-ignored image and
    adaptive edges; and so is the ablation's hot_bins build (bucket 0 of
    the bg half counted in per-lane 8-bit counters and summed over the
    warp) under its lane-capped plan;
  * the ctypes declarations match the C entries' parameter lists, and the
    ablation tool's edits still match the committed source.
"""
import re

import numpy as np
import pytest
import torch

import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import nchw_hist as nh
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    count_fields)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import nchw_hist_ablation

# blocks the card may hold at once: an H100's 132 SMs at one to eight
# blocks each, and a small count that makes each stream walk many tiles
RESIDENT = (7, 132, 264, 396, 1056)


def padded(h, w):
    return -(-h // 8) * 8, -(-w // 128) * 128


def check_plan(plan: nh.NchwPlan, n_cls: int, walk: bool = True, forced: bool = False):
    layout = plan.layout
    assert layout.groups * layout.rows_per >= n_cls > (layout.groups - 1) * layout.rows_per
    assert layout.smem <= 232_448
    words = layout.rows_per * layout.n_buckets * (1 if layout.packed else 2)
    assert layout.smem >= 4 * (words + 32)
    assert 1 <= layout.groups <= 8
    assert layout.threads % 32 == 0
    assert layout.threads <= nh.max_threads(n_cls, layout.groups)
    assert layout.tile_px % 32 == 0 and (1 << layout.tile_w_log2) >= 32
    # one softmax a pixel and scale wherever one block holds the rows (a
    # layout forced to split them aside)
    if layout.n_buckets <= 2048 and n_cls <= 28 and not forced:
        assert layout.softmax_passes == 1
    assert plan.ctas_x % layout.groups == 0
    assert 1 <= plan.streams <= plan.n_tiles
    if walk:
        tiles = np.concatenate([np.asarray(plan.stream_tiles(j), dtype=np.int64)
                                for j in range(plan.streams)])
        np.testing.assert_array_equal(np.sort(tiles), np.arange(plan.n_tiles))
    # the kernel's counters: 16 bits in a packed table, else 32
    assert plan.table_pixels <= (0xFFFF if layout.packed else 0x7FFFFFFF)


@pytest.mark.parametrize("case", chip_smoke.NCHW_CASES, ids=lambda c: c[0])
def test_plan_at_every_nchw_case(case):
    name, scales, n, c, _, (h, w), nb, *_ = case
    h_pad, w_pad = padded(h, w)
    layout = nh.nchw_layout(c, nb)
    assert layout.groups == 1                       # every case fits one block
    for s in scales:
        for resident in RESIDENT:
            check_plan(nh.nchw_plan(layout, n, s, h_pad, w_pad, w, resident=resident), c)


@pytest.mark.parametrize("scales", (1, 2))
@pytest.mark.parametrize("n_buckets", (256, 512, 1024, 2048))
def test_plan_sweep(n_buckets, scales):
    for c in range(1, 33):
        layout = nh.nchw_layout(c, n_buckets)
        # int32 counters wherever they fit one block
        assert layout.packed == (4 * (c * 2 * n_buckets + 32) > 232_448)
        for n in (1, 8, 64):
            for resident in RESIDENT:
                plan = nh.nchw_plan(layout, n, scales, 544, 1024, 960, resident=resident)
                check_plan(plan, c, walk=n == 1)
    # only C > 28 at B 2048 needs its rows split, over two blocks
    groups = {c: nh.nchw_layout(c, n_buckets).groups for c in range(1, 33)}
    assert groups == {c: 2 if n_buckets == 2048 and c > 28 else 1 for c in range(1, 33)}


def test_model_shapes_take_one_wave():
    """The flagship (two scales, B 1024: int32 counters, 139 KB) and the
    DeepLabv3 cell (one scale, B 2048: 16-bit pairs, 139 KB) at N 8 on 132
    SMs: one block of 1024 threads an SM, one wave; the 16-bit table well
    inside its counters (about 34 K pixels). The int32 table takes one wave
    at N 64 too."""
    b1024 = nh.nchw_layout(17, 1024)
    assert not b1024.packed
    assert (b1024.threads, b1024.smem) == (1024, 4 * (17 * 2048 + 32))
    plan = nh.nchw_plan(b1024, 8, 2, 544, 1024, 960, resident=132)
    assert plan.ctas_x == 66
    assert nh.nchw_plan(b1024, 64, 2, 544, 1024, 960, resident=132).ctas_x == 66
    b2048 = nh.nchw_layout(17, 2048)
    assert b2048.packed
    assert (b2048.threads, b2048.smem) == (1024, 4 * (17 * 2048 + 32))
    plan = nh.nchw_plan(b2048, 8, 1, 544, 1024, 960, resident=132)
    assert plan.ctas_x == 132 and plan.table_pixels <= 35_000
    # columns past w_real are not walked
    assert plan.tiles_w == 8 and plan.n_tiles == 8 * 34 * 8


def test_plan_grows_the_grid_in_whole_waves():
    layout = nh.nchw_layout(17, 1024, packed=True)
    plan = nh.nchw_plan(layout, 64, 2, 544, 1024, 960, resident=264)
    wave = 132
    assert plan.streams % wave == 0 and plan.streams > wave
    assert plan.table_pixels <= nh.COUNT_MAX
    check_plan(plan, 17, walk=False)
    tiny = nh.nchw_plan(layout, 1, 2, 8, 128, 125, resident=264)
    assert tiny.streams == tiny.n_tiles == 1


def test_layout_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        nh.nchw_layout(33, 1024)
    with pytest.raises(ValueError):
        nh.nchw_layout(32, 32768)                   # 8 blocks cannot hold it
    with pytest.raises(ValueError):
        nh.nchw_layout(17, 4096, groups=1)          # 278 KB in one block
    with pytest.raises(ValueError):
        nh.nchw_layout(25, 1024, threads=1024)      # the C 32 instance: 512
    with pytest.raises(ValueError):
        nh.nchw_layout(17, 1024, tile_w_log2=4)     # a tile row under a warp
    with pytest.raises(ValueError):
        nh.nchw_plan(nh.nchw_layout(5, 256), 1, 1, 8, 128, 130, resident=4)
    with pytest.raises(ValueError):                 # a 16-bit table under one tile
        nh.nchw_plan(nh.nchw_layout(5, 256, packed=True, tile_h=512, tile_w_log2=7),
                     1, 1, 512, 128, 128, resident=4)
    assert nh.nchw_layout(17, 2048, packed=False).softmax_passes == 2
    assert nh.max_threads(17, 2, uniform=False) == 512      # the C 32 instance


def walk_model(labels, w_real, fg, bid, plan: nh.NchwPlan, hot_bins: bool):
    """What the kernel computes from the fields, step by step in numpy: per
    scale and block, the tiles of its stream and their pixels, warps of 32
    pixels skipped where none counts, the per-lane hot counts (where
    `hot_bins`: the ablation's build), its table of owned rows, then the
    flush of every block into int32 (R, 2, B). Returns the counts and the
    number of (pixel, class) loads."""
    labels, fg, bid = labels.numpy(), fg.numpy(), bid.numpy()
    n, n_scales, n_cls, h_pad, w_pad = bid.shape
    layout = plan.layout
    nb, rows_per = layout.n_buckets, layout.rows_per
    wpr = nb if layout.packed else 2 * nb
    out = np.zeros((n_scales * n_cls, 2, nb), np.int64)
    k = np.arange(layout.tile_px)
    slot_y = k >> layout.tile_w_log2
    slot_x = k & ((1 << layout.tile_w_log2) - 1)
    loads = 0
    for s in range(n_scales):
        for block in range(plan.ctas_x):
            group, stream = block % layout.groups, block // layout.groups
            r_lo = group * rows_per
            r_hi = min(r_lo + rows_per, n_cls)
            table = np.zeros(rows_per * wpr, np.uint32)
            hot = np.zeros((layout.threads, n_cls), np.int64)
            for t in plan.stream_tiles(stream):
                img, rem = divmod(t, plan.tiles_h * plan.tiles_w)
                ty, tx = divmod(rem, plan.tiles_w)
                y = ty * layout.tile_h + slot_y
                x = (tx << layout.tile_w_log2) + slot_x
                inside = (y < h_pad) & (x < w_real)
                lbl = np.where(inside, labels[img, np.minimum(y, h_pad - 1),
                                              np.minimum(x, w_pad - 1)], -1)
                counted = lbl >= 0
                warp_live = counted.reshape(-1, 32).any(1)        # tile_px % 32 == 0
                # a skipped warp holds no counted pixel: nothing is lost
                assert not counted.reshape(-1, 32)[~warp_live].any()
                loads += int(counted.sum()) * n_cls
                yy, xx, th = y[counted], x[counted], (k % layout.threads)[counted]
                for c in range(r_lo, r_hi):
                    f = fg[img, c, yy, xx]
                    b = bid[img, s, c, yy, xx]
                    is_hot = ~f & (b == 0) & hot_bins
                    np.add.at(hot[:, c], th[is_hot], 1)
                    f, b = f[~is_hot], b[~is_hot]
                    row = (c - r_lo) * wpr
                    if layout.packed:
                        # word b: the bg count low, the fg count high
                        np.add.at(table, row + b,
                                  np.where(f, np.uint32(1 << 16), np.uint32(1)))
                    else:
                        np.add.at(table, row + f * nb + b, np.uint32(1))
            # the lane counters never pass 8 bits; the warp sums land in
            # bucket 0 of the bg half
            assert hot.max(initial=0) <= 0xFF
            warp_sums = hot.reshape(-1, 32, n_cls).sum(1).sum(0)
            for c in range(r_lo, r_hi):
                table[(c - r_lo) * wpr] += np.uint32(warp_sums[c])
            rows = r_hi - r_lo
            if layout.packed:
                counts = np.stack([table & 0xFFFF, table >> 16]).reshape(2, rows_per, nb)
                counts = counts.transpose(1, 0, 2).reshape(-1)
            else:
                counts = table.astype(np.int64)
            r0 = s * n_cls + r_lo
            out[r0:r0 + rows] += counts[: rows * 2 * nb].reshape(rows, 2, nb)
    return torch.as_tensor(out.astype(np.int32)), loads


P16 = dict(packed=True)
WALK_CASES = {
    # N, C, (H, W), w_real, B, edges, layout keywords, resident; labels
    # live in the pad lanes past w_real
    "live_pad_16bit": (2, 5, (13, 128), 125, 256, "uniform", P16, 5),
    "live_pad_int32": (2, 5, (13, 128), 125, 256, "uniform", {}, 5),
    "all_ignore_image": (2, 5, (13, 128), 128, 256, "uniform", P16, 6),
    "adaptive_16bit": (1, 7, (9, 64), 61, 512, "adaptive", P16, 6),
    "adaptive_int32": (1, 7, (9, 64), 61, 256, "adaptive", {}, 6),
    "c17_int32": (1, 17, (6, 64), 64, 256, "uniform", {}, 6),
    "split2": (1, 7, (9, 64), 61, 256, "uniform", dict(groups=2, **P16), 12),
    # C 30 at B 2048 does not fit one block even in 16 bits: two row groups
    "c30_b2048_split": (1, 30, (5, 64), 61, 2048, "uniform", {}, 8),
}


@pytest.mark.parametrize("hot_bins", (False, True), ids=("committed", "hot_bins_build"))
@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_model_equals_count_fields(name, hot_bins):
    n, c, (h, w_pad), w_real, nb, edges, layout_kw, resident = WALK_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    scales = 2
    lbl = rng.integers(-1, c + 1, (n, h, w_pad)).astype(np.int32)
    if name == "all_ignore_image":
        lbl[0] = -1
    # peaked on the label for half the pixels, so that bucket 0 of the bg
    # half is hot, as for a net that has learnt
    logits = 3.0 * rng.standard_normal((scales, n, c, h, w_pad))
    peak = (lbl[:, None] == np.arange(c)[None, :, None, None]) & (rng.random((n, 1, h, w_pad)) < 0.5)
    logits += 15.0 * peak[None]
    grids = [torch.as_tensor(g, dtype=torch.float32) for g in logits]
    labels = torch.as_tensor(lbl)
    _, fg, keep, bid = nh.nchw_fields(grids, labels, n_buckets=nb, edges=edges,
                                      w_real=w_real)
    want = count_fields(fg, keep, bid, nb)
    assert int(((bid == 0) & ~fg[:, None] & keep[:, None, None]).sum()) > 0
    layout = nh.nchw_layout(c, nb, **dict(dict(threads=64, tile_h=2, tile_w_log2=5),
                                          **layout_kw))
    plan = nh.nchw_plan(layout, n, scales, h, w_pad, w_real, resident=resident)
    if hot_bins:
        plan = nchw_hist_ablation.lane_capped(plan, resident)
        assert nchw_hist_ablation.lane_pixels(plan) <= 0xFF
    check_plan(plan, c, forced="groups" in layout_kw)
    assert plan.streams > 1
    got, loads = walk_model(labels, w_real, fg, bid, plan, hot_bins)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # no logit loaded for a pixel that does not count
    assert loads == scales * c * int(keep.sum()) * layout.groups


def test_walk_model_sees_a_carry():
    """The model's 16-bit halves carry when a table receives more than
    COUNT_MAX pixels: what the plan's cap keeps from happening."""
    table = np.zeros(1, np.uint32)
    np.add.at(table, np.zeros(0x10000, np.int64), np.uint32(1))
    assert table[0] >> 16 == 1 and table[0] & 0xFFFF == 0


CTYPE = {"int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("entry", ("nchw_hist_fwd", "nchw_hist_resident"))
def test_ctypes_declarations_match_the_c_entries(entry):
    import ctypes

    src = (build.CSRC / "nchw_hist.cu").read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    want = []
    for param in params.split(","):
        ctype = param.split()[-2] if len(param.split()) > 2 else param.split()[0]
        want.append("c_void_p" if "*" in param and entry == "nchw_hist_fwd"
                    else "ptr" if "*" in param else CTYPE[ctype])

    class Fake:
        nchw_hist_fwd = type("F", (), {})()
        nchw_hist_resident = type("F", (), {})()

    nh.set_argtypes(Fake)
    got = [t.__name__ if t is not ctypes.POINTER(ctypes.c_int) else "ptr"
           for t in getattr(Fake, entry).argtypes]
    assert got == want


def test_per_pixel_loop_has_no_64_bit_division():
    """The committed walk divides 32-bit tile coordinates once per tile; the
    first design's 64-bit grid-stride index is only the ablation's edit."""
    src = (build.CSRC / "nchw_hist.cu").read_text()
    body = src[src.index("nchw_hist_kernel(const Params p)"):src.index("using Kernel")]
    assert "long long i" not in body and "% p.w_pad" not in body
    assert not re.search(r"\bi / plane\b", body)


def test_ablation_edits_match_the_source():
    texts = nchw_hist_ablation.edited_sources()
    assert set(texts) == set(nchw_hist_ablation.EDITS)
    src = (build.CSRC / "nchw_hist.cu").read_text()
    for name, text in texts.items():
        assert text != src
    assert "i % p.w_pad" in texts["grid_stride64"]
    assert "__reduce_add_sync" in texts["hot_bins"] and "__reduce_add_sync" not in src
    for vec in (2, 4):
        text = texts[f"vec{vec}"]
        assert f"constexpr int VEC = {vec};" in text and f"float{vec}" in text
        assert text.count("{") == text.count("}")
        layout = nh.nchw_layout(17, 1024, **nchw_hist_ablation.EDIT_PLANS[f"vec{vec}"])
        # 512 threads (the build's bound), a tile row of whole warps of vectors
        assert layout.threads == 512 and (1 << layout.tile_w_log2) >= 32 * vec
        assert layout.tile_px == nh.nchw_layout(17, 1024).tile_px
    for name, text in texts.items():
        assert text.count("{") == text.count("}"), name
    plans = {**nchw_hist_ablation.PLANS, **nchw_hist_ablation.EDIT_PLANS,
             **nchw_hist_ablation.SWEEP}
    for nb in (1024, 2048):
        default = nh.nchw_layout(17, nb)
        for name, layout_kw in plans.items():
            try:
                layout = nh.nchw_layout(17, nb, **layout_kw)
            except ValueError:
                assert name == "t1024"          # the int32 split's 512-thread cap
                continue
            check_plan(nh.nchw_plan(layout, 8, 2, 544, 1024, 960, resident=132), 17,
                       walk=False, forced=name == "int32_split")
            if name in ("packed16", "int32_split"):
                # each differs from the default at one of the two cells
                assert (layout == default) == (name == ("packed16" if nb == 2048
                                                        else "int32_split"))
    split = nh.nchw_layout(17, 2048, packed=False)
    assert split.groups == 2 and split.smem <= 232_448


@pytest.mark.parametrize("case", chip_smoke.NCHW_CASES, ids=lambda c: c[0])
def test_hot_bins_build_plan_caps_its_lanes(case):
    """The ablation's hot_bins build counts bucket 0 of the bg half in 8-bit
    lane registers: its plan grows the committed one by whole waves until
    no lane counts more than 255 pixels; the committed plan needs no such
    cap. At N 8 the flagship's plan needs no extra wave."""
    name, scales, n, c, _, (h, w), nb, *_ = case
    h_pad, w_pad = padded(h, w)
    layout = nh.nchw_layout(c, nb)
    for s in scales:
        for resident in RESIDENT:
            plan = nh.nchw_plan(layout, n, s, h_pad, w_pad, w, resident=resident)
            capped = nchw_hist_ablation.lane_capped(plan, resident)
            assert nchw_hist_ablation.lane_pixels(capped) <= 0xFF
            assert capped.streams >= plan.streams
            wave = max(resident // s, 1)
            assert capped.streams == plan.streams or capped.streams % wave == 0 \
                or capped.streams == capped.n_tiles
            check_plan(capped, c, walk=False)
    flagship = nh.nchw_plan(nh.nchw_layout(17, 1024), 8, 2, 544, 1024, 960, resident=132)
    assert nchw_hist_ablation.lane_capped(flagship, 132) == flagship
