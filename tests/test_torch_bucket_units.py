"""B3's arithmetic and launch plan (kernels/bucket_hist.py,
csrc/bucket_hist.cu), held on the CPU where the kernel cannot run:

  * the kernel's fixed-point units, bf16(e) times a power of two in float32
    truncated toward zero, equal an integer model from the bf16 bit pattern
    (shift and mask) and `sum_units` (the plain version's double products)
    over every bf16 value below 2^45 and every negative one in bucket 0,
    over the float32 neighbours of each k/2048 and over random float32
    values;
  * a pixel's offset bf16(e) * 2^18 - 128 b lies within the bound the
    source states, at every bucket 1..2046, and bf16(e) = 1 at every error
    of bucket 2047 up to 1 + 2^-8;
  * the kernel's walk of a row (vectors from the first 16-byte aligned
    error, head and tail pixels one by one) under `b3_plan`, modelled in
    numpy with 32-bit offset sums per block, bucket 0 in packed lane
    registers, bucket 2047 counted where bf16(e) = 1 and the other hot
    pairs in side bins, gives `bucket_stats_plain`'s counts and int64 sums
    exactly;
  * at every phase-9 shape of chip_smoke.py and every alignment, the plan
    covers each pixel exactly once and gives no block more pixels than a
    32-bit offset sum holds and no lane more than its 12-bit count holds;
  * the ctypes declarations match the C entries, and the ablation tool's
    edits still match the committed source.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

import chip_smoke
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import bucket_hist as bh
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import bucket_hist_ablation

SOURCE = (build.CSRC / "bucket_hist.cu").read_text()
N_B = bh.N_BUCKETS
# blocks the card may hold at once: an H100's 132 SMs at one to four
# blocks each, and small counts
RESIDENT = (1, 7, 132, 264, 396, 528)
THREADS = (256, 512, 1024)


def bucket_ids(e32: np.ndarray) -> np.ndarray:
    """min(int(e * 2048), 2047), the float32 product exact (a power of 2)."""
    return np.minimum((e32 * np.float32(N_B)).astype(np.int64), N_B - 1)


def bf16_bits(e32: np.ndarray) -> np.ndarray:
    """The bits of bf16(e), rounded to nearest even, of finite float32 e."""
    u = e32.view(np.uint32).astype(np.int64)
    return (u + 0x7FFF + ((u >> 16) & 1)) >> 16


def bf16_float(e32: np.ndarray) -> np.ndarray:
    return (bf16_bits(e32).astype(np.uint32) << 16).view(np.float32)


def kernel_units(e32: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The kernel's int64 units (csrc/bucket_hist.cu `units`): bf16(e)
    times 2^48 in bucket 0 or 2^18 elsewhere, a float32 product, truncated
    toward zero."""
    scale = np.where(b == 0, np.float32(2.0 ** 48), np.float32(2.0 ** 18))
    return (bf16_float(e32) * scale.astype(np.float32)).astype(np.int64)


def shift_units(e32: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The same units as integers from the bf16 bit pattern: (128 + m) <<
    (E - 86) in bucket 0 (>> where negative, truncating), << (E - 116)
    elsewhere."""
    h = bf16_bits(e32)
    mant = (h & 0x7F) | 0x80
    ex = (h >> 7) & 0xFF
    sh = ex - np.where(b == 0, 86, 116)
    mag = np.where(sh >= 0, mant << np.clip(sh, 0, 62), mant >> np.clip(-sh, 0, 8))
    return np.where(h & 0x8000, -mag, mag)


def mid_offsets(e32: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The 32-bit offsets of buckets 1..2046, as the kernel computes them."""
    u = (bf16_float(e32) * np.float32(2.0 ** 18)).astype(np.int64)
    assert (u < 2 ** 18 + 1).all()
    return u - 128 * b


def plain_units(e32: np.ndarray, b: np.ndarray) -> np.ndarray:
    return bh.sum_units(torch.from_numpy(e32), torch.from_numpy(b)).numpy()


def unit_inputs() -> np.ndarray:
    """Every bf16 value below 2^45 and every negative one above -2^-11
    (as float32), the float32 neighbours of k/2048 up to 2, and random
    float32 values of the same ranges."""
    bits = np.arange(0, 172 << 7, dtype=np.uint32)             # 0 .. < 2^45
    neg = np.arange(0x8000, 0x8000 | (116 << 7), dtype=np.uint32)
    exact = (np.concatenate([bits, neg]) << 16).view(np.float32)
    k = np.arange(2 * N_B + 1, dtype=np.float32) / N_B
    near = np.concatenate([k, np.nextafter(k, np.float32(3)), np.nextafter(k, np.float32(-1))])
    rng = np.random.default_rng(0)
    # below 0x55FF8000, which bf16 rounds up to 2^45
    rand = rng.integers(0, 0x55FF8000, 200_000, dtype=np.uint32).view(np.float32)
    rand_neg = -(rng.random(20_000, dtype=np.float32) * np.float32(2.0 ** -11))
    small = rng.random(50_000, dtype=np.float32)
    return np.concatenate([exact, near, rand, rand_neg, small]).astype(np.float32)


def test_integer_units_equal_the_double_products():
    e = unit_inputs()
    b = bucket_ids(e)
    keep = b >= 0
    e, b = e[keep], b[keep]
    assert ((b == 0) & (e < 0)).any() and (b == N_B - 1).any() and (e > 1).any()
    assert ((e > 0) & (e < 2.0 ** -48)).any() and (e == 1).any()
    want = plain_units(e, b)
    for got in (kernel_units(e, b), shift_units(e, b)):
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (e[bad[:5]], got[bad[:5]], want[bad[:5]])
    mid = (b > 0) & (b < N_B - 1)
    np.testing.assert_array_equal(mid_offsets(e[mid], b[mid]) + 128 * b[mid], want[mid])


def test_offset_bound_holds_at_every_bucket():
    """The offset is monotone in e within a bucket (bf16 rounding is), so
    its extremes over bucket b lie at b/2048 and the float below
    (b + 1)/2048; both lie within the bound the source states."""
    lo_src = int(re.search(r"lies in \[-(\d+), (\d+)\]", SOURCE).group(1))
    hi_src = int(re.search(r"constexpr int kOffsetMax = (\d+);", SOURCE).group(1))
    assert (lo_src, hi_src) == (bh.OFFSET_MIN, bh.OFFSET_MAX)
    b = np.arange(1, N_B - 1)
    e_lo = (b / N_B).astype(np.float32)
    e_hi = np.nextafter(((b + 1) / N_B).astype(np.float32), np.float32(0))
    assert (bucket_ids(e_lo) == b).all() and (bucket_ids(e_hi) == b).all()
    o_lo, o_hi = mid_offsets(e_lo, b), mid_offsets(e_hi, b)
    assert o_lo.min() >= -bh.OFFSET_MIN and o_hi.max() <= bh.OFFSET_MAX
    assert (o_lo <= o_hi).all()
    block = int(re.search(r"constexpr int kBlockPixels = 1 << (\d+);", SOURCE).group(1))
    assert bh.BLOCK_PIXELS == 1 << block
    assert bh.BLOCK_PIXELS * max(bh.OFFSET_MIN, bh.OFFSET_MAX) < 2 ** 31


def test_hot_registers_hold_their_fields():
    """Bucket 0's register: a lane's count in the bits above kCountShift,
    its units (each at most 2^37) below; bucket 2047: bf16(e) = 1 for every
    error from 2047/2048 to 1 + 2^-8, so a count gives its sum."""
    shift = int(re.search(r"constexpr int kCountShift = (\d+);", SOURCE).group(1))
    assert bh.LANE_PIXELS == 2 ** (64 - shift) - 1
    assert bh.LANE_PIXELS * 2 ** 37 < 2 ** shift
    below = np.nextafter(np.float32(2.0 ** -11), np.float32(0))
    assert kernel_units(np.array([below, -below]), np.zeros(2, np.int64)).tolist() == [
        2 ** 37, -2 ** 37]
    lo = np.float32((N_B - 1) / N_B)
    e = np.concatenate([np.linspace(lo, 1.0 + 2.0 ** -8, 100_001, dtype=np.float32),
                        [lo, np.float32(1), np.float32(1 + 2.0 ** -8)]])
    assert (bucket_ids(e) == N_B - 1).all() and (bf16_float(e) == 1).all()
    assert bf16_float(np.nextafter(np.float32(1 + 2.0 ** -8), np.float32(2)))[()] > 1


def block_ranges(plan: bh.B3Plan, p: int, first_float: int):
    """The pixel ranges [lo, hi) of each block of one row whose first error
    is float number `first_float` of a 16-byte aligned storage, as the
    kernel walks them (vectors, then the head and the tail)."""
    head = min(p, (4 - first_float % 4) % 4)
    n_vec = (p - head) // 4
    out = []
    for x in range(plan.per_row):
        v_lo, v_hi = x * plan.chunk, min(n_vec, (x + 1) * plan.chunk)
        ranges = [(head + 4 * v_lo, head + 4 * v_hi)] if v_hi > v_lo else []
        if x == 0 and head:
            ranges.append((0, head))
        if x == plan.per_row - 1 and head + 4 * n_vec < p:
            ranges.append((head + 4 * n_vec, p))
        out.append(ranges)
    return out


def phase9_shapes() -> dict:
    """(R, P) of each phase-9 case of chip_smoke.py."""
    n, h, w = chip_smoke.B3_CELL
    rows = chip_smoke.B3_ROWS
    shapes = {"cell": (17, n * h * w), "init": (17, n * h * w),
              "per_image_136": (n * 17, h * w),
              "classes_to_ignore": (17, 2 * (h // 2) * (w // 2)),
              "edges": (rows["other"][0], 3 * (N_B + 1)),
              "r1": rows["r1"], "p_odd": rows["p_odd"]}
    out = {name: shapes.get(name, rows["other"]) for name in chip_smoke.B3_CASES}
    assert set(shapes) <= set(out)
    return out


@pytest.mark.parametrize("name", chip_smoke.B3_CASES)
def test_plan_covers_every_pixel_once_within_the_cap(name):
    rows, p = phase9_shapes()[name]
    for resident in RESIDENT:
        for threads in THREADS:
            plan = bh.b3_plan(rows, p, resident, threads)
            assert plan.block_pixels <= bh.BLOCK_PIXELS
            assert plan.lane_pixels <= bh.LANE_PIXELS
            assert plan.per_row * plan.chunk >= p // 4 and plan.per_row <= 2 ** 31 - 1
            # one wave, unless a cap splits the rows further
            cap = min((bh.BLOCK_PIXELS - bh.EDGE_PIXELS) // 4,
                      (bh.LANE_PIXELS - 1) // 4 * threads)
            assert plan.per_row * rows <= max(resident, rows) or plan.chunk == cap
            # every row's first float at each alignment (the views of
            # phase 9's "misaligned" case start one float in)
            for first in range(4):
                spans = sorted(r for block in block_ranges(plan, p, first) for r in block)
                assert spans[0][0] == 0 and spans[-1][1] == p
                assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
                assert all(sum(hi - lo for lo, hi in block) <= plan.block_pixels
                           for block in block_ranges(plan, p, first))


def test_plan_caps_long_rows():
    """One block would take a whole row of 2^26 - 1 pixels; the caps split
    it (a lane's 4095 pixels bind first at 512 threads, the block's 2^21
    at 1024)."""
    plan = bh.b3_plan(1, 2 ** 26 - 1, 1, 512)
    assert plan.lane_pixels == 4 * 1023 + 1 and plan.per_row == 33
    plan = bh.b3_plan(1, 2 ** 26 - 1, 1, 1024)
    assert plan.block_pixels == bh.BLOCK_PIXELS - 2 and plan.per_row == 33
    assert bh.b3_plan(3, 2, 528, 512) == bh.B3Plan(per_row=1, chunk=512, threads=512)
    assert bh.b3_plan(17, 4_177_920, 0, 512, per_row=4).per_row == 4
    assert bh.b3_plan(17, 4_177_920, 528, 512).per_row == 31


def model_stats(e: np.ndarray, fg: np.ndarray, plan: bh.B3Plan, first_float: int):
    """The kernel's statistics in numpy: per block, int32 counts and 32-bit
    offset sums of buckets 1..2046 (held to 32 bits), bucket 0's packed
    lane registers (non-negative errors), bucket 2047's counts where
    bf16(e) = 1 and the other hot pairs' int64 side sums; the flush's
    128 b * count + offset sum and its hot totals."""
    rows, p = e.shape
    counts = np.zeros((rows, 2, N_B), np.int64)
    sums = np.zeros((rows, 2, N_B), np.int64)
    bins = np.arange(2 * N_B) % N_B
    for r in range(rows):
        for block in block_ranges(plan, p, first_float + r * p):
            idx = np.concatenate([np.arange(lo, hi) for lo, hi in block] or [[]]).astype(int)
            er, fr = e[r, idx], fg[r, idx]
            b = bucket_ids(er)
            er, fr, b = er[b >= 0], fr[b >= 0], b[b >= 0]
            key = fr * N_B + b
            hot = (b == 0) | (b == N_B - 1)
            cnt = np.bincount(key, minlength=2 * N_B)
            off = np.bincount(key[~hot], weights=mid_offsets(er[~hot], b[~hot]),
                              minlength=2 * N_B).astype(np.int64)
            assert np.abs(off).max(initial=0) < 2 ** 31
            zero = (b == 0) & (er >= 0)
            one = (b == N_B - 1) & (bf16_float(er) == 1)
            side = hot & ~zero & ~one
            hot_sum = np.zeros(2 * N_B, np.int64)
            np.add.at(hot_sum, key[zero], kernel_units(er[zero], b[zero]))
            np.add.at(hot_sum, key[one], 2 ** 18)
            np.add.at(hot_sum, key[side], kernel_units(er[side], b[side]))
            s = np.where((bins == 0) | (bins == N_B - 1), hot_sum, 128 * bins * cnt + off)
            counts[r] += cnt.reshape(2, N_B)
            sums[r] += s.reshape(2, N_B)
    return counts, sums


def model_inputs(name: str, rows: int, p: int):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "edges":
        k = np.arange(N_B + 1, dtype=np.float32) / N_B
        row = np.concatenate([k, np.nextafter(k, np.float32(2)),
                              np.maximum(np.nextafter(k, np.float32(-1)), 0)])
        e = np.tile(row, (rows, 1))[:, :p]
    elif name == "piled":
        u = rng.random((rows, p), dtype=np.float32)
        which = rng.random((rows, p))
        e = np.where(which < 0.45, u * np.float32(2.0 ** -11 * 0.999),
                     np.where(which < 0.9, 1 - u * np.float32(2.0 ** -12), u))
    elif name == "beyond":      # negative errors in bucket 0, errors above 1
        u = rng.random((rows, p), dtype=np.float32)
        which = rng.random((rows, p))
        e = np.where(which < 0.3, -u * np.float32(2.0 ** -12),
                     np.where(which < 0.6, 1 + 2 * u, u))
    else:
        e = rng.random((rows, p), dtype=np.float32) ** 3
        e[:, ::7] *= np.float32(2.0 ** -11)     # bucket 0
    return e.astype(np.float32), rng.random((rows, p)) < 0.3


@pytest.mark.parametrize("name,rows,p,first", [
    ("random", 3, 10_001, 0), ("random", 2, 4_099, 3), ("edges", 2, 3 * (N_B + 1), 1),
    ("piled", 3, 5_003, 2), ("beyond", 2, 3_001, 1)])
def test_offset_encoding_gives_the_plain_sums(name, rows, p, first):
    e, fg = model_inputs(name, rows, p)
    want_c, want_s = bh.bucket_stats_plain(torch.from_numpy(e), torch.from_numpy(fg))
    for plan in (bh.b3_plan(rows, p, 8, 64), bh.b3_plan(rows, p, 8, 64, per_row=1)):
        counts, sums = model_stats(e, fg, plan, first)
        np.testing.assert_array_equal(counts, want_c.numpy())
        np.testing.assert_array_equal(sums, want_s.numpy())


C_TYPES = {"int": "c_int", "long long": "c_longlong"}


@pytest.mark.parametrize("entry", ["bucket_hist_fwd", "bucket_hist_resident"])
def test_ctypes_declarations_match_the_c_entries(entry):
    params = re.search(rf"\bint {entry}\(([^)]*)\)", SOURCE).group(1)
    want = []
    for param in filter(None, (q.strip() for q in params.split(","))):
        if "*" in param:
            want.append("c_void_p" if entry == "bucket_hist_fwd" else "ptr")
        else:
            want.append(C_TYPES[param.rsplit(" ", 1)[0]])

    class Fake:
        bucket_hist_fwd = type("F", (), {})()
        bucket_hist_resident = type("F", (), {})()

    bh.set_argtypes(Fake)
    fn = getattr(Fake, entry)
    got = [t.__name__ if t is not ctypes.POINTER(ctypes.c_int) else "ptr"
           for t in fn.argtypes]
    assert got == want and fn.restype is ctypes.c_int


def test_ablation_edits_match_the_source():
    for name, edits in bucket_hist_ablation.EDITS.items():
        for old, _ in edits:
            assert SOURCE.count(old) == 1, name
