"""The port's v3 route (the JAX package's CADIS_FUSED_V3=1 fallback): the
plain versions of B5-B8 (the CPU paths of the kernel wrappers) against the
JAX package's `_nchw_histogram`, `_nchw_grad`, `_nchw1_histogram` and
`_nchw1_grad` fed the same full-resolution grids (their Pallas kernels in
interpret mode, as the JAX package's own tests run them), `upsample_nchw`,
the two-scale v3 loss against the JAX package's with `_USE_V3` set on both
sides (test_torch_deeplab.py holds the single-scale one so), and both v3
losses against the port's own v4 route.

Inputs are made with numpy from a seed. Tolerances:
  * each row's total count is exact; the histograms' L1 distance is
    <= 1e-3 of the counted (row, pixel) pairs (a softmax rounded in
    another order can move an error on a bucket edge by one bucket);
  * the backward given the same table: 1e-6 relative L2. The table varies
    by 64-bucket block, so a pair that moves one bucket reads the same
    value but where it crosses a block edge, and the gather's row, fg and
    block are all checked;
  * `upsample_nchw` to 1e-6;
  * losses to 1e-5 (v3 against JAX) and 1e-5 (v3 against v4, the JAX
    package's own check); gradients to 1e-5 relative L2 against JAX and
    1e-4 between v3 and v4 (test_round4_fixes.py holds them to rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.losses import fused_lovasz as jfl

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts, reset_launches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_grad import (
    nchw1_gradient, nchw_grad_plain, nchw_gradient)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    check_nchw, nchw1_histogram, nchw_histogram, nchw_histogram_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import fused_lovasz as fl

GRID_CASES = {
    # N, C, H_pad, W_pad, w_real, B, edges, ignore pixels in the pad lanes
    "c5-w100-1024": (2, 5, 16, 128, 100, 1024, "uniform", False),
    "c17-w128-256-adaptive": (1, 17, 8, 128, 128, 256, "adaptive", True),
    "c25-w125-2048": (1, 25, 8, 128, 125, 2048, "uniform", False),
    "c17-w60-1024-lanes-unmasked": (2, 17, 8, 128, 60, 1024, "uniform", True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def grid_inputs(name, n_scales):
    """S seeded (N, C, H_pad, W_pad) grids; labels with the ignore id and an
    all -1 image, and -1 in the pad lanes unless the case keeps labels
    there (which only w_real then excludes)."""
    n, c, h, w, w_real, *_, labelled_pad = GRID_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + n_scales)
    grids = [(3.0 * rng.standard_normal((n, c, h, w))).astype(np.float32)
             for _ in range(n_scales)]
    labels = rng.integers(-1, c + 1, (n, h, w)).astype(np.int32)
    if not labelled_pad:
        labels[..., w_real:] = -1
    if n > 1:
        labels[-1] = -1
    return grids, labels


def block_table(r_rows, n_buckets, seed=3):
    """(R, 2, B) bf16-valued table, constant on 64-bucket blocks."""
    rng = np.random.default_rng(seed)
    blocks = 1e-3 * rng.standard_normal((r_rows, 2, -(-n_buckets // 64)))
    table = np.repeat(blocks, 64, axis=2)[..., :n_buckets].astype(np.float32)
    return torch.from_numpy(table).to(torch.bfloat16).to(torch.float32)


def jax_table(table):
    """The port's (R, 2, B) [bg, fg] table in the TPU kernels' (R, 2 lo,
    hi) layout."""
    r_rows, _, nb = table.shape
    hi_n, lo_n = jfl._bucket_split(nb)
    t = table.numpy().reshape(r_rows, 2, hi_n, lo_n).transpose(0, 1, 3, 2)
    return jnp.asarray(t.reshape(r_rows, 2 * lo_n, hi_n))


def jax_counts(hist):
    """(R, B, 4) [n_fg, n_bg, ...] -> (R, 2, B) [bg, fg] counts."""
    h = np.asarray(hist)
    return np.stack([h[..., 1], h[..., 0]], axis=1)


@pytest.mark.parametrize("n_scales", [2, 1])
@pytest.mark.parametrize("name", list(GRID_CASES))
def test_nchw_histogram_plain_matches_jax(name, n_scales):
    n, c, h, w, w_real, nb, edges, _ = GRID_CASES[name]
    grids, labels = grid_inputs(name, n_scales)
    jg = [jnp.asarray(g) for g in grids]
    if n_scales == 2:
        want = jfl._nchw_histogram(jg[0], jg[1], jnp.asarray(labels), c,
                                   jfl._pick_bh(h, jfl._FWD_BH_CAP), w_real, nb, edges)
        wrapper = nchw_histogram
    else:
        want = jfl._nchw1_histogram(jg[0], jnp.asarray(labels),
                                    jfl._pick_bh(h, jfl._FWD_BH_CAP), w_real, nb, edges)
        wrapper = nchw1_histogram
    want = jax_counts(want)
    tg = [torch.from_numpy(g) for g in grids]
    lbl = torch.from_numpy(labels)
    got = nchw_histogram_plain(tg, lbl, n_buckets=nb, edges=edges, w_real=w_real)
    assert got.dtype == torch.int32 and got.shape == (n_scales * c, 2, nb)
    np.testing.assert_array_equal(got.numpy().sum((1, 2)), want.sum((1, 2)))
    np.testing.assert_array_equal(got.numpy()[:, 1].sum(1), want[:, 1].sum(1))
    pairs = n_scales * c * int(((labels >= 0) & (np.arange(w) < w_real)).sum())
    assert int(want.sum()) == pairs
    assert np.abs(got.numpy().astype(np.int64) - want).sum() <= 1e-3 * pairs
    reset_launches()
    assert torch.equal(wrapper(tg, lbl, n_buckets=nb, edges=edges, w_real=w_real), got)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("n_scales", [2, 1])
@pytest.mark.parametrize("name", ["c5-w100-1024", "c25-w125-2048",
                                  "c17-w60-1024-lanes-unmasked"])
def test_nchw_grad_plain_matches_jax(name, n_scales):
    n, c, h, w, w_real, nb, edges, _ = GRID_CASES[name]
    grids, labels = grid_inputs(name, n_scales)
    table = block_table(n_scales * c, nb)
    jg = [jnp.asarray(g) for g in grids]
    if n_scales == 2:
        want = jfl._nchw_grad(jg[0], jg[1], jnp.asarray(labels), jax_table(table), c,
                              jfl._pick_bh(h, jfl._BWD_BH_CAP), w_real, nb, edges)
        wrapper = nchw_gradient
    else:
        want = [jfl._nchw1_grad(jg[0], jnp.asarray(labels), jax_table(table),
                                jfl._pick_bh(h, jfl._BWD1_BH_CAP), w_real, nb, edges)]
        wrapper = nchw1_gradient
    tg = [torch.from_numpy(g) for g in grids]
    lbl = torch.from_numpy(labels)
    got = nchw_grad_plain(tg, lbl, table, n_buckets=nb, edges=edges, w_real=w_real)
    assert len(got) == n_scales
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (n, c, h, w)
        assert rel_l2(g.numpy(), np.asarray(wnt)) <= 1e-6
        # nothing flows to a pixel that is not counted
        dead = (labels < 0) | (np.arange(w) >= w_real)
        assert not g.numpy().transpose(0, 2, 3, 1)[dead].any()
    reset_launches()
    again = wrapper(tg, lbl, table, n_buckets=nb, edges=edges, w_real=w_real)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_upsample_nchw_matches_jax(align, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12, 5)).astype(dtype)      # NHWC, as JAX takes it
    want = np.asarray(jfl.upsample_nchw(jnp.asarray(x), (67, 93), align, 128, 72)
                      .astype(jnp.float32))
    got = fl.upsample_nchw(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                           (67, 93), align, 128, 72)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 72, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not got[:, :, 67:].any() and not got[..., 93:].any()


V3_CASES = {
    # N, hs, ws, C, H, W, B, edges, classes_to_ignore
    "c5-1024": (2, 9, 16, 5, 68, 120, 1024, "uniform", None),
    "c17-2048-ignore3": (1, 9, 12, 17, 67, 93, 2048, "uniform", 3),
    "c17-256-adaptive": (2, 5, 8, 17, 40, 60, 256, "adaptive", None),
}


def v3_inputs(name):
    (n, hs, ws, c, h, w, *_rest) = V3_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    li = (3.0 * rng.standard_normal((n, hs, ws, c))).astype(np.float32)
    lf = (3.0 * rng.standard_normal((n, hs, ws, c))).astype(np.float32)
    grid = rng.integers(0, c + 1, (n, h // 4 + 1, w // 4 + 1))
    labels = np.repeat(np.repeat(grid, 4, 1), 4, 2)[:, :h, :w].astype(np.uint8)
    return li, lf, labels


class use_v3:
    """`_USE_V3` set on both packages for the block."""

    def __init__(self, on=True):
        self.on = on

    def __enter__(self):
        self.old = jfl._USE_V3, fl._USE_V3
        jfl._USE_V3 = fl._USE_V3 = self.on

    def __exit__(self, *exc):
        jfl._USE_V3, fl._USE_V3 = self.old


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", list(V3_CASES))
def test_v3_loss_and_gradient_match_jax(name):
    """The two-scale v3 loss (B5/B6's plain versions) against the JAX
    package's v3 loss and its custom VJP; the single-scale one (B7/B8's) is
    held to the JAX package's in test_torch_deeplab.py, with and without
    `_USE_V3`."""
    *_, nb, edges, ignore = V3_CASES[name]
    li, lf, labels = v3_inputs(name)

    def jloss(a, b):
        return jfl.fused_two_scale_bucket_lovasz_s8(
            a, b, jnp.asarray(labels), 0.4, 1.0, classes_to_ignore=ignore,
            n_buckets=nb, edges=edges)

    with use_v3():
        want, want_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            jnp.asarray(li), jnp.asarray(lf))
        want = float(want)
        ts = [nchw(a).requires_grad_(True) for a in (li, lf)]
        reset_launches()
        loss = fl.fused_two_scale_bucket_lovasz_s8(
            *ts, torch.from_numpy(labels), 0.4, 1.0, classes_to_ignore=ignore,
            n_buckets=nb, edges=edges)
        loss.backward()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert abs(float(loss) - want) <= 1e-5
    for t, wg in zip(ts, want_g):
        assert rel_l2(t.grad.numpy(), np.asarray(wg).transpose(0, 3, 1, 2)) <= 1e-5


@pytest.mark.parametrize("two_scale", [True, False])
def test_v3_matches_v4_in_the_port(two_scale):
    """The port's two routes are the same math: loss within 1e-5 and
    gradients within 1e-4 relative L2 (the JAX package's own check,
    test_round4_fixes.py:70-97)."""
    li, lf, labels = v3_inputs("c5-1024")
    lbl = torch.from_numpy(labels)
    results = []
    for v3 in (True, False):
        ts = [nchw(a).requires_grad_(True) for a in ((li, lf) if two_scale else (lf,))]
        with use_v3(v3):
            if two_scale:
                loss = fl.fused_two_scale_bucket_lovasz_s8(*ts, lbl, 0.4, 1.0,
                                                           n_buckets=1024)
            else:
                loss = fl.fused_bucket_lovasz_s8(*ts, lbl, n_buckets=1024)
        loss.backward()
        results.append((float(loss), [t.grad.numpy() for t in ts]))
    (l3, g3), (l4, g4) = results
    assert abs(l3 - l4) <= 1e-5
    for a, b in zip(g3, g4):
        assert rel_l2(a, b) <= 1e-4


def test_dither_under_v3_raises():
    li, lf, labels = v3_inputs("c5-1024")
    with use_v3():
        with pytest.raises(ValueError, match="CADIS_FUSED_V3"):
            fl.fused_bucket_lovasz_s8(nchw(lf), torch.from_numpy(labels),
                                      dither_seed=3)
        with pytest.raises(ValueError, match="CADIS_FUSED_V3"):
            fl.fused_two_scale_bucket_lovasz_s8(nchw(li), nchw(lf),
                                                torch.from_numpy(labels), 0.4,
                                                1.0, dither_seed=0)
    assert np.isfinite(float(fl.fused_bucket_lovasz_s8(
        nchw(lf), torch.from_numpy(labels), dither_seed=3)))


def test_nchw_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.zeros(1, 5, 8, 128)
    lbl = torch.full((1, 8, 128), -1, dtype=torch.int32)
    check_nchw([g, g], lbl, 2, 100)
    with pytest.raises(ValueError):
        check_nchw([g], lbl, 2, 100)                    # one scale for B5/B6
    with pytest.raises(TypeError):
        check_nchw([g.double()], lbl, 1, 100)
    with pytest.raises(TypeError):
        check_nchw([g], lbl.long(), 1, 100)
    with pytest.raises(ValueError):
        check_nchw([g.transpose(2, 3)], lbl, 1, 100)
    with pytest.raises(ValueError):
        check_nchw([torch.zeros(1, 33, 8, 128)], lbl, 1, 100)
    with pytest.raises(ValueError):
        check_nchw([g], lbl, 1, 129)
    with pytest.raises(ValueError, match="2 grid"):
        nchw_histogram([g], lbl, n_buckets=1024, w_real=128)
    with pytest.raises(ValueError, match="CUDA"):
        nchw1_gradient._launch([g], lbl, torch.zeros(5, 2, 1024), None, 1024,
                               "uniform", 128)
