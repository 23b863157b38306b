"""The port's B1 and B2 (plain versions, the CPU paths of the kernel
wrappers) and its two-scale bucket-Lovász loss against the JAX package's
`_fu_core_fwd`, `_fu_grad` and `fused_two_scale_bucket_lovasz_s8` with its
gradient, whose Pallas kernels run here in interpret mode, as the JAX
package's own tests run them.

Inputs are made with numpy from a seed. Logits enter the JAX side NHWC and
the port NCHW (a (0, 3, 1, 2) transpose). Tolerances:
  * each row's total count (and its foreground total) is exact: which
    pixels count does not depend on arithmetic;
  * the L1 distance between the histograms is <= 1e-3 of the counted
    (row, pixel) pairs: float32 interpolation and softmax in another order
    can move an error that sits on a bucket edge by one bucket;
  * the loss agrees to 1e-5 absolute;
  * the loss's gradients with respect to both stride-8 logit tensors, and
    B2's plain version given the same table, agree to a relative L2 of
    1e-5 (measured: 7e-8 to 6.2e-7 over the six cases; the guide for the
    kernel on the card is 1e-4);
  * the bucket-id maps and the fmix32 hash are bit-equal.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.losses import bucket_edges as jbe
from miccai2021_cataract_semantic_segmentation_tpu.losses.fused_lovasz import (
    _FU_BWD_BH_CAP, _FU_FWD_BH_CAP, _fu_core_fwd, _fu_grad, _fu_mats, _fu_prep,
    _pick_bh, fused_two_scale_bucket_lovasz_s8 as jax_fused_loss)

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (
    fu_grad, fu_grad_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    fu_histogram, fu_histogram_plain, fu_mats)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import bucket_edges as be
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
    fu_core_fwd, fused_two_scale_bucket_lovasz_s8, grad_table, pad_labels)

A = (2, 17, 30, 5, 136, 240)        # N, hs, ws, C, H, W
B17 = (2, 9, 16, 17, 68, 120)
ODD = (2, 9, 16, 17, 67, 125)

CASES = {
    # shape, n_buckets, edges, dither seed, classes_to_ignore
    "A-uniform-1024": (A, 1024, "uniform", None, None),
    "A-adaptive-256": (A, 256, "adaptive", None, None),
    "A-uniform-2048-dither7": (A, 2048, "uniform", 7, None),
    "B17-adaptive-1024-dither3": (B17, 1024, "adaptive", 3, None),
    "B17-adaptive8-2048-ignore3": (B17, 2048, "adaptive8", None, 3),
    "odd-uniform-1024-dither123-ignore17": (ODD, 1024, "uniform", 123, 17),
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


def make_inputs(name):
    (n, hs, ws, c, h, w), *_, ignore = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    li = (3.0 * rng.standard_normal((n, hs, ws, c))).astype(np.float32)
    lf = (3.0 * rng.standard_normal((n, hs, ws, c))).astype(np.float32)
    grid = rng.integers(0, c + 1, (n, h // 4 + 1, w // 4 + 1))
    labels = np.repeat(np.repeat(grid, 4, 1), 4, 2)[:, :h, :w]
    labels[0, :3] = c                         # the ignore id is always present
    if ignore == c:
        labels[1] = c                         # an all-ignore image
    return li, lf, labels.astype(np.uint8)


def jax_padded_labels(labels, ignore):
    """The JAX entry's label preparation (fused_lovasz.py:1081-1088)."""
    lbl = labels.astype(np.int32)
    if ignore is not None:
        lbl = np.where(lbl == ignore, -1, lbl)
    n, h, w = lbl.shape
    return np.pad(lbl, ((0, 0), (0, -(-h // 8) * 8 - h),
                        (0, -(-w // 128) * 128 - w)), constant_values=-1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", list(CASES))
def test_b1_and_loss_match_jax(name):
    (n, hs, ws, c, h, w), nb, edges, dseed, ignore = CASES[name]
    li, lf, labels = make_inputs(name)
    lbl_np = jax_padded_labels(labels, ignore)
    dither = dseed is not None
    seed = jnp.asarray([dseed or 0], jnp.int32)
    want = np.asarray(_fu_core_fwd(
        [jnp.asarray(li), jnp.asarray(lf)], jnp.asarray(lbl_np), c,
        _pick_bh(lbl_np.shape[1], _FU_FWD_BH_CAP), (h, w), nb, True, edges,
        seed, dither))

    lbl = pad_labels(torch.from_numpy(labels), ignore)
    np.testing.assert_array_equal(lbl.numpy(), lbl_np)
    got = fu_core_fwd([nchw(li), nchw(lf)], lbl, c, (h, w), nb, True, edges,
                      dseed or 0, dither).numpy()
    assert got.shape == want.shape == (2 * c, nb, 4)
    counts_g, counts_w = got[..., :2], want[..., :2]
    np.testing.assert_array_equal(counts_g.sum((1, 2)), counts_w.sum((1, 2)))
    np.testing.assert_array_equal(counts_g[..., 0].sum(1), counts_w[..., 0].sum(1))
    pairs = 2 * c * int((lbl_np >= 0).sum())
    assert np.abs(counts_g - counts_w).sum() <= 1e-3 * pairs

    kw = dict(classes_to_ignore=ignore, n_buckets=nb, edges=edges,
              dither_seed=dseed)
    warns = dither and edges != "uniform"
    with pytest.warns(UserWarning, match="adaptive") if warns else nullcontext():
        loss = fused_two_scale_bucket_lovasz_s8(
            nchw(li), nchw(lf), torch.from_numpy(labels), 0.4, 1.0, **kw)
    want_loss = float(jax_fused_loss(jnp.asarray(li), jnp.asarray(lf),
                                     jnp.asarray(labels), 0.4, 1.0, **kw))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want_loss) <= 1e-5


def rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_gradient_matches_jax(name):
    """d loss / d (interm, final) stride-8 logits: the port's autograd
    Function (B1 forward, B2's plain version backward) against jax.grad
    of the JAX loss (its custom VJP, `_fu_bwd_kernel` in interpret mode)."""
    (n, hs, ws, c, h, w), nb, edges, dseed, ignore = CASES[name]
    li, lf, labels = make_inputs(name)
    kw = dict(classes_to_ignore=ignore, n_buckets=nb, edges=edges,
              dither_seed=dseed)
    warns = dseed is not None and edges != "uniform"
    with pytest.warns(UserWarning, match="adaptive") if warns else nullcontext():
        want = jax.jit(jax.grad(lambda a, b: jax_fused_loss(
            a, b, jnp.asarray(labels), 0.4, 1.0, **kw), argnums=(0, 1)))(
                jnp.asarray(li), jnp.asarray(lf))
        a, b = nchw(li).requires_grad_(True), nchw(lf).requires_grad_(True)
        fused_two_scale_bucket_lovasz_s8(a, b, torch.from_numpy(labels),
                                         0.4, 1.0, **kw).backward()
    for got, w in ((a.grad, want[0]), (b.grad, want[1])):
        assert got.dtype == torch.float32
        assert rel_l2(got.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= 1e-5


@pytest.mark.parametrize("name", ["A-uniform-1024",
                                  "odd-uniform-1024-dither123-ignore17"])
def test_fu_grad_plain_matches_jax_fu_grad(name):
    """B2's plain version against `_fu_grad` given the same table: a random
    (R, 2, B) table, rounded to bf16, handed to the JAX kernel in its
    (R, [bg lo | fg lo], hi) layout."""
    (n, hs, ws, c, h, w), nb, edges, dseed, ignore = CASES[name]
    li, lf, labels = make_inputs(name)
    lbl_np = jax_padded_labels(labels, ignore)
    r_rows = 2 * c
    hi_n = 32 if nb <= 512 else (64 if nb <= 2048 else 128)
    rng = np.random.default_rng(1)
    table = torch.from_numpy(1e-3 * rng.standard_normal((r_rows, 2, nb)).astype(
        np.float32)).to(torch.bfloat16).to(torch.float32)
    jtbl = table.numpy().reshape(r_rows, 2, hi_n, nb // hi_n)
    jtbl = jtbl.transpose(0, 1, 3, 2).reshape(r_rows, 2 * (nb // hi_n), hi_n)
    h_pad, w_pad = lbl_np.shape[1:]
    hs_pad, ws_pad = -(-hs // 8) * 8, -(-ws // 128) * 128
    mh_t, mw, mw_t = _fu_mats(hs, ws, hs_pad, ws_pad, (h, w), h_pad, w_pad, True)
    ls2d = _fu_prep([jnp.asarray(li), jnp.asarray(lf)], hs_pad, ws_pad)
    dither = dseed is not None
    bh = _pick_bh(h_pad, _FU_BWD_BH_CAP)
    dls = np.asarray(jax.jit(lambda *a: _fu_grad(*a[:6], 2, c, bh, w, nb, edges,
                                                 a[6], dither))(
        ls2d, jnp.asarray(lbl_np), mh_t, mw, mw_t, jnp.asarray(jtbl),
        jnp.asarray([dseed or 0], jnp.int32)))
    want = dls.reshape(n, hs_pad, r_rows, ws_pad)[:, :hs, :, :ws].transpose(0, 2, 1, 3)
    lbl = pad_labels(torch.from_numpy(labels), ignore)
    mats = fu_mats(hs, ws, (h, w), h_pad, w_pad, True, torch.device("cpu"))
    ls = torch.cat([nchw(li), nchw(lf)], 1)
    got = fu_grad_plain(ls, lbl, mats, table, n_cls=c, n_buckets=nb,
                        edges=edges, seed=dseed or 0, dither=dither)
    assert got.shape == want.shape == (n, r_rows, hs, ws)
    assert rel_l2(got.numpy(), want) <= 1e-5


def test_cpu_wrapper_is_the_plain_version():
    li, lf, labels = make_inputs("B17-adaptive-1024-dither3")
    lbl = pad_labels(torch.from_numpy(labels))
    mats = fu_mats(9, 16, (68, 120), lbl.shape[1], lbl.shape[2], True,
                   torch.device("cpu"))
    ls = torch.cat([nchw(li), nchw(lf)], 1)
    kw = dict(n_cls=17, n_buckets=1024, seed=5, dither=True)
    before = fu_histogram.launches, fu_grad.launches
    np.testing.assert_array_equal(fu_histogram(ls, lbl, mats, **kw).numpy(),
                                  fu_histogram_plain(ls, lbl, mats, **kw).numpy())
    table = torch.rand(34, 2, 1024)
    assert torch.equal(fu_grad(ls, lbl, mats, table, **kw),
                       fu_grad_plain(ls, lbl, mats, table, **kw))
    assert (fu_histogram.launches, fu_grad.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fu_grad._launch(ls, lbl, mats, table, None, edges="uniform", **kw)


def test_grad_table_rounds_to_bf16_in_bg_fg_order():
    rng = np.random.default_rng(2)
    g_fg = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    g_bg = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    ct = torch.tensor([0.4, 0.0, 1.0, 0.25], dtype=torch.float64)
    t = grad_table(g_fg, g_bg, ct)
    assert t.shape == (4, 2, 8) and t.dtype == torch.float32
    want_fg = (g_fg * ct.float()[:, None]).to(torch.bfloat16).float()
    assert torch.equal(t[:, 1], want_fg)
    assert torch.equal(t[:, 0], (g_bg * ct.float()[:, None]).to(torch.bfloat16).float())
    assert torch.equal(t[1], torch.zeros(2, 8))


def test_fu_mats_taps_are_the_matrix_entries():
    """The kernel's two taps per output row/column are exactly the nonzero
    entries of the float32 matrices the plain version multiplies by."""
    for hs, ws, out, hp, wp in [(68, 120, (544, 960), 544, 1024),
                                (9, 16, (67, 125), 72, 128)]:
        m = fu_mats(hs, ws, out, hp, wp, True, torch.device("cpu"))
        for mat, lo, w0, w1 in ((m.mh, m.h_lo, m.h_w0, m.h_w1),
                                (m.mw.t(), m.w_lo, m.w_w0, m.w_w1)):
            rebuilt = torch.zeros_like(mat)
            rows = torch.arange(mat.shape[0])
            nxt = torch.clamp_max(lo.long() + 1, mat.shape[1] - 1)
            rebuilt[rows, nxt] += w1
            rebuilt[rows, lo.long()] += w0
            assert torch.equal(rebuilt, mat)
        # B2's ranges: the output rows/columns that read each source index
        for mat, beg, end in ((m.mh, m.h_beg, m.h_end),
                              (m.mw.t(), m.w_beg, m.w_end)):
            for j in range(mat.shape[1]):
                nz = torch.nonzero(mat[:, j]).flatten()
                assert (int(beg[j]), int(end[j])) == (int(nz.min()), int(nz.max()) + 1)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import _check
    lbl = torch.full((1, 8, 128), -1, dtype=torch.int32)
    mats = fu_mats(2, 3, (8, 100), 8, 128, True, torch.device("cpu"))
    ls = torch.zeros(1, 10, 2, 3)
    _check(ls, lbl, mats, 5)
    with pytest.raises(TypeError):
        _check(ls.double(), lbl, mats, 5)
    with pytest.raises(TypeError):
        _check(ls, lbl.long(), mats, 5)
    with pytest.raises(ValueError):
        _check(ls, lbl, mats, 3)                 # 10 rows are not whole scales
    with pytest.raises(ValueError):
        _check(ls.transpose(2, 3), lbl, mats, 5)
    with pytest.raises(ValueError):
        _check(torch.zeros(1, 66, 2, 3), lbl, mats, 33)


def test_loss_is_forward_only_and_checks_buckets():
    """The loss back-propagates into both logit tensors (the name is kept
    from the slice in which it was forward-only), runs under inference
    mode without a graph, and rejects bucket counts the kernels do not
    take."""
    li, lf, labels = make_inputs("A-uniform-1024")
    a, b = nchw(li).requires_grad_(True), nchw(lf).requires_grad_(True)
    loss = fused_two_scale_bucket_lovasz_s8(a, b, torch.from_numpy(labels),
                                            0.4, 1.0)
    assert loss.requires_grad
    loss.backward()
    for t in (a, b):
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().sum()) > 0
    with torch.inference_mode():
        frozen = fused_two_scale_bucket_lovasz_s8(a, b, torch.from_numpy(labels),
                                                  0.4, 1.0)
    assert not frozen.requires_grad and float(frozen) == float(loss)
    with pytest.raises(ValueError, match="bucket count"):
        fused_two_scale_bucket_lovasz_s8(nchw(li), nchw(lf),
                                         torch.from_numpy(labels), 0.4, 1.0,
                                         n_buckets=3000)


def _errors(n_buckets):
    rng = np.random.default_rng(n_buckets)
    k = np.arange(n_buckets + 1, dtype=np.float32) / np.float32(n_buckets)
    special = np.array([0.0, 1.0, 0.5, 2.0 ** -17, 2.0 ** -18, 1e-30,
                        1 - 2.0 ** -17, np.nextafter(np.float32(0.5), 0),
                        -1e-4, 1 + 1e-4], np.float32)
    return np.concatenate([rng.random(4000, dtype=np.float32), k,
                           np.nextafter(k, np.float32(2)),
                           np.nextafter(k, np.float32(-1)), special])


@pytest.mark.parametrize("n_buckets,edges", [
    (256, "uniform"), (1024, "uniform"), (2048, "uniform"),
    (256, "adaptive"), (1024, "adaptive"), (2048, "adaptive8"),
    (1024, "adaptive4")])
def test_bucket_id_bit_equal(n_buckets, edges):
    e = _errors(n_buckets)
    want = jbe.bucket_id_np(e, n_buckets, edges)
    np.testing.assert_array_equal(be.bucket_id_np(e, n_buckets, edges), want)
    got = be.make_bid_fn(n_buckets, edges)(torch.from_numpy(e))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(be.bucket_edges(n_buckets, edges),
                                  jbe.bucket_edges(n_buckets, edges))
    np.testing.assert_array_equal(be.bucket_midpoints_np(n_buckets, edges),
                                  jbe.bucket_midpoints_np(n_buckets, edges))


def test_fmix32_bit_equal():
    rng = np.random.default_rng(11)
    h = np.concatenate([rng.integers(0, 2 ** 32, 5000, dtype=np.uint64),
                        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                                 np.uint64)]).astype(np.uint32)
    want = jbe.fmix32_np(h)
    np.testing.assert_array_equal(be.fmix32_np(h), want)
    got = be.fmix32(torch.from_numpy(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 7, -5, 2 ** 31 + 3])
@pytest.mark.parametrize("n_buckets", [256, 1024])
def test_dithered_bucket_id_bit_equal(seed, n_buckets):
    e = _errors(n_buckets)
    idx = np.arange(e.size, dtype=np.int64) * 977 + 12345
    want = jbe.dithered_bucket_id_np(e, idx, seed, n_buckets)
    np.testing.assert_array_equal(
        be.dithered_bucket_id_np(e, idx, seed, n_buckets), want)
    shifted = torch.from_numpy(e) + be.dither_shift(torch.from_numpy(idx),
                                                    seed, n_buckets)
    got = be.make_bid_fn(n_buckets)(shifted)
    np.testing.assert_array_equal(got.numpy(), want)
