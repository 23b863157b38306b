"""The port's generic bucket Lovász (B3 and B4 plain versions, the CPU
paths of the kernel wrappers) and its Lovász-Softmax routes against the
JAX package's `_bucket_histogram`, `_bucket_grad`, `bucket_lovasz_per_class`,
`lovasz_softmax` and `fused_two_scale_lovasz`, whose Pallas kernels run
here in interpret mode under `jax.jit`, as the JAX package's own tests run
them.

Inputs are made with numpy from a seed; logits enter the JAX side NHWC and
the port NCHW. Tolerances:
  * B3's counts are exact; its error sums within 1e-5 relative of JAX's
    (JAX sums the bf16 errors in float32 in another order; the port's are
    exact fixed-point sums, see kernels/bucket_hist.py), and within one
    float32 rounding of a float64 sum outside bucket 0;
  * B4 equal to 1e-7 (both gather one bf16-rounded table value);
  * losses to 1e-5 absolute and their gradients to a relative L2 of 1e-5
    (float32 softmax and sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.losses.bucket_lovasz import (
    CHUNK, _bucket_grad, _bucket_histogram,
    bucket_lovasz_per_class as jax_bucket_lovasz)
from miccai2021_cataract_semantic_segmentation_tpu.losses.functional import (
    fused_two_scale_lovasz as jax_two_scale, lovasz_softmax as jax_lovasz_softmax)

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    bucket_gather, bucket_gather_plain, bucket_histogram, bucket_histogram_plain,
    launch_counts)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
    _check, bucket_stats_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
    bucket_lovasz_per_class, grad_table)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
    fused_two_scale_lovasz, lovasz_softmax)

P = 5003                      # not a multiple of the TPU kernel's CHUNK


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def bucket_inputs(r_rows: int, kind: str, seed: int = 0):
    """(errors (R, P) float32, fg (R, P) bool) of one kind of row."""
    rng = np.random.default_rng(seed + r_rows)
    fg = rng.random((r_rows, P)) < 0.2
    if kind == "uniform":
        e = rng.random((r_rows, P), dtype=np.float32)
    elif kind == "peaked":                 # most near 0, a pile near 1
        e = (rng.random((r_rows, P)) ** 12).astype(np.float32)
        e[:, ::9] = 1.0 - e[:, ::9] * 1e-3
        e[:, ::13] = 0.0
    elif kind == "ignore":                 # excluded pixels: e = 0, fg = 0
        e = rng.random((r_rows, P), dtype=np.float32)
        e[:, 1000:2500] = 0.0
        fg[:, 1000:2500] = False
    else:                                  # every bucket edge and its neighbours
        k = (np.arange(P // 3 + 1) % 2049).astype(np.float32) / np.float32(2048)
        e = np.concatenate([k, np.nextafter(k, np.float32(2)),
                            np.nextafter(k, np.float32(-1)).clip(0)])[:P]
        e = np.tile(e, (r_rows, 1)).astype(np.float32)
    return e, fg


CASES = [(r, kind) for r in (1, 17) for kind in ("uniform", "peaked", "ignore",
                                                 "edges")]
_jax_hist = jax.jit(_bucket_histogram)
_jax_grad = jax.jit(_bucket_grad)


@pytest.mark.parametrize("r_rows,kind", CASES)
def test_b3_plain_matches_jax_bucket_histogram(r_rows, kind):
    e, fg = bucket_inputs(r_rows, kind)
    assert P % CHUNK
    want = np.asarray(_jax_hist(jnp.asarray(e), jnp.asarray(fg, jnp.float32)))
    got = bucket_histogram_plain(torch.from_numpy(e), torch.from_numpy(fg)).numpy()
    assert got.shape == want.shape == (r_rows, 2048, 4)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    assert got[..., :2].sum() == r_rows * P
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-5, atol=1e-9)
    # against float64 sums of the same bf16 errors: exact but for the one
    # float32 rounding in buckets >= 1; bucket 0 off by < 2^-48 per pixel
    bf = torch.from_numpy(e).to(torch.bfloat16).double().numpy()
    bid = np.minimum((e * np.float32(2048)).astype(np.int32), 2047)
    se64 = np.zeros((r_rows, 2, 2048))
    for r in range(r_rows):
        np.add.at(se64[r], (fg[r].astype(int), bid[r]), bf[r])
    se = got[..., [3, 2]].transpose(0, 2, 1)          # -> (R, [bg, fg], B)
    n0 = got[:, 0, [1, 0]]
    assert np.all(np.abs(se[..., 1:] - se64[..., 1:]) <= 2.0 ** -24 * se64[..., 1:])
    assert np.all(np.abs(se[..., 0] - se64[..., 0])
                  <= 2.0 ** -24 * se64[..., 0] + n0 * 2.0 ** -48)


@pytest.mark.parametrize("r_rows,kind", CASES[::2] + [(17, "edges")])
def test_b4_plain_matches_jax_bucket_grad(r_rows, kind):
    e, fg = bucket_inputs(r_rows, kind, seed=1)
    rng = np.random.default_rng(2)
    g_fg = (1e-3 * rng.standard_normal((r_rows, 2048))).astype(np.float32)
    g_bg = (1e-3 * rng.standard_normal((r_rows, 2048))).astype(np.float32)
    want = np.asarray(_jax_grad(jnp.asarray(e), jnp.asarray(fg, jnp.float32),
                                jnp.asarray(g_fg), jnp.asarray(g_bg)))
    table = grad_table(torch.from_numpy(g_fg), torch.from_numpy(g_bg),
                       torch.ones(r_rows))
    got = bucket_gather_plain(torch.from_numpy(e), torch.from_numpy(fg), table)
    assert got.shape == want.shape == (r_rows, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_bucket_stats_are_order_free_integers():
    """The fixed-point sums: bucket >= 1 values are whole units of 2^-18,
    and permuting the pixels of a row changes nothing, bit for bit."""
    e, fg = bucket_inputs(3, "peaked")
    counts, sums = bucket_stats_plain(torch.from_numpy(e), torch.from_numpy(fg))
    assert counts.dtype == torch.int32 and sums.dtype == torch.int64
    perm = np.random.default_rng(5).permutation(P)
    c2, s2 = bucket_stats_plain(torch.from_numpy(e[:, perm]),
                                torch.from_numpy(fg[:, perm]))
    assert torch.equal(counts, c2) and torch.equal(sums, s2)
    assert int(counts.sum()) == 3 * P


def test_bucket_lovasz_per_class_value_and_grad_match_jax():
    e, fg = bucket_inputs(17, "uniform", seed=3)
    w = np.random.default_rng(4).random(17).astype(np.float32)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda a: jnp.sum(jax_bucket_lovasz(a, jnp.asarray(fg, jnp.float32))
                          * jnp.asarray(w))))(jnp.asarray(e))
    a = torch.from_numpy(e).requires_grad_(True)
    v = torch.sum(bucket_lovasz_per_class(a, torch.from_numpy(fg.astype(np.float32)))
                  * torch.from_numpy(w))
    v.backward()
    assert abs(float(v) - float(want_v)) <= 1e-5
    assert rel_l2(a.grad.numpy(), np.asarray(want_g)) <= 1e-5


N, C, H, W = 2, 5, 24, 40


def seg_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((N, H, W, C))).astype(np.float32)
    grid = rng.integers(0, C + 1, (N, H // 4, W // 4))
    labels = np.repeat(np.repeat(grid, 4, 1), 4, 2).astype(np.uint8)
    labels[0, :4] = C                     # the ignore id is always present
    labels[1, :, :8] = 3                  # class 4 may be absent from image 1
    return logits, labels


LOVASZ = [
    # impl, classes_to_consider, classes_to_ignore, per_image
    ("sort", "present", None, False),
    ("sort", "all", C, False),
    ("sort", [0, 2, 4], None, True),
    ("sort", "present", C, True),
    ("bucket", "present", None, False),
    ("bucket", "all", C, True),
    ("bucket", [1, 3], C, False),
    ("bucket", "present", None, True),
]


@pytest.mark.parametrize("impl,consider,ignore,per_image", LOVASZ)
def test_lovasz_softmax_value_and_grad_match_jax(impl, consider, ignore, per_image):
    logits, labels = seg_inputs()
    kw = dict(classes_to_consider=consider, classes_to_ignore=ignore,
              per_image=per_image, impl=impl)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda lg: jax_lovasz_softmax(lg, jnp.asarray(labels), **kw)))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    v = lovasz_softmax(x, torch.from_numpy(labels), **kw)
    v.backward()
    assert v.dtype == torch.float32 and v.dim() == 0
    assert abs(float(v) - float(want_v)) <= 1e-5
    assert rel_l2(x.grad.numpy(), np.asarray(want_g).transpose(0, 3, 1, 2)) <= 1e-5


@pytest.mark.parametrize("impl,ignore", [("sort", None), ("bucket", C)])
def test_fused_two_scale_lovasz_matches_jax(impl, ignore):
    li, labels = seg_inputs(1)
    lf, _ = seg_inputs(2)
    want_v, want_g = jax.jit(jax.value_and_grad(
        lambda a, b: jax_two_scale(a, b, jnp.asarray(labels), 0.4, 1.0,
                                   classes_to_ignore=ignore, impl=impl),
        argnums=(0, 1)))(jnp.asarray(li), jnp.asarray(lf))
    a, b = (torch.from_numpy(t.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
            for t in (li, lf))
    v = fused_two_scale_lovasz(a, b, torch.from_numpy(labels), 0.4, 1.0,
                               classes_to_ignore=ignore, impl=impl)
    v.backward()
    assert abs(float(v) - float(want_v)) <= 1e-5
    for t, w in ((a, want_g[0]), (b, want_g[1])):
        assert rel_l2(t.grad.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= 1e-5


def test_sort_is_the_exact_oracle_of_bucket():
    """At 2048 buckets the generic route stays within 1e-3 of the exact
    Lovász, its gradient within a few percent (the JAX module's stated
    O(1/B) envelope)."""
    logits, labels = seg_inputs(3)
    vals, grads = {}, {}
    for impl in ("sort", "bucket"):
        x = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
        v = lovasz_softmax(x, torch.from_numpy(labels), impl=impl)
        v.backward()
        vals[impl], grads[impl] = float(v), x.grad.numpy()
    assert abs(vals["bucket"] - vals["sort"]) <= 1e-3
    assert rel_l2(grads["bucket"], grads["sort"]) <= 5e-2


def test_cpu_wrappers_are_the_plain_versions():
    e, fg = bucket_inputs(17, "peaked")
    et, ft = torch.from_numpy(e), torch.from_numpy(fg)
    before = launch_counts()
    assert torch.equal(bucket_histogram(et, ft), bucket_histogram_plain(et, ft))
    table = torch.rand(17, 2, 2048)
    assert torch.equal(bucket_gather(et, ft, table), bucket_gather_plain(et, ft, table))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        bucket_histogram._launch(et, ft)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_gather._launch(et, ft, table)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    e, fg = torch.zeros(3, 10), torch.zeros(3, 10, dtype=torch.bool)
    _check(e, fg)
    with pytest.raises(TypeError):
        _check(e.double(), fg)
    with pytest.raises(TypeError):
        _check(e, fg.float())
    with pytest.raises(ValueError):
        _check(e, fg[:, :5])
    with pytest.raises(ValueError):
        _check(e.t(), fg.t())
    with pytest.raises(ValueError):
        _check(torch.zeros(1, 2 ** 26), torch.zeros(1, 2 ** 26, dtype=torch.bool))
