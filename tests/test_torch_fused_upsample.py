"""P1/P2 (the prototype fused upsample and its transpose) against the
prototype's own TPU kernels, the port's counterpart of the prototype, and
the kernels' 3xTF32 arithmetic emulated in numpy.

The prototype tools/proto_fused_upsample.py launches its Pallas kernels
`_fwd_kernel` and `_bwd_kernel` through wrappers that cannot run on the
CPU, and it is not edited; these tests wrap the same kernel bodies in a
`pl.pallas_call(..., interpret=True)` with the prototype's BlockSpecs and
scratch, and hold the port's plain versions (what `fused_upsample` and
`fused_downsample` run for CPU tensors) against them at small shapes, for
both align_corners conventions, to 1e-5 abs: both sides sum in float32,
over <= 4 nonzero taps a term for P1 and a few dozen for P2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from miccai2021_cataract_semantic_segmentation_tpu.losses.fused_lovasz import (
    upsample_nchw as jax_upsample_nchw)
from miccai2021_cataract_semantic_segmentation_tpu.ops.resize import (
    _interp_matrix as jax_interp_matrix)
from tools import proto_fused_upsample as proto

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
    KERNELS, launch_counts)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.fused_upsample import (
    _check, fused_downsample, fused_downsample_plain, fused_upsample,
    fused_upsample_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
    upsample_nchw)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import (
    fused_upsample_ablation, proto_fused_upsample as port_proto)

# n, (h, ws, C) -> out (H, W); pads h_pad, ws_pad, W_pad; block height bh
SMALL = dict(n=1, h=9, ws=15, c=3, out_hw=(64, 112), h_pad=16, ws_pad=16,
             w_pad=128)
BH = 16


def interpret_upsample(ls2d, mhT, mw, n_rows, bh, w_pad, ws_pad, h_pad):
    """The prototype's `fused_upsample` with interpret=True."""
    n, big_h = ls2d.shape[0], mhT.shape[0]
    return pl.pallas_call(
        functools.partial(proto._fwd_kernel, n_rows=n_rows, bh=bh, w=w_pad,
                          ws_pad=ws_pad),
        grid=(n, big_h // bh),
        in_specs=[
            pl.BlockSpec((1, h_pad, n_rows * ws_pad), lambda i, j: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((bh, h_pad), lambda i, j: (j, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((ws_pad, w_pad), lambda i, j: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, n_rows, bh, w_pad), lambda i, j: (i, 0, j, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, n_rows, big_h, w_pad), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bh, n_rows * ws_pad), jnp.float32),
                        pltpu.VMEM((n_rows, bh, w_pad), jnp.float32)],
        interpret=True,
    )(ls2d, mhT, mw)


def interpret_downsample(d_full, mhT, mwT, bh):
    """The prototype's `fused_downsample` with interpret=True."""
    n, n_rows, big_h, w_pad = d_full.shape
    h_pad, ws_pad = mhT.shape[1], mwT.shape[1]
    return pl.pallas_call(
        functools.partial(proto._bwd_kernel, n_rows=n_rows, bh=bh, ws_pad=ws_pad),
        grid=(n, big_h // bh),
        in_specs=[
            pl.BlockSpec((1, n_rows, bh, w_pad), lambda i, j: (i, 0, j, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((bh, h_pad), lambda i, j: (j, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((w_pad, ws_pad), lambda i, j: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, n_rows, h_pad, ws_pad), lambda i, j: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, n_rows, h_pad, ws_pad), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bh, ws_pad), jnp.float32)],
        interpret=True,
    )(d_full, mhT, mwT)


def jax_mats(align):
    """The prototype's `_prep` matrices for either convention, in numpy."""
    s = SMALL
    mh = np.pad(jax_interp_matrix(s["h"], s["out_hw"][0], align).T,
                ((0, s["h_pad"] - s["h"]), (0, 0)))
    mw = np.pad(jax_interp_matrix(s["ws"], s["out_hw"][1], align).T,
                ((0, s["ws_pad"] - s["ws"]), (0, s["w_pad"] - s["out_hw"][1])))
    return mh.T.astype(np.float32), mw.astype(np.float32)


def small_logits(seed):
    s = SMALL
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s["n"], s["h"], s["ws"], s["c"])).astype(np.float32)
            for _ in range(2)]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_prep_matches_the_prototypes():
    """`prep` on NCHW logits gives the prototype's stacked rows and
    align_corners=True matrices exactly; `upsample_mats` gives its
    matrices for either convention."""
    s = SMALL
    li, lf = small_logits(1)
    pads = (s["h_pad"], s["ws_pad"], s["w_pad"])
    want_ls, want_mhT, _, want_mw = proto._prep(jnp.asarray(li), jnp.asarray(lf),
                                                s["out_hw"], *pads)
    ls2d, mhT, mw = port_proto.prep(nchw(li), nchw(lf), s["out_hw"], *pads)
    assert ls2d.shape == (1, s["h_pad"], 2 * s["c"] * s["ws_pad"])
    for got, want in ((ls2d, want_ls), (mhT, want_mhT), (mw, want_mw)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for align in (True, False):
        got = port_proto.upsample_mats(s["h"], s["ws"], s["out_hw"], *pads, align)
        for g, w in zip(got, jax_mats(align)):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("align", [True, False], ids=["align", "acf"])
def test_p1_plain_matches_the_interpreted_tpu_kernel(align):
    """P1's plain version (the CPU path of `fused_upsample`) against the
    prototype's `_fwd_kernel`, and both against `upsample_nchw` of both
    scales."""
    s = SMALL
    li, lf = small_logits(2)
    mhT, mw = jax_mats(align)
    ls2d = np.array(proto._prep(jnp.asarray(li), jnp.asarray(lf), s["out_hw"],
                                s["h_pad"], s["ws_pad"], s["w_pad"])[0])
    want = np.asarray(interpret_upsample(jnp.asarray(ls2d), jnp.asarray(mhT),
                                         jnp.asarray(mw), 2 * s["c"], BH, s["w_pad"],
                                         s["ws_pad"], s["h_pad"]))
    before = launch_counts()
    got = fused_upsample(torch.from_numpy(ls2d), torch.from_numpy(mhT),
                         torch.from_numpy(mw), 2 * s["c"])
    assert launch_counts() == before
    assert got.shape == want.shape == (1, 2 * s["c"], 64, s["w_pad"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = torch.cat([upsample_nchw(nchw(x), s["out_hw"], align, s["w_pad"])
                     for x in (li, lf)], dim=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    jref = np.concatenate([np.asarray(jax_upsample_nchw(jnp.asarray(x), s["out_hw"],
                                                        align_corners=align,
                                                        w_pad=s["w_pad"]))
                           for x in (li, lf)], axis=1)
    np.testing.assert_allclose(want, jref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("align", [True, False], ids=["align", "acf"])
def test_p2_plain_matches_the_interpreted_tpu_kernel(align):
    """P2's plain version (the CPU path of `fused_downsample`) against the
    prototype's `_bwd_kernel`, which sums its row blocks into one
    revisited output block, and against a float64 einsum."""
    s = SMALL
    mhT, mw = jax_mats(align)
    mwT = np.ascontiguousarray(mw.T)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((s["n"], 2 * s["c"], 64, s["w_pad"])).astype(np.float32)
    want = np.asarray(interpret_downsample(jnp.asarray(d), jnp.asarray(mhT),
                                           jnp.asarray(mwT), BH))
    got = fused_downsample(*map(torch.from_numpy, (d, mhT, mwT)))
    assert got.shape == want.shape == (1, 2 * s["c"], s["h_pad"], s["ws_pad"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    f64 = np.einsum("Hh,nrHW,Ww->nrhw", mhT.astype(np.float64), d.astype(np.float64),
                    mwT.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), f64, rtol=0, atol=1e-5)


def test_wrappers_run_the_plain_versions_on_the_cpu_and_launch_nothing():
    """CPU tensors take the plain versions (launch counts unchanged); the
    kernel entries refuse what the kernels do not take; both wrappers are
    in `KERNELS` with the prototype's kernels as what they replace."""
    ls2d, mhT, mw = torch.rand(2, 8, 3 * 16), torch.rand(40, 8), torch.rand(16, 128)
    d = torch.rand(2, 3, 40, 128)
    before = launch_counts()
    assert torch.equal(fused_upsample(ls2d, mhT, mw, 3),
                       fused_upsample_plain(ls2d, mhT, mw, 3))
    assert torch.equal(fused_downsample(d, mhT, mw.t()),
                       fused_downsample_plain(d, mhT, mw.t()))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_upsample._launch(ls2d, mhT, mw, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fused_downsample._launch(d, mhT, mw.t().contiguous())
    assert KERNELS["fused_upsample"] is fused_upsample
    assert KERNELS["fused_downsample"] is fused_downsample
    assert fused_upsample.replaces.endswith("proto_fused_upsample.py:47")
    assert fused_downsample.replaces.endswith("proto_fused_upsample.py:92")


def test_kernel_check_rejects_what_the_kernels_do_not_take():
    cuda = torch.device("cuda", 0)
    meta = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        _check({"x": torch.zeros(4, 4)}, torch.device("cpu"))
    with pytest.raises(ValueError, match="is on"):
        _check({"x": meta}, cuda)


def test_prototype_counterpart_main_runs_on_the_cpu_when_asked():
    """`main(device="cpu")` at a small shape: its checks pass on the plain
    versions and it reports host times; without the card it refuses the
    default device."""
    s = SMALL
    res = port_proto.main("cpu", n=s["n"], n_time=2, h=s["h"], ws=s["ws"], c=s["c"],
                          out_hw=s["out_hw"], h_pad=s["h_pad"], ws_pad=s["ws_pad"],
                          w_pad=s["w_pad"], reps=2)
    assert res["fwd_max_abs_err"] < 1e-4 and res["bwd_rel"] < 1e-5
    assert {"fused_upsample_ms", "fused_downsample_ms", "upsample_nchw_x2_ms"} <= set(res)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_proto.main()


# --- the kernels' arithmetic: 3xTF32 against one TF32 product -------------

def tf32(x: np.ndarray) -> np.ndarray:
    """float32 x rounded to TF32: to nearest, ties away from zero, on the 13
    low mantissa bits of its bit pattern (as `cvt.rna.tf32.f32`)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_matmul(a: np.ndarray, b: np.ndarray, three: bool) -> np.ndarray:
    """float32 a @ b as the kernels sum it: every 8-deep step adds to a
    float32 accumulator small*big, big*small and big*big of the operands'
    TF32 parts (`three`), or big*big alone, each step's product exact."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big)) if three else (
        (a_big, b_big),)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc += step.astype(np.float32)
    return acc


def test_tf32_rounds_to_nearest_ties_away_and_splits_exactly():
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)          # halfway between two TF32 values
    got = tf32(np.array([one + half_ulp, -(one + half_ulp), one + half_ulp / 2,
                         np.float32(3.0)], np.float32))
    np.testing.assert_array_equal(got, [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0])
    x = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    big = tf32(x)
    assert np.all(big.view(np.uint32) & np.uint32(0x1FFF) == 0)
    np.testing.assert_array_equal(big.astype(np.float64) + (x - big).astype(np.float64),
                                  x.astype(np.float64))


PROTO_PLANE = dict(h=68, ws=120, out_hw=(544, 960), h_pad=72, ws_pad=128, w_pad=1024)


@pytest.mark.parametrize("align", [True, False], ids=["align", "acf"])
@pytest.mark.parametrize("kernel", ["p1", "p2"])
def test_three_tf32_products_meet_the_gate_where_one_does_not(kernel, align):
    """One plane at the prototype's shape through both passes as the CUDA
    kernels order and sum them (P1 columns then rows, P2 rows then columns,
    P2's row pass as the transposed product d^T @ mhT): 3xTF32 lies within
    phase 17's 1e-6 relative L2 of float64, one TF32 product does not
    (above 1e-5): the reason for the split."""
    s = PROTO_PLANE
    mhT, mw = (m.numpy() for m in port_proto.upsample_mats(
        s["h"], s["ws"], s["out_hw"], s["h_pad"], s["ws_pad"], s["w_pad"], align))
    rng = np.random.default_rng(11)
    if kernel == "p1":
        x = np.zeros((s["h_pad"], s["ws_pad"]), np.float32)
        x[:s["h"], :s["ws"]] = rng.standard_normal((s["h"], s["ws"]))
        ref = mhT.astype(np.float64) @ x.astype(np.float64) @ mw.astype(np.float64)
    else:
        x = rng.standard_normal((s["out_hw"][0], s["w_pad"])).astype(np.float32)
        mwT = np.ascontiguousarray(mw.T)
        ref = mhT.T.astype(np.float64) @ x.astype(np.float64) @ mwT.astype(np.float64)
    rel = {}
    for three in (True, False):
        if kernel == "p1":
            got = tf32_matmul(mhT, tf32_matmul(x, mw, three), three)
        else:
            dh = tf32_matmul(np.ascontiguousarray(x.T), mhT, three).T
            got = tf32_matmul(np.ascontiguousarray(dh), mwT, three)
        rel[three] = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel[True] <= 1e-6, rel
    assert rel[False] > 1e-5, rel


def test_ablation_edits_match_the_committed_kernel_source():
    """tools/fused_upsample_ablation.py edits the committed source: each of
    its edits still finds its text there, and only `full` is unedited; it
    refuses to run without the card."""
    src = (fused_upsample_ablation.build.CSRC / "fused_upsample.cu").read_text()
    variants = fused_upsample_ablation.sources()
    assert variants["full"] == src
    assert len(set(variants.values())) == len(variants)
    assert [v.count("mma(acc") for v in variants.values()] == [3, 3, 3, 1, 0]
    assert "cvt.rna.tf32.f32 %0" in variants["cvt_split"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused_upsample_ablation.main()
