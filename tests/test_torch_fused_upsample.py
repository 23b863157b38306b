"""P1/P2 (the prototype fused upsample and its transpose) against the
prototype's own TPU kernels, and the port's counterpart of the prototype.

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
    proto_fused_upsample as port_proto)

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
