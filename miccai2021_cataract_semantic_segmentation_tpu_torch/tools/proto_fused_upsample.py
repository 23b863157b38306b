"""Counterpart of the prototype tools/proto_fused_upsample.py: the fused
separable upsample of both scales' stride-8 logits (P1) and its transpose
(P2), checked and timed as the prototype's `main` does it.

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.proto_fused_upsample
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.proto_fused_upsample --device cpu

`main` runs on the card unless asked for the CPU, where the wrappers run
their plain versions and the times are the host's. At the prototype's
shape (n 2; (h, ws, C) = (68, 120, 18); 544 x 960 padded to h_pad 72,
ws_pad 128, W_pad 1024) it holds P1 within 1e-4 abs of `upsample_nchw` of
both scales and P2 within 1e-5 (max abs error over the largest value) of
the three-operand einsum: the prototype's looser 3e-2 was for the TPU's
single-pass bf16 products, and these kernels sum in float32. Then, at n 8,
it times P1, P2 and `upsample_nchw` of both scales (median of `reps`, CUDA
events on the card).
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.fused_upsample import (  # noqa: F401
    fused_downsample, fused_downsample_plain, fused_upsample, fused_upsample_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import upsample_nchw
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import interp_matrix

# the prototype's shape: n, (h, ws, C), the output and its pads
PROTO = dict(n=2, h=68, ws=120, c=18, out_hw=(544, 960), h_pad=72,
             ws_pad=128, w_pad=1024)


def upsample_mats(h: int, ws: int, out_hw: tuple[int, int], h_pad: int,
                  ws_pad: int, w_pad: int, align_corners: bool = True,
                  device: str | torch.device = "cpu"):
    """The zero-padded float32 interpolation matrices (mhT (H, h_pad), mw
    (ws_pad, W_pad)), built in float64 and cast once."""
    oh, ow = out_hw
    mh = np.pad(interp_matrix(h, oh, align_corners).T, ((0, h_pad - h), (0, 0)))
    mw = np.pad(interp_matrix(ws, ow, align_corners).T,
                ((0, ws_pad - ws), (0, w_pad - ow)))
    return tuple(torch.as_tensor(np.ascontiguousarray(m), dtype=torch.float32,
                                 device=device) for m in (mh.T, mw))


def prep(logits_i: torch.Tensor, logits_f: torch.Tensor,
         out_hw: tuple[int, int], h_pad: int, ws_pad: int, w_pad: int):
    """The prototype's `_prep` on NCHW logits: both scales (N, C, h, ws)
    stacked as ls2d (N, h_pad, 2C * ws_pad) float32 (row block r of a
    row is class row r, scale-major) and the align_corners=True matrices
    (mhT, mw) of `upsample_mats`, the prototype's only convention."""
    n, c, h, ws = logits_i.shape
    ls = torch.cat([logits_i, logits_f], dim=1).permute(0, 2, 1, 3)   # (N, h, 2C, ws)
    ls = F.pad(ls.to(torch.float32), (0, ws_pad - ws, 0, 0, 0, h_pad - h))
    mhT, mw = upsample_mats(h, ws, out_hw, h_pad, ws_pad, w_pad, True,
                            logits_i.device)
    return ls.reshape(n, h_pad, 2 * c * ws_pad).contiguous(), mhT, mw


def _median_ms(fn, dev: torch.device, reps: int) -> float:
    """Median milliseconds of `fn`: CUDA events on the card, the host's
    clock on the CPU; after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(device: str | torch.device = "cuda", *, n: int = PROTO["n"],
         n_time: int = 8, h: int = PROTO["h"], ws: int = PROTO["ws"],
         c: int = PROTO["c"], out_hw: tuple[int, int] = PROTO["out_hw"],
         h_pad: int = PROTO["h_pad"], ws_pad: int = PROTO["ws_pad"],
         w_pad: int = PROTO["w_pad"], reps: int = 20) -> dict:
    """The prototype's checks at batch `n` and its timings at `n_time`
    (0 skips them); returns the errors and the times in ms."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)

    def logits(batch):
        return [torch.randn((batch, c, h, ws), generator=gen).to(dev)
                for _ in range(2)]

    li, lf = logits(n)
    ls2d, mhT, mw = prep(li, lf, out_hw, h_pad, ws_pad, w_pad)
    got = fused_upsample(ls2d, mhT, mw, 2 * c)
    ref = torch.cat([upsample_nchw(x, out_hw, True, w_pad, out_hw[0])
                     for x in (li, lf)], dim=1)
    err = float((got - ref).abs().max())
    print(f"fwd max abs err vs upsample_nchw: {err!r}", flush=True)
    if not err < 1e-4:
        raise AssertionError(f"P1 differs from upsample_nchw by {err}")

    mwT = mw.t().contiguous()
    d = torch.randn((n, 2 * c, out_hw[0], w_pad), generator=gen).to(dev)
    got_b = fused_downsample(d, mhT, mwT)
    ref_b = torch.einsum("Hh,nrHW,Ww->nrhw", mhT, d, mwT)
    err_b = float((got_b - ref_b).abs().max())
    rel_b = err_b / float(ref_b.abs().max())
    print(f"bwd max abs err: {err_b!r} rel: {rel_b!r}", flush=True)
    if not rel_b < 1e-5:
        raise AssertionError(f"P2 differs from the einsum by {rel_b} (relative)")
    result = {"fwd_max_abs_err": err, "bwd_max_abs_err": err_b, "bwd_rel": rel_b}
    if not n_time:
        return result

    li8, lf8 = logits(n_time)
    ls8, mhT8, mw8 = prep(li8, lf8, out_hw, h_pad, ws_pad, w_pad)
    mwT8 = mw8.t().contiguous()
    d8 = torch.randn((n_time, 2 * c, out_hw[0], w_pad), generator=gen).to(dev)
    where = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    for key, what, fn in (
            ("fused_upsample_ms", f"fused upsample fwd (bs{n_time}, 2x{c}ch)",
             lambda: fused_upsample(ls8, mhT8, mw8, 2 * c)),
            ("fused_downsample_ms", f"fused downsample bwd (bs{n_time})",
             lambda: fused_downsample(d8, mhT8, mwT8)),
            ("upsample_nchw_x2_ms", f"upsample_nchw x2 (bs{n_time})",
             lambda: [upsample_nchw(x, out_hw, True, w_pad, out_hw[0])
                      for x in (li8, lf8)])):
        result[key] = _median_ms(fn, dev, reps)
        print(f"{what}: {result[key]!r} ms ({where}, median of {reps})",
              flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
