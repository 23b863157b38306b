"""Where B6/B8's time goes on the card: the committed kernel beside edited
builds of the same source, other launch plans, and the parent commit's
B6/B8.

    git archive 502417d | tar -x -C build/parent    # once, for the parent
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.nchw_grad_ablation \\
        [--parent build/parent] [--sweep] [--out ablation.json]

It builds kernels/csrc/nchw_grad.cu as committed and edited copies into
build/kernels/ablation/ (a directory .gitignore lists), and the parent's
nchw_grad.cu where --parent names a checkout of it:

    full            the committed kernel and its default plan (the bf16
                    table in shared memory, one scale a block of 1024
                    threads, tiles of two whole rows);
    table_global    the table gathered from global memory with an `__ldg`
                    per pair, as the parent did (same plan, no fill);
    table_f32       a float32 table in shared memory (twice the bytes: at B
                    1024 one block of 1024 threads an SM; B 1024 only);
    global_instance the plan's instance for tables that do not fit (the C
                    32 one, gathering from global memory) at C 17;
    maxc24          the C 17 rows on the MAXC 24 instance (512 threads, its
                    register cap), as the parent ran them;
    grid_stride64   a grid-stride loop over every padded pixel with a 64-bit
                    index, divided and reduced per pixel (the parent's walk);
    both_scales     one block on both scales of its pixels (labels read once,
                    both tables held; two-scale cases at B 1024 only);
    plain_stores    plain stores of the gradient instead of streaming ones;
    evict_first_loads  the logits read with evict-first (streaming) loads
                    instead of through the read-only path;
    t256, t512, t1024  other block sizes;
    no_gather*, no_fill*, no_vjp*  timing only, their gradients wrong: de
                    a constant of the bucket id instead of the table's, the
                    shared table left unfilled, or dz = dp (no sum over the
                    classes, no product);
    parent          the parent commit's B6/B8 (one thread a pixel and scale
                    over the whole grid, the table in global memory, the
                    MAXC 24 instance, 64-bit division per pixel);
    --sweep adds other tile shapes.

At the flagship's grids (two scales of N 8, 17 classes, 544 x 1024, w_real
960, B 1024), the DeepLabv3 cell's (one scale, B 2048) and the flagship's
from peaked logits (std 3 plus 15 on the class of the label under each
stride-8 cell, as a net that has learnt), with the table of the loss on
the forward's counts, it holds every variant's gradient but the timing-only
ones, the parent's included, bit-equal to the committed kernel's and its
bucket ids' counts equal to B5/B7's, then times them in turns (the
variants, then in reverse; median of `reps`) twice: the C entry's call
with the allocation of its outputs (CUDA events), then the kernel's own
device time (torch.profiler). It prints each build's registers and spills
(ptxas). It runs on the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import subprocess

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    SMEM_PER_BLOCK, _ptr, bucket_params, count_fields, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_grad import (
    NchwGradLayout, _grad_lib, nchw_grad_layout, nchw_grad_plain, nchw_grad_plan,
    resident_blocks, run_plan, set_argtypes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    _void, check_nchw, nchw1_histogram, nchw_fields, nchw_histogram, sm_threads)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.bucket_hist_ablation import (
    _median_ms, _nvcc)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
    device_ms)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.nchw_hist_ablation import (
    inputs, registers)

# name: scales, N, C, s8 (hs, ws), (H, W), B, peaked (nchw_hist_ablation's rows)
CASES = {
    "flagship": (2, 8, 17, (68, 120), (544, 960), 1024, False),
    "deeplab_cell": (1, 8, 17, (68, 120), (544, 960), 2048, False),
    "peaked": (2, 8, 17, (68, 120), (544, 960), 1024, True),
}

FILL = "  if constexpr (SMEM) {\n    fill_table(tbl, gtbl, rows);\n    __syncthreads();\n  }\n"
SMEM_GATHER = "    return tbl[at];\n"
FILL_HEAD = ("__device__ __forceinline__ void fill_table(uint16_t* tbl, const float* src, "
             "int count) {\n")
FILL_F32 = """__device__ __forceinline__ void fill_table(uint16_t* tbl, const float* src, int count) {
  float* dst = reinterpret_cast<float*>(tbl);
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ void fill_table_bf16(uint16_t* tbl, const float* src, int count) {
"""
# the tile walk, replaced by a grid-stride loop over every padded pixel with
# a 64-bit index (img and column by 64-bit division and modulo)
WALK = """  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {  // uniform across the block
    const int img = t / p.tiles_per_img;
    const int rem = t - img * p.tiles_per_img;
    const int ty = rem / p.tiles_w;
    const int y0 = ty * p.tile_h;
    const int x0 = (rem - ty * p.tiles_w) << p.tile_w_log2;
    const long long img_at = static_cast<long long>(img) * ncls * p.plane;
"""
STRIDE64 = """  const long long total = static_cast<long long>(p.n_tiles / p.tiles_per_img) * p.plane;
  for (int once = 0; once < 1; ++once) {
    for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x; i0 < total;
         i0 += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = i0 + threadIdx.x;
    const long long img = min(i, total - 1) / p.plane;
    const long long img_at = img * ncls * p.plane;
"""
PIXEL_HEAD = """    for (int k = threadIdx.x; k < tile_px; k += blockDim.x) {
      const int y = y0 + (k >> p.tile_w_log2);
      const int x = x0 + (k & (tile_w - 1));
      const int off = y * p.w_pad + x;
"""
PIXEL_STRIDE64 = """      const int x = static_cast<int>(i % p.w_pad);
      const int off = static_cast<int>(i - img * p.plane);
      const int y = i < total ? 0 : p.h_pad;
"""
# one block on both scales: both tables in shared memory, the scale loop
# around each pixel
SCALE_HEAD = """  const int scale = blockIdx.y;
  const int rows = ncls * 2 * bm.n_buckets;  // table entries of a scale
  const float* gtbl = p.table + static_cast<long long>(scale) * rows;
  if constexpr (SMEM) {
    fill_table(tbl, gtbl, rows);
"""
BOTH_HEAD = """  const int rows = ncls * 2 * bm.n_buckets;  // table entries of a scale
  const float* gtbl = p.table;
  if constexpr (SMEM) {
    fill_table(tbl, gtbl, rows * p.n_scales);
"""
PIXEL_CALL = """      pixel_grad<MAXC, EXACT, SMEM, BIDS>(grid_img + off, out_img + off,
                                          BIDS ? bid_img + off : nullptr, lbl,
                                          y < p.h_pad && x < p.w_pad, p.plane, ncls, bm,
                                          tbl, gtbl);
"""
BOTH_CALL = """      for (int scale = 0; scale < p.n_scales; ++scale) {
        pixel_grad<MAXC, EXACT, SMEM, BIDS>((scale ? p.grid1 : p.grid0) + img_at + off,
                                            (scale ? p.out1 : p.out0) + img_at + off,
                                            BIDS ? bid_img + scale * ncls * p.plane + off
                                                 : nullptr, lbl,
                                            y < p.h_pad && x < p.w_pad, p.plane, ncls, bm,
                                            tbl + scale * rows, gtbl + scale * rows);
      }
"""
BIDS_AT = ("    int* bid_img = BIDS ? p.bids + (img_at * p.n_scales + "
           "static_cast<long long>(scale) * ncls\n                                    * p.plane)\n")
GATHER = "table_bits<SMEM>(tbl, gtbl, 2 * c * nb + (fg ? nb + b : b))"
S_ADD = "      s = __fadd_rn(s, __fmul_rn(__uint_as_float(h << 16), prob));\n"
ZERO_STORE = "          __stcs(dst + c * plane, 0.0f);\n"
GRAD_STORE = "      __stcs(dst + c * plane, counted ? __fmul_rn(z[c], __fsub_rn(dp, s)) : 0.0f);\n"
EDITS = {
    "table_global": ((SMEM_GATHER, "    return bf16_bits(__ldg(gtbl + at));\n"),
                     (FILL, "")),
    "table_f32": ((FILL_HEAD, FILL_F32),
                  (SMEM_GATHER,
                   "    return bf16_bits(reinterpret_cast<const float*>(tbl)[at]);\n")),
    "maxc24": (("  if (n_cls == 17) {\n    return uniform", "  if (false) {\n    return uniform"),
               ("  if (n_cls == 17) return 17;\n", "")),
    "grid_stride64": ((WALK, STRIDE64), (PIXEL_HEAD, PIXEL_STRIDE64),
                      ("  const int tile_w = 1 << p.tile_w_log2;\n", ""),
                      ("  const int tile_px = p.tile_h << p.tile_w_log2;\n", "")),
    "both_scales": ((SCALE_HEAD, BOTH_HEAD),
                    ("  const float* grid = scale ? p.grid1 : p.grid0;\n"
                     "  float* out = scale ? p.out1 : p.out0;\n", ""),
                    ("    const float* grid_img = grid + img_at;\n"
                     "    float* out_img = out + img_at;\n", ""),
                    (BIDS_AT, "    int* bid_img = BIDS ? p.bids + img_at * p.n_scales\n"),
                    (PIXEL_CALL, BOTH_CALL),
                    ("dim3(static_cast<unsigned>(ctas_x), static_cast<unsigned>(n_scales))",
                     "dim3(static_cast<unsigned>(ctas_x), 1u)")),
    "plain_stores": ((ZERO_STORE, ZERO_STORE.replace("__stcs(dst + c * plane, 0.0f)",
                                                     "dst[c * plane] = 0.0f")),
                     (GRAD_STORE, GRAD_STORE.replace("__stcs(dst + c * plane, ",
                                                     "dst[c * plane] = ("))),
    "evict_first_loads": (("counted ? __ldg(src + c * plane)", "counted ? __ldcs(src + c * plane)"),),
    "no_gather*": ((GATHER, "(static_cast<uint32_t>(b) & 0x3F80u)"),),
    "no_fill*": ((FILL, "  __syncthreads();\n"),),
    "no_vjp*": ((S_ADD, ""), (GRAD_STORE, GRAD_STORE.replace(
        "__fmul_rn(z[c], __fsub_rn(dp, s))", "dp"))),
}
PLANS = {f"t{t}": dict(threads=t) for t in (256, 512, 1024)}
SWEEP = {f"h{h}_w{1 << w}": dict(tile_h=h, tile_w_log2=w)
         for h, w in ((1, 10), (4, 10), (2, 9), (4, 9), (4, 8), (8, 8), (8, 7), (16, 7),
                      (32, 7))}


@dataclasses.dataclass(frozen=True)
class WideLayout(NchwGradLayout):
    """A layout whose block holds `tables` times one scale's bf16 table: the
    float32 table, or both scales' tables (2)."""
    tables: int = 1

    @property
    def smem(self) -> int:
        return self.tables * super().smem


def edited_sources() -> dict[str, str]:
    """Each EDITS variant's text of the committed source; raises where an
    edit no longer matches it."""
    src = (build.CSRC / "nchw_grad.cu").read_text()
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source does not hold {old!r} once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(parent: pathlib.Path | None) -> tuple[dict, dict]:
    """nvcc the committed source, every edited one (and the parent's) at
    once with the library's flags; ({name: handle}, {name: ptxas lines})."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {"full": _nvcc(build.CSRC / "nchw_grad.cu", build.CSRC,
                           out_dir / "nchw_grad_full.so")}
    for name, text in edited_sources().items():
        cu = out_dir / f"nchw_grad_{name.rstrip('*')}.cu"
        cu.write_text(text)
        procs[name] = _nvcc(cu, build.CSRC, out_dir / f"nchw_grad_{name.rstrip('*')}.so")
    if parent is not None:
        csrc = parent / "miccai2021_cataract_semantic_segmentation_tpu_torch" / "kernels" / "csrc"
        procs["parent"] = _nvcc(csrc / "nchw_grad.cu", csrc, out_dir / "nchw_grad_parent.so")
    libs, info = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"nchw_grad_{name.rstrip('*')}.so"))
        info[name] = {"ptxas": registers(log)}
        if name == "parent":
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            libs[name].nchw_grad_bwd.argtypes = [vp] * 7 + [i] * 11 + [f, i, vp]
            libs[name].nchw_grad_bwd.restype = ctypes.c_int
        else:
            set_argtypes(libs[name])
    return libs, info


def _parent_call(lib, grids, lbl, table, nb, w_real, bids=None):
    """The parent's C entry: the same inputs, no plan."""
    n, c, h_pad, w_pad = grids[0].shape
    half, shift, q0, e_min, _, _ = bucket_params(nb, "uniform", 0)
    outs = [torch.empty_like(g) for g in grids]
    two = len(grids) == 2
    err = lib.nchw_grad_bwd(
        _ptr(grids[0]), _void(grids[1] if two else None), _ptr(lbl), _ptr(table),
        _ptr(outs[0]), _void(outs[1] if two else None), _void(bids), n, len(grids), c,
        h_pad, w_pad, w_real, nb, 0, half, shift, q0, e_min, lbl.device.index,
        stream_ptr(lbl.device))
    if err != 0:
        raise RuntimeError(f"parent nchw_grad failed with cudaError {err}")
    return outs


def loss_table(grids, lbl, nb: int, w_real: int) -> torch.Tensor:
    """The bf16-rounded table of the loss sum_s w_s * mean over present
    classes of scale s (w = 0.4, 1.0 for two scales, 1.0 for one) on the
    forward's counts (B5/B7): chip_smoke.py's phase-13 table."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        counts_to_hist, grad_table, losses_and_tables)

    s = len(grids)
    counts = (nchw1_histogram, nchw_histogram)[s - 1](grids, lbl, n_buckets=nb,
                                                      w_real=w_real)
    _, gts, g_fg, g_bg = losses_and_tables(counts_to_hist(counts, nb, "uniform"))
    present = (gts > 0).float().reshape(s, -1)
    weights = torch.tensor([[0.4], [1.0]] if s == 2 else [[1.0]], device=lbl.device)
    ct = (weights * present / present.sum(1, keepdim=True).clamp_min(1.0)).reshape(-1)
    return grad_table(g_fg, g_bg, ct), counts


def variant_plan(lib, name: str, c: int, nb: int, n: int, s: int, h_pad: int,
                 w_pad: int, w_real: int, dev: int, plans: dict):
    """A variant's plan, or None where it does not apply to the case."""
    if name in ("table_f32", "both_scales"):
        if name == "both_scales" and s == 1:
            return None         # one scale: the committed kernel's own plan
        base = nchw_grad_layout(c, nb, w_pad)
        smem = 2 * base.smem
        if smem > SMEM_PER_BLOCK:
            return None
        threads = max((256, 512, 1024), key=lambda t: (sm_threads(t, smem, 64), -t))
        layout = WideLayout(c, nb, True, threads, base.tile_h, base.tile_w_log2, 2)
        resident = resident_blocks(lib, layout, dev)
        if name == "both_scales":
            resident *= s       # a block takes both scales: the grid's y is 1
        return nchw_grad_plan(layout, n, s, h_pad, w_pad, w_real, resident=resident)
    if name == "global_instance":
        layout = nchw_grad_layout(c, nb, w_pad, table_smem=False)
    elif name == "maxc24":
        layout = nchw_grad_layout(c, nb, w_pad, threads=512)
    else:
        layout = nchw_grad_layout(c, nb, w_pad, **plans.get(name, {}))
    return nchw_grad_plan(layout, n, s, h_pad, w_pad, w_real,
                          resident=resident_blocks(lib, layout, dev))


def runners(libs, grids, lbl, table, nb, w_real, sweep: bool) -> dict:
    """Each variant's call at one case, and its plan (None for the parent)."""
    n, c, h_pad, w_pad = grids[0].shape
    dev = lbl.device.index
    s = len(grids)
    out = {}
    plans = dict(PLANS, **SWEEP) if sweep else PLANS
    names = ["full", *EDITS, "global_instance", *plans]
    default = nchw_grad_layout(c, nb, w_pad)
    for name in names:
        lib = libs.get(name, libs["full"])
        plan = variant_plan(lib, name, c, nb, n, s, h_pad, w_pad, w_real, dev, plans)
        if plan is None or (name in plans and plan.layout == default):
            continue
        out[name] = (lambda lib=lib, plan=plan: run_plan(lib, plan, grids, lbl, table,
                                                         edges="uniform")), plan
    if "parent" in libs:
        out["parent"] = (lambda: _parent_call(libs["parent"], grids, lbl, table, nb,
                                              w_real)), None
    return out


def check_ids(lib, plan, grids, lbl, table, nb, w_real, counts) -> bool:
    """The committed kernel's bucket ids reproduce the forward's counts."""
    n, c, h_pad, w_pad = grids[0].shape
    bids = torch.empty((n, plan.n_scales * c, h_pad, w_pad), dtype=torch.int32,
                       device=lbl.device)
    ids_plan = dataclasses.replace(plan, ctas_x=min(
        max(resident_blocks(lib, plan.layout, lbl.device.index, bids=True) // plan.n_scales, 1),
        plan.n_tiles))
    run_plan(lib, ids_plan, grids, lbl, table, bids, edges="uniform")
    p, fg, keep, pbid = nchw_fields(grids, lbl, n_buckets=nb, w_real=w_real)
    return bool(torch.equal(count_fields(fg, keep, bids.reshape(pbid.shape).long(), nb),
                            counts))


def main(reps: int = 20, parent: str | None = None, sweep: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    _grad_lib()     # the committed library, built as the wrapper builds it
    libs, info = build_variants(pathlib.Path(parent) if parent else None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for name, item in info.items():
        print(f"build {name}: {json.dumps(item)}", flush=True)
    result = {"card": card, "builds": info}
    for case, (_, _, c, _, (_, w), nb, _) in CASES.items():
        grids, lbl = inputs(case, dev)
        check_nchw(grids, lbl, len(grids), w)
        table, counts = loss_table(grids, lbl, nb, w)
        calls = runners(libs, grids, lbl, table, nb, w, sweep)
        ref = calls["full"][0]()
        if not check_ids(libs["full"], calls["full"][1], grids, lbl, table, nb, w, counts):
            raise AssertionError(f"{case}: the kernel's bucket ids differ from B5/B7's counts")
        plain = nchw_grad_plain(grids, lbl, table, n_buckets=nb, w_real=w)
        max_abs = max(float((a - b).abs().max()) for a, b in zip(ref, plain))
        for name, (fn, plan) in calls.items():
            got = fn()
            if not name.endswith("*") and not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{case} {name}: the gradient differs from the "
                                     "committed kernel's")
            if plan is not None:
                print(f"{case} {name}: plan {plan}", flush=True)
        print(f"{case}: every gradient bit-equal to the committed kernel's "
              f"({', '.join(n for n in calls if not n.endswith('*'))}); the committed "
              f"kernel's largest difference from the plain version {max_abs!r}", flush=True)
        order = list(calls) + list(calls)[::-1]
        times, kernel = {}, {}
        for name in order:
            times.setdefault(name, []).append(_median_ms(calls[name][0], reps))
        for name in order:
            kernel.setdefault(name, []).append(
                device_ms(calls[name][0], reps, kernel="nchw_grad_kernel"))
        print(f"{case} call ms, C entry with its output allocation (CUDA events; two "
              f"turns): {json.dumps(times)}", flush=True)
        print(f"{case} kernel ms (profiler; two turns): {json.dumps(kernel)}", flush=True)
        result[case] = {"call_ms": times, "kernel_ms": kernel, "max_abs_vs_plain": max_abs}
        del grids, lbl, table, ref, plain
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of the parent commit")
    parser.add_argument("--sweep", action="store_true", help="also time other tile shapes")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", help="also write the result as JSON here")
    args = parser.parse_args()
    res = main(args.reps, args.parent, args.sweep)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
