"""Where B5/B7's time goes on the card: the committed kernel beside edited
builds of the same source, other launch plans, and the parent commit's
B5/B7.

    git archive 5e87d9a | tar -x -C build/parent    # once, for the parent
    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.nchw_hist_ablation \\
        [--parent build/parent] [--sweep] [--out ablation.json]

It builds kernels/csrc/nchw_hist.cu as committed and edited copies into
build/kernels/ablation/ (a directory .gitignore lists), and the parent's
nchw_hist.cu where --parent names a checkout of it:

    full            the committed kernel and its default plan (int32
                    counters at B 1024, 16-bit pairs at B 2048);
    hot_bins        bucket 0 of the bg half counted in per-lane 8-bit register
                    counters, summed over the warp once per block (B1's
                    scheme), every other pair a shared atomic; its plan
                    grows by whole waves until no lane counts more than
                    255 pixels (`lane_capped`);
    variable_operand  the per-pair shared atomic with its operand chosen at
                    run time (1 or 1 << 16, as B1's): an ATOMS.ADD, which
                    the hardware does not aggregate (at int32 counters the
                    operand is 1 either way);
    packed16        16-bit counters two to a word where int32 ones fit (B
                    1024: two blocks of 512 an SM, not one of 1024);
    int32_split     int32 counters where they do not fit one block (B 2048):
                    the 17 rows then take two blocks that each read and
                    softmax every pixel (the first design's layout);
    grid_stride64   a grid-stride loop over every padded pixel with a 64-bit
                    index, divided and reduced per pixel (the first
                    design's walk);
    vec2, vec4      two or four pixels a thread at a time, each class plane
                    and the labels read as 8- or 16-byte vectors (twice the
                    registers: blocks of 512 threads);
    t256, t512, t1024  other block sizes;
    no_pair_atomics*, no_flush*  timing only, their counts wrong: the
                    per-pair shared atomic folded into a register instead,
                    or the flush of the table to the global histogram left
                    out;
    parent          the parent commit's B5/B7 (int32 bins, 512-thread blocks,
                    a 64-bit grid-stride loop);
    --sweep adds other tile shapes.

At the flagship's grids (two scales of N 8, 17 classes, 544 x 1024, w_real
960, B 1024), the DeepLabv3 cell's (one scale, B 2048) and both from
peaked logits (std 3 plus 15 on the class of the label under each
stride-8 cell, as a net that has learnt) it holds every variant's counts
equal to the committed kernel's and those to the plain version, then times
them in turns (the variants, then in reverse; median of `reps`) twice: the
C entry's call with the zeroing of its output (CUDA events), then the
kernel's own device time (torch.profiler). It prints each build's
registers and spills (ptxas) and its shared-memory atomics by SASS opcode
(cuobjdump). It runs on the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import subprocess

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
    COUNT_MAX, LANE_MAX, _ptr, bucket_params, stream_ptr)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
    _hist_lib, _void, check_nchw, nchw_histogram_plain, nchw_layout, nchw_plan,
    resident_blocks, run_plan, set_argtypes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.bucket_hist_ablation import (
    _median_ms, _nvcc, shared_atomics)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_hist_ablation import (
    hot_shares)
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
    device_ms)

# name: scales, N, C, s8 (hs, ws), (H, W), B, peaked
CASES = {
    "flagship": (2, 8, 17, (68, 120), (544, 960), 1024, False),
    "deeplab_cell": (1, 8, 17, (68, 120), (544, 960), 2048, False),
    "peaked": (2, 8, 17, (68, 120), (544, 960), 1024, True),
    "deeplab_peaked": (1, 8, 17, (68, 120), (544, 960), 2048, True),
}

# the hot-bin build: bucket 0 of the bg half counted in per-lane 8-bit
# register counters, four rows a register, summed over the warp once per
# block; every other pair a shared atomic
TILE_LOOP = "  const float* grid = scale ? p.grid1 : p.grid0;\n"
HOT_INIT = """  uint32_t hot[(MAXC + 3) / 4];  // per lane: bg bucket 0, four 8-bit rows a register
#pragma unroll
  for (int k = 0; k < (MAXC + 3) / 4; ++k) hot[k] = 0;
"""
PAIR_AT = "        uint32_t* const at = hist + (counted ? word : words + lane);\n"
HOT_PAIR = """        const bool is_hot = !fg && b == 0;
        hot[c >> 2] += counted && is_hot ? 1u << ((c & 3) << 3) : 0u;
        uint32_t* const at = hist + (counted && !is_hot ? word : words + lane);
"""
FLUSH_START = "  __syncthreads();\n\n  int* out0"
HOT_FLUSH = """#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= ncls) break;
    if (MODE == kSplit && (c < r_lo || c >= r_hi)) continue;
    const uint32_t v = __reduce_add_sync(0xFFFFFFFFu, (hot[c >> 2] >> ((c & 3) << 3)) & 0xFFu);
    if (lane == 0 && v) atomicAdd(hist + (c - r_lo) * row_words, v);
  }
"""
# the vector builds: VEC pixels a thread at a time, each class plane and the
# labels read as one 8- or 16-byte vector, 512 threads a block at most
BOUNDS = "constexpr int max_threads(int maxc) { return maxc <= 17 ? 1024 : 512; }\n"
LOAD_VEC = """constexpr int max_threads(int) { return 512; }

// VEC consecutive values at `src` (VEC-aligned), one load.
template <typename T, typename V>
__device__ __forceinline__ void load_vec(const T* src, T (&v)[VEC]) {
  const V t = __ldg(reinterpret_cast<const V*>(src));
  const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = e[j];
}
"""
PIXEL_LOOP = """    for (int k = threadIdx.x; k < tile_px; k += blockDim.x) {
      const int y = y0 + (k >> p.tile_w_log2);
      const int x = x0 + (k & (tile_w - 1));
      const int off = y * p.w_pad + x;
      const int lbl = y < p.h_pad && x < p.w_real ? __ldg(lbl_img + off) : -1;
      const bool counted = lbl >= 0;
      if (!__any_sync(0xFFFFFFFFu, counted)) continue;

      float z[MAXC];
      const float* src = grid_img + off;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < ncls) {
          z[c] = counted ? __ldg(src) : 0.0f;
          src += p.plane;
        }
      }
      float sum;
      fu::exp_terms<MAXC>(ncls, z, sum);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c >= ncls) break;
        if (MODE == kSplit && (c < r_lo || c >= r_hi)) continue;
        const bool fg = lbl == c;
        const int b = fu::pixel_bucket(__fdiv_rn(z[c], sum), fg, 0.0f, bm);
"""
VEC_LOOP = """    for (int k = threadIdx.x; k < tile_px / VEC; k += blockDim.x) {
      const int y = y0 + ((k * VEC) >> p.tile_w_log2);
      const int x = x0 + ((k * VEC) & (tile_w - 1));
      const int off = y * p.w_pad + x;
      int lbls[VEC];
      if (y < p.h_pad && x < p.w_real) {
        load_vec<int, VEC_INT>(lbl_img + off, lbls);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) lbls[j] = -1;
      }
      bool live = false;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (x + j >= p.w_real) lbls[j] = -1;
        live |= lbls[j] >= 0;
      }
      if (!__any_sync(0xFFFFFFFFu, live)) continue;

      float zs[VEC][MAXC];
      const float* src = grid_img + off;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < ncls) {
          float v[VEC];
          if (live) {
            load_vec<float, VEC_FLOAT>(src, v);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] = 0.0f;
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) zs[j][c] = v[j];
          src += p.plane;
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
      const int lbl = lbls[j];
      const bool counted = lbl >= 0;
      float sum;
      fu::exp_terms<MAXC>(ncls, zs[j], sum);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c >= ncls) break;
        if (MODE == kSplit && (c < r_lo || c >= r_hi)) continue;
        const bool fg = lbl == c;
        const int b = fu::pixel_bucket(__fdiv_rn(zs[j][c], sum), fg, 0.0f, bm);
"""
# the pair loop's end, closed once more around the vector build's pixels
PAIR_END = """          atomicAdd(at, 1u);
        }
      }
    }
  }
"""


def vector_edits(vec: int) -> tuple:
    """The edits of a build that takes `vec` (2 or 4) pixels a thread."""
    head = f"constexpr int VEC = {vec};\n#define VEC_INT int{vec}\n#define VEC_FLOAT float{vec}\n"
    return ((BOUNDS, head + LOAD_VEC), (PIXEL_LOOP, VEC_LOOP),
            (PAIR_END, PAIR_END.replace("      }\n    }\n", "      }\n      }\n    }\n", 1)))


# the tile walk, replaced by a grid-stride loop over every padded pixel
# with a 64-bit index (img and column by 64-bit division and modulo)
WALK = """  for (int t = stream; t < p.n_tiles; t += n_streams) {  // uniform across the block
    const int img = t / p.tiles_per_img;
    const int rem = t - img * p.tiles_per_img;
    const int ty = rem / p.tiles_w;
    const int y0 = ty * p.tile_h;
    const int x0 = (rem - ty * p.tiles_w) << p.tile_w_log2;
    const int* lbl_img = p.labels + static_cast<long long>(img) * p.plane;
    const float* grid_img = grid + static_cast<long long>(img) * ncls * p.plane;
    // tile_px is a multiple of 32: the loop is uniform across each warp
    for (int k = threadIdx.x; k < tile_px; k += blockDim.x) {
      const int y = y0 + (k >> p.tile_w_log2);
      const int x = x0 + (k & (tile_w - 1));
      const int off = y * p.w_pad + x;
"""
STRIDE64 = """  const long long total = static_cast<long long>(p.n_tiles / p.tiles_per_img) * p.plane;
  for (int once = 0; once < 1; ++once) {
    for (long long i0 = static_cast<long long>(stream) * blockDim.x; i0 < total;
         i0 += static_cast<long long>(n_streams) * blockDim.x) {
      const long long i = i0 + threadIdx.x;
      const long long img = min(i, total - 1) / p.plane;
      const int* lbl_img = p.labels + img * p.plane;
      const float* grid_img = grid + img * ncls * p.plane;
      const int x = static_cast<int>(i % p.w_pad);
      const int off = static_cast<int>(i - img * p.plane);
      const int y = i < total ? 0 : p.h_pad;
"""
PAIR_ATOMIC = """        if (PACKED && fg) {
          atomicAdd(at, 1u << 16);
        } else {
          atomicAdd(at, 1u);
        }
"""
FLUSH = """    if (PACKED) {
      const int bg = i + (i / nb) * nb;  // row i / B, bucket i % B, bg half
      if (v & 0xFFFFu) atomicAdd(out0 + bg, static_cast<int>(v & 0xFFFFu));
      if (v >> 16) atomicAdd(out0 + bg + nb, static_cast<int>(v >> 16));
    } else if (v) {
      atomicAdd(out0 + i, static_cast<int>(v));
    }
"""
EDITS = {
    "hot_bins": ((TILE_LOOP, HOT_INIT + TILE_LOOP), (PAIR_AT, HOT_PAIR),
                 (FLUSH_START, HOT_FLUSH + FLUSH_START)),
    "no_pair_atomics*": (
        (PAIR_ATOMIC, "        sink += static_cast<uint32_t>(at - hist) ^ (fg ? 1u : 2u);\n"),
        (TILE_LOOP, "  uint32_t sink = 0;\n" + TILE_LOOP),
        (FLUSH_START, "  if (sink == 0xFFFFFFFFu) hist[0] = 1;\n" + FLUSH_START)),
    "no_flush*": ((FLUSH, "    if (v == 0xFFFFFFFFu) out0[i] = 0;\n"),),
    "variable_operand": ((PAIR_ATOMIC, "        atomicAdd(at, PACKED && fg ? 1u << 16 : 1u);\n"),),
    "vec2": vector_edits(2),
    "vec4": vector_edits(4),
    "grid_stride64": ((WALK, STRIDE64),
                      ("  const int tile_w = 1 << p.tile_w_log2;\n", ""),
                      ("  const int tile_px = p.tile_h << p.tile_w_log2;\n", "")),
}
# nchw_layout's keywords of the plan variants on the committed build, and
# of the edited builds whose plan is not the default one (the vector builds:
# 512 threads, tiles of as many pixels, vec times as wide)
PLANS = {"packed16": dict(packed=True), "int32_split": dict(packed=False)}
PLANS.update({f"t{t}": dict(threads=t) for t in (256, 512, 1024)})
EDIT_PLANS = {f"vec{v}": dict(threads=512, tile_h=16 // v, tile_w_log2=6 + v.bit_length())
              for v in (2, 4)}
SWEEP = {f"h{h}_w{1 << w}": dict(tile_h=h, tile_w_log2=w) for h in (4, 8, 16, 32)
         for w in (7, 8, 10)}


def inputs(name: str, dev):
    """The grids and padded int32 labels of a CASES row: `upsample_nchw`
    (the v3 route's) of seeded stride-8 logits, labels blocky on 8 x 8
    tiles with C + 1 values."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        pad_labels, upsample_nchw)

    scales, n, c, (hs, ws), (h, w), _, peaked = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    grid = rng.integers(0, c + 1, (n, -(-h // 8), -(-w // 8)))
    labels = np.repeat(np.repeat(grid, 8, 1), 8, 2)[:, :h, :w]
    lbl = pad_labels(torch.as_tensor(labels, device=dev))
    h_pad, w_pad = lbl.shape[1:]
    out = []
    for _ in range(scales):
        s8 = 3.0 * rng.standard_normal((n, c, hs, ws))
        if peaked:
            under = labels[:, ::8, ::8][:, :hs, :ws]
            s8 += 15.0 * (under[:, None] == np.arange(c)[None, :, None, None])
        out.append(upsample_nchw(torch.as_tensor(s8, dtype=torch.float32, device=dev),
                                 (h, w), True, w_pad, h_pad).contiguous())
    return out, lbl


def registers(log: str) -> list[str]:
    """ptxas' 'Used N registers ...' and spill lines of a build log."""
    return [line.split("ptxas info    : ")[-1] for line in log.splitlines()
            if ("Used" in line and "registers" in line) or "spill" in line]


def edited_sources() -> dict[str, str]:
    """Each EDITS variant's text of the committed source; raises where an
    edit no longer matches it."""
    src = (build.CSRC / "nchw_hist.cu").read_text()
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
    once with the library's flags; ({name: handle}, {name: ptxas lines and
    SASS shared atomics})."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {"full": _nvcc(build.CSRC / "nchw_hist.cu", build.CSRC,
                           out_dir / "nchw_hist_full.so")}
    for name, text in edited_sources().items():
        cu = out_dir / f"nchw_hist_{name.rstrip('*')}.cu"
        cu.write_text(text)
        procs[name] = _nvcc(cu, build.CSRC, out_dir / f"nchw_hist_{name.rstrip('*')}.so")
    if parent is not None:
        csrc = parent / "miccai2021_cataract_semantic_segmentation_tpu_torch" / "kernels" / "csrc"
        procs["parent"] = _nvcc(csrc / "nchw_hist.cu", csrc, out_dir / "nchw_hist_parent.so")
    libs, info = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        so = out_dir / f"nchw_hist_{name.rstrip('*')}.so"
        libs[name] = ctypes.CDLL(str(so))
        info[name] = {"ptxas": registers(log), "shared_atomics": shared_atomics(so)}
        if name == "parent":
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            libs[name].nchw_hist_fwd.argtypes = [vp] * 4 + [i] * 11 + [f, i, vp]
            libs[name].nchw_hist_fwd.restype = ctypes.c_int
        else:
            set_argtypes(libs[name])
    return libs, info


def _parent_call(lib, grids, lbl, nb, w_real):
    """The parent's C entry: the same inputs, no plan."""
    n, c, h_pad, w_pad = grids[0].shape
    half, shift, q0, e_min, _, _ = bucket_params(nb, "uniform", 0)
    out = torch.zeros((len(grids) * c, 2, nb), dtype=torch.int32, device=lbl.device)
    err = lib.nchw_hist_fwd(
        _ptr(grids[0]), _void(grids[1] if len(grids) == 2 else None), _ptr(lbl),
        _ptr(out), n, len(grids), c, h_pad, w_pad, w_real, nb, 0, half, shift, q0,
        e_min, lbl.device.index, stream_ptr(lbl.device))
    if err != 0:
        raise RuntimeError(f"parent nchw_hist failed with cudaError {err}")
    return out


def lane_pixels(plan) -> int:
    """The most pixels one thread counts under `plan`."""
    return -(-plan.n_tiles // plan.streams) * -(-plan.layout.tile_px // plan.layout.threads)


def lane_capped(plan, resident: int):
    """The hot_bins build's plan: `plan` grown by whole waves until no
    lane's 8-bit register counters count more than LANE_MAX pixels."""
    layout = plan.layout
    per_stream = LANE_MAX // -(-layout.tile_px // layout.threads)
    if per_stream < 1:
        raise ValueError("a tile gives each lane more pixels than 8 bits count")
    wave = max(resident // plan.n_scales // layout.groups, 1)
    need = -(-plan.n_tiles // per_stream)
    streams = min(max(plan.streams, -(-need // wave) * wave), plan.n_tiles)
    return dataclasses.replace(plan, ctas_x=streams * layout.groups)


def stride64_fits(plan) -> bool:
    """The grid-stride walk's 16-bit counters stay in range under `plan`:
    a block receives at most ceil(padded pixels / its pixels a pass)
    passes."""
    layout = plan.layout
    passes = -(-plan.n * plan.h_pad * plan.w_pad // (plan.streams * layout.threads))
    return not layout.packed or passes * layout.threads <= COUNT_MAX


def runners(libs, grids, lbl, nb, w_real, sweep: bool) -> dict:
    """Each variant's call at one case, and its plan (None for the parent)."""
    n, c, h_pad, w_pad = grids[0].shape
    dev = lbl.device.index
    s = len(grids)

    def planned(lib, capped=False, **layout_kw):
        layout = nchw_layout(c, nb, **layout_kw)
        resident = resident_blocks(lib, layout, dev)
        plan = nchw_plan(layout, n, s, h_pad, w_pad, w_real, resident=resident)
        if capped:
            plan = lane_capped(plan, resident)
        return (lambda: run_plan(lib, plan, grids, lbl, edges="uniform")), plan

    full = libs["full"]
    out = {"full": planned(full)}
    for name in EDITS:
        vec = int(name[3:]) if name.startswith("vec") else 1
        if w_pad % vec or any((t.data_ptr() // 4) % vec for t in (*grids, lbl)):
            raise AssertionError(f"{name}: the case's rows are not {4 * vec}-byte aligned")
        out[name] = planned(libs[name], name == "hot_bins", **EDIT_PLANS.get(name, {}))
    if not stride64_fits(out["grid_stride64"][1]):
        raise AssertionError("the grid-stride walk's counters would overflow")
    plans = dict(PLANS, **SWEEP) if sweep else PLANS
    for name, layout_kw in plans.items():
        try:
            layout = nchw_layout(c, nb, **layout_kw)
        except ValueError:
            continue        # the instance does not take it, or it does not fit
        if layout != out["full"][1].layout:
            out[name] = planned(full, **layout_kw)
    if "parent" in libs:
        out["parent"] = (lambda: _parent_call(libs["parent"], grids, lbl, nb, w_real)), None
    return out


def main(reps: int = 20, parent: str | None = None, sweep: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation runs on the card")
    dev = torch.device("cuda")
    _hist_lib()     # the committed library, built as the wrapper builds it
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
        calls = runners(libs, grids, lbl, nb, w, sweep)
        ref = calls["full"][0]()
        plain = nchw_histogram_plain(grids, lbl, n_buckets=nb, w_real=w)
        if not torch.equal(ref, plain):
            raise AssertionError(f"{case}: the committed kernel differs from the plain version")
        for name, (fn, plan) in calls.items():
            if not torch.equal(fn(), ref) and not name.endswith("*"):
                raise AssertionError(f"{case} {name}: counts differ from the committed "
                                     "kernel's")
            if plan is not None:
                print(f"{case} {name}: plan {plan}", flush=True)
        print(f"{case}: hot-bin shares {json.dumps(hot_shares(ref))}", flush=True)
        order = list(calls) + list(calls)[::-1]
        times, kernel = {}, {}
        for name in order:
            times.setdefault(name, []).append(_median_ms(calls[name][0], reps))
        for name in order:
            kernel.setdefault(name, []).append(
                device_ms(calls[name][0], reps, kernel="nchw_hist_kernel"))
        print(f"{case} call ms, C entry with output zeroing (CUDA events; two "
              f"turns): {json.dumps(times)}", flush=True)
        print(f"{case} kernel ms (profiler; two turns): {json.dumps(kernel)}",
              flush=True)
        result[case] = {"call_ms": times, "kernel_ms": kernel,
                        "hot_shares": hot_shares(ref)}
        del grids, lbl, ref, plain
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
