// B1: fused bucket-Lovász forward histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fu_fwd_kernel`
// (miccai2021_cataract_semantic_segmentation_tpu/losses/fused_lovasz.py:648,
// launched by `_fu_histogram`). For every counted output pixel and every
// class row of each scale it computes what that kernel computes:
//   * bilinear upsample of the stride-8 logits from the 2x2 neighbours with
//     the float32 `_fu_mats` coefficients, height weights first, then width
//     weights (the TPU kernel's matmul order);
//   * softmax over the C classes of the scale;
//   * e = |fg - p|, optionally shifted by the dither (d - 1/2)/B with
//     d = (fmix32(idx ^ seed) & 0xFFFF) / 65536, idx the row-major index over
//     the padded (N, H_pad, W_pad) label grid;
//   * the uniform or adaptive bucket id, and one count in the bg|fg
//     histogram of its (scale, class) row.
// Pixels whose label is -1 (ignored class, row and lane padding) get no
// count; a label >= C (the task's ignore id) is background for every class.
// Output: int32 (R, 2, B), R = n_scales * C, [row][bg, fg][bucket].
//
// What bounds it on the card. Per pixel it reads one label (4 bytes) and
// C x 4 logits that neighbouring pixels share: at the flagship shape (N 8,
// 2 x 17 rows, 544 x 960, B 1024) the bytes it must move (27 MB) take 8 us
// at 3.35 TB/s and its float32 work (16 operations per counted (pixel,
// row) pair, 2.3 G) 34 us at 67 TFLOP/s. What it spends instead is issued
// instructions and their latency: per counted pair the interpolation, the
// share of expf, the IEEE division (its reciprocal, Newton step and range
// check), the bucket id and the count come to about 60 instructions, and
// a warp waits on them in long dependent chains. The first design took
// 1.1 ms at that shape, for three reasons this one removes:
//   * one shared-memory atomic per (pixel, row) on bins that are nearly all
//     the same: errors of neighbouring pixels are close, so the lanes of a
//     warp added into one or a few addresses and the adds serialised;
//   * at B 2048 the 17 rows' int32 bins did not fit one block, so the rows
//     were split over blocks and each block recomputed every pixel's
//     interpolation and softmax;
//   * one 512-thread block per SM (16 warps) to hide that latency.
//
// The design:
//   * Counters are 16 bits, two to a 32-bit word of shared memory (a count
//     in the upper half is an atomicAdd of 1 << 16). The launch plan
//     (kernels/lovasz_hist.py `b1_plan`) caps the pixels each block's
//     table can receive at 65535, so a half never carries into the other.
//     A row takes 4B bytes: 17 rows fit one block at B 2048 (139 KB, one
//     block of 1024 threads an SM), and two blocks of 512 fit an SM at
//     B 1024 (70 KB each). The instances up to 17 classes are held to 64
//     registers so that an SM keeps 32 warps.
//   * Hot bins: bucket 0 of the background half, where most background
//     pairs land once a net has learnt (63 % of all pairs with peaked
//     logits, 6-11 % at random weights), is counted in per-lane 8-bit
//     register counters (four rows a register; the plan caps a lane's
//     pixels at 255) and summed over the warp (__reduce_add_sync) once per
//     block. Every other pair is one shared atomic, issued without a
//     branch: a lane with nothing to count adds to a spare word of its own.
//     Aggregating equal bins over the warp (__match_any_sync) was measured
//     and costs more than the conflicts it saves (tools/fu_hist_ablation.py).
//   * Every block computes all C classes of each of its pixels once per
//     scale. Where a scale's rows do not fit one block (C > 28 at B 2048
//     only), the plan makes a thread-block cluster whose blocks own
//     contiguous shares of the rows; a block adds counts of a partner's row
//     into the partner's shared memory (distributed shared memory), and
//     cluster.sync() comes after the zeroing and before the flush.
//   * Persistent blocks walk 2-D tiles (tile_h rows x 128 columns of one
//     image) without 64-bit division; a warp covers 32 columns of a row, so
//     a warp of lane-pad columns does one label load and moves on. The
//     tile's source window of logits is staged in shared memory, (row,
//     column, class), by cp.async one tile ahead, so a pixel reads four
//     classes of a tap in one 16-byte load with no address arithmetic.
//   * The C 17 kernel of the model paths' bucket map (uniform, no dither)
//     is compiled for that map, so the per-pair bucket id has no branch.
//   * The flush adds each nonzero 16-bit count to the global int32
//     histogram with atomicAdd. Counts are integers, so the order of the
//     atomics cannot change the result: two runs are bit-equal.
//
// Built with -fmad=false: every multiply and add rounds on its own (no
// contraction into FMA). The per-pixel arithmetic lives in fu_common.cuh
// (`tap_combine`, `exp_terms`, `__fdiv_rn`, `dither_shift`,
// `pixel_bucket`), which B2 (fu_grad.cu) shares, so the backward reads the
// gradient of the very bucket this kernel counted.

#include <cooperative_groups.h>

#include "fu_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxClasses = 32;
// bucket 0 of the bg half counted in per-lane registers (the hot-bin scheme)
constexpr bool kHotBins = true;

// The largest block of an instance: 1024 threads at 64 registers where a
// scale's logits fit (MAXC <= 17), else 512 threads at 128 registers.
constexpr int max_threads(int maxc) { return maxc <= 17 ? 1024 : 512; }

struct Params {
  const float* logits;  // (N, R, hs, ws)
  const int* labels;    // (N, h_pad, w_pad), -1 = no count
  const int* h_lo;      // (h_pad,) first source row of each output row
  const float* h_w0;    // (h_pad,) weight of row h_lo
  const float* h_w1;    // (h_pad,) weight of row h_lo + 1
  const int* w_lo;      // (w_pad,) the same for columns
  const float* w_w0;
  const float* w_w1;
  int* out;             // (R, 2, B)
  int n, n_cls, n_rows, hs, ws, h_pad, w_pad;
  // the launch plan (lovasz_hist.py `b1_plan`)
  int tile_h, tile_w_log2, tiles_w, tiles_per_img, n_tiles;
  int groups, rows_per;  // row groups (cluster ranks, or chunks) of a scale
  int win_h, win_w;      // the staged source window of a tile; 0: none
  int win_off;           // its offset in dynamic shared memory, in words
  fu::BucketMap bm;
};

// How a scale's class rows are spread over blocks.
enum Mode {
  kOwn = 0,      // one block holds them all
  kCluster = 1,  // the blocks of a cluster share them (distributed shared memory)
  kSplit = 2,    // blocks of their own split them, each computing every pixel
                 // (the first design's layout at B 2048; for the ablation)
};

// A tile of the scale's output: its image, its first row and column, the
// first source row and column of its window, and the image's logits.
struct Tile {
  int img, y0, x0, wr0, ws0;
  const float* base;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t, int first_row) {
  Tile tl;
  tl.img = t / p.tiles_per_img;
  const int rem = t - tl.img * p.tiles_per_img;
  const int ty = rem / p.tiles_w;
  tl.y0 = ty * p.tile_h;
  tl.x0 = (rem - ty * p.tiles_w) << p.tile_w_log2;
  tl.wr0 = __ldg(p.h_lo + tl.y0);
  tl.ws0 = __ldg(p.w_lo + tl.x0);
  tl.base = p.logits
            + (static_cast<long long>(tl.img) * p.n_rows + first_row) * p.hs * p.ws;
  return tl;
}

// Start copying a tile's window of ncls logits into `win`, (row, column,
// class) with the classes padded to cp, four bytes a copy (cp.async, no
// registers); cells past the source's last row or column are never read.
__device__ __forceinline__ void stage_window(const Params& p, const Tile& tl, int ncls,
                                             int cp, float* win) {
  const int per_class = p.win_h * p.win_w;
  const int plane = p.hs * p.ws;
  for (int i = threadIdx.x; i < per_class * ncls; i += blockDim.x) {
    const int c = i / per_class;
    const int rs = i - c * per_class;
    const int r = rs / p.win_w;
    const int row = tl.wr0 + r, col = tl.ws0 + rs - r * p.win_w;
    if (row < p.hs && col < p.ws) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(win + rs * cp + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(tl.base + c * plane + row * p.ws + col));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// MAXC: the size of the per-pixel class arrays; EXACT: n_cls == MAXC (the
// compiler then drops the per-class guards); MODE: how the rows are spread;
// UNIFORM: uniform buckets without dither (the compiler then drops the
// bucket map's branches; the model paths' map).
template <int MAXC, bool EXACT, int MODE, bool UNIFORM>
__global__ void __launch_bounds__(max_threads(MAXC), 1)
fu_hist_kernel(const Params p) {
  // (rows_per, 2, B) 16-bit counters, one spare word per lane, two windows
  extern __shared__ uint32_t hist[];
  __shared__ uint32_t* row_ptr[kMaxClasses];  // kCluster: each class's row
  const int ncls = EXACT ? MAXC : p.n_cls;
  fu::BucketMap bm = p.bm;
  if constexpr (UNIFORM) {
    bm.adaptive = 0;
    bm.dither = 0;
  }
  const int nb = bm.n_buckets;
  const int scale = blockIdx.y;
  const int lane = threadIdx.x & 31;
  int group = 0, stream = blockIdx.x, n_streams = gridDim.x;
  if constexpr (MODE == kCluster) {
    group = static_cast<int>(cg::this_cluster().block_rank());
  } else if constexpr (MODE == kSplit) {
    group = blockIdx.x % p.groups;
    stream = blockIdx.x / p.groups;
    n_streams = gridDim.x / p.groups;
  }
  const int r_lo = group * p.rows_per;
  const int r_hi = min(r_lo + p.rows_per, ncls);
  const int words = p.rows_per * nb;
  for (int i = threadIdx.x; i < words; i += blockDim.x) hist[i] = 0;
  if constexpr (MODE == kCluster) {
    if (threadIdx.x < ncls) {
      const int c = threadIdx.x;
      row_ptr[c] = cg::this_cluster().map_shared_rank(hist, c / p.rows_per)
                   + (c % p.rows_per) * nb;
    }
    cg::this_cluster().sync();  // partners' tables are zero before any add
  } else {
    __syncthreads();
  }

  uint32_t hot[(MAXC + 3) / 4];  // per lane: bg bucket 0, four 8-bit rows a register
#pragma unroll
  for (int k = 0; k < (MAXC + 3) / 4; ++k) hot[k] = 0;

  // The window of a tile: its source rows h_lo[y0] .. + win_h and columns
  // w_lo[x0] .. + win_w, so that a pixel reads four classes of a tap with
  // one 16-byte load. Two buffers: the next tile's window is copied while
  // this tile's pixels are computed. A pixel whose taps fall outside the
  // window (pad rows and columns: taps 0 with weight 0) reads them from
  // global memory.
  const bool staging = p.win_h > 0;
  const int cp = (ncls + 3) & ~3;
  const int win_words = p.win_h * p.win_w * cp;
  float* const win0 = reinterpret_cast<float*>(hist + p.win_off);
  const int plane = p.hs * p.ws;
  const int tile_w = 1 << p.tile_w_log2;
  const int tile_px = p.tile_h << p.tile_w_log2;
  const int n_mine = stream < p.n_tiles ? (p.n_tiles - 1 - stream) / n_streams + 1 : 0;
  if (staging && n_mine > 0) stage_window(p, tile_at(p, stream, scale * ncls), ncls, cp, win0);
  for (int i = 0; i < n_mine; ++i) {  // uniform across the block
    const Tile tl = tile_at(p, stream + i * n_streams, scale * ncls);
    const float* win = win0 + (i & 1) * win_words;
    if (staging) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // this tile's window is in; the last tile is done
      if (i + 1 < n_mine) {
        stage_window(p, tile_at(p, stream + (i + 1) * n_streams, scale * ncls), ncls, cp,
                     win0 + ((i + 1) & 1) * win_words);
      }
    }
    // tile_px is a multiple of 32: the loop is uniform across each warp
    for (int k = threadIdx.x; k < tile_px; k += blockDim.x) {
      const int y = tl.y0 + (k >> p.tile_w_log2);
      const int x = tl.x0 + (k & (tile_w - 1));
      const int lbl = y < p.h_pad && x < p.w_pad
                          ? __ldg(p.labels + (static_cast<long long>(tl.img) * p.h_pad + y)
                                                 * p.w_pad + x)
                          : -1;
      if (!__any_sync(0xFFFFFFFFu, lbl >= 0)) continue;
      const fu::Taps taps = fu::pixel_taps(min(y, p.h_pad - 1), min(x, p.w_pad - 1), p.hs,
                                           p.ws, p.h_lo, p.h_w0, p.h_w1, p.w_lo, p.w_w0,
                                           p.w_w1);
      const unsigned dr0 = taps.r0 - tl.wr0, dr1 = taps.r1 - tl.wr0;
      const unsigned ds0 = taps.s0 - tl.ws0, ds1 = taps.s1 - tl.ws0;
      const bool staged = dr1 < static_cast<unsigned>(p.win_h) && dr0 <= dr1
                          && ds1 < static_cast<unsigned>(p.win_w) && ds0 <= ds1;
      float z[MAXC];
      if (__all_sync(0xFFFFFFFFu, staged)) {
        const float* w00 = win + (dr0 * p.win_w + ds0) * cp;
        const float* w10 = win + (dr1 * p.win_w + ds0) * cp;
        const float* w01 = win + (dr0 * p.win_w + ds1) * cp;
        const float* w11 = win + (dr1 * p.win_w + ds1) * cp;
#pragma unroll
        for (int c = 0; c < MAXC; c += 4) {
          if (c < ncls) {
            const float4 v00 = *reinterpret_cast<const float4*>(w00 + c);
            const float4 v10 = *reinterpret_cast<const float4*>(w10 + c);
            const float4 v01 = *reinterpret_cast<const float4*>(w01 + c);
            const float4 v11 = *reinterpret_cast<const float4*>(w11 + c);
            z[c] = fu::tap_combine(taps, v00.x, v10.x, v01.x, v11.x);
            if (c + 1 < MAXC) z[c + 1] = fu::tap_combine(taps, v00.y, v10.y, v01.y, v11.y);
            if (c + 2 < MAXC) z[c + 2] = fu::tap_combine(taps, v00.z, v10.z, v01.z, v11.z);
            if (c + 3 < MAXC) z[c + 3] = fu::tap_combine(taps, v00.w, v10.w, v01.w, v11.w);
          }
        }
      } else {
        const int o00 = taps.r0 * p.ws + taps.s0;
        const int o10 = taps.r1 * p.ws + taps.s0;
        const int ds = taps.s1 - taps.s0;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < ncls) {
            const float* lc = tl.base + c * plane;
            z[c] = fu::tap_combine(taps, __ldg(lc + o00), __ldg(lc + o10), __ldg(lc + o00 + ds),
                                   __ldg(lc + o10 + ds));
          }
        }
      }
      float sum;
      fu::exp_terms<MAXC>(ncls, z, sum);
      const uint32_t idx = (static_cast<uint32_t>(tl.img) * p.h_pad + y) * p.w_pad + x;
      const float shift = bm.dither ? fu::dither_shift(idx, bm) : 0.0f;
      const bool counted = lbl >= 0;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c >= ncls) break;
        if (MODE == kSplit && (c < r_lo || c >= r_hi)) continue;
        const bool fg = lbl == c;
        const int b = fu::pixel_bucket(__fdiv_rn(z[c], sum), fg, shift, bm);
        const int half = fg ? nb + b : b;  // 0: bucket 0 of the bg half
        const bool is_hot = kHotBins && half == 0;
        if (kHotBins) hot[c >> 2] += counted && is_hot ? 1u << ((c & 3) << 3) : 0u;
        const bool add = counted && !is_hot;
        const uint32_t one = 1u << ((half & 1) << 4);
        // without a branch: a lane with nothing to count adds to its own
        // spare word, which no other lane touches and nothing reads
        if constexpr (MODE == kCluster) {
          atomicAdd(add ? row_ptr[c] + (half >> 1) : hist + words + lane, one);
        } else {
          atomicAdd(hist + (add ? (c - r_lo) * nb + (half >> 1) : words + lane), one);
        }
      }
    }
  }

  if (kHotBins) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= ncls) break;
      if (MODE == kSplit && (c < r_lo || c >= r_hi)) continue;
      const uint32_t v = __reduce_add_sync(0xFFFFFFFFu, (hot[c >> 2] >> ((c & 3) << 3)) & 0xFFu);
      if (lane == 0 && v) {
        atomicAdd(MODE == kCluster ? row_ptr[c] : hist + (c - r_lo) * nb, v);
      }
    }
  }
  if constexpr (MODE == kCluster) {
    cg::this_cluster().sync();  // every partner's adds have landed
  } else {
    __syncthreads();
  }

  int* out0 = p.out + static_cast<long long>(scale * ncls + r_lo) * 2 * nb;
  const int used = (r_hi - r_lo) * nb;  // words of the rows this block owns
  for (int i = threadIdx.x; i < used; i += blockDim.x) {
    const uint32_t v = hist[i];
    if (v & 0xFFFFu) atomicAdd(out0 + 2 * i, static_cast<int>(v & 0xFFFFu));
    if (v >> 16) atomicAdd(out0 + 2 * i + 1, static_cast<int>(v >> 16));
  }
}

using Kernel = void (*)(const Params);

template <int MODE>
Kernel pick_for(int n_cls) {
  if (n_cls == 17) return fu_hist_kernel<17, true, MODE, false>;
  if (n_cls <= 8) return fu_hist_kernel<8, false, MODE, false>;
  if (n_cls <= 16) return fu_hist_kernel<16, false, MODE, false>;
  if (n_cls <= 24) return fu_hist_kernel<24, false, MODE, false>;
  return fu_hist_kernel<32, false, MODE, false>;
}

// The kernel of a plan: row groups in a cluster, split over blocks (C 17
// only, the ablation's), or one block's; at C 17 with uniform buckets and
// no dither (the model paths), one compiled for that map.
Kernel pick(int n_cls, int groups, bool cluster, bool uniform) {
  if (cluster) return pick_for<kCluster>(n_cls);
  if (groups > 1) return n_cls == 17 ? fu_hist_kernel<17, true, kSplit, false> : nullptr;
  if (n_cls == 17 && uniform) return fu_hist_kernel<17, true, kOwn, true>;
  return pick_for<kOwn>(n_cls);
}

cudaError_t prepare(Kernel kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

cudaLaunchConfig_t config(dim3 grid, int threads, int smem, int groups, bool cluster,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster ? groups : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cfg;
}

bool valid_plan(int n_cls, int threads, int groups, int cluster) {
  return n_cls >= 1 && n_cls <= kMaxClasses && threads >= 32
         && threads <= max_threads(n_cls) && threads % 32 == 0 && groups >= 1 && groups <= 8
         && (cluster == 0 || cluster == 1);
}

}  // namespace

extern "C" {

// The number of blocks of this plan's kernel the device holds at once (a
// whole number of clusters where `cluster` is set), in *resident; returns
// a cudaError_t. The launch plan sizes its grid from it.
int fu_hist_resident(int n_cls, int threads, int smem, int groups, int cluster,
                     int uniform, int device, int* resident) {
  if (!valid_plan(n_cls, threads, groups, cluster)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kern = pick(n_cls, groups, cluster, uniform);
  if (kern == nullptr) return cudaErrorInvalidValue;
  err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  if (cluster) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(dim3(groups, 1), threads, smem, groups, true,
                                          attr, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    *resident = clusters * groups;
  } else {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return err;
    *resident = per_sm * sms;
  }
  return *resident >= (cluster ? groups : 1) ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Returns a cudaError_t: 0 when the launch was accepted. The plan's
// arguments (tile_h .. smem) come from lovasz_hist.py `b1_plan`.
int fu_hist_fwd(const float* logits, const int* labels, const int* h_lo,
                const float* h_w0, const float* h_w1, const int* w_lo,
                const float* w_w0, const float* w_w1, int* out, int n,
                int n_scales, int n_cls, int hs, int ws, int h_pad, int w_pad,
                int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                float a_emin, int dither, int seed, float inv_b, int tile_h,
                int tile_w_log2, int groups, int rows_per, int cluster, int win_h,
                int win_w, int ctas_x, int threads, int smem, int device, void* stream) {
  // the table, a spare word per lane, two windows at a 16-byte boundary
  const int win_off = (rows_per * n_buckets + 32 + 3) & ~3;
  if (!valid_plan(n_cls, threads, groups, cluster) || tile_h < 1 || tile_w_log2 < 5
      || tile_w_log2 > 10 || rows_per * groups < n_cls || ctas_x < groups || ctas_x % groups
      || win_h < 0 || win_w < 0
      || smem < (win_off + 2 * win_h * win_w * ((n_cls + 3) & ~3)) * 4) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.logits = logits;
  p.labels = labels;
  p.h_lo = h_lo;
  p.h_w0 = h_w0;
  p.h_w1 = h_w1;
  p.w_lo = w_lo;
  p.w_w0 = w_w0;
  p.w_w1 = w_w1;
  p.out = out;
  p.n = n;
  p.n_cls = n_cls;
  p.n_rows = n_scales * n_cls;
  p.hs = hs;
  p.ws = ws;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.tile_h = tile_h;
  p.tile_w_log2 = tile_w_log2;
  p.tiles_w = (w_pad + (1 << tile_w_log2) - 1) >> tile_w_log2;
  p.tiles_per_img = p.tiles_w * ((h_pad + tile_h - 1) / tile_h);
  p.n_tiles = n * p.tiles_per_img;
  p.win_h = win_h;
  p.win_w = win_w;
  p.win_off = win_off;
  p.groups = groups;
  p.rows_per = rows_per;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.inv_b = inv_b;
  p.bm.dither = dither;
  p.bm.seed = static_cast<uint32_t>(seed);
  const Kernel kern = pick(n_cls, groups, cluster, !adaptive && !dither);
  if (kern == nullptr) return cudaErrorInvalidValue;
  err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(ctas_x, n_scales), threads, smem, groups,
                                        cluster, attr, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
