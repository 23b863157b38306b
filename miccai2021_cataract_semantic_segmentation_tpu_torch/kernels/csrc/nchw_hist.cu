// B5 and B7: bucket-Lovász forward histogram on full-resolution NCHW logit
// grids, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_nchw_fwd_kernel` (two scales, B5) and
// `_nchw1_fwd_kernel` (one scale, B7) of
// miccai2021_cataract_semantic_segmentation_tpu/losses/fused_lovasz.py
// (:169 and :1119, launched by `_nchw_histogram` and `_nchw1_histogram`),
// the "v3" route that the JAX package keeps behind CADIS_FUSED_V3=1. The
// logits arrive already upsampled (N, C, H_pad, W_pad) per scale; for every
// counted pixel and every class row of each scale it computes what those
// kernels compute:
//   * softmax over the C classes of the scale;
//   * e = |fg - p| and its uniform or adaptive bucket id (no dither: the
//     JAX package refuses dither on this route);
//   * one count in the bg|fg histogram of its (scale, class) row.
// Pixels whose label is -1 (ignored class, row and lane padding) and lanes
// at or past w_real get no count; a label >= C (the task's ignore id) is
// background for every class. Output: int32 (R, 2, B), R = n_scales * C,
// [row][bg, fg][bucket], which is the port's layout (not the TPU kernel's
// (R, hi, 2 lo) one).
//
// What bounds it on the card: it must read the logits of every counted
// pixel once (4 bytes per pixel and row; 564 MB for two scales at N 8,
// C 17 and 540 x 960 counted pixels of a 544 x 1024 grid) and the labels
// of the lanes below w_real: about 0.17 ms at 3.35 TB/s; its float32 work
// (7 operations per pair) is a tenth of that. Issued instructions come
// close behind: about 40 per (pixel, row) pair (the share of expf, the
// IEEE division, the bucket id, the count), 141 M pairs at that shape, so
// 0.18-0.25 ms at the H100's issue rate. The first design took 0.59 ms
// there (0.50 at B 2048, one scale; kernel alone), for three reasons this
// one removes (tools/nchw_hist_ablation.py measures each):
//   * one 512-thread block an SM (16 warps) to hide 17 strided loads and
//     the IEEE division of each pair: 32 warps take a quarter off;
//   * int32 bins: at B 2048 only 14 class rows fit a block, so the 17 rows
//     were split over two blocks that each read and softmaxed every pixel
//     (40 % at B 2048);
//   * a 64-bit division and modulo per pixel in a grid-stride loop (3 %).
//
// The design (B1's, fu_hist.cu, without the interpolation):
//   * One block holds every class row of its scale, so each pixel's
//     softmax is computed once per scale. Its counters are int32 where the
//     rows fit one block with them (17 rows at B 1024: 139 KB, one block of
//     1024 threads an SM), else 16 bits, two to a 32-bit word (bucket b's
//     bg count in the low half, its fg count in the high half, an atomicAdd
//     of 1 << 16): 17 rows at B 2048 take 139 KB, up to 28 rows fit. The
//     launch plan (kernels/nchw_hist.py `nchw_plan`) caps the pixels a
//     16-bit table can receive at 65535, so a half never carries into the
//     other. Where a scale's rows do not fit even so (C > 28 at B 2048
//     only) the plan splits them over blocks that each compute every pixel.
//     int32 counters were measured 12-15 % faster where both fit (one
//     block of 1024 threads, not two of 512; no packed index).
//   * Every pair is one shared atomic, issued without a branch: a lane with
//     nothing to count adds to a spare word of its own. Its operand is a
//     constant (1, or 1 << 16 for a fg count in a 16-bit table), so the
//     compiler makes the adds of 1 ATOMS.POPC.INC, a warp-aggregated
//     increment (measured: the hot bins, bucket 0 of the bg half with 6-11
//     % of pairs at random weights and 63 % with peaked logits, then cost
//     nothing over a spread of bins). B1's per-lane 8-bit register
//     counters for that bin cost 9-12 % here, peaked logits included (the
//     ablation's hot_bins build); an operand chosen at run time (an
//     ATOMS.ADD) serialises equal addresses.
//   * Persistent blocks walk 2-D tiles (tile_h rows x a power-of-two run of
//     columns of one image, up to w_real) with 32-bit tile coordinates: no
//     64-bit division. A warp covers 32 pixels of one row; a warp whose
//     pixels all lie at or past w_real, or are all ignored, skips after
//     its label check and loads no logits. A lane loads the logits only
//     where its pixel counts.
//   * A thread takes one pixel at a time: a warp reads 128 contiguous bytes
//     of each class plane, and its lanes' 17 loads are in flight together.
//     Two or four pixels a thread (8- or 16-byte vectors) need twice the
//     registers and so half the warps, and were measured slower (the
//     ablation's vec2 and vec4 builds).
//   * The C 17 kernel of the model paths' bucket map (uniform, no dither)
//     is compiled for that map, so the per-pair bucket id has no branch.
//   * The flush adds each nonzero count to the global int32 histogram with
//     atomicAdd. Counts are integers, so the order of the atomics cannot
//     change the result: two runs are bit-equal, and equal to the first
//     design's.
//
// Built with -fmad=false, with the softmax and bucket id of fu_common.cuh
// (`exp_terms`, `__fdiv_rn`, `pixel_bucket`), which B6/B8 (nchw_grad.cu)
// share, so the backward reads the gradient of the very bucket this kernel
// counted.

#include <mutex>

#include "fu_common.cuh"

namespace {

constexpr int kMaxClasses = 32;

// The largest block of an instance: 1024 threads at 64 registers where a
// pixel's logits fit (MAXC <= 17), else 512 at 128.
constexpr int max_threads(int maxc) { return maxc <= 17 ? 1024 : 512; }

struct Params {
  const float* grid0;  // (N, C, h_pad, w_pad) logits of scale 0
  const float* grid1;  // the same for scale 1, or null for one scale
  const int* labels;   // (N, h_pad, w_pad), -1 = no count
  int* out;            // (n_scales * C, 2, B)
  int n_cls, h_pad, w_pad, w_real, plane;
  // the launch plan (nchw_hist.py `nchw_plan`)
  int tile_h, tile_w_log2, tiles_w, tiles_per_img, n_tiles;
  int groups, rows_per;  // row groups of a scale (blocks of their own)
  fu::BucketMap bm;
};

// How a scale's class rows are spread over blocks.
enum Mode {
  kOwn = 0,    // one block holds them all
  kSplit = 1,  // blocks of their own split them, each computing every pixel
};

// MAXC: the size of the per-pixel class arrays; EXACT: n_cls == MAXC (the
// compiler then drops the per-class guards); MODE: how the rows are spread;
// UNIFORM: uniform buckets (the compiler then drops the bucket map's
// branches; the model paths' map); PACKED: two 16-bit counters to a word of
// shared memory, else one int32 counter.
template <int MAXC, bool EXACT, int MODE, bool UNIFORM, bool PACKED>
__global__ void __launch_bounds__(max_threads(MAXC), 1)
nchw_hist_kernel(const Params p) {
  // (rows_per, 2, B) counters, then one spare word per lane
  extern __shared__ uint32_t hist[];
  const int ncls = EXACT ? MAXC : p.n_cls;
  fu::BucketMap bm = p.bm;
  bm.dither = 0;  // refused on this route
  if constexpr (UNIFORM) bm.adaptive = 0;
  const int nb = bm.n_buckets;
  const int scale = blockIdx.y;
  const int lane = threadIdx.x & 31;
  int group = 0, stream = blockIdx.x, n_streams = gridDim.x;
  if constexpr (MODE == kSplit) {
    group = blockIdx.x % p.groups;
    stream = blockIdx.x / p.groups;
    n_streams = gridDim.x / p.groups;
  }
  const int r_lo = group * p.rows_per;
  const int r_hi = min(r_lo + p.rows_per, ncls);
  const int row_words = PACKED ? nb : 2 * nb;
  const int words = p.rows_per * row_words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const float* grid = scale ? p.grid1 : p.grid0;
  const int tile_w = 1 << p.tile_w_log2;
  const int tile_px = p.tile_h << p.tile_w_log2;
  for (int t = stream; t < p.n_tiles; t += n_streams) {  // uniform across the block
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
        // int32: word fg * B + b of the row; 16-bit: word b, bg count in the
        // low half, fg count in the high half
        const int word = (c - r_lo) * row_words + (!PACKED && fg ? nb + b : b);
        // a lane with nothing to count adds to its own spare word, which no
        // other lane touches and nothing reads
        uint32_t* const at = hist + (counted ? word : words + lane);
        // constant operands: the compiler makes the add of 1 an increment
        // that the hardware aggregates over lanes with equal addresses
        if (PACKED && fg) {
          atomicAdd(at, 1u << 16);
        } else {
          atomicAdd(at, 1u);
        }
      }
    }
  }
  __syncthreads();

  int* out0 = p.out + static_cast<long long>(scale * ncls + r_lo) * 2 * nb;
  const int used = (r_hi - r_lo) * row_words;  // words of the rows this block owns
  for (int i = threadIdx.x; i < used; i += blockDim.x) {
    const uint32_t v = hist[i];
    if (PACKED) {
      const int bg = i + (i / nb) * nb;  // row i / B, bucket i % B, bg half
      if (v & 0xFFFFu) atomicAdd(out0 + bg, static_cast<int>(v & 0xFFFFu));
      if (v >> 16) atomicAdd(out0 + bg + nb, static_cast<int>(v >> 16));
    } else if (v) {
      atomicAdd(out0 + i, static_cast<int>(v));
    }
  }
}

using Kernel = void (*)(const Params);

template <bool PACKED>
Kernel pick_own(int n_cls, bool uniform) {
  if (n_cls == 17) {
    return uniform ? nchw_hist_kernel<17, true, kOwn, true, PACKED>
                   : nchw_hist_kernel<17, true, kOwn, false, PACKED>;
  }
  if (n_cls <= 8) return nchw_hist_kernel<8, false, kOwn, false, PACKED>;
  if (n_cls <= 16) return nchw_hist_kernel<16, false, kOwn, false, PACKED>;
  if (n_cls <= 24) return nchw_hist_kernel<24, false, kOwn, false, PACKED>;
  return nchw_hist_kernel<32, false, kOwn, false, PACKED>;
}

template <bool PACKED>
Kernel pick_split(int n_cls, bool uniform) {
  return n_cls == 17 && uniform ? nchw_hist_kernel<17, true, kSplit, true, PACKED>
                                : nchw_hist_kernel<32, false, kSplit, false, PACKED>;
}

// The MAXC of the kernel a plan runs (`pick`).
int instance_maxc(int n_cls, int groups, bool uniform) {
  if (groups > 1) return n_cls == 17 && uniform ? 17 : 32;
  if (n_cls == 17) return 17;
  return n_cls <= 8 ? 8 : n_cls <= 16 ? 16 : n_cls <= 24 ? 24 : 32;
}

// The kernel of a plan: rows split over blocks, or one block's; int32 or
// packed 16-bit counters; at C 17 with uniform buckets (the model paths),
// one compiled for that map.
Kernel pick(int n_cls, int groups, bool uniform, bool packed) {
  if (groups > 1) return packed ? pick_split<true>(n_cls, uniform) : pick_split<false>(n_cls, uniform);
  return packed ? pick_own<true>(n_cls, uniform) : pick_own<false>(n_cls, uniform);
}

// The dynamic shared memory a kernel may use, set once per (kernel, device)
// and raised only when a launch needs more.
cudaError_t prepare(Kernel kern, int smem, int device) {
  static std::mutex mu;
  static Kernel kerns[64];
  static int devices[64], sizes[64];
  static int known = 0;
  const std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < known && !(kerns[i] == kern && devices[i] == device)) ++i;
  if (i < known && sizes[i] >= smem) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (i == known && known < 64) {
    kerns[i] = kern;
    devices[i] = device;
    ++known;
  }
  if (i < known) sizes[i] = smem;
  return cudaSuccess;
}

int table_words(int rows_per, int n_buckets, bool packed) {
  return rows_per * n_buckets * (packed ? 1 : 2) + 32;  // and a spare word per lane
}

bool valid_plan(int n_cls, int threads, int groups, bool uniform) {
  return n_cls >= 1 && n_cls <= kMaxClasses && groups >= 1 && groups <= 8 && threads >= 32
         && threads % 32 == 0 && threads <= max_threads(instance_maxc(n_cls, groups, uniform));
}

}  // namespace

extern "C" {

// The number of blocks of this plan's kernel the device holds at once, in
// *resident; returns a cudaError_t. The launch plan sizes its grid from it.
int nchw_hist_resident(int n_cls, int threads, int smem, int groups, int uniform, int packed,
                       int device, int* resident) {
  if (!valid_plan(n_cls, threads, groups, uniform)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kern = pick(n_cls, groups, uniform, packed);
  err = prepare(kern, smem, device);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  return *resident >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Returns a cudaError_t: 0 when the launch was accepted. The plan's
// arguments (tile_h .. smem) come from nchw_hist.py `nchw_plan`.
int nchw_hist_fwd(const float* grid0, const float* grid1, const int* labels, int* out,
                  int n, int n_scales, int n_cls, int h_pad, int w_pad, int w_real,
                  int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                  float a_emin, int tile_h, int tile_w_log2, int groups, int rows_per,
                  int packed, int ctas_x, int threads, int smem, int device, void* stream) {
  const long long plane = static_cast<long long>(h_pad) * w_pad;
  if (!valid_plan(n_cls, threads, groups, !adaptive) || n < 1 || n_scales < 1 || n_scales > 2
      || (n_scales == 2) != (grid1 != nullptr) || h_pad < 1 || w_real < 1 || w_real > w_pad
      || plane >= (1ll << 31) || tile_h < 1 || tile_w_log2 < 5 || tile_w_log2 > 12
      || rows_per * groups < n_cls || (groups - 1) * rows_per >= n_cls || ctas_x < groups
      || ctas_x % groups || n_buckets < 1 || smem < table_words(rows_per, n_buckets, packed) * 4) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.grid0 = grid0;
  p.grid1 = grid1;
  p.labels = labels;
  p.out = out;
  p.n_cls = n_cls;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.w_real = w_real;
  p.plane = static_cast<int>(plane);
  p.tile_h = tile_h;
  p.tile_w_log2 = tile_w_log2;
  // tiles up to w_real: columns past it never count
  p.tiles_w = (w_real + (1 << tile_w_log2) - 1) >> tile_w_log2;
  p.tiles_per_img = p.tiles_w * ((h_pad + tile_h - 1) / tile_h);
  const long long n_tiles = static_cast<long long>(n) * p.tiles_per_img;
  if (n_tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  p.n_tiles = static_cast<int>(n_tiles);
  p.groups = groups;
  p.rows_per = rows_per;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.dither = 0;
  p.bm.seed = 0u;
  p.bm.inv_b = 0.0f;
  const Kernel kern = pick(n_cls, groups, !adaptive, packed);
  err = prepare(kern, smem, device);
  if (err != cudaSuccess) return err;
  kern<<<dim3(static_cast<unsigned>(ctas_x), static_cast<unsigned>(n_scales)), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
