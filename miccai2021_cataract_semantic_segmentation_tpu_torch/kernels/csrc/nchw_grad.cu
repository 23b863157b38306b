// B6 and B8: bucket-Lovász backward on full-resolution NCHW logit grids,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_nchw_bwd_kernel` (two scales, B6) and
// `_nchw1_bwd_kernel` (one scale, B8) of
// miccai2021_cataract_semantic_segmentation_tpu/losses/fused_lovasz.py
// (:353 and :1226 with `_degrad_rows` :307, launched by `_nchw_grad` and
// `_nchw1_grad`). Given the logit grids, the padded labels and the loss's
// per-bucket gradient table, it returns d loss / d grid per scale:
//   1. for every pixel and every class row of each scale, the same softmax,
//      e = |fg - p| and bucket id as B5/B7 (fu_common.cuh, bit for bit);
//   2. de = table[row][fg][bucket], the table being float32 (R, 2, B)
//      [bg, fg] rows already scaled by the cotangent and rounded to bf16 by
//      the caller (the TPU kernel's `tbl_ref[r].astype(bfloat16)`);
//   3. dp = (fg ? -de : de) on counted pixels; a pixel whose label is -1 or
//      whose lane is at or past w_real has dp = 0 and so a zero gradient;
//   4. the softmax VJP dz = p * (dp - sum_c dp * p), the sum over c in
//      ascending order, written as one float32 plane per class.
//
// What bounds it on the card: it reads the logits of every counted pixel
// once and writes every element of the gradient grids once (282 MB read
// and 303 MB written for one scale at N 8, C 17 and 540 x 960 counted
// pixels of a 544 x 1024 grid, twice that for two) plus the labels below
// w_real and the table: about 0.18 ms a scale at 3.35 TB/s. Its float32
// work (7 operations for the softmax and e, 1 for the sign, 4 for the VJP
// per pair) is under a tenth of that, but its issued instructions (about
// 50 a pair: B5/B7's 40, the gather and the VJP) come to two thirds of it
// at the H100's issue rate, so the loads and stores must overlap them.
//
// The first design (one thread per pixel and scale, 256-thread blocks over
// the whole grid) took 0.75 ms for two scales at that shape, 2.1x its
// bound. It ran C 17 on its general C 24 instance (78 registers, so 768
// threads an SM), gathered de with an `__ldg` of one float per pair from
// the (R, 2, B) table in global memory (139 KB a scale at B 1024, 278 KB
// at B 2048, which the streaming logits evict from L1), and divided a
// 64-bit index per pixel. This one (tools/nchw_grad_ablation.py measures
// each choice on the H100):
//   * The C 17 instances (the model paths' class count) are compiled for
//     C 17, so the per-class guards drop, and fit 64 registers, so an SM
//     holds 32 warps; the model paths' one is also compiled for the
//     uniform map, so the bucket id has no branch. The C 24 instance at
//     C 17 is 60 % slower.
//   * A block copies the table rows of its scale into shared memory once,
//     as bf16 (rounded to nearest, which leaves the bf16-valued table the
//     loss builds unchanged): 70 KB at C 17 and B 1024, 139 KB at B 2048.
//     A gather is then one 16-bit shared load; dp = (fg ? -de : de) is a
//     flip of its sign bit, and dp is kept as bf16 bits, two classes to a
//     register. Gathering from global memory instead is 3-18 % slower.
//     Where the rows do not fit the 227 KB a block may hold (C > 28 at B
//     2048), the plan runs the instance that gathers from global memory
//     and rounds each value the same way (an instance chosen by shape).
//   * Persistent blocks of 1024 threads, one wave, each on one scale, walk
//     tiles of whole padded rows (2048 pixels, nchw_grad.py `grad_tile`)
//     with 32-bit tile coordinates: no 64-bit division per pixel, and a
//     block's warps read and write one contiguous run of each class plane.
//     A warp covers 32 pixels of one row, so it reads 128 contiguous bytes
//     of each class plane and writes as many, its lanes' C loads in flight
//     together. A warp none of whose pixels counts (pad rows, lanes at or
//     past w_real, ignored labels) writes its zeros and loads no logit; a
//     lane loads logits only where its pixel counts.
//   * The gradient is written with streaming stores (1-4 % faster than
//     plain ones); the logits are read through the read-only path (2-3 %
//     faster than evict-first loads).
//   * No atomics: every output element has one owner thread and a fixed
//     order of operations, the first design's, so two runs are bit-equal
//     and equal to the first design's gradient.
// Built with -fmad=false like B5/B7.

#include <cuda_bf16.h>

#include <mutex>

#include "fu_common.cuh"

namespace {

constexpr int kMaxClasses = 32;

// The largest block of an instance: 1024 threads at 64 registers where a
// pixel's logits and dp fit (MAXC <= 17), else 512 at 128.
constexpr int max_threads(int maxc) { return maxc <= 17 ? 1024 : 512; }

struct Params {
  const float* grid0;  // (N, C, h_pad, w_pad) logits of scale 0
  const float* grid1;  // scale 1, or null
  const int* labels;   // (N, h_pad, w_pad), -1 = no count
  const float* table;  // (n_scales * C, 2, B) [bg, fg], bf16-valued
  float* out0;         // (N, C, h_pad, w_pad) gradient of scale 0
  float* out1;         // scale 1, or null
  int* bids;           // (N, n_scales * C, h_pad, w_pad) bucket ids, or null
  int n_scales, n_cls, h_pad, w_pad, w_real, plane;
  // the launch plan (nchw_grad.py `nchw_grad_plan`)
  int tile_h, tile_w_log2, tiles_w, tiles_per_img, n_tiles;
  fu::BucketMap bm;
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Copy `count` float32 table entries into shared memory as bf16.
__device__ __forceinline__ void fill_table(uint16_t* tbl, const float* src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    uint2* dst2 = reinterpret_cast<uint2*>(tbl);
    done = count & ~3;
#pragma unroll 4
    for (int i = threadIdx.x; i < done >> 2; i += blockDim.x) {
      const float4 v = __ldg(src4 + i);
      dst2[i] = make_uint2(bf16_bits(v.x) | bf16_bits(v.y) << 16,
                           bf16_bits(v.z) | bf16_bits(v.w) << 16);
    }
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) {
    tbl[i] = static_cast<uint16_t>(bf16_bits(__ldg(src + i)));
  }
}

// The bf16 bits of table entry `at` of the block's scale: from its shared
// copy, or from the float32 table in global memory, rounded as the copy is.
template <bool SMEM>
__device__ __forceinline__ uint32_t table_bits(const uint16_t* tbl, const float* gtbl,
                                               int at) {
  if constexpr (SMEM) {
    return tbl[at];
  } else {
    return bf16_bits(__ldg(gtbl + at));
  }
}

// One pixel of one scale: its gradient (and bucket ids) at `dst` (and
// `bdst`), one class plane `plane` apart, from its logits at `src`.
// `inside`: the pixel lies in the padded grid; `lbl`: its label, -1 where
// it does not count (ignored, or at or past w_real). Warp-uniform call.
template <int MAXC, bool EXACT, bool SMEM, bool BIDS>
__device__ __forceinline__ void pixel_grad(const float* src, float* dst, int* bdst,
                                           int lbl, bool inside, int plane, int n_cls,
                                           const fu::BucketMap& bm, const uint16_t* tbl,
                                           const float* gtbl) {
  const int ncls = EXACT ? MAXC : n_cls;
  const bool counted = lbl >= 0;
  if (!__any_sync(0xFFFFFFFFu, counted)) {
    if (inside) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < ncls) {
          __stcs(dst + c * plane, 0.0f);
          if constexpr (BIDS) bdst[c * plane] = -1;
        }
      }
    }
    return;
  }
  float z[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) z[c] = counted ? __ldg(src + c * plane) : 0.0f;
  }
  float sum;
  fu::exp_terms<MAXC>(ncls, z, sum);
  const int nb = bm.n_buckets;
  uint32_t dpk[(MAXC + 1) / 2];  // dp as bf16 bits, class 2k low, 2k + 1 high
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) {
      const float prob = __fdiv_rn(z[c], sum);
      const bool fg = lbl == c;
      const int b = fu::pixel_bucket(prob, fg, 0.0f, bm);
      if constexpr (BIDS) {
        if (inside) bdst[c * plane] = counted ? b : -1;
      }
      // dp = (fg ? -de : de): de's bf16 bits with the sign flipped
      const uint32_t h =
          table_bits<SMEM>(tbl, gtbl, 2 * c * nb + (fg ? nb + b : b)) ^ (fg ? 0x8000u : 0u);
      dpk[c >> 1] = (c & 1) ? dpk[c >> 1] | h << 16 : h;
      z[c] = prob;
      s = __fadd_rn(s, __fmul_rn(__uint_as_float(h << 16), prob));
    }
  }
  if (!inside) return;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) {
      const float dp =
          __uint_as_float((c & 1) ? dpk[c >> 1] & 0xFFFF0000u : dpk[c >> 1] << 16);
      __stcs(dst + c * plane, counted ? __fmul_rn(z[c], __fsub_rn(dp, s)) : 0.0f);
    }
  }
}

// MAXC: the size of the per-pixel class arrays; EXACT: n_cls == MAXC (the
// compiler then drops the per-class guards); UNIFORM: uniform buckets (the
// compiler then drops the bucket map's branches; the model paths' map);
// SMEM: the table in shared memory, else gathered from global memory;
// BIDS: also write the bucket ids.
template <int MAXC, bool EXACT, bool UNIFORM, bool SMEM, bool BIDS>
__global__ void __launch_bounds__(max_threads(MAXC), 1)
nchw_grad_kernel(const Params p) {
  extern __shared__ __align__(16) uint16_t tbl[];  // (C, 2, B) bf16 of the block's scale
  const int ncls = EXACT ? MAXC : p.n_cls;
  fu::BucketMap bm = p.bm;
  bm.dither = 0;  // refused on this route
  if constexpr (UNIFORM) bm.adaptive = 0;
  const int scale = blockIdx.y;
  const int rows = ncls * 2 * bm.n_buckets;  // table entries of a scale
  const float* gtbl = p.table + static_cast<long long>(scale) * rows;
  if constexpr (SMEM) {
    fill_table(tbl, gtbl, rows);
    __syncthreads();
  }
  const float* grid = scale ? p.grid1 : p.grid0;
  float* out = scale ? p.out1 : p.out0;
  const int tile_w = 1 << p.tile_w_log2;
  const int tile_px = p.tile_h << p.tile_w_log2;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {  // uniform across the block
    const int img = t / p.tiles_per_img;
    const int rem = t - img * p.tiles_per_img;
    const int ty = rem / p.tiles_w;
    const int y0 = ty * p.tile_h;
    const int x0 = (rem - ty * p.tiles_w) << p.tile_w_log2;
    const long long img_at = static_cast<long long>(img) * ncls * p.plane;
    const int* lbl_img = p.labels + static_cast<long long>(img) * p.plane;
    const float* grid_img = grid + img_at;
    float* out_img = out + img_at;
    int* bid_img = BIDS ? p.bids + (img_at * p.n_scales + static_cast<long long>(scale) * ncls
                                    * p.plane)
                        : nullptr;
    // tile_px is a multiple of 32: the loop is uniform across each warp
    for (int k = threadIdx.x; k < tile_px; k += blockDim.x) {
      const int y = y0 + (k >> p.tile_w_log2);
      const int x = x0 + (k & (tile_w - 1));
      const int off = y * p.w_pad + x;
      const int lbl = y < p.h_pad && x < p.w_real ? __ldg(lbl_img + off) : -1;
      pixel_grad<MAXC, EXACT, SMEM, BIDS>(grid_img + off, out_img + off,
                                          BIDS ? bid_img + off : nullptr, lbl,
                                          y < p.h_pad && x < p.w_pad, p.plane, ncls, bm,
                                          tbl, gtbl);
    }
  }
}

using Kernel = void (*)(const Params);

template <bool BIDS>
Kernel pick_smem(int n_cls, bool uniform) {
  if (n_cls == 17) {
    return uniform ? nchw_grad_kernel<17, true, true, true, BIDS>
                   : nchw_grad_kernel<17, true, false, true, BIDS>;
  }
  if (n_cls <= 8) return nchw_grad_kernel<8, false, false, true, BIDS>;
  if (n_cls <= 16) return nchw_grad_kernel<16, false, false, true, BIDS>;
  if (n_cls <= 24) return nchw_grad_kernel<24, false, false, true, BIDS>;
  return nchw_grad_kernel<32, false, false, true, BIDS>;
}

// The kernel of a plan: the table in shared memory (C 17's own instances,
// the one for the uniform map being the model paths'; else 8, 16, 24 or 32
// classes), or, where it does not fit, gathered from global memory (the C
// 32 instance); with or without the bucket-id output.
Kernel pick(int n_cls, bool uniform, bool smem, bool bids) {
  if (!smem) {
    return bids ? nchw_grad_kernel<32, false, false, false, true>
                : nchw_grad_kernel<32, false, false, false, false>;
  }
  return bids ? pick_smem<true>(n_cls, uniform) : pick_smem<false>(n_cls, uniform);
}

// The MAXC of the kernel a plan runs (`pick`).
int instance_maxc(int n_cls, bool smem) {
  if (!smem) return kMaxClasses;
  if (n_cls == 17) return 17;
  return n_cls <= 8 ? 8 : n_cls <= 16 ? 16 : n_cls <= 24 ? 24 : 32;
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

bool valid_plan(int n_cls, int threads, bool smem) {
  return n_cls >= 1 && n_cls <= kMaxClasses && threads >= 32 && threads % 32 == 0
         && threads <= max_threads(instance_maxc(n_cls, smem));
}

}  // namespace

extern "C" {

// The number of blocks of this plan's kernel the device holds at once, in
// *resident; returns a cudaError_t. The launch plan sizes its grid from it.
int nchw_grad_resident(int n_cls, int threads, int smem, int uniform, int table_smem, int bids,
                       int device, int* resident) {
  if (!valid_plan(n_cls, threads, table_smem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kern = pick(n_cls, uniform, table_smem, bids);
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
// arguments (tile_h .. smem) come from nchw_grad.py `nchw_grad_plan`.
int nchw_grad_bwd(const float* grid0, const float* grid1, const int* labels,
                  const float* table, float* out0, float* out1, int* bids, int n,
                  int n_scales, int n_cls, int h_pad, int w_pad, int w_real,
                  int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                  float a_emin, int tile_h, int tile_w_log2, int table_smem, int ctas_x,
                  int threads, int smem, int device, void* stream) {
  const long long plane = static_cast<long long>(h_pad) * w_pad;
  const long long table_bytes = 4ll * n_cls * n_buckets;  // bf16, one scale
  if (!valid_plan(n_cls, threads, table_smem) || n < 1 || n_scales < 1 || n_scales > 2
      || (n_scales == 2) != (grid1 != nullptr && out1 != nullptr) || h_pad < 1
      || w_real < 1 || w_real > w_pad || plane * n_cls >= (1ll << 31) || tile_h < 1
      || tile_w_log2 < 5 || tile_w_log2 > 12 || ctas_x < 1 || n_buckets < 1
      || (table_smem && smem < table_bytes)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.grid0 = grid0;
  p.grid1 = grid1;
  p.labels = labels;
  p.table = table;
  p.out0 = out0;
  p.out1 = out1;
  p.bids = bids;
  p.n_scales = n_scales;
  p.n_cls = n_cls;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.w_real = w_real;
  p.plane = static_cast<int>(plane);
  p.tile_h = tile_h;
  p.tile_w_log2 = tile_w_log2;
  // tiles over the whole padded width: every gradient element is written
  p.tiles_w = (w_pad + (1 << tile_w_log2) - 1) >> tile_w_log2;
  p.tiles_per_img = p.tiles_w * ((h_pad + tile_h - 1) / tile_h);
  const long long n_tiles = static_cast<long long>(n) * p.tiles_per_img;
  if (n_tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  p.n_tiles = static_cast<int>(n_tiles);
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.dither = 0;
  p.bm.seed = 0u;
  p.bm.inv_b = 0.0f;
  const Kernel kern = pick(n_cls, !adaptive, table_smem, bids != nullptr);
  err = prepare(kern, smem, device);
  if (err != cudaSuccess) return err;
  kern<<<dim3(static_cast<unsigned>(ctas_x), static_cast<unsigned>(n_scales)), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
