// B4 and B4f: the generic bucket-Lovász backward for Hopper (sm_90a).
//
// B4, the gather, replaces the Pallas TPU kernel `_grad_kernel`
// (miccai2021_cataract_semantic_segmentation_tpu/losses/bucket_lovasz.py:152,
// launched by `_bucket_grad`). For every (row, pixel) of the (R, P) float32
// errors and bool foreground flags it writes
//   grad = table[row][fg][min(int(e * 2048), 2047)]
// with the bucket id of B3 (bucket_common.cuh), or 0 where that id is
// negative. `table` is (R, 2, 2048) float32 [row][bg, fg][bucket]: the
// per-bucket Lovász gradients scaled by the cotangent of each row's loss.
// The kernel reads it as bf16, as the TPU kernel does
// (`tbl_ref.astype(bfloat16)`); the loss's table is rounded to bf16 already
// (`grad_table`), so the copy is exact. It equals its plain version bit for
// bit.
//
// B4f, the fused backward of the generic route, replaces B4 together with
// the XLA VJP of the error construction
// (miccai2021_cataract_semantic_segmentation_tpu/losses/functional.py:152-156:
// softmax, |fg - p|, the transpose). From the errors and flags the forward
// saved, the cotangent-scaled table and the (N, C, H, W) logits it writes
// d loss / d logits in the logits' layout and type. For pixel q = (n, h, w)
// and class c, with row r = c (or n * C + c per image) and column
// n * HW + hw (or hw), in float32:
//   e = errors[r, col]; dE = table[r][fg][bucket_id(e)] (0 for a negative id)
//   dp_c = e > 0 ? (fg ? -dE : dE) : 0        (torch's |x|' is 0 at 0)
//   p = softmax_c(logits[n, :, h, w])         (recomputed from the logits)
//   dz_c = p_c * (dp_c - sum_k p_k dp_k)      (the sum in ascending k)
// rounded to the logits' type. Ignored pixels have e = 0 and fg = 0 in every
// row, so their gradient is 0.
//
// What bounds both on the card: bytes. At the HRNetv2 cell (R 17, P 8 x 544
// x 960 = 4,177,920) the gather reads each error (4 bytes) and flag (1) and
// writes one float32 gradient; B4f reads the error, the flag and the bf16
// logit and writes the bf16 gradient: 4 + 1 + 2 + 2 bytes a pair. Both come
// to 639,500,288 bytes with the table, 0.19 ms at 3.35 TB/s (float32 logits:
// 923,598,848, 0.28 ms). B4f's float32 work (the softmax's 5 operations, the
// sign, the VJP's 4) is a tenth of that.
//
// The first B4 (0.555 ms at the cell on an H100, 2.9x its bound) gave each thread one
// scalar 4-byte error load and one 1-byte flag load at a time, then a
// dependent `__ldg` of the float32 table (up to 32 sectors a warp) and a
// scalar store, over a 64-bit index: about 8 KB in flight an SM, half of
// what 3.35 TB/s needs. Its output, the float32 d loss / d errors, then went
// through eager autograd (|x|, the negation, the strided softmax VJP and the
// cast back to NCHW bf16): about 3.3 GB of traffic a step, and two float32
// (R, P) tensors kept from the forward. This design
// (tools/bucket_grad_ablation.py measures each choice on the H100):
//   * The gather: 16-byte vector loads of the errors and stores of the
//     gradient, 4-byte loads of the flags, kGatherVecs vectors a thread in
//     flight. A row's scalar head runs up to the first pixel where its
//     errors, flags and gradient share their alignment, and its tail after
//     the last whole vector; a row whose three never line up (a view that
//     starts at another offset) takes the scalar path. Each block copies its
//     row's table into shared memory as bf16 (8 KB), so a gather is one
//     16-bit shared load. One wave of blocks: `per_row` blocks a row, each
//     over `chunk` vectors, with 32-bit in-row indices (bucket_grad.py
//     `b4_plan`).
//   * B4f: one thread a pixel, looping over the classes; each block holds
//     the C rows' tables in shared memory as bf16 (139 KB at C 17, 205 KB at
//     C 25) and walks tiles of `tile_px` pixels of one image with 32-bit
//     offsets: persistent blocks, one wave. Per image, the table depends on
//     the image, so the blocks are split among the images and a block loads
//     its image's rows before walking that image's tiles. C 17, the model
//     paths' class count, has its own instance (no per-class guards, 64
//     registers at 1024 threads); C above 25 gathers from the float32 table
//     in global memory. The softmax's probabilities and dp (as bf16 bits,
//     two classes a register) stay in registers between the sum and the
//     write. No atomics: every output element has one owner thread and a
//     fixed order of operations, so two runs are bit-equal.
// Built with -fmad=false like every kernel of the port.

#include <cuda_bf16.h>

#include <mutex>

#include "bucket_common.cuh"

namespace {

constexpr int kGatherMaxThreads = 1024;
constexpr int kGatherVecs = 2;      // float4 vectors a thread has in flight
constexpr int kMaxClasses = 32;
constexpr int kSmemClasses = 25;    // the most classes whose tables a block holds

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_float(uint32_t h) { return __uint_as_float(h << 16); }

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

// ---------------------------------------------------------------------------
// B4: the gather
// ---------------------------------------------------------------------------

// dE of one pixel from its row's bf16 table ([bg | fg] x bucket); `gtbl`,
// the row's float32 table, is what tools/bucket_grad_ablation.py's
// table_global build gathers from instead.
__device__ __forceinline__ float gather_one(const uint16_t* tbl, const float* gtbl, float e,
                                            bool fg) {
  const int b = bk::bucket_id(e);
  return b < 0 ? 0.0f : bf16_float(tbl[(fg ? bk::kBuckets : 0) + b]);
}

// Block x of row y takes vectors [x * chunk, (x + 1) * chunk) of the row's
// aligned body; block 0 also the head, the row's last block the tail. On the
// scalar path it takes pixels [4 x chunk, 4 (x + 1) chunk).
__global__ void __launch_bounds__(kGatherMaxThreads)
bucket_gather_kernel(const float* __restrict__ errors, const uint8_t* __restrict__ fg,
                     const float* __restrict__ table, int p, int chunk,
                     float* __restrict__ out) {
  __shared__ __align__(16) uint16_t tbl[bk::kBins];
  const long long row_at = static_cast<long long>(blockIdx.y) * p;
  const float* e_row = errors + row_at;
  const uint8_t* f_row = fg + row_at;
  float* o_row = out + row_at;
  const float* gtbl = table + static_cast<long long>(blockIdx.y) * bk::kBins;
  fill_table(tbl, gtbl, bk::kBins);
  __syncthreads();
  const uintptr_t a_e = reinterpret_cast<uintptr_t>(e_row);
  const uintptr_t a_o = reinterpret_cast<uintptr_t>(o_row);
  const uintptr_t a_f = reinterpret_cast<uintptr_t>(f_row);
  // errors and gradient 16-byte aligned and flags 4-byte aligned at one pixel
  const bool aligned = ((a_e | a_o) & 3) == 0 && ((a_e >> 2) & 3) == ((a_o >> 2) & 3)
                       && ((a_e >> 2) & 3) == (a_f & 3);
  const int first = blockIdx.x * chunk;
  if (aligned) {
    const int head = min(static_cast<int>((4 - ((a_e >> 2) & 3)) & 3), p);
    const int n_vec = (p - head) >> 2;
    const int v_end = min(first + chunk, n_vec);
    const float4* e4 = reinterpret_cast<const float4*>(e_row + head);
    const uchar4* f4 = reinterpret_cast<const uchar4*>(f_row + head);
    float4* o4 = reinterpret_cast<float4*>(o_row + head);
    const int step = kGatherVecs * blockDim.x;
    for (int v = first + threadIdx.x; v < v_end; v += step) {
      float4 e[kGatherVecs];
      uchar4 f[kGatherVecs];
#pragma unroll
      for (int k = 0; k < kGatherVecs; ++k) {
        const int i = v + k * blockDim.x;
        if (i < v_end) {
          e[k] = __ldg(e4 + i);
          f[k] = __ldg(f4 + i);
        }
      }
#pragma unroll
      for (int k = 0; k < kGatherVecs; ++k) {
        const int i = v + k * blockDim.x;
        if (i < v_end) {
          __stcs(o4 + i, make_float4(gather_one(tbl, gtbl, e[k].x, f[k].x),
                                     gather_one(tbl, gtbl, e[k].y, f[k].y),
                                     gather_one(tbl, gtbl, e[k].z, f[k].z),
                                     gather_one(tbl, gtbl, e[k].w, f[k].w)));
        }
      }
    }
    // the head's up to 3 pixels, and the tail's up to 3, one a thread
    const int tid = threadIdx.x;
    if (blockIdx.x == 0 && tid < head) {
      o_row[tid] = gather_one(tbl, gtbl, __ldg(e_row + tid), __ldg(f_row + tid));
    }
    const int t = head + 4 * n_vec + tid;
    if (blockIdx.x == gridDim.x - 1 && tid < 4 && t < p) {
      o_row[t] = gather_one(tbl, gtbl, __ldg(e_row + t), __ldg(f_row + t));
    }
  } else {
    const int hi = min(4 * (first + chunk), p);
    for (int i = 4 * first + threadIdx.x; i < hi; i += blockDim.x) {
      o_row[i] = gather_one(tbl, gtbl, __ldg(e_row + i), __ldg(f_row + i));
    }
  }
}

// ---------------------------------------------------------------------------
// B4f: the fused backward to d logits
// ---------------------------------------------------------------------------

struct FusedParams {
  const float* errors;   // (R, P) saved errors
  const uint8_t* fg;     // (R, P) saved flags
  const float* table;    // (R, 2, B) [bg, fg], cotangent-scaled, bf16-valued
  const void* logits;    // (N, C, HW), bf16 or float32
  void* out;             // (N, C, HW), the logits' type
  int n, n_cls, hw, p;   // p: a row's columns, HW per image, else N * HW
  int per_image;
  // the launch plan (bucket_grad.py `b4f_plan`)
  int tile_px, tiles_per_img, per_seg;
};

template <typename T>
__device__ __forceinline__ float load_logit(const T* src);

template <>
__device__ __forceinline__ float load_logit<float>(const float* src) {
  return __ldg(src);
}

template <>
__device__ __forceinline__ float load_logit<__nv_bfloat16>(const __nv_bfloat16* src) {
  return bf16_float(__ldg(reinterpret_cast<const unsigned short*>(src)));
}

template <typename T>
__device__ __forceinline__ void store_grad(T* dst, float v);

template <>
__device__ __forceinline__ void store_grad<float>(float* dst, float v) {
  __stcs(dst, v);
}

template <>
__device__ __forceinline__ void store_grad<__nv_bfloat16>(__nv_bfloat16* dst, float v) {
  __stcs(reinterpret_cast<unsigned short*>(dst), static_cast<unsigned short>(bf16_bits(v)));
}

// The bf16 bits of table entry `at` of the block's rows: from the shared
// copy, or from the float32 table in global memory, rounded as the copy is.
template <bool SMEM>
__device__ __forceinline__ uint32_t table_bits(const uint16_t* tbl, const float* gtbl, int at) {
  if constexpr (SMEM) {
    return tbl[at];
  } else {
    return bf16_bits(__ldg(gtbl + at));
  }
}

// One pixel: class c's logit at src[c * hw], error and flag at e[c * p] and
// f[c * p], gradient to dst[c * hw].
template <int MAXC, bool EXACT, bool SMEM, typename T>
__device__ __forceinline__ void pixel_dlogits(const T* src, const float* e_src,
                                              const uint8_t* f_src, T* dst, int hw, int p,
                                              int n_cls, const uint16_t* tbl, const float* gtbl) {
  const int ncls = EXACT ? MAXC : n_cls;
  float z[MAXC];
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) {
      z[c] = load_logit<T>(src + c * hw);
      m = fmaxf(m, z[c]);
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) {
      z[c] = expf(__fsub_rn(z[c], m));
      sum = __fadd_rn(sum, z[c]);
    }
  }
  uint32_t dpk[(MAXC + 1) / 2];  // dp as bf16 bits, class 2k low, 2k + 1 high
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) {
      const float prob = __fdiv_rn(z[c], sum);
      const float e = __ldg(e_src + c * p);
      const bool fg = __ldg(f_src + c * p) != 0;
      const int b = bk::bucket_id(e);
      // dp = (fg ? -dE : dE): dE's bf16 bits with the sign flipped; 0 where
      // e is not positive or the id negative
      const uint32_t h =
          e > 0.0f && b >= 0
              ? table_bits<SMEM>(tbl, gtbl, 2 * c * bk::kBuckets + (fg ? bk::kBuckets + b : b))
                    ^ (fg ? 0x8000u : 0u)
              : 0u;
      dpk[c >> 1] = (c & 1) ? dpk[c >> 1] | h << 16 : h;
      z[c] = prob;
      s = __fadd_rn(s, __fmul_rn(bf16_float(h), prob));
    }
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < ncls) {
      const float dp = __uint_as_float((c & 1) ? dpk[c >> 1] & 0xFFFF0000u : dpk[c >> 1] << 16);
      store_grad<T>(dst + c * hw, __fmul_rn(z[c], __fsub_rn(dp, s)));
    }
  }
}

constexpr int fused_max_threads(int maxc) { return maxc <= 17 ? 1024 : 512; }

// MAXC: the size of the per-pixel class arrays; EXACT: n_cls == MAXC (the
// compiler then drops the per-class guards); SMEM: the tables in shared
// memory, else gathered from global memory; T: the logits' type.
template <int MAXC, bool EXACT, bool SMEM, typename T>
__global__ void __launch_bounds__(fused_max_threads(MAXC), 1)
bucket_dlogits_kernel(const FusedParams p) {
  extern __shared__ __align__(16) uint16_t tbl[];  // (C, 2, B) bf16 of the block's rows
  const int ncls = EXACT ? MAXC : p.n_cls;
  const int rows = ncls * bk::kBins;                // table entries of one image's rows
  // segments: the images (per image), else one of all N images' tiles
  const int n_segs = p.per_image ? p.n : 1;
  const int seg_tiles = p.per_image ? p.tiles_per_img : p.n * p.tiles_per_img;
  const int slots = gridDim.x / p.per_seg;
  const int sub = blockIdx.x % p.per_seg;
  const T* logits = static_cast<const T*>(p.logits);
  T* out = static_cast<T*>(p.out);
  for (int seg = blockIdx.x / p.per_seg; seg < n_segs; seg += slots) {  // uniform
    const float* gtbl = p.table + static_cast<long long>(seg) * rows;
    const long long row_at = static_cast<long long>(seg) * ncls * p.p;  // errors of row seg * C
    if constexpr (SMEM) {
      __syncthreads();  // the previous segment's readers are done
      fill_table(tbl, gtbl, rows);
      __syncthreads();
    }
    for (int t = sub; t < seg_tiles; t += p.per_seg) {  // uniform across the block
      const int img = p.per_image ? seg : t / p.tiles_per_img;
      const int hw0 = (t - (p.per_image ? 0 : img * p.tiles_per_img)) * p.tile_px;
      const int col0 = p.per_image ? hw0 : img * p.hw + hw0;
      const long long img_at = static_cast<long long>(img) * ncls * p.hw;
      const T* src = logits + img_at + hw0;
      T* dst = out + img_at + hw0;
      const float* e_src = p.errors + row_at + col0;
      const uint8_t* f_src = p.fg + row_at + col0;
      const int n_px = min(p.tile_px, p.hw - hw0);
      for (int k = threadIdx.x; k < n_px; k += blockDim.x) {
        pixel_dlogits<MAXC, EXACT, SMEM, T>(src + k, e_src + k, f_src + k, dst + k, p.hw, p.p,
                                            ncls, tbl, gtbl);
      }
    }
  }
}

using FusedKernel = void (*)(const FusedParams);

template <typename T>
FusedKernel pick_typed(int n_cls, bool smem) {
  if (!smem) return bucket_dlogits_kernel<32, false, false, T>;
  if (n_cls == 17) return bucket_dlogits_kernel<17, true, true, T>;
  if (n_cls <= 8) return bucket_dlogits_kernel<8, false, true, T>;
  if (n_cls <= 16) return bucket_dlogits_kernel<16, false, true, T>;
  if (n_cls <= 24) return bucket_dlogits_kernel<24, false, true, T>;
  return bucket_dlogits_kernel<32, false, true, T>;
}

// The kernel of a plan: the tables in shared memory (C 17's own instance,
// else 8, 16, 24 or 32 classes), or, above kSmemClasses, gathered from
// global memory (the C 32 instance); bf16 or float32 logits.
FusedKernel pick(int n_cls, bool smem, bool bf16) {
  return bf16 ? pick_typed<__nv_bfloat16>(n_cls, smem) : pick_typed<float>(n_cls, smem);
}

// The MAXC of the kernel a plan runs (`pick`).
int instance_maxc(int n_cls, bool smem) {
  if (!smem) return kMaxClasses;
  if (n_cls == 17) return 17;
  return n_cls <= 8 ? 8 : n_cls <= 16 ? 16 : n_cls <= 24 ? 24 : 32;
}

// The dynamic shared memory a kernel may use, set once per (kernel, device)
// and raised only when a launch needs more.
cudaError_t prepare(FusedKernel kern, int smem, int device) {
  static std::mutex mu;
  static FusedKernel kerns[64];
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

bool valid_fused(int n_cls, int threads, bool smem) {
  return n_cls >= 1 && n_cls <= kMaxClasses && (!smem || n_cls <= kSmemClasses)
         && threads >= 32 && threads % 32 == 0
         && threads <= fused_max_threads(instance_maxc(n_cls, smem));
}

}  // namespace

extern "C" {

// The number of gather blocks of `threads` threads the device holds at once,
// in *resident; returns a cudaError_t. The launch plan sizes its grid from it.
int bucket_grad_resident(int threads, int device, int* resident) {
  if (threads < 32 || threads > kGatherMaxThreads || threads % 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_gather_kernel, threads, 0);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  return *resident >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// B4. Returns a cudaError_t: 0 when the launch was accepted. The plan's
// arguments (per_row, chunk, threads) come from bucket_grad.py `b4_plan`.
int bucket_grad_bwd(const float* errors, const unsigned char* fg, const float* table, int rows,
                    int p, int per_row, int chunk, int threads, float* out, int device,
                    void* stream) {
  if (rows < 1 || rows > 65535 || p < 1 || per_row < 1 || chunk < 1 || threads < 32
      || threads > kGatherMaxThreads || threads % 32
      || 4ll * per_row * chunk < p || 4ll * per_row * chunk >= (1ll << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bucket_gather_kernel<<<dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(rows)),
                         threads, 0, static_cast<cudaStream_t>(stream)>>>(errors, fg, table, p,
                                                                          chunk, out);
  return cudaGetLastError();
}

// The number of B4f blocks of this plan's kernel the device holds at once,
// in *resident; returns a cudaError_t.
int bucket_dlogits_resident(int n_cls, int threads, int smem, int table_smem, int bf16,
                            int device, int* resident) {
  if (!valid_fused(n_cls, threads, table_smem)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const FusedKernel kern = pick(n_cls, table_smem, bf16);
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

// B4f. Returns a cudaError_t: 0 when the launch was accepted. The plan's
// arguments (tile_px .. smem) come from bucket_grad.py `b4f_plan`.
int bucket_dlogits_bwd(const float* errors, const unsigned char* fg, const float* table,
                       const void* logits, void* out, int n, int n_cls, int hw, int per_image,
                       int bf16, int tile_px, int table_smem, int ctas, int per_seg,
                       int threads, int smem, int device, void* stream) {
  const long long elems = static_cast<long long>(n) * n_cls * hw;
  const long long table_bytes = 4ll * n_cls * bk::kBuckets;  // bf16, one image's rows
  if (!valid_fused(n_cls, threads, table_smem) || n < 1 || hw < 1 || elems >= (1ll << 31)
      || tile_px < 32 || tile_px % 32 || ctas < 1 || per_seg < 1 || ctas % per_seg
      || (!per_image && per_seg != ctas) || (table_smem && smem < table_bytes)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FusedParams prm;
  prm.errors = errors;
  prm.fg = fg;
  prm.table = table;
  prm.logits = logits;
  prm.out = out;
  prm.n = n;
  prm.n_cls = n_cls;
  prm.hw = hw;
  prm.p = per_image ? hw : n * hw;
  prm.per_image = per_image;
  prm.tile_px = tile_px;
  prm.tiles_per_img = (hw + tile_px - 1) / tile_px;
  prm.per_seg = per_seg;
  const FusedKernel kern = pick(n_cls, table_smem, bf16);
  err = prepare(kern, smem, device);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(ctas), threads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return cudaGetLastError();
}

}  // extern "C"
