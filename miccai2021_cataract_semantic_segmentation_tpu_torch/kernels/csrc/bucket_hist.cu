// B3: the generic bucket-Lovász histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_hist_kernel`
// (miccai2021_cataract_semantic_segmentation_tpu/losses/bucket_lovasz.py:78,
// launched by `_bucket_histogram`). For every (row, pixel) of the (R, P)
// float32 errors and bool foreground flags it takes the bucket
// b = min(int(e * 2048), 2047) (bucket_common.cuh) and adds, in the row's
// bg or fg half, one count and the error rounded to bf16 (nearest even), as
// the TPU kernel's `mask * e.astype(bf16)` does. Nothing is masked: pixels
// that `classes_to_ignore` excluded arrive as e = 0, fg = 0 and count as
// background in bucket 0, as on the TPU. A negative id (e <= -1/2048) is
// counted nowhere.
//
// Outputs, zeroed by the caller: int32 counts (R, 2, 2048) and int64 error
// sums (R, 2, 2048) in fixed point, [row][bg, fg][bucket]. The sums are
// integers so that the order of the atomics cannot change them and two runs
// agree bit for bit (float atomics would not). Every bf16 value of 2^-11 or
// more is a multiple of 2^-18, and a pixel in bucket b >= 1 has e >= 2^-11,
// so buckets 1..2047 sum bf16(e) * 2^18 exactly. Bucket 0 holds errors
// below 2^-11 and sums trunc(bf16(e) * 2^48): exact for values of 2^-41 or
// more, each smaller one off by less than 2^-48, and a row stays below
// P * 2^37 units, so P may reach 2^26. Errors of 2^45 or more (none on any
// path: errors lie in [0, 1]) overflow the fixed point. The wrapper turns
// the integers into the (R, 2048, 4) float32 histogram
// [n_fg, n_bg, se_fg, se_bg] (kernels/bucket_hist.py).
//
// What bounds it on the card: it reads each error (4 bytes) and flag
// (1 byte) once and does a few operations per pair, so bytes bound it: at
// the HRNetv2 cell (R 17, P 8 x 544 x 960) 355 MB, 0.106 ms at 3.35 TB/s.
// The first design took 2.6-2.9 ms there, on shared-memory atomics: a
// 64-bit atomicAdd to shared memory compiles to a compare-and-swap loop on
// this card (ATOMS.CAST.SPIN.64 in its SASS), every pair went through one,
// and most pairs of a row fall in a few buckets (background pixels the
// network gets right near 0, foreground pixels it misses near 2047), so a
// warp's loops on one bin retried once per lane.
//
// The design:
//   * Hot bins in registers. Bucket 0 of each half, the one bin whose sums
//     need 64 bits, is counted per lane in one 64-bit register: the count
//     in bits 52..63 and the units below (a pixel adds at most 2^37 units,
//     and the plan gives a lane at most kLanePixels pixels, so neither field
//     overflows). Bucket 2047 of each half takes errors of 2047/2048 or
//     more, and bf16(e) = 1 for every one up to 1 + 2^-8, so a lane only
//     counts those (32 bits; the sum is count * 2^18). The warp reduces the
//     four by shuffles once, and the flush adds them. The rest of the hot
//     pairs, negative errors in bucket 0 and errors above 1 + 2^-8 (none on
//     any path: errors lie in [0, 1]), go through 64-bit shared atomics on
//     four side bins.
//   * Only 32-bit shared atomics. A pixel in bucket b of 1..2046 has
//     b/2048 <= e < 2047/2048 < 1, so e * 2^18 lies in [128 b, 128 (b + 1));
//     bf16(e) lies within half a bf16 ulp of e, at most 2^-9 = 512 units
//     below 1, so bf16(e) * 2^18 - 128 b lies in [-512, 640]. The shared
//     table holds, per bin, an int32 count and an int32 sum of that offset;
//     the flush rebuilds the exact sum as 128 b * count + offset sum. The
//     launch plan caps the pixels of a row a block takes at kBlockPixels, so
//     no offset sum can leave 32 bits. The table is 32 KB.
//   * No FP64: the units are bf16(e) times a power of two in float32, which
//     is exact (|e| < 2^45), converted with truncation toward zero, equal to
//     the plain version's double product (tests/test_torch_bucket_units.py
//     holds a model of them to `sum_units` over every bf16 value).
//   * Each block walks a contiguous chunk of its row in float4 errors and
//     one 4-byte load of four flags; the pixels before the row's first
//     16-byte boundary and after its last whole vector are taken one by one
//     by the first and last blocks. Flags are read a byte at a time where
//     their alignment differs from the errors'.
//   * The flush adds each nonzero bin to the global histogram with integer
//     atomics (a native 64-bit atomicAdd in global memory). The grid is one
//     wave of resident blocks, four an SM at 32 registers
//     (kernels/bucket_hist.py `b3_plan`).
// The run merge of the first design (a lane's run of equal bins added at
// once) saves nothing on any input measured, the errors of a net at random
// weights included, and costs a fifth where a fifth of the pairs or more are
// hot. tools/bucket_hist_ablation.py builds edited copies of this source,
// each with one part taken back to the first design's, and times them.

#include <cuda_bf16.h>

#include "bucket_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2048 / kThreads;  // a full SM: at most 32 registers
constexpr int kWarps = kThreads / 32;

// A pixel's offset lies in [-512, 640]: no 32-bit offset sum of a block's
// kBlockPixels pixels can overflow.
constexpr int kOffsetMax = 640;
constexpr int kBlockPixels = 1 << 21;
static_assert(static_cast<long long>(kBlockPixels) * kOffsetMax < (1ll << 31),
              "an offset sum must fit in 32 bits");
// Bucket 0's register: the count above bit kCountShift, at most kLanePixels
// pixels a lane, each of at most 2^37 units.
constexpr int kCountShift = 52;
constexpr int kLanePixels = (1 << (64 - kCountShift)) - 1;
static_assert((static_cast<unsigned long long>(kLanePixels) << 37) < (1ull << kCountShift),
              "bucket 0's units must stay below the count");
constexpr unsigned long long kUnitsMask = (1ull << kCountShift) - 1;
constexpr int kHot = 4;  // [bg 0, bg 2047, fg 0, fg 2047]
constexpr int kLast = bk::kBuckets - 1;

// bf16(e), rounded to nearest even, as a float
__device__ __forceinline__ float bf16_round(float e) {
  return __bfloat162float(__float2bfloat16_rn(e));
}

// v * scale (a power of two) truncated toward zero: 2^48 in bucket 0, 2^18
// elsewhere
__device__ __forceinline__ long long units(float v, float scale) {
  return static_cast<long long>(__fmul_rn(v, scale));
}

// bf16(e) * 2^18 of buckets 1..2046: an integer below 2^18
__device__ __forceinline__ int mid_units(float v) {
  return static_cast<int>(__fmul_rn(v, 0x1p18f));
}

struct Lane {
  unsigned long long zero[2];  // bucket 0 of [bg, fg]: count << 52 | units
  unsigned one[2];             // bucket 2047 of [bg, fg] at bf16(e) = 1: count
};

struct Table {
  int* cnt;                 // (kBins,): counts of buckets 1..2046
  int* off;                 // (kBins,): their offset sums
  int* side_cnt;            // (kHot,): hot pairs outside the registers
  unsigned long long* side_sum;
};

__device__ __forceinline__ void add_pixel(float e, bool fg, Lane& ln, const Table& t) {
  const int b = bk::bucket_id(e);
  if (b < 0) return;
  const float v = bf16_round(e);
  if (b == 0 || b == kLast) {
    if (b == 0 && e >= 0.0f) {
      const unsigned long long a =
          static_cast<unsigned long long>(units(v, 0x1p48f)) + (1ull << kCountShift);
      if (fg) {
        ln.zero[1] += a;
      } else {
        ln.zero[0] += a;
      }
    } else if (b == kLast && v == 1.0f) {
      if (fg) {
        ln.one[1] += 1u;
      } else {
        ln.one[0] += 1u;
      }
    } else {
      const int j = (fg ? 2 : 0) + (b != 0);
      atomicAdd(t.side_cnt + j, 1);
      atomicAdd(t.side_sum + j,
                static_cast<unsigned long long>(units(v, b == 0 ? 0x1p48f : 0x1p18f)));
    }
    return;
  }
  const int k = (fg ? bk::kBuckets : 0) + b;
  atomicAdd(t.cnt + k, 1);
  atomicAdd(t.off + k, mid_units(v) - 128 * b);
}

// The four flags of vector v, a byte each
template <bool VEC_FLAGS>
__device__ __forceinline__ unsigned flags4(const uint8_t* fb, int v) {
  if constexpr (VEC_FLAGS) {
    return __ldg(reinterpret_cast<const unsigned*>(fb) + v);
  } else {
    const uint8_t* q = fb + 4 * v;
    return __ldg(q) | (__ldg(q + 1) << 8) | (__ldg(q + 2) << 16) | (__ldg(q + 3) << 24);
  }
}

// Block (x, row) takes the vectors [x * chunk, (x + 1) * chunk) of its row,
// counted from the row's first 16-byte aligned error, and the first block
// also the pixels before it (the head), the last one those after the last
// whole vector (the tail). VEC_FLAGS: the flags of a vector are one aligned
// 4-byte word.
template <bool VEC_FLAGS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bucket_hist_kernel(const float* __restrict__ errors, const uint8_t* __restrict__ fg,
                   int p, int chunk, int* __restrict__ counts,
                   unsigned long long* __restrict__ sums) {
  __shared__ int s_cnt[bk::kBins];
  __shared__ int s_off[bk::kBins];
  __shared__ int s_hot_cnt[kWarps + 1][kHot];  // a row per warp, the side bins last
  __shared__ unsigned long long s_hot_sum[kWarps + 1][kHot];
  const Table t{s_cnt, s_off, s_hot_cnt[kWarps], s_hot_sum[kWarps]};
  for (int i = threadIdx.x; i < bk::kBins; i += kThreads) {
    t.cnt[i] = 0;
    t.off[i] = 0;
  }
  if (threadIdx.x < kHot) {
    t.side_cnt[threadIdx.x] = 0;
    t.side_sum[threadIdx.x] = 0ull;
  }
  __syncthreads();

  const long long row = blockIdx.y;
  const float* e_row = errors + row * p;
  const uint8_t* f_row = fg + row * p;
  const int head =
      min(p, static_cast<int>((4u - (reinterpret_cast<uintptr_t>(e_row) >> 2)) & 3u));
  const int n_vec = (p - head) >> 2;
  const int v_lo = blockIdx.x * chunk;
  const int v_hi = min(n_vec, v_lo + chunk);
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  Lane ln = {};
  const float4* ev = reinterpret_cast<const float4*>(e_row + head);
  const uint8_t* fb = f_row + head;
  for (int v = v_lo + threadIdx.x; v < v_hi; v += kThreads) {
    const float4 x = __ldg(ev + v);
    const unsigned fl = flags4<VEC_FLAGS>(fb, v);
    add_pixel(x.x, fl & 0xFFu, ln, t);
    add_pixel(x.y, fl & 0xFF00u, ln, t);
    add_pixel(x.z, fl & 0xFF0000u, ln, t);
    add_pixel(x.w, fl & 0xFF000000u, ln, t);
  }
  // the head: threads 0..2 of the first block; the tail: 4..6 of the last
  const int tail0 = head + 4 * n_vec;
  int edge = -1;
  if (first && static_cast<int>(threadIdx.x) < head) edge = threadIdx.x;
  if (last && threadIdx.x >= 4 && static_cast<int>(threadIdx.x) - 4 < p - tail0) {
    edge = tail0 + threadIdx.x - 4;
  }
  if (edge >= 0) add_pixel(__ldg(e_row + edge), __ldg(f_row + edge) != 0, ln, t);

  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned c0 =
        __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(ln.zero[h] >> kCountShift));
    unsigned long long s0 = ln.zero[h] & kUnitsMask;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, d);
    const unsigned c1 = __reduce_add_sync(0xFFFFFFFFu, ln.one[h]);
    if ((threadIdx.x & 31) == 0) {
      s_hot_cnt[warp][2 * h] = static_cast<int>(c0);
      s_hot_sum[warp][2 * h] = s0;
      s_hot_cnt[warp][2 * h + 1] = static_cast<int>(c1);
      s_hot_sum[warp][2 * h + 1] = static_cast<unsigned long long>(c1) << 18;
    }
  }
  __syncthreads();

  int* c_row = counts + row * bk::kBins;
  unsigned long long* s_row = sums + row * bk::kBins;
  for (int i = threadIdx.x; i < bk::kBins; i += kThreads) {
    const int b = i & kLast;
    int c = 0;
    unsigned long long s = 0ull;
    if (b == 0 || b == kLast) {
      const int j = (i >= bk::kBuckets ? 2 : 0) + (b != 0);
      for (int w = 0; w <= kWarps; ++w) {
        c += s_hot_cnt[w][j];
        s += s_hot_sum[w][j];
      }
    } else {
      c = t.cnt[i];
      s = 128ull * b * static_cast<unsigned>(c)
          + static_cast<unsigned long long>(static_cast<long long>(t.off[i]));
    }
    if (c) {
      atomicAdd(c_row + i, c);
      atomicAdd(s_row + i, s);
    }
  }
}

using Kernel = void (*)(const float*, const uint8_t*, int, int, int*, unsigned long long*);

}  // namespace

extern "C" {

// The blocks of the kernel the device holds at once (*resident) and its
// block size (*threads); returns a cudaError_t. The launch plan
// (kernels/bucket_hist.py `b3_plan`) sizes its grid from them.
int bucket_hist_resident(int device, int* resident, int* threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kern = bucket_hist_kernel<true>;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  *threads = kThreads;
  return *resident >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Returns a cudaError_t: 0 when the launch was accepted. The plan: per_row
// blocks of `chunk` float4 vectors each over every row; a block also takes
// up to 3 head and 3 tail pixels, a lane one of them. A plan that gives a
// block more than kBlockPixels pixels or a lane more than kLanePixels is
// refused.
int bucket_hist_fwd(const float* errors, const unsigned char* fg, int rows, int p,
                    int per_row, int chunk, int* counts, long long* sums, int device,
                    void* stream) {
  if (rows < 1 || rows > 65535 || p < 1 || p >= (1 << 26) || per_row < 1 || chunk < 1
      || static_cast<long long>(per_row) * chunk < p / 4 || 4ll * chunk + 6 > kBlockPixels
      || 4 * ((chunk + kThreads - 1) / kThreads) + 1 > kLanePixels
      || (reinterpret_cast<uintptr_t>(errors) & 3u) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // a vector's four flags are one aligned word when the errors' alignment
  // (in floats) and the flags' (in bytes) agree modulo 4, for every row
  const bool vec_flags =
      (((reinterpret_cast<uintptr_t>(errors) >> 2) - reinterpret_cast<uintptr_t>(fg)) & 3u) == 0;
  const Kernel kern = vec_flags ? bucket_hist_kernel<true> : bucket_hist_kernel<false>;
  kern<<<dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(rows)), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(errors, fg, p, chunk, counts,
                                              reinterpret_cast<unsigned long long*>(sums));
  return cudaGetLastError();
}

}  // extern "C"
