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
// background in bucket 0, as on the TPU.
//
// Outputs, zeroed by the caller: int32 counts (R, 2, 2048) and int64 error
// sums (R, 2, 2048) in fixed point, [row][bg, fg][bucket]. The sums are
// integers so that the order of the atomics cannot change them and two runs
// agree bit for bit (float atomics would not). Every bf16 value of 2^-11 or
// more is a multiple of 2^-18, and a pixel in bucket b >= 1 has e >= 2^-11,
// so buckets 1..2047 sum bf16(e) * 2^18 exactly (a row of P pixels stays
// below P * 2^18 units). Bucket 0 holds errors below 2^-11 and sums
// trunc(bf16(e) * 2^48): exact for values of 2^-41 or more, each smaller one
// off by less than 2^-48, and a row stays below P * 2^37 units, so P may
// reach 2^26. The wrapper turns the integers into the (R, 2048, 4) float32
// histogram [n_fg, n_bg, se_fg, se_bg] (kernels/bucket_hist.py).
//
// What bounds it on the card: it reads each error (4 bytes) and flag
// (1 byte) once and does a few operations per pair, so bytes bound it: at
// the HRNetv2 cell (R 17, P 8 x 544 x 960) 355 MB, 0.106 ms at 3.35 TB/s.
// What the design spends its time on instead is shared-memory atomics: most
// pixels of a row fall in a few buckets (background pixels the network gets
// right near 0, foreground pixels it misses near 2047), and a warp's atomics
// on one bin serialise.
//
// The simple design: a 2D grid, blockIdx.y the row and blockIdx.x a
// contiguous chunk of it, sized to one wave of resident blocks. Each block
// keeps the row's 4096 bins (count int32 and sum uint64, 48 KB) in shared
// memory; each thread walks its chunk with a block-wide stride and keeps a
// run of equal bins in registers, adding it to shared memory only where the
// bin changes, which takes most atomics off the hot bins. Each block then
// adds its nonzero bins to the global histogram with integer atomics.
// Warp-aggregated atomics and fusing the error construction (softmax,
// |fg - p|) into this pass, so that the (R, P) errors are never written,
// are later work.

#include <cuda_bf16.h>

#include "bucket_common.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ long long sum_units(float e, int b) {
  // bf16(e) in units of 2^-18 (buckets >= 1, exact) or 2^-48 (bucket 0,
  // truncated toward zero); the double product is exact in both cases
  const float v = __bfloat162float(__float2bfloat16_rn(e));
  return static_cast<long long>(static_cast<double>(v) *
                                (b == 0 ? 0x1p48 : 0x1p18));
}

__global__ void __launch_bounds__(kThreads)
bucket_hist_kernel(const float* __restrict__ errors,
                   const uint8_t* __restrict__ fg, long long p,
                   long long chunk, int* __restrict__ counts,
                   unsigned long long* __restrict__ sums) {
  __shared__ int s_cnt[bk::kBins];
  __shared__ unsigned long long s_sum[bk::kBins];
  for (int i = threadIdx.x; i < bk::kBins; i += blockDim.x) {
    s_cnt[i] = 0;
    s_sum[i] = 0ull;
  }
  __syncthreads();

  const long long row = blockIdx.y;
  const float* e_row = errors + row * p;
  const uint8_t* f_row = fg + row * p;
  const long long beg = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = min(p, beg + chunk);
  int key = -1, n = 0;
  unsigned long long s = 0ull;
  for (long long i = beg + threadIdx.x; i < end; i += blockDim.x) {
    const float e = __ldg(e_row + i);
    const int b = bk::bucket_id(e);
    if (b < 0) continue;
    const int k = (__ldg(f_row + i) ? bk::kBuckets : 0) + b;
    if (k != key) {
      if (n) {
        atomicAdd(&s_cnt[key], n);
        atomicAdd(&s_sum[key], s);
      }
      key = k;
      n = 0;
      s = 0ull;
    }
    ++n;
    s += static_cast<unsigned long long>(sum_units(e, b));
  }
  if (n) {
    atomicAdd(&s_cnt[key], n);
    atomicAdd(&s_sum[key], s);
  }
  __syncthreads();

  int* c_row = counts + row * bk::kBins;
  unsigned long long* s_row = sums + row * bk::kBins;
  for (int i = threadIdx.x; i < bk::kBins; i += blockDim.x) {
    const int c = s_cnt[i];
    if (c) {
      atomicAdd(c_row + i, c);
      atomicAdd(s_row + i, s_sum[i]);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int bucket_hist_fwd(const float* errors, const unsigned char* fg, int rows,
                    long long p, int* counts, long long* sums, int device,
                    void* stream) {
  if (rows < 1 || rows > 65535 || p < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0, resident = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, bucket_hist_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  // one wave of resident blocks over all rows, at least a block's worth of
  // pixels per chunk
  long long per_row = (static_cast<long long>(sms) * resident + rows - 1) / rows;
  const long long most = (p + kThreads - 1) / kThreads;
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  const long long chunk = (p + per_row - 1) / per_row;
  per_row = (p + chunk - 1) / chunk;
  bucket_hist_kernel<<<dim3(static_cast<unsigned>(per_row), rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      errors, fg, p, chunk, counts, reinterpret_cast<unsigned long long*>(sums));
  return cudaGetLastError();
}

}  // extern "C"
