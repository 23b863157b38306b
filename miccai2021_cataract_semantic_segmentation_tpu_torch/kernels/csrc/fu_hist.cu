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
// What bounds it on the card: per pixel it reads one label (4 bytes) and
// C x 4 logits that neighbouring threads share through L1/L2. At the
// flagship shape (N 8, 2 x 17 rows, 544 x 960, B 1024) the bytes it must
// move (27 MB) take 8 us at 3.35 TB/s and its float32 work (16 operations
// per counted (pixel, row) pair, 2.3 G) takes 34 us at 67 TFLOP/s, so the
// floor is arithmetic. What this design spends its time on instead is one
// shared-memory atomic per (pixel, row): the errors of a row crowd into a
// few bins, and a warp's atomics on one bin serialise.
//
// The simple design: one thread per output pixel in a grid-stride loop;
// each block owns one scale and a chunk of classes and keeps their C x 2B
// int32 bins in dynamic shared memory
// (139 KB at C=17, B=1024, above the 48 KB default, so the limit is raised
// per launch; classes are split over grid.y when they do not fit). The grid
// is sized to one wave of resident blocks, so each block zeroes and
// flushes its bins once; the flush adds only nonzero bins to the global
// histogram with atomicAdd. Counts are integers, so the order of the
// atomics cannot change the result. Fewer atomics on the hot bins and TMA
// loads are later work.
//
// Built with -fmad=false: every multiply and add rounds on its own (no
// contraction into FMA). Matrix products elsewhere may round in another
// order, which moves an error sitting on a bucket edge by one bucket now
// and then; the counts per row do not change. The per-pixel arithmetic
// lives in fu_common.cuh, which B2 (fu_grad.cu) shares, so the backward
// reads the gradient of the very bucket this kernel counted.

#include "fu_common.cuh"

namespace {

constexpr int kThreads = 512;

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
  int chunk, n_chunks;
  fu::BucketMap bm;
};

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
fu_hist_kernel(const Params p) {
  extern __shared__ int hist[];  // (chunk, 2, B)
  const int scale = blockIdx.y / p.n_chunks;
  const int c0 = (blockIdx.y % p.n_chunks) * p.chunk;
  const int c1 = min(c0 + p.chunk, p.n_cls);
  const int nb = p.bm.n_buckets;
  const int bins = (c1 - c0) * 2 * nb;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const long long total = static_cast<long long>(p.n) * p.h_pad * p.w_pad;
  const long long plane = static_cast<long long>(p.hs) * p.ws;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lbl = p.labels[i];
    if (lbl < 0) continue;
    const int x = static_cast<int>(i % p.w_pad);
    const long long t = i / p.w_pad;
    const int y = static_cast<int>(t % p.h_pad);
    const int img = static_cast<int>(t / p.h_pad);
    const fu::Taps taps = fu::pixel_taps(y, x, p.hs, p.ws, p.h_lo, p.h_w0,
                                         p.h_w1, p.w_lo, p.w_w0, p.w_w1);
    const float* base =
        p.logits + (static_cast<long long>(img) * p.n_rows + scale * p.n_cls) * plane;
    float z[MAXC];
    float sum;
    fu::softmax_terms<MAXC>(base, plane, p.ws, p.n_cls, taps, z, sum);
    const float shift = p.bm.dither ? fu::dither_shift(i, p.bm) : 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= c0 && c < c1) {
        const bool fg = lbl == c;
        const int b = fu::pixel_bucket(__fdiv_rn(z[c], sum), fg, shift, p.bm);
        atomicAdd(&hist[(c - c0) * 2 * nb + (fg ? nb : 0) + b], 1);
      }
    }
  }
  __syncthreads();

  int* row0 = p.out + static_cast<long long>(scale * p.n_cls + c0) * 2 * nb;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(row0 + i, v);
  }
}

template <int MAXC>
cudaError_t launch(const Params& p, int n_scales, size_t smem,
                   cudaStream_t stream, int sms) {
  auto kern = fu_hist_kernel<MAXC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int gy = n_scales * p.n_chunks;
  long long gx = (static_cast<long long>(sms) * resident + gy - 1) / gy;
  const long long total = static_cast<long long>(p.n) * p.h_pad * p.w_pad;
  const long long needed = (total + kThreads - 1) / kThreads;
  if (gx > needed) gx = needed;
  if (gx < 1) gx = 1;
  kern<<<dim3(static_cast<unsigned>(gx), gy), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int fu_hist_fwd(const float* logits, const int* labels, const int* h_lo,
                const float* h_w0, const float* h_w1, const int* w_lo,
                const float* w_w0, const float* w_w1, int* out, int n,
                int n_scales, int n_cls, int hs, int ws, int h_pad, int w_pad,
                int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                float a_emin, int dither, int seed, float inv_b, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0, smem_optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t per_class = static_cast<size_t>(2) * n_buckets * sizeof(int);
  const int max_chunk = static_cast<int>(smem_optin / per_class);
  if (max_chunk < 1 || n_cls < 1 || n_cls > 32) return cudaErrorInvalidValue;
  const int n_chunks = (n_cls + max_chunk - 1) / max_chunk;

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
  p.n_chunks = n_chunks;
  p.chunk = (n_cls + n_chunks - 1) / n_chunks;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.inv_b = inv_b;
  p.bm.dither = dither;
  p.bm.seed = static_cast<uint32_t>(seed);
  const size_t smem = static_cast<size_t>(p.chunk) * per_class;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cls <= 8) return launch<8>(p, n_scales, smem, s, sms);
  if (n_cls <= 16) return launch<16>(p, n_scales, smem, s, sms);
  if (n_cls <= 24) return launch<24>(p, n_scales, smem, s, sms);
  return launch<32>(p, n_scales, smem, s, sms);
}

}  // extern "C"
