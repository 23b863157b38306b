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
// (7 operations per pair) is a tenth of that. The bytes bound it.
//
// The simple design, B1's without the interpolation: one thread per pixel
// in a grid-stride loop; each block owns one scale and a chunk of classes
// and keeps their chunk x 2B int32 bins in dynamic shared memory (139 KB at
// C 17, B 1024; at B 2048 the 17 classes take two chunks, split over
// grid.y). The grid is one wave of resident blocks, so each block zeroes
// and flushes its bins once, adding nonzero bins to the global histogram
// with atomicAdd: counts are integers, so the order of the atomics cannot
// change the result. Loads along x are coalesced; the class planes lie
// H_pad * W_pad apart. Built with -fmad=false, with the softmax and bucket
// id of fu_common.cuh, which B6/B8 (nchw_grad.cu) share, so the backward
// reads the gradient of the very bucket this kernel counted.

#include "fu_common.cuh"

namespace {

constexpr int kThreads = 512;

struct Params {
  const float* grid0;  // (N, C, h_pad, w_pad) logits of scale 0
  const float* grid1;  // the same for scale 1, or null for one scale
  const int* labels;   // (N, h_pad, w_pad), -1 = no count
  int* out;            // (n_scales * C, 2, B)
  int n, n_cls, h_pad, w_pad, w_real;
  int chunk, n_chunks;
  fu::BucketMap bm;
};

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
nchw_hist_kernel(const Params p) {
  extern __shared__ int hist[];  // (chunk, 2, B)
  const int scale = blockIdx.y / p.n_chunks;
  const int c0 = (blockIdx.y % p.n_chunks) * p.chunk;
  const int c1 = min(c0 + p.chunk, p.n_cls);
  const int nb = p.bm.n_buckets;
  const int bins = (c1 - c0) * 2 * nb;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const float* grid = scale ? p.grid1 : p.grid0;
  const long long plane = static_cast<long long>(p.h_pad) * p.w_pad;
  const long long total = static_cast<long long>(p.n) * plane;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lbl = p.labels[i];
    if (lbl < 0 || static_cast<int>(i % p.w_pad) >= p.w_real) continue;
    const long long img = i / plane;
    const float* base = grid + img * p.n_cls * plane + (i - img * plane);
    float z[MAXC];
    float sum;
    fu::grid_softmax_terms<MAXC>(base, plane, p.n_cls, z, sum);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= c0 && c < c1) {
        const bool fg = lbl == c;
        const int b = fu::pixel_bucket(__fdiv_rn(z[c], sum), fg, 0.0f, p.bm);
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
  auto kern = nchw_hist_kernel<MAXC>;
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
int nchw_hist_fwd(const float* grid0, const float* grid1, const int* labels,
                  int* out, int n, int n_scales, int n_cls, int h_pad, int w_pad,
                  int w_real, int n_buckets, int adaptive, int a_half,
                  int a_shift, int a_q0, float a_emin, int device, void* stream) {
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
  if (max_chunk < 1 || n_cls < 1 || n_cls > 32 || n_scales < 1 || n_scales > 2 ||
      (n_scales == 2) != (grid1 != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int n_chunks = (n_cls + max_chunk - 1) / max_chunk;

  Params p;
  p.grid0 = grid0;
  p.grid1 = grid1;
  p.labels = labels;
  p.out = out;
  p.n = n;
  p.n_cls = n_cls;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.w_real = w_real;
  p.n_chunks = n_chunks;
  p.chunk = (n_cls + n_chunks - 1) / n_chunks;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.dither = 0;
  p.bm.seed = 0u;
  p.bm.inv_b = 0.0f;
  const size_t smem = static_cast<size_t>(p.chunk) * per_class;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cls <= 8) return launch<8>(p, n_scales, smem, s, sms);
  if (n_cls <= 16) return launch<16>(p, n_scales, smem, s, sms);
  if (n_cls <= 24) return launch<24>(p, n_scales, smem, s, sms);
  return launch<32>(p, n_scales, smem, s, sms);
}

}  // extern "C"
