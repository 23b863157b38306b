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
// w_real and the table: about 0.18 ms a scale at 3.35 TB/s; its float32
// work (7 operations for the softmax and e, 1 for the sign, 4 for the VJP
// per pair) is under a tenth of that. The bytes bound it.
//
// The simple design: one thread per (pixel, scale), grid.y the scale; each
// thread keeps the C probabilities and dp in registers. There are no
// atomics: every output has one owner thread and a fixed order of
// operations, so two runs are bit-equal. Built with -fmad=false like B5/B7.

#include "fu_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* grid0;  // (N, C, h_pad, w_pad) logits of scale 0
  const float* grid1;  // scale 1, or null
  const int* labels;   // (N, h_pad, w_pad), -1 = no count
  const float* table;  // (n_scales * C, 2, B) [bg, fg]
  float* out0;         // (N, C, h_pad, w_pad) gradient of scale 0
  float* out1;         // scale 1, or null
  int* bids;           // (N, n_scales * C, h_pad, w_pad) bucket ids, or null
  int n, n_scales, n_cls, h_pad, w_pad, w_real;
  fu::BucketMap bm;
};

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
nchw_grad_kernel(const Params p) {
  const int scale = blockIdx.y;
  const long long plane = static_cast<long long>(p.h_pad) * p.w_pad;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(p.n) * plane) return;
  const long long img = i / plane;
  const long long at = img * p.n_cls * plane + (i - img * plane);
  const float* base = (scale ? p.grid1 : p.grid0) + at;
  float* dst = (scale ? p.out1 : p.out0) + at;
  const int row0 = scale * p.n_cls;
  int* bid_dst = p.bids
      ? p.bids + (img * p.n_scales + scale) * p.n_cls * plane + (i - img * plane)
      : nullptr;
  const int lbl = p.labels[i];
  if (lbl < 0 || static_cast<int>(i % p.w_pad) >= p.w_real) {
    for (int c = 0; c < p.n_cls; ++c) {
      dst[c * plane] = 0.0f;
      if (bid_dst) bid_dst[c * plane] = -1;
    }
    return;
  }
  float z[MAXC];
  float sum;
  fu::grid_softmax_terms<MAXC>(base, plane, p.n_cls, z, sum);
  const int nb = p.bm.n_buckets;
  float dp[MAXC];
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < p.n_cls) {
      const float prob = __fdiv_rn(z[c], sum);
      const bool fg = lbl == c;
      const int b = fu::pixel_bucket(prob, fg, 0.0f, p.bm);
      if (bid_dst) bid_dst[c * plane] = b;
      const float de =
          __ldg(p.table + (static_cast<long long>(row0 + c) * 2 + (fg ? 1 : 0)) * nb + b);
      dp[c] = fg ? -de : de;
      z[c] = prob;
      s = __fadd_rn(s, __fmul_rn(dp[c], prob));
    }
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < p.n_cls) dst[c * plane] = __fmul_rn(z[c], __fsub_rn(dp[c], s));
  }
}

template <int MAXC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.n) * p.h_pad * p.w_pad;
  const long long blocks = (total + kThreads - 1) / kThreads;
  nchw_grad_kernel<MAXC><<<dim3(static_cast<unsigned>(blocks), p.n_scales),
                           kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int nchw_grad_bwd(const float* grid0, const float* grid1, const int* labels,
                  const float* table, float* out0, float* out1, int* bids, int n,
                  int n_scales, int n_cls, int h_pad, int w_pad, int w_real,
                  int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                  float a_emin, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (static_cast<long long>(n) * h_pad * w_pad + kThreads - 1) / kThreads;
  if (n_cls < 1 || n_cls > 32 || n_scales < 1 || n_scales > 2 ||
      (n_scales == 2) != (grid1 != nullptr && out1 != nullptr) ||
      blocks > 0x7FFFFFFFLL) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.grid0 = grid0;
  p.grid1 = grid1;
  p.labels = labels;
  p.table = table;
  p.out0 = out0;
  p.out1 = out1;
  p.bids = bids;
  p.n = n;
  p.n_scales = n_scales;
  p.n_cls = n_cls;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.w_real = w_real;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.dither = 0;
  p.bm.seed = 0u;
  p.bm.inv_b = 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cls <= 8) return launch<8>(p, s);
  if (n_cls <= 16) return launch<16>(p, s);
  if (n_cls <= 24) return launch<24>(p, s);
  return launch<32>(p, s);
}

}  // extern "C"
