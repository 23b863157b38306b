// Per-pixel arithmetic shared by B1 (fu_hist.cu) and B2 (fu_grad.cu), and
// by B5/B7 (nchw_hist.cu) and B6/B8 (nchw_grad.cu).
//
// A backward kernel must put every counted pixel in the bucket its forward
// kernel counted it in: the loss's gradient table comes from the forward's
// counts, so a pixel in another bucket reads another bucket's gradient.
// The kernels therefore take the interpolation, the softmax terms, the
// dither shift and the bucket id from this one header, and are built with
// -fmad=false, so each multiply and add rounds on its own and the same
// inputs give the same bits in forward and backward.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "error.cuh"

namespace fu {

// The bucket-id map of losses/bucket_edges.py and the dither of its
// `dither_shift`: uniform, or the adaptive float32-bit-pattern map.
struct BucketMap {
  int n_buckets;
  int adaptive, a_half, a_shift, a_q0;
  float a_emin;
  int dither;
  uint32_t seed;
  float inv_b;  // float32(1 / n_buckets)
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int bucket_id(float e, const BucketMap& m) {
  if (!m.adaptive) {
    // float -> int truncates toward zero, as the reference's astype(int32)
    const int b = static_cast<int>(__fmul_rn(e, static_cast<float>(m.n_buckets)));
    return min(b, m.n_buckets - 1);
  }
  const float u = fminf(e, __fsub_rn(1.0f, e));
  const float uc = fmaxf(u, m.a_emin);
  int q = static_cast<int>(static_cast<uint32_t>(__float_as_int(uc)) >> m.a_shift)
          - m.a_q0;
  q = min(q, m.a_half - 1);
  return e < 0.5f ? q : (m.n_buckets - 1) - q;
}

// (d - 1/2)/B with d = (fmix32(idx ^ seed) & 0xFFFF) / 65536; `idx` is the
// row-major index over the padded (N, H_pad, W_pad) label grid.
__device__ __forceinline__ float dither_shift(long long idx, const BucketMap& m) {
  const uint32_t h = fmix32(static_cast<uint32_t>(idx) ^ m.seed);
  const float d = __fmul_rn(static_cast<float>(h & 0xFFFFu), 1.0f / 65536.0f);
  return __fmul_rn(__fsub_rn(d, 0.5f), m.inv_b);
}

// e = |fg - p|, shifted by the dither when it is on, and its bucket.
__device__ __forceinline__ int pixel_bucket(float prob, bool fg, float shift,
                                            const BucketMap& m) {
  float e = fabsf(__fsub_rn(fg ? 1.0f : 0.0f, prob));
  if (m.dither) e = __fadd_rn(e, shift);
  return bucket_id(e, m);
}

// The bilinear taps of one output pixel: source rows r0/r1 with weights
// a0/a1, source columns s0/s1 with weights b0/b1 (the two nonzero entries
// of the float32 `_fu_mats` row and column; pad rows and columns are 0).
struct Taps {
  int r0, r1, s0, s1;
  float a0, a1, b0, b1;
};

__device__ __forceinline__ Taps pixel_taps(int y, int x, int hs, int ws,
                                           const int* h_lo, const float* h_w0,
                                           const float* h_w1, const int* w_lo,
                                           const float* w_w0, const float* w_w1) {
  Taps t;
  t.r0 = h_lo[y];
  t.r1 = min(t.r0 + 1, hs - 1);
  t.s0 = w_lo[x];
  t.s1 = min(t.s0 + 1, ws - 1);
  t.a0 = h_w0[y];
  t.a1 = h_w1[y];
  t.b0 = w_w0[x];
  t.b1 = w_w1[x];
  return t;
}

// Replace the logits z[0 .. n_cls) by exp(z_c - max z) and leave their sum
// in `sum`: p_c = __fdiv_rn(z[c], sum). The softmax of every kernel here
// (B1/B2 after their interpolation, B5-B8 on full-resolution grids).
template <int MAXC>
__device__ __forceinline__ void exp_terms(int n_cls, float (&z)[MAXC], float& sum) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < n_cls) m = fmaxf(m, z[c]);
  }
  sum = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < n_cls) {
      z[c] = expf(__fsub_rn(z[c], m));
      sum = __fadd_rn(sum, z[c]);
    }
  }
}

// The upsampled logit of one output pixel from its four source logits
// x_rs (source row r0/r1, column s0/s1): height weights first, then width
// weights (the TPU kernel's matmul order). Every kernel that interpolates
// calls this one function, whatever memory the four values come from.
__device__ __forceinline__ float tap_combine(const Taps& t, float x00, float x10,
                                             float x01, float x11) {
  const float u0 = __fadd_rn(__fmul_rn(t.a0, x00), __fmul_rn(t.a1, x10));
  const float u1 = __fadd_rn(__fmul_rn(t.a0, x01), __fmul_rn(t.a1, x11));
  return __fadd_rn(__fmul_rn(t.b0, u0), __fmul_rn(t.b1, u1));
}

// Upsample the n_cls logit planes at `base` (each hs x ws, `plane` apart)
// to one output pixel (`tap_combine`), then `exp_terms`.
template <int MAXC>
__device__ __forceinline__ void softmax_terms(const float* base, long long plane,
                                              int ws, int n_cls, const Taps& t,
                                              float (&z)[MAXC], float& sum) {
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < n_cls) {
      const float* lc = base + c * plane;
      z[c] = tap_combine(t, __ldg(lc + t.r0 * ws + t.s0), __ldg(lc + t.r1 * ws + t.s0),
                         __ldg(lc + t.r0 * ws + t.s1), __ldg(lc + t.r1 * ws + t.s1));
    }
  }
  exp_terms<MAXC>(n_cls, z, sum);
}

// `exp_terms` of one pixel of a full-resolution grid: the n_cls logits at
// `base`, `plane` apart.
template <int MAXC>
__device__ __forceinline__ void grid_softmax_terms(const float* base, long long plane,
                                                   int n_cls, float (&z)[MAXC],
                                                   float& sum) {
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < n_cls) z[c] = __ldg(base + c * plane);
  }
  exp_terms<MAXC>(n_cls, z, sum);
}

}  // namespace fu
