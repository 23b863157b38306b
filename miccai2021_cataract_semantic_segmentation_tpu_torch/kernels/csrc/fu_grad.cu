// B2: fused bucket-Lovász backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fu_bwd_kernel`
// (miccai2021_cataract_semantic_segmentation_tpu/losses/fused_lovasz.py:742,
// launched by `_fu_grad`). Given the stride-8 logits, the padded labels and
// the loss's per-bucket gradient table, it returns d loss / d logits:
//   1. for every output pixel of the padded label grid and every class row
//      of each scale, the same upsampled logits, softmax, e = |fg - p|,
//      dither shift and bucket id as B1 (fu_common.cuh, bit for bit);
//   2. de = table[row][fg][bucket], the table being float32 (R, 2, B)
//      [bg, fg] rows already scaled by the cotangent and rounded to bf16 by
//      the caller (the TPU kernel's `tbl_ref[...].astype(bfloat16)`);
//   3. dp = (fg ? -de : de) for counted pixels, 0 for label -1, and the
//      softmax VJP dz = p * (dp - sum_c dp * p) over the classes of a scale;
//   4. the transposed bilinear interpolation: width taps first, then height
//      taps (the TPU kernel's mwT then mhT order), into float32
//      (N, R, hs, ws).
//
// What bounds it on the card: it reads the labels (4 bytes a pixel), the
// logits and the table and writes the gradient: 36 MB at the flagship shape
// (N 8, 2 x 17 rows, 544 x 1024 padded grid, B 1024), 0.011 ms at
// 3.35 TB/s. Its float32 work is about 25.5 operations per counted
// (pixel, row) pair (B1's 16, 1 for the sign, 4 for the VJP, 4 for the
// width taps, 4 * ws / W_pad for the height taps), 0.054 ms at 67 TFLOP/s:
// the floor is arithmetic.
//
// The simple, deterministic design. Float atomics into the gradient would
// make its low bits depend on the order the atomics land in, so every sum
// has one owner thread and a fixed order:
//   pass A, one block per (output row y, image): the threads compute dz for
//   the whole row of one scale into shared memory (C x W_pad float32, 70 KB
//   at C 17, W_pad 1024), then each thread owns one (class, source column
//   s) and sums the width taps of the output columns that read s, in
//   ascending x, into a float32 (N, R, H_pad, ws) buffer; then the next
//   scale;
//   pass B, one thread per (image, row, source row h, s): the sum of the
//   height taps over the output rows that read h, in ascending y.
// Built with -fmad=false like B1. Fewer passes over the buffer, and warps
// that share the gather of a source column, are later work.

#include "fu_common.cuh"

namespace {

constexpr int kThreadsA = 256;
constexpr int kThreadsB = 256;

struct Params {
  const float* logits;  // (N, R, hs, ws)
  const int* labels;    // (N, h_pad, w_pad), -1 = no count
  const int* h_lo;      // (h_pad,) first source row of each output row
  const float* h_w0;    // (h_pad,) weight of row h_lo
  const float* h_w1;    // (h_pad,) weight of row h_lo + 1
  const int* h_beg;     // (hs,) first output row that reads source row h
  const int* h_end;     // (hs,) one past the last
  const int* w_lo;      // (w_pad,) the same for columns
  const float* w_w0;
  const float* w_w1;
  const int* w_beg;     // (ws,)
  const int* w_end;     // (ws,)
  const float* table;   // (R, 2, B) [bg, fg]
  float* rows;          // (N, R, h_pad, ws) width-transposed rows
  float* out;           // (N, R, hs, ws)
  int* bids;            // (N, R, h_pad, w_pad) bucket ids, or null
  int n, n_scales, n_cls, n_rows, hs, ws, h_pad, w_pad;
  fu::BucketMap bm;
};

// The weight with which an output row or column whose taps are (lo, w0, w1)
// reads source index `s`.
__device__ __forceinline__ float tap_weight(int lo, float w0, float w1, int s) {
  return lo == s ? w0 : (lo + 1 == s ? w1 : 0.0f);
}

template <int MAXC>
__global__ void __launch_bounds__(kThreadsA)
fu_grad_rows(const Params p) {
  extern __shared__ float dz[];  // (n_cls, w_pad) of one scale
  const int y = blockIdx.x;
  const int img = blockIdx.y;
  const long long plane = static_cast<long long>(p.hs) * p.ws;
  const long long pix0 = (static_cast<long long>(img) * p.h_pad + y) * p.w_pad;
  const int* lrow = p.labels + pix0;
  const int nb = p.bm.n_buckets;

  for (int scale = 0; scale < p.n_scales; ++scale) {
    const int row0 = scale * p.n_cls;
    const float* base =
        p.logits + (static_cast<long long>(img) * p.n_rows + row0) * plane;
    for (int x = threadIdx.x; x < p.w_pad; x += blockDim.x) {
      const int lbl = lrow[x];
      if (lbl < 0) {
        for (int c = 0; c < p.n_cls; ++c) {
          dz[c * p.w_pad + x] = 0.0f;
          if (p.bids) {
            p.bids[((static_cast<long long>(img) * p.n_rows + row0 + c) * p.h_pad + y)
                   * p.w_pad + x] = -1;
          }
        }
        continue;
      }
      const fu::Taps taps = fu::pixel_taps(y, x, p.hs, p.ws, p.h_lo, p.h_w0,
                                           p.h_w1, p.w_lo, p.w_w0, p.w_w1);
      float z[MAXC];
      float sum;
      fu::softmax_terms<MAXC>(base, plane, p.ws, p.n_cls, taps, z, sum);
      const float shift = p.bm.dither ? fu::dither_shift(pix0 + x, p.bm) : 0.0f;
      float dp[MAXC];
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < p.n_cls) {
          const float prob = __fdiv_rn(z[c], sum);
          const bool fg = lbl == c;
          const int b = fu::pixel_bucket(prob, fg, shift, p.bm);
          if (p.bids) {
            p.bids[((static_cast<long long>(img) * p.n_rows + row0 + c) * p.h_pad + y)
                   * p.w_pad + x] = b;
          }
          const float de =
              __ldg(p.table + (static_cast<long long>(row0 + c) * 2 + (fg ? 1 : 0)) * nb + b);
          dp[c] = fg ? -de : de;
          z[c] = prob;
          s = __fadd_rn(s, __fmul_rn(dp[c], prob));
        }
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < p.n_cls) dz[c * p.w_pad + x] = __fmul_rn(z[c], __fsub_rn(dp[c], s));
      }
    }
    __syncthreads();

    // width-transposed taps: one owner thread per (class, source column)
    const int items = p.n_cls * p.ws;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int c = it / p.ws;
      const int sc = it - c * p.ws;
      const float* dzc = dz + c * p.w_pad;
      float acc = 0.0f;
      for (int x = p.w_beg[sc]; x < p.w_end[sc]; ++x) {
        const float wgt = tap_weight(p.w_lo[x], p.w_w0[x], p.w_w1[x], sc);
        acc = __fadd_rn(acc, __fmul_rn(wgt, dzc[x]));
      }
      p.rows[((static_cast<long long>(img) * p.n_rows + row0 + c) * p.h_pad + y) * p.ws
             + sc] = acc;
    }
    __syncthreads();
  }
}

// height-transposed taps: one owner thread per output element
__global__ void __launch_bounds__(kThreadsB)
fu_grad_cols(const Params p) {
  const long long total = static_cast<long long>(p.n) * p.n_rows * p.hs * p.ws;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int sc = static_cast<int>(i % p.ws);
  const long long t = i / p.ws;
  const int h = static_cast<int>(t % p.hs);
  const long long plane_row = t / p.hs;  // image * n_rows + row
  const float* col = p.rows + plane_row * p.h_pad * p.ws + sc;
  float acc = 0.0f;
  for (int y = p.h_beg[h]; y < p.h_end[h]; ++y) {
    const float wgt = tap_weight(p.h_lo[y], p.h_w0[y], p.h_w1[y], h);
    acc = __fadd_rn(acc, __fmul_rn(wgt, col[static_cast<long long>(y) * p.ws]));
  }
  p.out[i] = acc;
}

template <int MAXC>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto rows = fu_grad_rows<MAXC>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rows<<<dim3(p.h_pad, p.n), kThreadsA, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(p.n) * p.n_rows * p.hs * p.ws;
  const long long blocks = (total + kThreadsB - 1) / kThreadsB;
  fu_grad_cols<<<static_cast<unsigned>(blocks), kThreadsB, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when both launches were accepted.
int fu_grad_bwd(const float* logits, const int* labels, const int* h_lo,
                const float* h_w0, const float* h_w1, const int* h_beg,
                const int* h_end, const int* w_lo, const float* w_w0,
                const float* w_w1, const int* w_beg, const int* w_end,
                const float* table, float* rows, float* out, int* bids, int n,
                int n_scales, int n_cls, int hs, int ws, int h_pad, int w_pad,
                int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                float a_emin, int dither, int seed, float inv_b, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(n_cls) * w_pad * sizeof(float);
  if (n_cls < 1 || n_cls > 32 || smem > static_cast<size_t>(smem_optin) ||
      h_pad > 65535 || n > 65535) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.logits = logits;
  p.labels = labels;
  p.h_lo = h_lo;
  p.h_w0 = h_w0;
  p.h_w1 = h_w1;
  p.h_beg = h_beg;
  p.h_end = h_end;
  p.w_lo = w_lo;
  p.w_w0 = w_w0;
  p.w_w1 = w_w1;
  p.w_beg = w_beg;
  p.w_end = w_end;
  p.table = table;
  p.rows = rows;
  p.out = out;
  p.bids = bids;
  p.n = n;
  p.n_scales = n_scales;
  p.n_cls = n_cls;
  p.n_rows = n_scales * n_cls;
  p.hs = hs;
  p.ws = ws;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.dither = dither;
  p.bm.seed = static_cast<uint32_t>(seed);
  p.bm.inv_b = inv_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cls <= 8) return launch<8>(p, smem, s);
  if (n_cls <= 16) return launch<16>(p, smem, s);
  if (n_cls <= 24) return launch<24>(p, smem, s);
  return launch<32>(p, smem, s);
}

}  // extern "C"
