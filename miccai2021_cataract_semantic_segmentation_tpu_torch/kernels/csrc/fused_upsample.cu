// P1/P2: the prototype fused separable upsample of stacked logit rows and
// its transpose, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/proto_fused_upsample.py:
//   P1 `_fwd_kernel` (:47, launched by `fused_upsample`, :68):
//        out[n, r] = mhT @ ls2d[n][:, r*ws_pad:(r+1)*ws_pad] @ mw
//      ls2d (N, h_pad, R*ws_pad), mhT (H, h_pad), mw (ws_pad, W_pad)
//      -> out (N, R, H, W_pad) float32;
//   P2 `_bwd_kernel` (:92, launched by `fused_downsample`, :114):
//        out[n, r] = mhT^T @ d[n, r] @ mwT
//      d (N, R, H, W_pad), mhT (H, h_pad), mwT (W_pad, ws_pad)
//      -> out (N, R, h_pad, ws_pad) float32.
// Both take the interpolation matrices as inputs, as the TPU kernels do, so
// they are dense contractions over whatever matrices they get (either
// align_corners convention, any zero padding).
//
// The design: each function is two launches of one strided, batched
// float32 matrix product C[b] = A[b] @ B[b] (`fused_upsample_gemm`), whose
// operands are views of the inputs given by element strides. Both contract
// the short side first, which is the cheaper order here: 2 N R h W (ws + H)
// operations against the 2 N R H ws (h + W) of the TPU kernel's order (25.0
// against 38.7 GFLOP at the prototype's shape). P1 first contracts the
// columns of every (source row, class row) pair at once (V[n] = ls2d[n],
// read as (h_pad * R, ws_pad), @ mw, into a scratch (N, h_pad, R, W_pad)
// the wrapper allocates), then the rows (out[n, r] = mhT @ V[n][:, r]); P2
// first the rows (DH[n, r] = mhT^T @ d[n, r], scratch (N, R, h_pad,
// W_pad)), then the columns of every (class row, source row) pair at once
// (out[n], read as (R * h_pad, ws_pad), = DH[n] @ mwT). A block computes
// a 64 x 64 tile of C from 16-deep slices of A and B staged in shared
// memory; each of its 256 threads keeps a 4 x 4 block of C in registers and
// sums over k in ascending order. Every output element is summed by one
// thread in a fixed order, with no atomics, so both functions are
// deterministic (two runs are bit-equal), where the TPU's P2 accumulates
// its row blocks in sequence into one revisited output block.
//
// What bounds them on the card: operations. At the prototype's shape (N 8,
// R 36, h 68 -> H 544, ws 120 -> W 960) the contraction without its pads
// is 25.0 GFLOP, 0.37 ms at 67 TFLOP/s (float32 outside the tensor cores);
// the bytes (the 642 MB full-resolution side read or written once) take
// 0.19 ms at 3.35 TB/s. The kernels multiply the pads' zeros too, and P2's
// row pass, whose C has h_pad = 72 rows, fills two 64-row tiles. The
// products call `__fmaf_rn`, so the library's `-fmad=false` (kept for the
// bucket kernels' exact ids) does not split them into a multiply and an
// add. Tensor cores (TF32 or 3xTF32 `wgmma`), TMA and fusing the two
// products are later work.

#include <cstdint>

#include "error.cuh"

namespace {

constexpr int kBM = 64;       // rows of C per block
constexpr int kBN = 64;       // columns of C per block
constexpr int kBK = 16;       // depth of a shared-memory slice
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps the staged rows 16-byte aligned

struct Operand {
  const float* p;
  long long s_row, s_col;     // element strides of (row, column)
  long long s_b1, s_b2;       // of the two batch indices
};

struct Gemm {
  Operand a, b;               // A (M, K), B (K, N)
  float* c;
  long long c_row, c_b1, c_b2;  // C's columns are contiguous
  int m, n, k, nb2;           // batch index = b1 * nb2 + b2
};

__global__ void __launch_bounds__(kThreads) fused_upsample_gemm(Gemm g) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];  // A^T slice: [k][m]
  __shared__ __align__(16) float bs[kBK][kBN + kPad];  // B slice:   [k][n]
  const int b1 = blockIdx.z / g.nb2, b2 = blockIdx.z % g.nb2;
  const float* a = g.a.p + b1 * g.a.s_b1 + b2 * g.a.s_b2;
  const float* b = g.b.p + b1 * g.b.s_b1 + b2 * g.b.s_b2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  // neighbouring threads load neighbouring addresses of whichever operand
  // index is contiguous
  const bool a_k_fast = g.a.s_col == 1, b_n_fast = g.b.s_col == 1;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.k; k0 += kBK) {
    for (int e = t; e < kBM * kBK; e += kThreads) {
      const int mi = a_k_fast ? e / kBK : e % kBM;
      const int ki = a_k_fast ? e % kBK : e / kBM;
      const int m = m0 + mi, k = k0 + ki;
      as[ki][mi] = (m < g.m && k < g.k) ? __ldg(a + m * g.a.s_row + k * g.a.s_col) : 0.0f;
    }
    for (int e = t; e < kBN * kBK; e += kThreads) {
      const int ni = b_n_fast ? e % kBN : e / kBK;
      const int ki = b_n_fast ? e / kBN : e % kBK;
      const int n = n0 + ni, k = k0 + ki;
      bs[ki][ni] = (n < g.n && k < g.k) ? __ldg(b + k * g.b.s_row + n * g.b.s_col) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* c = g.c + b1 * g.c_b1 + b2 * g.c_b2;
  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.m) continue;
    float* out = c + m * g.c_row + n;
    if (n + 3 < g.n && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < g.n) out[j] = acc[i][j];
  }
}

cudaError_t gemm(const Gemm& g, int nb1, cudaStream_t stream) {
  const long long batches = static_cast<long long>(nb1) * g.nb2;
  if (g.m < 1 || g.n < 1 || g.k < 1 || batches < 1 || batches > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM,
                  static_cast<unsigned>(batches));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  fused_upsample_gemm<<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P1. ls2d (n, h_pad, rows*ws_pad), mht (H, h_pad), mw (ws_pad, w_pad),
// scratch v (n, h_pad, rows, w_pad), out (n, rows, H, w_pad); all float32,
// contiguous. Returns a cudaError_t: 0 when both launches were accepted.
int fused_upsample_fwd(const float* ls2d, const float* mht, const float* mw,
                       float* v, float* out, int n, int rows, int h_out,
                       int h_pad, int ws_pad, int w_pad, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(h_pad) * rows;
  if (pairs >= (1LL << 31)) return cudaErrorInvalidValue;   // C's height is an int
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // V[n] (h_pad*rows, w_pad) = ls2d[n] (h_pad*rows, ws_pad) @ mw (ws_pad, w_pad)
  Gemm cols_pass{{ls2d, ws_pad, 1, pairs * ws_pad, 0},
                 {mw, w_pad, 1, 0, 0},
                 v, w_pad, pairs * w_pad, 0,
                 static_cast<int>(pairs), w_pad, ws_pad, 1};
  err = gemm(cols_pass, n, s);
  if (err != cudaSuccess) return err;
  // out[n, r] (H, w_pad) = mhT (H, h_pad) @ V[n][:, r] (h_pad, w_pad)
  const long long plane = static_cast<long long>(h_out) * w_pad;
  Gemm rows_pass{{mht, h_pad, 1, 0, 0},
                 {v, static_cast<long long>(rows) * w_pad, 1, pairs * w_pad, w_pad},
                 out, w_pad, rows * plane, plane,
                 h_out, w_pad, h_pad, rows};
  return gemm(rows_pass, n, s);
}

// P2. d (n, rows, H, w_pad), mht (H, h_pad), mwt (w_pad, ws_pad), scratch
// dh (n, rows, h_pad, w_pad), out (n, rows, h_pad, ws_pad); all float32,
// contiguous. Returns a cudaError_t: 0 when both launches were accepted.
int fused_downsample_bwd(const float* d, const float* mht, const float* mwt,
                         float* dh, float* out, int n, int rows, int h_out,
                         int h_pad, int ws_pad, int w_pad, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(rows) * h_pad;
  if (pairs >= (1LL << 31)) return cudaErrorInvalidValue;   // C's height is an int
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(h_out) * w_pad;
  const long long dplane = static_cast<long long>(h_pad) * w_pad;
  // DH[n, r] (h_pad, w_pad) = mhT^T (h_pad, H) @ d[n, r] (H, w_pad)
  Gemm rows_pass{{mht, 1, h_pad, 0, 0},
                 {d, w_pad, 1, rows * plane, plane},
                 dh, w_pad, rows * dplane, dplane,
                 h_pad, w_pad, h_out, rows};
  err = gemm(rows_pass, n, s);
  if (err != cudaSuccess) return err;
  // out[n] (rows*h_pad, ws_pad) = DH[n] (rows*h_pad, w_pad) @ mwT (w_pad, ws_pad)
  Gemm cols_pass{{dh, w_pad, 1, pairs * w_pad, 0},
                 {mwt, ws_pad, 1, 0, 0},
                 out, ws_pad, pairs * ws_pad, 0,
                 static_cast<int>(pairs), ws_pad, w_pad, 1};
  return gemm(cols_pass, n, s);
}

}  // extern "C"
