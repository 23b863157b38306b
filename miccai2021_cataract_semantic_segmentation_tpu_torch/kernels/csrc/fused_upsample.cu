// P1/P2: the prototype fused separable upsample of stacked logit rows and
// its transpose, for Hopper (sm_90a), on the tensor cores in 3xTF32.
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
// The design: each function is two launches of one strided, batched matrix
// product C[b] = A[b] @ B[b] (`fused_upsample_gemm`), whose operands are
// views of the inputs given by element strides. Both contract the short
// side first: 2 N R h W (ws + H) operations against the 2 N R H ws (h + W)
// of the TPU kernel's order (25.0 against 38.7 GFLOP at the prototype's
// shape). P1 first contracts the columns of every (source row, class row)
// pair at once (V[n] = ls2d[n], read as (h_pad * R, ws_pad), @ mw, into a
// scratch (N, h_pad, R, W_pad) the wrapper allocates), then the rows
// (out[n, r] = mhT @ V[n][:, r]); P2 first the rows, then the columns of
// every (class row, source row) pair at once (out[n], read as (R * h_pad,
// W_pad) @ mwT). P2's row pass has h_pad = 72 output rows, which no 16-row
// mma tile fits, so it computes the transposed product DH[n, r]^T (W_pad,
// h_pad) = d[n, r]^T @ mhT: h_pad lies on the tile's N side, 72 = 9 mma
// columns of 8, and the epilogue stores C through its strides into the
// scratch DH (N, R, h_pad, W_pad).
//
// What bounds them on the card: bytes. At the prototype's shape (N 8, R 36,
// h 68 -> H 544, ws 120 -> W 960) the contraction without its pads is 25.0
// GFLOP; as three TF32 products at 495 TFLOP/s that takes 0.151 ms, and
// the 642 MB full-resolution side, read (P2) or written (P1) once, takes
// 0.195 ms at 3.35 TB/s. With pads and partial tiles the tiles issue 28.6
// (P2) and 30.0 (P1) GFLOP (`fused_upsample_issued_flops`). On the card
// neither limit is reached: the copies alone (a build without the
// products, tools/fused_upsample_ablation.py) run P2's row pass at about
// three quarters of the memory's rate, and the products add to that time
// more than they overlap it (PERF.md).
//
// The arithmetic: float32 by three TF32 products ("3xTF32"). Each operand
// value x is split into big = tf32(x), rounded to nearest with ties away
// from zero on the 13 low mantissa bits (the bits `cvt.rna.tf32.f32`
// gives, by an integer add and mask, which issue faster), and small =
// tf32(x - big); the subtraction is exact. Every 8-deep step adds
// small*big, then big*small, then big*big into float32 accumulators with
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`; small*small (2^-22
// relative) is dropped. One TF32 product alone lies about 3e-4 (relative
// L2) from float64 at the prototype's shape, past phase 17's 1e-6 gate;
// 3xTF32 about 1e-7 (tests/test_torch_fused_upsample.py emulates both; the
// tensor cores' own sums land a little further, within the gate). The
// library's `-fmad=false`, kept for the bucket kernels' exact ids, does not
// touch mma instructions.
//
// The tiles: a block of 4 warps (128 threads) computes a BM x BN tile of C
// from BK = 16-deep slices staged in shared memory through a ring of
// kStages = 4 stages of `cp.async` copies, so the next slices load while
// this one multiplies. Two shapes: P2's row pass (A = d^T, contiguous along
// M) takes 128 x 72 tiles, each warp 32 x 72 (2 x 9 mma tiles); the other
// three passes (A contiguous along K) take 64 x 128 tiles, each warp 32 x 64
// (2 x 8). Shared memory per stage: A as [k][m] (row stride BM + 8) or
// [m][k] (BK + 4), B as [k][n] (row stride BN rounded up to 8 mod 32), so
// every fragment read of a warp hits 32 distinct banks; 53,248 and 55,296
// bytes for the four stages, above the 48 KB default, hence
// `cudaFuncSetAttribute`. The copies put neighbouring threads on
// neighbouring addresses of the operand's contiguous axis: 16 bytes each
// where the operand's base and strides are 16-byte aligned (the tail of a
// row zero-filled through cp.async's source size), else 4 bytes each
// (ragged rows such as W_pad = 101). Rows and columns past the matrix are
// zero-filled, and an 8-deep step wholly past K is skipped. Every output
// element is summed by one thread in a fixed order, with no atomics and no
// split of K across blocks, so both functions are deterministic (two runs
// are bit-equal).
//
// Not done: `wgmma` (TF32 `wgmma` reads shared-memory operands only
// K-major, and d is contracted over its outer axis, so it would need a
// transpose in shared memory); TMA copies issued by a producer warp, which
// would take the copies and their address work off the warps that
// multiply; fusing the two passes of P2 so that d's partial products stay
// on chip (the scratch costs 85 MB each way, about 0.05 ms).

#include <cstdint>

#include "error.cuh"

namespace {

constexpr int kBK = 16;       // depth of a shared-memory slice
constexpr int kStages = 4;    // slices in flight
constexpr int kThreads = 128;

struct Operand {
  const float* p;
  long long s_row, s_col;     // element strides of (row, column)
  long long s_b1, s_b2;       // of the two batch indices
};

struct Gemm {
  Operand a, b;               // A (M, K), B (K, N)
  float* c;
  long long c_row, c_col, c_b1, c_b2;
  int m, n, k, nb2;           // batch index = b1 * nb2 + b2
  bool a_vec, b_vec;          // 16-byte copies (base and strides aligned)
  bool c_vec2;                // 8-byte stores of column pairs
};

// a row stride of shared memory that is a multiple of 4 floats (16-byte
// copies) and `rem` modulo 32 banks
constexpr int ld_of(int cols, int rem) { return cols + ((rem - cols % 32) + 32) % 32; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage a ROWS x COLS tile of a matrix whose column axis is contiguous:
// element (i, j) is p[(r0 + i) * s_row + c0 + j], zero where r0 + i >= nrows
// or c0 + j >= ncols; into dst[i * ld + j]. Neighbouring threads take
// neighbouring 4-float chunks of a row.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, int ld, const float* p, long long s_row,
                                      int r0, int nrows, int c0, int ncols, bool vec) {
  static_assert(COLS % 4 == 0, "a staged row is whole 4-float chunks");
  constexpr int kChunks = COLS / 4;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
    const int i = e / kChunks, j = (e % kChunks) * 4;
    const int r = r0 + i, c = c0 + j;
    float* d = dst + i * ld + j;
    const float* row = p + static_cast<long long>(r) * s_row;
    if (vec) {
      const int valid = r < nrows ? max(0, min(4, ncols - c)) : 0;
      cp_async16(d, valid ? row + c : p, 4 * valid);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = r < nrows && c + q < ncols;
        cp_async4(d + q, ok ? row + c + q : p, ok ? 4 : 0);
      }
    }
  }
}

// x rounded to TF32, to nearest with ties away from zero: the bits of
// `cvt.rna.tf32.f32` for every finite x, by an integer add and mask
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));   // the subtraction is exact
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tile shape of one instance: BM x BN per block, WM x WN per warp; A
// staged [m][k] when it is contiguous along K (A_KMAJOR), else [k][m]. A
// row stride of 20 mod 32 words puts the 8 rows x 4 columns of a [m][k]
// fragment read on 32 banks; 8 mod 32 does it for the 4 rows x 8 columns of
// a [k][m] or [k][n] one.
template <int BM, int BN, int WM, int WN, bool A_KMAJOR>
struct Tile {
  static constexpr int kBM = BM, kBN = BN, kWM = WM, kWN = WN;
  static constexpr bool kAKMajor = A_KMAJOR;
  static constexpr int kMt = WM / 16, kNt = WN / 8;      // mma tiles per warp
  static constexpr int kWarpsN = BN / WN;
  static_assert((BM / WM) * kWarpsN * 32 == kThreads, "4 warps a block");
  static constexpr int kLdA = A_KMAJOR ? ld_of(kBK, 20) : ld_of(BM, 8);
  static constexpr int kLdB = ld_of(BN, 8);
  static constexpr int kStageA = A_KMAJOR ? BM * kLdA : kBK * kLdA;
  static constexpr int kStageFloats = kStageA + kBK * kLdB;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
};

// The two instances: P2's row pass (A contiguous along M, h_pad on N), and
// the other passes (A contiguous along K).
using TileMN = Tile<128, 72, 32, 72, false>;
using TileKN = Tile<64, 128, 32, 64, true>;

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_upsample_gemm(Gemm g) {
  constexpr int kMt = T::kMt, kNt = T::kNt;
  extern __shared__ __align__(16) float smem[];
  const int b1 = blockIdx.z / g.nb2, b2 = blockIdx.z % g.nb2;
  const float* a = g.a.p + b1 * g.a.s_b1 + b2 * g.a.s_b2;
  const float* b = g.b.p + b1 * g.b.s_b1 + b2 * g.b.s_b2;
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * T::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;       // the mma fragments' indices
  const int wm = (warp / T::kWarpsN) * T::kWM, wn = (warp % T::kWarpsN) * T::kWN;
  const int k_tiles = (g.k + kBK - 1) / kBK;

  auto load = [&](int kt) {
    float* as = smem + (kt % kStages) * T::kStageFloats;
    float* bs = as + T::kStageA;
    const int k0 = kt * kBK;
    if constexpr (T::kAKMajor)
      stage<T::kBM, kBK>(as, T::kLdA, a, g.a.s_row, m0, g.m, k0, g.k, g.a_vec);
    else
      stage<kBK, T::kBM>(as, T::kLdA, a, g.a.s_col, k0, g.k, m0, g.m, g.a_vec);
    stage<kBK, T::kBN>(bs, T::kLdB, b, g.b.s_row, k0, g.k, n0, g.n, g.b_vec);
  };

  float acc[kMt][kNt][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kt landed for every thread; slice kt - 1 is free
    if (kt + kStages - 1 < k_tiles) load(kt + kStages - 1);
    cp_async_commit();
    const float* as = smem + (kt % kStages) * T::kStageFloats;
    const float* bs = as + T::kStageA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      if (kt * kBK + kk >= g.k) break;   // an 8-deep step wholly past K
      uint32_t a_big[kMt][4], a_small[kMt][4];
#pragma unroll
      for (int i = 0; i < kMt; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const int row = wm + i * 16 + gid + (q & 1) * 8;
          const int col = kk + tig + (q >> 1) * 4;
          const float v = T::kAKMajor ? as[row * T::kLdA + col] : as[col * T::kLdA + row];
          split(v, a_big[i][q], a_small[i][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        // b0 (t, g), b1 (t + 4, g)
        const int col = wn + j * 8 + gid;
        uint32_t b_big[2], b_small[2];
        split(bs[(kk + tig) * T::kLdB + col], b_big[0], b_small[0]);
        split(bs[(kk + tig + 4) * T::kLdB + col], b_big[1], b_small[1]);
#pragma unroll
        for (int i = 0; i < kMt; ++i) {
          mma(acc[i][j], a_small[i], b_big);
          mma(acc[i][j], a_big[i], b_small);
          mma(acc[i][j], a_big[i], b_big);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* c = g.c + b1 * g.c_b1 + b2 * g.c_b2;
#pragma unroll
  for (int i = 0; i < kMt; ++i) {
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int n = n0 + wn + j * 8 + 2 * tig;   // c0/c2 at n, c1/c3 at n + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + gid + h * 8;
        if (m >= g.m) continue;
        float* out = c + m * g.c_row + n * g.c_col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (g.c_vec2 && n + 1 < g.n) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          if (n < g.n) out[0] = v0;
          if (n + 1 < g.n) out[g.c_col] = v1;
        }
      }
    }
  }
}

bool aligned16(const Operand& o, long long s_other) {
  return reinterpret_cast<uintptr_t>(o.p) % 16 == 0 && s_other % 4 == 0 &&
         o.s_b1 % 4 == 0 && o.s_b2 % 4 == 0;
}

template <typename T>
dim3 grid_of(const Gemm& g, long long nb1) {
  return dim3((g.n + T::kBN - 1) / T::kBN, (g.m + T::kBM - 1) / T::kBM,
              static_cast<unsigned>(nb1 * g.nb2));
}

// The multiply-adds the tiles issue, twice (pads, partial tiles and the
// 8-deep steps up to K included).
template <typename T>
double issued(const Gemm& g, long long nb1) {
  const dim3 grid = grid_of<T>(g, nb1);
  return 2.0 * grid.z * (static_cast<double>(grid.y) * T::kBM) *
         (static_cast<double>(grid.x) * T::kBN) * ((g.k + 7) / 8 * 8);
}

template <typename T>
cudaError_t launch(const Gemm& g, long long nb1, cudaStream_t stream) {
  const dim3 grid = grid_of<T>(g, nb1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_upsample_gemm<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  fused_upsample_gemm<T><<<grid, kThreads, T::kSmemBytes, stream>>>(g);
  return cudaGetLastError();
}

// Fill the derived fields of `g`, check what the kernel takes, and launch
// the instance its A's contiguous axis asks for.
cudaError_t gemm(Gemm g, long long nb1, cudaStream_t stream) {
  const bool a_kmajor = g.a.s_col == 1;
  if (g.m < 1 || g.n < 1 || g.k < 1 || nb1 < 1 || nb1 * g.nb2 > 65535)
    return cudaErrorInvalidValue;
  if ((!a_kmajor && g.a.s_row != 1) || g.b.s_col != 1)   // a contiguous axis each
    return cudaErrorInvalidValue;
  g.a_vec = aligned16(g.a, a_kmajor ? g.a.s_row : g.a.s_col);
  g.b_vec = aligned16(g.b, g.b.s_row);
  g.c_vec2 = g.c_col == 1 && reinterpret_cast<uintptr_t>(g.c) % 8 == 0 &&
             g.c_row % 2 == 0 && g.c_b1 % 2 == 0 && g.c_b2 % 2 == 0;
  return a_kmajor ? launch<TileKN>(g, nb1, stream) : launch<TileMN>(g, nb1, stream);
}

double issued_flops(const Gemm& g, long long nb1) {
  return g.a.s_col == 1 ? issued<TileKN>(g, nb1) : issued<TileMN>(g, nb1);
}

// P1's two passes: V[n] = ls2d[n] @ mw, then out[n, r] = mhT @ V[n][:, r].
void plan_fwd(Gemm (&p)[2], long long (&nb1)[2], const float* ls2d, const float* mht,
              const float* mw, float* v, float* out, int n, int rows, int h_out,
              int h_pad, int ws_pad, int w_pad) {
  const long long pairs = static_cast<long long>(h_pad) * rows;
  const long long plane = static_cast<long long>(h_out) * w_pad;
  // V[n] (h_pad*rows, w_pad) = ls2d[n] (h_pad*rows, ws_pad) @ mw (ws_pad, w_pad)
  p[0] = Gemm{{ls2d, ws_pad, 1, pairs * ws_pad, 0}, {mw, w_pad, 1, 0, 0},
              v, w_pad, 1, pairs * w_pad, 0,
              static_cast<int>(pairs), w_pad, ws_pad, 1};
  nb1[0] = n;
  // out[n, r] (H, w_pad) = mhT (H, h_pad) @ V[n][:, r] (h_pad, w_pad)
  p[1] = Gemm{{mht, h_pad, 1, 0, 0},
              {v, static_cast<long long>(rows) * w_pad, 1, pairs * w_pad, w_pad},
              out, w_pad, 1, rows * plane, plane,
              h_out, w_pad, h_pad, rows};
  nb1[1] = n;
}

// P2's two passes: DH[n, r]^T = d[n, r]^T @ mhT, then out[n] = DH[n] @ mwT.
void plan_bwd(Gemm (&p)[2], long long (&nb1)[2], const float* d, const float* mht,
              const float* mwt, float* dh, float* out, int n, int rows, int h_out,
              int h_pad, int ws_pad, int w_pad) {
  const long long pairs = static_cast<long long>(rows) * h_pad;
  const long long plane = static_cast<long long>(h_out) * w_pad;
  const long long dplane = static_cast<long long>(h_pad) * w_pad;
  // DH[n, r]^T (w_pad, h_pad) = d[n, r]^T (w_pad, H) @ mhT (H, h_pad),
  // stored as DH[n, r] (h_pad, w_pad): C's row stride 1, column stride w_pad
  p[0] = Gemm{{d, 1, w_pad, rows * plane, plane}, {mht, h_pad, 1, 0, 0},
              dh, 1, w_pad, rows * dplane, dplane,
              w_pad, h_pad, h_out, rows};
  nb1[0] = n;
  // out[n] (rows*h_pad, ws_pad) = DH[n] (rows*h_pad, w_pad) @ mwT (w_pad, ws_pad)
  p[1] = Gemm{{dh, w_pad, 1, pairs * w_pad, 0}, {mwt, ws_pad, 1, 0, 0},
              out, ws_pad, 1, pairs * ws_pad, 0,
              static_cast<int>(pairs), ws_pad, w_pad, 1};
  nb1[1] = n;
}

bool fits(int rows, int h_pad) {   // C's height h_pad * rows is an int
  return static_cast<long long>(h_pad) * rows < (1LL << 31);
}

int run(const Gemm (&p)[2], const long long (&nb1)[2], int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = gemm(p[0], nb1[0], s);
  if (err != cudaSuccess) return err;
  return gemm(p[1], nb1[1], s);
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
  if (!fits(rows, h_pad)) return cudaErrorInvalidValue;
  Gemm p[2];
  long long nb1[2];
  plan_fwd(p, nb1, ls2d, mht, mw, v, out, n, rows, h_out, h_pad, ws_pad, w_pad);
  return run(p, nb1, device, stream);
}

// P2. d (n, rows, H, w_pad), mht (H, h_pad), mwt (w_pad, ws_pad), scratch
// dh (n, rows, h_pad, w_pad), out (n, rows, h_pad, ws_pad); all float32,
// contiguous. Returns a cudaError_t: 0 when both launches were accepted.
int fused_downsample_bwd(const float* d, const float* mht, const float* mwt,
                         float* dh, float* out, int n, int rows, int h_out,
                         int h_pad, int ws_pad, int w_pad, int device,
                         void* stream) {
  if (!fits(rows, h_pad)) return cudaErrorInvalidValue;
  Gemm p[2];
  long long nb1[2];
  plan_bwd(p, nb1, d, mht, mwt, dh, out, n, rows, h_out, h_pad, ws_pad, w_pad);
  return run(p, nb1, device, stream);
}

// The floating-point operations (two per multiply-add) that P1's (bwd 0)
// or P2's (bwd 1) tiles issue at these sizes, as float32 work: each is
// three TF32 products on the tensor cores.
double fused_upsample_issued_flops(int bwd, int n, int rows, int h_out, int h_pad,
                                   int ws_pad, int w_pad) {
  Gemm p[2];
  long long nb1[2];
  if (bwd)
    plan_bwd(p, nb1, nullptr, nullptr, nullptr, nullptr, nullptr, n, rows, h_out,
             h_pad, ws_pad, w_pad);
  else
    plan_fwd(p, nb1, nullptr, nullptr, nullptr, nullptr, nullptr, n, rows, h_out,
             h_pad, ws_pad, w_pad);
  return issued_flops(p[0], nb1[0]) + issued_flops(p[1], nb1[1]);
}

}  // extern "C"
