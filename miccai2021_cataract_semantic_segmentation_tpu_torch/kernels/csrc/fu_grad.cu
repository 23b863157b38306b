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
// the floor is arithmetic. What it spends instead, as B1 does, is issued
// instructions: B1's 60 or so per pair for the softmax and the bucket id,
// and here a table gather, the VJP and two multiply-adds of the width taps
// on top.
//
// The parent's design took 1.7-2.0 ms on an H100 at that shape: a pass over
// every output row wrote a 71 MB (N, R, H_pad, ws) buffer of
// width-transposed rows, a second pass read it back; 3 blocks of 256
// threads an SM, the logits' taps and the float32 table gathered from
// global memory and L2, three global loads per width tap and 8-way bank
// conflicts in the width pass.
//
// The design. One launch of one wave of persistent blocks (the launch
// plan, kernels/lovasz_grad.py `b2_plan`, sizes the grid from the
// occupancy query: one block of 1024 threads an SM at the model shapes).
// Block x of scale y owns a contiguous share of that scale's N * hs source
// rows (split where an image ends) and, for each column chunk of `chunk_s`
// source columns (one chunk at the model shapes), walks the output rows
// whose height taps reach the share, in ascending order:
//   * pixel phase: each thread computes dz of the scale's C classes at one
//     output pixel of the row into shared memory, dz[class][column], a
//     class's row an odd number of words long, so that the owners below,
//     the classes of one source column side by side in a warp, read
//     distinct banks. The logits of the two source rows the output row
//     reads are staged by cp.async, (row, column, class) with the classes padded to
//     4, so a pixel reads four classes of a tap in one 16-byte load, as B1
//     does. The table of the scale's rows sits in shared memory as bf16
//     (exact: the caller rounded it) where the plan finds room beside the
//     tiles (B 1024 at C 17), else it is read from global memory. Each
//     thread loads its pixel's label of the next row while the owners of
//     this row work.
//   * owner phase: one thread per (class, source column), the classes of a
//     column in neighbouring lanes, sums the width taps of its output
//     columns in ascending x (coefficients from a table the block fills per
//     chunk, one broadcast load a tap), then adds the height taps into two
//     running sums, for the source row `cur` the output rows have reached
//     and the next one. When the rows pass a source row, its owner writes
//     it: each gradient element is written once, by one thread, after a
//     fixed sequence of float32 adds (ascending x, then ascending y, the
//     parent's order). No float atomics, no row buffer.
// The output rows on both sides of a share's first source row h0 feed it.
// The block above leaves its partial sum of that row (its rows, ascending
// y) in a small edge buffer, the block below its own terms of the row, one
// per output row, and the block that arrives second at the boundary's
// integer counter, when its piece ends (`merge_boundary`), continues the
// partial sum with the terms in ascending y: the parent's order exactly,
// whichever block comes second, so the gradient is bit-equal to the
// parent's at every plan. The transposed interpolation has
// two nonzero taps per output row and column, so a tensor-core product
// would multiply mostly zeros; the taps stay scalar float32.
//
// Built with -fmad=false like B1. The instances up to 17 classes are held to
// 64 registers (1024 threads an SM), the wider ones to 128 (512); the C 17
// instance of the model paths' map (uniform, no dither) is compiled for it,
// and the instances that write the bucket ids (the checking path) apart.

#include <climits>

#include "fu_common.cuh"

namespace {

constexpr int kMaxClasses = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int max_threads(int maxc) { return maxc <= 17 ? 1024 : 512; }

struct Params {
  const float* logits;  // (N, R, hs, ws)
  const int* labels;    // (N, h_pad, w_pad), -1 = no count
  const int* h_lo;      // (h_pad,) first source row of each output row
  const float* h_w0;    // (h_pad,) weight of row h_lo
  const float* h_w1;    // (h_pad,) weight of row h_lo + 1
  const int* h_beg;     // (hs,) first output row that reads source row h
  const int* h_end;     // (hs,) one past the last (0, 0: none)
  const int* w_lo;      // (w_pad,) the same for columns
  const float* w_w0;
  const float* w_w1;
  const int* w_beg;     // (ws,)
  const int* w_end;     // (ws,)
  const float* table;   // (R, 2, B) [bg, fg], bf16 values
  float* out;           // (N, R, hs, ws)
  int* bids;            // (N, R, h_pad, w_pad) bucket ids, or null
  float* edge;          // (n_scales, blocks, 1 + max_run, C, ws) rows
  int* arrive;          // (n_scales, blocks) counters, zeros at the launch
  int n, n_cls, n_rows, hs, ws, h_pad, w_pad;
  // the launch plan (lovasz_grad.py `b2_plan`)
  int blocks, chunk_s, n_chunks, chunk_px, max_taps, win_w;
  int table_smem;
  int max_run;          // the most output rows whose first height tap is one row
  // shared-memory layout, in 32-bit words (`Layout`)
  int off_dz, dz_stride, off_acc, off_wt, off_xs, off_win;
  fu::BucketMap bm;
};

// The dynamic shared memory of a plan, in 32-bit words: the bf16 table of
// a scale's rows (if staged), dz of one output row of a chunk, two running
// sums per (class, source column), the width-tap coefficients and each
// source column's first output column and tap count, then the window of
// two source rows at a 16-byte boundary.
struct Layout {
  int off_dz, dz_stride, off_acc, off_wt, off_xs, off_win, words;
};

// The (class, source column of the chunk) that owner item i sums: the
// classes of a column in neighbouring items.
__device__ __forceinline__ void owner_of(int i, int ncls, int& c, int& sl) {
  sl = i / ncls;
  c = i - sl * ncls;
}

inline Layout layout(int n_cls, int n_buckets, int table_smem, int chunk_s, int chunk_px,
                     int max_taps, int win_w) {
  Layout l;
  l.off_dz = table_smem ? n_cls * n_buckets : 0;  // (C, 2, B) bf16
  l.dz_stride = ((chunk_px + 31) & ~31) + 1;  // odd: classes in distinct banks
  l.off_acc = l.off_dz + n_cls * l.dz_stride;
  l.off_wt = l.off_acc + 2 * n_cls * chunk_s;
  l.off_xs = l.off_wt + max_taps * chunk_s;
  l.off_win = (l.off_xs + 2 * chunk_s + 3) & ~3;
  l.words = l.off_win + 2 * win_w * ((n_cls + 3) & ~3);
  return l;
}

// The weight with which an output row or column whose taps are (lo, w0, w1)
// reads source index `s`.
__device__ __forceinline__ float tap_weight(int lo, float w0, float w1, int s) {
  return lo == s ? w0 : (lo + 1 == s ? w1 : 0.0f);
}

// The first and one-past-last output index with a nonzero tap into the
// source indices [a, b) (beg/end per source index; 0, 0 where none).
__device__ __forceinline__ void reach(const int* beg, const int* end, int a, int b,
                                      int& lo, int& hi) {
  int f = a;
  while (f < b && __ldg(end + f) == 0) ++f;
  int l = b - 1;
  while (l >= f && __ldg(end + l) == 0) --l;
  lo = f < b ? __ldg(beg + f) : 0;
  hi = f < b ? __ldg(end + l) : 0;
}

// Start copying source rows lo and min(lo + 1, hs - 1), columns [c_a, c_b),
// of the scale's ncls logit planes into `win`, (row, column, class) with
// the classes padded to cp, four bytes a copy (cp.async, no registers).
__device__ __forceinline__ void stage_rows(const Params& p, const float* base, int lo,
                                           int c_a, int c_b, int ncls, int cp, float* win) {
  const int cols = c_b - c_a;
  const int per_class = 2 * cols;
  const int plane = p.hs * p.ws;
  const int r1 = min(lo + 1, p.hs - 1);
  for (int i = threadIdx.x; i < per_class * ncls; i += blockDim.x) {
    const int c = i / per_class;
    const int rs = i - c * per_class;
    const int r = rs >= cols ? 1 : 0;
    const int col = rs - r * cols;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(win + (r * p.win_w + col) * cp + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(base + c * plane + (r ? r1 : lo) * p.ws + c_a + col));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A row of the edge buffer at boundary `bnd` (between blocks bnd - 1 and
// bnd of a scale): slot 0 the block above's partial sum of the boundary
// row, slot 1 + j the block below's j-th term of it.
__device__ __forceinline__ float* edge_row(const Params& p, int scale, int bnd, int slot,
                                           int ncls, int c) {
  return p.edge + (((static_cast<long long>(scale) * p.blocks + bnd) * (1 + p.max_run) + slot)
                   * ncls + c) * p.ws;
}

// A finished source row h's sum for (class row, source column), unless it
// is a share's first row whose rows above are another block's: that row's
// sum the boundary's merge writes.
__device__ __forceinline__ void put(const Params& p, int img, int row, int h, int s,
                                    float v, bool merged) {
  if (!merged) {
    p.out[((static_cast<long long>(img) * p.n_rows + row) * p.hs + h) * p.ws + s] = v;
  }
}

// Boundary `bnd` of a scale, source row h of image img, once this block has
// written its side of the row to the edge buffer: the block that arrives
// second continues the block above's partial sum with the block below's
// terms in ascending y (the parent's order exactly) and writes the row.
__device__ void merge_boundary(const Params& p, int scale, int bnd, int img, int h,
                               int ncls, int row0) {
  __shared__ int second;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) second = atomicAdd(p.arrive + scale * p.blocks + bnd, 1);
  __syncthreads();
  if (!second) return;
  __threadfence();
  // the block below's terms: its rows whose first height tap is row h
  int y = __ldg(p.h_beg + h), terms = 0;
  const int y_end = __ldg(p.h_end + h);
  while (y < y_end && __ldg(p.h_lo + y) < h) ++y;
  while (y + terms < y_end && __ldg(p.h_lo + y + terms) == h) ++terms;
  for (int i = threadIdx.x; i < ncls * p.ws; i += blockDim.x) {
    const int c = i / p.ws, s = i - c * p.ws;
    float v = __ldcg(edge_row(p, scale, bnd, 0, ncls, c) + s);
    for (int j = 0; j < terms; ++j) {
      v = __fadd_rn(v, __ldcg(edge_row(p, scale, bnd, 1 + j, ncls, c) + s));
    }
    p.out[((static_cast<long long>(img) * p.n_rows + row0 + c) * p.hs + h) * p.ws + s] = v;
  }
}

// MAXC: the size of the per-pixel class arrays; EXACT: n_cls == MAXC;
// UNIFORM: uniform buckets without dither (the model paths' map); IDS: the
// bucket ids are written out (the checking path's `with_bucket_ids`).
template <int MAXC, bool EXACT, bool UNIFORM, bool IDS>
__global__ void __launch_bounds__(max_threads(MAXC), 1)
fu_grad_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const int ncls = EXACT ? MAXC : p.n_cls;
  fu::BucketMap bm = p.bm;
  if constexpr (UNIFORM) {
    bm.adaptive = 0;
    bm.dither = 0;
  }
  const int nb = bm.n_buckets;
  const int scale = blockIdx.y;
  const int row0 = scale * ncls;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cp = (ncls + 3) & ~3;

  if (p.table_smem) {
    uint16_t* t = reinterpret_cast<uint16_t*>(smem);
    const float* tg = p.table + static_cast<long long>(row0) * 2 * nb;
    for (int i = tid; i < ncls * 2 * nb; i += nthr) {
      t[i] = static_cast<uint16_t>(__float_as_uint(__ldg(tg + i)) >> 16);
    }
  }

  const long long total = static_cast<long long>(p.n) * p.hs;  // < 2^31
  const int r_beg = static_cast<int>(total * blockIdx.x / p.blocks);
  const int r_end = static_cast<int>(total * (blockIdx.x + 1) / p.blocks);

  // the share's pieces, one per image
  for (int r = r_beg, first = 1; r < r_end; first = 0) {
    const int img = r / p.hs;
    const int h0 = r - img * p.hs;
    const int h1 = min(p.hs, h0 + (r_end - r));
    // the terms of row h0 from this share's rows, and the partial sum of
    // row h1, go to the edge buffer
    const bool edge_top = first && h0 > 0;
    const bool edge_bot = r + (h1 - h0) == r_end && h1 < p.hs;
    r += h1 - h0;
    int y0, y1;
    reach(p.h_beg, p.h_end, h0, h1, y0, y1);
    if (edge_top) {
      while (y0 < y1 && __ldg(p.h_lo + y0) < h0) ++y0;
    }

    for (int k = 0; k < p.n_chunks; ++k) {
      const int s_a = k * p.chunk_s;
      const int ns = min(p.ws, s_a + p.chunk_s) - s_a;
      int x_a, x_b;
      reach(p.w_beg, p.w_end, s_a, s_a + ns, x_a, x_b);
      const int span = x_b - x_a;
      const int c_a = span > 0 ? __ldg(p.w_lo + x_a) : 0;
      const int c_b = span > 0 ? min(__ldg(p.w_lo + x_b - 1) + 1, p.ws - 1) + 1 : 0;
      // the chunk's width taps, and zero running sums
      float* const wt = reinterpret_cast<float*>(smem + p.off_wt);
      int* const xs = reinterpret_cast<int*>(smem + p.off_xs);
      for (int i = tid; i < ns; i += nthr) {
        const int s = s_a + i;
        const int beg = __ldg(p.w_beg + s), cnt = __ldg(p.w_end + s) - beg;
        xs[i] = cnt > 0 ? beg - x_a : 0;
        xs[p.chunk_s + i] = max(cnt, 0);
        for (int m = 0; m < p.max_taps; ++m) {
          const int x = beg + m;
          wt[m * p.chunk_s + i] =
              m < cnt ? tap_weight(__ldg(p.w_lo + x), __ldg(p.w_w0 + x), __ldg(p.w_w1 + x), s)
                      : 0.0f;
        }
      }
      const int items = ncls * ns;
      float* const acc = reinterpret_cast<float*>(smem + p.off_acc);  // [a | b]
      for (int i = tid; i < items; i += nthr) {
        acc[i] = 0.0f;
        acc[ncls * p.chunk_s + i] = 0.0f;
      }

      // The owners of row y, then the pixels of row y + 1, whose labels load
      // during the owners (y = y0 - 1: pixels only; y = y1 - 1: owners
      // only).
      const bool one_round = span <= nthr;
      const int lrow0 = img * p.h_pad;  // < 2^31
      int cur = h0;      // the source row the running sum `a` is for
      int win_row = -1;  // the source row staged in the window's slot 0
      __syncthreads();   // the taps are in
      for (int y = y0 - 1; y < y1; ++y) {
        const bool next = y + 1 < y1;
        const int lbl_next = next && one_round && tid < span
                                 ? __ldg(p.labels + static_cast<long long>(lrow0 + y + 1)
                                                             * p.w_pad + x_a + tid)
                                 : -1;
        if (y >= y0) {
          // owner phase of row y (source row lo >= cur): the width taps in
          // ascending x, then the height taps into the running sums of
          // source rows lo and lo + 1
          const int lo = __ldg(p.h_lo + y);
          const float hw0 = __ldg(p.h_w0 + y), hw1 = __ldg(p.h_w1 + y);
          const float* dz = reinterpret_cast<const float*>(smem + p.off_dz);
          for (int i = tid; i < items; i += nthr) {
            int c, sl;
            owner_of(i, ncls, c, sl);
            const int u0 = xs[sl], cnt = xs[p.chunk_s + sl];
            const float* dzc = dz + c * p.dz_stride + u0;
            const float* wtc = wt + sl;
            float d = 0.0f;
#pragma unroll 4
            for (int m = 0; m < cnt; ++m) {
              d = __fadd_rn(d, __fmul_rn(wtc[m * p.chunk_s], dzc[m]));
            }
            float a = acc[i], b = acc[ncls * p.chunk_s + i];
            int cc = cur;
            for (; cc < lo; ++cc) {  // the rows have passed source row cc
              put(p, img, row0 + c, cc, s_a + sl, a, edge_top && cc == h0);
              a = b;
              b = 0.0f;
            }
            const float t = __fmul_rn(hw0, d);
            if (edge_top && cc == h0) {  // a term for the boundary's merge
              edge_row(p, scale, blockIdx.x, 1 + y - y0, ncls, c)[s_a + sl] = t;
            } else {
              a = __fadd_rn(a, t);
            }
            b = __fadd_rn(b, __fmul_rn(hw1, d));
            acc[i] = a;
            acc[ncls * p.chunk_s + i] = b;
          }
          cur = lo;
        }
        if (next) {
          const int yn = y + 1;
          if (y >= y0) __syncthreads();  // the owners have read dz
          const int lo_next = __ldg(p.h_lo + yn);
          const float* base =
              p.logits + (static_cast<long long>(img) * p.n_rows + row0) * p.hs * p.ws;
          float* const win = reinterpret_cast<float*>(smem + p.off_win);
          if (lo_next != win_row) {
            stage_rows(p, base, lo_next, c_a, c_b, ncls, cp, win);
            __syncthreads();
            win_row = lo_next;
          }
          // pixel phase of row yn: dz of every class at each output pixel
          float* const dz = reinterpret_cast<float*>(smem + p.off_dz);
          const long long lrow = static_cast<long long>(lrow0 + yn) * p.w_pad;
          for (int u0 = 0; u0 < span; u0 += nthr) {  // uniform across the block
            const int u = u0 + tid;
            const bool in = u < span;
            const int x = x_a + (in ? u : span - 1);
            const int lbl = one_round ? lbl_next : (in ? __ldg(p.labels + lrow + x) : -1);
            float* const dzu = dz + u;
            if (!__any_sync(kFull, lbl >= 0)) {
              if (in) {
                for (int c = 0; c < ncls; ++c) {
                  dzu[c * p.dz_stride] = 0.0f;
                  if constexpr (IDS) {
                    p.bids[(static_cast<long long>(img) * p.n_rows + row0 + c) * p.h_pad
                               * p.w_pad + static_cast<long long>(yn) * p.w_pad + x] = -1;
                  }
                }
              }
              continue;
            }
            const fu::Taps taps = fu::pixel_taps(yn, x, p.hs, p.ws, p.h_lo, p.h_w0, p.h_w1,
                                                 p.w_lo, p.w_w0, p.w_w1);
            float z[MAXC];
            const float* w00 = win + (taps.s0 - c_a) * cp;
            const float* w01 = win + (taps.s1 - c_a) * cp;
            const float* w10 = w00 + p.win_w * cp;
            const float* w11 = w01 + p.win_w * cp;
#pragma unroll
            for (int c = 0; c < MAXC; c += 4) {
              if (c < ncls) {
                const float4 v00 = *reinterpret_cast<const float4*>(w00 + c);
                const float4 v10 = *reinterpret_cast<const float4*>(w10 + c);
                const float4 v01 = *reinterpret_cast<const float4*>(w01 + c);
                const float4 v11 = *reinterpret_cast<const float4*>(w11 + c);
                z[c] = fu::tap_combine(taps, v00.x, v10.x, v01.x, v11.x);
                if (c + 1 < MAXC) z[c + 1] = fu::tap_combine(taps, v00.y, v10.y, v01.y, v11.y);
                if (c + 2 < MAXC) z[c + 2] = fu::tap_combine(taps, v00.z, v10.z, v01.z, v11.z);
                if (c + 3 < MAXC) z[c + 3] = fu::tap_combine(taps, v00.w, v10.w, v01.w, v11.w);
              }
            }
            float sum;
            fu::exp_terms<MAXC>(ncls, z, sum);
            const float shift = bm.dither ? fu::dither_shift(lrow + x, bm) : 0.0f;
            const bool counted = lbl >= 0;
            float s = 0.0f;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
              if (c < ncls) {
                const float prob = __fdiv_rn(z[c], sum);
                const bool fg = lbl == c;
                const int b = fu::pixel_bucket(prob, fg, shift, bm);
                const int t = ((row0 + c) * 2 + (fg ? 1 : 0)) * nb + b;
                const float de =
                    p.table_smem
                        ? __uint_as_float(static_cast<uint32_t>(
                              reinterpret_cast<const uint16_t*>(smem)[t - row0 * 2 * nb]) << 16)
                        : __ldg(p.table + t);
                const float dp = counted ? (fg ? -de : de) : 0.0f;
                z[c] = prob;
                s = __fadd_rn(s, __fmul_rn(dp, prob));
                if (in) {
                  dzu[c * p.dz_stride] = dp;  // read back below
                  if constexpr (IDS) {
                    p.bids[(static_cast<long long>(img) * p.n_rows + row0 + c) * p.h_pad
                               * p.w_pad + static_cast<long long>(yn) * p.w_pad + x] =
                        counted ? b : -1;
                  }
                }
              }
            }
            if (in) {
#pragma unroll
              for (int c = 0; c < MAXC; ++c) {
                if (c < ncls) {
                  float* const d = dzu + c * p.dz_stride;
                  *d = counted ? __fmul_rn(z[c], __fsub_rn(*d, s)) : 0.0f;
                }
              }
            }
          }
        }
        __syncthreads();  // dz of row y + 1 is in
      }

      // the share's source rows the output rows did not pass yet
      for (int i = tid; i < items; i += nthr) {
        int c, sl;
        owner_of(i, ncls, c, sl);
        float a = acc[i], b = acc[ncls * p.chunk_s + i];
        for (int cc = cur; cc < h1; ++cc) {
          put(p, img, row0 + c, cc, s_a + sl, a, edge_top && cc == h0);
          a = b;
          b = 0.0f;
        }
        if (edge_bot) edge_row(p, scale, blockIdx.x + 1, 0, ncls, c)[s_a + sl] = a;  // row h1's
      }
      __syncthreads();  // the next chunk rewrites the taps
    }
    if (edge_top) merge_boundary(p, scale, blockIdx.x, img, h0, ncls, row0);
    if (edge_bot) merge_boundary(p, scale, blockIdx.x + 1, img, h1, ncls, row0);
  }
}

using Kernel = void (*)(const Params);

// The instance of a class count: at C 17 with uniform buckets and no dither
// (the model paths), one compiled for that map; the instances that write
// the bucket ids are the general ones.
template <bool IDS>
Kernel pick_for(int n_cls, bool uniform) {
  if constexpr (!IDS) {
    if (n_cls == 17 && uniform) return fu_grad_kernel<17, true, true, false>;
  }
  if (n_cls == 17) return fu_grad_kernel<17, true, false, IDS>;
  if (n_cls <= 8) return fu_grad_kernel<8, false, false, IDS>;
  if (n_cls <= 16) return fu_grad_kernel<16, false, false, IDS>;
  if (n_cls <= 24) return fu_grad_kernel<24, false, false, IDS>;
  return fu_grad_kernel<32, false, false, IDS>;
}

Kernel pick(int n_cls, bool uniform, bool ids) {
  return ids ? pick_for<true>(n_cls, uniform) : pick_for<false>(n_cls, uniform);
}

// Let `kern` take `smem` bytes of dynamic shared memory (an error beyond
// what a block may opt into).
cudaError_t prepare(Kernel kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool valid_threads(int n_cls, int threads) {
  return n_cls >= 1 && n_cls <= kMaxClasses && threads >= 32 && threads % 32 == 0
         && threads <= max_threads(n_cls);
}

}  // namespace

extern "C" {

// The number of blocks of this instance and plan the device holds at once,
// in *resident; returns a cudaError_t. The launch plan sizes its grid from it.
int fu_grad_resident(int n_cls, int threads, int smem, int uniform, int device,
                     int* resident) {
  if (!valid_threads(n_cls, threads) || smem < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Kernel kern = pick(n_cls, uniform, false);
  err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  return *resident >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Returns a cudaError_t: 0 when the launch was accepted. The plan's
// arguments (threads .. smem) come from lovasz_grad.py `b2_plan`; `smem`
// must be the layout's size exactly; `edge` holds the plan's edge buffer
// and `arrive` its n_scales * blocks counters, zeros.
int fu_grad_bwd(const float* logits, const int* labels, const int* h_lo,
                const float* h_w0, const float* h_w1, const int* h_beg,
                const int* h_end, const int* w_lo, const float* w_w0,
                const float* w_w1, const int* w_beg, const int* w_end,
                const float* table, float* out, int* bids, float* edge, int* arrive, int n,
                int n_scales, int n_cls, int hs, int ws, int h_pad, int w_pad,
                int n_buckets, int adaptive, int a_half, int a_shift, int a_q0,
                float a_emin, int dither, int seed, float inv_b, int threads,
                int blocks, int chunk_s, int chunk_px, int max_taps, int win_w,
                int table_smem, int max_run, int smem, int device, void* stream) {
  if (!valid_threads(n_cls, threads) || n < 1 || n_scales < 1 || n_scales > 65535 || hs < 1
      || ws < 1 || static_cast<long long>(n) * max(hs, h_pad) > INT_MAX || blocks < 1
      || static_cast<long long>(blocks) > static_cast<long long>(n) * hs
      || chunk_s < 1 || chunk_px < 1 || max_taps < 0 || win_w < 1
      || (table_smem != 0 && table_smem != 1) || max_run < 0 || edge == nullptr
      || arrive == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Layout l = layout(n_cls, n_buckets, table_smem, chunk_s, chunk_px, max_taps, win_w);
  if (smem != 4 * l.words) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
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
  p.out = out;
  p.bids = bids;
  p.edge = edge;
  p.arrive = arrive;
  p.n = n;
  p.n_cls = n_cls;
  p.n_rows = n_scales * n_cls;
  p.hs = hs;
  p.ws = ws;
  p.h_pad = h_pad;
  p.w_pad = w_pad;
  p.blocks = blocks;
  p.chunk_s = chunk_s;
  p.n_chunks = (ws + chunk_s - 1) / chunk_s;
  p.chunk_px = chunk_px;
  p.max_taps = max_taps;
  p.win_w = win_w;
  p.table_smem = table_smem;
  p.max_run = max_run;
  p.off_dz = l.off_dz;
  p.dz_stride = l.dz_stride;
  p.off_acc = l.off_acc;
  p.off_wt = l.off_wt;
  p.off_xs = l.off_xs;
  p.off_win = l.off_win;
  p.bm.n_buckets = n_buckets;
  p.bm.adaptive = adaptive;
  p.bm.a_half = a_half;
  p.bm.a_shift = a_shift;
  p.bm.a_q0 = a_q0;
  p.bm.a_emin = a_emin;
  p.bm.dither = dither;
  p.bm.seed = static_cast<uint32_t>(seed);
  p.bm.inv_b = inv_b;
  const Kernel kern = pick(n_cls, !adaptive && !dither, bids != nullptr);
  err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(blocks, n_scales), threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
