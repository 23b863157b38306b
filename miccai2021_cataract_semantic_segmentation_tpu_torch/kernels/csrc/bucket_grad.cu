// B4: the generic bucket-Lovász backward gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_grad_kernel`
// (miccai2021_cataract_semantic_segmentation_tpu/losses/bucket_lovasz.py:152,
// launched by `_bucket_grad`). For every (row, pixel) of the (R, P) float32
// errors and bool foreground flags it writes
//   grad = table[row][fg][min(int(e * 2048), 2047)]
// with the bucket id of B3 (bucket_common.cuh), or 0 where that id is
// negative. `table` is (R, 2, 2048) float32 [row][bg, fg][bucket]: the
// per-bucket Lovász gradients already scaled by the cotangent of each row's
// loss and rounded to bf16 by the wrapper, as the TPU kernel rounds its
// table, so the kernel and its plain version read the same values. It is a
// pure gather: it equals the plain version bit for bit.
//
// What bounds it on the card: bytes. It reads each error (4 bytes) and flag
// (1 byte) once and writes one float32 gradient; at the HRNetv2 cell
// (R 17, P 8 x 544 x 960) that is 639 MB, 0.19 ms at 3.35 TB/s. The table
// (278 KB) stays in L1/L2.
//
// The simple design: blockIdx.y is the row, so no thread divides by P; the
// threads of a block stride over the row's pixels with coalesced loads and
// stores. Fusing the error construction (softmax, |fg - p|, and the softmax
// VJP after the gather) into this pass is later work.

#include "bucket_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bucket_grad_kernel(const float* __restrict__ errors,
                   const uint8_t* __restrict__ fg,
                   const float* __restrict__ table, long long p,
                   float* __restrict__ out) {
  const long long row = blockIdx.y;
  const float* e_row = errors + row * p;
  const uint8_t* f_row = fg + row * p;
  const float* t_row = table + row * bk::kBins;
  float* o_row = out + row * p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p; i += stride) {
    const int b = bk::bucket_id(__ldg(e_row + i));
    o_row[i] = b < 0 ? 0.0f
                     : __ldg(t_row + (__ldg(f_row + i) ? bk::kBuckets : 0) + b);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int bucket_grad_bwd(const float* errors, const unsigned char* fg,
                    const float* table, int rows, long long p, float* out,
                    int device, void* stream) {
  if (rows < 1 || rows > 65535 || p < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // about eight blocks per SM over all rows; each thread takes several
  // pixels of its row
  long long per_row = (8LL * sms + rows - 1) / rows;
  const long long most = (p + kThreads - 1) / kThreads;
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  bucket_grad_kernel<<<dim3(static_cast<unsigned>(per_row), rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(errors, fg, table,
                                                            p, out);
  return cudaGetLastError();
}

}  // extern "C"
