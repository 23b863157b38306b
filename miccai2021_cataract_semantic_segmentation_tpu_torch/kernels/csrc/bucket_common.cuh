// The bucket map shared by B3 (bucket_hist.cu) and B4 (bucket_grad.cu).
//
// B4 reads the gradient of the bucket B3 counted a pixel in, so both take
// the bucket id from this one function: the generic route's fixed map
// min(int(e * 2048), 2047) of the float32 error (bucket_lovasz.py:93, 162).
// A negative id (an error below -1/2048) is counted nowhere and gets a
// gradient of 0, as the TPU kernels' one-hots never match it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "error.cuh"

namespace bk {

constexpr int kBuckets = 2048;
constexpr int kBins = 2 * kBuckets;  // [bg | fg] x bucket

__device__ __forceinline__ int bucket_id(float e) {
  // float -> int truncates toward zero, as the reference's astype(int32)
  return min(static_cast<int>(__fmul_rn(e, static_cast<float>(kBuckets))),
             kBuckets - 1);
}

}  // namespace bk
