// Helpers shared by the attention kernels: float32 conversion of the
// element types they take, and the staging of rows of a (.., D) tensor
// into shared memory.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiles {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copies `rows` rows of D elements (row r at src + r * row_stride, 16-byte
// aligned) into shared memory as float32 with a row stride of D + 1, so
// that threads walking a column hit distinct banks; rows at or past
// `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t row_stride, int rows,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kVec;
    float* out = dst + r * (D + 1) + c;
    if (r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = to_f32(vals[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = 0.0f;
    }
  }
}

}  // namespace tiles
