// Shared helpers of the kernels: element conversion and 16-byte
// row loads from global memory into f32 tiles in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

// The reference's finite mask value: a fully masked tile then computes
// exp(NEG_INF - NEG_INF) = 1 instead of inf - inf = NaN, and a real score
// arriving later wipes it with exp(NEG_INF - m) = 0.
#define REPRO_NEG_INF (-0.7f * FLT_MAX)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}

// Round an f32 value through T and back: the reference casts the softmax
// probabilities to the value type before the P.V product.
template <typename T>
__device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

// A tile of ROWS rows of DH elements, copied from global memory into an f32
// tile in shared memory. `load` issues every 16-byte read of the tile into
// registers before any is used, so the reads overlap instead of paying one
// memory latency each; `store` converts them into the shared tile. Rows
// r >= n_valid are zero-filled and their memory is never read, so whatever
// lies past the valid length cannot reach the result.
template <typename T, int DH, int ROWS, int NTHREADS>
struct RowTile {
  static constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte read
  static constexpr int VPR = DH / VEC;        // reads per row
  static constexpr int TOTAL = ROWS * VPR;
  static constexpr int ITERS = (TOTAL + NTHREADS - 1) / NTHREADS;
  uint4 raw[ITERS];

  // row r starts at src + r * stride (in elements)
  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t stride, int n_valid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = threadIdx.x + it * NTHREADS;
      const int r = i / VPR, c = (i % VPR) * VEC;
      if (i < TOTAL && r < n_valid)
        raw[it] = *reinterpret_cast<const uint4*>(src + r * stride + c);
      else
        raw[it] = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits: 0.0 in f32 and bf16
    }
  }

  // row r lands at dst + r * ld
  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = threadIdx.x + it * NTHREADS;
      if (i < TOTAL) {
        const int r = i / VPR, c = (i % VPR) * VEC;
        const T* e = reinterpret_cast<const T*>(&raw[it]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[r * ld + c + j] = to_f32(e[j]);
      }
    }
  }
};

// Calls f(std::integral_constant<int, Dh>{}) for a head dimension the
// attention kernels are built for (checks.HEAD_DIMS), so a kernel templated
// on it is instantiated once per value; any other Dh is refused.
template <class F>
int with_head_dim(int Dh, F&& f) {
  switch (Dh) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
