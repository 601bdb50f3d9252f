// Helpers shared by the pruning kernels (pruning_forward.cu,
// pruning_reverse.cu, pruning_slot.cu): the per-column state rows, the
// child contraction, the exact power-of-two rescale, and the dispatch from
// a run-time state count to the compiled instantiations.
#pragma once

#include <cfloat>
#include <cstddef>
#include <type_traits>
#include <cuda_runtime.h>

namespace pruning {

constexpr int kThreads = 256;   // walk kernels: one thread per column

// One node's S states of one column: rows are S contiguous floats. When S is
// a multiple of 4 a row is whole 16-byte vectors (16 bytes at S = 4, 80 at
// S = 20), and every row offset is a multiple of 16 bytes.
template <int S>
__device__ __forceinline__ void load_states(const float* __restrict__ src,
                                            float (&x)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) x[j] = src[j];
  }
}

template <int S>
__device__ __forceinline__ void store_states(float* __restrict__ dst,
                                             const float (&x)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) dst[j] = x[j];
  }
}

// acc[r] *= (P x)[r] for one S x S block P (row-major), an fmaf chain in j
// order. kShared: P lies in shared memory (plain loads); else in device
// memory, read through the read-only path (every thread of a block reads the
// same entries, which the hardware broadcasts).
template <int S, bool kShared>
__device__ __forceinline__ void times_child(const float* __restrict__ pm,
                                            const float (&x)[S],
                                            float (&acc)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float y = 0.0f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float pv = kShared ? pm[r * S + j] : __ldg(pm + r * S + j);
      y = fmaf(pv, x[j], y);
    }
    acc[r] *= y;
  }
}

// Exact power-of-two rescale, bit for bit ops/pruning.pow2_rescale: scales
// acc by 2^-floor(log2 m), m = max(max_r acc[r], FLT_MIN), and returns the
// exponent floor(log2 m) (an exact integer, in f32).
template <int S>
__device__ __forceinline__ float rescale_pow2(float (&acc)[S]) {
  float m = FLT_MIN;
#pragma unroll
  for (int r = 0; r < S; ++r) m = fmaxf(m, acc[r]);
  int eb = (__float_as_int(m) >> 23) & 0xFF;
  eb = min(max(eb, 1), 253);
  const float scale = __int_as_float((254 - eb) << 23);
#pragma unroll
  for (int r = 0; r < S; ++r) acc[r] *= scale;
  return static_cast<float>(eb - 127);
}

// exact 2^k for an integer-valued k, bit for bit ops/pruning.exp2_int
__device__ __forceinline__ float exp2_int(float k) {
  const int ki = static_cast<int>(fminf(fmaxf(k, -126.0f), 127.0f));
  return __int_as_float((ki + 127) << 23);
}

// Calls launch(std::integral_constant<int, S>{}) for the state counts the
// kernels are compiled for (DNA 4, protein 20); any other count returns
// cudaErrorInvalidValue without launching.
template <typename F>
int dispatch_states(int s, F&& launch) {
  switch (s) {
    case 4:
      return launch(std::integral_constant<int, 4>{});
    case 20:
      return launch(std::integral_constant<int, 20>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pruning
