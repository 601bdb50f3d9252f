// Helpers shared by the pruning kernels (pruning_forward.cu,
// pruning_reverse.cu, pruning_slot.cu, pruning_classic_reverse.cu,
// pruning_fold.cu, pruning_static.cu): the
// per-column state rows, the child contraction and its transpose (P read
// from device memory, or from a shared-memory stage as 16-byte vectors), the
// cp.async copies that fill such a stage, the reverse walks' warp sums of
// dP, the exact power-of-two rescale, and the dispatch from a run-time state
// count to the compiled instantiations.
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

// Four consecutive entries of row r of an S x S block P (row-major) staged
// in shared memory, as one 16-byte load. Every thread of a block reads the
// same address, so the load is a broadcast (LDS.128): one load feeds four
// FMAs. The stage must be 16-byte aligned and S a multiple of 4.
template <int S>
__device__ __forceinline__ float4 p_vec(const float* pm, int r, int q) {
  static_assert(S % 4 == 0, "P rows are read as 16-byte vectors");
  return reinterpret_cast<const float4*>(pm + r * S)[q];
}

// acc[r] *= (P x)[r] for one S x S block P (row-major), an fmaf chain in j
// order. kShared: P lies in a shared-memory stage, read row by row as
// 16-byte broadcast vectors (p_vec); else in device memory, read one entry
// at a time through the read-only path (every thread of a block reads the
// same entries, which the hardware broadcasts through L1). Both give the
// same bits: the chain's order does not depend on how P is read.
template <int S, bool kShared>
__device__ __forceinline__ void times_child(const float* __restrict__ pm,
                                            const float (&x)[S],
                                            float (&acc)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float y = 0.0f;
    if constexpr (kShared) {
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 v = p_vec<S>(pm, r, q);
        y = fmaf(v.x, x[4 * q], y);
        y = fmaf(v.y, x[4 * q + 1], y);
        y = fmaf(v.z, x[4 * q + 2], y);
        y = fmaf(v.w, x[4 * q + 3], y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < S; ++j) y = fmaf(__ldg(pm + r * S + j), x[j], y);
    }
    acc[r] *= y;
  }
}

// out = P^T v for one S x S block P (row-major) in device memory, fmaf
// chain in j order
template <int S>
__device__ __forceinline__ void transpose_apply(const float* __restrict__ pm,
                                                const float (&v)[S],
                                                float (&out)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < S; ++j) acc = fmaf(__ldg(pm + j * S + r), v[j], acc);
    out[r] = acc;
  }
}

// transpose_apply with P in a shared-memory stage: row j of P is read as
// S / 4 broadcast vectors and feeds out[r] for every r, so each out[r] is
// the same fmaf chain in j order (the same bits) from S^2 / 4 loads.
template <int S>
__device__ __forceinline__ void transpose_apply_shared(const float* pm,
                                                       const float (&v)[S],
                                                       float (&out)[S]) {
#pragma unroll
  for (int r = 0; r < S; ++r) out[r] = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 pv = p_vec<S>(pm, j, q);
      out[4 * q] = fmaf(pv.x, v[j], out[4 * q]);
      out[4 * q + 1] = fmaf(pv.y, v[j], out[4 * q + 1]);
      out[4 * q + 2] = fmaf(pv.z, v[j], out[4 * q + 2]);
      out[4 * q + 3] = fmaf(pv.w, v[j], out[4 * q + 3]);
    }
  }
}

// One 16-byte asynchronous copy from device memory into shared memory
// (cp.async, bypassing L1), and the group fences that order such copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stages of the P ring of the walks that stage P in shared memory: node
// i + 2's blocks are copied (cp.async) into stage (i + 2) % 3 while node i
// computes from stage i % 3, right after the barrier of node i. That one
// barrier per node both publishes node i's copies (each thread first waits
// for its own with cp.async.wait_group 1) and frees stage (i + 2) % 3,
// which node i - 1 read before it.
constexpr int kPStages = 3;

// dP sums of the reverse walks (pruning_reverse.cu, pruning_classic_reverse.cu):
// each entry of gy x^T summed over a warp's 32 sites in a fixed order,
// without block barriers.

// One step of warp_scatter16: a lane keeps one half of its first 2H
// entries (the upper half where lane bit 2H is set), sends the other half
// to lane ^ 2H and adds what it receives. H is a template argument so that
// every index is a constant and v stays in registers.
template <int H>
__device__ __forceinline__ void scatter_step(float (&v)[16], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const float send = upper ? v[e] : v[e + H];
    const float keep = upper ? v[e + H] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// The sum over the warp's 32 lanes of each of v[0..15], by a reduce-scatter:
// after four steps (8 + 4 + 2 + 1 shuffles) lane l holds entry l >> 1
// summed over 16 lanes, and a last exchange with lane l ^ 1 completes it
// (16 shuffles instead of 80 for a butterfly per entry). The order of every
// add is fixed, and a + b is b + a, so both lanes of a pair hold the same
// bits.
__device__ __forceinline__ float warp_scatter16(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// part[i * S + j] = sum over the warp's 32 sites of gy[i] x[j] at S = 20,
// where 400 products a lane would not fit in registers: the lanes put their
// rows in the warp's own stretch of shared memory `ws` (2 x 32 x S floats),
// then lane l < (S / 4)^2 sums the 4 x 4 sub-block l over the 32 sites in
// lane order, two 16-byte loads (broadcasts within one row) per 16 FMAs.
// Only __syncwarp: no other warp touches `ws`.
template <int S>
__device__ __forceinline__ void warp_dp_blocked(const float (&gy)[S],
                                                const float (&x)[S],
                                                float* ws, float* part) {
  constexpr int kSubs = (S / 4) * (S / 4);
  static_assert(S % 4 == 0 && kSubs <= 32, "one 4 x 4 sub-block a lane");
  const int lane = threadIdx.x & 31;
  float* wg = ws;
  float* wx = ws + 32 * S;
  store_states<S>(wg + lane * S, gy);
  store_states<S>(wx + lane * S, x);
  __syncwarp();
  if (lane < kSubs) {
    const int i0 = (lane / (S / 4)) * 4;
    const int j0 = (lane % (S / 4)) * 4;
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    for (int s = 0; s < 32; ++s) {
      const float4 gv = *reinterpret_cast<const float4*>(wg + s * S + i0);
      const float4 xv = *reinterpret_cast<const float4*>(wx + s * S + j0);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a * 4 + c] = fmaf(ga[a], xa[c], acc[a * 4 + c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) part[(i0 + a) * S + j0 + c] = acc[a * 4 + c];
    }
  }
  __syncwarp();  // the rows are read before the next child overwrites them
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
