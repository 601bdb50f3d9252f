// Helpers shared by the pruning kernels (pruning_forward.cu,
// pruning_reverse.cu, pruning_slot.cu, pruning_classic_reverse.cu,
// pruning_fold.cu, pruning_static.cu): the
// per-column state rows, the child contraction and its transpose (P read
// from device memory, or from a shared-memory stage as 16-byte vectors), the
// cp.async copies that fill such a stage, the reverse walks' warp sums of
// dP, the 64-state reverse walks' four-lane contractions, block dP sums
// and per-child body,
// the one kernel that sums the reverse walks' dP rows, the exact
// power-of-two rescale, and the dispatch from a run-time state count to the
// compiled instantiations.
#pragma once

#include <cfloat>
#include <cstddef>
#include <type_traits>
#include <cuda_runtime.h>

namespace pruning {

constexpr int kThreads = 256;   // walk kernels: one thread per column

// Leaf rows between batch elements' leaves from an entry point's
// leaf_batch (floats between them): 0 where the batch shares one
// (n_leaves, sites, S) set, n_leaves for leaves (B, n_leaves, sites, S);
// -1 for a stride of no whole leaf rows, or one whose B batch elements'
// rows pass an int. Batch element b of every walk reads leaf row b
// leaf_rows + leaf: one int row offset, one kernel for both forms.
inline int leaf_rows_of(long long leaf_batch, int B, int sites, int s) {
  const long long row = static_cast<long long>(sites) * s;
  if (leaf_batch < 0 || leaf_batch % row != 0 ||
      (leaf_batch / row) * B >= (1LL << 31)) {
    return -1;
  }
  return static_cast<int>(leaf_batch / row);
}

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

// A lane's kRows entries of a row, stored as the widest vectors they allow.
template <int kRows>
__device__ __forceinline__ void store_part(float* dst, const float (&v)[kRows]) {
  if constexpr (kRows % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else if constexpr (kRows % 2 == 0) {
#pragma unroll
    for (int q = 0; q < kRows / 2; ++q) {
      reinterpret_cast<float2*>(dst)[q] = make_float2(v[2 * q], v[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r] = v[r];
  }
}

// Floats between the rows of an S x S block of P staged in shared memory:
// S, and S + 4 at 64 states. There the lanes that share a column form rows
// r kL + h (lane_row): rows 64 floats apart would put the rows the lanes
// read at once in one bank quad (a 4-way conflict on every LDS.128), 68
// apart puts them in four.
template <int S>
__host__ __device__ constexpr int p_row() {
  return S == 64 ? S + 4 : S;
}

// Floats of one staged S x S block of P.
template <int S>
__host__ __device__ constexpr int p_block() {
  return S * p_row<S>();
}

// Where 16-byte vector q of an S x S block of P (row-major in device
// memory) goes in its staged copy (rows p_row apart).
template <int S>
__device__ __forceinline__ int p_stage_offset(int q) {
  return (q / (S / 4)) * p_row<S>() + 4 * (q % (S / 4));
}

// The r-th of the S / kL rows lane h of the kL lanes of a column forms:
// h S / kL + r, a contiguous share, below 64 states; r kL + h at 64
// (see p_row).
template <int S, int kL>
__device__ __forceinline__ int lane_row(int h, int r) {
  return S == 64 ? r * kL + h : h * (S / kL) + r;
}

// Four consecutive entries of row r of an S x S block P (row-major, rows
// p_row<S>() apart) staged in shared memory, as one 16-byte load. Every
// thread of a block reads the same address, so the load is a broadcast
// (LDS.128): one load feeds four FMAs. The stage must be 16-byte aligned
// and S a multiple of 4.
template <int S>
__device__ __forceinline__ float4 p_vec(const float* pm, int r, int q) {
  static_assert(S % 4 == 0, "P rows are read as 16-byte vectors");
  return reinterpret_cast<const float4*>(pm + r * p_row<S>())[q];
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

// The 64-state reverse walks (pruning_reverse.cu's B3 and
// pruning_classic_reverse.cu's B7 at S = 64, codon's 61 or 60 states padded
// with zero states): one thread's rows of g, the siblings' product, gy, x
// and P^T gy would take ~5 x 64 registers, and a warp's 64 x 64 dP entries
// fit neither registers nor S = 20's warp-private blocks. So kWideLanes
// lanes share a column, lane h keeping rows lane_row(h, r) = 4 r + h of g
// and gy, and a block of kWideTile columns (256 threads) sums each child's
// dP from two shared tiles of its columns' gy and x rows, one 4 x 4
// sub-block a thread.
constexpr int kWideLanes = 4;
constexpr int kWideTile = 64;

// Floats of one 64-state reverse block: a P ring of kPStages stages of
// `children` S x S blocks, rows p_row apart, then the gy and x tiles
// (2, tile, p_row).
template <int S>
__host__ __device__ constexpr size_t wide_smem_floats(int children, int tile) {
  return (static_cast<size_t>(kPStages) * children * S + 2 * static_cast<size_t>(tile)) *
         p_row<S>();
}

// 16-byte vector q of row r of an S x S block of P: staged in shared memory
// (kShared, rows p_row apart) or in device memory (row-major, read through
// the read-only path).
template <int S, bool kShared>
__device__ __forceinline__ float4 wide_p_vec(const float* pm, int r, int q) {
  if constexpr (kShared) {
    return p_vec<S>(pm, r, q);
  } else {
    return __ldg(reinterpret_cast<const float4*>(pm + r * S) + q);
  }
}

// Steps of the j loops below unrolled: 4 (wide_times_child) or 2
// (wide_transpose) with P in shared memory; 1 with P in device memory,
// where ptxas otherwise keeps every unrolled step's 16-byte loads of P in
// flight at once (B7's 64-state kernel took 255 registers and spilled 68
// bytes with both of its paths unrolled alike: nvcc -Xptxas -v, sm_90a).
template <bool kShared>
__host__ __device__ constexpr int wide_unroll(int shared_steps) {
  return kShared ? shared_steps : 1;
}

// gy[r] *= (P x)[lane_row(h, r)] for lane h's S / kWideLanes rows, with x a
// row of S floats in device memory read as 16-byte vectors (not held in
// registers): each row's fmaf chain in j order, times_child's.
template <int S, bool kShared>
__device__ __forceinline__ void wide_times_child(const float* pm,
                                                 const float* x, int h,
                                                 float (&gy)[S / kWideLanes]) {
  constexpr int kL = kWideLanes;
  constexpr int kRows = S / kL;
  constexpr int kUnroll = wide_unroll<kShared>(4);
  const float4* xo = reinterpret_cast<const float4*>(x);
  float y[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) y[r] = 0.0f;
#pragma unroll (kUnroll)
  for (int q = 0; q < S / 4; ++q) {
    const float4 xv = xo[q];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 v = wide_p_vec<S, kShared>(pm, lane_row<S, kL>(h, r), q);
      y[r] = fmaf(v.x, xv.x, y[r]);
      y[r] = fmaf(v.y, xv.y, y[r]);
      y[r] = fmaf(v.z, xv.z, y[r]);
      y[r] = fmaf(v.w, xv.w, y[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) gy[r] *= y[r];
}

// Entries [h kRows, (h + 1) kRows) of P^T gy, gy the column's whole row in
// the shared gy tile: each an fmaf chain in j order (transpose_apply's).
template <int S, bool kShared>
__device__ __forceinline__ void wide_transpose(const float* pm,
                                               const float* gy_row, int h,
                                               float (&gc)[S / kWideLanes]) {
  constexpr int kRows = S / kWideLanes;
  constexpr int kUnroll = wide_unroll<kShared>(2);
#pragma unroll
  for (int r = 0; r < kRows; ++r) gc[r] = 0.0f;
#pragma unroll (kUnroll)
  for (int q = 0; q < S / 4; ++q) {
    const float4 gv = *reinterpret_cast<const float4*>(gy_row + 4 * q);
    const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int v = 0; v < kRows / 4; ++v) {
        const float4 pv = wide_p_vec<S, kShared>(pm, 4 * q + jj, h * kRows / 4 + v);
        gc[4 * v] = fmaf(pv.x, ga[jj], gc[4 * v]);
        gc[4 * v + 1] = fmaf(pv.y, ga[jj], gc[4 * v + 1]);
        gc[4 * v + 2] = fmaf(pv.z, ga[jj], gc[4 * v + 2]);
        gc[4 * v + 3] = fmaf(pv.w, ga[jj], gc[4 * v + 3]);
      }
    }
  }
}

// Lane h's rows of one node's row of S floats (g from its slot or a seed):
// src[lane_row(h, r)].
template <int S>
__device__ __forceinline__ void wide_load_rows(const float* src, int h,
                                               float (&v)[S / kWideLanes]) {
#pragma unroll
  for (int r = 0; r < S / kWideLanes; ++r) v[r] = src[lane_row<S, kWideLanes>(h, r)];
}

// One child of a 64-state reverse visit, up to its dP: lane h's gy rows into
// the column's row of the gy tile and its quarter [h kRows, (h + 1) kRows)
// of the child's partials row `x` (zeros past the sites) into the x tile,
// a block barrier, then sub-block (ib, jb) of gy x^T summed over the
// tile's columns in column order (two 16-byte loads per 16 FMAs) into acc.
template <int S>
__device__ __forceinline__ void wide_dp_tiles(float* gy_t, float* x_t, int col,
                                              int h, bool live, const float* x,
                                              const float (&gy)[S / kWideLanes],
                                              float (&acc)[16]) {
  constexpr int kRows = S / kWideLanes;
  constexpr int LD = p_row<S>();
  constexpr int kSub = S / 4;
  float* gy_row = gy_t + col * LD;
  float* x_row = x_t + col * LD;
#pragma unroll
  for (int r = 0; r < kRows; ++r) gy_row[lane_row<S, kWideLanes>(h, r)] = gy[r];
  float4 xq[kRows / 4];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    xq[q] = live ? reinterpret_cast<const float4*>(x)[h * kRows / 4 + q]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) reinterpret_cast<float4*>(x_row + h * kRows)[q] = xq[q];
  __syncthreads();  // both tiles are whole
  const int ib = threadIdx.x / kSub;
  const int jb = threadIdx.x % kSub;
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
  for (int s2 = 0; s2 < kWideTile; ++s2) {
    const float4 gv = *reinterpret_cast<const float4*>(gy_t + s2 * LD + 4 * ib);
    const float4 xv = *reinterpret_cast<const float4*>(x_t + s2 * LD + 4 * jb);
    const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a * 4 + e] = fmaf(ga[a], xa[e], acc[a * 4 + e]);
    }
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

// 2^{-r_n} of one visit at one column: the exponent counts of the node's
// internal children, summed in child order, minus the node's own (es holds
// the internal nodes' counts, (n_inner, sites)).
__device__ __forceinline__ float visit_inv_m(const int* __restrict__ kids,
                                             int cnt, int node, int n_leaves,
                                             const float* __restrict__ es,
                                             size_t ns, int site) {
  float esum = 0.0f;
  for (int c = 0; c < cnt; ++c) {
    const int child = __ldg(kids + c);
    if (child >= n_leaves) {
      esum += es[static_cast<size_t>(child - n_leaves) * ns + site];
    }
  }
  return exp2_int(esum - es[static_cast<size_t>(node - n_leaves) * ns + site]);
}

// Child c of a 64-state reverse visit: the body B3's and B7's 64-state
// kernels share, which differ only in where a node's g comes from and in
// how a block's dP row adds up over its tiles. gy = g x the siblings' y (in
// child order) x inv_m; sub-block (threadIdx.x / 16, threadIdx.x % 16) of
// the child's dP over the block's tile stored at dst (row-major S x S), or
// added to what is there when `add`; then, where `out` is not null, lane
// h's quarter of P_c^T gy, plus the same quarter of the row `plus` where
// that is not null (a seed below another seed), stored into the row `out`.
// p_of(c2) is child c2's P block (staged, rows p_row apart, when kShared)
// and x_of(c2) its partials row at this column. Ends with a block barrier:
// the tiles are read before the next child's overwrite them.
template <int S, bool kShared, class POf, class XOf>
__device__ __forceinline__ void wide_reverse_child(
    int c, int cnt, const POf& p_of, const XOf& x_of, bool live,
    const float (&g)[S / kWideLanes], float inv_m, float* gy_t, float* x_t,
    int col, int h, float* dst, bool add, const float* plus, float* out) {
  constexpr int kRows = S / kWideLanes;
  constexpr int kSub = S / 4;
  float gy[kRows];  // the siblings' product, then gy, rows 4 r + h
#pragma unroll
  for (int r = 0; r < kRows; ++r) gy[r] = 1.0f;
  if (live) {
    for (int c2 = 0; c2 < cnt; ++c2) {
      if (c2 == c) continue;
      wide_times_child<S, kShared>(p_of(c2), x_of(c2), h, gy);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) gy[r] = g[r] * gy[r] * inv_m;
  float acc[16];  // dP sub-block (ib, jb) of the child over the tile
  wide_dp_tiles<S>(gy_t, x_t, col, h, live, x_of(c), gy, acc);
  const int ib = threadIdx.x / kSub;
  const int jb = threadIdx.x % kSub;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float4* d = reinterpret_cast<float4*>(dst + (4 * ib + a) * S + 4 * jb);
    float4 v = make_float4(acc[a * 4], acc[a * 4 + 1], acc[a * 4 + 2], acc[a * 4 + 3]);
    if (add) {
      const float4 o = *d;
      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    }
    *d = v;
  }
  if (out != nullptr) {
    float gc[kRows];
    wide_transpose<S, kShared>(p_of(c), gy_t + col * p_row<S>(), h, gc);
    if (plus != nullptr) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) gc[r] += plus[h * kRows + r];
    }
    store_part<kRows>(out + h * kRows, gc);
  }
  __syncthreads();
}

namespace {

// dP[b, node, k] = sum over the rows of dp_rows[b, k, :, node] in row
// order with a compensated (Kahan) add; zero for `root` (-1: none, the
// caller zeroed its rows). One thread per entry of dP (B, n_nodes, K, S,
// S). The one row sum of the reverse walks (B3 and B7), in the anonymous
// namespace so that each source instantiates its own.
template <int S>
__global__ void __launch_bounds__(256)
dp_rows_kernel(const float* __restrict__ dp_rows,  // (B, K, rows, n_nodes, S, S)
               float* __restrict__ dp,             // (B, n_nodes, K, S, S)
               int B, int K, int n_nodes, int rows, int root) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * n_nodes * K * S * S) return;
  const int e = static_cast<int>(idx % (S * S));
  const int k = static_cast<int>(idx / (S * S) % K);
  const int node = static_cast<int>(idx / (static_cast<size_t>(S) * S * K) % n_nodes);
  const size_t b = idx / (static_cast<size_t>(S) * S * K * n_nodes);
  if (node == root) {  // no parent edge
    dp[idx] = 0.0f;
    return;
  }
  const size_t stride = static_cast<size_t>(n_nodes) * S * S;
  const float* __restrict__ src = dp_rows + (b * K + k) * rows * stride +
                                  static_cast<size_t>(node) * S * S + e;
  float acc = 0.0f;
  float comp = 0.0f;
  for (int t = 0; t < rows; ++t) {
    const float y = src[t * stride] - comp;
    const float s = acc + y;
    comp = (s - acc) - y;
    acc = s;
  }
  dp[idx] = acc;
}

// Launches dp_rows_kernel<S> on `stream`; returns cudaGetLastError().
template <int S>
int launch_dp_rows(const float* dp_rows, float* dp, int B, int K,
                   int n_nodes, int rows, int root, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * n_nodes * K * S * S;
  dp_rows_kernel<S><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dp_rows, dp, B, K, n_nodes, rows, root);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Calls launch(std::integral_constant<int, S>{}) for the state counts every
// kernel is compiled for: DNA 4, protein 20 and 64, the width codon's 61
// (or 60) states and every count from 21 to 63 are padded to
// (ops/cuda_pruning.py::padded_states). Any other count returns
// cudaErrorInvalidValue without launching.
template <typename F>
int dispatch_states(int s, F&& launch) {
  switch (s) {
    case 4:
      return launch(std::integral_constant<int, 4>{});
    case 20:
      return launch(std::integral_constant<int, 20>{});
    case 64:
      return launch(std::integral_constant<int, 64>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pruning
