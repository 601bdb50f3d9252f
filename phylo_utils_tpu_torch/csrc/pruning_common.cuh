// Helpers shared by the pruning kernels (pruning_forward.cu,
// pruning_reverse.cu, pruning_slot.cu, pruning_classic_reverse.cu,
// pruning_fold.cu, pruning_static.cu): the
// per-column state rows, the child contraction and its transpose (P read
// from device memory, or from a shared-memory stage as 16-byte vectors), the
// cp.async copies that fill such a stage, the reverse walks' warp sums of
// dP, the 64-state walks' tiled products (B5, B3, B7), block dP sums and
// the reverses' staged visit,
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
// S, and S + 4 at 64 states, where a quarter-warp of the tiled products
// reads 8 consecutive rows at once: 64 floats apart they would share one
// bank quad (an 8-way conflict on every LDS.128), 68 apart they take
// eight.
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

// wait until every committed group has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// The 64-state walks' tiled products: the stream walk (pruning_slot.cu's
// B5) and the reverse walks (pruning_reverse.cu's B3, pruning_classic_
// reverse.cu's B7) at S = 64, codon's 61 or 60 states padded with zero
// states. A block of 256 threads owns a tile of kWideTile columns (sites),
// and each contraction is one product over the tile, P X or P^T GY, with
// the tile's rows of x (or gy) and P staged in shared memory, rows
// p_row<64>() = 68 floats apart. Thread t = 32 w + l forms a 4 x 4
// micro-tile: rows wide_rg() + 16 a of P X and rows 4 wide_rg() + a of
// P^T GY, columns wide_cg() + 16 b (a, b < 4), with wide_rg() = 8 (w & 1)
// + (l & 7) and wide_cg() = 4 (w >> 1) + (l >> 3). Per four steps j of
// its chains it reads four 16-byte vectors of P and four of x: eight FMAs
// a load, where the first 64-state design (four lanes a column, each
// column's row read once a lane from device memory) read one vector of P
// per four FMAs. A warp reads 8 consecutive rows of P (or 8 consecutive
// quads of one row) and 4 consecutive columns of x, each set in distinct
// bank quads at 68 floats a row. A warp's LDS.128 moves 512 bytes to its
// lanes at the SM's 128 bytes a clock, so eight FMAs a load hold these
// loops to half the card's f32 rate. 8 x 4 micro-tiles (10.7 FMAs a load)
// measured no faster: B5 in blocks of 128 threads (half the warps), B3 and
// B7 with a binary visit's two children on the block's two halves. Every
// entry stays one fmaf chain in j order, times_child's and
// transpose_apply_shared's, so the bits do not change. Measured in turns
// against the first 64-state design (kernel_turns.py --states 64, NVIDIA
// H100 80GB HBM3, 700 W) at 100 taxa x 4096 codon sites, 4 categories: B5
// 1.124 ms (2.186 before; 33% of its operations bound), B3 3.662 (5.840;
// 25%), B7 3.781 (6.001; 24%); the hot loops read 0.125 loads an FMA
// (0.27 before), and the rest of the gap is the loads, barriers and
// staging around them.
constexpr int kWideTile = 64;
// children a staged 64-state reverse visit may have (their y = P x held
// in registers at once)
constexpr int kWideStaged = 3;

__device__ __forceinline__ int wide_rg() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}

__device__ __forceinline__ int wide_cg() {
  return (threadIdx.x >> 6) * 4 + ((threadIdx.x >> 3) & 3);
}

// Floats of one tile of rows (kWideTile columns, or an S x S block of P)
// staged in shared memory at 64 states.
template <int S>
__host__ __device__ constexpr int wide_tile_floats() {
  return kWideTile * p_row<S>();
}

// gy tiles of a 64-state reverse block whose visits stage `children`
// children: two where a visit has at most two (one barrier a child), else
// one (a second barrier a child).
__host__ __device__ constexpr int wide_gy_tiles(int children) {
  return children <= 2 ? 2 : 1;
}

// Floats of one 64-state reverse block (B3's and B7's): a ring of two
// stages, each `children` P blocks then their x tiles, then the gy tiles.
template <int S>
__host__ __device__ constexpr size_t wide_smem_floats(int children) {
  return (2 * 2 * static_cast<size_t>(children) + wide_gy_tiles(children)) *
         wide_tile_floats<S>();
}

// 16 bytes at p: from shared memory, or (kGlobal) from device memory
// through the read-only path.
template <bool kGlobal>
__device__ __forceinline__ float4 wide_ld4(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

// entry i (a constant once unrolled) of v
__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// y[a][b] = sum_j pr[a][j] xc[b][j]: rows pr[a] of P and columns xc[b]
// (each a row of S states), in shared memory or (kGlobal) device memory;
// each an fmaf chain in j order (times_child's). Through L1 one step at a
// time: unrolled, ptxas keeps every step's loads in flight at once.
// kXGlobal (P in shared memory): the columns in device memory, read by
// plain loads, which see rows the block wrote earlier in the walk (the
// read-only path of __ldg need not). kUnroll: steps of four j unrolled.
template <int S, bool kGlobal, bool kXGlobal = kGlobal,
          int kUnroll = (kGlobal || kXGlobal) ? 1 : 2>
__device__ __forceinline__ void wide_product(const float* const (&pr)[4],
                                             const float* const (&xc)[4],
                                             float (&y)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) y[a][b] = 0.0f;
  }
#pragma unroll (kUnroll)
  for (int q = 0; q < S / 4; ++q) {
    float4 pv[4], xv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pv[a] = wide_ld4<kGlobal>(pr[a] + 4 * q);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      xv[b] = kXGlobal && !kGlobal ? *reinterpret_cast<const float4*>(xc[b] + 4 * q)
                                   : wide_ld4<kGlobal>(xc[b] + 4 * q);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        y[a][b] = fmaf(pv[a].x, xv[b].x, y[a][b]);
        y[a][b] = fmaf(pv[a].y, xv[b].y, y[a][b]);
        y[a][b] = fmaf(pv[a].z, xv[b].z, y[a][b]);
        y[a][b] = fmaf(pv[a].w, xv[b].w, y[a][b]);
      }
    }
  }
}

// out[a][b] = (P^T gy)[r0 + a] at column b, for one S x S block P (rows
// ldp floats apart) in shared memory or (kGlobal) device memory and gc[b]
// the column's row of gy in shared memory; each an fmaf chain in j order
// (transpose_apply_shared's).
template <int S, bool kGlobal>
__device__ __forceinline__ void wide_transpose(const float* pm, int ldp, int r0,
                                               const float* const (&gc)[4],
                                               float (&out)[4][4]) {
  constexpr int kUnroll = kGlobal ? 1 : 2;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[a][b] = 0.0f;
  }
#pragma unroll (kUnroll)
  for (int q = 0; q < S / 4; ++q) {
    float4 gv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) gv[b] = *reinterpret_cast<const float4*>(gc[b] + 4 * q);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 pv = wide_ld4<kGlobal>(pm + (4 * q + jj) * ldp + r0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float gj = f4_at(gv[b], jj);
        out[0][b] = fmaf(pv.x, gj, out[0][b]);
        out[1][b] = fmaf(pv.y, gj, out[1][b]);
        out[2][b] = fmaf(pv.z, gj, out[2][b]);
        out[3][b] = fmaf(pv.w, gj, out[3][b]);
      }
    }
  }
}

// Sub-block (ib, jb) = (t / 16, t % 16) of gy x^T summed over the tile's
// columns in column order, from the gy and x tiles ((kWideTile, p_row)
// each): two 16-byte loads per 16 FMAs. Stored at dst (row-major S x S),
// or added to what is there when `add`, which is read before the sum (a
// load consumed at once stalls the warp for a round trip to L2).
template <int S>
__device__ __forceinline__ void wide_dp(const float* gy_t, const float* x_t,
                                        float* dst, bool add) {
  constexpr int LD = p_row<S>();
  constexpr int kSub = S / 4;
  static_assert(kSub * kSub == 256, "one 4 x 4 sub-block a thread");
  const int i0 = 4 * (threadIdx.x / kSub);
  const int jb = threadIdx.x % kSub;
  float4 old[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    old[a] = add ? *reinterpret_cast<const float4*>(dst + (i0 + a) * S + 4 * jb)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
  }
  for (int s2 = 0; s2 < kWideTile; ++s2) {
    const float4 gv = *reinterpret_cast<const float4*>(gy_t + s2 * LD + i0);
    const float4 xv = *reinterpret_cast<const float4*>(x_t + s2 * LD + 4 * jb);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float ga = f4_at(gv, a);
      acc[a][0] = fmaf(ga, xv.x, acc[a][0]);
      acc[a][1] = fmaf(ga, xv.y, acc[a][1]);
      acc[a][2] = fmaf(ga, xv.z, acc[a][2]);
      acc[a][3] = fmaf(ga, xv.w, acc[a][3]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float4 v = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    if (add) {
      v = make_float4(old[a].x + v.x, old[a].y + v.y, old[a].z + v.z, old[a].w + v.w);
    }
    *reinterpret_cast<float4*>(dst + (i0 + a) * S + 4 * jb) = v;
  }
}

// The 64-state walks whose columns each belong to one warp: B2
// (pruning_forward.cu's pruning_saveall_wide_kernel) and the live-row body
// (pruning_rows.cuh's row_walk_wide_kernel, B1, B4, B8 and B9). Lane l of
// warp w forms the 4 x 4 micro-tile of rows tile_rg() + 16 a and columns
// tile_col(b) = 8 w + (l >> 4) + 2 b (a, b < 4): the wide_product of
// B5's layout, but a column's 64 rows lie in the 16 lanes of one
// half-warp. So a column's rescale max is 4 exact shuffles (no shared row
// and block barrier), and the rows a warp forms are read back only by
// that warp, after __syncwarp. A quarter-warp's 8 lanes read 8 rows of P
// (68 floats apart: distinct bank quads) and one column's x vector (a
// broadcast), so x rows may lie 64 floats apart, as the live rows do.
__device__ __forceinline__ int tile_rg() { return threadIdx.x & 15; }

__device__ __forceinline__ int tile_col(int b) {
  return 8 * (threadIdx.x >> 5) + ((threadIdx.x >> 4) & 1) + 2 * b;
}

// rescale_pow2 over each of the thread's four columns (acc[a][b], rows
// tile_rg() + 16 a of column tile_col(b)): the max over the column's 64
// rows by exact shuffles within its half-warp, then the same scale; the
// exponents are added to e[b].
__device__ __forceinline__ void tile_rescale(float (&acc)[4][4], float (&e)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float m = FLT_MIN;
#pragma unroll
    for (int a = 0; a < 4; ++a) m = fmaxf(m, acc[a][b]);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    int eb = (__float_as_int(m) >> 23) & 0xFF;
    eb = min(max(eb, 1), 253);
    const float scale = __int_as_float((254 - eb) << 23);
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][b] *= scale;
    e[b] += static_cast<float>(eb - 127);
  }
}

// Writes the thread's entries v[a][b] (rows rg + 16 a, columns cg + 16 b)
// into a tile of rows (kWideTile, p_row) in shared memory.
template <int S>
__device__ __forceinline__ void wide_put(float* tile, int rg, int cg,
                                         const float (&v)[4][4]) {
  constexpr int LD = p_row<S>();
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int a = 0; a < 4; ++a) tile[(cg + 16 * b) * LD + rg + 16 * a] = v[a][b];
  }
}

// Child c's outside vector at the thread's columns cols[b]: out[a][b]
// (rows r0 + a), plus the same rows of plus_of(c, col) where that is not
// null (a seed below another seed), stored as one 16-byte vector into
// out_of(c, col) where that is not null (a dead column, or a leaf without
// dleaf).
template <class OutOf, class PlusOf>
__device__ __forceinline__ void wide_store_out(int c, int r0, const int (&cols)[4],
                                               float (&out)[4][4],
                                               const OutOf& out_of,
                                               const PlusOf& plus_of) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float* o = out_of(c, cols[b]);
    if (o == nullptr) continue;
    const float* pl = plus_of(c, cols[b]);
    if (pl != nullptr) {
      const float4 v = *reinterpret_cast<const float4*>(pl + r0);
      out[0][b] += v.x;
      out[1][b] += v.y;
      out[2][b] += v.z;
      out[3][b] += v.w;
    }
    *reinterpret_cast<float4*>(o + r0) =
        make_float4(out[0][b], out[1][b], out[2][b], out[3][b]);
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

// visit_inv_m at the thread's columns cols[j] of a tile from column site0
// (zero at a column past n_live), for a visit of cnt <= kWideStaged
// children kids[c]: every exponent load issued before any is summed (a
// chain of loads each summed at once stalls the warp for a round trip to
// L2 per load), then the same sums in child order.
__device__ __forceinline__ void wide_inv_m(const int (&kids)[kWideStaged], int cnt,
                                           int node, int n_leaves,
                                           const float* __restrict__ es, size_t ns,
                                           int site0, const int (&cols)[4], int n_live,
                                           float (&inv_m)[4]) {
  float en[4];
  float ek[kWideStaged][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = cols[j] < n_live;
    const size_t site = static_cast<size_t>(site0) + cols[j];
    en[j] = live ? es[static_cast<size_t>(node - n_leaves) * ns + site] : 0.0f;
#pragma unroll
    for (int c = 0; c < kWideStaged; ++c) {
      ek[c][j] = live && c < cnt && kids[c] >= n_leaves
                     ? es[static_cast<size_t>(kids[c] - n_leaves) * ns + site]
                     : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float esum = 0.0f;
#pragma unroll
    for (int c = 0; c < kWideStaged; ++c) {
      if (c < cnt && kids[c] >= n_leaves) esum += ek[c][j];
    }
    inv_m[j] = cols[j] < n_live ? exp2_int(esum - en[j]) : 0.0f;
  }
}

// One staged visit of a 64-state reverse walk: the body B3's and B7's
// 64-state kernels share, which differ only in where a node's g comes from
// and how a block's dP row adds up over its tiles. Its cnt <= kWideStaged
// children's P blocks (p, S x p_row floats each) and x tiles (x, (kWideTile,
// p_row) each, zeros past the sites) are staged in shared memory.
// gval(row, col) is the node's g at a live column col < n_live of the
// tile, invm(cols, inv_m) its 2^{-r_n} at columns cols (wide_inv_m); dst_of(c) child c's dP row (added to when
// `add`); out_of(c, col) and plus_of(c, col) as wide_store_out's. In 4 x 4
// micro-tiles: y_c = P_c x_c for every child once (the first design formed
// the siblings' y again for each child), then for each child gy_c = g x
// the siblings' y (in child order) x inv_m, zero on dead columns, put in gy
// tile c % n_gy; a block barrier; its dP rows (wide_dp); P_c^T gy_c. With
// one gy tile, a second barrier a child before the next overwrites it;
// with two, the next child's barrier orders it, and the caller's next
// barrier frees the stage.
template <int S, class GVal, class InvM, class DstOf, class OutOf, class PlusOf>
__device__ __forceinline__ void wide_reverse_visit(
    int cnt, const float* p, const float* x, const GVal& gval,
    const InvM& invm, int n_live, float* gy_tiles, int n_gy,
    const DstOf& dst_of, bool add, const OutOf& out_of,
    const PlusOf& plus_of) {
  constexpr int LD = p_row<S>();
  constexpr int kTileF = wide_tile_floats<S>();
  const int rg = wide_rg();
  const int cg = wide_cg();
  int cols[4];
  float g[4][4];
  float inv_m[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    cols[b] = cg + 16 * b;
#pragma unroll
    for (int a = 0; a < 4; ++a) g[a][b] = cols[b] < n_live ? gval(rg + 16 * a, cols[b]) : 0.0f;
  }
  invm(cols, inv_m);
  float y[kWideStaged][4][4];
#pragma unroll
  for (int c = 0; c < kWideStaged; ++c) {
    if (c < cnt) {
      const float* pr[4];
      const float* xc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pr[a] = p + c * kTileF + (rg + 16 * a) * LD;
#pragma unroll
      for (int b = 0; b < 4; ++b) xc[b] = x + c * kTileF + cols[b] * LD;
      wide_product<S, false>(pr, xc, y[c]);
    }
  }
  for (int c = 0; c < cnt; ++c) {
    float gy[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float prod = 1.0f;
#pragma unroll
        for (int c2 = 0; c2 < kWideStaged; ++c2) {
          if (c2 < cnt && c2 != c) prod *= y[c2][a][b];
        }
        gy[a][b] = cols[b] < n_live ? g[a][b] * prod * inv_m[b] : 0.0f;
      }
    }
    float* gy_t = gy_tiles + (c % n_gy) * kTileF;
    wide_put<S>(gy_t, rg, cg, gy);
    __syncthreads();  // the gy tile is whole
    wide_dp<S>(gy_t, x + c * kTileF, dst_of(c), add);
    const float* gc[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) gc[b] = gy_t + cols[b] * LD;
    float out[4][4];
    wide_transpose<S, false>(p + c * kTileF, LD, 4 * rg, gc, out);
    wide_store_out(c, 4 * rg, cols, out, out_of, plus_of);
    if (n_gy == 1) __syncthreads();  // the tile is read before the next child's
  }
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
