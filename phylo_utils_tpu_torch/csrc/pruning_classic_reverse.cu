// Classic reverse (gradient) walk of Felsenstein pruning for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_bwd_kernel. It computes
// what that kernel computes, not a copy of its VMEM tiling. From the
// residuals of pruning_saveall_f32 (every internal node's rescaled partials
// x_n and exponent count e_n) and the cotangents gseed_j of the seed nodes'
// rescaled partials: outside vectors g start at the seeds (zero elsewhere);
// then for every internal node n in pre-order, with y_c = P_c x_c for each
// child c and 2^{-r_n} = 2^{sum_c e_c - e_n} an exact power of two
// (exp2_int in ops/pruning.py),
//     gy_c  = g_n * prod_{c' != c} y_c' * 2^{-r_n},
//     dP_c += sum_sites gy_c x_c^T,
//     g_c  += P_c^T gy_c,
// and the leaves' g is their partials' cotangent (dleaf). The rescale
// divisors are constants of the backward, which is exact because logL does
// not depend on them.
//
// Where it differs from pruning_reverse_f32 (the deferred reverse, B3): any
// set of seeds, a seed below a seed included; dP rows capped by the
// launch's blocks, so its scratch does not grow with the sites; and any
// number of children a node. It is the only reverse past B3's scratch and
// for a node wider than B3's shared-memory stage.
//
// Its first version read P one entry at a time through L1 and summed each
// child's dP with a block reduction and a barrier pair per child (0.965 ms
// at the flagship's B = 64 against B3's 0.505, 17.0 ms at 512 taxa x 8192
// LG patterns; NVIDIA H100 80GB HBM3, 700 W). This one takes B3's walk
// machinery:
// - One thread per (site, k, b) column, `tile` sites a block. A block walks
//   every gridDim.x-th tile of its (k, b) in turn (a grid-stride loop), so
//   the launch has a capped number of blocks whatever the site count.
// - Each node's g lives in a slot of g_slots, (B, K, n_gslots, sites, S),
//   only from its parent's visit to its own: the walk is the reverse of the
//   DFS post-order, so n_gslots is O(depth x cmax) (ReverseSchedule in
//   ops/cuda_pruning.py). A thread reads and writes only its own column.
// - The walk goes in steps: a visit whose children number at most
//   `stage_children` is one step, and the block stages its children's P
//   blocks in shared memory two steps ahead, in a kPStages-deep cp.async
//   ring (one barrier a step), read as 16-byte broadcast vectors
//   (times_child<S, true>, transpose_apply_shared). A wider visit takes
//   ceil(count / stage_children) steps, one group of children each, and
//   reads its P through the read-only path (times_child<S, false>,
//   transpose_apply). The choice is per visit, from the schedule, inside
//   the kernel, and both paths run the same fmaf chains.
// - dP inside the walk, without block barriers of its own: while gy_c and
//   x_c are in registers, each entry's sum over a warp's 32 sites is formed
//   in a fixed order (warp_scatter16 at S = 4, warp_dp_blocked at S = 20,
//   pruning_common.cuh). The warps' sums are added in warp order at the
//   next step's barrier into the block's own row of dp_rows, (B, K, rows,
//   n_nodes, S, S), which thus adds across the block's tiles in tile order.
//   A second kernel, B3's (pruning_common.cuh's dp_rows_kernel), sums the
//   rows in row order with a compensated add. There are no atomics, so two
//   launches on the same inputs give bit-identical dP.
// - gy, g and dleaf per column are the deferred kernel's arithmetic (the
//   same fmaf chains in the same order, the siblings' y recomputed in child
//   order), so with one seed at the root both reverses give the same dleaf
//   bits and differ in dP only by the order of the site sums. Threads past
//   the last site stay in the loop for the barriers and add zeros.
// At S = 64 (codon's 61 or 60 states padded with zero states by
// ops/cuda_pruning.py) one thread a column would hold ~5 x 64 rows of g,
// the siblings' product, gy, x and P^T gy, and a warp's 64 x 64 dP entries
// fit neither registers nor S = 20's warp-private blocks. So
// classic_reverse_wide_kernel takes B3's 64-state layout (pruning_reverse.cu,
// pruning_common.cuh's wide_* helpers): four lanes a column, each keeping
// rows 4 r + h of g and gy; 64 columns a block of 256 threads; P staged with
// rows 68 floats apart; per child the block's gy and x rows in two shared
// tiles, from which thread t sums dP's 4 x 4 sub-block (t / 16, t % 16) over
// the tile's columns and adds it into the block's row (the first tile
// stores), and lane h forms entries [16 h, 16 h + 16) of P^T gy. B7's
// contract stays: several seeds, one dP row a block over every gridDim.x-th
// tile, and a visit of more children than the stage holds (at most 3 in
// 227 KB, ops/cuda_pruning.py::classic_reverse_stage) read through L1 in
// groups. A child's work is B3's own code (pruning_common.cuh's
// wide_reverse_child), so with one seed at the root its dleaf is B3's bit
// for bit, and so is its dP where every block walks one tile. The outer
// loops stay two: B3's walks one tile a block and stages each visit whole
// (its scratch grows with the sites); B7's walks its block's tiles in turn
// through a ring of steps of at most `stage_children` children.
// The entry point is compiled for S = 4, 20 and 64 and refuses any other.
//
// What bounds it on an H100: per internal node and column it reads g, each
// child's x and exponent (the siblings' x again for each child), and writes
// each child's g (dleaf at leaves); at S = 20 operations bound it (per
// child and column 2 S^2 flops each for y, P^T gy and dP, and the
// siblings' y again at a node of more than two children). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (kernel_turns.py, PERF.md section 6):
// 6.38 ms at 512 taxa x 8192 LG patterns (19% of its operations bound;
// 17.0 ms before; B3 4.87 ms, with the same hot loops in its SASS), 368 us
// of device time at the flagship's B = 64 (903 before; B3 493) and 160 at
// B = 1 (266; B3 158). A visit read through L1 is as slow as before: the
// root of 49 children at 20 states takes 21.6 ms (23.2 before), its 49 x
// 48 sibling contractions a load per FMA.

#include "pruning_common.cuh"

namespace {

using pruning::exp2_int;
using pruning::load_states;
using pruning::store_states;

constexpr int kMaxTile = 256;   // sites per block, one per thread (the widest)

// The steps of a block's walk, in walk order, tile after tile (every
// gridDim.x-th tile from its own): visit i's children [c0, c0 + cs) for c0
// = 0, cs, ... below its count (one step for a visit of none). next()
// copies the next step not yet staged, at (st, si, sc), into stage
// `staged` % kPStages of the P ring when its visit is staged (count <= cs:
// the whole visit, P blocks p_block<S>() floats apart, rows p_row<S>()
// apart), and commits the group. Both of this file's kernels walk it.
template <int S>
struct StepRing {
  float* p_stage;                 // (kPStages, cs, p_block<S>()) floats
  const float* __restrict__ pb;   // P of (b, node 0, k): + node p_node_stride
  size_t p_node_stride;
  const int* __restrict__ counts;
  const int* __restrict__ children;
  int cmax, n_int, n_tiles, cs;
  int st, si, sc, staged;

  __device__ __forceinline__ void next() {
    constexpr int kBlockVecs = S * S / 4;
    if (st < n_tiles) {
      const int cnt = __ldg(counts + si);
      if (cnt <= cs) {
        float* dst = p_stage + static_cast<size_t>(staged % pruning::kPStages) *
                                   cs * pruning::p_block<S>();
        for (int v = threadIdx.x; v < cnt * kBlockVecs; v += blockDim.x) {
          const int c = v / kBlockVecs;
          const int q = v - c * kBlockVecs;
          const int child = __ldg(children + si * cmax + c);
          pruning::cp_async16(dst + c * pruning::p_block<S>() + pruning::p_stage_offset<S>(q),
                              pb + child * p_node_stride + 4 * q);
        }
      }
      sc += cs;
      if (sc >= cnt) {
        sc = 0;
        if (++si == n_int) {
          si = 0;
          st += gridDim.x;
        }
      }
    }
    ++staged;
    pruning::cp_async_commit();
  }
};

template <int S>
__global__ void __launch_bounds__(kMaxTile)
classic_reverse_walk_kernel(const float* __restrict__ p,       // (B, n_nodes, K, S, S)
                            const float* __restrict__ leaves,  // (B?, n_leaves, sites, S): leaf_rows
                            const int* __restrict__ rnode,     // (n_int,) pre-order
                            const int* __restrict__ gslot,     // (n_int,)
                            const int* __restrict__ children,  // (n_int, cmax)
                            const int* __restrict__ cslot,     // (n_int, cmax)
                            const int* __restrict__ counts,    // (n_int,)
                            const int* __restrict__ node_seed, // (n_nodes,)
                            const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                            const float* __restrict__ res_e,   // (B, K, n_inner, sites)
                            const float* __restrict__ gseeds,  // (B, K, n_seed, sites, S)
                            float* __restrict__ g_slots,       // (B, K, n_gslots, sites, S)
                            float* __restrict__ dp_rows,       // (B, K, rows, n_nodes, S, S)
                            float* __restrict__ dleaf,         // (B, K, n_leaves, sites, S) or null
                            int K, int n_nodes, int n_leaves, int n_int,
                            int cmax, int sites, int n_seed, int n_gslots,
                            int stage_children, int leaf_rows) {
  const int cs = stage_children;
  extern __shared__ float4 smem_vec[];
  const int warps = blockDim.x >> 5;
  // the P ring (kPStages, cs, S, S), the warps' dP sums of the last two
  // steps (2, warps, cs, S * S) and, at S = 20, each warp's gy and x rows
  // (warps, 2, 32, S)
  float* p_stage = reinterpret_cast<float*>(smem_vec);
  float* part = p_stage + pruning::kPStages * cs * S * S;
  float* wstage = part + 2 * warps * cs * S * S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int lrow0 = b * leaf_rows;  // b's first leaf row (0: shared)
  const size_t bk = static_cast<size_t>(b) * K + k;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t ns = static_cast<size_t>(sites);
  const float* __restrict__ xs = res_x + bk * n_inner * ns * S;
  const float* __restrict__ es = res_e + bk * n_inner * ns;
  const float* __restrict__ seeds = gseeds + bk * n_seed * ns * S;
  float* __restrict__ slots = g_slots + bk * n_gslots * ns * S;
  float* __restrict__ dls =
      dleaf == nullptr ? nullptr : dleaf + bk * n_leaves * ns * S;
  float* __restrict__ row =
      dp_rows + (bk * gridDim.x + blockIdx.x) * n_nodes * S * S;
  const float* __restrict__ pb =
      p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  const int n_tiles = (sites + blockDim.x - 1) / blockDim.x;

  // the steps in walk order, staged two ahead (StepRing)
  StepRing<S> ring{p_stage, pb, p_node_stride, counts, children, cmax,
                   n_int, n_tiles, cs, static_cast<int>(blockIdx.x), 0, 0, 0};
  // the last step's dP sums: the warps' partial sums, added in warp order,
  // into the block's row (the block owns its row; tiles add in tile order).
  // The block's first tile stores them (every child's entries once a tile),
  // so a launch whose blocks walk one tile each reads no row back.
  int prev_i = -1, prev_c0 = 0, prev_n = 0;
  bool prev_first = true;
  auto flush = [&](int parity) {
    const float* src = part + static_cast<size_t>(parity) * warps * cs * S * S;
    for (int e = threadIdx.x; e < prev_n * S * S; e += blockDim.x) {
      float total = 0.0f;
      for (int w = 0; w < warps; ++w) total += src[w * cs * S * S + e];
      const int c = e / (S * S);
      const int child = __ldg(children + prev_i * cmax + prev_c0 + c);
      float* dst = row + static_cast<size_t>(child) * S * S + (e - c * S * S);
      *dst = prev_first ? total : *dst + total;
    }
  };
  ring.next();
  ring.next();

  int step = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int site = tile * blockDim.x + threadIdx.x;
    const bool live = site < sites;
    for (int i = 0; i < n_int; ++i) {
      const int node = __ldg(rnode + i);
      const int cnt = __ldg(counts + i);
      const bool staged_visit = cnt <= cs;
      float g[S];
#pragma unroll
      for (int r = 0; r < S; ++r) g[r] = 0.0f;
      float inv_m = 0.0f;
      if (live) {
        const int gs = __ldg(gslot + i);
        const int seed = __ldg(node_seed + node);
        if (gs >= 0) {
          load_states<S>(slots + (static_cast<size_t>(gs) * ns + site) * S, g);
        } else if (seed >= 0) {
          load_states<S>(seeds + (static_cast<size_t>(seed) * ns + site) * S, g);
        }
        // 2^{-r_n}: the children's exponent counts minus the node's
        float esum = 0.0f;
        for (int c = 0; c < cnt; ++c) {
          const int child = __ldg(children + i * cmax + c);
          if (child >= n_leaves) {
            esum += es[static_cast<size_t>(child - n_leaves) * ns + site];
          }
        }
        inv_m = exp2_int(esum - es[static_cast<size_t>(node - n_leaves) * ns + site]);
      }
      int c0 = 0;
      do {
        pruning::cp_async_wait_one();  // this step's P has landed (this thread's part)
        __syncthreads();               // ... and every other thread's
        ring.next();                  // into the stage the last step read
        if (prev_i >= 0) flush((step - 1) & 1);
        const float* p_now =
            p_stage + static_cast<size_t>(step % pruning::kPStages) * cs * S * S;
        const int c1 = min(c0 + cs, cnt);
        // children [c0, c1), P from the stage or through L1: one body
        // compiled for each, chosen once per step
        auto group = [&](auto staged_tag) {
          constexpr bool kStaged = decltype(staged_tag)::value;
          for (int c = c0; c < c1; ++c) {
            const int child = __ldg(children + i * cmax + c);
            float sib[S];
#pragma unroll
            for (int r = 0; r < S; ++r) sib[r] = 1.0f;
            if (live) {
              for (int c2 = 0; c2 < cnt; ++c2) {
                if (c2 == c) continue;
                const int other = __ldg(children + i * cmax + c2);
                float xo[S];
                if (other < n_leaves) {
                  load_states<S>(leaves + (static_cast<size_t>(lrow0 + other) * ns + site) * S, xo);
                } else {
                  load_states<S>(xs + (static_cast<size_t>(other - n_leaves) * ns + site) * S, xo);
                }
                if constexpr (kStaged) {
                  pruning::times_child<S, true>(p_now + c2 * S * S, xo, sib);
                } else {
                  pruning::times_child<S, false>(pb + other * p_node_stride, xo, sib);
                }
              }
            }
            float gyc[S];
#pragma unroll
            for (int r = 0; r < S; ++r) gyc[r] = g[r] * sib[r] * inv_m;
            float x[S];
#pragma unroll
            for (int r = 0; r < S; ++r) x[r] = 0.0f;
            if (live) {
              if (child < n_leaves) {
                load_states<S>(leaves + (static_cast<size_t>(lrow0 + child) * ns + site) * S, x);
              } else {
                load_states<S>(xs + (static_cast<size_t>(child - n_leaves) * ns + site) * S, x);
              }
            }
            float* pc = part + ((static_cast<size_t>(step & 1) * warps + warp) * cs +
                                (c - c0)) * S * S;
            if constexpr (S == 4) {
              float prod[S * S];
#pragma unroll
              for (int a = 0; a < S; ++a) {
#pragma unroll
                for (int j = 0; j < S; ++j) prod[a * S + j] = gyc[a] * x[j];
              }
              const float sum = pruning::warp_scatter16(prod);
              if ((lane & 1) == 0) pc[lane >> 1] = sum;
            } else {
              pruning::warp_dp_blocked<S>(gyc, x, wstage + warp * 2 * 32 * S, pc);
            }
            if (!live) continue;
            if (child < n_leaves && dls == nullptr) continue;
            float gc[S];  // the child's outside vector P_c^T gy_c
            if constexpr (kStaged) {
              pruning::transpose_apply_shared<S>(p_now + c * S * S, gyc, gc);
            } else {
              pruning::transpose_apply<S>(pb + child * p_node_stride, gyc, gc);
            }
            const int seed = __ldg(node_seed + child);
            if (seed >= 0) {  // a seed below another seed: the two add up
              float gsd[S];
              load_states<S>(seeds + (static_cast<size_t>(seed) * ns + site) * S, gsd);
#pragma unroll
              for (int r = 0; r < S; ++r) gc[r] += gsd[r];
            }
            if (child >= n_leaves) {
              const int slot = __ldg(cslot + i * cmax + c);
              store_states<S>(slots + (static_cast<size_t>(slot) * ns + site) * S, gc);
            } else {
              store_states<S>(dls + (static_cast<size_t>(child) * ns + site) * S, gc);
            }
          }
        };
        if (staged_visit) {
          group(std::true_type{});
        } else {
          group(std::false_type{});
        }
        prev_i = i;
        prev_c0 = c0;
        prev_n = c1 - c0;
        prev_first = tile == blockIdx.x;
        ++step;
        c0 += cs;
      } while (c0 < cnt);
    }
  }
  __syncthreads();
  if (prev_i >= 0) flush((step - 1) & 1);
}

// The classic reverse at S = 64: B3's wide layout (pruning_common.cuh's
// wide_*: kWideLanes lanes a column, kWideTile columns a block of 256
// threads, P rows p_row apart, each child's dP summed over the block from
// the shared gy and x tiles, one 4 x 4 sub-block a thread) with B7's
// contract: several seeds, the block's tiles walked in turn into its own dP
// row, and a visit of more than `stage_children` children read through L1
// in groups. Same arguments and outputs as classic_reverse_walk_kernel.
template <int S>
__global__ void __launch_bounds__(kMaxTile)
classic_reverse_wide_kernel(const float* __restrict__ p,       // (B, n_nodes, K, S, S)
                            const float* __restrict__ leaves,  // (B?, n_leaves, sites, S): leaf_rows
                            const int* __restrict__ rnode,     // (n_int,) pre-order
                            const int* __restrict__ gslot,     // (n_int,)
                            const int* __restrict__ children,  // (n_int, cmax)
                            const int* __restrict__ cslot,     // (n_int, cmax)
                            const int* __restrict__ counts,    // (n_int,)
                            const int* __restrict__ node_seed, // (n_nodes,)
                            const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                            const float* __restrict__ res_e,   // (B, K, n_inner, sites)
                            const float* __restrict__ gseeds,  // (B, K, n_seed, sites, S)
                            float* __restrict__ g_slots,       // (B, K, n_gslots, sites, S)
                            float* __restrict__ dp_rows,       // (B, K, rows, n_nodes, S, S)
                            float* __restrict__ dleaf,         // (B, K, n_leaves, sites, S) or null
                            int K, int n_nodes, int n_leaves, int n_int,
                            int cmax, int sites, int n_seed, int n_gslots,
                            int stage_children, int leaf_rows) {
  constexpr int kL = pruning::kWideLanes;
  constexpr int kRows = S / kL;              // rows of g and gy a lane keeps
  constexpr int kSub = S / 4;                // 4 x 4 dP sub-blocks a side
  constexpr int kTile = pruning::kWideTile;  // columns a block
  constexpr int LD = pruning::p_row<S>();    // floats between staged rows
  constexpr int kBlock = S * LD;             // floats of a staged P block
  static_assert(S % 16 == 0 && kTile * kL == kSub * kSub && kSub * kSub <= kMaxTile,
                "16-byte vectors of a lane's quarter row, one sub-block a thread");
  const int cs = stage_children;
  extern __shared__ float4 smem_vec[];
  float* p_stage = reinterpret_cast<float*>(smem_vec);  // (kPStages, cs, S, LD)
  float* gy_t = p_stage + pruning::kPStages * cs * kBlock;  // (kTile, LD)
  float* x_t = gy_t + kTile * LD;                           // (kTile, LD)
  const int h = threadIdx.x % kL;
  const int col = threadIdx.x / kL;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int lrow0 = b * leaf_rows;  // b's first leaf row (0: shared)
  const size_t bk = static_cast<size_t>(b) * K + k;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t ns = static_cast<size_t>(sites);
  const float* __restrict__ xs = res_x + bk * n_inner * ns * S;
  const float* __restrict__ es = res_e + bk * n_inner * ns;
  const float* __restrict__ seeds = gseeds + bk * n_seed * ns * S;
  float* __restrict__ slots = g_slots + bk * n_gslots * ns * S;
  float* __restrict__ dls =
      dleaf == nullptr ? nullptr : dleaf + bk * n_leaves * ns * S;
  float* __restrict__ row =
      dp_rows + (bk * gridDim.x + blockIdx.x) * n_nodes * S * S;
  const float* __restrict__ pb =
      p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  const int n_tiles = (sites + kTile - 1) / kTile;

  StepRing<S> ring{p_stage, pb, p_node_stride, counts, children, cmax,
                   n_int, n_tiles, cs, static_cast<int>(blockIdx.x), 0, 0, 0};
  ring.next();
  ring.next();

  int step = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int site = tile * kTile + col;
    const bool live = site < sites;
    const bool first = tile == blockIdx.x;  // the block's first tile stores its row
    // a node's partials row at this column: a leaf's or its residual
    auto row_of = [&](int node) {
      return node < n_leaves
                 ? leaves + (static_cast<size_t>(lrow0 + node) * ns + site) * S
                 : xs + (static_cast<size_t>(node - n_leaves) * ns + site) * S;
    };
    for (int i = 0; i < n_int; ++i) {
      const int node = __ldg(rnode + i);
      const int cnt = __ldg(counts + i);
      float g[kRows];  // rows 4 r + h of the node's outside vector
#pragma unroll
      for (int r = 0; r < kRows; ++r) g[r] = 0.0f;
      float inv_m = 0.0f;
      if (live) {
        const int gs = __ldg(gslot + i);
        const int seed = __ldg(node_seed + node);
        if (gs >= 0) {
          pruning::wide_load_rows<S>(slots + (static_cast<size_t>(gs) * ns + site) * S, h, g);
        } else if (seed >= 0) {
          pruning::wide_load_rows<S>(seeds + (static_cast<size_t>(seed) * ns + site) * S, h, g);
        }
        inv_m = pruning::visit_inv_m(children + i * cmax, cnt, node, n_leaves, es, ns, site);
      }
      int c0 = 0;
      do {
        pruning::cp_async_wait_one();  // this step's P has landed (this thread's part)
        __syncthreads();               // ... and every other thread's
        ring.next();                  // into the stage the last step read
        const float* p_now =
            p_stage + static_cast<size_t>(step % pruning::kPStages) * cs * kBlock;
        const int c1 = min(c0 + cs, cnt);
        // children [c0, c1), P from the stage or through L1: one body
        // compiled for each, chosen once per step
        auto group = [&](auto staged_tag) {
          constexpr bool kStaged = decltype(staged_tag)::value;
          const auto p_of = [&](int c) {
            return kStaged ? p_now + c * kBlock
                           : pb + __ldg(children + i * cmax + c) * p_node_stride;
          };
          const auto x_of = [&](int c) { return row_of(__ldg(children + i * cmax + c)); };
          for (int c = c0; c < c1; ++c) {
            const int child = __ldg(children + i * cmax + c);
            const int seed = __ldg(node_seed + child);
            float* out = nullptr;  // the child's outside vector: its slot, or dleaf
            if (live && child >= n_leaves) {
              out = slots + (static_cast<size_t>(__ldg(cslot + i * cmax + c)) * ns + site) * S;
            } else if (live && dls != nullptr) {
              out = dls + (static_cast<size_t>(child) * ns + site) * S;
            }
            // a seed below another seed adds to the child's g; the block's
            // later tiles add their dP in tile order
            pruning::wide_reverse_child<S, kStaged>(
                c, cnt, p_of, x_of, live, g, inv_m, gy_t, x_t, col, h,
                row + static_cast<size_t>(child) * S * S, !first,
                seed >= 0 ? seeds + (static_cast<size_t>(seed) * ns + site) * S : nullptr,
                out);
          }
        };
        if (cnt <= cs) {
          group(std::true_type{});
        } else {
          group(std::false_type{});
        }
        ++step;
        c0 += cs;
      } while (c0 < cnt);
    }
  }
}

}  // namespace

// Launch the classic reverse walk and then the sum of its dP rows on
// `stream`; returns the first non-zero cudaGetLastError(), or the error of
// granting the shared memory (0 = ok). Device pointers to contiguous
// float32 / int32 buffers laid out as documented above; the caller
// allocates every buffer (g_slots is scratch, dp_rows is zeroed scratch
// with `rows` rows per (b, k), dleaf may be null). The schedule arrays are
// ReverseSchedule's; node_seed[n] is j where n is the j-th seed, else -1.
// `tile` is 32, 64, 128 or 256 sites a block at S = 4 and 20, 64 at S = 64
// (kWideTile); a visit of at most `stage_children` children (>= 1) is
// staged in shared memory, whose size
// (ops/cuda_pruning.py::classic_reverse_stage) must fit the SM's 227 KB.
// leaf_batch as pruning_forward_f32's (csrc/pruning_forward.cu).
extern "C" int pruning_classic_reverse_f32(
    const void* p, const void* leaves, const void* rnode, const void* gslot,
    const void* children, const void* cslot, const void* counts,
    const void* node_seed, const void* res_x, const void* res_e,
    const void* gseeds, void* g_slots, void* dp_rows, void* dp, void* dleaf,
    int B, int K, int S, int n_nodes, int n_leaves, int n_int, int cmax,
    int sites, int n_seed, int n_gslots, int rows, int tile,
    int stage_children, void* stream, long long leaf_batch) {
  const int leaf_rows = pruning::leaf_rows_of(leaf_batch, B, sites, S);
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || n_seed <= 0 ||
      n_gslots <= 0 || rows <= 0 || tile < 32 || tile > kMaxTile ||
      tile % 32 != 0 || stage_children <= 0 || leaf_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows, K, B);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    const auto launch = [&](auto walk, int threads, size_t smem) {
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
      }
      walk<<<grid, threads, smem, st>>>(
          static_cast<const float*>(p), static_cast<const float*>(leaves),
          static_cast<const int*>(rnode), static_cast<const int*>(gslot),
          static_cast<const int*>(children), static_cast<const int*>(cslot),
          static_cast<const int*>(counts), static_cast<const int*>(node_seed),
          static_cast<const float*>(res_x), static_cast<const float*>(res_e),
          static_cast<const float*>(gseeds), static_cast<float*>(g_slots),
          static_cast<float*>(dp_rows), static_cast<float*>(dleaf), K,
          n_nodes, n_leaves, n_int, cmax, sites, n_seed, n_gslots,
          stage_children, leaf_rows);
      return cudaGetLastError();
    };
    cudaError_t err;
    if constexpr (kS == 64) {
      if (tile != pruning::kWideTile) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch(classic_reverse_wide_kernel<kS>, tile * pruning::kWideLanes,
                   pruning::wide_smem_floats<kS>(stage_children, tile) * sizeof(float));
    } else {
      const size_t warps = tile / 32;
      size_t floats = (pruning::kPStages + 2 * warps) * stage_children * kS * kS;
      if (kS != 4) floats += warps * 2 * 32 * kS;
      err = launch(classic_reverse_walk_kernel<kS>, tile, floats * sizeof(float));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // every row of the root is zero (the caller zeroes dp_rows)
    return pruning::launch_dp_rows<kS>(static_cast<const float*>(dp_rows),
                                       static_cast<float*>(dp), B, K, n_nodes,
                                       rows, -1, st);
  });
}
