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
// pruning_common.cuh's wide_* helpers): a block of 256 threads over a tile
// of 64 columns, each contraction one tiled product (4 x 4 micro-tiles),
// a step's P blocks and x tiles staged one step ahead in a ring of two
// stages, a staged visit B3's own code (wide_reverse_visit), which adds
// its dP into the block's row (the first tile stores). B7's contract
// stays: several seeds, one dP row a block over every gridDim.x-th tile,
// and a visit of more children than the stage holds (at most 3 in 227 KB,
// ops/cuda_pruning.py::classic_reverse_stage) read through L1 in groups:
// there each child's gy takes its siblings' y again, P and x through L1,
// the same micro-tiles. With one seed at the root its dleaf is B3's bit
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
// 48 sibling contractions a load per FMA. At 64 states (kernel_turns.py
// --states 64, in turns against the first 64-state design, same card):
// 3.781 ms at 100 taxa x 4096 codon sites (6.001 before; 24% of its
// operations bound) and 20.35 ms at 1000 taxa x 2048 (31.00), its hot
// loops at 0.125 loads an FMA (pruning_common.cuh).

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
// apart), and commits the group. classic_reverse_walk_kernel walks it; the
// 64-state kernel keeps its own cursor, which stages x tiles as well.
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

// The classic reverse at S = 64: B3's tiled layout (pruning_common.cuh's
// wide_*: a block of 256 threads over a tile of kWideTile columns, 4 x 4
// micro-tiles, P and x rows 68 floats apart) with B7's contract: several
// seeds, the block's tiles walked in turn into its own dP row, and a
// visit of more than `stage_children` children read through L1 in groups.
// A step's P blocks and x tiles are staged one step ahead in a ring of two
// stages; a staged visit is wide_reverse_visit, B3's body. Same arguments
// and outputs as classic_reverse_walk_kernel.
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
  constexpr int kTile = pruning::kWideTile;  // columns a block
  constexpr int LD = pruning::p_row<S>();    // floats between staged rows
  constexpr int kTileF = pruning::wide_tile_floats<S>();
  constexpr int kRowVecs = S / 4;
  static_assert(S == kTile, "a 16 x 16 grid of 4 x 4 micro-tiles");
  const int cs = stage_children;
  extern __shared__ float4 smem_vec[];
  float* ring = reinterpret_cast<float*>(smem_vec);  // (2, 2 cs, tile): P, then x
  float* gy_tiles = ring + 2 * 2 * cs * kTileF;       // (n_gy, tile)
  const int n_gy = pruning::wide_gy_tiles(cs);
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
  // a node's partials row at site s0: a leaf's or its residual
  auto row_of = [&](int node, int s0) {
    return node < n_leaves
               ? leaves + (static_cast<size_t>(lrow0 + node) * ns + s0) * S
               : xs + (static_cast<size_t>(node - n_leaves) * ns + s0) * S;
  };

  // The steps of the block's walk, in walk order, tile after tile (every
  // gridDim.x-th tile from its own): visit si's children [sc, sc + cs)
  // (one step for a visit of none). next() copies the next step not yet
  // staged, at (st, si, sc), into ring stage `staged` % 2 when its visit
  // is staged (count <= cs: the whole visit's P blocks, then its x tiles,
  // zeros past the sites), and commits the group.
  int st = blockIdx.x, si = 0, sc = 0, staged = 0;
  auto next = [&]() {
    if (st < n_tiles) {
      const int cnt = __ldg(counts + si);
      if (cnt <= cs) {
        float* dst = ring + (staged & 1) * 2 * cs * kTileF;
        const int s0 = st * kTile;
        for (int c = 0; c < cnt; ++c) {
          const int child = __ldg(children + si * cmax + c);
          const float* ps = pb + child * p_node_stride;
          const float* xsrc = row_of(child, s0);
          for (int q = threadIdx.x; q < S * kRowVecs; q += blockDim.x) {
            pruning::cp_async16(dst + c * kTileF + pruning::p_stage_offset<S>(q), ps + 4 * q);
            const int col = q / kRowVecs;
            float* xd = dst + (cs + c) * kTileF + col * LD + 4 * (q % kRowVecs);
            if (s0 + col < sites) {
              pruning::cp_async16(xd, xsrc + col * S + 4 * (q % kRowVecs));
            } else {
              *reinterpret_cast<float4*>(xd) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
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
  };
  next();

  int step = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int site0 = tile * kTile;
    const int n_live = min(kTile, sites - site0);  // the tile's columns within the sites
    const bool first = tile == blockIdx.x;  // the block's first tile stores its row
    for (int i = 0; i < n_int; ++i) {
      const int node = __ldg(rnode + i);
      const int cnt = __ldg(counts + i);
      const int gs = __ldg(gslot + i);
      const int nseed = __ldg(node_seed + node);
      // the node's outside vector at (row, col): its slot or its seed, else
      // zero; and its 2^{-r_n}
      const auto gval = [&](int r, int col) -> float {
        const size_t site = site0 + col;
        return gs >= 0      ? slots[(static_cast<size_t>(gs) * ns + site) * S + r]
               : nseed >= 0 ? seeds[(static_cast<size_t>(nseed) * ns + site) * S + r]
                            : 0.0f;
      };
      int kids[pruning::kWideStaged];
#pragma unroll
      for (int c = 0; c < pruning::kWideStaged; ++c) {
        kids[c] = c < cnt ? __ldg(children + i * cmax + c) : 0;
      }
      const auto invm = [&](const int (&cl)[4], float (&out)[4]) {
        pruning::wide_inv_m(kids, cnt, node, n_leaves, es, ns, site0, cl, n_live, out);
      };
      const auto dst_of = [&](int c) {
        return row + static_cast<size_t>(__ldg(children + i * cmax + c)) * S * S;
      };
      // the child's outside vector: its slot, or dleaf
      const auto out_of = [&](int c, int col) -> float* {
        if (col >= n_live) return nullptr;
        const int child = __ldg(children + i * cmax + c);
        const size_t site = site0 + col;
        if (child >= n_leaves) {
          return slots + (static_cast<size_t>(__ldg(cslot + i * cmax + c)) * ns + site) * S;
        }
        return dls == nullptr ? nullptr : dls + (static_cast<size_t>(child) * ns + site) * S;
      };
      // a seed below another seed adds to the child's g
      const auto plus_of = [&](int c, int col) -> const float* {
        const int seed = __ldg(node_seed + __ldg(children + i * cmax + c));
        return seed < 0 ? nullptr
                        : seeds + (static_cast<size_t>(seed) * ns + site0 + col) * S;
      };
      // a visit wider than the stage: g and 2^{-r_n} held over its steps,
      // 4 x 4 micro-tiles over the block's 256 threads
      const int rg = pruning::wide_rg();
      const int cg = pruning::wide_cg();
      int cols[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cols[j] = cg + 16 * j;
      float g[4][4];
      float inv_m[4];
      int c0 = 0;
      do {
        pruning::cp_async_wait_all();  // this step's stage has landed (this thread's part)
        __syncthreads();               // ... and every other thread's
        next();                        // into the stage the last step read
        float* now = ring + (step & 1) * 2 * cs * kTileF;
        if (cnt <= cs) {
          pruning::wide_reverse_visit<S>(cnt, now, now + cs * kTileF, gval, invm, n_live,
                                         gy_tiles, n_gy, dst_of, !first, out_of, plus_of);
        } else {
          if (c0 == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool live = cols[j] < n_live;
              inv_m[j] = live ? pruning::visit_inv_m(children + i * cmax, cnt, node,
                                                     n_leaves, es, ns, site0 + cols[j])
                              : 0.0f;
#pragma unroll
              for (int a = 0; a < 4; ++a) g[a][j] = live ? gval(rg + 16 * a, cols[j]) : 0.0f;
            }
          }
          // children [c0, c0 + cs): P and the siblings' x through L1, each
          // child's gy from all its siblings' y in child order, its x tile
          // copied for its dP
          const int c1 = min(c0 + cs, cnt);
          for (int c = c0; c < c1; ++c) {
            float gy[4][4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int j = 0; j < 4; ++j) gy[a][j] = 1.0f;
            }
            for (int c2 = 0; c2 < cnt; ++c2) {
              if (c2 == c) continue;
              const int sib = __ldg(children + i * cmax + c2);
              const float* pr[4];
              const float* xc[4];
#pragma unroll
              for (int a = 0; a < 4; ++a) pr[a] = pb + sib * p_node_stride + (rg + 16 * a) * S;
#pragma unroll
              for (int j = 0; j < 4; ++j) {  // a dead column reads column 0's row
                xc[j] = row_of(sib, site0) + (cols[j] < n_live ? cols[j] : 0) * S;
              }
              float y[4][4];
              pruning::wide_product<S, true>(pr, xc, y);
#pragma unroll
              for (int a = 0; a < 4; ++a) {
#pragma unroll
                for (int j = 0; j < 4; ++j) gy[a][j] *= y[a][j];
              }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                gy[a][j] = cols[j] < n_live ? g[a][j] * gy[a][j] * inv_m[j] : 0.0f;
              }
            }
            const int child = __ldg(children + i * cmax + c);
            float* x_t = now + (cs + c - c0) * kTileF;
            const float* xsrc = row_of(child, site0);
            for (int v = threadIdx.x; v < kTile * kRowVecs; v += blockDim.x) {
              const int col = v / kRowVecs;
              const int q = v % kRowVecs;
              *reinterpret_cast<float4*>(x_t + col * LD + 4 * q) =
                  col < n_live ? __ldg(reinterpret_cast<const float4*>(xsrc + col * S) + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            pruning::wide_put<S>(gy_tiles, rg, cg, gy);
            __syncthreads();  // both tiles are whole
            pruning::wide_dp<S>(gy_tiles, x_t, dst_of(c), !first);
            const float* gc[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) gc[j] = gy_tiles + cols[j] * LD;
            float out[4][4];
            pruning::wide_transpose<S, true>(pb + child * p_node_stride, S, 4 * rg, gc, out);
            pruning::wide_store_out(c, 4 * rg, cols, out, out_of, plus_of);
            __syncthreads();  // the tiles are read before the next child's
          }
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
      if (tile != pruning::kWideTile || stage_children > pruning::kWideStaged) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch(classic_reverse_wide_kernel<kS>, kMaxTile,
                   pruning::wide_smem_floats<kS>(stage_children) * sizeof(float));
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
