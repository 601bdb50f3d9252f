// Reverse (gradient) walk of Felsenstein pruning for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_bwd2_kernel, the
// deferred-edge reverse, for a whole tree seeded at the root. It computes what
// that kernel computes, not a copy of its VMEM tiling, identity row or grouped
// walk. Given the residuals of pruning_saveall_f32 (every internal node's
// rescaled partials x_n and exponent count e_n) and the root cotangent
// lambda = ct / (pi . x_root), for every internal node n in pre-order:
//     g_n  = seed = lambda * pi           at the root,
//     y_c  = P_c x_c                      recomputed for each child c,
//     gy_c = g_n * prod_{c' != c} y_c' * 2^{-r_n},
//     g_c  = P_c^T gy_c                   the child's outside vector,
//     dP_c = sum_sites gy_c x_c^T,
// where r_n = e_n - sum_c e_c is the node's own rescale exponent, so
// 2^{-r_n} is an exact power of two assembled from float bits (exp2_int in
// ops/pruning.py). The rescale divisors are constants of the backward, which
// is exact because logL does not depend on them. A leaf's g is its partials'
// cotangent (dleaf), written when asked.
//
// What bounded the first version on an H100: it stored gy for every
// child, leaves included, in a (B, K, n_nodes, sites, S) array and read it
// back with x in a second kernel for dP: ~2 GB moved at the flagship's
// B = 64, at ~75% of the HBM rate, so only fewer bytes could help. At 20
// states every contraction read its 400 P values one at a time through L1
// (17.3 ms against a 1.03 ms operations bound at 512 taxa x 8192 LG
// patterns). At B = 1 its 256-site blocks used 16 of the 132 SMs.
//
// Design.
// - One thread per (site, k, b) column walks the reverse of the DFS
//   post-order (ReverseSchedule in ops/cuda_pruning.py). Internal nodes'
//   outside vectors g live in g slots, (B, K, n_gslots, sites, S), from the
//   parent's visit to the node's own: O(depth x cmax) slots, not n_nodes.
// - Every thread of a block visits the same nodes, so the block stages
//   each visit's children's P blocks in shared memory two visits ahead, in
//   a 3-stage cp.async ring (one barrier per visit), and reads them as
//   16-byte broadcast vectors (times_child<S, true>,
//   transpose_apply_shared): one load per four FMAs. Every fmaf chain keeps
//   its j order, so gy, g and dleaf keep their bits (B7's dleaf equals this
//   kernel's).
// - dP is summed inside the walk and no gy is stored. While gy_c and x_c
//   are in registers, each entry's sum over a warp's 32 sites is formed in
//   a fixed order: at S = 4 each thread forms its 16 products and a
//   reduce-scatter of shuffles (16, not 80) leaves each entry in a lane
//   pair; at S = 20 (400 products would not fit in registers) the warp puts
//   its 32 rows of gy_c and x_c in its own stretch of shared memory and lane
//   l < 25 sums the 4 x 4 sub-block l over them, two 16-byte loads per 16
//   FMAs, with only __syncwarp. The warps' sums are added in warp order at
//   the next visit's barrier, and one plain store puts each entry in the
//   block's own row of dp_rows, (B, K, tiles, n_nodes, S, S).
//   pruning_common.cuh's dp_rows_kernel (B7's too) then sums the rows in
//   tile order with a compensated add. No atomics and no read-modify-write: two launches on
//   the same inputs give bit-identical dP.
// - Blocks are 256 sites wide (reverse_tile in ops/cuda_pruning.py:
//   narrower only where a node's children would not fit the stage): the
//   widest was the fastest at every measured shape, and at B = 1 every
//   width took the same device time.
//
// What bounds it now: at S = 4, bytes and latency (the residuals and
// leaves once, the siblings' rows once more, the g slots in L2, the dP
// rows: S / tile of a gy store); at S = 20, operations (per child and column
// 2 S^2 flops each for y, P^T gy and dP) on ~8 warps an SM at 512 taxa x
// 8192 patterns. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (kernel_turns.py, PERF.md section 6): 0.505 ms at the flagship's
// B = 64, 20% of its bytes bound (0.793 ms, 13%, before); 4.89 ms at 512
// taxa x 8192 LG patterns, 21% of its operations bound (17.8 ms, 6%). At
// B = 1 it is slower than before (160 against 114 us of device time): 63
// dependent visits, each now with a barrier and a shuffle chain.
//
// At S = 64 (codon's 61 or 60 states padded with zero states by
// ops/cuda_pruning.py) one thread's rows of g, sib, gy, x and P^T gy would
// take ~5 x 64 registers, and a warp's 64 x 64 dP entries fit neither
// registers nor the warp-private layout of S = 20. So
// pruning_reverse_wide_kernel splits a column over kWideLanes = 4 lanes
// and sums dP over the whole block (pruning_common.cuh's wide_* helpers,
// which B7's 64-state kernel shares):
// - lane h keeps g, the siblings' product and gy for rows 4 r + h
//   (r < 16), y = P x of a sibling formed row by row with the sibling's
//   row read from device memory as 16-byte vectors, each row's fmaf chain
//   in j order (times_child's);
// - P is staged as in the narrow kernel, two visits ahead in a 3-stage
//   cp.async ring, but with rows p_row = 68 floats apart, so that the
//   four lanes' rows 4 r + h fall in four different bank quads (as in B1,
//   B2 and B5 at 64 states);
// - per child the block puts its 64 columns' gy and x rows in two shared
//   tiles (rows 68 floats apart) and, after a barrier, thread t sums the
//   4 x 4 sub-block (t / 16, t % 16) of gy x^T over the tile's columns in
//   column order (two 16-byte loads per 16 FMAs) and stores it in the
//   block's dP row: the same rows and the same compensated row sum as
//   S = 4 and 20, so dP is bit-identical across launches;
// - lane h forms entries [16 h, 16 h + 16) of the child's P^T gy from the
//   gy tile, each an fmaf chain in j order (transpose_apply_shared's);
// - 64 columns a block, 256 threads; the ring holds at most 3 children a
//   visit (cmax <= 3 in 227 KB: ops/cuda_pruning.py::reverse_tile).
// The entry point is compiled for S = 4, 20 and 64 and refuses any other.

#include "pruning_common.cuh"

namespace {

using pruning::exp2_int;
using pruning::load_states;
using pruning::store_states;

constexpr int kMaxTile = 256;   // sites per block, one per thread (the widest)

template <int S>
__global__ void __launch_bounds__(kMaxTile)
pruning_reverse_walk_kernel(const float* __restrict__ p,       // (B, n_nodes, K, S, S)
                            const float* __restrict__ leaves,  // (n_leaves, sites, S)
                            const int* __restrict__ rnode,     // (n_int,) pre-order
                            const int* __restrict__ gslot,     // (n_int,)
                            const int* __restrict__ children,  // (n_int, cmax)
                            const int* __restrict__ cslot,     // (n_int, cmax)
                            const int* __restrict__ counts,    // (n_int,)
                            const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                            const float* __restrict__ res_e,   // (B, K, n_inner, sites)
                            const float* __restrict__ lam,     // (B, K, sites)
                            const float* __restrict__ freqs,   // (S,)
                            float* __restrict__ g_slots,       // (B, K, n_gslots, sites, S)
                            float* __restrict__ dp_rows,       // (B, K, rows, n_nodes, S, S)
                            float* __restrict__ dleaf,         // (B, K, n_leaves, sites, S) or null
                            int K, int n_nodes, int n_leaves, int n_int,
                            int cmax, int sites, int n_gslots) {
  constexpr int kBlockVecs = S * S / 4;
  extern __shared__ float4 smem_vec[];
  const int warps = blockDim.x >> 5;
  // the P ring (kPStages, cmax, S, S), the warps' dP sums of the last two
  // visits (2, warps, cmax, S * S) and, at S = 20, each warp's gy and x
  // rows (warps, 2, 32, S)
  float* p_stage = reinterpret_cast<float*>(smem_vec);
  float* part = p_stage + pruning::kPStages * cmax * S * S;
  float* wstage = part + 2 * warps * cmax * S * S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = site < sites;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * K + k;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t ns = static_cast<size_t>(sites);
  const float* __restrict__ xs = res_x + bk * n_inner * ns * S;
  const float* __restrict__ es = res_e + bk * n_inner * ns;
  float* __restrict__ slots = g_slots + bk * n_gslots * ns * S;
  float* __restrict__ dls =
      dleaf == nullptr ? nullptr : dleaf + bk * n_leaves * ns * S;
  float* __restrict__ rows =
      dp_rows + (bk * gridDim.x + blockIdx.x) * n_nodes * S * S;
  const float* __restrict__ pb =
      p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;

  // visit i's children's P blocks -> its stage (all threads share)
  auto stage = [&](int i) {
    if (i >= n_int) return;
    const int cnt = __ldg(counts + i);
    float* dst = p_stage + static_cast<size_t>(i % pruning::kPStages) * cmax * S * S;
    for (int v = threadIdx.x; v < cnt * kBlockVecs; v += blockDim.x) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;
      const int child = __ldg(children + i * cmax + c);
      pruning::cp_async16(dst + c * S * S + 4 * q,
                          pb + child * p_node_stride + 4 * q);
    }
  };
  // visit i's dP sums: the warps' partial sums, added in warp order, into
  // the block's row (one plain store per entry; the block owns its row)
  auto flush = [&](int i) {
    const int cnt = __ldg(counts + i);
    const float* src = part + static_cast<size_t>(i & 1) * warps * cmax * S * S;
    for (int e = threadIdx.x; e < cnt * S * S; e += blockDim.x) {
      float total = 0.0f;
      for (int w = 0; w < warps; ++w) total += src[w * cmax * S * S + e];
      const int c = e / (S * S);
      const int child = __ldg(children + i * cmax + c);
      rows[static_cast<size_t>(child) * S * S + (e - c * S * S)] = total;
    }
  };
  stage(0);
  pruning::cp_async_commit();
  stage(1);
  pruning::cp_async_commit();

  for (int i = 0; i < n_int; ++i) {
    pruning::cp_async_wait_one();  // visit i's P has landed (this thread's part)
    __syncthreads();               // ... and every other thread's
    stage(i + 2);                  // into the stage visit i - 1 read
    pruning::cp_async_commit();
    if (i > 0) flush(i - 1);
    const float* p_now =
        p_stage + static_cast<size_t>(i % pruning::kPStages) * cmax * S * S;
    const int node = __ldg(rnode + i);
    const int cnt = __ldg(counts + i);
    float g[S];
#pragma unroll
    for (int r = 0; r < S; ++r) g[r] = 0.0f;
    float inv_m = 0.0f;
    if (live) {
      const int gs = __ldg(gslot + i);
      if (gs < 0) {  // the root: g = seed = lambda pi
        const float l = lam[bk * ns + site];
#pragma unroll
        for (int r = 0; r < S; ++r) g[r] = l * __ldg(freqs + r);
      } else {
        load_states<S>(slots + (static_cast<size_t>(gs) * ns + site) * S, g);
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
    for (int c = 0; c < cnt; ++c) {
      const int child = __ldg(children + i * cmax + c);
      float sib[S];
#pragma unroll
      for (int r = 0; r < S; ++r) sib[r] = 1.0f;
      if (live) {
        for (int c2 = 0; c2 < cnt; ++c2) {
          if (c2 == c) continue;
          const int other = __ldg(children + i * cmax + c2);
          float x[S];
          if (other < n_leaves) {
            load_states<S>(leaves + (static_cast<size_t>(other) * ns + site) * S, x);
          } else {
            load_states<S>(xs + (static_cast<size_t>(other - n_leaves) * ns + site) * S, x);
          }
          pruning::times_child<S, true>(p_now + c2 * S * S, x, sib);
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
          load_states<S>(leaves + (static_cast<size_t>(child) * ns + site) * S, x);
        } else {
          load_states<S>(xs + (static_cast<size_t>(child - n_leaves) * ns + site) * S, x);
        }
      }
      float* pc =
          part + ((static_cast<size_t>(i & 1) * warps + warp) * cmax + c) * S * S;
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
      if (child >= n_leaves || dls != nullptr) {
        float gc[S];  // the child's outside vector P_c^T gy_c
        pruning::transpose_apply_shared<S>(p_now + c * S * S, gyc, gc);
        if (child >= n_leaves) {
          const int cs = __ldg(cslot + i * cmax + c);
          store_states<S>(slots + (static_cast<size_t>(cs) * ns + site) * S, gc);
        } else {
          store_states<S>(dls + (static_cast<size_t>(child) * ns + site) * S, gc);
        }
      }
    }
  }
  __syncthreads();
  flush(n_int - 1);
}

// The deferred reverse at S = 64 (see the header; the layout and its
// helpers are pruning_common.cuh's wide_*): kWideLanes lanes a column,
// kWideTile columns a block of 256 threads, one tile a block; same
// arguments and outputs as pruning_reverse_walk_kernel. Each child is
// wide_reverse_child, the body B7's 64-state kernel shares.
template <int S>
__global__ void __launch_bounds__(kMaxTile)
pruning_reverse_wide_kernel(const float* __restrict__ p,       // (B, n_nodes, K, S, S)
                            const float* __restrict__ leaves,  // (n_leaves, sites, S)
                            const int* __restrict__ rnode,     // (n_int,) pre-order
                            const int* __restrict__ gslot,     // (n_int,)
                            const int* __restrict__ children,  // (n_int, cmax)
                            const int* __restrict__ cslot,     // (n_int, cmax)
                            const int* __restrict__ counts,    // (n_int,)
                            const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                            const float* __restrict__ res_e,   // (B, K, n_inner, sites)
                            const float* __restrict__ lam,     // (B, K, sites)
                            const float* __restrict__ freqs,   // (S,)
                            float* __restrict__ g_slots,       // (B, K, n_gslots, sites, S)
                            float* __restrict__ dp_rows,       // (B, K, rows, n_nodes, S, S)
                            float* __restrict__ dleaf,         // (B, K, n_leaves, sites, S) or null
                            int K, int n_nodes, int n_leaves, int n_int,
                            int cmax, int sites, int n_gslots) {
  constexpr int kL = pruning::kWideLanes;
  constexpr int kRows = S / kL;        // rows of g a lane keeps
  constexpr int kSub = S / 4;          // 4 x 4 dP sub-blocks a side
  constexpr int kTile = pruning::kWideTile;  // columns a block
  constexpr int LD = pruning::p_row<S>();   // floats between staged rows
  static_assert(S % 16 == 0 && kTile * kL == kSub * kSub && kSub * kSub <= kMaxTile,
                "16-byte vectors of a lane's quarter row, one sub-block a thread");
  extern __shared__ float4 smem_vec[];
  float* p_stage = reinterpret_cast<float*>(smem_vec);       // (kPStages, cmax, S, LD)
  float* gy_t = p_stage + pruning::kPStages * cmax * S * LD;  // (kTile, LD)
  float* x_t = gy_t + kTile * LD;                             // (kTile, LD)
  const int h = threadIdx.x % kL;
  const int col = threadIdx.x / kL;
  const int site = blockIdx.x * kTile + col;
  const bool live = site < sites;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * K + k;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t ns = static_cast<size_t>(sites);
  const float* __restrict__ xs = res_x + bk * n_inner * ns * S;
  const float* __restrict__ es = res_e + bk * n_inner * ns;
  float* __restrict__ slots = g_slots + bk * n_gslots * ns * S;
  float* __restrict__ dls =
      dleaf == nullptr ? nullptr : dleaf + bk * n_leaves * ns * S;
  float* __restrict__ rows =
      dp_rows + (bk * gridDim.x + blockIdx.x) * n_nodes * S * S;
  const float* __restrict__ pb =
      p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  // a node's partials row at this column: a leaf's or its residual
  auto row_of = [&](int node) {
    return node < n_leaves
               ? leaves + (static_cast<size_t>(node) * ns + site) * S
               : xs + (static_cast<size_t>(node - n_leaves) * ns + site) * S;
  };

  // visit i's children's P blocks -> its stage, rows LD floats apart
  auto stage = [&](int i) {
    if (i >= n_int) return;
    const int cnt = __ldg(counts + i);
    float* dst = p_stage + static_cast<size_t>(i % pruning::kPStages) * cmax * S * LD;
    for (int v = threadIdx.x; v < cnt * S * kSub; v += blockDim.x) {
      const int c = v / (S * kSub);
      const int q = v - c * S * kSub;
      const int child = __ldg(children + i * cmax + c);
      pruning::cp_async16(dst + c * S * LD + pruning::p_stage_offset<S>(q),
                          pb + child * p_node_stride + 4 * q);
    }
  };
  stage(0);
  pruning::cp_async_commit();
  stage(1);
  pruning::cp_async_commit();

  for (int i = 0; i < n_int; ++i) {
    pruning::cp_async_wait_one();  // visit i's P has landed (this thread's part)
    __syncthreads();               // ... and every other thread's
    stage(i + 2);                  // into the stage visit i - 1 read
    pruning::cp_async_commit();
    const float* p_now =
        p_stage + static_cast<size_t>(i % pruning::kPStages) * cmax * S * LD;
    const int node = __ldg(rnode + i);
    const int cnt = __ldg(counts + i);
    float g[kRows];  // rows 4 r + h of the node's outside vector
#pragma unroll
    for (int r = 0; r < kRows; ++r) g[r] = 0.0f;
    float inv_m = 0.0f;
    if (live) {
      const int gs = __ldg(gslot + i);
      if (gs < 0) {  // the root: g = seed = lambda pi
        const float l = lam[bk * ns + site];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          g[r] = l * __ldg(freqs + pruning::lane_row<S, kL>(h, r));
        }
      } else {
        pruning::wide_load_rows<S>(slots + (static_cast<size_t>(gs) * ns + site) * S, h, g);
      }
      inv_m = pruning::visit_inv_m(children + i * cmax, cnt, node, n_leaves, es, ns, site);
    }
    const auto p_of = [&](int c) { return p_now + c * S * LD; };
    const auto x_of = [&](int c) { return row_of(__ldg(children + i * cmax + c)); };
    for (int c = 0; c < cnt; ++c) {
      const int child = __ldg(children + i * cmax + c);
      float* out = nullptr;  // the child's outside vector: its slot, or dleaf
      if (live && child >= n_leaves) {
        out = slots + (static_cast<size_t>(__ldg(cslot + i * cmax + c)) * ns + site) * S;
      } else if (live && dls != nullptr) {
        out = dls + (static_cast<size_t>(child) * ns + site) * S;
      }
      pruning::wide_reverse_child<S, true>(c, cnt, p_of, x_of, live, g, inv_m, gy_t, x_t,
                                           col, h, rows + static_cast<size_t>(child) * S * S,
                                           false, nullptr, out);
    }
  }
}

}  // namespace

// Launch the reverse walk and then the sum of its dP rows on `stream`;
// returns the first non-zero cudaGetLastError() (0 = ok). Device pointers to
// contiguous float32 / int32 buffers laid out as documented above; the
// caller allocates every buffer: g_slots and dp_rows (one row per block of
// `tile` sites, ceil(sites / tile) per (b, k)) are scratch, dleaf may be
// null. The schedule arrays are ReverseSchedule's (ops/cuda_pruning.py);
// `root` is rnode[0]. `tile` is 32, 64, 128 or 256, and the block's shared
// memory (ops/cuda_pruning.py::_reverse_smem_bytes) must fit the SM's
// 227 KB. At S = 64 `tile` must be 64 (pruning_reverse_wide_kernel's
// columns a block; 256 threads).
extern "C" int pruning_reverse_f32(const void* p, const void* leaves,
                                   const void* rnode, const void* gslot,
                                   const void* children, const void* cslot,
                                   const void* counts, const void* res_x,
                                   const void* res_e, const void* lam,
                                   const void* freqs, void* g_slots,
                                   void* dp_rows, void* dp, void* dleaf,
                                   int B, int K, int S, int n_nodes,
                                   int n_leaves, int n_int, int cmax,
                                   int sites, int n_gslots, int tile,
                                   int root, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || n_gslots <= 0 ||
      tile < 32 || tile > kMaxTile || tile % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (sites + tile - 1) / tile;
  const dim3 grid(tiles, K, B);
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
          static_cast<const int*>(counts), static_cast<const float*>(res_x),
          static_cast<const float*>(res_e), static_cast<const float*>(lam),
          static_cast<const float*>(freqs), static_cast<float*>(g_slots),
          static_cast<float*>(dp_rows), static_cast<float*>(dleaf), K,
          n_nodes, n_leaves, n_int, cmax, sites, n_gslots);
      return cudaGetLastError();
    };
    cudaError_t err;
    if constexpr (kS == 64) {
      if (tile != pruning::kWideTile) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch(pruning_reverse_wide_kernel<kS>, tile * pruning::kWideLanes,
                   pruning::wide_smem_floats<kS>(cmax, tile) * sizeof(float));
    } else {
      const size_t warps = tile / 32;
      size_t floats = (pruning::kPStages + 2 * warps) * cmax * kS * kS;
      if (kS != 4) floats += warps * 2 * 32 * kS;
      err = launch(pruning_reverse_walk_kernel<kS>, tile,
                   floats * sizeof(float));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return pruning::launch_dp_rows<kS>(static_cast<const float*>(dp_rows),
                                       static_cast<float*>(dp), B, K, n_nodes,
                                       tiles, root, st);
  });
}
