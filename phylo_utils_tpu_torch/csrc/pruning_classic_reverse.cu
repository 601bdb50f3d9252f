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
// Design. Where pruning_reverse_f32 (the deferred reverse) stores gy for
// every node and column, (B, K, n_nodes, sites, S), and sums dP afterwards,
// this kernel takes each child's dP inside the walk and stores no gy, so
// its scratch does not grow with n_nodes x sites:
// - One thread per (site, k, b) column, 256 sites per block tile. A block
//   walks every gridDim.x-th tile of its (k, b) in turn (a grid-stride loop),
//   so the launch has a capped number of blocks whatever the site count.
// - Each node's g lives in a slot of g_slots, (B, K, n_gslots, sites, S),
//   only from its parent's visit to its own: the walk is the reverse of the
//   DFS post-order, so n_gslots is O(depth x cmax) (ReverseSchedule in
//   ops/cuda_pruning.py). A thread reads and writes only its own column.
// - dP: every thread of a block walks the same node sequence, so after each
//   child's gy the block sums gy x^T over its 256 sites: at S = 4 each
//   thread forms the 16 products, a fixed warp-shuffle tree and a fixed
//   order over the 8 warps reduce them; at S = 20 (400 entries would spill
//   from registers) the block stages gy and x in shared memory and each
//   thread sums one or two (i, j) entries over the sites in four
//   interleaved fmaf chains. Threads past the last site stay in the loop
//   for the barriers and add zeros. The block adds its tile sum into its own
//   row of dp_rows, (B, K, rows, n_nodes, S, S), in tile order; a second
//   kernel sums the rows in row order with a compensated add. There are no
//   atomics, so two launches on the same inputs give bit-identical dP.
// - gy, g and dleaf per column are the deferred kernel's arithmetic (the
//   same fmaf chains and products), so with one seed at the root both
//   reverses give the same dleaf bits and differ in dP only by the order of
//   the site sums.
// The entry point is compiled for S = 4 and S = 20 and refuses any other.
//
// What bounds it on an H100: per internal node and column it reads g, each
// child's x and exponent (the siblings' x twice), and writes each child's g
// (dleaf at leaves): the deferred walk's traffic without the gy store. At
// S = 20 operations bound it: per child and column 2 S^2 flops each for y,
// P^T gy and dP, with P read through L1 by every thread (as B1-B3) and each
// (i, j) sum a chain of 64 fmafs per tile. At S = 4 the per-child barriers
// and shuffle trees bound it. Staging P in shared memory (as
// pruning_stream_f32 does) and fewer barriers are later work.

#include "pruning_common.cuh"

namespace {

using pruning::exp2_int;
using pruning::load_states;
using pruning::store_states;
using pruning::transpose_apply;

constexpr int kTile = 256;           // sites per block tile, one per thread
constexpr int kTileWarps = kTile / 32;

// row[i * S + j] += sum over the block's 256 sites of gy[i] * x[j], in a
// fixed order. Every thread of the block calls it with its own column's
// gy and x (zeros past the last site).
template <int S>
__device__ __forceinline__ void block_dp(const float (&gy)[S],
                                         const float (&x)[S],
                                         float* __restrict__ smem,
                                         float* __restrict__ row) {
  const int t = threadIdx.x;
  if constexpr (S == 4) {
    float prod[S * S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int j = 0; j < S; ++j) prod[i * S + j] = gy[i] * x[j];
    }
#pragma unroll
    for (int e = 0; e < S * S; ++e) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        prod[e] += __shfl_down_sync(0xffffffffu, prod[e], off);
      }
    }
    if ((t & 31) == 0) {
#pragma unroll
      for (int e = 0; e < S * S; ++e) smem[(t >> 5) * S * S + e] = prod[e];
    }
    __syncthreads();
    if (t < S * S) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) total += smem[w * S * S + t];
      row[t] += total;
    }
  } else {
    static_assert(S % 4 == 0, "rows are staged as 16-byte vectors");
    float* gs = smem;
    float* xs = smem + kTile * S;
    store_states<S>(gs + t * S, gy);
    store_states<S>(xs + t * S, x);
    __syncthreads();
    for (int e = t; e < S * S; e += kTile) {
      const int i = e / S;
      const int j = e % S;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int s = 0; s < kTile; s += 4) {
        a0 = fmaf(gs[s * S + i], xs[s * S + j], a0);
        a1 = fmaf(gs[(s + 1) * S + i], xs[(s + 1) * S + j], a1);
        a2 = fmaf(gs[(s + 2) * S + i], xs[(s + 2) * S + j], a2);
        a3 = fmaf(gs[(s + 3) * S + i], xs[(s + 3) * S + j], a3);
      }
      row[e] += (a0 + a1) + (a2 + a3);
    }
  }
  __syncthreads();  // smem is read before the next child overwrites it
}

template <int S>
__global__ void __launch_bounds__(kTile)
classic_reverse_walk_kernel(const float* __restrict__ p,       // (B, n_nodes, K, S, S)
                            const float* __restrict__ leaves,  // (n_leaves, sites, S)
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
                            int cmax, int sites, int n_seed, int n_gslots) {
  // the 8 warps' 4 x 4 sums at S = 4; the tile's gy and x rows at S = 20
  constexpr int kSmemFloats = S == 4 ? kTileWarps * S * S : 2 * kTile * S;
  __shared__ __align__(16) float smem[kSmemFloats];
  const int k = blockIdx.y;
  const int b = blockIdx.z;
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

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int site = tile * kTile + threadIdx.x;
    const bool live = site < sites;
    for (int i = 0; i < n_int; ++i) {
      const int node = __ldg(rnode + i);
      const int cnt = __ldg(counts + i);
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
        float x[S];
#pragma unroll
        for (int r = 0; r < S; ++r) {
          sib[r] = 1.0f;
          x[r] = 0.0f;
        }
        if (live) {
          for (int c2 = 0; c2 < cnt; ++c2) {
            if (c2 == c) continue;
            const int other = __ldg(children + i * cmax + c2);
            float xo[S];
            if (other < n_leaves) {
              load_states<S>(leaves + (static_cast<size_t>(other) * ns + site) * S, xo);
            } else {
              load_states<S>(xs + (static_cast<size_t>(other - n_leaves) * ns + site) * S, xo);
            }
            pruning::times_child<S, false>(pb + other * p_node_stride, xo, sib);
          }
          if (child < n_leaves) {
            load_states<S>(leaves + (static_cast<size_t>(child) * ns + site) * S, x);
          } else {
            load_states<S>(xs + (static_cast<size_t>(child - n_leaves) * ns + site) * S, x);
          }
        }
        float gyc[S];
#pragma unroll
        for (int r = 0; r < S; ++r) gyc[r] = g[r] * sib[r] * inv_m;
        block_dp<S>(gyc, x, smem, row + static_cast<size_t>(child) * S * S);
        if (!live) continue;
        float gc[S];
        transpose_apply<S>(pb + child * p_node_stride, gyc, gc);
        const int seed = __ldg(node_seed + child);
        if (seed >= 0) {  // a seed below another seed: the two add up
          float gsd[S];
          load_states<S>(seeds + (static_cast<size_t>(seed) * ns + site) * S, gsd);
#pragma unroll
          for (int r = 0; r < S; ++r) gc[r] += gsd[r];
        }
        if (child >= n_leaves) {
          const int cs = __ldg(cslot + i * cmax + c);
          store_states<S>(slots + (static_cast<size_t>(cs) * ns + site) * S, gc);
        } else if (dls != nullptr) {
          store_states<S>(dls + (static_cast<size_t>(child) * ns + site) * S, gc);
        }
      }
    }
  }
}

// dP[b, node, k] = sum over the rows of dp_rows[b, k, :, node], in row order
// with a compensated (Kahan) add: one thread per (i, j) entry, one block per
// (node, k, b).
template <int S>
__global__ void __launch_bounds__((S * S + 31) / 32 * 32)
classic_dp_rows_kernel(const float* __restrict__ dp_rows,  // (B, K, rows, n_nodes, S, S)
                       float* __restrict__ dp,             // (B, n_nodes, K, S, S)
                       int K, int n_nodes, int rows) {
  const int e = threadIdx.x;
  if (e >= S * S) return;
  const int node = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * K + k;
  const size_t stride = static_cast<size_t>(n_nodes) * S * S;
  const float* __restrict__ src =
      dp_rows + bk * rows * stride + static_cast<size_t>(node) * S * S + e;
  float acc = 0.0f;
  float comp = 0.0f;
  for (int r = 0; r < rows; ++r) {
    const float y = src[r * stride] - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
  dp[((static_cast<size_t>(b) * n_nodes + node) * K + k) * S * S + e] = acc;
}

}  // namespace

// Launch the classic reverse walk and then the sum of its dP rows on
// `stream`; returns the first non-zero cudaGetLastError() (0 = ok). Device
// pointers to contiguous float32 / int32 buffers laid out as documented
// above; the caller allocates every buffer (g_slots is scratch, dp_rows is
// zeroed scratch with `rows` rows per (b, k), dleaf may be null). The
// schedule arrays are ReverseSchedule's; node_seed[n] is j where n is the
// j-th seed, else -1.
extern "C" int pruning_classic_reverse_f32(
    const void* p, const void* leaves, const void* rnode, const void* gslot,
    const void* children, const void* cslot, const void* counts,
    const void* node_seed, const void* res_x, const void* res_e,
    const void* gseeds, void* g_slots, void* dp_rows, void* dp, void* dleaf,
    int B, int K, int S, int n_nodes, int n_leaves, int n_int, int cmax,
    int sites, int n_seed, int n_gslots, int rows, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || n_seed <= 0 ||
      n_gslots <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows, K, B);
  const dim3 grid_rows(n_nodes, K, B);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    classic_reverse_walk_kernel<kS><<<grid, kTile, 0, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(leaves),
        static_cast<const int*>(rnode), static_cast<const int*>(gslot),
        static_cast<const int*>(children), static_cast<const int*>(cslot),
        static_cast<const int*>(counts), static_cast<const int*>(node_seed),
        static_cast<const float*>(res_x), static_cast<const float*>(res_e),
        static_cast<const float*>(gseeds), static_cast<float*>(g_slots),
        static_cast<float*>(dp_rows), static_cast<float*>(dleaf), K, n_nodes,
        n_leaves, n_int, cmax, sites, n_seed, n_gslots);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    classic_dp_rows_kernel<kS><<<grid_rows, (kS * kS + 31) / 32 * 32, 0, st>>>(
        static_cast<const float*>(dp_rows), static_cast<float*>(dp), K,
        n_nodes, rows);
    return static_cast<int>(cudaGetLastError());
  });
}
