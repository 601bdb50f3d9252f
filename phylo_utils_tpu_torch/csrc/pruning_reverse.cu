// Reverse (gradient) walk of Felsenstein pruning for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_bwd2_kernel, the
// deferred-edge reverse, for a whole tree seeded at the root. It computes what
// that kernel computes, not a copy of its VMEM tiling, identity row or grouped
// walk. Given the residuals of pruning_saveall_f32 (every internal node's
// rescaled partials x_n and exponent count e_n) and the root cotangent
// lambda = ct / (pi . x_root), for every internal node n in pre-order (the
// reverse of the forward's post-order):
//     g_n  = seed = lambda * pi           at the root,
//     g_n  = P_n^T gy_n                   elsewhere,
//     y_c  = P_c x_c                      recomputed for each child c,
//     gy_c = g_n * prod_{c' != c} y_c' * 2^{-r_n}
// where r_n = e_n - sum_c e_c is the node's own rescale exponent, so
// 2^{-r_n} is an exact power of two assembled from float bits (exp2_int in
// ops/pruning.py). The rescale divisors are constants of the backward, which
// is exact because logL does not depend on them. Then, in a second kernel,
//     dP_n = sum_sites gy_n x_n^T          for every node but the root,
// and, when asked, dleaf_l = P_l^T gy_l for every leaf l.
//
// Design. The walk kernel is the forward's: one thread per (batch b, rate
// category k, site) column, grid (ceil(sites / 256), K, B), no
// synchronisation. A child has exactly one parent, so its gy is a plain store
// into the column's own row of gy (B, K, n_nodes, sites, S); a thread only
// reads what it wrote. Partials are read from the leaf array or the saveall
// residuals (B, K, n_nodes - n_leaves, sites, S), states innermost, so each
// node is whole 16-byte vectors per thread (one at S = 4, five at S = 20),
// coalesced across the warp. The
// sibling product is formed by recomputing the other children's y: for a
// binary node that is exactly one contraction per child, as in the TPU kernel,
// and the walk needs no per-child storage for any child count.
//
// The dP epilogue (the TPU kernel's batched MXU product) is a second kernel
// launched right after the walk on the same stream, one block per
// (node, k, b). At S = 4 (pruning_dp_kernel), 512 threads each hold the whole
// 4 x 4 sum in registers: each sums gy_n x_n^T over its sites in chunks of 16
// (a short inner sum per chunk, then one add into its running total), and the
// block reduces the 512 partial matrices by a fixed warp-shuffle tree and a
// fixed-order sum over the warps. There are no atomics, so two launches on the
// same inputs give bit-identical dP, and no sum runs over more than
// sites / 8192 + 16 terms before a tree takes over. At S = 20 the 400-entry
// sum would spill from registers, so pruning_dp_tiled_kernel gives each of
// 416 threads one (i, j) entry over site tiles staged in shared memory
// (fixed order, compensated running sums; deterministic in the same way).
// The entry points are compiled for S = 4 and S = 20 and refuse any other.
//
// What bounds it on an H100: bytes. Per internal node and column the walk
// reads gy_n, each child's x and exponent, and writes each child's gy (and
// dleaf at leaves): about twice the forward's traffic, for about 3 x S^2
// flops per child (bytes bound it at S = 4, operations at S = 20). The
// epilogue reads gy and x once more for every node. The
// design keeps g_n and the sibling products in registers, reads each
// residual row once per sibling use, and leaves gy in device memory (the
// epilogue needs all of it); keeping gy on chip and fusing the epilogue into
// the walk is later work.

#include "pruning_common.cuh"

namespace {

using pruning::exp2_int;
using pruning::kThreads;
using pruning::load_states;
using pruning::store_states;
using pruning::transpose_apply;

constexpr int kDpThreads = 512;   // dP kernel at S = 4: one block per (node, k, b)
constexpr int kDpChunk = 16;      // sites summed per inner chunk
constexpr int kWarps = kDpThreads / 32;
constexpr int kDpTile = 32;       // dP kernel at S = 20: sites staged per step

template <int S>
__global__ void __launch_bounds__(kThreads)
pruning_reverse_walk_kernel(const float* __restrict__ p,       // (B, n_nodes, K, S, S)
                            const float* __restrict__ leaves,  // (n_leaves, sites, S)
                            const int* __restrict__ order,     // (n_int,) post-order
                            const int* __restrict__ children,  // (n_int, cmax)
                            const int* __restrict__ counts,    // (n_int,)
                            const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                            const float* __restrict__ res_e,   // (B, K, n_inner, sites)
                            const float* __restrict__ lam,     // (B, K, sites)
                            const float* __restrict__ freqs,   // (S,)
                            float* __restrict__ gy,            // (B, K, n_nodes, sites, S)
                            float* __restrict__ dleaf,         // (B, K, n_leaves, sites, S) or null
                            int K, int n_nodes, int n_leaves, int n_int,
                            int cmax, int sites) {
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= sites) return;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t bk = static_cast<size_t>(b) * K + k;
  const float* __restrict__ xs = res_x + bk * n_inner * sites * S;
  const float* __restrict__ es = res_e + bk * n_inner * sites;
  float* __restrict__ gys = gy + bk * n_nodes * sites * S;
  float* __restrict__ dls =
      dleaf == nullptr ? nullptr : dleaf + bk * n_leaves * sites * S;
  const float* __restrict__ pb = p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;

  for (int i = n_int - 1; i >= 0; --i) {
    const int node = __ldg(order + i);
    const int cnt = __ldg(counts + i);
    float g[S];
    if (i == n_int - 1) {  // the root: g = seed, no P^T step
      const float l = lam[bk * sites + site];
#pragma unroll
      for (int r = 0; r < S; ++r) g[r] = l * __ldg(freqs + r);
    } else {
      float gyn[S];
      load_states<S>(gys + (static_cast<size_t>(node) * sites + site) * S, gyn);
      transpose_apply<S>(pb + node * p_node_stride, gyn, g);
    }
    // 2^{-r_n}: the children's exponent counts minus the node's
    float esum = 0.0f;
    for (int c = 0; c < cnt; ++c) {
      const int child = __ldg(children + i * cmax + c);
      if (child >= n_leaves) {
        esum += es[static_cast<size_t>(child - n_leaves) * sites + site];
      }
    }
    const float inv_m =
        exp2_int(esum - es[static_cast<size_t>(node - n_leaves) * sites + site]);

    for (int c = 0; c < cnt; ++c) {
      float sib[S];
#pragma unroll
      for (int r = 0; r < S; ++r) sib[r] = 1.0f;
      for (int c2 = 0; c2 < cnt; ++c2) {
        if (c2 == c) continue;
        const int other = __ldg(children + i * cmax + c2);
        float x[S];
        if (other < n_leaves) {
          load_states<S>(leaves + (static_cast<size_t>(other) * sites + site) * S, x);
        } else {
          load_states<S>(xs + (static_cast<size_t>(other - n_leaves) * sites + site) * S, x);
        }
        pruning::times_child<S, false>(pb + other * p_node_stride, x, sib);
      }
      float gyc[S];
#pragma unroll
      for (int r = 0; r < S; ++r) gyc[r] = g[r] * sib[r] * inv_m;
      const int child = __ldg(children + i * cmax + c);
      store_states<S>(gys + (static_cast<size_t>(child) * sites + site) * S, gyc);
      if (dls != nullptr && child < n_leaves) {
        float dl[S];
        transpose_apply<S>(pb + child * p_node_stride, gyc, dl);
        store_states<S>(dls + (static_cast<size_t>(child) * sites + site) * S, dl);
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kDpThreads)
pruning_dp_kernel(const float* __restrict__ leaves,  // (n_leaves, sites, S)
                  const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                  const float* __restrict__ gy,      // (B, K, n_nodes, sites, S)
                  float* __restrict__ dp,            // (B, n_nodes, K, S, S)
                  int K, int n_nodes, int n_leaves, int root, int sites) {
  const int node = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ out =
      dp + ((static_cast<size_t>(b) * n_nodes + node) * K + k) * S * S;
  if (node == root) {  // no parent edge
    if (threadIdx.x < S * S) out[threadIdx.x] = 0.0f;
    return;
  }
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const float* __restrict__ xg =
      node < n_leaves
          ? leaves + static_cast<size_t>(node) * sites * S
          : res_x + (bk * n_inner + (node - n_leaves)) * sites * S;
  const float* __restrict__ gg = gy + (bk * n_nodes + node) * sites * S;

  float acc[S * S];
#pragma unroll
  for (int e = 0; e < S * S; ++e) acc[e] = 0.0f;
  for (int base = threadIdx.x; base < sites; base += kDpThreads * kDpChunk) {
    float part[S * S];
#pragma unroll
    for (int e = 0; e < S * S; ++e) part[e] = 0.0f;
    for (int u = 0; u < kDpChunk; ++u) {
      const int site = base + u * kDpThreads;
      if (site >= sites) break;
      float gv[S], xv[S];
      load_states<S>(gg + static_cast<size_t>(site) * S, gv);
      load_states<S>(xg + static_cast<size_t>(site) * S, xv);
#pragma unroll
      for (int i = 0; i < S; ++i) {
#pragma unroll
        for (int j = 0; j < S; ++j) part[i * S + j] = fmaf(gv[i], xv[j], part[i * S + j]);
      }
    }
#pragma unroll
    for (int e = 0; e < S * S; ++e) acc[e] += part[e];
  }
  // fixed-order tree inside each warp, then a fixed-order sum over warps
#pragma unroll
  for (int e = 0; e < S * S; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off);
    }
  }
  __shared__ float warp_sum[kWarps][S * S];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < S * S; ++e) warp_sum[warp][e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < S * S) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w][threadIdx.x];
    out[threadIdx.x] = total;
  }
}

// dP at S = 20, where acc[S * S] per thread would spill (400 floats): each
// thread owns ONE (i, j) entry of the block's S x S sum. The block stages
// kDpTile sites of gy_n and x_n at a time in shared memory (every thread
// loads, 16-byte vectors), then thread (i, j) forms the tile's fmaf chain in
// site order and adds it to its running total with a compensated (Kahan)
// add. Every sum has a fixed order and there are no atomics, so two launches
// give bit-identical dP; the compensation keeps the running total within a
// few roundings however many tiles there are.
template <int S>
__global__ void __launch_bounds__((S * S + 31) / 32 * 32)
pruning_dp_tiled_kernel(const float* __restrict__ leaves,  // (n_leaves, sites, S)
                        const float* __restrict__ res_x,   // (B, K, n_inner, sites, S)
                        const float* __restrict__ gy,      // (B, K, n_nodes, sites, S)
                        float* __restrict__ dp,            // (B, n_nodes, K, S, S)
                        int K, int n_nodes, int n_leaves, int root,
                        int sites) {
  static_assert(S % 4 == 0, "tiles are staged as 16-byte vectors");
  constexpr int kVecs = kDpTile * S / 4;
  __shared__ float4 g_tile[kVecs];
  __shared__ float4 x_tile[kVecs];
  const int node = blockIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int e = threadIdx.x;
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ out =
      dp + ((static_cast<size_t>(b) * n_nodes + node) * K + k) * S * S;
  if (node == root) {  // no parent edge
    if (e < S * S) out[e] = 0.0f;
    return;
  }
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const float4* __restrict__ xg = reinterpret_cast<const float4*>(
      node < n_leaves
          ? leaves + static_cast<size_t>(node) * sites * S
          : res_x + (bk * n_inner + (node - n_leaves)) * sites * S);
  const float4* __restrict__ gg = reinterpret_cast<const float4*>(
      gy + (bk * n_nodes + node) * sites * S);
  const float* gs = reinterpret_cast<const float*>(g_tile);
  const float* xs = reinterpret_cast<const float*>(x_tile);
  const int ei = e / S;
  const int ej = e % S;
  float acc = 0.0f;
  float comp = 0.0f;
  for (int base = 0; base < sites; base += kDpTile) {
    const int n = min(kDpTile, sites - base);
    const size_t off = static_cast<size_t>(base) * S / 4;
    for (int v = e; v < n * S / 4; v += blockDim.x) {
      g_tile[v] = gg[off + v];
      x_tile[v] = xg[off + v];
    }
    __syncthreads();
    if (e < S * S) {
      float part = 0.0f;
      for (int s = 0; s < n; ++s) part = fmaf(gs[s * S + ei], xs[s * S + ej], part);
      const float y = part - comp;
      const float t = acc + y;
      comp = (t - acc) - y;
      acc = t;
    }
    __syncthreads();  // the tile is consumed before the next one lands
  }
  if (e < S * S) out[e] = acc;
}

}  // namespace

// Launch the reverse walk and then the dP reduction on `stream`; returns the
// first non-zero cudaGetLastError() (0 = ok). Device pointers to contiguous
// float32 / int32 buffers laid out as documented above; the caller allocates
// every buffer (gy is scratch, dleaf may be null). `root` is order[n_int - 1].
extern "C" int pruning_reverse_f32(const void* p, const void* leaves,
                                   const void* order, const void* children,
                                   const void* counts, const void* res_x,
                                   const void* res_e, const void* lam,
                                   const void* freqs, void* gy, void* dp,
                                   void* dleaf, int B, int K, int S,
                                   int n_nodes, int n_leaves, int n_int,
                                   int cmax, int sites, int root,
                                   void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((sites + kThreads - 1) / kThreads, K, B);
  const dim3 grid_dp(n_nodes, K, B);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    pruning_reverse_walk_kernel<kS><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(leaves),
        static_cast<const int*>(order), static_cast<const int*>(children),
        static_cast<const int*>(counts), static_cast<const float*>(res_x),
        static_cast<const float*>(res_e), static_cast<const float*>(lam),
        static_cast<const float*>(freqs), static_cast<float*>(gy),
        static_cast<float*>(dleaf), K, n_nodes, n_leaves, n_int, cmax, sites);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if constexpr (kS == 4) {
      pruning_dp_kernel<kS><<<grid_dp, kDpThreads, 0, st>>>(
          static_cast<const float*>(leaves), static_cast<const float*>(res_x),
          static_cast<const float*>(gy), static_cast<float*>(dp), K, n_nodes,
          n_leaves, root, sites);
    } else {
      pruning_dp_tiled_kernel<kS><<<grid_dp, (kS * kS + 31) / 32 * 32, 0, st>>>(
          static_cast<const float*>(leaves), static_cast<const float*>(res_x),
          static_cast<const float*>(gy), static_cast<float*>(dp), K, n_nodes,
          n_leaves, root, sites);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
