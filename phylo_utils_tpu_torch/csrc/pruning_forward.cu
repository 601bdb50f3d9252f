// Felsenstein pruning forward walk for NVIDIA Hopper (sm_90a): the value
// walk (pruning_forward_f32) and the walk that keeps every node's partials as
// residuals for the gradient (pruning_saveall_f32).
//
// pruning_forward_f32 replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_kernel
// (its grouped walk _walk_tree_grouped, the contraction _contract/_vpu_matmul
// and the exact power-of-two rescale _block_rescale). It computes what that
// kernel computes, not a block-by-block copy of it: for every internal node in
// post-order,
//     y_c = P_c . x_c            for each child c,
//     x_n = prod_c y_c,
//     m   = max(max_i x_n[i], FLT_MIN),  x_n *= 2^-floor(log2 m),
//     e_n = sum_c e_c + floor(log2 m)    (an exact integer count, kept in f32),
// and it returns the root partials and the root exponent count. The caller
// turns the count into ln units (x ln 2) in float64.
//
// Design. One thread owns one (batch b, rate category k, site) column and
// walks the whole tree for it, so there is no synchronisation at all: a
// thread only ever reads partials it wrote itself. Grid is
// (ceil(sites / 256), K, B) with 256 threads per block. Node partials live in
// device memory with sites minor and states innermost,
//     leaves  (n_leaves, sites, S)          -- the JAX function's own layout
//     scratch (B, K, n_nodes - n_leaves, sites, S), indexed by id - n_leaves
//     scratch_e (B, K, n_nodes - n_leaves, sites)
//     root    (B, K, sites, S),  root_e (B, K, sites)
// so each thread moves whole aligned 16-byte vectors per node (one at S = 4,
// five at S = 20) and a warp touches 32 contiguous rows: fully coalesced,
// with no state or site padding (the ragged site edge is masked by the early
// return). The kernels are compiled for S = 4 (DNA) and S = 20 (protein);
// the entry points dispatch on S and refuse any other count. P is read
// through the read-only path: all threads of a block read the same P entries,
// which the hardware broadcasts. Padding children (id 0 beyond counts[i]) are
// never read.
//
// What bounds it on an H100: at S = 4, bytes. Per node and site it reads
// 2 x S floats of children (plus their exponents) and writes S + 1 floats,
// against about 4 x S^2 flops: at S = 4 that is ~40 bytes for ~64 flops,
// below the card's ~20 flops/byte ridge for f32 on CUDA cores; at S = 20,
// ~170 bytes for ~1600 flops, above it, so the protein walk is bound by its
// operations (and by the 400 broadcast P loads per child). The design keeps the
// node's S values in registers between the child loads and the single store,
// so each partial crosses memory exactly once each way, and the scratch of a
// B = 1 flagship walk (4 categories x 63 internal nodes x 1024 sites x 5
// floats) fits in the 50 MB L2. When the whole-tree scratch outgrows that,
// the value path takes the O(depth) slot walk of csrc/pruning_slot.cu.
//
// pruning_saveall_f32 replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_saveall_kernel: the same
// walk, keeping every internal node's rescaled partials and exponent count,
// the root's included, as the residuals of the reverse walk
// (csrc/pruning_reverse.cu). It is the same kernel body instantiated with
// kSaveRoot = true, so its root row is bit for bit the forward's root. The
// residuals are the forward's scratch layout (B, K, n_inner, sites, S) and
// (B, K, n_inner, sites); leaves are not copied (the reverse walk reads the
// leaf array). Bounded by bytes like the forward; the one extra row per
// column (the root) is 1/n_inner more traffic, and residuals stay in device
// memory because the reverse walk needs them.

#include "pruning_common.cuh"

namespace {

using pruning::kThreads;

template <int S, bool kSaveRoot>
__global__ void __launch_bounds__(kThreads)
pruning_forward_kernel(const float* __restrict__ p,         // (B, n_nodes, K, S, S)
                       const float* __restrict__ leaves,    // (n_leaves, sites, S)
                       const int* __restrict__ order,       // (n_int,)
                       const int* __restrict__ children,    // (n_int, cmax)
                       const int* __restrict__ counts,      // (n_int,)
                       float* __restrict__ scratch,         // (B, K, n_inner, sites, S)
                       float* __restrict__ scratch_e,       // (B, K, n_inner, sites)
                       float* __restrict__ root,            // (B, K, sites, S)
                       float* __restrict__ root_e,          // (B, K, sites)
                       int K, int n_nodes, int n_leaves, int n_int, int cmax,
                       int sites) {
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= sites) return;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ xs = scratch + bk * n_inner * sites * S;
  float* __restrict__ es = scratch_e + bk * n_inner * sites;
  // P for (b, node, k) starts at pb + node * K * S * S
  const float* __restrict__ pb = p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;

  for (int i = 0; i < n_int; ++i) {
    const int node = __ldg(order + i);
    const int cnt = __ldg(counts + i);
    float acc[S];
#pragma unroll
    for (int r = 0; r < S; ++r) acc[r] = 1.0f;
    float e = 0.0f;
    for (int c = 0; c < cnt; ++c) {
      const int child = __ldg(children + i * cmax + c);
      float x[S];
      if (child < n_leaves) {
        pruning::load_states<S>(leaves + (static_cast<size_t>(child) * sites + site) * S, x);
      } else {
        const size_t row = static_cast<size_t>(child - n_leaves) * sites + site;
        pruning::load_states<S>(xs + row * S, x);
        e += es[row];
      }
      pruning::times_child<S, false>(pb + child * p_node_stride, x, acc);
    }
    e += pruning::rescale_pow2<S>(acc);

    if (!kSaveRoot && i == n_int - 1) {  // the root is last in post-order
      pruning::store_states<S>(root + (bk * sites + site) * S, acc);
      root_e[bk * sites + site] = e;
    } else {
      const size_t row = static_cast<size_t>(node - n_leaves) * sites + site;
      pruning::store_states<S>(xs + row * S, acc);
      es[row] = e;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// Pointers are device pointers to contiguous float32 / int32 buffers laid out
// as documented above; the caller allocates every buffer. S is 4 or 20.
extern "C" int pruning_forward_f32(const void* p, const void* leaves,
                                   const void* order, const void* children,
                                   const void* counts, void* scratch,
                                   void* scratch_e, void* root, void* root_e,
                                   int B, int K, int S, int n_nodes,
                                   int n_leaves, int n_int, int cmax, int sites,
                                   void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sites + kThreads - 1) / kThreads, K, B);
  return pruning::dispatch_states(S, [&](auto s) {
    pruning_forward_kernel<decltype(s)::value, false>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(p), static_cast<const float*>(leaves),
            static_cast<const int*>(order), static_cast<const int*>(children),
            static_cast<const int*>(counts), static_cast<float*>(scratch),
            static_cast<float*>(scratch_e), static_cast<float*>(root),
            static_cast<float*>(root_e), K, n_nodes, n_leaves, n_int, cmax,
            sites);
    return static_cast<int>(cudaGetLastError());
  });
}

// The forward walk keeping every internal node, the root included, in
// res_x (B, K, n_nodes - n_leaves, sites, S) / res_e (B, K, n_nodes -
// n_leaves, sites), indexed by node id - n_leaves. Returns
// cudaGetLastError() after the launch (0 = ok). S is 4 or 20.
extern "C" int pruning_saveall_f32(const void* p, const void* leaves,
                                   const void* order, const void* children,
                                   const void* counts, void* res_x,
                                   void* res_e, int B, int K, int S,
                                   int n_nodes, int n_leaves, int n_int,
                                   int cmax, int sites, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sites + kThreads - 1) / kThreads, K, B);
  return pruning::dispatch_states(S, [&](auto s) {
    pruning_forward_kernel<decltype(s)::value, true>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(p), static_cast<const float*>(leaves),
            static_cast<const int*>(order), static_cast<const int*>(children),
            static_cast<const int*>(counts), static_cast<float*>(res_x),
            static_cast<float*>(res_e), nullptr, nullptr, K, n_nodes,
            n_leaves, n_int, cmax, sites);
    return static_cast<int>(cudaGetLastError());
  });
}
