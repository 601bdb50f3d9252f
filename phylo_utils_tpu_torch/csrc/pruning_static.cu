// Felsenstein pruning forward walk compiled for one tree topology
// (pruning_static_f32), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel phylo_utils_tpu/ops/pallas_pruning.py::_static_kernel:
// the whole post-order walk unrolled at trace time, with every node id a
// constant. The Hopper counterpart is a kernel compiled per topology:
// ops/_build.py writes the tree's post-order, children and counts
// (ops/cuda_pruning._postorder_arrays) and the state count as constexpr
// arrays into a generated header, pruning_static_topology.h, in the build
// directory, and compiles this file against it with one nvcc. The walk is a
// fold over std::integer_sequence, one instantiation per node and child, so
// every node id, child id and leaf-or-internal test is a compile-time
// constant: each child's P offset and scratch row are an immediate times the
// stride, and there is no index load, loop counter or branch left in the
// walk. Each node is a device function of its own (__noinline__), called in
// post-order: fully inlined, ptxas scheduled loads across the whole tree and
// the walk took 254 registers a thread at 4 states (63 internal nodes) and
// 255 with 15.5 KB of spills at 20 states (31 internal nodes), whose build
// took 172 s (nvcc -Xptxas -v for sm_90a on the H100 machine); one function
// per node keeps each node's registers to itself, as B1's loop does.
// Per column it computes what B1 (csrc/pruning_forward.cu) computes,
// with the same helpers in the same order (times_child, rescale_pow2), so its
// root and exponent count are bit for bit B1's. Layouts are B1's:
//     p (B, n_nodes, K, S, S), leaves (n_leaves, sites, S),
//     scratch (B, K, n_nodes - n_leaves, sites, S), scratch_e (B, K, ..., sites),
//     root (B, K, sites, S), root_e (B, K, sites);
// one thread per (batch, category, site) column, grid (ceil(sites / 256), K, B).
//
// What bounds it on an H100: what bounds B1 (bytes at 4 states, operations
// and the broadcast P loads at 20); the unrolled walk removes B1's per-node
// index loads and loop branches, and adds a call per node. The price is the
// build: one nvcc per topology and state count, whose time grows with the
// number of nodes (ops/_build.py records it).
//
// The header defines, in namespace topo: kS, kNNodes, kNLeaves, kNInt, kCmax,
// kOrder[kNInt], kChildren[kNInt * kCmax], kCounts[kNInt]. Namespace-scope
// constexpr arrays are host variables to CUDA; device code reads their
// elements only through the constexpr functions below, in constant
// expressions.

#include <cstddef>
#include <utility>

#include "pruning_common.cuh"
#include "pruning_static_topology.h"

namespace {

using pruning::kThreads;
constexpr int S = topo::kS;

__host__ __device__ constexpr int order_at(int i) { return topo::kOrder[i]; }
__host__ __device__ constexpr int count_at(int i) { return topo::kCounts[i]; }
__host__ __device__ constexpr int child_at(int i, int c) {
  return topo::kChildren[i * topo::kCmax + c];
}

// one thread's column: where its P, leaves, scratch and root live
struct Column {
  const float* pb;   // P of (b, node 0, k); node n at + n * p_node_stride
  size_t p_node_stride;
  const float* leaves;
  float* xs;         // scratch of (b, k)
  float* es;
  float* root;       // root row of (b, k, site)
  float* root_e;
  size_t sites;
  int site;
};

// acc *= P_child x_child for child C of post-order node I
template <int I, int C>
__device__ __forceinline__ void child_step(const Column& col, float (&acc)[S],
                                           float& e) {
  constexpr int child = child_at(I, C);
  float x[S];
  if constexpr (child < topo::kNLeaves) {
    pruning::load_states<S>(
        col.leaves + (static_cast<size_t>(child) * col.sites + col.site) * S, x);
  } else {
    const size_t row =
        static_cast<size_t>(child - topo::kNLeaves) * col.sites + col.site;
    pruning::load_states<S>(col.xs + row * S, x);
    e += col.es[row];
  }
  pruning::times_child<S, false>(col.pb + child * col.p_node_stride, x, acc);
}

// post-order node I: its children C..., the rescale, the store
template <int I, int... C>
__device__ __forceinline__ void node_step(const Column& col,
                                          std::integer_sequence<int, C...>) {
  constexpr int node = order_at(I);
  float acc[S];
#pragma unroll
  for (int r = 0; r < S; ++r) acc[r] = 1.0f;
  float e = 0.0f;
  (child_step<I, C>(col, acc, e), ...);
  e += pruning::rescale_pow2<S>(acc);
  if constexpr (I == topo::kNInt - 1) {   // the root is last in post-order
    pruning::store_states<S>(col.root, acc);
    *col.root_e = e;
  } else {
    const size_t row =
        static_cast<size_t>(node - topo::kNLeaves) * col.sites + col.site;
    pruning::store_states<S>(col.xs + row * S, acc);
    col.es[row] = e;
  }
}

// post-order node I as a call of its own (see the note at the top)
template <int I>
__device__ __noinline__ void node_call(const Column col) {
  node_step<I>(col, std::make_integer_sequence<int, count_at(I)>{});
}

template <int... I>
__device__ __forceinline__ void walk(const Column& col,
                                     std::integer_sequence<int, I...>) {
  (node_call<I>(col), ...);
}

__global__ void __launch_bounds__(kThreads)
pruning_static_kernel(const float* __restrict__ p,
                      const float* __restrict__ leaves,
                      float* __restrict__ scratch,
                      float* __restrict__ scratch_e,
                      float* __restrict__ root, float* __restrict__ root_e,
                      int K, int sites) {
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= sites) return;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  constexpr size_t n_inner = topo::kNNodes - topo::kNLeaves;
  const size_t bk = static_cast<size_t>(b) * K + k;
  const size_t col_id = bk * sites + site;
  const Column col{
      p + (static_cast<size_t>(b) * topo::kNNodes * K + k) * S * S,
      static_cast<size_t>(K) * S * S,
      leaves,
      scratch + bk * n_inner * sites * S,
      scratch_e + bk * n_inner * sites,
      root + col_id * S,
      root_e + col_id,
      static_cast<size_t>(sites),
      site,
  };
  walk(col, std::make_integer_sequence<int, topo::kNInt>{});
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue without launching when the shapes are not the
// ones this library was compiled for. Buffers as pruning_forward_f32's; the
// caller allocates every one.
extern "C" int pruning_static_f32(const void* p, const void* leaves,
                                  void* scratch, void* scratch_e, void* root,
                                  void* root_e, int B, int K, int s,
                                  int n_nodes, int n_leaves, int n_int,
                                  int sites, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || s != topo::kS ||
      n_nodes != topo::kNNodes || n_leaves != topo::kNLeaves ||
      n_int != topo::kNInt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sites + kThreads - 1) / kThreads, K, B);
  pruning_static_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(leaves),
      static_cast<float*>(scratch), static_cast<float*>(scratch_e),
      static_cast<float*>(root), static_cast<float*>(root_e), K, sites);
  return static_cast<int>(cudaGetLastError());
}
