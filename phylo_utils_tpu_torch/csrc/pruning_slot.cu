// Big-tree forward walks of Felsenstein pruning for NVIDIA Hopper (sm_90a):
// the O(depth) slot walk (pruning_slot_f32) and the same walk with each
// node's transition matrices staged into shared memory one node ahead
// (pruning_stream_f32).
//
// pruning_slot_f32 replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_slot_kernel and
// pruning_stream_f32 replaces ::_dynamic_slot_stream_kernel. Both compute
// what pruning_forward_f32 (csrc/pruning_forward.cu) computes, the root
// partials and root exponent count of the pruning walk, with the same
// per-node arithmetic (child order, fmaf order, the power-of-two rescale from
// float bits), so their roots are bit for bit the forward kernel's. What
// differs is where a node's partials live until its parent is combined. The
// forward walk keeps every internal node, (B, K, n_nodes - n_leaves, sites,
// S + 1) floats, which grows with the tree (33.6 GB per batch element at
// 1000 taxa x 100,000 protein patterns x 4 categories). Here the walk runs in
// DFS post-order (ops/cuda_pruning.py::_dfs_slot_schedule, a port of the
// JAX package's _dfs_slot_schedule): a node's partials are dead once its
// parent is combined, so a free list gives each internal node a reusable
// slot and the scratch is (B, K, n_slots, sites, S + 1) with n_slots of the
// order of the tree's depth. A child is read from the leaf array or from its
// slot (child_isleaf); a node may write the slot of one of its children,
// after all its children were read.
//
// Design. As in the forward kernel, one thread owns one (batch b, rate
// category k, site) column and walks the whole tree for it; grid
// (ceil(sites / 256), K, B), 256 threads per block; rows of S floats with
// states innermost, read and written as 16-byte vectors. Slots live in device
// memory; a 1000-taxon slot set is a few MB per (b, k) and stays in the
// 50 MB L2. Keeping slots in shared memory is later work.
//
// pruning_slot_f32 reads P through the read-only path from device memory:
// every thread of a block reads the same S x S block of a child, which the
// hardware broadcasts. pruning_stream_f32 (kStageP) copies the children's P
// blocks of node i + 1 into shared memory with cp.async while node i
// computes: a double buffer of 2 x cmax x S x S floats (6.4 KB at S = 20,
// binary schedule), each 16-byte vector copied by one thread, committed as
// one group per node; cp.async.wait_group 1 then __syncthreads make node i's
// blocks visible before any thread reads them, and a second __syncthreads
// after the node keeps node i + 2's copies off a buffer still being read.
// This is the Hopper form of the TPU kernel's make_async_copy landing pads.
// The TPU kernel also streams the leaf rows; here each thread reads its own
// leaf rows directly from device memory (coalesced 16-byte vectors), because
// no other thread of the block uses them and staging would only add a copy.
// Threads past the last site stay in the loop for the block's barriers and
// skip the arithmetic.
//
// What bounds them on an H100: at S = 4, bytes (as the forward kernel); at
// S = 20, operations: 2 x S^2 flops per child and column against ~170 bytes
// per node and column, and at S = 20 the 400 P values per child are either
// 400 broadcast loads through L1 (slot) or 400 shared-memory loads (stream).
// The slot walk's scratch traffic is the forward's, but on a working set of
// n_slots rows instead of n_inner, which is what keeps it in L2.

#include "pruning_common.cuh"

namespace {

using pruning::kThreads;

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

template <int S, bool kStageP>
__global__ void __launch_bounds__(kThreads)
pruning_slot_kernel(const float* __restrict__ p,        // (B, n_nodes, K, S, S)
                    const float* __restrict__ leaves,   // (n_leaves, sites, S)
                    const int* __restrict__ nslot,      // (n_int,) slot a node writes
                    const int* __restrict__ cnode,      // (n_int, cmax) child node ids
                    const int* __restrict__ csrc,       // (n_int, cmax) leaf or slot id
                    const int* __restrict__ cleaf,      // (n_int, cmax) 1: child is a leaf
                    const int* __restrict__ counts,     // (n_int,)
                    float* __restrict__ slots,          // (B, K, n_slots, sites, S)
                    float* __restrict__ slots_e,        // (B, K, n_slots, sites)
                    float* __restrict__ root,           // (B, K, sites, S)
                    float* __restrict__ root_e,         // (B, K, sites)
                    int K, int n_nodes, int n_slots, int n_int, int cmax,
                    int sites) {
  extern __shared__ float4 p_stage_vec[];  // (2, cmax, S, S) when kStageP
  float* p_stage = reinterpret_cast<float*>(p_stage_vec);
  const int site = blockIdx.x * kThreads + threadIdx.x;
  const bool active = site < sites;
  if constexpr (!kStageP) {
    if (!active) return;
  }
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ xs = slots + bk * n_slots * sites * S;
  float* __restrict__ es = slots_e + bk * n_slots * sites;
  // P for (b, node, k) starts at pb + node * K * S * S
  const float* __restrict__ pb = p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  constexpr int kBlockVecs = S * S / 4;  // 16-byte vectors per P block

  // node i's children's P blocks -> stage buffer `buf` (all threads share)
  auto stage = [&](int i, int buf) {
    const int cnt = __ldg(counts + i);
    for (int v = threadIdx.x; v < cnt * kBlockVecs; v += kThreads) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;
      const int child = __ldg(cnode + i * cmax + c);
      cp_async16(p_stage + (static_cast<size_t>(buf) * cmax + c) * S * S + 4 * q,
                 pb + child * p_node_stride + 4 * q);
    }
  };
  if constexpr (kStageP) {
    stage(0, 0);
    cp_async_commit();
  }

  for (int i = 0; i < n_int; ++i) {
    const float* p_now = nullptr;
    if constexpr (kStageP) {
      if (i + 1 < n_int) stage(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait_one();  // node i's group has landed (this thread's part)
      __syncthreads();      // ... and every other thread's
      p_now = p_stage + static_cast<size_t>(i & 1) * cmax * S * S;
    }
    if (active) {
      const int cnt = __ldg(counts + i);
      float acc[S];
#pragma unroll
      for (int r = 0; r < S; ++r) acc[r] = 1.0f;
      float e = 0.0f;
      for (int c = 0; c < cnt; ++c) {
        const int src = __ldg(csrc + i * cmax + c);
        float x[S];
        if (__ldg(cleaf + i * cmax + c)) {
          pruning::load_states<S>(leaves + (static_cast<size_t>(src) * sites + site) * S, x);
        } else {
          const size_t row = static_cast<size_t>(src) * sites + site;
          pruning::load_states<S>(xs + row * S, x);
          e += es[row];
        }
        if constexpr (kStageP) {
          pruning::times_child<S, true>(p_now + c * S * S, x, acc);
        } else {
          const int child = __ldg(cnode + i * cmax + c);
          pruning::times_child<S, false>(pb + child * p_node_stride, x, acc);
        }
      }
      e += pruning::rescale_pow2<S>(acc);
      if (i == n_int - 1) {  // the root is last in DFS post-order
        pruning::store_states<S>(root + (bk * sites + site) * S, acc);
        root_e[bk * sites + site] = e;
      } else {  // may be a child's slot: every child was read above
        const size_t row = static_cast<size_t>(__ldg(nslot + i)) * sites + site;
        pruning::store_states<S>(xs + row * S, acc);
        es[row] = e;
      }
    }
    if constexpr (kStageP) {
      __syncthreads();  // buffer i & 1 is read before node i + 2 lands in it
    }
  }
}

template <bool kStageP>
int launch_slot(const void* p, const void* leaves, const void* nslot,
                const void* cnode, const void* csrc, const void* cleaf,
                const void* counts, void* slots, void* slots_e, void* root,
                void* root_e, int B, int K, int S, int n_nodes, int n_slots,
                int n_int, int cmax, int sites, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || n_slots <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sites + kThreads - 1) / kThreads, K, B);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    auto kernel = pruning_slot_kernel<kS, kStageP>;
    const size_t smem =
        kStageP ? 2 * static_cast<size_t>(cmax) * kS * kS * sizeof(float) : 0;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(leaves),
        static_cast<const int*>(nslot), static_cast<const int*>(cnode),
        static_cast<const int*>(csrc), static_cast<const int*>(cleaf),
        static_cast<const int*>(counts), static_cast<float*>(slots),
        static_cast<float*>(slots_e), static_cast<float*>(root),
        static_cast<float*>(root_e), K, n_nodes, n_slots, n_int, cmax, sites);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// The slot walk, P read from device memory. Launch on `stream`; returns
// cudaGetLastError() after the launch (0 = ok). Device pointers to contiguous
// float32 / int32 buffers laid out as documented above, every one 16-byte
// aligned; the caller allocates every buffer (slots, slots_e are scratch).
// S is 4 or 20.
extern "C" int pruning_slot_f32(const void* p, const void* leaves,
                                const void* nslot, const void* cnode,
                                const void* csrc, const void* cleaf,
                                const void* counts, void* slots, void* slots_e,
                                void* root, void* root_e, int B, int K, int S,
                                int n_nodes, int n_slots, int n_int, int cmax,
                                int sites, void* stream) {
  return launch_slot<false>(p, leaves, nslot, cnode, csrc, cleaf, counts,
                            slots, slots_e, root, root_e, B, K, S, n_nodes,
                            n_slots, n_int, cmax, sites, stream);
}

// The slot walk with each node's child P blocks staged in shared memory one
// node ahead (cp.async double buffer). Same contract as pruning_slot_f32.
extern "C" int pruning_stream_f32(const void* p, const void* leaves,
                                  const void* nslot, const void* cnode,
                                  const void* csrc, const void* cleaf,
                                  const void* counts, void* slots,
                                  void* slots_e, void* root, void* root_e,
                                  int B, int K, int S, int n_nodes,
                                  int n_slots, int n_int, int cmax, int sites,
                                  void* stream) {
  return launch_slot<true>(p, leaves, nslot, cnode, csrc, cleaf, counts,
                           slots, slots_e, root, root_e, B, K, S, n_nodes,
                           n_slots, n_int, cmax, sites, stream);
}
