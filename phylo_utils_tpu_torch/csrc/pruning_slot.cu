// Big-tree forward walks of Felsenstein pruning for NVIDIA Hopper (sm_90a):
// the O(depth) slot walk (pruning_slot_f32, B4) and the same walk with each
// node's transition matrices staged into shared memory two nodes ahead
// (pruning_stream_f32, B5).
//
// pruning_slot_f32 replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_slot_kernel and
// pruning_stream_f32 replaces ::_dynamic_slot_stream_kernel. Both compute
// what pruning_forward_f32 (csrc/pruning_forward.cu) computes, the root
// partials and root exponent count of the pruning walk, with the same
// per-node arithmetic (child order, fmaf order, the power-of-two rescale from
// float bits), so their roots are bit for bit the forward kernel's. What
// differs is where a node's partials live until its parent is combined: the
// walk runs in DFS post-order (ops/cuda_pruning.py::_dfs_slot_schedule, a
// port of the JAX package's _dfs_slot_schedule), a node's partials are dead
// once its parent is combined, so a free list gives each internal node a
// reusable slot, n_slots of the order of the tree's depth (8 at 1000 taxa,
// 4 at the flagship, 1 on a caterpillar). A child is read from the leaf
// array or from its slot; a node may write the slot of one of its children,
// after all its children were read.
//
// B4. What bounded its first body, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md section 6): one thread a column walked the tree with its
// slots in device memory, (B, K, n_slots, sites, S + 1), each node's row
// written there and read back by its parent from L2, P read through L1.
// At 1000 taxa x 8192 DNA patterns (32,768 columns: ~8 warps an SM) it
// took 1.265 ms, ~1.27 us a node: one memory round trip per node with too
// few warps to hide it, 3% of its bound (0.0395 ms, the 131 MB of leaves).
// The TPU kernel keeps the slots in VMEM. Its body now is csrc/
// pruning_rows.cuh's live-row walk (shared with B1) over the DFS walk's
// flat edges (SlotSchedule.rows): the slots live in shared memory (8 rows
// x (S + 1) floats a column at 1000 taxa), all of them in device memory
// (same kernel) where they do not fit a block at 32 columns; P is staged two steps of edges ahead, and at
// 4 states in a launch of few columns the leaf rows too, which are then its
// only device-memory reads; up to four lanes share a column
// (ops/cuda_pruning.py::row_geometry). A node of any number of children
// runs. What bounds it now, measured in turns against the first body
// (kernel_turns.py, PERF.md section 6): 0.639 ms at 1000-taxon DNA (1.241
// before, 6% of its bytes bound), latency with ~15 warps an SM; 0.132 ms
// at the flagship B = 64 (0.190 before), the issue of ~45 instructions a
// column and edge against 20 FMAs and multiplies; 41 us of device time at
// B = 1, as B1.
//
// B5 is the protein walk, bound by operations: 2 S^2 flops per child and
// column against ~170 bytes per node and column at S = 20. Its first
// version ran at 22% of its bound (1.92 ms at 512 taxa x 8192 LG
// patterns, NVIDIA H100 80GB HBM3, 700 W). Its SASS already read the staged
// P as LDS.128, one load per four FMAs, and a version with two lanes
// sharing two sites (one LDS.128 per eight FMAs) ran slower, so the
// shared-memory pipe is not what bounds it. At that shape the launch has
// 1024 warps, ~8 an SM, and each node waits on its children's rows from L2
// or HBM. The design:
// - At 20 states two adjacent lanes share a column, lane h forming rows
//   [h S/2, (h + 1) S/2) with each row's fmaf chain in j order, as in
//   times_child: twice the warps in flight. The rescale's max takes one
//   exact shuffle with the partner lane; the pair passes __syncwarp after
//   reading its children, before either lane writes a slot that may be a
//   child's. At 4 states (measured slower split) one lane a column.
// - 256-thread blocks; P read from the stage as 16-byte broadcast vectors.
// - The children's P blocks of node i + 2 are copied (cp.async) into a
//   3-stage ring right after node i's barrier (pruning_common.cuh), so one
//   barrier per node (two before) publishes them and frees the stage, and
//   the copy has two nodes' time to land (the TPU kernel's
//   make_async_copy landing pads).
// - Leaf and slot rows are read straight from device memory (coalesced
//   16-byte vectors): no other column uses them.
// - At 64 states (codon, padded by ops/cuda_pruning.py) four lanes share a
//   column, 16 rows each, rows r 4 + h of P staged with rows 68 floats
//   apart (pruning_common.cuh's lane_row, p_row: 64 apart, the four rows
//   read at once conflicted 4-way on every LDS.128: PERF.md section 6),
//   and the child's row streams from device memory as
//   16-byte vectors instead of sitting in 64 registers (80 registers a
//   thread, not 162: two blocks an SM). Bound by operations (2 S^2 flops
//   a child and column); its time beside its bound: PERF.md section 6.
// The rows, the fmaf order and the rescale are B1's, so the roots keep
// B1's bits. Threads past the last site stay in the loop for the barriers
// and skip the loads and stores. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (kernel_turns.py, PERF.md section 6): 1.65 ms at 512 taxa
// x 8192 LG patterns, 25% of its operations bound (1.93 ms, 22%, before).

#include "pruning_rows.cuh"

namespace {

using pruning::kThreads;

// Lanes per column of the stream walk: at 20 states two lanes share a
// column, each forming half of its rows, which doubles the warps in flight
// (the walk waits on row latency with ~8 warps an SM at one lane a column);
// at 4 states one lane (the split measured slower there); at 64 (codon)
// four, 16 rows a lane beside the child's 64-entry row in registers (two
// lanes' 32 rows would halve the warps of a launch of ~16,000 columns).
template <int S>
__host__ __device__ constexpr int stream_lanes() {
  return S >= 64 ? 4 : (S >= 20 ? 2 : 1);
}

// The stream walk (B5): the slot walk with the children's P staged in
// shared memory two nodes ahead, in a ring of kPStages stages, read as
// 16-byte broadcast vectors. kL = stream_lanes<S>() adjacent lanes own one
// column; lane h forms rows [h S / kL, (h + 1) S / kL), each row's fmaf
// chain in j order as in times_child.
template <int S>
__global__ void __launch_bounds__(kThreads)
pruning_stream_kernel(const float* __restrict__ p,        // (B, n_nodes, K, S, S)
                      const float* __restrict__ leaves,   // (n_leaves, sites, S)
                      const int* __restrict__ nslot,      // (n_int,)
                      const int* __restrict__ cnode,      // (n_int, cmax)
                      const int* __restrict__ csrc,       // (n_int, cmax)
                      const int* __restrict__ cleaf,      // (n_int, cmax)
                      const int* __restrict__ counts,     // (n_int,)
                      float* __restrict__ slots,          // (B, K, n_slots, sites, S)
                      float* __restrict__ slots_e,        // (B, K, n_slots, sites)
                      float* __restrict__ root,           // (B, K, sites, S)
                      float* __restrict__ root_e,         // (B, K, sites)
                      int K, int n_nodes, int n_slots, int n_int, int cmax,
                      int sites) {
  constexpr int kL = stream_lanes<S>();
  constexpr int kRows = S / kL;   // rows a lane forms
  static_assert(kRows % 2 == 0, "a lane's rows are stored as 8-byte vectors");
  constexpr int kBlock = pruning::p_block<S>();  // floats of a staged P block
  extern __shared__ float4 p_stage_vec[];  // (kPStages, cmax, S, p_row<S>)
  float* p_stage = reinterpret_cast<float*>(p_stage_vec);
  const int h = threadIdx.x % kL;
  const int site = blockIdx.x * (kThreads / kL) + threadIdx.x / kL;
  const bool active = site < sites;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ xs = slots + bk * n_slots * sites * S;
  float* __restrict__ es = slots_e + bk * n_slots * sites;
  const float* __restrict__ pb = p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  constexpr int kBlockVecs = S * S / 4;  // 16-byte vectors per P block

  // node i's children's P blocks -> its stage (all threads share)
  auto stage = [&](int i) {
    if (i >= n_int) return;
    const int cnt = __ldg(counts + i);
    float* dst = p_stage + static_cast<size_t>(i % pruning::kPStages) * cmax * kBlock;
    for (int v = threadIdx.x; v < cnt * kBlockVecs; v += kThreads) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;
      const int child = __ldg(cnode + i * cmax + c);
      pruning::cp_async16(dst + c * kBlock + pruning::p_stage_offset<S>(q),
                          pb + child * p_node_stride + 4 * q);
    }
  };
  stage(0);
  pruning::cp_async_commit();
  stage(1);
  pruning::cp_async_commit();

  for (int i = 0; i < n_int; ++i) {
    pruning::cp_async_wait_one();  // node i's group has landed (this thread's part)
    __syncthreads();               // ... and every other thread's
    stage(i + 2);                  // into the stage node i - 1 read
    pruning::cp_async_commit();
    const float* p_now =
        p_stage + static_cast<size_t>(i % pruning::kPStages) * cmax * kBlock;
    const int cnt = __ldg(counts + i);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 1.0f;
    float e = 0.0f;
    for (int c = 0; c < cnt; ++c) {
      const int src = __ldg(csrc + i * cmax + c);
      const float* pm = p_now + c * kBlock;
      if constexpr (S == 64) {
        // the child's row streamed as 16-byte vectors, as the saveall
        // kernel does at 64 states: the whole row in registers took 162 a
        // thread (ptxas), one block an SM; each row's fmaf chain stays in
        // j order, so the bits are B1's
        float y[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) y[r] = 0.0f;
        if (active) {
          const float* row_src;
          if (__ldg(cleaf + i * cmax + c)) {
            row_src = leaves + (static_cast<size_t>(src) * sites + site) * S;
          } else {
            const size_t row = static_cast<size_t>(src) * sites + site;
            row_src = xs + row * S;
            e += es[row];
          }
#pragma unroll 4
          for (int q = 0; q < S / 4; ++q) {
            const float4 xv = reinterpret_cast<const float4*>(row_src)[q];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 v = pruning::p_vec<S>(pm, pruning::lane_row<S, kL>(h, r), q);
              y[r] = fmaf(v.x, xv.x, y[r]);
              y[r] = fmaf(v.y, xv.y, y[r]);
              y[r] = fmaf(v.z, xv.z, y[r]);
              y[r] = fmaf(v.w, xv.w, y[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] *= y[r];
        continue;
      }
      float x[S];
#pragma unroll
      for (int j = 0; j < S; ++j) x[j] = 0.0f;
      if (active) {
        if (__ldg(cleaf + i * cmax + c)) {
          pruning::load_states<S>(leaves + (static_cast<size_t>(src) * sites + site) * S, x);
        } else {
          const size_t row = static_cast<size_t>(src) * sites + site;
          pruning::load_states<S>(xs + row * S, x);
          e += es[row];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float y = 0.0f;
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const float4 v = pruning::p_vec<S>(pm, h * kRows + r, q);
          y = fmaf(v.x, x[4 * q], y);
          y = fmaf(v.y, x[4 * q + 1], y);
          y = fmaf(v.z, x[4 * q + 2], y);
          y = fmaf(v.w, x[4 * q + 3], y);
        }
        acc[r] *= y;
      }
    }
    // rescale_pow2 over the column's S rows: the max over the kL lanes'
    // rows by exact shuffles, then the same scale and exponent
    float m = FLT_MIN;
#pragma unroll
    for (int r = 0; r < kRows; ++r) m = fmaxf(m, acc[r]);
#pragma unroll
    for (int off = 1; off < kL; off <<= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    int eb = (__float_as_int(m) >> 23) & 0xFF;
    eb = min(max(eb, 1), 253);
    const float scale = __int_as_float((254 - eb) << 23);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] *= scale;
    e += static_cast<float>(eb - 127);
    if constexpr (kL > 1) {
      __syncwarp();  // the column's lanes read its children (perhaps the slot below)
    }
    if (active) {
      float* dst = xs;
      float* dst_e = es;
      size_t row;
      if (i == n_int - 1) {  // the root is last in DFS post-order
        dst = root;
        dst_e = root_e;
        row = bk * sites + site;
      } else {  // may be a child's slot: every child was read above
        row = static_cast<size_t>(__ldg(nslot + i)) * sites + site;
      }
      if constexpr (S == 64) {  // the lane's rows r kL + h (lane_row)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dst[row * S + pruning::lane_row<S, kL>(h, r)] = acc[r];
        }
      } else {
#pragma unroll
        for (int q = 0; q < kRows / 2; ++q) {
          reinterpret_cast<float2*>(dst + row * S + h * kRows)[q] =
              make_float2(acc[2 * q], acc[2 * q + 1]);
        }
      }
      if (h == 0) dst_e[row] = e;
    }
  }
}

int launch_stream(const void* p, const void* leaves, const void* nslot,
                  const void* cnode, const void* csrc, const void* cleaf,
                  const void* counts, void* slots, void* slots_e, void* root,
                  void* root_e, int B, int K, int S, int n_nodes, int n_slots,
                  int n_int, int cmax, int sites, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || n_slots <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    auto kernel = pruning_stream_kernel<kS>;
    const size_t smem = static_cast<size_t>(pruning::kPStages) * cmax *
                        pruning::p_block<kS>() * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    // kThreads a block, kThreads / stream_lanes sites a block
    const int per_block = kThreads / stream_lanes<kS>();
    const dim3 grid((sites + per_block - 1) / per_block, K, B);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(leaves),
        static_cast<const int*>(nslot), static_cast<const int*>(cnode),
        static_cast<const int*>(csrc), static_cast<const int*>(cleaf),
        static_cast<const int*>(counts), static_cast<float*>(slots),
        static_cast<float*>(slots_e), static_cast<float*>(root),
        static_cast<float*>(root_e), K, n_nodes, n_slots, n_int, cmax,
        sites);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// The slot walk over B4's DFS slots (csrc/pruning_rows.cuh): `edges`,
// `eword`, the spill rows and the launch geometry as pruning_forward_f32's
// (csrc/pruning_forward.cu), over ops/cuda_pruning.py::SlotSchedule.rows,
// n_rows = n_slots. Launch on `stream`; returns cudaGetLastError() after
// the launch (0 = ok), the error of granting the shared memory, or
// cudaErrorInvalidValue without launching for a geometry that is not
// compiled. S is 4, 20 or 64 (lanes 2 or 4 at 64, B1's body: the walk
// that PHYLO_FORCE_STREAM=0 takes past the classic budget at codon width,
// as _pallas_forward takes _dynamic_slot_kernel there).
extern "C" int pruning_slot_f32(const void* p, const void* leaves,
                                const void* edges, const void* eword,
                                void* spill, void* spill_e, void* root,
                                void* root_e, int B, int K, int S,
                                int n_nodes, int n_leaves, int n_edges,
                                int sites, int n_rows, int smem_rows,
                                int lanes, int cols, int chunk,
                                int stage_leaves, void* stream) {
  const pruning::RowWalk w{
      static_cast<const float*>(p),   static_cast<const float*>(leaves),
      static_cast<const int*>(edges), static_cast<const int2*>(eword),
      static_cast<float*>(spill),     static_cast<float*>(spill_e),
      static_cast<float*>(root),      static_cast<float*>(root_e),
      K, n_nodes, n_leaves, n_edges, sites,
      n_rows, smem_rows, cols, chunk, stage_leaves};
  return pruning::launch_rows(w, B, S, lanes, stream);
}

// The slot walk with each node's child P blocks staged in shared memory
// two nodes ahead (B5): slots (B, K, n_slots, sites, S) and slots_e (B, K,
// n_slots, sites) in device memory, node i writing slot nslot[i], its
// children cnode[i, :counts[i]] read from the leaf array (cleaf) or slot
// csrc. Launch on `stream`; returns cudaGetLastError() after the launch
// (0 = ok). Device pointers to contiguous float32 / int32 buffers, every
// one 16-byte aligned; the caller allocates every buffer. S is 4, 20 or 64
// (3 cmax S^2 floats of shared memory must fit a block: cmax <= 4 at 64).
extern "C" int pruning_stream_f32(const void* p, const void* leaves,
                                  const void* nslot, const void* cnode,
                                  const void* csrc, const void* cleaf,
                                  const void* counts, void* slots,
                                  void* slots_e, void* root, void* root_e,
                                  int B, int K, int S, int n_nodes,
                                  int n_slots, int n_int, int cmax, int sites,
                                  void* stream) {
  return launch_stream(p, leaves, nslot, cnode, csrc, cleaf, counts, slots,
                       slots_e, root, root_e, B, K, S, n_nodes, n_slots, n_int,
                       cmax, sites, stream);
}
