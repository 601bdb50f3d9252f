// Felsenstein pruning forward walk compiled for one tree topology
// (pruning_static_f32, B8), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel phylo_utils_tpu/ops/pallas_pruning.py::_static_kernel:
// the whole post-order walk unrolled at trace time, with every node id a
// constant. The Hopper counterpart is a kernel compiled per topology and
// state count: ops/_build.py writes the tree's live-row walk (the DFS slot
// walk, ops/cuda_pruning.py::SlotSchedule.rows: each edge's child, its word
// {the child's row or -1 - leaf, -2 or the row its node writes, -1 for the
// root}, the row count) and the step `chunk` as constexpr arrays into a
// generated header, pruning_static_topology.h, in the build directory, and
// compiles this file against it with one nvcc.
//
// What bounded its first body, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md section 6): every internal node's row in a (B, K,
// n_inner, sites, S) device scratch, P read through L1 one load per FMA,
// one __noinline__ call a node (fully inlined, that walk took 254 registers
// a thread at 4 states and 255 with 15.5 KB of spills at 20, whose build
// took 172 s): 0.2209 ms at the flagship B = 64 against a 0.0197 ms
// operations bound, 0.94x B1's time then.
//
// Its body now is csrc/pruning_rows.cuh's live-row walk (B1's and B4's),
// its per-edge work pruning::row_edge: a column's rows in shared memory
// (rows from smem_rows on in device memory), P staged two steps of edges
// ahead in a 3-stage cp.async ring and read as 16-byte broadcast vectors,
// kL lanes a column. What bounds that body at B = 64 is issue, ~45
// instructions a column and edge of which 20 are FMAs and multiplies, and
// at B = 1 a chain of ~60 dependent instructions an edge. This kernel
// takes away what the walk being a constant makes needless: the edge loop
// is unrolled over the walk (a fold over std::integer_sequence, one
// instantiation an edge), each edge's word passed to row_edge as
// constants, so there is no word load, loop counter or step-boundary test
// left; the leaf / shared-memory / spill choice of the child, the node's
// end and its output row, the child's P offset in its stage and the stage
// itself fold. Left a column and edge: the child's row (one LDS.128 or
// LDG.128 a 4-state row), the P vector loads and the FMAs; and with every
// leaf a constant, ptxas issues later edges' leaf loads early, which is
// what shortens the B = 1 chain. The flat walk needs few registers (60 to
// 88 at 4 states, at ptxas's register-usage level 2, ops/_build.py's
// PTXAS_FLAGS), so there is no call a node. Past a code budget
// (kUnrolled below: config 4 at 20 states, whose 62 edges would unroll to
// 24,800 FMAs a kernel) the object launches the live-row kernel itself,
// pruning::row_walk_kernel<S, kL, 1>, over the walk's words in device
// memory: at 20 states an edge's 400 FMAs dwarf the per-edge overhead the
// constant words remove. The step is fixed at compile time (topo::kChunk);
// lanes, columns, smem_rows and leaf staging stay run-time choices of
// ops/cuda_pruning.py::row_geometry. Each lane count row_geometry can pick
// (1, 2, 4 at 4 states; 1, 2 at 20; 2, 4 at 64) is its own object
// (PRUNING_STATIC_LANES) with its own entry point, all compiled at once.
// The child order and the fmaf order are B1's, so the root and exponent
// count are bit for bit B1's. The price is the build: one nvcc per
// topology, state count and lane count, whose time grows with the edges
// (ops/_build.py records it).
//
// The header defines, in namespace topo: kS, kNNodes, kNLeaves, kNEdges,
// kNRows, kChunk, kEdges[kNEdges] (each edge's child node id) and
// kEword[2 kNEdges] (each edge's word). Namespace-scope constexpr arrays
// are host variables to CUDA; device code reads their elements only
// through the constexpr functions below, in constant expressions. The
// ring's copies of P read the child ids at run time from `edges` (the
// walk's edge array on the device), since a thread copies the blocks of
// several edges of a step.

#include <cstddef>
#include <utility>

#include "pruning_rows.cuh"
#include "pruning_static_topology.h"

namespace {

using pruning::kPStages;
using pruning::kThreads;
constexpr int S = topo::kS;
constexpr int kChunk = topo::kChunk;
constexpr int kNEdges = topo::kNEdges;

__host__ __device__ constexpr int edge_src(int i) { return topo::kEword[2 * i]; }
__host__ __device__ constexpr int edge_dst(int i) {
  return topo::kEword[2 * i + 1];
}

// The walk is unrolled while its code stays small: edges x S^2 up to 4096
// (the flagship's 126 edges at 4 states: 2016; config 4's 62 edges at 20
// states: 24,800 do not; at 64 states no tree is).
constexpr bool kUnrolled = kNEdges * S * S <= 4096;

// One block's walk, kL lanes a column: row_edge over the walk, unrolled.
template <int kL>
struct StaticWalk {
  static constexpr int kRows = S / kL;          // rows a lane forms
  static constexpr int kVecs = S / 4;           // 16-byte vectors of a row
  static constexpr int kBlockVecs = S * S / 4;  // 16-byte vectors of a P block

  const pruning::RowWalk& w;
  const pruning::RowPlace at;
  float acc[1][kRows];
  float e[1];

  __device__ __forceinline__ explicit StaticWalk(const pruning::RowWalk& w_)
      : w(w_), at(pruning::row_place<S, kL, 1>(w_, kChunk)) {
    e[0] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[0][r] = 1.0f;
  }

  __device__ __forceinline__ float* stage_at(int t) const {
    return at.smem + t * at.stage_floats;
  }

  // the column's leaf row of edge E into slot c of ring stage dst
  template <int E, int c>
  __device__ __forceinline__ void stage_leaf(float* dst) {
    if constexpr (E < kNEdges && edge_src(E) < 0) {
      constexpr int leaf = -1 - edge_src(E);
#pragma unroll
      for (int q = at.h; q < kVecs; q += kL) {
        pruning::cp_async16(
            dst + at.p_floats + (c * at.cols + at.col) * S + 4 * q,
            at.leaf_col + static_cast<size_t>(leaf) * at.leaf_stride + 4 * q);
      }
    }
  }

  template <int T, int... C>
  __device__ __forceinline__ void stage_leaf_rows(
      float* dst, std::integer_sequence<int, C...>) {
    (stage_leaf<T * kChunk + C, C>(dst), ...);
  }

  // step T: the P blocks (and leaf rows) of edges [T kChunk, (T + 1)
  // kChunk) into stage T % kPStages; a step past the walk commits an empty
  // group, so the wait below always leaves the next step in flight
  template <int T>
  __device__ __forceinline__ void stage() {
    constexpr int f0 = T * kChunk;
    constexpr int n =
        f0 >= kNEdges ? 0 : (kNEdges - f0 < kChunk ? kNEdges - f0 : kChunk);
    if constexpr (n > 0) {
      float* dst = stage_at(T % kPStages);
      for (int v = threadIdx.x; v < n * kBlockVecs; v += blockDim.x) {
        const int c = v / kBlockVecs;
        const int q = v - c * kBlockVecs;
        const int child = __ldg(w.edges + f0 + c);
        pruning::cp_async16(dst + c * S * S + 4 * q,
                            at.pb + child * at.p_node_stride + 4 * q);
      }
      if (w.stage_leaves && at.live) {
        stage_leaf_rows<T>(dst, std::make_integer_sequence<int, kChunk>{});
      }
    }
    pruning::cp_async_commit();
  }

  // edge I of the unrolled walk
  template <int I>
  __device__ __forceinline__ void edge() {
    constexpr int kStep = I / kChunk;
    if constexpr (I % kChunk == 0) {
      pruning::cp_async_wait_one();  // this step's group has landed (this thread's part)
      __syncthreads();               // ... and every other thread's
      stage<kStep + 2>();            // into the stage the last step read
    }
    pruning::row_edge<S, kL, 1>(w, at, edge_src(I), edge_dst(I),
                                stage_at(kStep % kPStages), I % kChunk, acc,
                                e);
  }

  template <int... I>
  __device__ __forceinline__ void walk(std::integer_sequence<int, I...>) {
    (edge<I>(), ...);
  }
};

template <int kL>
__global__ void __launch_bounds__(kThreads)
pruning_static_kernel(const pruning::RowWalk w) {
  StaticWalk<kL> walk(w);
  walk.template stage<0>();
  walk.template stage<1>();
  walk.walk(std::make_integer_sequence<int, kNEdges>{});
}

template <int kL>
int launch_static(const pruning::RowWalk& w, int B, cudaStream_t stream) {
  if constexpr (kUnrolled) {
    auto kernel = pruning_static_kernel<kL>;
    const size_t smem = pruning::row_smem_bytes(
        S, w.cols, kChunk, w.stage_leaves, w.smem_rows, 1);
    const int err = pruning::grant_smem(kernel, smem);
    if (err) return err;
    const dim3 grid((w.sites + w.cols - 1) / w.cols, w.K, B);
    kernel<<<grid, w.cols * kL, smem, stream>>>(w);
    return static_cast<int>(cudaGetLastError());
  } else {  // past the budget: the live-row kernel over `eword`
    return pruning::launch_row_kernel<S, kL, 1>(w, B, stream);
  }
}

}  // namespace

// This object's lane count: ops/_build.py compiles this file once per lane
// count that row_geometry can pick (1, 2, 4 at 4 states; 1, 2 at 20; 2, 4
// at 64, where every tree's walk is past kUnrolled), one
// nvcc each, all at once, and links the objects into the topology's library.
#ifndef PRUNING_STATIC_LANES
#error "compile with -DPRUNING_STATIC_LANES=1, 2 or 4 (ops/_build.py does)"
#endif
#define PRUNING_STATIC_ENTRY_(k) pruning_static_f32_l##k
#define PRUNING_STATIC_ENTRY(k) PRUNING_STATIC_ENTRY_(k)

// pruning_static_f32_l<lanes>: the live-row walk of this library's
// topology with every edge's word a constant (past kUnrolled, read from
// `eword`), `lanes` lanes a column. Arguments as pruning_forward_f32's
// (csrc/pruning_forward.cu): `edges` and `eword` the walk on the device
// (SlotSchedule.rows, the walk compiled in), rows [0, smem_rows) in shared memory, the
// others in spill (B, K, n_rows - smem_rows, sites, S) and spill_e (B, K,
// n_rows - smem_rows, sites) (null when none), root (B, K, sites, S),
// root_e (B, K, sites), leaf_batch as pruning_forward_f32's. Launch on
// `stream`; returns cudaGetLastError() after the launch (0 = ok), the
// error of granting the shared memory, or cudaErrorInvalidValue without
// launching when the walk, the states, the step, the lanes or the leaves'
// stride are not the ones this object was compiled for.
extern "C" int PRUNING_STATIC_ENTRY(PRUNING_STATIC_LANES)(
    const void* p, const void* leaves, const void* edges, const void* eword,
    void* spill, void* spill_e, void* root, void* root_e, int B, int K, int s,
    int n_nodes, int n_leaves, int n_edges, int sites, int n_rows,
    int smem_rows, int lanes, int cols, int chunk, int stage_leaves,
    void* stream, long long leaf_batch) {
  const pruning::RowWalk w{
      static_cast<const float*>(p),   static_cast<const float*>(leaves),
      static_cast<const int*>(edges), static_cast<const int2*>(eword),
      static_cast<float*>(spill),     static_cast<float*>(spill_e),
      static_cast<float*>(root),      static_cast<float*>(root_e),
      K, n_nodes, n_leaves, n_edges, sites,
      n_rows, smem_rows, cols, chunk, stage_leaves,
      pruning::leaf_rows_of(leaf_batch, B, sites, s)};
  if (!pruning::row_launch_ok(w, B, lanes, 1) || s != topo::kS ||
      n_nodes != topo::kNNodes || n_leaves != topo::kNLeaves ||
      n_edges != kNEdges || n_rows != topo::kNRows || chunk != kChunk ||
      lanes != PRUNING_STATIC_LANES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_static<PRUNING_STATIC_LANES>(w, B,
                                              static_cast<cudaStream_t>(stream));
}
