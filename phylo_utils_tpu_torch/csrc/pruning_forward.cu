// Felsenstein pruning forward walk for NVIDIA Hopper (sm_90a): the value
// walk (pruning_forward_f32, B1) and the walk that keeps every node's partials
// as residuals for the gradient (pruning_saveall_f32, B2).
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
// turns the count into ln units (x ln 2) in float64. Layouts, sites minor and
// states innermost: leaves (n_leaves, sites, S), the JAX function's own;
// root (B, K, sites, S), root_e (B, K, sites). Compiled for S = 4 (DNA),
// S = 20 (protein) and S = 64 (codon's 61 or 60 states, and every count
// from 21 to 63, padded with zero states by ops/cuda_pruning.py); the entry
// points refuse any other count. At 64 states two or four lanes share a
// column (16 or 32 rows a lane beside the child's 64-entry row in
// registers), and a stage of P is 16 KB an edge.
//
// What bounded its first body, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md section 6): one thread a column walked the tree with every
// internal node's row in a (B, K, n_inner, sites, S) device scratch that its
// parent read back from L2, and read P through L1, one load per FMA. At the
// flagship B = 1 its grid was (4, 4, 1), 16 blocks on 132 SMs, and its
// device time (45-56 us) one chain of 63 dependent L2 round trips; 0.2389 ms
// at B = 64 (8% of its bound); 12.68 ms at 512 taxa x 8192 LG patterns (3%).
//
// Its body now is csrc/pruning_rows.cuh's live-row walk, shared with B4. It
// keeps B1's level post-order (WalkSchedule.order); a free list over that
// order gives each internal node a row that is live only until its parent
// is combined (WalkSchedule.rows: 24 rows at the flagship, not 63), and the
// rows live in shared memory, all of them in device memory where they do
// not fit a block at 32 columns. P is staged two steps of edges ahead (B2's
// ring by chunks of edges, 16-byte broadcast reads), and at 4 states in a
// launch of few columns the leaf rows too; lanes (up to 4 at 4 states, 2
// at 20), columns a block and the step come from the launch's shape
// (ops/cuda_pruning.py::row_geometry), so that the flagship B = 1 launch
// spreads over 128 blocks. Per node the arithmetic is the first body's, so
// the roots keep its bits, which B2's root row, B4, B5, B8 and B9 are held
// to.
//
// What bounds it now, measured in turns against the first body on the same
// card (kernel_turns.py, PERF.md section 6): at 20 states config 4 takes
// 0.092 ms (0.484 before), 512-taxon LG with every row in device memory
// 1.76 ms (12.8 before); at the flagship B = 1, 41 us of device time (54
// before): one warp a scheduler walks a chain of ~60 dependent
// instructions an edge (SASS), so instruction latency, not memory, bounds
// it; B = 64 is unchanged (0.236 ms), its 24 rows a column costing the
// warps that B4's 4 slots leave free.
//
// pruning_saveall_f32 replaces the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_saveall_kernel: the same
// walk, keeping every internal node's rescaled partials and exponent count,
// the root's included, as the residuals of the reverse walks
// (csrc/pruning_reverse.cu, csrc/pruning_classic_reverse.cu). The residuals
// are (B, K, n_inner, sites, S) and (B, K, n_inner, sites), indexed by node
// id - n_leaves; leaves are not copied (the reverse walks read the leaf
// array). Each thread moves whole aligned 16-byte vectors per node and a
// warp touches contiguous rows. It runs on every gradient call, and at 20
// states its first version (B1's first body, P read one entry at a time
// through L1: one load per FMA) took 12.46 ms at 512 taxa x 8192 LG
// patterns against a 0.52 ms bound (NVIDIA H100 80GB HBM3, 700 W). Its own
// body:
// - Every thread of a block walks the same post-order, so the block stages
//   the children's P blocks in shared memory two steps ahead, in a
//   kPStages-deep cp.async ring with one barrier a step, and reads them as
//   16-byte broadcast vectors (p_vec): one load per four FMAs.
// - A step is a chunk of `chunk` edges of the walk: the children of the
//   nodes in walk order, flattened (`edges`), so a step may end inside a
//   node or span several. The ring, kPStages x chunk x S x S floats, does
//   not grow with the widest node, so a node of any number of children
//   runs, and one barrier serves several nodes where their children are
//   few (ops/cuda_pruning.py::saveall_stage sizes it).
// - `lanes` adjacent lanes share a column (1 or 2): lane h forms rows
//   [h S / lanes, (h + 1) S / lanes), and the rescale's max takes one exact
//   shuffle (as pruning_stream_f32 at 20 states), which doubles the warps in
//   flight where a launch has about one block an SM.
// - Threads past the last site stay in the loop for the barriers and
//   store nothing.
// - At 64 states four lanes share a column, forming rows r 4 + h of P
//   staged with rows 68 floats apart (no bank conflict among the four),
//   and the child's row streams from device memory as 16-byte vectors (64
//   of them in registers beside the accumulators spilled); 2 edges a step.
// Every row's fmaf chain keeps its j order and the children their order, so
// the residuals are bit for bit the forward's arithmetic: the root row
// equals pruning_forward_f32's root.
//
// What bounds it now, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (kernel_turns.py, PERF.md section 6): at 20 states its SASS reads P as
// one LDS.128 per four FFMA where the first version read one LDG per FFMA;
// 1.73 ms at 512 taxa x 8192 LG patterns (30% of its bytes bound, the
// 1.41 GB of residuals; 11.6 ms before), 0.26 ms on a root of 49 children
// (1.73 before). At 4 states bytes bound it and P was never the limit:
// 0.248 ms at the flagship's B = 64 (40% of its bound; 0.228 before, with
// 32 registers to this body's 48), and less device time at B = 1 (44
// against 56 us).

#include "pruning_rows.cuh"

namespace {

using pruning::kThreads;

// The saveall walk (B2): kL lanes a column, P staged in shared memory by
// chunks of `chunk` children of the walk (see the header).
template <int S, int kL>
__global__ void __launch_bounds__(kThreads)
pruning_saveall_kernel(const float* __restrict__ p,         // (B, n_nodes, K, S, S)
                       const float* __restrict__ leaves,    // (n_leaves, sites, S)
                       const int* __restrict__ order,       // (n_int,)
                       const int* __restrict__ edges,       // (n_edges,)
                       const int* __restrict__ counts,      // (n_int,)
                       float* __restrict__ res_x,           // (B, K, n_inner, sites, S)
                       float* __restrict__ res_e,           // (B, K, n_inner, sites)
                       int K, int n_nodes, int n_leaves, int n_int, int n_edges,
                       int sites, int chunk) {
  constexpr int kRows = S / kL;   // rows a lane forms
  static_assert(S % kL == 0 && kRows % 2 == 0,
                "a lane's rows are stored as 8-byte vectors");
  constexpr int kBlockVecs = S * S / 4;  // 16-byte vectors per P block
  constexpr int kBlock = pruning::p_block<S>();  // floats of a staged P block
  extern __shared__ float4 p_stage_vec[];  // (kPStages, chunk, S, p_row<S>)
  float* p_stage = reinterpret_cast<float*>(p_stage_vec);
  const int h = threadIdx.x % kL;
  const int site = blockIdx.x * (kThreads / kL) + threadIdx.x / kL;
  const bool live = site < sites;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ xs = res_x + bk * n_inner * sites * S;
  float* __restrict__ es = res_e + bk * n_inner * sites;
  const float* __restrict__ pb = p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  const int stage_floats = chunk * kBlock;

  // step t stages the P blocks of edges [t chunk, (t + 1) chunk): the
  // children of the walk's nodes in walk order, so a step may end inside
  // a node or span several
  int staged = 0;
  auto stage_next = [&]() {
    const int f0 = staged * chunk;
    const int n = min(chunk, n_edges - f0);
    float* dst = p_stage + (staged % pruning::kPStages) * stage_floats;
    for (int v = threadIdx.x; v < n * kBlockVecs; v += kThreads) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;
      const int child = __ldg(edges + f0 + c);
      pruning::cp_async16(dst + c * kBlock + pruning::p_stage_offset<S>(q),
                          pb + child * p_node_stride + 4 * q);
    }
    ++staged;
    pruning::cp_async_commit();
  };
  stage_next();
  stage_next();

  int f = 0;             // the next edge
  int step = -1;         // the step whose stage holds edge f
  int in_step = chunk;   // edges of that step already read
  const float* p_now = p_stage;
  for (int i = 0; i < n_int; ++i) {
    const int node = __ldg(order + i);
    const int cnt = __ldg(counts + i);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 1.0f;
    float e = 0.0f;
    for (int c = 0; c < cnt; ++c, ++f, ++in_step) {
      if (in_step == chunk) {
        pruning::cp_async_wait_one();  // the next step's group has landed (this thread's part)
        __syncthreads();               // ... and every other thread's
        stage_next();                  // into the stage the last step read
        ++step;
        p_now = p_stage + (step % pruning::kPStages) * stage_floats;
        in_step = 0;
      }
      const int child = __ldg(edges + f);
      const float* pm = p_now + in_step * kBlock;
      if constexpr (S == 64) {
        // the child's row streamed as 16-byte vectors: 64 entries held
        // beside a lane's accumulators spilled (ptxas, 12 bytes); each
        // row's fmaf chain stays in j order, so the bits are B1's
        float y[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) y[r] = 0.0f;
        if (live) {
          const float* src;
          if (child < n_leaves) {
            src = leaves + (static_cast<size_t>(child) * sites + site) * S;
          } else {
            const size_t row = static_cast<size_t>(child - n_leaves) * sites + site;
            src = xs + row * S;
            e += es[row];
          }
#pragma unroll 4
          for (int q = 0; q < S / 4; ++q) {
            const float4 xv = reinterpret_cast<const float4*>(src)[q];
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
      if (live) {
        if (child < n_leaves) {
          pruning::load_states<S>(leaves + (static_cast<size_t>(child) * sites + site) * S, x);
        } else {
          const size_t row = static_cast<size_t>(child - n_leaves) * sites + site;
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
    if (live) {
      const size_t row = static_cast<size_t>(node - n_leaves) * sites + site;
      if constexpr (S == 64) {  // the lane's rows r kL + h (lane_row)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          xs[row * S + pruning::lane_row<S, kL>(h, r)] = acc[r];
        }
      } else if constexpr (kL == 1) {
        pruning::store_states<S>(xs + row * S, acc);
      } else {
#pragma unroll
        for (int q = 0; q < kRows / 2; ++q) {
          reinterpret_cast<float2*>(xs + row * S + h * kRows)[q] =
              make_float2(acc[2 * q], acc[2 * q + 1]);
        }
      }
      if (h == 0) es[row] = e;
    }
    if constexpr (kL > 1) {
      __syncwarp();  // the column's row is whole before a lane reads it
    }
  }
}

}  // namespace

// The value walk over B1's live rows (csrc/pruning_rows.cuh). `edges`
// (n_edges,) holds the children of order[0], then of order[1], ...,
// counts[i] each; eword (n_edges + 1,) one int2 an edge: .x the child's row
// (-1 - leaf for a leaf), .y -2 or, on a node's last child, the row the
// node writes (-1: the root); the last entry is read ahead and not used.
// Rows [0, smem_rows) live in shared memory, the others in spill (B, K,
// n_rows - smem_rows, sites, S) and spill_e (B, K, n_rows - smem_rows,
// sites) (null when none). `lanes` lanes a column, `cols` columns a block,
// `chunk` edges a step, leaf rows staged in shared memory (stage_leaves)
// or read from device memory. Launch on `stream`; returns
// cudaGetLastError() after the launch (0 = ok), the error of granting the
// shared memory, or cudaErrorInvalidValue without launching for a geometry
// that is not compiled. S is 4, 20 or 64 (lanes 2 or 4 at 64).
extern "C" int pruning_forward_f32(const void* p, const void* leaves,
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

// The forward walk keeping every internal node, the root included, in
// res_x (B, K, n_nodes - n_leaves, sites, S) / res_e (B, K, n_nodes -
// n_leaves, sites), indexed by node id - n_leaves. `edges` (n_edges,) holds
// the children of order[0], then of order[1], ..., counts[i] each. P is
// staged in shared memory by chunks of `chunk` edges (kPStages x chunk x
// S x S floats of dynamic shared memory, ops/cuda_pruning.py::
// saveall_stage), with `lanes` lanes a column: 1 or 2 at S = 4 and 20, 2
// or 4 at S = 64. Returns cudaGetLastError() after the launch (0 = ok), the
// error of granting the shared memory, or cudaErrorInvalidValue without
// launching for a lane or state count that is not compiled. S is 4, 20 or
// 64.
extern "C" int pruning_saveall_f32(const void* p, const void* leaves,
                                   const void* order, const void* edges,
                                   const void* counts, void* res_x,
                                   void* res_e, int B, int K, int S,
                                   int n_nodes, int n_leaves, int n_int,
                                   int n_edges, int sites, int chunk,
                                   int lanes, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    const auto launch = [&](auto kernel, int per_block) {
      const size_t smem = static_cast<size_t>(pruning::kPStages) * chunk *
                          pruning::p_block<kS>() * sizeof(float);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      const dim3 grid((sites + per_block - 1) / per_block, K, B);
      kernel<<<grid, kThreads, smem, st>>>(
          static_cast<const float*>(p), static_cast<const float*>(leaves),
          static_cast<const int*>(order), static_cast<const int*>(edges),
          static_cast<const int*>(counts), static_cast<float*>(res_x),
          static_cast<float*>(res_e), K, n_nodes, n_leaves, n_int, n_edges,
          sites, chunk);
      return static_cast<int>(cudaGetLastError());
    };
    if constexpr (kS == 64) {   // 64 accumulators a lane would cost warps
      if (lanes == 2) return launch(pruning_saveall_kernel<kS, 2>, kThreads / 2);
      if (lanes == 4) return launch(pruning_saveall_kernel<kS, 4>, kThreads / 4);
    } else {
      if (lanes == 1) return launch(pruning_saveall_kernel<kS, 1>, kThreads);
      if (lanes == 2) return launch(pruning_saveall_kernel<kS, 2>, kThreads / 2);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
