// The live-row walk of the value path, for NVIDIA Hopper (sm_90a): the body
// of B1 (pruning_forward_f32, csrc/pruning_forward.cu) and of B4
// (pruning_slot_f32, csrc/pruning_slot.cu). The two differ only in the walk
// they are given: B1 the level post-order of ops/cuda_pruning.py::
// WalkSchedule with live rows from a free list (WalkSchedule.rows), B4 the
// DFS post-order with its O(depth) slots (SlotSchedule.rows).
//
// A walk is a list of internal nodes in post-order (the root last), given
// as the flat list of their children in walk order (`edges`, child node
// ids, leaves below n_leaves) and one word per edge (`eword`): .x the
// child's row, or -1 - leaf for a leaf; .y -2, or, on a node's last child,
// the row the node writes after every child was read (it may be a child's
// row), -1 for the root. Per (batch b, category k, site) column the walk
// computes what pruning_forward_f32 always computed:
//     y_c = P_c . x_c            for each child c, in order,
//     x_n = prod_c y_c,
//     m   = max(max_i x_n[i], FLT_MIN),  x_n *= 2^-floor(log2 m),
//     e_n = sum_c e_c + floor(log2 m)    (an exact integer count, in f32),
// each row's fmaf chain in j order, so the roots are bit for bit the same
// whatever walk, geometry or row placement a launch takes.
//
// Design:
// - Rows on the SM. A column's rows and exponents live in dynamic shared
//   memory, indexed by (row, column): rows [0, smem_rows) there, rows
//   [smem_rows, n_rows) in device memory (`spill`, (B, K, n_rows -
//   smem_rows, sites, S) and its exponents), in the same kernel. Every
//   thread of a block reads the same row id, so the branch is uniform. Only
//   a column's own lanes read its rows, so the rows need no block barrier.
// - P and leaf rows fetched ahead. The walk's edges are taken in steps of
//   `chunk` edges (a step may end inside a node or span several, so a node
//   of any number of children runs). Two steps ahead, the block copies the
//   step's P blocks into a kPStages-deep ring in shared memory (cp.async,
//   bypassing L1), as B2 stages P (csrc/pruning_forward.cu), and, with
//   `stage_leaves`, each column its leaf rows of the step's leaf edges; one
//   barrier a step publishes a stage and frees the one two steps back. P is
//   read back as 16-byte broadcast vectors. Without `stage_leaves` a leaf
//   row is read from device memory when its edge comes: the ring's leaf
//   rows cost shared memory a column, which a launch of many columns needs
//   for warps (ops/cuda_pruning.py::row_geometry decides).
// - One flat loop over the edges: one 8-byte word an edge, read one edge
//   ahead; a node's rescale and store run on its last child's edge.
// - kL adjacent lanes own a column: lane h forms rows [h S / kL, (h + 1) S /
//   kL) and the rescale's max takes exact shuffles, so a launch of few
//   columns (B = 1) still puts several warps on every SM. The lanes pass
//   __syncwarp after reading the children, before a lane writes a row that
//   may be a child's, and again after writing it.
// - `cols` columns (sites) of one (b, k) a block, cols x kL threads; the
//   host (ops/cuda_pruning.py::row_geometry) picks kL, cols, chunk,
//   stage_leaves and smem_rows from the launch's shape. Threads past the
//   last site stay in the loop for the barriers and load from device memory
//   and store nothing.
#pragma once

#include "pruning_common.cuh"

namespace pruning {
namespace {

// The buffers and sizes of one live-row launch (passed by value).
struct RowWalk {
  const float* p;        // (B, n_nodes, K, S, S)
  const float* leaves;   // (n_leaves, sites, S)
  const int* edges;      // (n_edges,) children of the walk's nodes, in order
  const int2* eword;     // (n_edges + 1,) {child's row or -1 - leaf, row out}
  float* spill;          // (B, K, n_rows - smem_rows, sites, S)
  float* spill_e;        // (B, K, n_rows - smem_rows, sites)
  float* root;           // (B, K, sites, S)
  float* root_e;         // (B, K, sites)
  int K, n_nodes, n_leaves, n_edges, sites;
  int n_rows, smem_rows, cols, chunk, stage_leaves;
};

// Floats of one ring stage: the step's P blocks and, with stage_leaves, its
// leaf rows for every column of the block.
__host__ __device__ int row_stage_floats(int s, int cols, int chunk,
                                         int stage_leaves) {
  return chunk * s * s + (stage_leaves ? chunk * cols * s : 0);
}

// Dynamic shared memory of one block: the ring, then smem_rows rows of S
// floats and their exponents for each of `cols` columns.
size_t row_smem_bytes(int s, int cols, int chunk, int stage_leaves,
                      int smem_rows) {
  return sizeof(float) *
         (static_cast<size_t>(kPStages) *
              row_stage_floats(s, cols, chunk, stage_leaves) +
          static_cast<size_t>(smem_rows) * cols * (s + 1));
}

// A lane's kRows entries of a row, stored as the widest vectors they allow.
template <int kRows>
__device__ __forceinline__ void store_part(float* dst, const float (&v)[kRows]) {
  if constexpr (kRows % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else if constexpr (kRows % 2 == 0) {
#pragma unroll
    for (int q = 0; q < kRows / 2; ++q) {
      reinterpret_cast<float2*>(dst)[q] = make_float2(v[2 * q], v[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) dst[r] = v[r];
  }
}

template <int S, int kL>
__global__ void __launch_bounds__(kThreads) row_walk_kernel(const RowWalk w) {
  constexpr int kRows = S / kL;          // rows a lane forms
  constexpr int kVecs = S / 4;           // 16-byte vectors of a row
  constexpr int kBlockVecs = S * S / 4;  // 16-byte vectors of a P block
  static_assert(S % 4 == 0 && S % kL == 0, "rows are whole 16-byte vectors");
  extern __shared__ float4 row_smem_vec[];
  float* smem = reinterpret_cast<float*>(row_smem_vec);
  const int cols = w.cols;
  const int chunk = w.chunk;
  const int h = threadIdx.x % kL;
  const int col = threadIdx.x / kL;
  const int site = blockIdx.x * cols + col;
  const bool live = site < w.sites;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * w.K + k;
  const float* __restrict__ pb =
      w.p + (static_cast<size_t>(b) * w.n_nodes * w.K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(w.K) * S * S;
  const int p_floats = chunk * S * S;
  const int stage_floats = row_stage_floats(S, cols, chunk, w.stage_leaves);
  float* rows = smem + kPStages * stage_floats;          // (smem_rows, cols, S)
  float* rows_e = rows + w.smem_rows * cols * S;         // (smem_rows, cols)
  const size_t n_spill = static_cast<size_t>(w.n_rows - w.smem_rows);
  float* spill = n_spill ? w.spill + bk * n_spill * w.sites * S : nullptr;
  float* spill_e = n_spill ? w.spill_e + bk * n_spill * w.sites : nullptr;
  const float* leaf_col = w.leaves + static_cast<size_t>(site) * S;
  const size_t leaf_stride = static_cast<size_t>(w.sites) * S;

  // step t stages edges [t chunk, (t + 1) chunk) into stage t % kPStages
  int staged = 0;
  auto stage_next = [&]() {
    const int f0 = staged * chunk;
    const int n = max(0, min(chunk, w.n_edges - f0));
    float* dst = smem + (staged % kPStages) * stage_floats;
    for (int v = threadIdx.x; v < n * kBlockVecs; v += blockDim.x) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;
      const int child = __ldg(w.edges + f0 + c);
      cp_async16(dst + c * S * S + 4 * q, pb + child * p_node_stride + 4 * q);
    }
    if (w.stage_leaves && live) {  // the column's lanes share its copies
      float* leaf_dst = dst + p_floats + col * S;
#pragma unroll 4
      for (int v = h; v < n * kVecs; v += kL) {
        const int c = v / kVecs;
        const int q = v - c * kVecs;
        const int child = __ldg(w.edges + f0 + c);
        if (child < w.n_leaves) {
          cp_async16(leaf_dst + c * cols * S + 4 * q,
                     leaf_col + static_cast<size_t>(child) * leaf_stride + 4 * q);
        }
      }
    }
    ++staged;
    cp_async_commit();
  };
  stage_next();
  stage_next();

  int step = -1;        // the step whose stage holds the edge
  int in_step = chunk;  // edges of that step already read
  const float* stage_now = smem;
  int2 next = __ldg(w.eword);  // the next edge's word, read one edge ahead
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 1.0f;
  float e = 0.0f;
  for (int f = 0; f < w.n_edges; ++f, ++in_step) {
    if (in_step == chunk) {
      cp_async_wait_one();  // the next step's group has landed (this thread's part)
      __syncthreads();      // ... and every other thread's
      stage_next();         // into the stage the last step read
      ++step;
      stage_now = smem + (step % kPStages) * stage_floats;
      in_step = 0;
    }
    const int2 word = next;
    next = __ldg(w.eword + f + 1);
    // a column past the last site reads its unwritten ring and rows,
    // nothing from device memory, and stores nothing
    float x[S];
    if (word.x < 0) {  // a leaf
      if (w.stage_leaves) {
        load_states<S>(stage_now + p_floats + (in_step * cols + col) * S, x);
      } else if (live) {
        load_states<S>(leaf_col + static_cast<size_t>(-1 - word.x) * leaf_stride, x);
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) x[j] = 0.0f;
      }
    } else if (word.x < w.smem_rows) {
      load_states<S>(rows + (word.x * cols + col) * S, x);
      e += rows_e[word.x * cols + col];
    } else if (live) {
      const size_t g = static_cast<size_t>(word.x - w.smem_rows) * w.sites + site;
      load_states<S>(spill + g * S, x);
      e += spill_e[g];
    } else {
#pragma unroll
      for (int j = 0; j < S; ++j) x[j] = 0.0f;
    }
    // acc[r] *= (P x)[h kRows + r], the fmaf chain in j order
    const float* pm = stage_now + in_step * S * S;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float y = 0.0f;
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const float4 v = p_vec<S>(pm, h * kRows + r, q);
        y = fmaf(v.x, x[4 * q], y);
        y = fmaf(v.y, x[4 * q + 1], y);
        y = fmaf(v.z, x[4 * q + 2], y);
        y = fmaf(v.w, x[4 * q + 3], y);
      }
      acc[r] *= y;
    }
    if (word.y == -2) continue;  // more children of this node follow
    // the node's last child: rescale_pow2 over the column's S rows (the
    // max over the kL lanes' rows by exact shuffles), then store
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
      __syncwarp();  // every lane read the children (perhaps the row below)
    }
    if (word.y < 0) {  // the root
      if (live) {
        const size_t g = bk * w.sites + site;
        store_part<kRows>(w.root + g * S + h * kRows, acc);
        if (h == 0) w.root_e[g] = e;
      }
    } else if (word.y < w.smem_rows) {
      store_part<kRows>(rows + (word.y * cols + col) * S + h * kRows, acc);
      if (h == 0) rows_e[word.y * cols + col] = e;
    } else if (live) {
      const size_t g = static_cast<size_t>(word.y - w.smem_rows) * w.sites + site;
      store_part<kRows>(spill + g * S + h * kRows, acc);
      if (h == 0) spill_e[g] = e;
    }
    if constexpr (kL > 1) {
      __syncwarp();  // the row is whole before a lane reads it
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 1.0f;
    e = 0.0f;
  }
}

template <int S, int kL>
int launch_row_kernel(const RowWalk& w, int B, cudaStream_t stream) {
  auto kernel = row_walk_kernel<S, kL>;
  const size_t smem =
      row_smem_bytes(S, w.cols, w.chunk, w.stage_leaves, w.smem_rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w.sites + w.cols - 1) / w.cols, w.K, B);
  kernel<<<grid, w.cols * kL, smem, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// Launches the live-row walk `w` over B batch elements with `lanes` lanes a
// column on `stream`. Compiled for lanes 1, 2, 4 at S = 4 and 1, 2 at S =
// 20; any other, or a block of other than 32 to kThreads threads in whole
// warps, returns cudaErrorInvalidValue without launching.
int launch_rows(const RowWalk& w, int B, int S, int lanes, void* stream) {
  const int threads = w.cols * lanes;
  if (B <= 0 || w.K <= 0 || w.sites <= 0 || w.n_edges <= 0 ||
      w.cols <= 0 || w.chunk <= 0 || threads > kThreads || threads % 32 ||
      w.smem_rows < 0 || w.smem_rows > w.n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    if (lanes == 1) return launch_row_kernel<kS, 1>(w, B, st);
    if (lanes == 2) return launch_row_kernel<kS, 2>(w, B, st);
    if constexpr (kS == 4) {
      if (lanes == 4) return launch_row_kernel<kS, 4>(w, B, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

}  // namespace
}  // namespace pruning
