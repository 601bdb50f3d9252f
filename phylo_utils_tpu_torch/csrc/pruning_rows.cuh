// The live-row walk of the value path, for NVIDIA Hopper (sm_90a): the body
// of B1 (pruning_forward_f32, csrc/pruning_forward.cu), of B4
// (pruning_slot_f32, csrc/pruning_slot.cu) and of B9 (pruning_fold_f32,
// csrc/pruning_fold.cu), whose helpers B8 (csrc/pruning_static.cu) shares.
// B1 and B4 differ only in the walk they are given: B1 the level post-order
// of ops/cuda_pruning.py::WalkSchedule with live rows from a free list
// (WalkSchedule.rows), B4 the DFS post-order with its O(depth) slots
// (SlotSchedule.rows). B9 walks B4's slots with F categories a column.
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
// whatever walk, geometry, fold or row placement a launch takes.
//
// Design:
// - Rows on the SM. A column's rows and exponents live in dynamic shared
//   memory, indexed by (row, f, column) for the F categories a column
//   walks (F = 1 but in B9): rows [0, smem_rows) there, rows [smem_rows,
//   n_rows) in device memory (`spill`, (B, K, n_rows - smem_rows, sites,
//   S) and its exponents), in the same kernel. Every thread of a block
//   reads the same row id, so the branch is uniform. Only a column's own
//   lanes read its rows, so the rows need no block barrier.
// - P and leaf rows fetched ahead. The walk's edges are taken in steps of
//   `chunk` edges (a step may end inside a node or span several, so a node
//   of any number of children runs). Two steps ahead, the block copies the
//   step's P blocks (F of them an edge, contiguous in P) into a
//   kPStages-deep ring in shared memory (cp.async, bypassing L1), as B2
//   stages P (csrc/pruning_forward.cu), and, with `stage_leaves`, each
//   column its leaf rows of the step's leaf edges; one barrier a step
//   publishes a stage and frees the one two steps back. P is read back as
//   16-byte broadcast vectors. Without `stage_leaves` a leaf row is read
//   from device memory when its edge comes: the ring's leaf rows cost
//   shared memory a column, which a launch of many columns needs for warps
//   (ops/cuda_pruning.py::row_geometry decides).
// - One flat loop over the edges: one 8-byte word an edge, read one edge
//   ahead; a node's rescale and store run on its last child's edge.
// - F categories a column (B9): the column walks categories gF ... gF + F -
//   1 of one (b, site); a leaf row is read once and applied to all F, each
//   category keeps its own accumulators, exponent and rescale, and its
//   fmaf chains in j order.
// - kL adjacent lanes own a column: lane h forms rows [h S / kL, (h + 1) S /
//   kL) of every category (at 64 states rows r kL + h, from P staged with
//   rows 68 floats apart: pruning_common.cuh's lane_row and p_row), so a
//   lane holds F S / kL accumulators, and the rescale's max takes exact
//   shuffles; a launch of few columns (B = 1)
//   still puts several warps on every SM. The lanes pass __syncwarp after
//   reading the children, before a lane writes a row that may be a
//   child's, and again after writing it.
// - One body: row_place gives a thread its place (RowPlace), row_edge runs
//   one edge; row_walk_kernel loops over the edges' words around them, B8
//   (csrc/pruning_static.cu) unrolls the walk with constant words.
// - `cols` columns (sites) of one (b, category group) a block, cols x kL
//   threads; the host (ops/cuda_pruning.py::row_geometry) picks kL, cols,
//   chunk, stage_leaves and smem_rows from the launch's shape. Threads
//   past the last site stay in the loop for the barriers and load from
//   device memory and store nothing.
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

// Floats of one ring stage: the step's P blocks, `fold` a edge (rows
// p_row apart: s + 4 at 64 states), and, with stage_leaves, its leaf rows
// for every column of the block.
__host__ __device__ int row_stage_floats(int s, int cols, int chunk,
                                         int stage_leaves, int fold) {
  const int p_rows = s == 64 ? s + 4 : s;   // p_row<s>()
  return chunk * fold * s * p_rows + (stage_leaves ? chunk * cols * s : 0);
}

// Dynamic shared memory of one block: the ring, then smem_rows rows of S
// floats and their exponents for each of `fold` categories of `cols`
// columns (ops/cuda_pruning.py::row_smem_bytes is its twin).
size_t row_smem_bytes(int s, int cols, int chunk, int stage_leaves,
                      int smem_rows, int fold) {
  return sizeof(float) *
         (static_cast<size_t>(kPStages) *
              row_stage_floats(s, cols, chunk, stage_leaves, fold) +
          static_cast<size_t>(smem_rows) * fold * cols * (s + 1));
}

// A lane's kRows = S / kL entries of a row (lane_row's rows of the row
// `dst`): the widest vectors they allow, interleaved scalars at 64 states.
template <int S, int kL>
__device__ __forceinline__ void store_lane(float* dst, int h,
                                           const float (&v)[S / kL]) {
  if constexpr (S == 64) {
#pragma unroll
    for (int r = 0; r < S / kL; ++r) dst[lane_row<S, kL>(h, r)] = v[r];
  } else {
    store_part<S / kL>(dst + h * (S / kL), v);
  }
}

// acc[r] *= (P x)[lane_row(h, r)] for the kRows rows lane h forms, P an
// S x S block staged in shared memory: each row's fmaf chain in j order.
template <int S, int kRows>
__device__ __forceinline__ void times_rows(const float* pm, int h,
                                           const float (&x)[S],
                                           float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float y = 0.0f;
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 v = p_vec<S>(pm, lane_row<S, S / kRows>(h, r), q);
      y = fmaf(v.x, x[4 * q], y);
      y = fmaf(v.y, x[4 * q + 1], y);
      y = fmaf(v.z, x[4 * q + 2], y);
      y = fmaf(v.w, x[4 * q + 3], y);
    }
    acc[r] *= y;
  }
}

// rescale_pow2 over a column's S rows, kRows in each of its kL lanes: the
// max over the lanes' rows by exact shuffles, then the same scale; returns
// the exponent.
template <int kL, int kRows>
__device__ __forceinline__ float rescale_rows(float (&acc)[kRows]) {
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
  return static_cast<float>(eb - 127);
}

// Where one thread of a live-row launch reads and writes, for the F
// categories its column walks (row_place below builds it, for
// row_walk_kernel and for B8, csrc/pruning_static.cu).
struct RowPlace {
  float* rows;            // (smem_rows, F, cols, S) in shared memory
  float* rows_e;          // (smem_rows, F, cols)
  float* spill;           // category k0's spilled rows; k0 + c's from
  float* spill_e;         //   + c n_spill sites S (and + c n_spill sites)
  const float* leaf_col;  // leaf 0's row at the column's site
  size_t leaf_stride;     // one leaf's rows
  size_t bk;              // (b, k0): the column's first category
  size_t n_spill;         // rows in device memory
  int cols, col, site, h;
  int p_floats;           // floats of a stage's P blocks
  bool live;              // site < sites
  float* smem;            // the ring's stage 0
  const float* __restrict__ pb;  // P of (b, node 0, k0): + node
                                 // p_node_stride + c S S
  size_t p_node_stride;
  int stage_floats;       // floats of a ring stage
};

// The place of thread (h, col) of this block in a live-row launch of `w`
// whose ring steps `chunk` edges, F categories a column.
template <int S, int kL, int F>
__device__ __forceinline__ RowPlace row_place(const RowWalk& w, int chunk) {
  extern __shared__ float4 row_smem_vec[];
  RowPlace at;
  at.smem = reinterpret_cast<float*>(row_smem_vec);
  at.cols = w.cols;
  at.h = threadIdx.x % kL;
  at.col = threadIdx.x / kL;
  at.site = blockIdx.x * at.cols + at.col;
  at.live = at.site < w.sites;
  const int k0 = blockIdx.y * F;   // the column's categories k0 ... k0 + F - 1
  const int b = blockIdx.z;
  at.bk = static_cast<size_t>(b) * w.K + k0;
  at.pb = w.p + (static_cast<size_t>(b) * w.n_nodes * w.K + k0) * S * S;
  at.p_node_stride = static_cast<size_t>(w.K) * S * S;
  at.p_floats = chunk * F * p_block<S>();
  at.stage_floats = row_stage_floats(S, at.cols, chunk, w.stage_leaves, F);
  at.rows = at.smem + kPStages * at.stage_floats;
  at.rows_e = at.rows + w.smem_rows * F * at.cols * S;
  at.n_spill = static_cast<size_t>(w.n_rows - w.smem_rows);
  at.spill = at.n_spill ? w.spill + at.bk * at.n_spill * w.sites * S : nullptr;
  at.spill_e = at.n_spill ? w.spill_e + at.bk * at.n_spill * w.sites : nullptr;
  at.leaf_col = w.leaves + static_cast<size_t>(at.site) * S;
  at.leaf_stride = static_cast<size_t>(w.sites) * S;
  return at;
}

// One edge of a column's walk: the child's row (src: its row, or -1 -
// leaf), its product with the child's P blocks in slot in_step of ring
// stage `now`, and on a node's last child (dst != -2) each category's
// rescale and its store to row dst (-1: the root). row_walk_kernel calls it
// in its loop over the edges' words, B8 unrolled with constant words.
template <int S, int kL, int F>
__device__ __forceinline__ void row_edge(const RowWalk& w, const RowPlace& at,
                                         int src, int dst, const float* now,
                                         int in_step,
                                         float (&acc)[F][S / kL],
                                         float (&e)[F]) {
  constexpr int kRows = S / kL;
  const float* pm = now + in_step * F * p_block<S>();
  // a column past the last site reads its unwritten ring and rows,
  // nothing from device memory, and stores nothing
  float x[S];
#pragma unroll
  for (int c = 0; c < F; ++c) {
    if (src < 0) {  // a leaf: one read for the F categories
      if (c == 0) {
        if (w.stage_leaves) {
          load_states<S>(now + at.p_floats + (in_step * at.cols + at.col) * S, x);
        } else if (at.live) {
          load_states<S>(at.leaf_col + static_cast<size_t>(-1 - src) * at.leaf_stride, x);
        } else {
#pragma unroll
          for (int j = 0; j < S; ++j) x[j] = 0.0f;
        }
      }
    } else if (src < w.smem_rows) {
      const int slot = (src * F + c) * at.cols + at.col;
      load_states<S>(at.rows + slot * S, x);
      e[c] += at.rows_e[slot];
    } else if (at.live) {
      const size_t g =
          (c * at.n_spill + (src - w.smem_rows)) * w.sites + at.site;
      load_states<S>(at.spill + g * S, x);
      e[c] += at.spill_e[g];
    } else {
#pragma unroll
      for (int j = 0; j < S; ++j) x[j] = 0.0f;
    }
    times_rows<S, kRows>(pm + c * p_block<S>(), at.h, x, acc[c]);
  }
  if (dst == -2) return;  // more children of this node follow
  // the node's last child: each category's rescale, then its store
#pragma unroll
  for (int c = 0; c < F; ++c) e[c] += rescale_rows<kL, kRows>(acc[c]);
  if constexpr (kL > 1) {
    __syncwarp();  // every lane read the children (perhaps the row below)
  }
#pragma unroll
  for (int c = 0; c < F; ++c) {
    if (dst < 0) {  // the root
      if (at.live) {
        const size_t g = (at.bk + c) * w.sites + at.site;
        store_lane<S, kL>(w.root + g * S, at.h, acc[c]);
        if (at.h == 0) w.root_e[g] = e[c];
      }
    } else if (dst < w.smem_rows) {
      const int slot = (dst * F + c) * at.cols + at.col;
      store_lane<S, kL>(at.rows + slot * S, at.h, acc[c]);
      if (at.h == 0) at.rows_e[slot] = e[c];
    } else if (at.live) {
      const size_t g =
          (c * at.n_spill + (dst - w.smem_rows)) * w.sites + at.site;
      store_lane<S, kL>(at.spill + g * S, at.h, acc[c]);
      if (at.h == 0) at.spill_e[g] = e[c];
    }
  }
  if constexpr (kL > 1) {
    __syncwarp();  // the row is whole before a lane reads it
  }
#pragma unroll
  for (int c = 0; c < F; ++c) {
    e[c] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 1.0f;
  }
}

template <int S, int kL, int F>
__global__ void __launch_bounds__(kThreads) row_walk_kernel(const RowWalk w) {
  constexpr int kRows = S / kL;   // rows a lane forms
  constexpr int kVecs = S / 4;    // 16-byte vectors of a row
  constexpr int kBlockVecs = F * S * S / 4;  // 16-byte vectors of an edge's P
  static_assert(S % 4 == 0 && S % kL == 0, "rows are whole 16-byte vectors");
  const int chunk = w.chunk;
  const RowPlace at = row_place<S, kL, F>(w, chunk);

  // step t stages edges [t chunk, (t + 1) chunk) into stage t % kPStages
  int staged = 0;
  auto stage_next = [&]() {
    const int f0 = staged * chunk;
    const int n = max(0, min(chunk, w.n_edges - f0));
    float* dst = at.smem + (staged % kPStages) * at.stage_floats;
    for (int v = threadIdx.x; v < n * kBlockVecs; v += blockDim.x) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;
      const int child = __ldg(w.edges + f0 + c);
      if constexpr (S == 64) {   // rows p_row apart, F blocks an edge
        cp_async16(dst + c * F * p_block<S>() + (q / (S * S / 4)) * p_block<S>() +
                       p_stage_offset<S>(q % (S * S / 4)),
                   at.pb + child * at.p_node_stride + 4 * q);
      } else {
        cp_async16(dst + c * F * S * S + 4 * q,
                   at.pb + child * at.p_node_stride + 4 * q);
      }
    }
    if (w.stage_leaves && at.live) {  // the column's lanes share its copies
      float* leaf_dst = dst + at.p_floats + at.col * S;
#pragma unroll 4
      for (int v = at.h; v < n * kVecs; v += kL) {
        const int c = v / kVecs;
        const int q = v - c * kVecs;
        const int child = __ldg(w.edges + f0 + c);
        if (child < w.n_leaves) {
          cp_async16(leaf_dst + c * at.cols * S + 4 * q,
                     at.leaf_col + static_cast<size_t>(child) * at.leaf_stride + 4 * q);
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
  const float* stage_now = at.smem;
  int2 next = __ldg(w.eword);  // the next edge's word, read one edge ahead
  float acc[F][kRows];
  float e[F];
#pragma unroll
  for (int c = 0; c < F; ++c) {
    e[c] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 1.0f;
  }
  for (int f = 0; f < w.n_edges; ++f, ++in_step) {
    if (in_step == chunk) {
      cp_async_wait_one();  // the next step's group has landed (this thread's part)
      __syncthreads();      // ... and every other thread's
      stage_next();         // into the stage the last step read
      ++step;
      stage_now = at.smem + (step % kPStages) * at.stage_floats;
      in_step = 0;
    }
    const int2 word = next;
    next = __ldg(w.eword + f + 1);
    row_edge<S, kL, F>(w, at, word.x, word.y, stage_now, in_step, acc, e);
  }
}

// Raises dynamic shared memory past 48 KB for `kernel` where `smem` needs
// it; returns the error of granting it (0 = ok).
template <typename K>
int grant_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int S, int kL, int F>
int launch_row_kernel(const RowWalk& w, int B, cudaStream_t stream) {
  auto kernel = row_walk_kernel<S, kL, F>;
  const size_t smem =
      row_smem_bytes(S, w.cols, w.chunk, w.stage_leaves, w.smem_rows, F);
  const int err = grant_smem(kernel, smem);
  if (err) return err;
  const dim3 grid((w.sites + w.cols - 1) / w.cols, w.K / F, B);
  kernel<<<grid, w.cols * kL, smem, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// Whether a live-row launch of `w` over B batch elements with `lanes` lanes
// and F categories a column is one the kernels take: a block of 32 to
// kThreads threads in whole warps, F dividing K, smem_rows within n_rows.
inline bool row_launch_ok(const RowWalk& w, int B, int lanes, int F) {
  const int threads = w.cols * lanes;
  return B > 0 && w.K > 0 && F > 0 && w.K % F == 0 && w.sites > 0 &&
         w.n_edges > 0 && w.cols > 0 && w.chunk > 0 && threads <= kThreads &&
         threads % 32 == 0 && w.smem_rows >= 0 && w.smem_rows <= w.n_rows;
}

// The lane counts compiled at S (1, 2, 4 at S = 4; 1, 2 at S = 20; 2, 4
// at S = 64, where one lane's 64 accumulators beside its 64-entry child
// row would leave few warps an SM) for F categories a column; any other
// returns cudaErrorInvalidValue. (B9 compiles its own (F, lanes) pairs:
// pruning_fold.cu.)
template <int S, int F>
int launch_lanes(const RowWalk& w, int B, int lanes, cudaStream_t st) {
  if constexpr (S != 64) {
    if (lanes == 1) return launch_row_kernel<S, 1, F>(w, B, st);
  }
  if (lanes == 2) return launch_row_kernel<S, 2, F>(w, B, st);
  if constexpr (S == 4 || S == 64) {
    if (lanes == 4) return launch_row_kernel<S, 4, F>(w, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the live-row walk `w` over B batch elements with `lanes` lanes a
// column, one category a column (B1, B4), on `stream`, at 4, 20 or 64
// states. A launch that row_launch_ok refuses, or a lane count or state
// count that is not compiled, returns cudaErrorInvalidValue without
// launching. (A template, so that a source that does not call it compiles
// none of its kernels.)
template <int F = 1>
int launch_rows(const RowWalk& w, int B, int S, int lanes, void* stream) {
  if (!row_launch_ok(w, B, lanes, F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_states(S, [&](auto s) {
    return launch_lanes<decltype(s)::value, F>(w, B, lanes, st);
  });
}

}  // namespace
}  // namespace pruning
