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
//   kL) of every category, so a lane holds F S / kL accumulators, and the
//   rescale's max takes exact shuffles; a launch of few columns (B = 1)
//   still puts several warps on every SM. At 64 states a warp owns 8
//   columns as 4 x 4 micro-tiles instead (row_walk_wide_kernel, below). The lanes pass __syncwarp after
//   reading the children, before a lane writes a row that may be a
//   child's, and again after writing it.
// - Leaves shared by the batch, or one set a batch element (a stack of
//   loci): batch element b reads leaf row b leaf_rows + leaf, leaf_rows 0
//   for shared leaves (pruning_common.cuh's leaf_rows_of). One category a
//   column (B1, B4, B8) folds b leaf_rows into its leaf pointer once; F >
//   1 (B9) adds it to the leaf row at each read: folded, ptxas spilled
//   B9's (20 states, 2 lanes, F = 4) and (4, 1, 2) kernels, and added at
//   each read, B1 and B4 ran 13-14% slower at 512-taxon LG (nvcc 12.8,
//   sm_90a; forward_ab.py, PERF.md section 6).
// - One body: row_place gives a thread its place (RowPlace), row_edge runs
//   one edge; row_walk_kernel loops over the edges' words around them, B8
//   (csrc/pruning_static.cu) unrolls the walk with constant words. At 64
//   states row_walk_wide_kernel (below) is the whole body: its first (four
//   lanes a column, the child's row in every lane's registers, one LDS.128
//   of P per four FMAs) took 2.25-2.40 ms at 100 taxa x 4096 codon sites
//   (4 categories) for B1, B4, B8 and B9, 15-16% of the operations bound;
//   the tiled body 1.32-1.35 ms for B1, B4 and B8 in turns
//   (kernel_turns.py --states 64, NVIDIA H100 80GB HBM3, 700 W).
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
  const float* leaves;   // (n_leaves, sites, S), or (B, ...): leaf_rows
  const int* edges;      // (n_edges,) children of the walk's nodes, in order
  const int2* eword;     // (n_edges + 1,) {child's row or -1 - leaf, row out}
  float* spill;          // (B, K, n_rows - smem_rows, sites, S)
  float* spill_e;        // (B, K, n_rows - smem_rows, sites)
  float* root;           // (B, K, sites, S)
  float* root_e;         // (B, K, sites)
  int K, n_nodes, n_leaves, n_edges, sites;
  int n_rows, smem_rows, cols, chunk, stage_leaves;
  int leaf_rows;         // leaf rows between batch elements' leaves (0:
                         // shared), -1 where leaf_rows_of refused them
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

// A lane's kRows = S / kL entries of a row (rows h kRows ... of the row
// `dst`), as the widest vectors they allow.
template <int S, int kL>
__device__ __forceinline__ void store_lane(float* dst, int h,
                                           const float (&v)[S / kL]) {
  store_part<S / kL>(dst + h * (S / kL), v);
}

// acc[r] *= (P x)[h kRows + r] for the kRows rows lane h forms, P an S x S
// block staged in shared memory: each row's fmaf chain in j order.
template <int S, int kRows>
__device__ __forceinline__ void times_rows(const float* pm, int h,
                                           const float (&x)[S],
                                           float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float y = 0.0f;
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 v = p_vec<S>(pm, h * kRows + r, q);
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
  const float* leaf_col;  // leaf row 0's entries at the column's site
  size_t leaf_stride;     // one leaf's rows
  int lrow0;              // leaf rows to add at each read: b leaf_rows at
                          // F > 1, else 0 (folded into leaf_col)
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
  const int lrow0 = b * w.leaf_rows;  // b's first leaf row (0: shared)
  if constexpr (F == 1) {   // folded into leaf_col (see the top of file)
    at.lrow0 = 0;
    at.leaf_col =
        w.leaves + (static_cast<size_t>(lrow0) * w.sites + at.site) * S;
  } else {
    at.lrow0 = lrow0;
    at.leaf_col = w.leaves + static_cast<size_t>(at.site) * S;
  }
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
          load_states<S>(at.leaf_col + static_cast<size_t>(at.lrow0 - 1 - src) * at.leaf_stride, x);
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
  static_assert(S % 4 == 0 && S % kL == 0 && S < 64,
                "rows are whole 16-byte vectors; 64 states: row_walk_wide_kernel");
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
      cp_async16(dst + c * F * S * S + 4 * q,
                 at.pb + child * at.p_node_stride + 4 * q);
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
                     at.leaf_col + static_cast<size_t>(at.lrow0 + child) * at.leaf_stride + 4 * q);
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

// The live-row walk at 64 states (B1, B4, B8 past its unroll budget, B9;
// codon's 61 or 60 states padded): the same walk and contract as
// row_walk_kernel, each edge's contraction one product over the block's
// `cols` columns in 4 x 4 micro-tiles, four threads a column
// (pruning_common.cuh's tile_rg / tile_col: a warp owns 8 columns, a
// column's 64 rows lie in one half-warp). The child's row is read where it
// lies, not copied into every lane's registers: a row in shared memory
// (64 floats a column: a quarter-warp reads one column, a broadcast), a
// leaf row staged in the ring (stage_leaves), or a leaf or spilled row
// from device memory through L1 by plain loads (a spilled row was written
// by the warp that reads it, before __syncwarp), the next edge's leaf or
// earlier spilled row prefetched into L1 during this one. 8 FMAs a 16-byte
// load, where the lanes of the first 64-state body read one vector of P
// per four. Steps of four j unrolled kUnroll times: once at F = 1
// (unrolled twice, ptxas held B1's and B4's sources' kernel to 128
// registers and spilled 8 bytes), twice at F = 2 (once, pruning_fold.cu's
// was held to 128 and spilled 20; twice it took 178 and spilled nothing).
// Each entry stays one fmaf chain in j order, the children's
// product in child order, the max exact (4 shuffles within the half-warp),
// so the roots keep B1's bits. Only a column's own warp reads its rows: the
// rows need __syncwarp, and the ring one barrier a step.
template <int F>
__global__ void __launch_bounds__(kThreads) row_walk_wide_kernel(const RowWalk w) {
  constexpr int S = 64;
  constexpr int LD = p_row<S>();
  constexpr int kVecs = S / 4;               // 16-byte vectors of a row
  constexpr int kBlockVecs = F * S * S / 4;  // 16-byte vectors of an edge's P
  constexpr int kUnroll = F == 1 ? 1 : 2;
  extern __shared__ float4 row_smem_vec[];
  float* smem = reinterpret_cast<float*>(row_smem_vec);
  const int chunk = w.chunk;
  const int cols = w.cols;
  const int rg = tile_rg();
  const int k0 = blockIdx.y * F;  // the block's categories k0 ... k0 + F - 1
  const int b = blockIdx.z;
  const size_t bk = static_cast<size_t>(b) * w.K + k0;
  const float* __restrict__ pb = w.p + (static_cast<size_t>(b) * w.n_nodes * w.K + k0) * S * S;
  const size_t p_node_stride = static_cast<size_t>(w.K) * S * S;
  const int p_floats = chunk * F * p_block<S>();
  const int stage_floats = row_stage_floats(S, cols, chunk, w.stage_leaves, F);
  float* rows = smem + kPStages * stage_floats;           // (smem_rows, F, cols, S)
  float* rows_e = rows + w.smem_rows * F * cols * S;      // (smem_rows, F, cols)
  const size_t n_spill = static_cast<size_t>(w.n_rows - w.smem_rows);
  float* spill = n_spill ? w.spill + bk * n_spill * w.sites * S : nullptr;
  float* spill_e = n_spill ? w.spill_e + bk * n_spill * w.sites : nullptr;
  const size_t leaf_stride = static_cast<size_t>(w.sites) * S;
  const float* leaf0 = w.leaves + static_cast<size_t>(b) * w.leaf_rows * leaf_stride;
  int col[4];
  int site[4];   // the column's site, clamped to the last for a dead column
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col[j] = tile_col(j);
    const int s_ = blockIdx.x * cols + col[j];
    live[j] = s_ < w.sites;
    site[j] = live[j] ? s_ : w.sites - 1;
  }

  // step t stages edges [t chunk, (t + 1) chunk) into stage t % kPStages
  int staged = 0;
  auto stage_next = [&]() {
    const int f0 = staged * chunk;
    const int n = max(0, min(chunk, w.n_edges - f0));
    float* dst = smem + (staged % kPStages) * stage_floats;
    for (int v = threadIdx.x; v < n * kBlockVecs; v += blockDim.x) {
      const int c = v / kBlockVecs;
      const int q = v - c * kBlockVecs;   // rows p_row apart, F blocks an edge
      cp_async16(dst + c * F * p_block<S>() + (q / (S * S / 4)) * p_block<S>() +
                     p_stage_offset<S>(q % (S * S / 4)),
                 pb + __ldg(w.edges + f0 + c) * p_node_stride + 4 * q);
    }
    if (w.stage_leaves) {   // the step's leaf rows at the block's live columns
      for (int v = threadIdx.x; v < n * cols * kVecs; v += blockDim.x) {
        const int c = v / (cols * kVecs);
        const int cq = v - c * cols * kVecs;
        const int cl = cq / kVecs;
        const int q = cq - cl * kVecs;
        const int child = __ldg(w.edges + f0 + c);
        const int s_ = blockIdx.x * cols + cl;
        if (child < w.n_leaves && s_ < w.sites) {
          cp_async16(dst + p_floats + (c * cols + cl) * S + 4 * q,
                     leaf0 + static_cast<size_t>(child) * leaf_stride +
                         static_cast<size_t>(s_) * S + 4 * q);
        }
      }
    }
    ++staged;
    cp_async_commit();
  };
  // an edge's child row at the thread's columns, in device memory (leaf or
  // spilled), or null where it is in shared memory
  auto global_row = [&](int src, int c, int j) -> const float* {
    if (src < 0) {
      return w.stage_leaves ? nullptr
                            : leaf0 + static_cast<size_t>(-1 - src) * leaf_stride +
                                  static_cast<size_t>(site[j]) * S;
    }
    if (src < w.smem_rows) return nullptr;
    return spill + ((c * n_spill + (src - w.smem_rows)) * w.sites + site[j]) * S;
  };
  stage_next();
  stage_next();

  int step = -1;        // the step whose stage holds the edge
  int in_step = chunk;  // edges of that step already read
  const float* stage_now = smem;
  int2 next = __ldg(w.eword);  // the next edge's word, read one edge ahead
  float acc[F][4][4];
  float e[F][4];
#pragma unroll
  for (int c = 0; c < F; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[c][j] = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[c][a][j] = 1.0f;
    }
  }
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
    const int src = word.x;
    const int dst = word.y;
    // the next edge's row into L1 while this one computes: a leaf, or a
    // spilled row this edge does not write (16 lanes, a 128-byte line each
    // of the warp's 8 columns' rows)
    const bool ahead = f + 1 < w.n_edges &&
                       (next.x < 0 ? !w.stage_leaves
                                   : next.x >= w.smem_rows && next.x != dst);
    if (ahead && rg < 8) {   // lane rg: column j = rg % 4, line rg / 4
#pragma unroll
      for (int c = 0; c < (next.x < 0 ? 1 : F); ++c) {
        const float* r = global_row(next.x, c, rg & 3) + 32 * (rg >> 2);
        asm volatile("prefetch.global.L1 [%0];" ::"l"(r));
      }
    }
    const float* pm = stage_now + in_step * F * p_block<S>();
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float* pr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pr[a] = pm + c * p_block<S>() + (rg + 16 * a) * LD;
      const float* xc[4];
      float y[4][4];
      if (src >= 0 && src < w.smem_rows) {   // a row in shared memory
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int slot = (src * F + c) * cols + col[j];
          xc[j] = rows + slot * S;
          e[c][j] += rows_e[slot];
        }
        wide_product<S, false, false, kUnroll>(pr, xc, y);
      } else if (src < 0 && w.stage_leaves) {   // a leaf row in the ring
#pragma unroll
        for (int j = 0; j < 4; ++j) xc[j] = stage_now + p_floats + (in_step * cols + col[j]) * S;
        wide_product<S, false, false, kUnroll>(pr, xc, y);
      } else {   // a leaf or spilled row in device memory
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xc[j] = global_row(src, c, j);
          if (src >= 0) {
            e[c][j] += live[j] ? spill_e[(c * n_spill + (src - w.smem_rows)) * w.sites + site[j]]
                               : 0.0f;
          }
        }
        wide_product<S, false, true, kUnroll>(pr, xc, y);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][a][j] *= y[a][j];
      }
    }
    if (dst == -2) continue;  // more children of this node follow
    // the node's last child: each category's rescale, then its store
#pragma unroll
    for (int c = 0; c < F; ++c) tile_rescale(acc[c], e[c]);
    __syncwarp();  // the warp read the children (perhaps the row it writes)
#pragma unroll
    for (int c = 0; c < F; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* out;
        float* out_e;
        if (dst < 0) {   // the root
          if (!live[j]) continue;
          const size_t g = (bk + c) * w.sites + site[j];
          out = w.root + g * S;
          out_e = w.root_e + g;
        } else if (dst < w.smem_rows) {
          const int slot = (dst * F + c) * cols + col[j];
          out = rows + slot * S;
          out_e = rows_e + slot;
        } else {
          if (!live[j]) continue;
          const size_t g = (c * n_spill + (dst - w.smem_rows)) * w.sites + site[j];
          out = spill + g * S;
          out_e = spill_e + g;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) out[rg + 16 * a] = acc[c][a][j];
        if (rg == 0) *out_e = e[c][j];
      }
    }
    __syncwarp();  // the row is whole before a lane reads it
#pragma unroll
    for (int c = 0; c < F; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[c][j] = 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[c][a][j] = 1.0f;
      }
    }
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

// The live-row kernel of S states, kL threads a column, F categories a
// column; at 64 states row_walk_wide_kernel, whose four threads a column
// are its only lane count.
template <int S, int kL, int F>
int launch_row_kernel(const RowWalk& w, int B, cudaStream_t stream) {
  const auto launch = [&](auto kernel) {
    const size_t smem =
        row_smem_bytes(S, w.cols, w.chunk, w.stage_leaves, w.smem_rows, F);
    const int err = grant_smem(kernel, smem);
    if (err) return err;
    const dim3 grid((w.sites + w.cols - 1) / w.cols, w.K / F, B);
    kernel<<<grid, w.cols * kL, smem, stream>>>(w);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (S == 64) {
    if constexpr (kL == 4) {
      return launch(row_walk_wide_kernel<F>);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return launch(row_walk_kernel<S, kL, F>);
  }
}

// Whether a live-row launch of `w` over B batch elements with `lanes` lanes
// and F categories a column is one the kernels take: a block of 32 to
// kThreads threads in whole warps, F dividing K, smem_rows within n_rows.
inline bool row_launch_ok(const RowWalk& w, int B, int lanes, int F) {
  const int threads = w.cols * lanes;
  return B > 0 && w.K > 0 && F > 0 && w.K % F == 0 && w.sites > 0 &&
         w.leaf_rows >= 0 &&
         w.n_edges > 0 && w.cols > 0 && w.chunk > 0 && threads <= kThreads &&
         threads % 32 == 0 && w.smem_rows >= 0 && w.smem_rows <= w.n_rows;
}

// The lane counts compiled at S (1, 2, 4 at S = 4; 1, 2 at S = 20; 4 at
// S = 64, row_walk_wide_kernel's four threads a column) for F categories
// a column; any other returns cudaErrorInvalidValue. (B9 compiles its own
// (F, lanes) pairs: pruning_fold.cu.)
template <int S, int F>
int launch_lanes(const RowWalk& w, int B, int lanes, cudaStream_t st) {
  if constexpr (S == 64) {
    if (lanes == 4) return launch_row_kernel<S, 4, F>(w, B, st);
  } else {
    if (lanes == 1) return launch_row_kernel<S, 1, F>(w, B, st);
    if (lanes == 2) return launch_row_kernel<S, 2, F>(w, B, st);
    if constexpr (S == 4) {
      if (lanes == 4) return launch_row_kernel<S, 4, F>(w, B, st);
    }
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
