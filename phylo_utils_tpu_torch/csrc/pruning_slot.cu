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
// - At 64 states (codon, padded by ops/cuda_pruning.py) its first body had
//   four lanes share a column, 16 rows each, every lane reading the
//   child's row from device memory and one LDS.128 of P per four FMAs:
//   2.186 ms at 100 taxa x 4096 codon sites (4 categories), 17% of its
//   operations bound. pruning_stream_wide_kernel forms a node's product
//   over a block of 64 columns as one tiled product a child
//   (pruning_common.cuh's wide_product, 4 x 4 micro-tiles, 8 FMAs a load),
//   the children's rows staged in shared memory beside P: 1.124 ms there,
//   33% (8.13 ms at 30 categories, 16.76 before), in turns on an NVIDIA
//   H100 80GB HBM3 at 700 W (kernel_turns.py --states 64). What bounds it:
//   the shared-memory datapath (a warp's LDS.128 moves 512 bytes at 128
//   bytes a clock, so 8 FMAs a load cap the loop at half the f32 rate; 8 x
//   4 micro-tiles over 128 threads, 10.7 a load, ran slower on half the
//   warps) and a round trip to L2 a node for the x rows staged after the
//   node's last read.
// The rows, the fmaf order and the rescale are B1's, so the roots keep
// B1's bits. pruning_slot_f32 (B4) is B1's live-row body over the slots
// (pruning_rows.cuh; at 64 states its tiled row_walk_wide_kernel). Threads
// past the last site stay in the loop for the barriers
// and skip the loads and stores. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (kernel_turns.py, PERF.md section 6): 1.65 ms at 512 taxa
// x 8192 LG patterns, 25% of its operations bound (1.93 ms, 22%, before).

#include "pruning_rows.cuh"

namespace {

using pruning::kThreads;

// Lanes per column of the stream walk at 4 and 20 states: at 20 two lanes
// share a column, each forming half of its rows, which doubles the warps
// in flight (the walk waits on row latency with ~8 warps an SM at one lane
// a column); at 4 one lane (the split measured slower there). 64 states
// take pruning_stream_wide_kernel.
template <int S>
__host__ __device__ constexpr int stream_lanes() {
  return S >= 20 ? 2 : 1;
}

// The stream walk (B5): the slot walk with the children's P staged in
// shared memory two nodes ahead, in a ring of kPStages stages, read as
// 16-byte broadcast vectors. kL = stream_lanes<S>() adjacent lanes own one
// column; lane h forms rows [h S / kL, (h + 1) S / kL), each row's fmaf
// chain in j order as in times_child.
template <int S>
__global__ void __launch_bounds__(kThreads)
pruning_stream_kernel(const float* __restrict__ p,        // (B, n_nodes, K, S, S)
                      const float* __restrict__ leaves,   // (B?, n_leaves, sites, S): leaf_rows
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
                      int sites, int leaf_rows) {
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
  const int lrow0 = b * leaf_rows;  // b's first leaf row (0: shared)
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
      float x[S];
#pragma unroll
      for (int j = 0; j < S; ++j) x[j] = 0.0f;
      if (active) {
        if (__ldg(cleaf + i * cmax + c)) {
          pruning::load_states<S>(leaves + (static_cast<size_t>(lrow0 + src) * sites + site) * S, x);
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
#pragma unroll
      for (int q = 0; q < kRows / 2; ++q) {
        reinterpret_cast<float2*>(dst + row * S + h * kRows)[q] =
            make_float2(acc[2 * q], acc[2 * q + 1]);
      }
      if (h == 0) dst_e[row] = e;
    }
  }
}

// children a node of the 64-state stream walk may have (its P ring: cmax
// <= 4 in 227 KB, ops/cuda_pruning.py::stream_smem_bytes)
constexpr int kStreamWideMaxChildren = 4;

// Floats of a 64-state stream block (pruning_stream_wide_kernel) whose
// widest node has cmax children: a ring of two stages of cmax P blocks,
// one stage of cmax x tiles, and two rows of kWideTile column maxima
// (ops/cuda_pruning.py::stream_smem_bytes mirrors it).
template <int S>
__host__ __device__ constexpr size_t stream_wide_smem_floats(int cmax) {
  return 3 * static_cast<size_t>(cmax) * pruning::wide_tile_floats<S>() +
         2 * pruning::kWideTile;
}

// The stream walk at 64 states (B5, codon's 61 or 60 states padded): the
// block's kWideTile columns as one tiled product a child (pruning_common.
// cuh's wide_product, a 4 x 4 micro-tile a thread over 256 threads: 8
// FMAs a 16-byte load). Node i's children's P blocks are staged one node
// ahead in a ring of two stages, and their x rows (leaf or slot rows of
// the block's columns) into one stage of x tiles once node i - 1 has read
// its own, at node i - 1's second barrier: all but the child that node i
// - 1 formed, whose rows the threads put into the tile from registers as
// they store them. The loads a node's epilogue reads (its slot children's
// exponents, the next node's children) are issued before its products.
// Threads past the last site copy nothing and store nothing. Same
// arguments and outputs as pruning_stream_kernel.
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
pruning_stream_wide_kernel(const float* __restrict__ p,        // (B, n_nodes, K, S, S)
                           const float* __restrict__ leaves,   // (B?, n_leaves, sites, S): leaf_rows
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
                           int sites, int leaf_rows) {
  constexpr int T = pruning::kWideTile;
  constexpr int LD = pruning::p_row<S>();
  constexpr int kTileF = pruning::wide_tile_floats<S>();
  constexpr int kRowVecs = S / 4;  // 16-byte vectors of a row
  static_assert(S == T && kThreads == 256, "a 16 x 16 grid of 4 x 4 micro-tiles");
  extern __shared__ float4 smem_vec[];
  float* p_stage = reinterpret_cast<float*>(smem_vec);  // (2, cmax, S, LD)
  float* x_tile = p_stage + 2 * cmax * kTileF;           // (cmax, T, LD)
  float* red = x_tile + cmax * kTileF;                   // (2, T)
  const int rg = pruning::wide_rg();
  const int cg = pruning::wide_cg();
  const int site0 = blockIdx.x * T;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int lrow0 = b * leaf_rows;  // b's first leaf row (0: shared)
  const size_t bk = static_cast<size_t>(b) * K + k;
  float* __restrict__ xs = slots + bk * n_slots * sites * S;
  float* __restrict__ es = slots_e + bk * n_slots * sites;
  const float* __restrict__ pb = p + (static_cast<size_t>(b) * n_nodes * K + k) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) live[j] = site0 + cg + 16 * j < sites;

  // node i's children's P blocks -> P stage i % 2 (all threads share)
  auto stage_p = [&](int i) {
    if (i >= n_int) return;
    const int cnt = __ldg(counts + i);
    float* dst = p_stage + (i & 1) * cmax * kTileF;
    for (int c = 0; c < cnt; ++c) {
      const float* src = pb + __ldg(cnode + i * cmax + c) * p_node_stride;
      for (int q = threadIdx.x; q < S * kRowVecs; q += kThreads) {
        pruning::cp_async16(dst + c * kTileF + pruning::p_stage_offset<S>(q), src + 4 * q);
      }
    }
  };
  // node i's children's rows at the block's live columns -> the x tiles,
  // but child `fwd` (the node just formed, put there from registers)
  auto stage_x = [&](int i, int fwd) {
    if (i >= n_int) return;
    const int cnt = __ldg(counts + i);
    for (int c = 0; c < cnt; ++c) {
      if (c == fwd) continue;
      const int src = __ldg(csrc + i * cmax + c);
      const float* base = (__ldg(cleaf + i * cmax + c)
                               ? leaves + static_cast<size_t>(lrow0 + src) * sites * S
                               : xs + static_cast<size_t>(src) * sites * S) +
                          static_cast<size_t>(site0) * S;
      for (int v = threadIdx.x; v < T * kRowVecs; v += kThreads) {
        const int col = v / kRowVecs;
        const int q = v % kRowVecs;
        if (site0 + col < sites) {
          pruning::cp_async16(x_tile + (c * T + col) * LD + 4 * q, base + col * S + 4 * q);
        }
      }
    }
  };
  stage_p(0);
  stage_x(0, -1);
  pruning::cp_async_commit();

  for (int i = 0; i < n_int; ++i) {
    pruning::cp_async_wait_all();  // node i's P and x rows (this thread's part)
    __syncthreads();               // ... and every other thread's
    stage_p(i + 1);                // into the stage node i - 1 read
    pruning::cp_async_commit();
    const float* p_now = p_stage + (i & 1) * cmax * kTileF;
    const int cnt = __ldg(counts + i);
    const bool last = i == n_int - 1;  // the root is last in DFS post-order
    const int own = __ldg(nslot + i);
    // the slot children's exponents, and the child of node i + 1 that node
    // i forms (fwd, or -1), read before the products and used after them
    float ce[kStreamWideMaxChildren][4];
#pragma unroll
    for (int c = 0; c < kStreamWideMaxChildren; ++c) {
      const bool slot = c < cnt && rg == 0 && !__ldg(cleaf + i * cmax + c);
      const size_t row = slot ? static_cast<size_t>(__ldg(csrc + i * cmax + c)) * sites + site0 : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) ce[c][j] = slot && live[j] ? es[row + cg + 16 * j] : 0.0f;
    }
    int fwd = -1;
    if (!last) {
      const int cnt1 = __ldg(counts + i + 1);
      for (int c = 0; c < cnt1; ++c) {
        if (!__ldg(cleaf + (i + 1) * cmax + c) && __ldg(csrc + (i + 1) * cmax + c) == own) fwd = c;
      }
    }
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 1.0f;
    }
    for (int c = 0; c < cnt; ++c) {
      const float* pr[4];
      const float* xc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pr[a] = p_now + c * kTileF + (rg + 16 * a) * LD;
#pragma unroll
      for (int j = 0; j < 4; ++j) xc[j] = x_tile + (c * T + cg + 16 * j) * LD;
      float y[4][4];
      pruning::wide_product<S, false>(pr, xc, y);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] *= y[a][j];
      }
    }
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the exponents in child order
#pragma unroll
    for (int c = 0; c < kStreamWideMaxChildren; ++c) {
      if (c < cnt && !__ldg(cleaf + i * cmax + c)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] += ce[c][j];
      }
    }
    // rescale_pow2 over each column's S rows: the max over the thread's
    // rows, the 8 row groups of its warp (exact shuffles) and the other
    // warp's 8 (through `red`), then the same scale and exponent
    float m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = FLT_MIN;
#pragma unroll
      for (int a = 0; a < 4; ++a) m[j] = fmaxf(m[j], acc[a][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
      }
    }
    if ((rg & 7) == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(rg >> 3) * T + cg + 16 * j] = m[j];
    }
    __syncthreads();  // the x tiles are read and the maxima written
    stage_x(i + 1, fwd);
    pruning::cp_async_commit();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = fmaxf(red[cg + 16 * j], red[T + cg + 16 * j]);
      int eb = (__float_as_int(m[j]) >> 23) & 0xFF;
      eb = min(max(eb, 1), 253);
      const float scale = __int_as_float((254 - eb) << 23);
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][j] *= scale;
      e[j] += static_cast<float>(eb - 127);
    }
    if (fwd >= 0) pruning::wide_put<S>(x_tile + fwd * kTileF, rg, cg, acc);
    float* dst = xs;
    float* dst_e = es;
    size_t row;
    if (last) {
      dst = root;
      dst_e = root_e;
      row = bk * sites + site0;
    } else {  // may be a child's slot: every child was staged above
      row = static_cast<size_t>(own) * sites + site0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cg + 16 * j;
      if (!live[j]) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a) dst[(row + col) * S + rg + 16 * a] = acc[a][j];
      if (rg == 0) dst_e[row + col] = e[j];
    }
  }
}

int launch_stream(const void* p, const void* leaves, const void* nslot,
                  const void* cnode, const void* csrc, const void* cleaf,
                  const void* counts, void* slots, void* slots_e, void* root,
                  void* root_e, int B, int K, int S, int n_nodes, int n_slots,
                  int n_int, int cmax, int sites, void* stream,
                  long long leaf_batch) {
  const int leaf_rows = pruning::leaf_rows_of(leaf_batch, B, sites, S);
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || n_slots <= 0 ||
      leaf_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    const auto launch = [&](auto kernel, int per_block, int threads, size_t smem) {
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      const dim3 grid((sites + per_block - 1) / per_block, K, B);
      kernel<<<grid, threads, smem, st>>>(
          static_cast<const float*>(p), static_cast<const float*>(leaves),
          static_cast<const int*>(nslot), static_cast<const int*>(cnode),
          static_cast<const int*>(csrc), static_cast<const int*>(cleaf),
          static_cast<const int*>(counts), static_cast<float*>(slots),
          static_cast<float*>(slots_e), static_cast<float*>(root),
          static_cast<float*>(root_e), K, n_nodes, n_slots, n_int, cmax,
          sites, leaf_rows);
      return static_cast<int>(cudaGetLastError());
    };
    if constexpr (kS == 64) {  // kWideTile sites a block
      if (cmax > kStreamWideMaxChildren) return static_cast<int>(cudaErrorInvalidValue);
      return launch(pruning_stream_wide_kernel<kS>, pruning::kWideTile, kThreads,
                    stream_wide_smem_floats<kS>(cmax) * sizeof(float));
    } else {  // kThreads / stream_lanes sites a block
      return launch(pruning_stream_kernel<kS>, kThreads / stream_lanes<kS>(), kThreads,
                    static_cast<size_t>(pruning::kPStages) * cmax *
                        pruning::p_block<kS>() * sizeof(float));
    }
  });
}

}  // namespace

// The slot walk over B4's DFS slots (csrc/pruning_rows.cuh): `edges`,
// `eword`, the spill rows and the launch geometry as pruning_forward_f32's
// (csrc/pruning_forward.cu), over ops/cuda_pruning.py::SlotSchedule.rows,
// n_rows = n_slots. Launch on `stream`; returns cudaGetLastError() after
// the launch (0 = ok), the error of granting the shared memory, or
// cudaErrorInvalidValue without launching for a geometry that is not
// compiled. S is 4, 20 or 64 (lanes 4 at 64, B1's body: the walk
// that PHYLO_FORCE_STREAM=0 takes past the classic budget at codon width,
// as _pallas_forward takes _dynamic_slot_kernel there).
extern "C" int pruning_slot_f32(const void* p, const void* leaves,
                                const void* edges, const void* eword,
                                void* spill, void* spill_e, void* root,
                                void* root_e, int B, int K, int S,
                                int n_nodes, int n_leaves, int n_edges,
                                int sites, int n_rows, int smem_rows,
                                int lanes, int cols, int chunk,
                                int stage_leaves, void* stream,
                                long long leaf_batch) {
  const pruning::RowWalk w{
      static_cast<const float*>(p),   static_cast<const float*>(leaves),
      static_cast<const int*>(edges), static_cast<const int2*>(eword),
      static_cast<float*>(spill),     static_cast<float*>(spill_e),
      static_cast<float*>(root),      static_cast<float*>(root_e),
      K, n_nodes, n_leaves, n_edges, sites,
      n_rows, smem_rows, cols, chunk, stage_leaves,
      pruning::leaf_rows_of(leaf_batch, B, sites, S)};
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
// leaf_batch as pruning_forward_f32's (csrc/pruning_forward.cu).
extern "C" int pruning_stream_f32(const void* p, const void* leaves,
                                  const void* nslot, const void* cnode,
                                  const void* csrc, const void* cleaf,
                                  const void* counts, void* slots,
                                  void* slots_e, void* root, void* root_e,
                                  int B, int K, int S, int n_nodes,
                                  int n_slots, int n_int, int cmax, int sites,
                                  void* stream, long long leaf_batch) {
  return launch_stream(p, leaves, nslot, cnode, csrc, cleaf, counts, slots,
                       slots_e, root, root_e, B, K, S, n_nodes, n_slots, n_int,
                       cmax, sites, stream, leaf_batch);
}
