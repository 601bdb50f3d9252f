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
// the root's included, as the residuals of the reverse walks
// (csrc/pruning_reverse.cu, csrc/pruning_classic_reverse.cu). The residuals
// are the forward's scratch layout (B, K, n_inner, sites, S) and (B, K,
// n_inner, sites); leaves are not copied (the reverse walks read the leaf
// array). It runs on every gradient call, and at 20 states its first
// version (the forward's body, P read one entry at a time through L1: one
// load per FMA) took 12.46 ms at 512 taxa x 8192 LG patterns against a
// 0.52 ms bound (NVIDIA H100 80GB HBM3, 700 W). Its own body:
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

#include "pruning_common.cuh"

namespace {

using pruning::kThreads;

template <int S>
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

    if (i == n_int - 1) {  // the root is last in post-order
      pruning::store_states<S>(root + (bk * sites + site) * S, acc);
      root_e[bk * sites + site] = e;
    } else {
      const size_t row = static_cast<size_t>(node - n_leaves) * sites + site;
      pruning::store_states<S>(xs + row * S, acc);
      es[row] = e;
    }
  }
}

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
  extern __shared__ float4 p_stage_vec[];  // (kPStages, chunk, S, S)
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
  const int stage_floats = chunk * S * S;

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
      pruning::cp_async16(dst + c * S * S + 4 * q,
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
      const float* pm = p_now + in_step * S * S;
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
      if constexpr (kL == 1) {
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
    pruning_forward_kernel<decltype(s)::value>
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
// n_leaves, sites), indexed by node id - n_leaves. `edges` (n_edges,) holds
// the children of order[0], then of order[1], ..., counts[i] each. P is
// staged in shared memory by chunks of `chunk` edges (kPStages x chunk x
// S x S floats of dynamic shared memory, ops/cuda_pruning.py::
// saveall_stage), with `lanes` (1 or 2) lanes a column. Returns
// cudaGetLastError() after the launch (0 = ok), or the error of granting
// the shared memory. S is 4 or 20.
extern "C" int pruning_saveall_f32(const void* p, const void* leaves,
                                   const void* order, const void* edges,
                                   const void* counts, void* res_x,
                                   void* res_e, int B, int K, int S,
                                   int n_nodes, int n_leaves, int n_int,
                                   int n_edges, int sites, int chunk,
                                   int lanes, void* stream) {
  if (B <= 0 || K <= 0 || sites <= 0 || n_int <= 0 || chunk <= 0 ||
      (lanes != 1 && lanes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    const auto launch = [&](auto kernel, int per_block) {
      const size_t smem = static_cast<size_t>(pruning::kPStages) * chunk *
                          kS * kS * sizeof(float);
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
    return lanes == 1 ? launch(pruning_saveall_kernel<kS, 1>, kThreads)
                      : launch(pruning_saveall_kernel<kS, 2>, kThreads / 2);
  });
}
