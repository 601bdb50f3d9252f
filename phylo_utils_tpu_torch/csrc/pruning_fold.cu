// Felsenstein pruning forward walk with F rate categories per thread
// (pruning_fold_f32), for NVIDIA Hopper (sm_90a).
//
// Replaces the category-fold and DNA-pack lowerings of the TPU kernel
// phylo_utils_tpu/ops/pallas_pruning.py::_dynamic_kernel (_pick_fold,
// _block_rescale, _walk_tree's n_blocks; PHYLO_FOLD_CATEGORIES and
// PHYLO_PACK_DNA). On the TPU, F categories are stacked into one
// block-diagonal (F S_pad)^2 P so that one wide MXU product replaces F narrow
// ones, with the rescale kept per block; packing is that at 4 states, F = 2.
// This kernel computes what those lowerings compute, not a copy of the
// block-diagonal P: the root partials and exponent counts of all K
// categories, each category rescaled on its own.
//
// Design. One thread owns one (batch b, fold group g, site) column and walks
// the whole tree for the categories gF ... gF + F - 1. Grid is
// (ceil(sites / 256), K / F, B); F must divide K (the caller refuses, not
// pads, a K that F does not divide). A leaf row is shared by every category,
// so the thread loads it once for all F categories: that is what folding
// buys on this card, F - 1 of every F leaf reads. Internal children are per
// category, as in B1. The thread keeps F x S accumulators in registers, and
// applies each category's P through pruning_common.cuh's times_child and
// rescale_pow2, in B1's order, so every category's root and exponent count
// is bit for bit B1's (csrc/pruning_forward.cu). Scratch is the whole-tree
// layout of B1's first body (and of B2's residuals),
//     scratch (B, K, n_nodes - n_leaves, sites, S), scratch_e (B, K, ..., sites),
//     root (B, K, sites, S), root_e (B, K, sites).
//
// What bounds it on an H100: what bounds B1. At 4 states bytes (the leaf
// reads it saves are at most half of one node's child traffic); at 20 states
// operations and the 400 broadcast P loads per child and category, which
// folding does not change. Registers grow as F x S: the compiled widths are
// the ones ptxas takes without spills under 256 threads a block (at most 255
// registers a thread): F in {2, 4} at S = 4 (48 and 64 registers; F = 3 took
// 48 with an 8-byte spill) and F in {2, 3, 4, 5} at S = 20 (128, 227, 255
// and 255 registers, no spill; nvcc -Xptxas -v for sm_90a). FoldWidths below
// lists them; ops/cuda_pruning.FOLD_WIDTHS mirrors it.

#include <utility>

#include "pruning_common.cuh"

namespace {

using pruning::kThreads;

// the F values compiled at S
template <int S>
struct FoldWidths;
template <>
struct FoldWidths<4> {
  using type = std::integer_sequence<int, 2, 4>;
};
template <>
struct FoldWidths<20> {
  using type = std::integer_sequence<int, 2, 3, 4, 5>;
};

template <int S, int F>
__global__ void __launch_bounds__(kThreads)
pruning_fold_kernel(const float* __restrict__ p,         // (B, n_nodes, K, S, S)
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
  const int k0 = blockIdx.y * F;
  const int b = blockIdx.z;
  const size_t n_inner = static_cast<size_t>(n_nodes - n_leaves);
  const size_t bk0 = static_cast<size_t>(b) * K + k0;
  // category k0 + f: scratch at xs0 + f * x_cat, exponents at es0 + f * e_cat
  const size_t e_cat = n_inner * sites;
  const size_t x_cat = e_cat * S;
  float* __restrict__ xs0 = scratch + bk0 * x_cat;
  float* __restrict__ es0 = scratch_e + bk0 * e_cat;
  // P for (b, node, k0 + f) starts at pb + node * K * S * S + f * S * S
  const float* __restrict__ pb =
      p + (static_cast<size_t>(b) * n_nodes * K + k0) * S * S;
  const size_t p_node_stride = static_cast<size_t>(K) * S * S;

  for (int i = 0; i < n_int; ++i) {
    const int node = __ldg(order + i);
    const int cnt = __ldg(counts + i);
    float acc[F][S];
    float e[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      e[f] = 0.0f;
#pragma unroll
      for (int r = 0; r < S; ++r) acc[f][r] = 1.0f;
    }
    for (int c = 0; c < cnt; ++c) {
      const int child = __ldg(children + i * cmax + c);
      const float* __restrict__ pc = pb + child * p_node_stride;
      if (child < n_leaves) {   // one load of the leaf row for all F
        float x[S];
        pruning::load_states<S>(
            leaves + (static_cast<size_t>(child) * sites + site) * S, x);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          pruning::times_child<S, false>(pc + f * S * S, x, acc[f]);
        }
      } else {
        const size_t row = static_cast<size_t>(child - n_leaves) * sites + site;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float x[S];
          pruning::load_states<S>(xs0 + f * x_cat + row * S, x);
          e[f] += es0[f * e_cat + row];
          pruning::times_child<S, false>(pc + f * S * S, x, acc[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) e[f] += pruning::rescale_pow2<S>(acc[f]);

    if (i == n_int - 1) {   // the root is last in post-order
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const size_t col = (bk0 + f) * sites + site;
        pruning::store_states<S>(root + col * S, acc[f]);
        root_e[col] = e[f];
      }
    } else {
      const size_t row = static_cast<size_t>(node - n_leaves) * sites + site;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        pruning::store_states<S>(xs0 + f * x_cat + row * S, acc[f]);
        es0[f * e_cat + row] = e[f];
      }
    }
  }
}

// Calls launch(std::integral_constant<int, F>{}) when f is one of Fs; else
// returns cudaErrorInvalidValue without launching.
template <typename L, int... Fs>
int dispatch_fold(int f, L&& launch, std::integer_sequence<int, Fs...>) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((f == Fs ? (rc = launch(std::integral_constant<int, Fs>{}), true)
                  : false) || ...);
  return rc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue without launching when F does not divide K or is
// not compiled at S. Buffers as documented above; the caller allocates
// every one. S is 4 or 20.
extern "C" int pruning_fold_f32(const void* p, const void* leaves,
                                const void* order, const void* children,
                                const void* counts, void* scratch,
                                void* scratch_e, void* root, void* root_e,
                                int B, int K, int S, int F, int n_nodes,
                                int n_leaves, int n_int, int cmax, int sites,
                                void* stream) {
  if (B <= 0 || K <= 0 || F <= 0 || K % F != 0 || sites <= 0 || n_int <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sites + kThreads - 1) / kThreads, K / F, B);
  return pruning::dispatch_states(S, [&](auto s) {
    constexpr int kS = decltype(s)::value;
    return dispatch_fold(
        F,
        [&](auto f) {
          pruning_fold_kernel<kS, decltype(f)::value>
              <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                  static_cast<const float*>(p),
                  static_cast<const float*>(leaves),
                  static_cast<const int*>(order),
                  static_cast<const int*>(children),
                  static_cast<const int*>(counts),
                  static_cast<float*>(scratch),
                  static_cast<float*>(scratch_e), static_cast<float*>(root),
                  static_cast<float*>(root_e), K, n_nodes, n_leaves, n_int,
                  cmax, sites);
          return static_cast<int>(cudaGetLastError());
        },
        typename FoldWidths<kS>::type{});
  });
}
