// Felsenstein pruning forward walk with F rate categories a column
// (pruning_fold_f32, B9), for NVIDIA Hopper (sm_90a).
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
// What bounded its first body, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md section 6): one thread walked a (b, site) column's F
// categories over the level post-order with every internal node's row in a
// (B, K, n_inner, sites, S) device scratch (330 MB at the flagship B = 64),
// read P through L1 one load per FMA, and held F x S accumulators (128 to
// 255 registers at 20 states), so few warps fit an SM: 0.2483 ms at the
// flagship B = 64, F = 2, against a 0.0197 ms operations bound; the widest
// fold was the slowest.
//
// Its body now is csrc/pruning_rows.cuh's live-row walk, row_walk_kernel<S,
// kL, F> (B1 and B4 are its F = 1 instantiations), over the DFS slot walk
// (ops/cuda_pruning.py::SlotSchedule.rows, 3 to 8 rows, the fewest, since
// the rows on the SM are multiplied by F). A column (its kL lanes) walks
// categories gF ... gF + F - 1 of one (b, site): a leaf row is read once and
// applied to all F, every category keeps its own accumulators, exponent and
// rescale and its fmaf chains in j order, so each category's root and
// exponent count is bit for bit B1's (csrc/pruning_forward.cu). The ring
// stages each step's P for the F categories (chunk x F x S^2 floats: F blocks
// of one node are contiguous in P), the rows live in shared memory by (row,
// f, column), and the lanes split every category's rows, so a lane holds F
// S / kL accumulators. Grid ((sites + cols - 1) / cols, K / F, B); F must
// divide K (the caller refuses, not pads, a K that F does not divide).
//
// What bounds it now is what bounds B4: at B = 64 the issue of ~45
// instructions a column and edge, of which folding removes the word load,
// the branches and, for F - 1 of every F categories, the leaf read (at 4
// states half the flagship's edges are leaves); at B = 1 the latency of one
// warp's chain of dependent instructions, which F categories a column
// lengthen F-fold while halving (F = 2) the warps of a launch that holds
// only a few an SM; at 20 states the FMAs, which folding does not reduce,
// against registers that grow with F. PERF.md section 6 has the times.
// Each compiled width is compiled at the lane counts of its state count
// that ptxas (nvcc -Xptxas -v for sm_90a, at register-usage level 10:
// ops/_build.py::PTXAS_FLAGS) takes without a spill (fold_compiled below;
// ops/cuda_pruning.py::FOLD_WIDTHS mirrors it).

#include <type_traits>
#include <utility>

#include "pruning_rows.cuh"

namespace {

// The fold widths compiled at state count S (FoldWidths<S>), and whether F
// is compiled at `lanes` lanes a column there: every lane count of the
// state count (1, 2, 4 at 4 states; 1, 2 at 20; 2 at 64) whose kernel
// ptxas takes without a spill. It spilled F = 4 at 4 states at one lane
// ("Used 128 registers ... 8 bytes spill stores") and at four ("Used 64
// registers ... 8 bytes spill stores"; kernel_turns.py's
// ptxas_fold_pairs), so that width runs at two lanes only. At 64 states
// (codon) F = 2, the widest the JAX package folds there (F S_pad <= 128
// lanes): at four lanes ptxas held it to 128 registers and spilled 24
// bytes, at two it took 224 and spilled nothing (nvcc -Xptxas -v for
// sm_90a at this source's level), so it runs at two lanes.
template <int S>
using FoldWidths = std::conditional_t<
    S == 4, std::integer_sequence<int, 2, 4>,
    std::conditional_t<S == 64, std::integer_sequence<int, 2>,
                       std::integer_sequence<int, 2, 3, 4, 5>>>;
constexpr bool fold_compiled(int s, int f, int lanes) {
  if (s == 64) return lanes == 2;
  const bool lane_count = lanes == 1 || lanes == 2 || (s == 4 && lanes == 4);
  return lane_count && !(s == 4 && f == 4 && lanes != 2);
}

// Calls launch(std::integral_constant<int, V>{}) when v is one of Vs; else
// returns cudaErrorInvalidValue without launching.
template <typename L, int... Vs>
int dispatch_among(int v, L&& launch, std::integer_sequence<int, Vs...>) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((v == Vs ? (rc = launch(std::integral_constant<int, Vs>{}), true)
                  : false) || ...);
  return rc;
}

}  // namespace

// The live-row walk (csrc/pruning_rows.cuh) with F categories a column.
// Buffers and arguments as pruning_forward_f32's (csrc/pruning_forward.cu),
// F after S: `edges` and `eword` the walk (SlotSchedule.rows), rows [0,
// smem_rows) in shared memory, the others in spill (B, K, n_rows -
// smem_rows, sites, S) and spill_e (B, K, n_rows - smem_rows, sites) (null
// when none), root (B, K, sites, S), root_e (B, K, sites). Launch on
// `stream`; returns cudaGetLastError() after the launch (0 = ok), the error
// of granting the shared memory, or cudaErrorInvalidValue without launching
// when F does not divide K, or F or its lanes are not compiled at s. s is
// 4, 20 or 64. leaf_batch as pruning_forward_f32's.
extern "C" int pruning_fold_f32(const void* p, const void* leaves,
                                const void* edges, const void* eword,
                                void* spill, void* spill_e, void* root,
                                void* root_e, int B, int K, int s, int F,
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
      pruning::leaf_rows_of(leaf_batch, B, sites, s)};
  if (!pruning::row_launch_ok(w, B, lanes, F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pruning::dispatch_states(s, [&](auto s_) {
    constexpr int kS = decltype(s_)::value;
    return dispatch_among(
        F,
        [&](auto f) {
          constexpr int kF = decltype(f)::value;
          return dispatch_among(
              lanes,
              [&](auto l) {
                constexpr int kL = decltype(l)::value;
                if constexpr (fold_compiled(kS, kF, kL)) {
                  return pruning::launch_row_kernel<kS, kL, kF>(w, B, st);
                } else {
                  return static_cast<int>(cudaErrorInvalidValue);
                }
              },
              std::integer_sequence<int, 1, 2, 4>{});
        },
        FoldWidths<kS>{});
  });
}
