// K2: the per-rank partial vote + weighted sum of the sharded server step,
// over every leaf of the model in one launch, written into the round's
// packed all_reduce buffer.
//
// Replaces the Pallas TPU kernel `_partial_kernel` of
// defending_against_backdoors_with_robust_learning_rate_tpu/ops/pallas_rlr.py
// (launched per leaf by `partial_vote_avg_flat`). For every coordinate j of
// a leaf, over this rank's block of m agents' updates U[m, n]:
//
//   sign_sum_j     = sum_i sign(U_ij)
//   weighted_sum_j = sum_i wn_i * U_ij      (wn already divided by the
//                                            GLOBAL weight total)
//
// Each leaf's two outputs are views of one flat buffer (its offsets 16-byte
// aligned, parallel/rounds.PackedPlan); a null output is not written, so
// the kernel writes only the halves the step all_reduces. The cross-rank
// all_reduce and the elementwise lr / apply happen outside, in PyTorch, as
// XLA fuses them outside the Pallas kernel.
//
// Bound: bytes, (m + h) * n * 4 of them for the h (1 or 2) halves written.
// The column reduction, the leaf table and the bulk-copy ring are
// rlr_columns.cuh; this file is the epilogue, 16-byte stores.
//
// Plain C interface: this file includes no PyTorch header;
// rlr_fused_binding.cpp binds it.

#include "rlr_columns.cuh"

namespace {

struct PartialEpilogue {
  static constexpr bool kParamsRow = false;

  static __device__ __forceinline__ void store4(const rlr::Table&,
                                                const rlr::Leaf& leaf,
                                                int64_t col, float4 s,
                                                float4 w, float4) {
    if (leaf.out) *reinterpret_cast<float4*>(leaf.out + col) = s;
    if (leaf.out2) *reinterpret_cast<float4*>(leaf.out2 + col) = w;
  }

  static __device__ __forceinline__ void store1(const rlr::Table&,
                                                const rlr::Leaf& leaf,
                                                int64_t col, float s, float w) {
    if (leaf.out) leaf.out[col] = s;
    if (leaf.out2) leaf.out2[col] = w;
  }

  static __device__ __forceinline__ void store_zero(const rlr::Leaf& leaf,
                                                    int64_t col) {
    if (leaf.out) leaf.out[col] = 0.f;
    if (leaf.out2) leaf.out2[col] = 0.f;
  }
};

}  // namespace

// One launch over the table's leaves on `stream`; see launch_columns.
extern "C" int rlr_partial_launch(const rlr::Table* table,
                                  cudaStream_t stream) {
  return static_cast<int>(rlr::launch_columns<PartialEpilogue>(*table, stream));
}
