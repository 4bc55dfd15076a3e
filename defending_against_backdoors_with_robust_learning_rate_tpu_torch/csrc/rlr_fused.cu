// K1: the fused RLR vote + FedAvg + apply, the dense round's server step,
// over every leaf of the model in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` of
// defending_against_backdoors_with_robust_learning_rate_tpu/ops/pallas_rlr.py
// (launched per leaf by `_fused_leaf`). For every coordinate j of a leaf,
// over the m sampled agents' updates U[m, n]:
//
//   s_j   = sum_i sign(U_ij)
//   lr_j  = use_rlr ? (|s_j| >= threshold ? server_lr : -server_lr) : server_lr
//   agg_j = sign_mode ? sign(s_j) : sum_i wn_i * U_ij     (wn sums to 1)
//   out_j = p_j + lr_j * agg_j
//
// Bound: bytes, (m + 2) * n * 4 of them (U and p read once, out written
// once). The column reduction, the leaf table and the bulk-copy ring are
// rlr_columns.cuh; this file is the epilogue, which takes p from the ring
// and writes out 16 bytes a thread. threshold, server_lr and the mode are
// runtime arguments (the Pallas kernel bakes them in as compile-time
// constants).
//
// Plain C interface: this file includes no PyTorch header, so nvcc compiles
// it in seconds; rlr_fused_binding.cpp binds it.

#include "rlr_columns.cuh"

namespace {

struct FusedEpilogue {
  static constexpr bool kParamsRow = true;  // p comes through the ring

  static __device__ __forceinline__ float apply(const rlr::Table& t, float p,
                                                float s, float w) {
    const float agg = t.sign_mode ? rlr::sign_of(s) : w;
    const float lr = t.use_rlr
                         ? (fabsf(s) >= t.threshold ? t.server_lr : -t.server_lr)
                         : t.server_lr;
    return p + lr * agg;
  }

  static __device__ __forceinline__ void store4(const rlr::Table& t,
                                                const rlr::Leaf& leaf,
                                                int64_t col, float4 s,
                                                float4 w, float4 p) {
    float4 out;
    out.x = apply(t, p.x, s.x, w.x);
    out.y = apply(t, p.y, s.y, w.y);
    out.z = apply(t, p.z, s.z, w.z);
    out.w = apply(t, p.w, s.w, w.w);
    *reinterpret_cast<float4*>(leaf.out + col) = out;
  }

  static __device__ __forceinline__ void store1(const rlr::Table& t,
                                                const rlr::Leaf& leaf,
                                                int64_t col, float s, float w) {
    leaf.out[col] = apply(t, __ldg(leaf.p + col), s, w);
  }

  static __device__ __forceinline__ void store_zero(const rlr::Leaf& leaf,
                                                    int64_t col) {
    leaf.out[col] = 0.f;
  }
};

}  // namespace

// One launch over the table's leaves on `stream`; see launch_columns.
extern "C" int rlr_fused_launch(const rlr::Table* table, cudaStream_t stream) {
  return static_cast<int>(rlr::launch_columns<FusedEpilogue>(*table, stream));
}
