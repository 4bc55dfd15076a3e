// Fused RLR vote + FedAvg + apply: the server step of one parameter leaf.
//
// Replaces the Pallas TPU kernel `_kernel` of
// defending_against_backdoors_with_robust_learning_rate_tpu/ops/pallas_rlr.py
// (launched per leaf by `_fused_leaf`). For every coordinate j of a leaf
// with n coordinates, over the m sampled agents' updates U[m, n]:
//
//   s_j   = sum_i sign(U_ij)
//   lr_j  = use_rlr ? (|s_j| >= threshold ? server_lr : -server_lr) : server_lr
//   agg_j = sign_mode ? sign(s_j) : sum_i wn_i * U_ij     (wn sums to 1)
//   out_j = p_j + lr_j * agg_j
//
// Bound: bytes. Each coordinate reads m + 1 floats and writes one, and does
// about 4m flops, far below the card's flop-per-byte balance. The design
// reads U exactly once: one thread per column j walks the m rows, so at
// every step of the loop a warp reads 32 consecutive floats of one row
// (coalesced), and the sign sum and weighted sum stay in registers. Nothing
// but `out` is written. The Pallas kernel tiled 1024 columns per grid step
// into VMEM; here the tile is the thread block and the row loop replaces
// the [m, 1024] block.
//
// threshold, server_lr and the mode are runtime arguments (the Pallas kernel
// bakes them in as compile-time constants).
//
// Plain C interface: this file includes no PyTorch header, so nvcc compiles
// it in seconds; rlr_fused_binding.cpp binds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// jnp.sign / torch.sign: +1, -1, the zero itself, NaN stays NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__global__ void __launch_bounds__(kThreads)
rlr_fused_kernel(const float* __restrict__ u, const float* __restrict__ wn,
                 const float* __restrict__ p, float* __restrict__ out, int m,
                 int64_t n, float threshold, float server_lr, int use_rlr,
                 int sign_mode) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  float ssum = 0.f;
  float wsum = 0.f;
  const float* col = u + j;
  for (int i = 0; i < m; ++i) {
    const float x = __ldg(col + static_cast<int64_t>(i) * n);
    ssum += sign_of(x);
    wsum = fmaf(__ldg(wn + i), x, wsum);
  }
  const float agg = sign_mode ? sign_of(ssum) : wsum;
  const float lr =
      use_rlr ? (fabsf(ssum) >= threshold ? server_lr : -server_lr) : server_lr;
  out[j] = p[j] + lr * agg;
}

}  // namespace

// Launches on `stream` and returns without synchronising. The caller checks
// cudaGetLastError() right after (C10_CUDA_KERNEL_LAUNCH_CHECK in the
// binding), so this function must not read or clear the error itself.
extern "C" void rlr_fused_launch(const float* u, const float* wn,
                                 const float* p, float* out, int m, int64_t n,
                                 float threshold, float server_lr, int use_rlr,
                                 int sign_mode, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  rlr_fused_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      u, wn, p, out, m, n, threshold, server_lr, use_rlr, sign_mode);
}
