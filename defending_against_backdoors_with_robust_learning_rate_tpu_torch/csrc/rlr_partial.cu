// Per-rank partial vote + weighted sum: the sharded server step's kernel.
//
// Replaces the Pallas TPU kernel `_partial_kernel` of
// defending_against_backdoors_with_robust_learning_rate_tpu/ops/pallas_rlr.py
// (launched per leaf by `partial_vote_avg_flat`). For every coordinate j of
// a leaf with n coordinates, over this rank's block of m agents' updates
// U[m, n] (m = the round's sample over the ranks):
//
//   sign_sum_j     = sum_i sign(U_ij)
//   weighted_sum_j = sum_i wn_i * U_ij      (wn already divided by the
//                                            GLOBAL weight total)
//
// The cross-rank all_reduce of both outputs and the elementwise lr / apply
// happen outside, in PyTorch (parallel/rounds.py), as XLA fuses them
// outside the Pallas kernel.
//
// Bound: bytes. Each coordinate reads m floats and writes two, and does
// about 3m flops, far below the card's flop-per-byte balance. The design is
// K1's (rlr_fused.cu): one thread per column j walks the m rows, so at
// every step of the loop a warp reads 32 consecutive floats of one row
// (coalesced); U is read exactly once and both sums stay in registers. The
// Pallas kernel tiled 1024 columns per grid step into VMEM; here the tile
// is the thread block and the row loop replaces the [m, 1024] block.
//
// Plain C interface: this file includes no PyTorch header;
// rlr_fused_binding.cpp binds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// jnp.sign / torch.sign: +1, -1, the zero itself, NaN stays NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__global__ void __launch_bounds__(kThreads)
rlr_partial_kernel(const float* __restrict__ u, const float* __restrict__ wn,
                   float* __restrict__ sign_sum,
                   float* __restrict__ weighted_sum, int m, int64_t n) {
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
  sign_sum[j] = ssum;
  weighted_sum[j] = wsum;
}

}  // namespace

// Launches on `stream` and returns without synchronising. The caller checks
// cudaGetLastError() right after (C10_CUDA_KERNEL_LAUNCH_CHECK in the
// binding), so this function must not read or clear the error itself.
extern "C" void rlr_partial_launch(const float* u, const float* wn,
                                   float* sign_sum, float* weighted_sum, int m,
                                   int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  rlr_partial_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       stream>>>(u, wn, sign_sum, weighted_sum, m, n);
}
