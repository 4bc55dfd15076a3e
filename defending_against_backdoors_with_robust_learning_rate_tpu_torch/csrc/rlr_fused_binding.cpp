// PyTorch binding of the RLR server kernels: the fused step (rlr_fused.cu)
// and the per-rank partials of the sharded step (rlr_partial.cu). The only
// source of this package that includes torch/extension.h.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <cstdint>
#include <vector>

extern "C" void rlr_partial_launch(const float* u, const float* wn,
                                   float* sign_sum, float* weighted_sum, int m,
                                   int64_t n, cudaStream_t stream);

extern "C" void rlr_fused_launch(const float* u, const float* wn,
                                 const float* p, float* out, int m, int64_t n,
                                 float threshold, float server_lr, int use_rlr,
                                 int sign_mode, cudaStream_t stream);

// out[n] = p + lr * agg over u[m, n] with weights wn[m]; see rlr_fused.cu.
torch::Tensor rlr_fused(const torch::Tensor& u, const torch::Tensor& wn,
                        const torch::Tensor& p, double threshold,
                        double server_lr, bool use_rlr, bool sign_mode) {
  for (const auto* t : {&u, &wn, &p}) {
    TORCH_CHECK(t->is_cuda(), "rlr_fused: tensors must be on a CUDA device");
    TORCH_CHECK(t->scalar_type() == torch::kFloat32,
                "rlr_fused: tensors must be float32");
    TORCH_CHECK(t->is_contiguous(), "rlr_fused: tensors must be contiguous");
    TORCH_CHECK(t->device() == u.device(),
                "rlr_fused: tensors must be on one device");
  }
  TORCH_CHECK(u.dim() == 2 && wn.dim() == 1 && p.dim() == 1,
              "rlr_fused: expected u[m, n], wn[m], p[n]");
  TORCH_CHECK(u.size(0) > 0 && u.size(1) > 0 && wn.size(0) == u.size(0) &&
                  p.size(0) == u.size(1),
              "rlr_fused: shapes do not agree");
  const c10::cuda::CUDAGuard guard(u.device());
  auto out = torch::empty_like(p);
  rlr_fused_launch(u.data_ptr<float>(), wn.data_ptr<float>(),
                   p.data_ptr<float>(), out.data_ptr<float>(),
                   static_cast<int>(u.size(0)), u.size(1),
                   static_cast<float>(threshold),
                   static_cast<float>(server_lr), use_rlr ? 1 : 0,
                   sign_mode ? 1 : 0, at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// (sign_sum[n], weighted_sum[n]) over u[m, n] with weights wn[m]; see
// rlr_partial.cu.
std::vector<torch::Tensor> rlr_partial(const torch::Tensor& u,
                                       const torch::Tensor& wn) {
  for (const auto* t : {&u, &wn}) {
    TORCH_CHECK(t->is_cuda(), "rlr_partial: tensors must be on a CUDA device");
    TORCH_CHECK(t->scalar_type() == torch::kFloat32,
                "rlr_partial: tensors must be float32");
    TORCH_CHECK(t->is_contiguous(), "rlr_partial: tensors must be contiguous");
    TORCH_CHECK(t->device() == u.device(),
                "rlr_partial: tensors must be on one device");
  }
  TORCH_CHECK(u.dim() == 2 && wn.dim() == 1,
              "rlr_partial: expected u[m, n], wn[m]");
  TORCH_CHECK(u.size(0) > 0 && u.size(1) > 0 && wn.size(0) == u.size(0),
              "rlr_partial: shapes do not agree");
  const c10::cuda::CUDAGuard guard(u.device());
  auto sign_sum = torch::empty({u.size(1)}, u.options());
  auto weighted_sum = torch::empty({u.size(1)}, u.options());
  rlr_partial_launch(u.data_ptr<float>(), wn.data_ptr<float>(),
                     sign_sum.data_ptr<float>(),
                     weighted_sum.data_ptr<float>(),
                     static_cast<int>(u.size(0)), u.size(1),
                     at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {sign_sum, weighted_sum};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rlr_fused", &rlr_fused, "fused RLR vote + FedAvg + apply (one leaf)");
  m.def("rlr_partial", &rlr_partial,
        "per-rank partial sign sum + weighted sum (one leaf)");
}
