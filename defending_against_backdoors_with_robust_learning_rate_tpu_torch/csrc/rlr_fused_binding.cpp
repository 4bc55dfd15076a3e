// PyTorch binding of the RLR server kernels: the fused step (K1,
// rlr_fused.cu) and the per-rank partials of the sharded step (K2,
// rlr_partial.cu). Each entry fills one leaf table (rlr_table.h) from a
// list of at most rlr::kMaxLeaves leaves, whose outputs sit at given
// offsets of one flat buffer, and makes exactly one launch; the Python
// wrapper (ops/rlr_fused.py) cuts longer lists and counts the launches.
// The checks, the table and the output views are made here, in C++, so a
// server step costs the host one call. The only source of this package
// that includes torch/extension.h.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <algorithm>
#include <cstdint>
#include <vector>

#include "rlr_table.h"

extern "C" int rlr_fused_launch(const rlr::Table* table, cudaStream_t stream);
extern "C" int rlr_partial_launch(const rlr::Table* table,
                                  cudaStream_t stream);

namespace {

using Tensors = std::vector<torch::Tensor>;

void check_tensor(const torch::Tensor& t, const torch::Tensor& like,
                  const char* what) {
  TORCH_CHECK(t.is_cuda(), what, ": tensors must be on a CUDA device");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, what,
              ": tensors must be float32");
  TORCH_CHECK(t.is_contiguous(), what, ": tensors must be contiguous");
  TORCH_CHECK(t.device() == like.device(), what,
              ": tensors must be on one device");
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The table's header and each leaf's u: [m, ...], read as [m, n].
rlr::Table make_table(const Tensors& us, const torch::Tensor& wn,
                      const char* what) {
  TORCH_CHECK(!us.empty() && us.size() <= static_cast<size_t>(rlr::kMaxLeaves),
              what, ": 1 to ", rlr::kMaxLeaves, " leaves a launch, got ",
              us.size());
  check_tensor(wn, wn, what);
  TORCH_CHECK(wn.dim() == 1 && wn.size(0) > 0, what, ": expected wn[m]");
  rlr::Table t{};
  t.wn = wn.data_ptr<float>();
  t.m = static_cast<int32_t>(wn.size(0));
  t.n_leaves = static_cast<int32_t>(us.size());
  for (size_t i = 0; i < us.size(); ++i) {
    check_tensor(us[i], wn, what);
    TORCH_CHECK(us[i].dim() >= 1 && us[i].size(0) == t.m && us[i].numel() > 0,
                what, ": leaf ", i, ": expected u[m, ...] with m = ", t.m);
    t.leaf[i].u = us[i].data_ptr<float>();
    t.leaf[i].n = us[i].numel() / t.m;
  }
  return t;
}

// Leaf i's place in the flat output `out`: out[at, at + n) takes its
// values and out[at + n, at + padded(n)) zeros, cut at the buffer's end.
float* leaf_out(rlr::Leaf& leaf, const torch::Tensor& out, int64_t at,
                const char* what) {
  TORCH_CHECK(at >= 0 && at + leaf.n <= out.numel(), what,
              ": a leaf's output runs past the buffer");
  const int64_t padded = (leaf.n + 3) / 4 * 4;
  leaf.pad = static_cast<int16_t>(std::min(padded, out.numel() - at) - leaf.n);
  return out.data_ptr<float>() + at;
}

void check_out(const torch::Tensor& out, const torch::Tensor& wn,
               const Tensors& us, const std::vector<int64_t>& offsets,
               const char* what) {
  check_tensor(out, wn, what);
  TORCH_CHECK(out.dim() == 1, what, ": expected a flat output buffer");
  TORCH_CHECK(offsets.size() == us.size(), what, ": one offset per leaf");
}

// Which leaves the bulk copies can take, then one launch.
void launch(rlr::Table& t, const torch::Tensor& wn,
            int (*launch_fn)(const rlr::Table*, cudaStream_t)) {
  for (int i = 0; i < t.n_leaves; ++i) {
    rlr::Leaf& leaf = t.leaf[i];
    leaf.bulk = leaf.n % 4 == 0 && aligned16(leaf.u) && aligned16(leaf.p) &&
                aligned16(leaf.out) && aligned16(leaf.out2);
  }
  const c10::cuda::CUDAGuard guard(wn.device());
  C10_CUDA_CHECK(static_cast<cudaError_t>(
      launch_fn(&t, at::cuda::getCurrentCUDAStream().stream())));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

// K1 over up to kMaxLeaves leaves: for leaf i, over us[i][m, ...] with
// weights wn[m] and params ps[i], out[offsets[i]:][:n] = p + lr * agg (pad
// lanes zero; see rlr_fused.cu). Returns each leaf's new params as a view
// of out in its params' shape.
Tensors rlr_fused(const Tensors& us, const torch::Tensor& wn,
                  const Tensors& ps, const torch::Tensor& out,
                  const std::vector<int64_t>& offsets, double threshold,
                  double server_lr, bool use_rlr, bool sign_mode) {
  rlr::Table t = make_table(us, wn, "rlr_fused");
  check_out(out, wn, us, offsets, "rlr_fused");
  TORCH_CHECK(ps.size() == us.size(), "rlr_fused: one p per leaf");
  Tensors views;
  views.reserve(us.size());
  for (size_t i = 0; i < us.size(); ++i) {
    check_tensor(ps[i], wn, "rlr_fused");
    TORCH_CHECK(ps[i].numel() == t.leaf[i].n, "rlr_fused: leaf ", i,
                ": p has ", ps[i].numel(), " values, u's rows ",
                t.leaf[i].n);
    t.leaf[i].p = ps[i].data_ptr<float>();
    t.leaf[i].out = leaf_out(t.leaf[i], out, offsets[i], "rlr_fused");
    views.push_back(out.narrow(0, offsets[i], t.leaf[i].n).view(ps[i].sizes()));
  }
  t.threshold = static_cast<float>(threshold);
  t.server_lr = static_cast<float>(server_lr);
  t.use_rlr = use_rlr ? 1 : 0;
  t.sign_mode = sign_mode ? 1 : 0;
  launch(t, wn, rlr_fused_launch);
  return views;
}

// K2 over up to kMaxLeaves leaves: for leaf i, over us[i][m, ...] with
// weights wn[m], the sign sums at out[sign_at + offsets[i]:][:n] and the
// weighted sums at out[wsum_at + offsets[i]:][:n] (pad lanes zero); an
// `_at` of -1 is a half the kernel does not write. See rlr_partial.cu.
void rlr_partial(const Tensors& us, const torch::Tensor& wn,
                 const torch::Tensor& out, const std::vector<int64_t>& offsets,
                 int64_t sign_at, int64_t wsum_at) {
  rlr::Table t = make_table(us, wn, "rlr_partial");
  check_out(out, wn, us, offsets, "rlr_partial");
  TORCH_CHECK(sign_at >= 0 || wsum_at >= 0, "rlr_partial: nothing to write");
  for (size_t i = 0; i < us.size(); ++i) {
    rlr::Leaf& leaf = t.leaf[i];
    if (sign_at >= 0) {
      leaf.out = leaf_out(leaf, out, sign_at + offsets[i], "rlr_partial");
    }
    const int16_t sign_pad = leaf.pad;
    if (wsum_at >= 0) {
      leaf.out2 = leaf_out(leaf, out, wsum_at + offsets[i], "rlr_partial");
      // the halves share one pad: the shorter, where the buffer cuts one
      if (sign_at >= 0) leaf.pad = std::min(sign_pad, leaf.pad);
    }
  }
  launch(t, wn, rlr_partial_launch);
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rlr_fused", &rlr_fused,
        "fused RLR vote + FedAvg + apply over up to 64 leaves into one flat "
        "buffer (one launch)");
  m.def("rlr_partial", &rlr_partial,
        "per-rank partial sign sums + weighted sums over up to 64 leaves "
        "into one flat buffer (one launch)");
}
