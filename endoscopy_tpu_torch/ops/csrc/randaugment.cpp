// PyTorch binding of the RandAugment kernel (randaugment.cu): checks the
// tensors, allocates the output and the float32 scratch, and launches on the
// current stream of the input's device.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include "randaugment.h"

namespace {

constexpr int64_t kMaxSide = 1024;  // the kernel's per-row shift tables

torch::Tensor randaugment_mc(const torch::Tensor& x, const torch::Tensor& pi,
                             const torch::Tensor& pf, int64_t size,
                             bool crop) {
  TORCH_CHECK(x.is_cuda() && pi.device() == x.device() &&
                  pf.device() == x.device(),
              "randaugment_mc: x, pi and pf must be on one CUDA device");
  TORCH_CHECK(x.dim() == 4 && x.size(3) == 3,
              "randaugment_mc: x must be (B, H, W, 3)");
  TORCH_CHECK(x.scalar_type() == at::kFloat ||
                  x.scalar_type() == at::kBFloat16,
              "randaugment_mc: x must be float32 or bfloat16");
  const int64_t b = x.size(0), hp = x.size(1), wp = x.size(2);
  TORCH_CHECK(pf.scalar_type() == at::kFloat && pf.dim() == 2 &&
                  pf.size(0) == b && pf.size(1) >= 2 && pf.size(1) % 2 == 0 &&
                  pf.is_contiguous(),
              "randaugment_mc: pf must be a contiguous float32 (B, 2n)");
  const int64_t n = pf.size(1) / 2;
  TORCH_CHECK(pi.scalar_type() == at::kInt && pi.dim() == 2 &&
                  pi.size(0) == b && pi.size(1) == 2 + 2 * n + (crop ? 2 : 0) &&
                  pi.is_contiguous(),
              "randaugment_mc: pi must be a contiguous int32 (B, 2+2n[+2])");
  TORCH_CHECK(0 < size && size <= std::min(hp, wp) && size <= kMaxSide &&
                  (crop || (size == hp && size == wp)),
              "randaugment_mc: bad image or crop size");

  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty({b, size, size, 3}, x.options());
  if (b == 0) return out;
  auto scratch = torch::empty({b, 6, size * size},
                              x.options().dtype(at::kFloat));
  const cudaError_t rc = randaugment_mc_launch(
      x.data_ptr(), out.data_ptr(), pi.data_ptr<int>(), pf.data_ptr<float>(),
      scratch.data_ptr<float>(), x.scalar_type() == at::kBFloat16, b, size,
      size, hp, wp, n, pi.size(1), crop, x.stride(0), x.stride(1),
      x.stride(2), x.stride(3), at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(rc == cudaSuccess, "randaugment_mc launch failed: ",
              cudaGetErrorString(rc));
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("randaugment_mc", &randaugment_mc,
        "RandAugmentMC + CutoutAbs(16) on a (B, H, W, 3) CUDA batch",
        py::arg("x"), py::arg("pi"), py::arg("pf"), py::arg("size"),
        py::arg("crop"));
}
