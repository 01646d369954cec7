// PyTorch binding of the RandAugment kernel (randaugment.cu): checks the
// tensors, allocates the output (the only device memory the kernel gets),
// and launches on the current stream of the input's device.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <cstdarg>
#include <cstdio>
#include <tuple>

#include "randaugment.h"

namespace {

// Raises RuntimeError with a printf-style message. It is formatted here
// and handed to TORCH_CHECK as one C string: a TORCH_CHECK that formats
// several message parts itself (through iostreams in this extension) ended
// in a segmentation fault under PyTorch 2.11 with CUDA 12.8.
__attribute__((format(printf, 2, 3))) void check(bool ok, const char* fmt, ...) {
  if (ok) return;
  char msg[512];
  va_list args;
  va_start(args, fmt);
  std::vsnprintf(msg, sizeof msg, fmt, args);
  va_end(args);
  const char* text = msg;
  TORCH_CHECK(false, text);
}

// Raises unless the on-chip design holds an output side of `side`.
void check_side(int64_t side) {
  check(0 < side && side <= kRandaugmentMaxSide,
        "randaugment_mc: the output side must be in [1, %d] (the "
        "largest the on-chip design holds), got %lld",
        kRandaugmentMaxSide, (long long)side);
}

torch::Tensor randaugment_mc(const torch::Tensor& x, const torch::Tensor& pi,
                             const torch::Tensor& pf, int64_t size, bool crop,
                             int64_t pad) {
  check(x.is_cuda() && pi.device() == x.device() &&
            pf.device() == x.device(),
        "randaugment_mc: x, pi and pf must be on one CUDA device");
  check(x.dim() == 4 && x.size(3) == 3,
        "randaugment_mc: x must be (B, H, W, 3)");
  check(x.scalar_type() == at::kFloat ||
            x.scalar_type() == at::kBFloat16,
        "randaugment_mc: x must be float32 or bfloat16");
  const int64_t b = x.size(0), hs = x.size(1), ws = x.size(2);
  check(pf.scalar_type() == at::kFloat && pf.dim() == 2 &&
            pf.size(0) == b && pf.size(1) >= 2 && pf.size(1) % 2 == 0 &&
            pf.is_contiguous(),
        "randaugment_mc: pf must be a contiguous float32 (B, 2n)");
  const int64_t n = pf.size(1) / 2;
  check(pi.scalar_type() == at::kInt && pi.dim() == 2 &&
            pi.size(0) == b && pi.size(1) == 2 + 2 * n + (crop ? 2 : 0) &&
            pi.is_contiguous(),
        "randaugment_mc: pi must be a contiguous int32 (B, 2+2n[+2])");
  check(pad == 0 || crop, "randaugment_mc: pad needs crop mode");
  check(0 <= pad && pad < std::min(hs, ws),
        "randaugment_mc: need 0 <= pad < the input side, got pad %lld",
        (long long)pad);
  check(0 < size && size <= std::min(hs, ws) + 2 * pad &&
            (crop || (size == hs && size == ws)),
        "randaugment_mc: bad image or crop size %lld", (long long)size);
  check_side(size);

  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty({b, size, size, 3}, x.options());
  if (b == 0) return out;
  const cudaError_t rc = randaugment_mc_launch(
      x.data_ptr(), out.data_ptr(), pi.data_ptr<int>(), pf.data_ptr<float>(),
      x.scalar_type() == at::kBFloat16, b, size, hs, ws, pad, n, pi.size(1),
      crop, x.stride(0), x.stride(1), x.stride(2), x.stride(3),
      at::cuda::getCurrentCUDAStream());
  check(rc == cudaSuccess, "randaugment_mc launch failed: %s", cudaGetErrorString(rc));
  return out;
}

// (cluster, shared bytes per block, max active clusters, registers per
// thread, local bytes per thread) of a launch at `side` on the current card.
std::tuple<int64_t, int64_t, int64_t, int64_t, int64_t> randaugment_mc_info(
    int64_t side, bool bf16) {
  check_side(side);
  const int c = randaugment_cluster_size((int)side);
  int active = 0, regs = 0, local = 0;
  const cudaError_t rc = randaugment_mc_occupancy(bf16, (int)side, &active,
                                                  &regs, &local);
  check(rc == cudaSuccess, "randaugment_mc occupancy query failed: %s",
        cudaGetErrorString(rc));
  return {c, (int64_t)randaugment_smem_bytes((int)side, c), active, regs, local};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("randaugment_mc", &randaugment_mc,
        "RandAugmentMC + CutoutAbs(16) on a (B, H, W, 3) CUDA batch",
        py::arg("x"), py::arg("pi"), py::arg("pf"), py::arg("size"),
        py::arg("crop"), py::arg("pad") = 0);
  m.def("randaugment_mc_info", &randaugment_mc_info,
        "cluster, shared bytes, max active clusters, registers and local "
        "bytes of a launch at this side",
        py::arg("side"), py::arg("bf16") = true);
  m.attr("MAX_SIDE") = kRandaugmentMaxSide;
}
