// PyTorch binding of the card's JPEG route (jpeg_card.cu): one decoder per
// device, created with the backend the Python side fixes; the decode, the
// resize and the encode on the current stream of the tensors' device.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <algorithm>
#include <chrono>
#include <cstdarg>
#include <cstdio>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <tuple>
#include <vector>

#include "jpeg_card.h"

namespace {

// Raises RuntimeError with a printf-style message, formatted here and
// handed to TORCH_CHECK as one C string (as ops/csrc/randaugment.cpp does).
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

// One decoder (an nvJPEG handle) per device, created with the fixed
// backend, and a pool of decode states: a decode call takes one state for
// each of its threads and gives them back, so calls from several threads
// (two loaders' prefetch threads, the validation loader's workers) run
// side by side. The encoder's state is one per decoder, used under g_mu.
std::mutex g_mu;
std::map<int, void*> g_decoders;
std::map<int, std::vector<void*>> g_states;
int g_backend = -1;

void* decoder_for(int device) {  // under g_mu
  auto it = g_decoders.find(device);
  if (it != g_decoders.end()) return it->second;
  check(g_backend >= 0, "jpeg_card: init(backend) was not called");
  void* dec = nullptr;
  const int rc = jpeg_card_create(g_backend, device, &dec);
  check(rc == 0, "jpeg_card: creating the nvJPEG decoder (backend %d) on "
        "cuda:%d failed with status %d", g_backend, device, rc);
  g_decoders[device] = dec;
  return dec;
}

// `n` decode states of `device`'s decoder, from the pool or new.
std::vector<void*> take_states(void* dec, int device, int n) {
  std::vector<void*> out;
  std::lock_guard<std::mutex> lk(g_mu);
  auto& pool = g_states[device];
  while (static_cast<int>(out.size()) < n) {
    if (!pool.empty()) {
      out.push_back(pool.back());
      pool.pop_back();
      continue;
    }
    void* state = nullptr;
    const int rc = jpeg_card_state_create(dec, &state);
    if (rc != 0) {
      for (void* s : out) pool.push_back(s);
      check(false, "jpeg_card: creating a decode state failed with status %d",
            rc);
    }
    out.push_back(state);
  }
  return out;
}

void give_states(int device, const std::vector<void*>& states) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto& pool = g_states[device];
  pool.insert(pool.end(), states.begin(), states.end());
}

void init(int64_t backend) {
  std::lock_guard<std::mutex> lk(g_mu);
  check(g_backend < 0 || g_backend == backend,
        "jpeg_card: the backend is fixed at %d, not %lld", g_backend,
        (long long)backend);
  g_backend = static_cast<int>(backend);
}

std::tuple<int64_t, int64_t, int64_t> version() {
  int major = 0, minor = 0, patch = 0;
  const int rc = jpeg_card_version(&major, &minor, &patch);
  check(rc == 0, "jpeg_card: nvjpegGetProperty failed with status %d", rc);
  return {major, minor, patch};
}

// Decode payloads [0, n) with `states.size()` threads, thread t taking
// payloads t, t + T, ...: each into flat + off[i] on `stream`. Statuses go
// to `status` (a failed payload's sides to 0).
void decode_threads(void* dec, const std::vector<void*>& states,
                    const std::vector<std::string>& payloads, uint8_t* flat,
                    const int64_t* off, int32_t* sides,
                    std::vector<int64_t>& status, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(payloads.size());
  const int64_t t_count = static_cast<int64_t>(states.size());
  auto work = [&](int64_t t) {
    for (int64_t i = t; i < n; i += t_count) {
      if (status[i] != 0) continue;
      const auto& p = payloads[i];
      status[i] = jpeg_card_decode(
          dec, states[t], reinterpret_cast<const unsigned char*>(p.data()),
          p.size(), flat + off[i], sides[2 * i + 1], stream);
      if (status[i] != 0) sides[2 * i] = sides[2 * i + 1] = 0;
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < t_count; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
}

// Decode every payload on `device` with `threads` host threads (each
// with a decode state of its own): (decoded RGB rows of all of them, one
// flat uint8 buffer; each one's offset in it, int64; each one's (h, w),
// int32; each one's nvjpegStatus_t). A payload whose status is not 0 has
// (0, 0) and no bytes. Waits for the current stream before it returns, so
// the states are free for the next call.
std::tuple<torch::Tensor, torch::Tensor, torch::Tensor, std::vector<int64_t>>
decode(const std::vector<std::string>& payloads, int64_t device,
       int64_t threads) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  const int64_t n = static_cast<int64_t>(payloads.size());
  auto offsets = torch::zeros({n}, torch::kInt64);
  auto hw = torch::zeros({n, 2}, torch::kInt32);
  std::vector<int64_t> status(n, 0);
  torch::Tensor flat;
  {
    py::gil_scoped_release nogil;
    void* dec;
    {
      std::lock_guard<std::mutex> lk(g_mu);
      dec = decoder_for(static_cast<int>(device));
    }
    auto* off = offsets.data_ptr<int64_t>();
    auto* sides = hw.data_ptr<int32_t>();
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
      int h = 0, w = 0;
      const auto& p = payloads[i];
      status[i] = jpeg_card_info(
          dec, reinterpret_cast<const unsigned char*>(p.data()), p.size(), &h, &w);
      if (status[i] != 0 || h <= 0 || w <= 0) {
        if (status[i] == 0) status[i] = 3;  // NVJPEG_STATUS_BAD_JPEG
        continue;
      }
      off[i] = total;
      sides[2 * i] = h;
      sides[2 * i + 1] = w;
      total += static_cast<int64_t>(h) * w * 3;
    }
    const auto stream = at::cuda::getCurrentCUDAStream();
    flat = torch::empty({std::max<int64_t>(total, 1)},
                        torch::dtype(torch::kUInt8).device(torch::kCUDA, device));
    const int t_count = static_cast<int>(
        std::max<int64_t>(1, std::min<int64_t>(threads, std::max<int64_t>(n, 1))));
    const auto states = take_states(dec, static_cast<int>(device), t_count);
    decode_threads(dec, states, payloads, flat.data_ptr<uint8_t>(), off, sides,
                   status, stream);
    const cudaError_t rc = cudaStreamSynchronize(stream);
    give_states(static_cast<int>(device), states);
    check(rc == cudaSuccess, "jpeg_card: the decode failed on the card: %s",
          cudaGetErrorString(rc));
  }
  const auto dev = torch::Device(torch::kCUDA, device);
  return {flat, offsets.to(dev), hw.to(dev), status};
}

torch::Tensor resize(const torch::Tensor& flat, const torch::Tensor& offsets,
                     const torch::Tensor& hw, int64_t size) {
  check(flat.is_cuda() && offsets.device() == flat.device() &&
            hw.device() == flat.device(),
        "jpeg_card.resize: flat, offsets and hw must be on one CUDA device");
  check(flat.scalar_type() == at::kByte && flat.dim() == 1 &&
            flat.is_contiguous(),
        "jpeg_card.resize: flat must be a contiguous 1-D uint8 tensor");
  const int64_t n = offsets.size(0);
  check(offsets.scalar_type() == at::kLong && offsets.dim() == 1 &&
            offsets.is_contiguous(),
        "jpeg_card.resize: offsets must be a contiguous int64 (N,)");
  check(hw.scalar_type() == at::kInt && hw.dim() == 2 && hw.size(0) == n &&
            hw.size(1) == 2 && hw.is_contiguous(),
        "jpeg_card.resize: hw must be a contiguous int32 (N, 2)");
  check(0 < size && size <= 16384, "jpeg_card.resize: bad size %lld",
        (long long)size);
  const c10::cuda::CUDAGuard guard(flat.device());
  auto out = torch::empty({n, size, size, 3}, flat.options());
  if (n == 0) return out;
  const cudaError_t rc = jpeg_card_resize_launch(
      flat.data_ptr<uint8_t>(), offsets.data_ptr<int64_t>(),
      hw.data_ptr<int32_t>(), out.data_ptr<uint8_t>(), static_cast<int>(n),
      static_cast<int>(size), at::cuda::getCurrentCUDAStream());
  check(rc == cudaSuccess, "jpeg_card.resize launch failed: %s",
        cudaGetErrorString(rc));
  return out;
}

py::bytes encode(const torch::Tensor& rgb, int64_t quality) {
  check(rgb.is_cuda() && rgb.scalar_type() == at::kByte && rgb.dim() == 3 &&
            rgb.size(2) == 3 && rgb.is_contiguous(),
        "jpeg_card.encode: rgb must be a contiguous uint8 (h, w, 3) CUDA "
        "tensor");
  const c10::cuda::CUDAGuard guard(rgb.device());
  std::vector<unsigned char> out;
  int rc = 0;
  {
    py::gil_scoped_release nogil;
    std::lock_guard<std::mutex> lk(g_mu);
    void* dec = decoder_for(rgb.device().index());
    rc = jpeg_card_encode(dec, rgb.data_ptr<uint8_t>(),
                          static_cast<int>(rgb.size(0)),
                          static_cast<int>(rgb.size(1)),
                          static_cast<int>(quality),
                          at::cuda::getCurrentCUDAStream(), &out);
  }
  check(rc == 0, "jpeg_card.encode failed with status %d", rc);
  return py::bytes(reinterpret_cast<const char*>(out.data()), out.size());
}

// For the probe alone (the port's decoder is the fixed one of init()): a
// decoder of `backend` of its own on `device` decodes `payloads` `repeats`
// times with nvjpegDecode on one thread: (creation status, the first
// status that is not 0, or 0; seconds per pass, the last pass, waited
// for). Creation failing gives (status, -1, 0).
std::tuple<int64_t, int64_t, double> probe(
    int64_t backend, const std::vector<std::string>& payloads, int64_t device,
    int64_t repeats) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  void* dec = nullptr;
  const int created = jpeg_card_create(static_cast<int>(backend),
                                       static_cast<int>(device), &dec);
  if (created != 0) return {created, -1, 0.0};
  void* state = nullptr;
  int64_t first = jpeg_card_state_create(dec, &state);
  double seconds = 0.0;
  const auto stream = at::cuda::getCurrentCUDAStream();
  for (int64_t r = 0; r < repeats && first == 0; ++r) {
    const auto t0 = std::chrono::steady_clock::now();
    for (const auto& p : payloads) {
      const auto* data = reinterpret_cast<const unsigned char*>(p.data());
      int h = 0, w = 0;
      int rc = jpeg_card_info(dec, data, p.size(), &h, &w);
      if (rc == 0) {
        auto buf = torch::empty(
            {static_cast<int64_t>(h) * w * 3},
            torch::dtype(torch::kUInt8).device(torch::kCUDA, device));
        rc = jpeg_card_decode(dec, state, data, p.size(),
                              buf.data_ptr<uint8_t>(), w, stream);
      }
      if (rc != 0) {
        first = rc;
        break;
      }
    }
    cudaStreamSynchronize(stream);
    seconds = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  }
  jpeg_card_state_destroy(state);
  jpeg_card_destroy(dec);
  return {0, first, seconds};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("init", &init, "fix the nvJPEG backend (nvjpegBackend_t)",
        py::arg("backend"));
  m.def("version", &version, "nvJPEG's (major, minor, patch)");
  m.def("decode", &decode,
        "decode JPEG payloads on a card: (flat RGB rows, offsets, (h, w), "
        "statuses)",
        py::arg("payloads"), py::arg("device"), py::arg("threads") = 1);
  m.def("resize", &resize, "the bilinear resize kernel on a decoded batch",
        py::arg("flat"), py::arg("offsets"), py::arg("hw"), py::arg("size"));
  m.def("encode", &encode, "encode (h, w, 3) RGB at a quality, 4:2:0",
        py::arg("rgb"), py::arg("quality"));
  m.def("probe", &probe,
        "(create status, decode status, seconds a pass) of a backend",
        py::arg("backend"), py::arg("payloads"), py::arg("device"),
        py::arg("repeats") = 1);
}
