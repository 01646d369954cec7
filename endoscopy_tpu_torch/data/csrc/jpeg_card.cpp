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
// backend, and a pool of decode states, each made for batches of one size
// and kept for it: a decode call takes a free state of its batch size (a
// new one if none is free) and gives it back, so calls from several threads
// (two loaders' prefetch threads, the validation loader's workers) run side
// by side, and a state is initialized (nvjpegDecodeBatchedInitialize) once.
// The encoder's state is one per decoder, used under g_mu.
struct State {
  void* state;
  int batch;  // the batch size nvjpegDecodeBatchedInitialize made it for
};
std::mutex g_mu;
std::map<int, void*> g_decoders;
std::map<int, std::vector<State>> g_states;
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

// A free decode state of `device`'s decoder made for batches of `batch`:
// from the pool or new.
State take_state(void* dec, int device, int batch) {
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto& pool = g_states[device];
    auto it = std::find_if(pool.begin(), pool.end(),
                           [&](const State& s) { return s.batch == batch; });
    if (it != pool.end()) {
      const State out = *it;
      pool.erase(it);
      return out;
    }
  }
  State out{nullptr, batch};
  int rc = jpeg_card_state_create(dec, &out.state);
  check(rc == 0, "jpeg_card: creating a decode state failed with status %d",
        rc);
  rc = jpeg_card_batch_init(dec, out.state, batch);
  if (rc != 0) jpeg_card_state_destroy(out.state);
  check(rc == 0, "jpeg_card: nvjpegDecodeBatchedInitialize for %d images "
        "failed with status %d", batch, rc);
  return out;
}

void give_state(int device, const State& state) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_states[device].push_back(state);
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

// nvjpegStatus_t of a payload that is not a JPEG nvJPEG decodes (invalid
// parameter, bad JPEG, not supported, incomplete bitstream), as
// data/jpeg_card.py::BAD_INPUT.
bool bad_input(int status) {
  return status == 2 || status == 3 || status == 4 || status == 10;
}

// Waits for `stream` without spinning a host core.
cudaError_t wait_stream(cudaStream_t stream) {
  cudaEvent_t done;
  cudaError_t rc = cudaEventCreateWithFlags(
      &done, cudaEventBlockingSync | cudaEventDisableTiming);
  if (rc != cudaSuccess) return rc;
  rc = cudaEventRecord(done, stream);
  if (rc == cudaSuccess) rc = cudaEventSynchronize(done);
  cudaEventDestroy(done);
  return rc;
}

// Whether a JPEG's markers, walked from its SOI, reach a start of scan
// (SOS) with data after it. nvjpegGetImageInfo reads no further than the
// frame header, and a batch of more than 100 that holds a payload with no
// scan does not return from nvjpegDecodeBatched (an H100, nvJPEG 12.4).
bool has_scan(const unsigned char* p, size_t len) {
  if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return false;
  size_t i = 2;
  while (i + 1 < len) {
    if (p[i] != 0xFF) return false;
    const unsigned char m = p[i + 1];
    if (m == 0xFF) {  // a fill byte
      ++i;
      continue;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {  // no length field
      i += 2;
      continue;
    }
    if (m == 0xD9 || i + 4 > len) return false;  // EOI, or no length field
    const size_t end = i + 2 + (static_cast<size_t>(p[i + 2]) << 8 | p[i + 3]);
    if (end < i + 4 || end > len) return false;
    if (m == 0xDA) return end < len;
    i = end;
  }
  return false;
}

// The payloads of one decode in the decoded batch's layout: each header
// parsed (nvjpegGetImageInfo, and has_scan), payload i's status, offset and (h, w) into
// status[i], off[i] and sides[2i, 2i + 1]; the flat buffer on `device`; and
// the payloads whose header parses, in the order of the batched call, with
// their bytes, length, destination and row pitch. A payload whose header
// does not parse keeps its status and (0, 0).
struct Layout {
  torch::Tensor flat;
  std::vector<int64_t> index;
  std::vector<const unsigned char*> src;
  std::vector<size_t> len;
  std::vector<unsigned char*> dst;
  std::vector<int64_t> pitch;
};

Layout lay_out(void* dec, const std::vector<const unsigned char*>& data,
               const std::vector<size_t>& lengths, int64_t device,
               int64_t* status, int64_t* off, int32_t* sides) {
  Layout out;
  int64_t total = 0;
  for (size_t i = 0; i < data.size(); ++i) {
    int h = 0, w = 0;
    status[i] = jpeg_card_info(dec, data[i], lengths[i], &h, &w);
    if (status[i] != 0 || h <= 0 || w <= 0 || !has_scan(data[i], lengths[i])) {
      if (status[i] == 0) status[i] = 3;  // NVJPEG_STATUS_BAD_JPEG
      continue;
    }
    off[i] = total;
    sides[2 * i] = h;
    sides[2 * i + 1] = w;
    out.index.push_back(static_cast<int64_t>(i));
    out.src.push_back(data[i]);
    out.len.push_back(lengths[i]);
    out.pitch.push_back(jpeg_card_row_pitch(w));
    total += h * out.pitch.back();  // a multiple of kJpegCardAlign
  }
  out.flat = torch::empty({std::max<int64_t>(total, kJpegCardAlign)},
                          torch::dtype(torch::kUInt8).device(torch::kCUDA, device));
  for (const int64_t i : out.index)
    out.dst.push_back(out.flat.data_ptr<uint8_t>() + off[i]);
  return out;
}

// The one nvjpegDecodeBatched call of a layout, with `state` (made for
// batches of its size).
int decode_batch(void* dec, void* state, const Layout& l, cudaStream_t stream) {
  return jpeg_card_decode_batch(dec, state, l.src.data(), l.len.data(),
                                l.dst.data(), l.pitch.data(),
                                static_cast<int>(l.index.size()), stream);
}

// Decode every payload on `device` in one nvjpegDecodeBatched call on the
// current stream, payload i the lengths[i] bytes of `data` (a uint8 CPU
// tensor) after those of payloads 0..i-1: (the decoded RGB rows of all of
// them in one flat uint8 buffer, in jpeg_card.h's layout; each one's offset
// in it, int64; each one's (h, w), int32; each one's nvjpegStatus_t; the
// payloads decoded again one at a time). A payload whose header does not
// parse is left out of the call with its status. If the call fails on its
// input, each of its payloads is decoded again on its own, on the card,
// only to find which fail; a failure that no payload explains raises. A
// payload whose status is not 0 has (0, 0). The offsets and sides go to
// the card from pinned memory on the stream. Waits for the stream before
// it returns, so the state is free for the next call.
std::tuple<torch::Tensor, torch::Tensor, torch::Tensor, std::vector<int64_t>,
           int64_t>
decode(const torch::Tensor& data, const std::vector<int64_t>& lengths,
       int64_t device) {
  check(data.device().is_cpu() && data.scalar_type() == at::kByte &&
            data.dim() == 1 && data.is_contiguous(),
        "jpeg_card.decode: data must be a contiguous 1-D uint8 CPU tensor");
  const int64_t n = static_cast<int64_t>(lengths.size());
  std::vector<const unsigned char*> src(n);
  std::vector<size_t> len(n);
  int64_t at = 0;
  for (int64_t i = 0; i < n; ++i) {
    check(lengths[i] >= 0, "jpeg_card.decode: a negative length");
    src[i] = data.data_ptr<uint8_t>() + std::min(at, data.numel());
    len[i] = static_cast<size_t>(lengths[i]);
    at += lengths[i];
  }
  check(at <= data.numel(), "jpeg_card.decode: the lengths add up to %lld "
        "bytes, past the data's %lld", (long long)at, (long long)data.numel());
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  const auto pinned = torch::TensorOptions().pinned_memory(true);
  auto offsets = torch::zeros({n}, pinned.dtype(torch::kInt64));
  auto hw = torch::zeros({n, 2}, pinned.dtype(torch::kInt32));
  std::vector<int64_t> status(n, 0);
  int64_t redecoded = 0;
  torch::Tensor flat;
  const auto stream = at::cuda::getCurrentCUDAStream();
  {
    py::gil_scoped_release nogil;
    void* dec;
    {
      std::lock_guard<std::mutex> lk(g_mu);
      dec = decoder_for(static_cast<int>(device));
    }
    int32_t* sides = hw.data_ptr<int32_t>();
    const Layout l = lay_out(dec, src, len, device, status.data(),
                             offsets.data_ptr<int64_t>(), sides);
    flat = l.flat;
    const int m = static_cast<int>(l.index.size());
    if (m > 0) {
      const State state = take_state(dec, static_cast<int>(device), m);
      const int rc = decode_batch(dec, state.state, l, stream);
      int failed = 0, created = 0;
      if (rc != 0 && bad_input(rc)) {
        void* single = nullptr;
        created = jpeg_card_state_create(dec, &single);
        for (int k = 0; k < m && created == 0; ++k) {
          const int64_t i = l.index[k];
          status[i] = jpeg_card_decode(dec, single, l.src[k], l.len[k],
                                       l.dst[k], l.pitch[k], stream);
          ++redecoded;
          if (status[i] != 0) {
            ++failed;
            sides[2 * i] = sides[2 * i + 1] = 0;
            if (!bad_input(static_cast<int>(status[i]))) break;
          }
        }
        jpeg_card_state_destroy(single);
      }
      const cudaError_t waited = wait_stream(stream);
      // a state whose batched call failed fails the next batch it is given
      // (status 2 on clean payloads), so it goes and a new one takes its place
      if (rc == 0) {
        give_state(static_cast<int>(device), state);
      } else {
        jpeg_card_state_destroy(state.state);
      }
      check(created == 0, "jpeg_card: creating the re-decode's state failed "
            "with status %d", created);
      check(rc == 0 || (bad_input(rc) && failed > 0),
            "jpeg_card: nvjpegDecodeBatched failed with status %d on %d "
            "payloads, which no payload explains", rc, m);
      check(waited == cudaSuccess, "jpeg_card: the decode failed on the card: %s",
            cudaGetErrorString(waited));
    }
  }
  const auto dev = torch::Device(torch::kCUDA, device);
  return {flat, offsets.to(dev, torch::kInt64, /*non_blocking=*/true),
          hw.to(dev, torch::kInt32, /*non_blocking=*/true), status, redecoded};
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
  check(reinterpret_cast<uintptr_t>(flat.data_ptr()) % kJpegCardAlign == 0 &&
            flat.numel() % kJpegCardAlign == 0,
        "jpeg_card.resize: flat must start on a %d-byte boundary and hold a "
        "multiple of %d bytes (the decoded batch's layout)", kJpegCardAlign,
        kJpegCardAlign);
  check(n <= 65535, "jpeg_card.resize: %lld images, above the grid's 65535",
        (long long)n);
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
// decoder of `backend` of its own on `device` decodes `payloads`, laid out
// as decode() lays them out, `repeats` times: as one batch, one
// nvjpegDecodeBatched call, or with `batched` false one nvjpegDecode call a
// payload (the single-image call). (creation status, the first status that
// is not 0, or 0; seconds of the last repeat, waited for). Creation failing
// gives (status, -1, 0).
std::tuple<int64_t, int64_t, double> probe(
    int64_t backend, const std::vector<std::string>& payloads, int64_t device,
    int64_t repeats, bool batched) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  void* dec = nullptr;
  const int created = jpeg_card_create(static_cast<int>(backend),
                                       static_cast<int>(device), &dec);
  if (created != 0) return {created, -1, 0.0};
  const size_t n = payloads.size();
  std::vector<const unsigned char*> data(n);
  std::vector<size_t> lengths(n);
  for (size_t i = 0; i < n; ++i) {
    data[i] = reinterpret_cast<const unsigned char*>(payloads[i].data());
    lengths[i] = payloads[i].size();
  }
  std::vector<int64_t> status(n), off(n);
  std::vector<int32_t> sides(2 * n);
  const Layout l = lay_out(dec, data, lengths, device, status.data(),
                           off.data(), sides.data());
  const int m = static_cast<int>(l.index.size());
  int64_t first = 0;
  for (const int64_t s : status)
    if (first == 0) first = s;
  void* state = nullptr;
  if (first == 0) first = jpeg_card_state_create(dec, &state);
  if (first == 0 && batched) first = jpeg_card_batch_init(dec, state, m);
  double seconds = 0.0;
  const auto stream = at::cuda::getCurrentCUDAStream();
  for (int64_t r = 0; r < repeats && first == 0; ++r) {
    const auto t0 = std::chrono::steady_clock::now();
    if (batched) {
      first = decode_batch(dec, state, l, stream);
    } else {
      for (int k = 0; k < m && first == 0; ++k)
        first = jpeg_card_decode(dec, state, l.src[k], l.len[k], l.dst[k],
                                 l.pitch[k], stream);
    }
    wait_stream(stream);
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
        "decode JPEG payloads on a card in one batched call: (flat RGB "
        "rows, offsets, (h, w), statuses, re-decodes)",
        py::arg("data"), py::arg("lengths"), py::arg("device"));
  m.def("resize", &resize, "the bilinear resize kernel on a decoded batch",
        py::arg("flat"), py::arg("offsets"), py::arg("hw"), py::arg("size"));
  m.def("encode", &encode, "encode (h, w, 3) RGB at a quality, 4:2:0",
        py::arg("rgb"), py::arg("quality"));
  m.def("probe", &probe,
        "(create status, decode status, seconds a decode) of a backend, "
        "batched or one nvjpegDecode a payload",
        py::arg("backend"), py::arg("payloads"), py::arg("device"),
        py::arg("repeats"), py::arg("batched"));
}
