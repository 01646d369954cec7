// The card's JPEG route (bound by jpeg_card.cpp, driven by
// data/jpeg_card.py).
//
// Decode and encode are nvJPEG's (the CUDA toolkit's libnvjpeg): they take
// the place of libjpeg, which decodes on the host in the JAX package
// (native/loader.cpp:44-68) and in the port's CPU route
// (data/csrc/loader.cpp), not of a TPU kernel. One fixed backend, chosen
// by the caller (data/jpeg_card.py::BACKEND); nothing switches it.
//
// The resize is written here: data/csrc/loader.cpp::resize_bilinear (the
// JAX package's native/loader.cpp:70-101) with one thread per output pixel
// of the batch. It keeps the C++ code's float32 operations in their order,
// each rounded on its own (the __f*_rn intrinsics are never contracted into
// fused multiply-adds; the build adds -fmad=false), and its truncations, so
// from the same decoded pixels it writes the host core's bytes exactly.
// It is bound by memory: each output pixel reads 4 source pixels (12 bytes,
// mostly from L1/L2) and writes 3; the least time is the batch's decoded
// bytes plus its output bytes at the card's memory rate.

#include <library_types.h>
#include <nvjpeg.h>

#include <cstdint>
#include <vector>

#include "jpeg_card.h"

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int device = 0;
};

__global__ void resize_bilinear_kernel(const uint8_t* __restrict__ src,
                                       const int64_t* __restrict__ offsets,
                                       const int32_t* __restrict__ hw,
                                       uint8_t* __restrict__ dst, int64_t n,
                                       int size) {
  const int64_t per_image = static_cast<int64_t>(size) * size;
  const int64_t total = n * per_image;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t img = t / per_image;
    const int rem = static_cast<int>(t - img * per_image);
    const int y = rem / size, x = rem - (rem / size) * size;
    uint8_t* d = dst + t * 3;
    const int sh = hw[2 * img], sw = hw[2 * img + 1];
    if (sh < 2 || sw < 2) {
      d[0] = d[1] = d[2] = 0;
      continue;
    }
    // const float sx = static_cast<float>(sw) / size; (sy likewise)
    const float sx = __fdiv_rn(static_cast<float>(sw), static_cast<float>(size));
    const float sy = __fdiv_rn(static_cast<float>(sh), static_cast<float>(size));
    // float fy = (y + 0.5f) * sy - 0.5f;
    const float fy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), sy), 0.5f);
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = __fsub_rn(fy, static_cast<float>(y0));
    if (wy < 0) wy = 0;
    const float fx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), sx), 0.5f);
    int x0 = fx < 0 ? 0 : static_cast<int>(fx);
    if (x0 > sw - 2) x0 = sw - 2;
    float wx = __fsub_rn(fx, static_cast<float>(x0));
    if (wx < 0) wx = 0;
    const uint8_t* p00 = src + offsets[img] + (static_cast<int64_t>(y0) * sw + x0) * 3;
    const uint8_t* p01 = p00 + 3;
    const uint8_t* p10 = p00 + static_cast<int64_t>(sw) * 3;
    const uint8_t* p11 = p10 + 3;
    const float one_wx = __fsub_rn(1.0f, wx), one_wy = __fsub_rn(1.0f, wy);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // top = p00 * (1 - wx) + p01 * wx; bot likewise;
      // v = top * (1 - wy) + bot * wy; d = (uint8_t)(v + 0.5f)
      const float top = __fadd_rn(__fmul_rn(static_cast<float>(p00[c]), one_wx),
                                  __fmul_rn(static_cast<float>(p01[c]), wx));
      const float bot = __fadd_rn(__fmul_rn(static_cast<float>(p10[c]), one_wx),
                                  __fmul_rn(static_cast<float>(p11[c]), wx));
      const float v = __fadd_rn(__fmul_rn(top, one_wy), __fmul_rn(bot, wy));
      d[c] = static_cast<uint8_t>(static_cast<int>(__fadd_rn(v, 0.5f)));
    }
  }
}

int cuda_status(cudaError_t e) { return e == cudaSuccess ? 0 : 100 + static_cast<int>(e); }

}  // namespace

int jpeg_card_version(int* major, int* minor, int* patch) {
  int rc = nvjpegGetProperty(MAJOR_VERSION, major);
  if (rc == 0) rc = nvjpegGetProperty(MINOR_VERSION, minor);
  if (rc == 0) rc = nvjpegGetProperty(PATCH_LEVEL, patch);
  return rc;
}

int jpeg_card_create(int backend, int device, void** out) {
  *out = nullptr;
  int rc = cuda_status(cudaSetDevice(device));
  if (rc) return rc;
  auto* dec = new Decoder();
  dec->device = device;
  rc = nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend), nullptr, nullptr,
                      0, &dec->handle);
  if (rc) {
    jpeg_card_destroy(dec);
    return rc;
  }
  *out = dec;
  return 0;
}

void jpeg_card_destroy(void* decoder) {
  auto* dec = static_cast<Decoder*>(decoder);
  if (!dec) return;
  if (dec->enc_params) nvjpegEncoderParamsDestroy(dec->enc_params);
  if (dec->enc_state) nvjpegEncoderStateDestroy(dec->enc_state);
  if (dec->handle) nvjpegDestroy(dec->handle);
  delete dec;
}

int jpeg_card_state_create(void* decoder, void** out) {
  nvjpegJpegState_t state = nullptr;
  const int rc = nvjpegJpegStateCreate(static_cast<Decoder*>(decoder)->handle,
                                       &state);
  *out = rc == 0 ? state : nullptr;
  return rc;
}

void jpeg_card_state_destroy(void* state) {
  if (state) nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state));
}

int jpeg_card_info(void* decoder, const unsigned char* data, size_t len,
                   int* h, int* w) {
  auto* dec = static_cast<Decoder*>(decoder);
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  *h = *w = 0;
  if (len == 0) return NVJPEG_STATUS_BAD_JPEG;
  const int rc = nvjpegGetImageInfo(dec->handle, data, len, &components,
                                    &subsampling, widths, heights);
  if (rc == 0) {
    *h = heights[0];
    *w = widths[0];
  }
  return rc;
}

int jpeg_card_decode(void* decoder, void* state, const unsigned char* data,
                     size_t len, unsigned char* dst, int w,
                     cudaStream_t stream) {
  auto* dec = static_cast<Decoder*>(decoder);
  nvjpegImage_t out = {};
  out.channel[0] = dst;
  out.pitch[0] = static_cast<unsigned int>(w) * 3;
  return nvjpegDecode(dec->handle, static_cast<nvjpegJpegState_t>(state), data,
                      len, NVJPEG_OUTPUT_RGBI, &out, stream);
}

int jpeg_card_encode(void* decoder, const unsigned char* rgb, int h, int w,
                     int quality, cudaStream_t stream,
                     std::vector<unsigned char>* out) {
  auto* dec = static_cast<Decoder*>(decoder);
  int rc = 0;
  if (!dec->enc_state) {
    rc = nvjpegEncoderStateCreate(dec->handle, &dec->enc_state, stream);
    if (rc) return rc;
  }
  if (!dec->enc_params) {
    rc = nvjpegEncoderParamsCreate(dec->handle, &dec->enc_params, stream);
    if (rc) return rc;
    rc = nvjpegEncoderParamsSetSamplingFactors(dec->enc_params, NVJPEG_CSS_420,
                                               stream);
    if (rc) return rc;
  }
  rc = nvjpegEncoderParamsSetQuality(dec->enc_params, quality, stream);
  if (rc) return rc;
  nvjpegImage_t src = {};
  src.channel[0] = const_cast<unsigned char*>(rgb);
  src.pitch[0] = static_cast<unsigned int>(w) * 3;
  rc = nvjpegEncodeImage(dec->handle, dec->enc_state, dec->enc_params, &src,
                         NVJPEG_INPUT_RGBI, w, h, stream);
  if (rc) return rc;
  size_t length = 0;
  rc = nvjpegEncodeRetrieveBitstream(dec->handle, dec->enc_state, nullptr,
                                     &length, stream);
  if (rc) return rc;
  rc = cuda_status(cudaStreamSynchronize(stream));
  if (rc) return rc;
  out->resize(length);
  rc = nvjpegEncodeRetrieveBitstream(dec->handle, dec->enc_state, out->data(),
                                     &length, stream);
  if (rc) return rc;
  out->resize(length);
  return cuda_status(cudaStreamSynchronize(stream));
}

cudaError_t jpeg_card_resize_launch(const uint8_t* src, const int64_t* offsets,
                                    const int32_t* hw, uint8_t* dst, int n,
                                    int size, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n) * size * size;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks64 = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(blocks64 < 65535 * 16 ? blocks64 : 65535 * 16);
  resize_bilinear_kernel<<<blocks, threads, 0, stream>>>(src, offsets, hw, dst,
                                                         n, size);
  return cudaGetLastError();
}
