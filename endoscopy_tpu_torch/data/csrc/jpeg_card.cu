// The card's JPEG route (bound by jpeg_card.cpp, driven by
// data/jpeg_card.py).
//
// Decode and encode are nvJPEG's (the CUDA toolkit's libnvjpeg): they take
// the place of libjpeg, which decodes on the host in the JAX package
// (native/loader.cpp:44-68) and in the port's CPU route
// (data/csrc/loader.cpp), not of a TPU kernel. A batch is decoded by one
// nvjpegDecodeBatched call into the layout of jpeg_card.h (16-byte aligned
// offsets and row pitches). One fixed backend, chosen by the caller
// (data/jpeg_card.py::BACKEND); nothing switches it.
//
// The resize is written here: data/csrc/loader.cpp::resize_bilinear (the
// JAX package's native/loader.cpp:70-101), host code in the JAX package, no
// TPU kernel. It keeps the C++ code's float32 operations in their order,
// each rounded on its own (the __f*_rn intrinsics are never contracted into
// fused multiply-adds; the build adds -fmad=false), and its truncations, so
// from the same decoded pixels it writes the host core's bytes exactly.
//
// Its bound is memory: the batch's decoded bytes read once plus its output
// bytes written once at the card's memory rate. On the card it is bound by
// instruction issue instead: the core's exact float32 order costs some 20
// instructions per output byte. The design: one block per (image, band of
// output rows) on a 2-D grid (no division per pixel). The x axis's
// (x0, wx, 1 - wx) is computed once per block and column into shared
// memory, the y axis's once per row: both are functions of the column or
// row alone, so computing them once changes no bit. The band's source rows
// are staged in shared memory by 16-byte cp.async copies in sub-bands, two
// halves of a ring: the next sub-band's rows load while the current one's
// compute. A thread owns kItems (column, channel) bytes of every row, their
// table entries in registers, and walks the rows keeping `top` and `bot`
// (the next row reads the same source row again: the same operations on the
// same bytes, so reusing them changes no bit either). The band's output is
// assembled in shared memory and written by 16-byte stores, bytes only at
// an unaligned head and tail. Columns come in chunks of at most kCols whose
// source span fits a ring slot, so any width runs. Bytes become floats by
// adding them to 2^23, not by a conversion instruction (those issue at a
// sixteenth of the float rate).

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

// a chunk of at most kCols columns; a thread per kItems (column, channel)
// bytes of it, each its own chain of rows
constexpr int kCols = 256;
constexpr int kItems = 4;
constexpr int kMaxThreads = (3 * kCols / kItems + 31) / 32 * 32;
constexpr int kMaxBandRows = 16;
constexpr int kOutTarget = 8192;  // a band's output bytes
// the source rows, staged in two halves: a sub-band of rows computes from
// one half while the next sub-band's rows load into the other
constexpr int kRingBytes = 16384;
constexpr int kMaxSlotBytes = kRingBytes / 6;  // >= 3 rows a half

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// One axis of the core's resize at output index i:
//   float f = (i + 0.5f) * scale - 0.5f;
//   int i0 = f < 0 ? 0 : (int)f; if (i0 > n - 2) i0 = n - 2;
//   float w = f - i0; if (w < 0) w = 0;
__device__ __forceinline__ void axis_at(int i, float scale, int n, int* i0,
                                        float* w) {
  const float f = __fsub_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), scale), 0.5f);
  int k = f < 0 ? 0 : static_cast<int>(f);
  if (k > n - 2) k = n - 2;
  float ww = __fsub_rn(f, static_cast<float>(k));
  if (ww < 0) ww = 0;
  *i0 = k;
  *w = ww;
}

// Writes s[0, len) to d[0, len): s and d agree modulo 16, so the aligned
// middle goes by 16-byte stores.
__device__ __forceinline__ void store_segment(uint8_t* d, const uint8_t* s,
                                              int len) {
  const int head = min(len, static_cast<int>(
                                (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15));
  const int words = (len - head) >> 4;
  const int nt = blockDim.x;
  for (int i = threadIdx.x; i < head; i += nt) d[i] = s[i];
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  for (int i = threadIdx.x; i < words; i += nt) dv[i] = sv[i];
  for (int i = head + (words << 4) + threadIdx.x; i < len; i += nt)
    d[i] = s[i];
}

// b (0..255) as a float, exactly: 2^23 + b holds b in its low mantissa bits.
__device__ __forceinline__ float byte_float(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// One source row's horizontal blend at a byte: p[0] * (1 - wx) + p[3] * wx
// (`top` of the core's resize on row y0, `bot` on row y0 + 1).
__device__ __forceinline__ float blend_x(const uint8_t* p, float wx,
                                         float owx) {
  return __fadd_rn(__fmul_rn(byte_float(p[0]), owx),
                   __fmul_rn(byte_float(p[3]), wx));
}

__global__ void __launch_bounds__(kMaxThreads)
resize_bilinear_kernel(const uint8_t* __restrict__ src,
                       const int64_t* __restrict__ offsets,
                       const int32_t* __restrict__ hw,
                       uint8_t* __restrict__ dst, int size, int band_rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ring = smem;
  uint8_t* const obuf = smem + kRingBytes;
  __shared__ int col_x0[kCols];
  __shared__ float col_w[kCols], col_ow[kCols];
  __shared__ int row_y0[kMaxBandRows];
  __shared__ float row_w[kMaxBandRows], row_ow[kMaxBandRows];
  __shared__ int chunk_cols;

  const int t = threadIdx.x, nt = blockDim.x;
  const int img = blockIdx.y;
  const int r0 = blockIdx.x * band_rows;
  const int nrows = min(band_rows, size - r0);
  const int64_t row_bytes = static_cast<int64_t>(size) * 3;
  uint8_t* const out_band =
      dst + (static_cast<int64_t>(img) * size + r0) * row_bytes;
  const int sh = hw[2 * img], sw = hw[2 * img + 1];
  if (sh < 2 || sw < 2) {
    for (int64_t i = t; i < nrows * row_bytes; i += nt) out_band[i] = 0;
    return;
  }
  const float sx = __fdiv_rn(static_cast<float>(sw), static_cast<float>(size));
  const float sy = __fdiv_rn(static_cast<float>(sh), static_cast<float>(size));
  const uint8_t* const img_src = src + offsets[img];
  const int64_t pitch = jpeg_card_row_pitch(sw);
  const int row_phase = static_cast<int>(row_bytes & 15);

  // the band's rows: row j reads source rows row_y0[j] and row_y0[j] + 1
  if (t < nrows) {
    int y0;
    float w;
    axis_at(r0 + t, sy, sh, &y0, &w);
    row_y0[t] = y0;
    row_w[t] = w;
    row_ow[t] = __fsub_rn(1.0f, w);
  }

  for (int c0 = 0; c0 < size;) {
    __syncthreads();  // the last chunk's tables, ring and output are free
    // the column table, once per column of the chunk's candidates
    const int cand = min(kCols, size - c0);
    for (int c = t; c < cand; c += nt) {
      int x0;
      float w;
      axis_at(c0 + c, sx, sw, &x0, &w);
      col_x0[c] = x0;
      col_w[c] = w;
      col_ow[c] = __fsub_rn(1.0f, w);
    }
    if (t == 0) chunk_cols = cand;
    __syncthreads();
    const int first = col_x0[0];
    // the chunk: the columns whose source span fits a slot (a prefix:
    // x0 does not decrease with the column)
    for (int c = t; c < cand; c += nt)
      if ((col_x0[c] + 2 - first) * 3 + 48 > kMaxSlotBytes)
        atomicMin(&chunk_cols, c);
    __syncthreads();
    const int k = chunk_cols;
    const int last = col_x0[k - 1];
    // a source row's span: [lo, lo + 16 cpr) from the row's start (every
    // row of the image starts at one offset modulo 16)
    const int lead0 = static_cast<int>(
        reinterpret_cast<uintptr_t>(img_src + 3 * first) & 15);
    const int lo = 3 * first - lead0;
    const int cpr = (3 * (last + 2) - lo + 15) >> 4;
    const int slot_bytes = cpr * 16;
    const int half_slots = (kRingBytes / 2) / slot_bytes;
    // two sub-bands or more, of g rows: their source rows, at most
    // (g - 1) sy + 3 of them, fit a half
    const int g = min((nrows + 1) / 2,
                      1 + static_cast<int>((half_slots - 3) / sy));
    const int subs = (nrows + g - 1) / g;
    // the output: rows of 3k bytes at obuf + j * stride + the phase of
    // their place in dst; one range when the chunk is the whole row
    const bool whole = k == size;
    const int stride = whole ? static_cast<int>(row_bytes)
                             : ((3 * k + 15) & ~15) + 16;
    uint8_t* const out_chunk = out_band + 3 * c0;
    const int cphase = static_cast<int>(
        reinterpret_cast<uintptr_t>(out_chunk) & 15);

    // this thread's bytes of every row: q = t + i nt is column q / 3,
    // channel q % 3; each keeps its column's table entry in registers
    int xo[kItems];
    bool mine[kItems];
    float wx[kItems], owx[kItems], top[kItems], bot[kItems];
    uint8_t* const spare = obuf + nrows * stride + 16;  // the idle items' byte
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int q = t + i * nt;
      mine[i] = q < 3 * k;
      const int cc = mine[i] ? q / 3 : 0;
      xo[i] = lead0 + 3 * (col_x0[cc] - first) + (q - 3 * cc);
      wx[i] = col_w[cc];
      owx[i] = col_ow[cc];
      top[i] = bot[i] = 0.0f;
    }

    // sub-band s's source rows into half s & 1 (one commit group)
    auto stage = [&](int s) {
      const int ja = s * g, jb = min(nrows, ja + g);
      const int y_first = row_y0[ja];
      const int rows = row_y0[jb - 1] + 2 - y_first;
      uint8_t* to = ring + (s & 1) * half_slots * slot_bytes;
      const uint8_t* from = img_src + y_first * pitch + lo;
      for (int i = t; i < rows * cpr; i += nt) {
        const int e = i / cpr, c = i - e * cpr;
        cp_async16(to + e * slot_bytes + 16 * c, from + e * pitch + 16 * c);
      }
      cp_async_commit();
    };

    // top and bot of the last source row pair are kept: the next output
    // row reads one or both again (the same operations on the same bytes)
    int prev = -2;
    stage(0);
    for (int s = 0; s < subs; ++s) {
      if (s + 1 < subs) {  // the next rows load while these compute
        stage(s + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const int ja = s * g, jb = min(nrows, ja + g);
      const int y_first = row_y0[ja];
      const uint8_t* half = ring + (s & 1) * half_slots * slot_bytes;
      for (int j = ja; j < jb; ++j) {
        const int y = row_y0[j];
        if (y != prev) {
          const uint8_t* ra = half + (y - y_first) * slot_bytes;
#pragma unroll
          for (int i = 0; i < kItems; ++i) {
            top[i] = y == prev + 1 ? bot[i] : blend_x(ra + xo[i], wx[i], owx[i]);
            bot[i] = blend_x(ra + slot_bytes + xo[i], wx[i], owx[i]);
          }
          prev = y;
        }
        const float wy = row_w[j], owy = row_ow[j];
        uint8_t* orow = obuf + j * stride +
                        (whole ? cphase : (cphase + j * row_phase) & 15);
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          // v = top * (1 - wy) + bot * wy; d = (uint8_t)(v + 0.5f)
          const float v = __fadd_rn(__fmul_rn(top[i], owy), __fmul_rn(bot[i], wy));
          *(mine[i] ? orow + t + i * nt : spare) =
              static_cast<uint8_t>(static_cast<int>(__fadd_rn(v, 0.5f)));
        }
      }
      __syncthreads();  // half s & 1 is free for sub-band s + 2
    }
    if (whole) {
      store_segment(out_chunk, obuf + cphase, static_cast<int>(nrows * row_bytes));
    } else {
      for (int j = 0; j < nrows; ++j)
        store_segment(out_chunk + j * row_bytes,
                      obuf + j * stride + ((cphase + j * row_phase) & 15), 3 * k);
    }
    c0 += k;
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

int jpeg_card_batch_init(void* decoder, void* state, int batch_size) {
  return nvjpegDecodeBatchedInitialize(
      static_cast<Decoder*>(decoder)->handle,
      static_cast<nvjpegJpegState_t>(state), batch_size, 1, NVJPEG_OUTPUT_RGBI);
}

int jpeg_card_decode_batch(void* decoder, void* state,
                           const unsigned char* const* data,
                           const size_t* lengths, unsigned char* const* dst,
                           const int64_t* pitch, int n, cudaStream_t stream) {
  std::vector<nvjpegImage_t> out(n);
  for (int k = 0; k < n; ++k) {
    out[k] = {};
    out[k].channel[0] = dst[k];
    out[k].pitch[0] = static_cast<unsigned int>(pitch[k]);
  }
  return nvjpegDecodeBatched(static_cast<Decoder*>(decoder)->handle,
                             static_cast<nvjpegJpegState_t>(state), data,
                             lengths, out.data(), stream);
}

int jpeg_card_decode(void* decoder, void* state, const unsigned char* data,
                     size_t len, unsigned char* dst, int64_t pitch,
                     cudaStream_t stream) {
  auto* dec = static_cast<Decoder*>(decoder);
  nvjpegImage_t out = {};
  out.channel[0] = dst;
  out.pitch[0] = static_cast<unsigned int>(pitch);
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
  if (n == 0 || size == 0) return cudaSuccess;
  const int cols = size < kCols ? size : kCols;
  int band_rows = kOutTarget / (3 * cols);
  band_rows = band_rows < 1 ? 1 : (band_rows > kMaxBandRows ? kMaxBandRows : band_rows);
  const int out_bytes = band_rows * (((3 * cols + 15) & ~15) + 16) + 32;
  const dim3 grid((size + band_rows - 1) / band_rows, n);
  const int threads = ((3 * cols + kItems - 1) / kItems + 31) / 32 * 32;
  resize_bilinear_kernel<<<grid, threads, kRingBytes + out_bytes, stream>>>(
      src, offsets, hw, dst, size, band_rows);
  return cudaGetLastError();
}
