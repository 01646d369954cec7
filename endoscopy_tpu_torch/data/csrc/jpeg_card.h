// The card's JPEG route: nvJPEG's batched decode and its encode, and the
// bilinear resize kernel (jpeg_card.cu). A plain C++ interface, so that
// only the small binding (jpeg_card.cpp) includes PyTorch's headers.
//
// The decoded batch's layout: image i's h x w interleaved RGB rows start at
// flat + offsets[i], each row jpeg_card_row_pitch(w) bytes apart (3 * w
// rounded up to 16), so that every offset and every row starts on a
// 16-byte boundary; the flat buffer starts on one too and its length is a
// multiple of 16.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <vector>

constexpr int kJpegCardAlign = 16;

// The bytes between two rows of a w-pixel RGB image in the decoded batch.
__host__ __device__ inline int64_t jpeg_card_row_pitch(int w) {
  return (static_cast<int64_t>(w) * 3 + kJpegCardAlign - 1) /
         kJpegCardAlign * kJpegCardAlign;
}

// nvJPEG's version; returns the status of nvjpegGetProperty.
int jpeg_card_version(int* major, int* minor, int* patch);

// A decoder (an nvJPEG handle and its encoder state) on `device` with
// nvjpegBackend_t `backend`. Returns the nvjpegStatus_t (or 100 + a
// cudaError_t) of its creation; *out is null on failure. The handle may be
// shared by threads; each caller decodes with a state of its own.
int jpeg_card_create(int backend, int device, void** out);
void jpeg_card_destroy(void* decoder);

// A decode state (nvjpegJpegState_t) of `decoder`: one caller at a time.
int jpeg_card_state_create(void* decoder, void** out);
void jpeg_card_state_destroy(void* state);

// Height and width of a JPEG from its header (nvjpegGetImageInfo).
int jpeg_card_info(void* decoder, const unsigned char* data, size_t len,
                   int* h, int* w);

// Makes `state` decode batches of `batch_size` images to interleaved RGB
// (nvjpegDecodeBatchedInitialize).
int jpeg_card_batch_init(void* decoder, void* state, int batch_size);

// Decodes `n` JPEGs in one nvjpegDecodeBatched call with `state` (made for
// batches of `n` by jpeg_card_batch_init): payload k's RGB rows to dst[k],
// pitch[k] bytes apart, on `stream`.
int jpeg_card_decode_batch(void* decoder, void* state,
                           const unsigned char* const* data,
                           const size_t* lengths, unsigned char* const* dst,
                           const int64_t* pitch, int n, cudaStream_t stream);

// Decodes one JPEG with `state` (nvjpegDecode) to its RGB rows at `dst`,
// `pitch` bytes apart, on `stream`: the re-decode that finds which
// payloads of a failed batch fail.
int jpeg_card_decode(void* decoder, void* state, const unsigned char* data,
                     size_t len, unsigned char* dst, int64_t pitch,
                     cudaStream_t stream);

// Encode h*w interleaved RGB rows in device memory at `quality` with 4:2:0
// chroma (nvjpegEncodeImage), the bitstream into *out. Synchronizes
// `stream`.
int jpeg_card_encode(void* decoder, const unsigned char* rgb, int h, int w,
                     int quality, cudaStream_t stream,
                     std::vector<unsigned char>* out);

// The bilinear resize of data/csrc/loader.cpp::resize_bilinear on the card:
// image i's (hw[2i], hw[2i+1]) RGB rows at src + offsets[i] in the decoded
// batch's layout (above) to dst's (size, size, 3) slot i. An image with a
// side below 2 gets zeros. `src` must start on a 16-byte boundary and hold
// a multiple of 16 bytes. Returns the launch's cudaGetLastError().
cudaError_t jpeg_card_resize_launch(const uint8_t* src, const int64_t* offsets,
                                    const int32_t* hw, uint8_t* dst, int n,
                                    int size, cudaStream_t stream);
