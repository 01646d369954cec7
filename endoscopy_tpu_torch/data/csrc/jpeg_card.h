// The card's JPEG route: nvJPEG's decode and encode, and the bilinear
// resize kernel (jpeg_card.cu). A plain C++ interface, so that only the
// small binding (jpeg_card.cpp) includes PyTorch's headers.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <vector>

// nvJPEG's version; returns the status of nvjpegGetProperty.
int jpeg_card_version(int* major, int* minor, int* patch);

// A decoder (an nvJPEG handle and its encoder state) on `device` with
// nvjpegBackend_t `backend`. Returns the nvjpegStatus_t (or 100 + a
// cudaError_t) of its creation; *out is null on failure. The handle may be
// shared by threads; each thread decodes with a state of its own.
int jpeg_card_create(int backend, int device, void** out);
void jpeg_card_destroy(void* decoder);

// A decode state (nvjpegJpegState_t) of `decoder`: one per thread at a time.
int jpeg_card_state_create(void* decoder, void** out);
void jpeg_card_state_destroy(void* state);

// Height and width of a JPEG from its header (nvjpegGetImageInfo).
int jpeg_card_info(void* decoder, const unsigned char* data, size_t len,
                   int* h, int* w);

// Decode a JPEG with `state` into interleaved RGB rows (NVJPEG_OUTPUT_RGBI)
// at `dst`, device memory of h*w*3 bytes, on `stream`.
int jpeg_card_decode(void* decoder, void* state, const unsigned char* data,
                     size_t len, unsigned char* dst, int w,
                     cudaStream_t stream);

// Encode h*w interleaved RGB rows in device memory at `quality` with 4:2:0
// chroma (nvjpegEncodeImage), the bitstream into *out. Synchronizes
// `stream`.
int jpeg_card_encode(void* decoder, const unsigned char* rgb, int h, int w,
                     int quality, cudaStream_t stream,
                     std::vector<unsigned char>* out);

// The bilinear resize of data/csrc/loader.cpp::resize_bilinear on the card:
// image i's (hw[2i], hw[2i+1]) RGB rows at src + offsets[i] to dst's
// (size, size, 3) slot i, one thread per output pixel. An image with a
// side below 2 gets zeros. Returns the launch's cudaGetLastError().
cudaError_t jpeg_card_resize_launch(const uint8_t* src, const int64_t* offsets,
                                    const int32_t* hw, uint8_t* dst, int n,
                                    int size, cudaStream_t stream);
