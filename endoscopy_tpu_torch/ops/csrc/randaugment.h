// Host-side launch of the RandAugment kernel (randaugment.cu), shared by the
// kernel's source and its PyTorch binding (randaugment.cpp), so the two
// cannot disagree on the signature.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Launches one block per image on `stream` and returns the launch's error.
// `in` is (batch, hp, wp, 3) float32 or bf16 with element strides
// (sb, sy, sx, sc); `out` is a contiguous (batch, h, w, 3) of the same dtype;
// `pi` is (batch, pi_cols) int32 and `pf` (batch, 2 * n_slots) float32, both
// contiguous; `scratch` holds batch * 6 * h * w floats. With `crop`, each
// image's h x w window at (pi[2 + 2n], pi[3 + 2n]) is read.
cudaError_t randaugment_mc_launch(const void* in, void* out, const int* pi,
                                  const float* pf, float* scratch,
                                  bool is_bf16, int batch, int h, int w,
                                  int hp, int wp, int n_slots, int pi_cols,
                                  bool crop, int64_t sb, int64_t sy,
                                  int64_t sx, int64_t sc, cudaStream_t stream);
