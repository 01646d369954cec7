// Host-side interface of the RandAugment kernel (randaugment.cu), shared by
// the kernel's source and its PyTorch binding (randaugment.cpp), so the two
// cannot disagree on the signature or on the shared-memory arithmetic.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Shared memory a block may opt into on Hopper (227 KB).
constexpr size_t kRandaugmentSmemLimit = 232448;
// The largest output side the on-chip design holds: at a cluster of 8 blocks
// each block keeps ceil(side / 8) rows of four float32 planes on chip.
constexpr int kRandaugmentMaxSide = 328;

// Dynamic shared memory of one block for an output side `side` split over a
// cluster of `cluster` blocks: four float32 planes (three state, one spare)
// of ceil(side / cluster) rows, three per-row/column shift tables, two sets
// of 3 x 256 histograms, the LUT and the reduction scratch.
constexpr size_t randaugment_smem_bytes(int side, int cluster) {
  return 16 * (size_t)((side + cluster - 1) / cluster) * side + 12 * (size_t)side
         + 7440;
}

static_assert(randaugment_smem_bytes(kRandaugmentMaxSide, 8) <= kRandaugmentSmemLimit,
              "the stated side limit must fit");
static_assert(randaugment_smem_bytes(kRandaugmentMaxSide + 1, 8) > kRandaugmentSmemLimit,
              "the stated side limit must be the largest that fits");

// The smallest cluster (2, 4 or 8 blocks) whose blocks hold `side`; 0 if
// none does.
constexpr int randaugment_cluster_size(int side) {
  return randaugment_smem_bytes(side, 2) <= kRandaugmentSmemLimit   ? 2
         : randaugment_smem_bytes(side, 4) <= kRandaugmentSmemLimit ? 4
         : randaugment_smem_bytes(side, 8) <= kRandaugmentSmemLimit ? 8
                                                                    : 0;
}

// Launches one cluster of randaugment_cluster_size(side) blocks per image on
// `stream` and returns the launch's error. `in` is (batch, hs, ws, 3)
// float32 or bf16 with element strides (sb, sy, sx, sc); `out` is a
// contiguous (batch, side, side, 3) of the same dtype; `pi` is (batch,
// pi_cols) int32 and `pf` (batch, 2 * n_slots) float32, both contiguous.
// With `crop`, each image's side x side window at
// (pi[2 + 2n], pi[3 + 2n]) is read in the frame of `in` reflect-padded by
// `pad` (no edge repeat); without it, side == hs == ws and pad == 0.
cudaError_t randaugment_mc_launch(const void* in, void* out, const int* pi,
                                  const float* pf, bool is_bf16, int batch,
                                  int side, int hs, int ws, int pad,
                                  int n_slots, int pi_cols, bool crop,
                                  int64_t sb, int64_t sy, int64_t sx,
                                  int64_t sc, cudaStream_t stream);

// What the launch at `side` gets on this card: the kernel's registers per
// thread and local (spill) bytes, and how many clusters of that shape can
// be resident at once (cudaOccupancyMaxActiveClusters).
cudaError_t randaugment_mc_occupancy(bool is_bf16, int side,
                                     int* max_active_clusters, int* regs,
                                     int* local_bytes);
