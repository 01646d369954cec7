// RandAugmentMC(n, 10) + CutoutAbs(16), one thread-block cluster per image,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel endoscopy_tpu/ops/randaugment_kernel.py
// (_randaugment_mc_pallas -> _kernel, pallas_call at :373). It computes what
// _kernel computes, pixel for pixel:
//   - an optional crop window: each image's side x side window at (top, left)
//     in the frame of the input reflect-padded by `pad`; the pad is resolved
//     in the load (row and column indices are mirrored, no edge repeat), so
//     no padded batch exists in device memory. pad = 0 is the Pallas
//     kernel's crop-fused mode on an already padded input;
//   - n sampled op slots from the 14-op FixMatch pool; an image runs only its
//     own op (the op id is uniform in a cluster, so no branch diverges);
//   - CutoutAbs(16) filled with 127, with inclusive bounds (17 px wide).
//
// Bound. A few operations per pixel and op: the card's memory rate bounds
// the work, each input byte read once and each output byte written once
// (0.0403 ms for 224 images of 224 px in bf16). So the image must not go
// back to device memory between ops. Its float32 state (3 x 224 x 224 x 4 B
// = 602 KB; bf16 or uint8 would not hold the non-integer pixels that one op
// hands the next) does not fit one block's 227 KB of shared memory, so:
//
// Design. One cluster of C blocks per image (C = 2, 4 or 8, the smallest
// that fits; 4 at 224 px). Block k owns rows [kR, kR + R), R = ceil(side/C),
// as three float32 planes plus one spare plane in its shared memory. The
// cluster's blocks read each other's planes through distributed shared
// memory (DSMEM), so the state never leaves the chip:
//   - load: where the pixels are contiguous in 16-byte aligned rows, each
//     warp brings in runs of a row as 16-byte vectors, stages them in the
//     spare plane and de-interleaves them into the planes with consecutive
//     lanes on consecutive pixels; mirrored columns (and any other layout)
//     are read pixel by pixel;
//   - pointwise ops (brightness, posterize, solarize, color) run in place on
//     each block's own rows, with no cluster traffic;
//   - reductions (autocontrast min/max, the contrast float64 sum, the 3 x
//     256 equalize histograms) are per-block partials in shared memory; after
//     one cluster barrier every block reads all peers' partials in rank
//     order, so every block builds the same statistics and LUT. Partials are
//     double-buffered by the reduction's parity, so one barrier suffices;
//   - geometry (rotate, shear, translate) first writes each own output
//     pixel's source through the composed Paeth index x' = x + s3[y],
//     y'' = y + s2[x'], x'' = x' + s1[y''] (zero where a step leaves the
//     image) into the spare plane; a source row lies up to 60 rows away at
//     224 px, so in any block. Then, one channel at a time, each thread
//     gathers its pixels into registers (all loads in flight at once), and
//     after a cluster barrier writes them into its own plane;
//   - sharpness computes each channel into the spare plane, reading one halo
//     row from each neighbour, and copies it back after a cluster barrier;
//   - store: the mirror of the load, with the cutout applied; a last cluster
//     barrier keeps each block's shared memory alive until no peer reads it.
// At 224 px a block holds 56 rows in 210,832 B of shared memory, so one
// 512-thread block runs on an SM and 30 images are in flight (7.5 waves for
// 224 images). The kernel is therefore bound by each image's latency, not
// by the memory rate: the load, the ops and the store of one image run one
// after another on its SMs, with 16 warps to hide each step's latency
// (PERF.md). The largest side the design holds is
// kRandaugmentMaxSide = 328 (clusters of 8); the binding and the wrapper
// refuse larger ones.
//
// Exactness. The float32 arithmetic is the reference's as XLA evaluates it:
// constant quotients are folded (v * 0.9 / 10 is v * 0.09f; / 13 and / (h*w)
// are products with the float32 reciprocal) and a product that feeds a sum
// is one fused multiply-add. Those are written out with __fmaf_rn, and the
// file is built with -fmad=false so nvcc contracts nothing else. tan/sin of
// the float32 angle are taken in float64 and rounded to float32.
// Autocontrast's scale stays a true division; posterize multiplies by the
// reciprocal of a power of two, which is exact.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "randaugment.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Own pixels per thread at most: the shared-memory limit keeps a block's
// rows x side (R S) at or below 14,063, so ceil(R S / kThreads) <= 28.
constexpr int kPerThread = 28;
constexpr int kCutout = 16;
constexpr float kCutoutFill = 127.0f;

enum Op {
  kAutocontrast = 0, kBrightness = 1, kColor = 2, kContrast = 3,
  kEqualize = 4, kIdentity = 5, kPosterize = 6, kRotate = 7,
  kSharpness = 8, kShearX = 9, kShearY = 10, kSolarize = 11,
  kTranslateX = 12, kTranslateY = 13,
};

// Element I/O in the caller's dtype.
template <typename T> struct IO;

template <> struct IO<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct IO<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float clip255(float x) {
  return fminf(fmaxf(x, 0.0f), 255.0f);
}

// PIL 'L' luminance: fma(0.114, B, fma(0.299, R, 0.587 G)).
__device__ __forceinline__ float luminance(float r, float g, float b) {
  return __fmaf_rn(0.114f, b, __fmaf_rn(0.299f, r, 0.587f * g));
}

// ImageEnhance blend: clip(deg + factor * (x - deg)) with one rounding.
__device__ __forceinline__ float blend(float deg, float x, float factor) {
  return clip255(__fmaf_rn(factor, x - deg, deg));
}

// Index of the reflect-padded frame (no edge repeat) in [0, n); needs
// -(n - 1) <= i <= 2 (n - 1), which pad < n guarantees.
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// floor(p / d) for 0 <= p < 2^16 through the float32 reciprocal of d: the
// product's error stays far below the 0.5 / d margin that p + 0.5 keeps.
__device__ __forceinline__ int div_small(int p, float inv_d) {
  return __float2int_rz(((float)p + 0.5f) * inv_d);
}

struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct SumOp { __device__ double operator()(double a, double b) const { return a + b; } };

// Reduce one value per thread over the block; every thread gets the result.
// `identity` pads the lanes of the last step that hold no warp's partial.
template <typename V, typename Op>
__device__ V block_reduce(V v, V identity, V* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// For the own pixels p < n: store(p, load(p)), K pixels per thread at a
// time, all K loads issued before the first store. With one block per SM
// the loads' latency is what bounds every pass; a store between two loads
// would keep the compiler from overlapping them.
template <int K, typename Load, typename Store>
__device__ __forceinline__ void batched(int n, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += K * kThreads) {
    float v[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int p = base + u * kThreads;
      if (p < n) v[u] = load(p);
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int p = base + u * kThreads;
      if (p < n) store(p, v[u]);
    }
  }
}

// In place over one own plane: x = f(x).
template <int K, typename F>
__device__ __forceinline__ void pointwise(float* plane, int n, F f) {
  batched<K>(n, [&](int p) { return f(plane[p]); },
             [&](int p, float x) { plane[p] = x; });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
randaugment_kernel(const T* __restrict__ in, T* __restrict__ out,
                   const int* __restrict__ pi, const float* __restrict__ pf,
                   int S, int R, int hs, int ws, int pad, int n_slots,
                   int pi_cols, int crop, long long sb, long long sy,
                   long long sx, long long sc) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  // layout: see randaugment_smem_bytes (16 R S + 12 S + 7440 bytes)
  double* red_d = reinterpret_cast<double*>(smem);   // [32]
  double* part_d = red_d + 32;                        // [2]
  float** peers = reinterpret_cast<float**>(part_d + 2);  // [8]
  float* planes = reinterpret_cast<float*>(peers + 8);    // [4][R][S]
  int* shifts = reinterpret_cast<int*>(planes + 4 * R * S);  // [3][S]
  int* hist = shifts + 3 * S;                         // [2][3][256]
  float* part_f = reinterpret_cast<float*>(hist + 2 * 768);  // [2][8]
  float* red_f = part_f + 16;                         // [32]
  unsigned char* lut = reinterpret_cast<unsigned char*>(red_f + 32);  // [3][256]

  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int r0 = rank * R;                          // first own row
  const int nrows = max(0, min(S, r0 + R) - r0);    // own rows
  const int npix = nrows * S;                       // own pixels
  const int plane = R * S;                          // plane stride
  const float inv_w = 1.0f / (float)S;
  const float inv_r = 1.0f / (float)R;
  const int* p_i = pi + (size_t)b * pi_cols;
  const float* p_f = pf + (size_t)b * 2 * n_slots;

  if (tid < C) peers[tid] = cluster.map_shared_rank(planes, tid);

  // ---- load: window row r is source row reflect(y0 + r), column j source
  // column reflect(x0 + j); offsets are clamped so a bad one cannot read
  // outside the padded frame
  int y0 = 0, x0 = 0;
  if (crop) {
    y0 = min(max(p_i[2 + 2 * n_slots], 0), hs + 2 * pad - S) - pad;
    x0 = min(max(p_i[3 + 2 * n_slots], 0), ws + 2 * pad - S) - pad;
  }
  {
    const T* src = in + (size_t)b * sb;
    // window columns [ja, jb) read source columns [xa, xb) in order; the
    // others are mirrored
    const int ja = min(S, max(0, -x0));
    const int jb = max(ja, min(S, ws - x0));
    const int xa = x0 + ja, xb = x0 + jb;
    // Contiguous pixels in 16-byte aligned rows: a warp brings in a run of
    // W = 32 G pixels of one row as 16-byte loads (G = 8 bf16 or 4 float32
    // pixels, three vectors, per lane), up to two runs in flight, stages
    // them in the spare plane and de-interleaves them from there with
    // consecutive lanes on consecutive pixels. Scalar 2-byte loads kept too
    // few bytes in flight to stream HBM. A row's byte length is a multiple
    // of 16, so a vector lies wholly inside the row or wholly past its end.
    constexpr int G = sizeof(T) == 2 ? 8 : 4;              // pixels per lane
    constexpr int W = 32 * G;                              // pixels per step
    constexpr int kStepBytes = W * 3 * (int)sizeof(T);     // 1536
    const int steps_in_flight = min(2, plane * 4 / (kWarps * kStepBytes));
    const bool vec = sx == 3 && sc == 1 && steps_in_flight > 0 &&
                     plane % 4 == 0 && (sy * (long long)sizeof(T)) % 16 == 0 &&
                     (ws * 3 * (int)sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0 && xb > xa;
    int jv0 = 0, jv1 = 0;  // window columns the vector path writes
    if (vec) {
      jv0 = ja;
      jv1 = jb;
      const int warp = tid >> 5, lane = tid & 31;
      const int xs0 = xa - xa % G;               // aligned first column
      const int nstep = (xb - xs0 + W - 1) / W;  // steps per row
      const int units = nrows * nstep;
      const int row_vecs = ws * 3 * (int)sizeof(T) / 16;
      T* stage = reinterpret_cast<T*>(planes + 3 * plane) +
                 warp * steps_in_flight * (kStepBytes / (int)sizeof(T));
      for (int u0 = warp; u0 < units; u0 += steps_in_flight * kWarps) {
        uint4 raw[2][3];
        int lrs[2], xss[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int unit = u0 + h * kWarps;
          lrs[h] = -1;
          if (h >= steps_in_flight || unit >= units) continue;
          const int lr = unit / nstep;
          const int xs = xs0 + (unit - lr * nstep) * W;
          lrs[h] = lr;
          xss[h] = xs;
          const uint4* row = reinterpret_cast<const uint4*>(
              src + (long long)reflect(y0 + r0 + lr, hs) * sy);
          const int v0 = (xs + lane * G) * 3 * (int)sizeof(T) / 16;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (v0 + k < row_vecs) raw[h][k] = row[v0 + k];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (lrs[h] < 0) continue;
          uint4* st = reinterpret_cast<uint4*>(stage + h * (kStepBytes / (int)sizeof(T)));
#pragma unroll
          for (int k = 0; k < 3; ++k) st[lane * 3 + k] = raw[h][k];
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (lrs[h] < 0) continue;
          const T* st = stage + h * (kStepBytes / (int)sizeof(T));
          float* dst = planes + lrs[h] * S - x0;  // + source column
#pragma unroll
          for (int k = 0; k < G; ++k) {
            const int q = lane + 32 * k, xsrc = xss[h] + q;
            if (xsrc >= xa && xsrc < xb) {
#pragma unroll
              for (int c = 0; c < 3; ++c) dst[c * plane + xsrc] = IO<T>::load(st + 3 * q + c);
            }
          }
        }
        __syncwarp();
      }
    }
    // every other window pixel (all of them when the vector path does not
    // apply), one by one: consecutive threads on consecutive columns
    const int nother = S - (jv1 - jv0);
    const int total = nrows * nother;
    constexpr int K = 4;
    for (int base = tid; base < total; base += K * kThreads) {
      float v[K][3];
      int dsts[K];
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int q = min(base + u * kThreads, total - 1);
        const int lr = q / nother, k = q - lr * nother;
        const int j = k < jv0 ? k : k + (jv1 - jv0);
        dsts[u] = lr * S + j;
        const T* s = src + (long long)reflect(y0 + r0 + lr, hs) * sy +
                     (long long)reflect(x0 + j, ws) * sx;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[u][c] = IO<T>::load(s + c * sc);
      }
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (base + u * kThreads >= total) break;
#pragma unroll
        for (int c = 0; c < 3; ++c) planes[c * plane + dsts[u]] = v[u][c];
      }
    }
  }
  // every block of the cluster has started (its shared memory may be read)
  // and loaded its rows
  cluster.sync();

  // plane c is planes[c * plane ...]; own rows are read as shared memory,
  // the peers' through their DSMEM window (peers[k])
  int nred = 0;  // reductions so far; their parity picks the partials buffer

  for (int slot = 0; slot < n_slots; ++slot) {
    const int op = p_i[2 + 2 * slot];
    if (p_i[3 + 2 * slot] != 1 || op == kIdentity) continue;  // uniform
    const float v = p_f[2 * slot];
    const float sign = p_f[2 * slot + 1];
    const float factor = __fmaf_rn(v, 0.9f / 10.0f, 0.05f);

    if (op == kRotate || op == kShearX || op == kShearY || op == kTranslateX ||
        op == kTranslateY) {
      const float deg = sign * truncf(v * (30.0f / 10.0f));
      const float theta = deg * (float)(3.14159265358979323846 / 180.0);
      const float a = (float)(-tan((double)(theta / 2.0f)));
      const float sb_ = (float)sin((double)theta);
      const float mag = v * (0.3f / 10.0f);
      const float shear = sign * mag;
      const int trans_x = (int)truncf(sign * mag * (float)S);
      const int trans_y = (int)truncf(sign * mag * (float)S);
      const int sa1 = (int)floorf(shear * 65536.0f + 0.5f);
      const int sa2 = (int)floorf((0.5f + 0.5f * shear) * 65536.0f + 0.5f);
      const float cs = (float)S / 2.0f;
      int* s1 = shifts;          // over rows
      int* s2 = shifts + S;      // over columns
      int* s3 = shifts + 2 * S;  // over rows
      for (int i = tid; i < S; i += kThreads) {
        const int rot = (int)floorf(__fmaf_rn(a, ((float)i + 0.5f) - cs, 0.5f));
        int r1 = 0, c2 = 0;
        if (op == kRotate) {
          r1 = rot;
          c2 = (int)floorf(__fmaf_rn(sb_, ((float)i + 0.5f) - cs, 0.5f));
        } else if (op == kShearX) {
          r1 = (sa1 * i + sa2) >> 16;
        } else if (op == kTranslateX) {
          r1 = trans_x;
        } else if (op == kShearY) {
          c2 = (sa1 * i + sa2) >> 16;
        } else {
          c2 = trans_y;
        }
        s1[i] = r1;
        s2[i] = c2;
        s3[i] = op == kRotate ? rot : 0;
      }
      __syncthreads();
      // the source of each own output pixel, (owner << 24) | offset in the
      // owner's plane, or -1 where a step leaves the image (zero fill); in
      // the spare plane
      int* src_of = reinterpret_cast<int*>(planes + 3 * plane);
      for (int p = tid; p < npix; p += kThreads) {
        const int lr = div_small(p, inv_w);
        const int y = r0 + lr, x = p - lr * S;
        int q = -1;
        const int x1 = x + s3[y];
        if (x1 >= 0 && x1 < S) {
          const int y2 = y + s2[x1];
          if (y2 >= 0 && y2 < S) {
            const int x3 = x1 + s1[y2];
            if (x3 >= 0 && x3 < S) {
              const int owner = div_small(y2, inv_r);
              q = owner << 24 | ((y2 - owner * R) * S + x3);
            }
          }
        }
        src_of[p] = q;
      }
      cluster.sync();  // the peers' planes hold the previous op's result
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v[kPerThread];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int p = tid + k * kThreads;
          if (p >= npix) break;
          const int q = src_of[p];
          const int owner = q >> 24, at = c * plane + (q & 0xffffff);
          v[k] = q < 0 ? 0.0f : owner == rank ? planes[at] : peers[owner][at];
        }
        cluster.sync();  // no block reads plane c any more
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int p = tid + k * kThreads;
          if (p >= npix) break;
          planes[c * plane + p] = v[k];
        }
      }
    } else if (op == kSharpness) {
      cluster.sync();
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* mine = planes + c * plane;
        // row r0 - 1 is the last row of block rank - 1, row r0 + nrows the
        // first of block rank + 1; each is read only where it exists
        const float* up = peers[max(rank - 1, 0)] + c * plane + (R - 1) * S;
        const float* dn = peers[min(rank + 1, C - 1)] + c * plane;
        float* spare = planes + 3 * plane;
#pragma unroll 4
        for (int p = tid; p < npix; p += kThreads) {
          const int lr = div_small(p, inv_w);
          const int y = r0 + lr, x = p - lr * S;
          const float xv = mine[p];
          if (y == 0 || y == S - 1 || x == 0 || x == S - 1) {
            spare[p] = clip255(xv);
            continue;
          }
          float u0, u1, u2, d0, d1, d2;
          if (lr > 0) {
            u0 = mine[p - S - 1]; u1 = mine[p - S]; u2 = mine[p - S + 1];
          } else {
            u0 = up[x - 1]; u1 = up[x]; u2 = up[x + 1];
          }
          if (lr + 1 < nrows) {
            d0 = mine[p + S - 1]; d1 = mine[p + S]; d2 = mine[p + S + 1];
          } else {
            d0 = dn[x - 1]; d1 = dn[x]; d2 = dn[x + 1];
          }
          // the nine SMOOTH taps, summed in the reference's order
          float s = u0 + u1;
          s = s + u2;
          s = s + mine[p - 1];
          s = __fmaf_rn(5.0f, xv, s);
          s = s + mine[p + 1];
          s = s + d0;
          s = s + d1;
          s = s + d2;
          spare[p] = blend(clip255(s * (1.0f / 13.0f)), xv, factor);
        }
        cluster.sync();  // no block reads plane c any more
        float* own = planes + c * plane;
        batched<4>(npix, [&](int p) { return spare[p]; },
                   [&](int p, float x) { own[p] = x; });
        __syncthreads();  // the spare is free for the next channel
      }
    } else if (op == kAutocontrast) {
      float* part = part_f + 8 * (nred & 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* pc = planes + c * plane;
        float mn = INFINITY, mx = -INFINITY;
#pragma unroll 4
        for (int p = tid; p < npix; p += kThreads) {
          mn = fminf(mn, pc[p]);
          mx = fmaxf(mx, pc[p]);
        }
        mn = block_reduce(mn, INFINITY, red_f, MinOp());
        mx = block_reduce(mx, -INFINITY, red_f, MaxOp());
        if (tid == 0) { part[c] = mn; part[3 + c] = mx; }
      }
      cluster.sync();
      float lo[3] = {INFINITY, INFINITY, INFINITY};
      float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
      for (int k = 0; k < C; ++k) {
        const float* pk = cluster.map_shared_rank(part, k);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lo[c] = fminf(lo[c], pk[c]);
          hi[c] = fmaxf(hi[c], pk[3 + c]);
        }
      }
      ++nred;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float scale = 255.0f / fmaxf(hi[c] - lo[c], 1e-6f);
        if (!(hi[c] > lo[c])) continue;
        const float l = lo[c];
        pointwise<4>(planes + c * plane, npix,
                     [&](float x) { return clip255((x - l) * scale); });
      }
    } else if (op == kBrightness) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        pointwise<4>(planes + c * plane, npix,
                     [&](float x) { return clip255(x * factor); });
    } else if (op == kColor || op == kContrast) {
      float* P0 = planes;
      float* P1 = planes + plane;
      float* P2 = planes + 2 * plane;
      float mean = 0.0f;
      if (op == kContrast) {
        double sum = 0.0;
#pragma unroll 4
        for (int p = tid; p < npix; p += kThreads) {
          sum += (double)luminance(P0[p], P1[p], P2[p]);
        }
        sum = block_reduce(sum, 0.0, red_d, SumOp());
        double* part = part_d + (nred & 1);
        if (tid == 0) *part = sum;
        cluster.sync();
        double total = 0.0;
        for (int k = 0; k < C; ++k) total += *cluster.map_shared_rank(part, k);
        ++nred;
        mean = floorf(__fmaf_rn((float)total, 1.0f / (float)(S * S), 0.5f));
      }
      constexpr int K = 4;
      for (int base = tid; base < npix; base += K * kThreads) {
        float r[K], g[K], bl[K];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int p = min(base + u * kThreads, npix - 1);
          r[u] = P0[p];
          g[u] = P1[p];
          bl[u] = P2[p];
        }
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int p = base + u * kThreads;
          if (p >= npix) break;
          const float deg = op == kColor ? luminance(r[u], g[u], bl[u]) : mean;
          P0[p] = blend(deg, r[u], factor);
          P1[p] = blend(deg, g[u], factor);
          P2[p] = blend(deg, bl[u], factor);
        }
      }
    } else if (op == kEqualize) {
      int* h = hist + 768 * (nred & 1);
      for (int i = tid; i < 768; i += kThreads) h[i] = 0;
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* pc = planes + c * plane;
        int* h_c = h + c * 256;
        batched<4>(npix, [&](int p) { return clip255(rintf(pc[p])); },
                   [&](int, float q) { atomicAdd(&h_c[(int)q], 1); });
      }
      cluster.sync();
      const int warp = tid >> 5, lane = tid & 31;
      if (warp < 3) {  // PIL's LUT, one warp per channel, integer math
        int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int k = 0; k < C; ++k) {
          const int* hk = cluster.map_shared_rank(h, k) + warp * 256 + lane * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) cnt[i] += hk[i];
        }
        int first = 256, last = -1, tot = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (cnt[i] > 0) { first = min(first, lane * 8 + i); last = lane * 8 + i; }
          tot += cnt[i];
        }
        int incl = tot;  // inclusive scan of the lanes' totals
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        for (int o = 16; o > 0; o >>= 1) {
          first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
          last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
        }
        int at_last = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) at_last += lane * 8 + i == last ? cnt[i] : 0;
        for (int o = 16; o > 0; o >>= 1) at_last += __shfl_xor_sync(0xffffffffu, at_last, o);
        const int step = (S * S - at_last) / 255;
        const bool identity = first == last || step == 0;
        int cdf = incl - tot;  // pixels in the bins below this lane's
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int bin = lane * 8 + i;
          lut[warp * 256 + bin] =
              (unsigned char)(identity ? bin : min(255, (step / 2 + cdf) / step));
          cdf += cnt[i];
        }
      }
      ++nred;
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char* lut_c = lut + c * 256;
        pointwise<4>(planes + c * plane, npix,
                     [&](float x) { return (float)lut_c[(int)clip255(rintf(x))]; });
      }
    } else if (op == kPosterize) {
      const int bits = (int)truncf(v * (4.0f / 10.0f)) + 4;
      const float keep = (float)(1 << (8 - bits));
      const float inv_keep = 1.0f / keep;  // a power of two: exact
#pragma unroll
      for (int c = 0; c < 3; ++c)
        pointwise<4>(planes + c * plane, npix,
                     [&](float x) { return floorf(x * inv_keep) * keep; });
    } else if (op == kSolarize) {
      const float threshold = 256.0f - truncf(v * (256.0f / 10.0f));
#pragma unroll
      for (int c = 0; c < 3; ++c)
        pointwise<4>(planes + c * plane, npix,
                     [&](float x) { return x >= threshold ? 255.0f - x : x; });
    }
    __syncthreads();
  }

  // ---- store with CutoutAbs(16), an inclusive box filled with 127: the
  // own rows are one contiguous NHWC run of the output
  {
    const int cx0 = max(0, p_i[0] - kCutout / 2), cy0 = max(0, p_i[1] - kCutout / 2);
    const int cx1 = min(S, cx0 + kCutout), cy1 = min(S, cy0 + kCutout);
    const float* P0 = planes;
    const float* P1 = planes + plane;
    const float* P2 = planes + 2 * plane;
    T* dst = out + ((size_t)b * S + r0) * S * 3;
    auto cut = [&](int p) {  // own pixel p lies in the cutout box
      const int lr = div_small(p, inv_w);
      const int y = r0 + lr, x = p - lr * S;
      return y >= cy0 && y <= cy1 && x >= cx0 && x <= cx1;
    };
    // as the load, mirrored: a warp interleaves a run of W = 32 G pixels
    // into NHWC in the spare plane, consecutive lanes on consecutive
    // pixels, then writes it out as 16-byte vectors
    constexpr int G = sizeof(T) == 2 ? 8 : 4;
    constexpr int W = 32 * G;
    constexpr int kStepElems = W * 3;
    const bool vec = plane % 4 == 0 && plane * 4 >= kWarps * kStepElems * (int)sizeof(T) &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                     (npix * 3 * (int)sizeof(T)) % 16 == 0;
    if (vec) {
      const int warp = tid >> 5, lane = tid & 31;
      T* stage = reinterpret_cast<T*>(planes + 3 * plane) + warp * kStepElems;
      for (int base = warp * W; base < npix; base += kWarps * W) {
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int q = lane + 32 * k, p = base + q;
          if (p >= npix) break;
          const bool m = cut(p);
          IO<T>::store(stage + 3 * q, m ? kCutoutFill : P0[p]);
          IO<T>::store(stage + 3 * q + 1, m ? kCutoutFill : P1[p]);
          IO<T>::store(stage + 3 * q + 2, m ? kCutoutFill : P2[p]);
        }
        __syncwarp();
        const int nvec = min(W, npix - base) * 3 * (int)sizeof(T) / 16;
        const uint4* from = reinterpret_cast<const uint4*>(stage);
        uint4* to = reinterpret_cast<uint4*>(dst + (size_t)base * 3);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int i = lane + 32 * k;
          if (i < nvec) to[i] = from[i];
        }
        __syncwarp();
      }
    } else {
      // consecutive threads on consecutive pixels, element by element
      constexpr int K = 4;
      for (int base = tid; base < npix; base += K * kThreads) {
        float v[K][3];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int p = min(base + u * kThreads, npix - 1);
          v[u][0] = P0[p];
          v[u][1] = P1[p];
          v[u][2] = P2[p];
        }
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int p = base + u * kThreads;
          if (p >= npix) break;
          const bool m = cut(p);
#pragma unroll
          for (int c = 0; c < 3; ++c) IO<T>::store(dst + 3 * p + c, m ? kCutoutFill : v[u][c]);
        }
      }
    }
  }
  // no block leaves while a peer may still read its planes or partials
  cluster.sync();
}

// The launch at `side`: one cluster of randaugment_cluster_size(side) blocks
// per image, each with its rows' dynamic shared memory.
template <typename T>
cudaLaunchConfig_t launch_config(int batch, int side, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  const int cluster = randaugment_cluster_size(side);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = randaugment_smem_bytes(side, cluster);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_side(int side) {
  if (side < 1 || side > kRandaugmentMaxSide) return false;
  const int c = randaugment_cluster_size(side);
  return c != 0 && (side + c - 1) / c * side <= kPerThread * kThreads;
}

template <typename T>
cudaError_t launch(const void* in, void* out, const int* pi, const float* pf,
                   int batch, int side, int hs, int ws, int pad, int n_slots,
                   int pi_cols, bool crop, int64_t sb, int64_t sy, int64_t sx,
                   int64_t sc, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T>(batch, side, stream, attr);
  const int cluster = (int)attr[0].val.clusterDim.x;
  cudaError_t rc = cudaFuncSetAttribute(
      randaugment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (rc != cudaSuccess) return rc;
  rc = cudaLaunchKernelEx(&cfg, randaugment_kernel<T>, (const T*)in, (T*)out, pi,
                          pf, side, (side + cluster - 1) / cluster, hs, ws, pad,
                          n_slots, pi_cols, (int)crop, (long long)sb,
                          (long long)sy, (long long)sx, (long long)sc);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int side, int* max_active_clusters, int* regs,
                      int* local_bytes) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T>(1, side, 0, attr);
  cudaError_t rc = cudaFuncSetAttribute(
      randaugment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes fa;
  rc = cudaFuncGetAttributes(&fa, randaugment_kernel<T>);
  if (rc != cudaSuccess) return rc;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveClusters(max_active_clusters,
                                        randaugment_kernel<T>, &cfg);
}

}  // namespace

cudaError_t randaugment_mc_launch(const void* in, void* out, const int* pi,
                                  const float* pf, bool is_bf16, int batch,
                                  int side, int hs, int ws, int pad,
                                  int n_slots, int pi_cols, bool crop,
                                  int64_t sb, int64_t sy, int64_t sx,
                                  int64_t sc, cudaStream_t stream) {
  if (!valid_side(side)) return cudaErrorInvalidValue;
  if (is_bf16) {
    return launch<__nv_bfloat16>(in, out, pi, pf, batch, side, hs, ws, pad,
                                 n_slots, pi_cols, crop, sb, sy, sx, sc,
                                 stream);
  }
  return launch<float>(in, out, pi, pf, batch, side, hs, ws, pad, n_slots,
                       pi_cols, crop, sb, sy, sx, sc, stream);
}

cudaError_t randaugment_mc_occupancy(bool is_bf16, int side,
                                     int* max_active_clusters, int* regs,
                                     int* local_bytes) {
  if (!valid_side(side)) return cudaErrorInvalidValue;
  return is_bf16 ? occupancy<__nv_bfloat16>(side, max_active_clusters, regs,
                                            local_bytes)
                 : occupancy<float>(side, max_active_clusters, regs,
                                    local_bytes);
}
