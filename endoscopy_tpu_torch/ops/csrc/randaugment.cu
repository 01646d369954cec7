// RandAugmentMC(n, 10) + CutoutAbs(16), one CUDA block per image, for Hopper.
//
// Replaces the Pallas TPU kernel endoscopy_tpu/ops/randaugment_kernel.py
// (_randaugment_mc_pallas -> _kernel, pallas_call at :373). It computes what
// _kernel computes, pixel for pixel:
//   - an optional crop-fused window: the input is the reflect-padded batch and
//     each image's h x w window at (top, left) is read by a plain offset load;
//   - n sampled op slots from the 14-op FixMatch pool; an image runs only its
//     own op (the op id is uniform in a block, so the branch never diverges);
//   - CutoutAbs(16) filled with 127, with inclusive bounds (17 px wide).
//
// Design. The image (3 x 224 x 224 float32 = 602 KB) does not fit in shared
// memory, so each block owns a float32 global scratch of two planar images
// (ping-pong). Reductions (min/max, the contrast sum in float64, the 256-bin
// equalize histograms) go through shared memory. The TPU's bit-decomposed
// rolls become one gather per pixel through the composed Paeth index
// x' = x + s3[y], y'' = y + s2[x'], x'' = x' + s1[y''], zero wherever a step
// leaves the image. Input and output stay in the caller's dtype (bf16 on the
// main path); all arithmetic is float32.
//
// Bound. The work is a few operations per pixel, so the card's memory rate
// bounds it: each input byte read once and each output byte written once.
// This first version also streams its scratch through L2/HBM; keeping the
// image on chip is the redesign ROADMAP.md lists.
//
// Exactness. The float32 arithmetic is the reference's as XLA evaluates it:
// constant quotients are folded (v * 0.9 / 10 is v * 0.09f; / 13 and / (h*w)
// are products with the float32 reciprocal) and a product that feeds a sum
// is one fused multiply-add. Those are written out with __fmaf_rn, and the
// file is built with -fmad=false so nvcc contracts nothing else. tan/sin of
// the float32 angle are taken in float64 and rounded to float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "randaugment.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSide = 1024;
constexpr int kCutout = 16;
constexpr float kCutoutFill = 127.0f;

enum Op {
  kAutocontrast = 0, kBrightness = 1, kColor = 2, kContrast = 3,
  kEqualize = 4, kIdentity = 5, kPosterize = 6, kRotate = 7,
  kSharpness = 8, kShearX = 9, kShearY = 10, kSolarize = 11,
  kTranslateX = 12, kTranslateY = 13,
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct SumOp { __device__ double operator()(double a, double b) const { return a + b; } };

// Reduce one value per thread over the block; every thread gets the result.
// `identity` pads the lanes of the last step that hold no warp's partial.
template <typename T, typename Op>
__device__ T block_reduce(T v, T identity, T* smem, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // smem may still be read from the previous reduction
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
randaugment_kernel(const T* __restrict__ in, T* __restrict__ out,
                   const int* __restrict__ pi, const float* __restrict__ pf,
                   float* __restrict__ scratch, int h, int w, int hp, int wp,
                   int n_slots, int pi_cols, int crop, long long sb,
                   long long sy, long long sx, long long sc) {
  __shared__ int shifts[3][kMaxSide];
  __shared__ int hist[3][256];
  __shared__ int lut[3][256];
  __shared__ float red_f[32];
  __shared__ double red_d[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = h * w;
  float* cur = scratch + (size_t)b * 6 * npix;
  float* nxt = cur + 3 * npix;
  const int* p_i = pi + (size_t)b * pi_cols;
  const float* p_f = pf + (size_t)b * 2 * n_slots;

  // crop-fused load; offsets are clamped so a bad one cannot read outside
  int top = 0, left = 0;
  if (crop) {
    top = min(max(p_i[2 + 2 * n_slots], 0), hp - h);
    left = min(max(p_i[3 + 2 * n_slots], 0), wp - w);
  }
  const T* src = in + (size_t)b * sb;
  for (int p = tid; p < npix; p += kThreads) {
    const int y = p / w, x = p - (p / w) * w;
    const T* s = src + (long long)(y + top) * sy + (long long)(x + left) * sx;
    cur[p] = load_f32(s);
    cur[npix + p] = load_f32(s + sc);
    cur[2 * npix + p] = load_f32(s + 2 * sc);
  }
  __syncthreads();

  for (int slot = 0; slot < n_slots; ++slot) {
    const int op = p_i[2 + 2 * slot];
    if (p_i[3 + 2 * slot] != 1) continue;  // uniform in the block
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
      const int trans_x = (int)truncf(sign * mag * (float)w);
      const int trans_y = (int)truncf(sign * mag * (float)h);
      const int sa1 = (int)floorf(shear * 65536.0f + 0.5f);
      const int sa2 = (int)floorf((0.5f + 0.5f * shear) * 65536.0f + 0.5f);
      const float cy = (float)h / 2.0f, cx = (float)w / 2.0f;
      for (int i = tid; i < h; i += kThreads) {
        const int rot = (int)floorf(__fmaf_rn(a, ((float)i + 0.5f) - cy, 0.5f));
        int s1 = 0;
        if (op == kRotate) s1 = rot;
        else if (op == kShearX) s1 = (sa1 * i + sa2) >> 16;
        else if (op == kTranslateX) s1 = trans_x;
        shifts[0][i] = s1;
        shifts[2][i] = op == kRotate ? rot : 0;
      }
      for (int i = tid; i < w; i += kThreads) {
        int s2 = 0;
        if (op == kRotate) s2 = (int)floorf(__fmaf_rn(sb_, ((float)i + 0.5f) - cx, 0.5f));
        else if (op == kShearY) s2 = (sa1 * i + sa2) >> 16;
        else if (op == kTranslateY) s2 = trans_y;
        shifts[1][i] = s2;
      }
      __syncthreads();
      for (int p = tid; p < npix; p += kThreads) {
        const int y = p / w, x = p - (p / w) * w;
        float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
        const int x1 = x + shifts[2][y];
        if (x1 >= 0 && x1 < w) {
          const int y2 = y + shifts[1][x1];
          if (y2 >= 0 && y2 < h) {
            const int x3 = x1 + shifts[0][y2];
            if (x3 >= 0 && x3 < w) {
              const int q = y2 * w + x3;
              o0 = cur[q];
              o1 = cur[npix + q];
              o2 = cur[2 * npix + q];
            }
          }
        }
        nxt[p] = o0;
        nxt[npix + p] = o1;
        nxt[2 * npix + p] = o2;
      }
      float* t = cur; cur = nxt; nxt = t;
    } else if (op == kAutocontrast) {
      float lo[3], hi[3];
      for (int c = 0; c < 3; ++c) {
        float mn = INFINITY, mx = -INFINITY;
        for (int p = tid; p < npix; p += kThreads) {
          const float x = cur[c * npix + p];
          mn = fminf(mn, x);
          mx = fmaxf(mx, x);
        }
        lo[c] = block_reduce(mn, INFINITY, red_f, MinOp());
        hi[c] = block_reduce(mx, -INFINITY, red_f, MaxOp());
      }
      for (int c = 0; c < 3; ++c) {
        const float scale = 255.0f / fmaxf(hi[c] - lo[c], 1e-6f);
        if (!(hi[c] > lo[c])) continue;
        for (int p = tid; p < npix; p += kThreads) {
          float* px = cur + c * npix + p;
          *px = clip255((*px - lo[c]) * scale);
        }
      }
    } else if (op == kBrightness) {
      for (int p = tid; p < 3 * npix; p += kThreads) cur[p] = clip255(cur[p] * factor);
    } else if (op == kColor || op == kContrast) {
      float mean = 0.0f;
      if (op == kContrast) {
        double sum = 0.0;
        for (int p = tid; p < npix; p += kThreads) {
          sum += (double)luminance(cur[p], cur[npix + p], cur[2 * npix + p]);
        }
        sum = block_reduce(sum, 0.0, red_d, SumOp());
        mean = floorf(__fmaf_rn((float)sum, 1.0f / (float)npix, 0.5f));
      }
      for (int p = tid; p < npix; p += kThreads) {
        const float r = cur[p], g = cur[npix + p], bl = cur[2 * npix + p];
        const float deg = op == kColor ? luminance(r, g, bl) : mean;
        cur[p] = blend(deg, r, factor);
        cur[npix + p] = blend(deg, g, factor);
        cur[2 * npix + p] = blend(deg, bl, factor);
      }
    } else if (op == kEqualize) {
      for (int i = tid; i < 3 * 256; i += kThreads) (&hist[0][0])[i] = 0;
      __syncthreads();
      for (int p = tid; p < 3 * npix; p += kThreads) {
        const int q = (int)clip255(rintf(cur[p]));
        atomicAdd(&hist[p / npix][q], 1);
      }
      __syncthreads();
      if (tid < 3) {  // PIL's LUT: one thread per channel, integer math
        const int* hc = hist[tid];
        int last = 255, first = 0;
        while (last > 0 && hc[last] == 0) --last;
        while (first < 255 && hc[first] == 0) ++first;
        const int step = (npix - hc[last]) / 255;
        const bool identity = first == last || step == 0;
        int cdf = 0;
        for (int i = 0; i < 256; ++i) {
          lut[tid][i] = identity ? i : min(255, (step / 2 + cdf) / step);
          cdf += hc[i];
        }
      }
      __syncthreads();
      for (int p = tid; p < 3 * npix; p += kThreads) {
        const int q = (int)clip255(rintf(cur[p]));
        cur[p] = (float)lut[p / npix][q];
      }
    } else if (op == kPosterize) {
      const int bits = (int)truncf(v * (4.0f / 10.0f)) + 4;
      const float keep = (float)(1 << (8 - bits));
      for (int p = tid; p < 3 * npix; p += kThreads) cur[p] = floorf(cur[p] / keep) * keep;
    } else if (op == kSharpness) {
      for (int p = tid; p < npix; p += kThreads) {
        const int y = p / w, x = p - (p / w) * w;
        const bool border = y == 0 || y == h - 1 || x == 0 || x == w - 1;
        for (int c = 0; c < 3; ++c) {
          const float* pl = cur + c * npix;
          const float xv = pl[p];
          float sm = xv;
          if (!border) {
            // the nine SMOOTH taps, summed in the reference's order
            float s = pl[p - w - 1] + pl[p - w];
            s = s + pl[p - w + 1];
            s = s + pl[p - 1];
            s = __fmaf_rn(5.0f, xv, s);
            s = s + pl[p + 1];
            s = s + pl[p + w - 1];
            s = s + pl[p + w];
            s = s + pl[p + w + 1];
            sm = clip255(s * (1.0f / 13.0f));
          }
          nxt[c * npix + p] = blend(sm, xv, factor);
        }
      }
      float* t = cur; cur = nxt; nxt = t;
    } else if (op == kSolarize) {
      const float threshold = 256.0f - truncf(v * (256.0f / 10.0f));
      for (int p = tid; p < 3 * npix; p += kThreads) {
        const float x = cur[p];
        cur[p] = x >= threshold ? 255.0f - x : x;
      }
    }
    __syncthreads();
  }

  // CutoutAbs(16): inclusive box, then the store in the output dtype (NHWC)
  const int x0 = max(0, p_i[0] - kCutout / 2), y0 = max(0, p_i[1] - kCutout / 2);
  const int x1 = min(w, x0 + kCutout), y1 = min(h, y0 + kCutout);
  T* dst = out + (size_t)b * npix * 3;
  for (int p = tid; p < npix; p += kThreads) {
    const int y = p / w, x = p - (p / w) * w;
    const bool m = y >= y0 && y <= y1 && x >= x0 && x <= x1;
    for (int c = 0; c < 3; ++c)
      store_f32(dst + (size_t)p * 3 + c, m ? kCutoutFill : cur[c * npix + p]);
  }
}

}  // namespace

cudaError_t randaugment_mc_launch(const void* in, void* out, const int* pi,
                                  const float* pf, float* scratch,
                                  bool is_bf16, int batch, int h, int w,
                                  int hp, int wp, int n_slots, int pi_cols,
                                  bool crop, int64_t sb, int64_t sy,
                                  int64_t sx, int64_t sc,
                                  cudaStream_t stream) {
  if (h > kMaxSide || w > kMaxSide) return cudaErrorInvalidValue;
  if (is_bf16) {
    randaugment_kernel<__nv_bfloat16><<<batch, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)in, (__nv_bfloat16*)out, pi, pf, scratch, h, w,
        hp, wp, n_slots, pi_cols, crop, sb, sy, sx, sc);
  } else {
    randaugment_kernel<float><<<batch, kThreads, 0, stream>>>(
        (const float*)in, (float*)out, pi, pf, scratch, h, w, hp, wp,
        n_slots, pi_cols, crop, sb, sy, sx, sc);
  }
  return cudaGetLastError();
}
