// Swin's window attention, forward and backward, one block per head and
// group of windows, every window's logits kept on chip.
//
// It replaces no TPU kernel: the JAX package computes this attention in
// einsums (endoscopy_tpu/models/swin.py) and leaves it to XLA. The port's
// plain path (models/layers.py::attention) writes each window's float32
// logits to device memory several times over (the product, the scale, the
// bias, the mask, the softmax, the cast), and its backward as often again.
//
// What bounds it on the card: bytes. A window-head of Swin-T is n = 49
// tokens of head width 32, so its products are 49 x 49 x 32: a few hundred
// thousand operations against about 35 KB that must cross device memory
// (forward: q, k, v in, the output and two float32 statistics a row out;
// backward: q, k, v, the output's gradient and the statistics in, the
// gradients of q, k and v out). The work is under 0.5 ms of tensor-core
// time and about 2 ms of float32 FFMA a training step at 480 images,
// against about 4.6 ms of bytes at 3.35 TB/s.
//
// What the design does about it: each block loads one head's bias (and the
// mask of one window position) into shared memory once, then walks windows
// of that head and position across the batch. A window's q, k and v (and
// in the backward the output's gradient) go to shared memory by 16-byte
// cp.async copies, read through the caller's strides from the qkv
// projection's (B nW, n, 3, heads, hd) output, so no permute copy is made;
// the forward prefetches the next window while it computes one. Each of
// the four warps owns 16 query rows of the window, padded to 64 with zero
// rows and columns: its 16 x 64 strip of logits lives in registers, as the
// mma.sync accumulators, through the scale, bias, mask and softmax, and the
// probabilities go straight from those registers into the P V product. The
// output is written as (B nW, n, heads hd), ready for the projection. The
// backward recomputes the strip from q, k, the bias, the mask and each
// row's saved maximum and sum, forms dS in registers (accumulating the
// block's bias gradient there), then shares P and dS through shared memory
// for the products that sum over the queries (dV, dk); it writes d(qkv) in
// the input's layout and one float32 bias gradient a block.
//
// The arithmetic is the plain path's, in its order:
// - logit = (q k^T, bf16 products summed in float32 on the tensor cores)
//   * hd^-0.5, rounded, + bias, rounded, + mask, rounded (no contraction:
//   __fmul_rn / __fadd_rn);
// - softmax in float32: the row's maximum, expf(x - max), their sum, and
//   the quotient, correctly rounded as the division gives it (div_rn); P
//   rounded to bf16 for P V, summed in float32 and stored as bf16;
// - backward: dV = P_bf16^T dO and dP = dO V^T on the tensor cores in
//   float32 (dP is not rounded to bf16), dS = P dP - P sum_j P dP in
//   float32 (torch's softmax backward, its last product fused), the bias
//   gradient the sum of dS, and dq = (dS hd^-0.5) k and
//   dk = (dS hd^-0.5)^T q in float32 FFMA (not TF32, not a bf16 product),
//   then rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// kTile, the padded window (n <= kTile), and kHd, the head width the kernel
// takes, come from the build's flags (window_attention.py's TILE, HEAD_DIM)
#if !defined(kTile) || !defined(kHd)
#error "build with -DkTile=<tile> -DkHd=<head width>"
#endif
constexpr int kThreads = 128; // four warps, 16 query rows each
constexpr int kLdH = kHd + 8;       // bf16 row pitch of q, k, v, dO
constexpr int kLdS = kTile + 4;     // float row pitch of dS
constexpr int kLdP = kTile + 8;     // bf16 row pitch of P
constexpr int kTileElems = kTile * kLdH;
constexpr int kTileBytesH = kTileElems * 2;
constexpr int kTileBytesS = kTile * kLdS * 4;
constexpr int kTileBytesP = kTile * kLdP * 2;
// the forward's two buffers of q, k, v (the next window's copies land in
// one while the other is computed); the backward's one of q, k, v, dO
constexpr int kFwdTilesBytes = 2 * 3 * kTileBytesH;
constexpr int kBwdTilesBytes = 4 * kTileBytesH;

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* qkv;
  long long sw, sn, st, sh;  // element strides of qkv's first four axes
  const bf16* dout;          // backward: (B nW, n, heads hd), contiguous
  const float* bias;         // (heads, n, n)
  const float* mask;         // (period, n, n) or null
  bf16* out;                 // forward: (B nW, n, heads hd); backward: d(qkv)
  float* stats;              // (B nW, heads, n, 2): each row's max and sum
  float* dbias;              // backward: (heads, gridDim.x, n, n)
  int n, heads, period, groups, per_block;
  float scale;
};

__device__ __forceinline__ float logit(float s, float scale, float b,
                                       const float* mask, int at) {
  float x = __fadd_rn(__fmul_rn(s, scale), b);
  return mask ? __fadd_rn(x, mask[at]) : x;
}

// x / y, correctly rounded, from ry = RN(1/y): q = RN(x ry) is within an ulp
// of x / y, r = x - q y is exact, and RN(q + r ry) is RN(x / y) (Markstein's
// theorem), three operations in place of a full-range division for each of
// a row's quotients by its one sum. Off the theorem's range, where the
// quotient is subnormal (a masked probability under 1.2e-38), it may differ
// from the division in its last place, 1.4e-45.
__device__ __forceinline__ float div_rn(float x, float y, float ry) {
  const float q = __fmul_rn(x, ry);
  return __fmaf_rn(__fmaf_rn(-q, y, x), ry, q);
}

// the window index of the block's i-th window, or -1 past its last
__device__ __forceinline__ int window_of(const Args& a, int i) {
  int g = (blockIdx.x / a.period) * a.per_block + i;
  return i < a.per_block && g < a.groups
             ? g * a.period + (int)(blockIdx.x % a.period) : -1;
}

__device__ __forceinline__ void zero(void* p, int bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    q[i] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows 0..n-1 of a (n, kHd) bf16 tile into shared memory at pitch kLdH by
// 16-byte cp.async copies (the caller checked the alignment)
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int n) {
  for (int i = threadIdx.x; i < n * (kHd / 8); i += kThreads) {
    int r = i / (kHd / 8), c = (i % (kHd / 8)) * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                 "r"(smem_addr(dst + r * kLdH + c)),
                 "l"(src + r * row_stride + c));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// -- mma.sync m16n8k16 (bf16 in, float32 sums) and its fragments -----------
// lane = 4 g + t. A (16 x 16): a0 = A[g][2t..], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8): b0 = B[2t..][g],
// b1 = B[2t+8..][g]; C (16 x 8): c0, c1 = C[g][2t..], c2, c3 = C[g+8][2t..]

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A from the row-major M: the 16 x 16 block at rows r0, columns c0
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* m, int ld,
                                       int r0, int c0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm(a, m + (r0 + rr + 8 * (mi & 1)) * ld + c0 + 8 * (mi >> 1));
}

// A = M^T: A[i][k] = M[k0 + k][m0 + i]
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* m,
                                         int ld, int k0, int m0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm_t(a, m + (k0 + rr + 8 * (mi >> 1)) * ld + m0 + 8 * (mi & 1));
}

// B[k][j] = M[n0 + j][k0 + k] for two n-tiles: b[0..1] columns n0..n0+7,
// b[2..3] columns n0+8..n0+15
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* m,
                                          int ld, int n0, int k0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm(b, m + (n0 + rr + 8 * (mi >> 1)) * ld + k0 + 8 * (mi & 1));
}

// B[k][j] = M[k0 + k][n0 + j] for two n-tiles, as frag_b_nk
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* m,
                                          int ld, int k0, int n0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  ldsm_t(b, m + (k0 + rr + 8 * (mi & 1)) * ld + n0 + 8 * (mi >> 1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s = A B^T for the warp's 16 rows r0 of A and all kTile rows of B, both
// (kTile, kHd) at pitch kLdH: s[nt] is columns 8 nt..8 nt+7
__device__ __forceinline__ void strip_abt(float (&s)[kTile / 8][4],
                                          const bf16* a_s, const bf16* b_s,
                                          int r0, int lane) {
  uint32_t fa[kHd / 16][4];
  #pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    frag_a(fa[kk], a_s, kLdH, r0, 16 * kk, lane);
  #pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
  #pragma unroll
  for (int np = 0; np < kTile / 16; ++np)
    #pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      uint32_t b[4];
      frag_b_nk(b, b_s, kLdH, 16 * np, 16 * kk, lane);
      mma(s[2 * np], fa[kk], b[0], b[1]);
      mma(s[2 * np + 1], fa[kk], b[2], b[3]);
    }
}

// the element e of n-tile nt of a warp's strip at rows r0: row, column
__device__ __forceinline__ int strip_row(int r0, int lane, int e) {
  return r0 + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int strip_col(int nt, int lane, int e) {
  return 8 * nt + 2 * (lane & 3) + (e & 1);
}

// s[nt][e] = the logit of each element, -inf outside the n x n window
__device__ __forceinline__ void logits(float (&s)[kTile / 8][4], const Args& a,
                                       const float* bias_s,
                                       const float* mask_s, int r0, int lane) {
  #pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = strip_row(r0, lane, e), j = strip_col(nt, lane, e);
      s[nt][e] = r < a.n && j < a.n
                     ? logit(s[nt][e], a.scale, bias_s[r * a.n + j], mask_s,
                             r * a.n + j)
                     : -CUDART_INF_F;
    }
}

// window w's q, k, v (and with kTiles 4 its dO) into consecutive tiles
template <int kTiles>
__device__ __forceinline__ void load_window(const Args& a, bf16* dst, int w) {
  const bf16* base = a.qkv + w * a.sw + blockIdx.y * a.sh;
  #pragma unroll
  for (int x = 0; x < 3; ++x)
    load_rows(dst + x * kTileElems, base + x * a.st, a.sn, a.n);
  if (kTiles == 4)
    load_rows(dst + 3 * kTileElems,
              a.dout + ((long long)w * a.n * a.heads + blockIdx.y) * kHd,
              a.heads * kHd, a.n);
}

__global__ void __launch_bounds__(kThreads)
window_attention_fwd(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + kFwdTilesBytes);
  const int n = a.n, nn = n * n, h = blockIdx.y;
  float* mask_s = a.mask ? bias_s + nn : nullptr;
  const int lane = threadIdx.x % 32, r0 = 16 * (threadIdx.x / 32);
  const int g = lane >> 2, t = lane & 3;

  zero(smem, kFwdTilesBytes);
  for (int i = threadIdx.x; i < nn; i += kThreads) {
    bias_s[i] = a.bias[(long long)h * nn + i];
    if (mask_s) mask_s[i] = a.mask[(long long)(blockIdx.x % a.period) * nn + i];
  }
  __syncthreads();  // the zeros before the copies land

  int w = window_of(a, 0);
  if (w >= 0) load_window<3>(a, tiles, w);
  commit();
  for (int it = 0; w >= 0; ++it) {
    const int next = window_of(a, it + 1);
    if (next >= 0)
      load_window<3>(a, tiles + ((it + 1) & 1) * 3 * kTileElems, next);
    commit();
    wait_copies<1>();
    __syncthreads();
    const bf16* q_s = tiles + (it & 1) * 3 * kTileElems;
    const bf16* k_s = q_s + kTileElems;
    const bf16* v_s = k_s + kTileElems;

    if (r0 < n) {
      float s[kTile / 8][4];
      strip_abt(s, q_s, k_s, r0, lane);  // S = Q K^T
      logits(s, a, bias_s, mask_s, r0, lane);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.0f, 0.0f};
      #pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      #pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = strip_row(r0, lane, e), j = strip_col(nt, lane, e);
          s[nt][e] = r < n && j < n ? expf(s[nt][e] - mx[e >> 1]) : 0.0f;
          sum[e >> 1] += s[nt][e];
        }
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
      const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
      #pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = sum[e >> 1] > 0.0f
                         ? div_rn(s[nt][e], sum[e >> 1], rs[e >> 1]) : 0.0f;
      if (t == 0)
        #pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int r = r0 + g + 8 * y;
          float2* st = reinterpret_cast<float2*>(a.stats);
          if (r < n)
            st[((long long)w * a.heads + h) * n + r] = make_float2(mx[y], sum[y]);
        }

      // O = P V: P's bf16 A fragments straight from the strip's registers
      float o[kHd / 8][4];
      #pragma unroll
      for (int nt = 0; nt < kHd / 8; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
      #pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                                pack(s[2 * kk][2], s[2 * kk][3]),
                                pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        #pragma unroll
        for (int dp = 0; dp < kHd / 16; ++dp) {
          uint32_t b[4];
          frag_b_kn(b, v_s, kLdH, 16 * kk, 16 * dp, lane);
          mma(o[2 * dp], pa, b[0], b[1]);
          mma(o[2 * dp + 1], pa, b[2], b[3]);
        }
      }
      const long long orow = (long long)a.heads * kHd;  // the output's pitch
      bf16* dst = a.out + w * n * orow + h * kHd + 2 * t;
      #pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int r = r0 + g + 8 * y;
        if (r >= n) continue;
        #pragma unroll
        for (int nt = 0; nt < kHd / 8; ++nt)
          *reinterpret_cast<uint32_t*>(dst + r * orow + 8 * nt) =
              pack(o[nt][2 * y], o[nt][2 * y + 1]);
      }
    }
    __syncthreads();  // this buffer is free for the prefetch after next
    w = next;
  }
}

// rows r = rg + 16 y (y < 4) and columns c0..c0+7 of dS' M (kT false: dq,
// M = k) or dS'^T M (kT true: dk, M = q), summed over the n rows of M in
// float32 FFMA in their order, rounded to bf16 and stored at
// dst + r * row_stride for r < n
template <bool kT>
__device__ __forceinline__ void ffma_rows(bf16* dst, long long row_stride,
                                          const float* ds_s, const bf16* m_s,
                                          int rg, int c0, int n) {
  float acc[4][8];
  #pragma unroll
  for (int y = 0; y < 4; ++y)
    #pragma unroll
    for (int x = 0; x < 8; ++x) acc[y][x] = 0.0f;
  // the fourth row slot, where the warp has a row under n in it
  const bool four = 48 + (rg & ~7) < n;
  for (int j = 0; j < n; ++j) {
    const uint4 raw = *reinterpret_cast<const uint4*>(m_s + j * kLdH + c0);
    const bf16* mv = reinterpret_cast<const bf16*>(&raw);
    float m[8];
    #pragma unroll
    for (int x = 0; x < 8; ++x) m[x] = __bfloat162float(mv[x]);
    #pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (y == 3 && !four) break;
      const int r = rg + 16 * y;
      const float s = kT ? ds_s[j * kLdS + r] : ds_s[r * kLdS + j];
      #pragma unroll
      for (int x = 0; x < 8; ++x) acc[y][x] = fmaf(s, m[x], acc[y][x]);
    }
  }
  #pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int r = rg + 16 * y;
    if (r >= n) continue;
    uint4 v;
    v.x = pack(acc[y][0], acc[y][1]);
    v.y = pack(acc[y][2], acc[y][3]);
    v.z = pack(acc[y][4], acc[y][5]);
    v.w = pack(acc[y][6], acc[y][7]);
    *reinterpret_cast<uint4*>(dst + r * row_stride) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
window_attention_bwd(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  float* ds_s = reinterpret_cast<float*>(smem + kBwdTilesBytes);
  bf16* p_s = reinterpret_cast<bf16*>(smem + kBwdTilesBytes + kTileBytesS);
  float* bias_s = reinterpret_cast<float*>(smem + kBwdTilesBytes + kTileBytesS +
                                           kTileBytesP);
  const int n = a.n, nn = n * n, h = blockIdx.y;
  float* mask_s = a.mask ? bias_s + nn : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = 16 * warp;
  const int g = lane >> 2, t = lane & 3;
  const long long drow = (long long)3 * a.heads * kHd;  // d(qkv)'s row pitch

  zero(smem, kBwdTilesBytes + kTileBytesS + kTileBytesP);
  for (int i = threadIdx.x; i < nn; i += kThreads) {
    bias_s[i] = a.bias[(long long)h * nn + i];
    if (mask_s) mask_s[i] = a.mask[(long long)(blockIdx.x % a.period) * nn + i];
  }
  float dbias[kTile / 8][4];  // the block's sum of dS, at the strip's places
  #pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) dbias[nt][e] = 0.0f;
  __syncthreads();

  int w = window_of(a, 0);
  for (int it = 0; w >= 0; ++it) {
    const int next = window_of(a, it + 1);
    load_window<4>(a, tiles, w);
    commit();
    wait_copies<0>();
    __syncthreads();
    const bf16* q_s = tiles;
    const bf16* k_s = q_s + kTileElems;
    const bf16* v_s = k_s + kTileElems;
    const bf16* do_s = v_s + kTileElems;

    if (r0 < n) {  // the warp's query rows: P, dP and dS in registers
      float s[kTile / 8][4], dp[kTile / 8][4];
      strip_abt(s, q_s, k_s, r0, lane);    // S = Q K^T
      strip_abt(dp, do_s, v_s, r0, lane);  // dP = dO V^T
      logits(s, a, bias_s, mask_s, r0, lane);
      float2 st[2];  // each row's max and sum, and the sum's reciprocal
      float rs[2];
      #pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int r = r0 + g + 8 * y;
        st[y] = r < n ? reinterpret_cast<const float2*>(a.stats)
                            [((long long)w * a.heads + h) * n + r]
                      : make_float2(0.0f, 1.0f);
        rs[y] = __frcp_rn(st[y].y);
      }
      float dot[2] = {0.0f, 0.0f};
      #pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = strip_row(r0, lane, e), j = strip_col(nt, lane, e);
          const float2 sy = st[e >> 1];
          s[nt][e] = r < n && j < n
                         ? div_rn(expf(s[nt][e] - sy.x), sy.y, rs[e >> 1])
                         : 0.0f;
          dot[e >> 1] += s[nt][e] * dp[nt][e];
        }
      dot[0] = quad_sum(dot[0]);
      dot[1] = quad_sum(dot[1]);
      #pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
        #pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int r = r0 + g + 8 * y, j = 8 * nt + 2 * t;
          float ds[2];
          #pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * y + x;
            ds[x] = fmaf(-s[nt][e], dot[y], s[nt][e] * dp[nt][e]);
            dbias[nt][e] += ds[x];
          }
          *reinterpret_cast<float2*>(ds_s + r * kLdS + j) =
              make_float2(__fmul_rn(ds[0], a.scale), __fmul_rn(ds[1], a.scale));
          *reinterpret_cast<uint32_t*>(p_s + r * kLdP + j) =
              pack(s[nt][2 * y], s[nt][2 * y + 1]);
        }
    }
    __syncthreads();

    if (r0 < n) {  // dV = P^T dO for the warp's 16 keys
      float o[kHd / 8][4];
      #pragma unroll
      for (int nt = 0; nt < kHd / 8; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
      #pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t pa[4];
        frag_a_t(pa, p_s, kLdP, 16 * kk, r0, lane);
        #pragma unroll
        for (int dp = 0; dp < kHd / 16; ++dp) {
          uint32_t b[4];
          frag_b_kn(b, do_s, kLdH, 16 * kk, 16 * dp, lane);
          mma(o[2 * dp], pa, b[0], b[1]);
          mma(o[2 * dp + 1], pa, b[2], b[3]);
        }
      }
      bf16* dst = a.out + (long long)w * n * drow + 2 * a.heads * kHd +
                  h * kHd + 2 * t;
      #pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int r = r0 + g + 8 * y;
        if (r >= n) continue;
        #pragma unroll
        for (int nt = 0; nt < kHd / 8; ++nt)
          *reinterpret_cast<uint32_t*>(dst + r * drow + 8 * nt) =
              pack(o[nt][2 * y], o[nt][2 * y + 1]);
      }
    }
    // dq (warps 0-1) and dk (warps 2-3) in float32 FFMA, dS' = dS hd^-0.5
    {
      const int tl = threadIdx.x % 64, rg = tl / 4, c0 = (tl % 4) * 8;
      bf16* dst = a.out + (long long)w * n * drow + h * kHd + c0;
      if (warp < 2)
        ffma_rows<false>(dst, drow, ds_s, k_s, rg, c0, n);
      else
        ffma_rows<true>(dst + a.heads * kHd, drow, ds_s, q_s, rg, c0, n);
    }
    __syncthreads();  // the tiles, dS and P are free for the next window
    w = next;
  }

  float* part = a.dbias + ((long long)h * gridDim.x + blockIdx.x) * nn;
  #pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = strip_row(r0, lane, e), j = strip_col(nt, lane, e);
      if (r < n && j < n) part[r * n + j] = dbias[nt][e];
    }
}

int smem_fwd(int n, bool mask) {
  return kFwdTilesBytes + (1 + mask) * n * n * 4;
}

int smem_bwd(int n, bool mask) {
  return kBwdTilesBytes + kTileBytesS + kTileBytesP +
         (1 + mask) * n * n * 4;
}

int launch(bool backward, Args a, int grid_x, cudaStream_t stream) {
  const int bytes = backward ? smem_bwd(a.n, a.mask != nullptr)
                             : smem_fwd(a.n, a.mask != nullptr);
  void (*kernel)(Args) = backward ? window_attention_bwd : window_attention_fwd;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_x, a.heads), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int window_attention_smem(int backward, int n, int mask) {
  return backward ? smem_bwd(n, mask) : smem_fwd(n, mask);
}

// registers a thread of each kernel uses (cudaFuncGetAttributes)
int window_attention_regs(int backward) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, backward ? (const void*)window_attention_bwd
                                            : (const void*)window_attention_fwd)
      != cudaSuccess)
    return -1;
  return attr.numRegs;
}

// out (B nW, n, heads hd) bf16; stats (B nW, heads, n, 2) float32. Returns
// a cudaError_t.
int window_attention_forward(const void* qkv, long long sw, long long sn,
                             long long st, long long sh, const void* bias,
                             const void* mask, void* out, void* stats, int bw,
                             int n, int heads, int period, int per_block,
                             float scale, void* stream) {
  Args a = {};
  a.qkv = static_cast<const bf16*>(qkv);
  a.sw = sw; a.sn = sn; a.st = st; a.sh = sh;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.stats = static_cast<float*>(stats);
  a.n = n; a.heads = heads; a.period = period;
  a.groups = bw / period; a.per_block = per_block; a.scale = scale;
  const int grid_x = period * ((a.groups + per_block - 1) / per_block);
  return launch(false, a, grid_x, static_cast<cudaStream_t>(stream));
}

// dout (B nW, n, heads hd) and dqkv (B nW, n, 3, heads, hd) bf16,
// contiguous; dbias_part (heads, grid_x, n, n) float32 with grid_x =
// period * ceil(bw / period / per_block). Returns a cudaError_t.
int window_attention_backward(const void* qkv, long long sw, long long sn,
                              long long st, long long sh, const void* dout,
                              const void* bias,
                              const void* mask, const void* stats, void* dqkv,
                              void* dbias_part, int bw, int n, int heads,
                              int period, int per_block, float scale,
                              void* stream) {
  Args a = {};
  a.qkv = static_cast<const bf16*>(qkv);
  a.sw = sw; a.sn = sn; a.st = st; a.sh = sh;
  a.dout = static_cast<const bf16*>(dout);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(dqkv);
  a.stats = const_cast<float*>(static_cast<const float*>(stats));
  a.dbias = static_cast<float*>(dbias_part);
  a.n = n; a.heads = heads; a.period = period;
  a.groups = bw / period; a.per_block = per_block; a.scale = scale;
  const int grid_x = period * ((a.groups + per_block - 1) / per_block);
  return launch(true, a, grid_x, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
