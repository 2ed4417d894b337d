// Device routines of unet_t4.cu, the only file that still includes this one:
// the mma.sync block GEMM, Dense with dhg's rounding, one attention head,
// LayerNorm + FiLM, and one EncoderLayer.attend on one batch row in one
// thread block, at the rounding points of dhg/kernels/fused_bottleneck.py's
// `_encoder_layer` (listed in encoder_layer.cu). This is the first port's
// design (fragments loaded from global memory, a per-row global workspace);
// enc3/enc5 left it for encoder_layer.cu's cluster kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define DHG_MAX_LAYERS 8
#define DHG_THREADS 512

// Per-layer operand order, as in dhg's _PER_LAYER list. Weights are torch
// Linear layout [out, in]; FiLM gamma/beta are [D] (the batch-1 broadcast).
enum {
  KH, VH, WQ, BQ, WO, BO, WQ2, BQ2, WK2, BK2, WV2, BV2, WO2, BO2,
  W1, B1, W2, B2, G1, BE1, G2, BE2, G3, BE3, PER_LAYER
};

struct LayerW {
  const bf16* p[PER_LAYER];
};

// Dimensions of one EncoderLayer call: x and the output are [T, D] with H
// heads; pe is [T, D]; the text K/V have L keys; scale = 1 / sqrt(D / H).
struct LayerCfg {
  const bf16* pe;
  int T, D, H, L;
  float scale;
};

// Point `nlayers` LayerW at consecutive groups of PER_LAYER operands.
static inline void fill_layers(LayerW* layers, const void* const* ops, int nlayers) {
  for (int i = 0; i < nlayers; ++i)
    for (int k = 0; k < PER_LAYER; ++k)
      layers[i].p[k] = static_cast<const bf16*>(ops[i * PER_LAYER + k]);
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Per-row scratch: X XPE Q ATT X2 K2 V2 ([T, D] each), H [T, 2D], S [T, lp].
__host__ __device__ inline long long ws_elems(int T, int D, int L) {
  const int lp = round16(T > L ? T : L);
  return (long long)T * D * 9 + (long long)T * lp;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rn(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// B element (k, n) and (k+1, n) packed for the mma "col" operand; entries
// with n >= N or k >= kvalid read as zero.
__device__ __forceinline__ uint32_t ld_b(const bf16* B, int sbn, int sbk, int N, int kvalid,
                                         int n, int k) {
  if (n >= N) return 0u;
  const bf16* p = B + (long long)n * sbn;
  if (sbk == 1 && k + 1 < kvalid) return ld32(p + k);
  const bf16 z = rn(0.f);
  const bf16 lo = k < kvalid ? p[(long long)k * sbk] : z;
  const bf16 hi = k + 1 < kvalid ? p[(long long)(k + 1) * sbk] : z;
  return pack2(lo, hi);
}

// acc(m, n) = sum_k A[m * lda + k] * B(k, n) for m < M, n < N, handed to
// epi(m, n, acc). B(k, n) sits at B[n * sbn + k * sbk]. K % 16 == 0 and A
// must hold K readable columns per row; B entries with k >= kvalid are zero.
// All warps of the block share the 16x32 output tiles.
template <class Epi>
static __device__ void block_gemm(const bf16* A, int lda, const bf16* B, int sbn, int sbk,
                                  int M, int N, int K, int kvalid, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mt = (M + 15) >> 4, nt = (N + 31) >> 5;
  for (int tile = warp; tile < mt * nt; tile += nwarps) {
    const int m0 = (tile / nt) << 4, n0 = (tile % nt) << 5;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const int r0 = m0 + g, r1 = r0 + 8;
    const bool v0 = r0 < M, v1 = r1 < M;
    const bf16* a_r0 = A + (long long)r0 * lda;
    const bf16* a_r1 = A + (long long)r1 * lda;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * tg;
      const uint32_t a0 = v0 ? ld32(a_r0 + ka) : 0u;
      const uint32_t a1 = v1 ? ld32(a_r1 + ka) : 0u;
      const uint32_t a2 = v0 ? ld32(a_r0 + ka + 8) : 0u;
      const uint32_t a3 = v1 ? ld32(a_r1 + ka + 8) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = n0 + 8 * j;  // warp-uniform
        if (nb < N) {
          const uint32_t b0 = ld_b(B, sbn, sbk, N, kvalid, nb + g, ka);
          const uint32_t b1 = ld_b(B, sbn, sbk, N, kvalid, nb + g, ka + 8);
          mma16816(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * j + 2 * tg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < N) {
          if (v0) epi(r0, c + e, acc[j][e]);
          if (v1) epi(r1, c + e, acc[j][2 + e]);
        }
      }
    }
  }
}

// Y[m, n] = bf16(bf16(X @ W^T)[m, n] + b[n]); W is [N, K] (torch Linear).
static __device__ void dense(const bf16* X, int ldx, const bf16* W, const bf16* b, bf16* Y,
                             int ldy, int M, int N, int K) {
  block_gemm(X, ldx, W, K, 1, M, N, K, K, [=](int m, int n, float acc) {
    Y[(long long)m * ldy + n] = rn(bf(rn(acc)) + bf(b[n]));
  });
}

// O[t, 0:hd] = softmax(bf16(Q K^T) * scale + neg) V for one head.
// Q [T, hd] at row stride ldq; K(l, d) at K[l * skl + d]; V(l, d) at
// V[l * svl + d]; S is [T, lds] scratch with lds >= round16(L).
static __device__ void attend_head(const bf16* Q, int ldq, const bf16* K, int skl,
                                   const bf16* V, int svl, const bf16* neg, bf16* S, int lds,
                                   bf16* O, int ldo, int T, int L, int hd, bf16 scale) {
  block_gemm(Q, ldq, K, skl, 1, T, L, hd, hd, [=](int m, int n, float acc) {
    float lg = bf(rn(bf(rn(acc)) * bf(scale)));
    if (neg) lg = bf(rn(lg + bf(neg[n])));
    S[(long long)m * lds + n] = rn(lg);
  });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lp = round16(L);
  for (int t = warp; t < T; t += nwarps) {
    bf16* row = S + (long long)t * lds;
    float mx = -INFINITY;
    for (int l = lane; l < L; l += 32) mx = fmaxf(mx, bf(row[l]));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) sum += expf(bf(row[l]) - mx);
    sum = warp_sum(sum);
    for (int l = lane; l < lp; l += 32)
      row[l] = l < L ? rn(expf(bf(row[l]) - mx) / sum) : rn(0.f);
  }
  __syncthreads();
  block_gemm(S, lds, V, 1, svl, T, hd, lp, L, [=](int m, int n, float acc) {
    O[(long long)m * ldo + n] = rn(acc);
  });
  __syncthreads();
}

// dst[t, :] = bf16(bf16(LN(a (+ b)) * g) + be) (+ res), one warp per row.
// The pre-add a + b rounds to bf16 first. dst may alias a or b.
static __device__ void ln_film(bf16* dst, const bf16* a, const bf16* b, const bf16* g,
                               const bf16* be, const bf16* res, int T, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    const long long o = (long long)t * D;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = b ? bf(rn(bf(a[o + c]) + bf(b[o + c]))) : bf(a[o + c]);
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / D;
    const float r = rsqrtf(fmaxf(0.f, s2 / D - mu * mu) + 1e-6f);
    for (int c = lane; c < D; c += 32) {
      const float v = b ? bf(rn(bf(a[o + c]) + bf(b[o + c]))) : bf(a[o + c]);
      float y = bf(rn((v - mu) * r));
      y = bf(rn(y * bf(g[c])));
      y = bf(rn(y + bf(be[c])));
      if (res) y = bf(rn(y + bf(res[o + c])));
      dst[o + c] = rn(y);
    }
  }
}

static __device__ void add_pe(bf16* dst, const bf16* x, const bf16* pe, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = rn(bf(x[i]) + bf(pe[i]));
}

static __device__ void silu(bf16* dst, const bf16* x, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = bf(x[i]);
    dst[i] = rn(v * (1.0f / (1.0f + expf(-v))));
  }
}

// One EncoderLayer.attend on one batch row: xin [T, D] -> xout [T, D]
// (xout may alias xin). ws is this row's scratch; kh/vh are [H, L, hd].
static __device__ void encoder_layer(const LayerCfg& a, const LayerW& w, const bf16* xin,
                                     bf16* xout, bf16* ws, const bf16* neg, int row) {
  const int T = a.T, D = a.D, H = a.H, L = a.L, hd = D / H, TD = T * D;
  const int lp = round16(T > L ? T : L);
  const bf16 scale = rn(a.scale);
  bf16* XPE = ws + 1LL * TD;
  bf16* Q = ws + 2LL * TD;
  bf16* ATT = ws + 3LL * TD;
  bf16* X2 = ws + 4LL * TD;
  bf16* K2 = ws + 5LL * TD;
  bf16* V2 = ws + 6LL * TD;
  bf16* Hb = ws + 7LL * TD;
  bf16* S = ws + 9LL * TD;
  const bf16* kh = w.p[KH] + (long long)row * H * L * hd;
  const bf16* vh = w.p[VH] + (long long)row * H * L * hd;

  // Cross-attention of x + PE against the precomputed text K/V.
  add_pe(XPE, xin, a.pe, TD);
  __syncthreads();
  dense(XPE, D, w.p[WQ], w.p[BQ], Q, D, T, D, D);
  __syncthreads();
  for (int h = 0; h < H; ++h)
    attend_head(Q + h * hd, D, kh + (long long)h * L * hd, hd, vh + (long long)h * L * hd, hd,
                neg, S, lp, ATT + h * hd, D, T, L, hd, scale);
  dense(ATT, D, w.p[WO], w.p[BO], X2, D, T, D, D);
  __syncthreads();
  ln_film(X2, X2, nullptr, w.p[G1], w.p[BE1], xin, T, D);
  __syncthreads();

  // Self-attention: Q = K = x2 + PE, V = x2.
  add_pe(XPE, X2, a.pe, TD);
  __syncthreads();
  dense(XPE, D, w.p[WQ2], w.p[BQ2], Q, D, T, D, D);
  dense(XPE, D, w.p[WK2], w.p[BK2], K2, D, T, D, D);
  dense(X2, D, w.p[WV2], w.p[BV2], V2, D, T, D, D);
  __syncthreads();
  for (int h = 0; h < H; ++h)
    attend_head(Q + h * hd, D, K2 + h * hd, D, V2 + h * hd, D, nullptr, S, lp, ATT + h * hd, D,
                T, T, hd, scale);
  dense(ATT, D, w.p[WO2], w.p[BO2], Q, D, T, D, D);
  __syncthreads();
  ln_film(Q, X2, Q, w.p[G2], w.p[BE2], nullptr, T, D);  // x3 = film(LN(x2 + .))
  __syncthreads();

  // FFN: SiLU -> fc1 -> SiLU -> fc2, residual, LN, FiLM.
  silu(XPE, Q, TD);
  __syncthreads();
  dense(XPE, D, w.p[W1], w.p[B1], Hb, 2 * D, T, 2 * D, D);
  __syncthreads();
  silu(Hb, Hb, 2 * TD);
  __syncthreads();
  dense(Hb, 2 * D, w.p[W2], w.p[B2], ATT, D, T, D, 2 * D);
  __syncthreads();
  ln_film(xout, ATT, Q, w.p[G3], w.p[BE3], nullptr, T, D);
  __syncthreads();
}
