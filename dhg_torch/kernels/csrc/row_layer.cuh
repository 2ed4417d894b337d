// The EncoderLayer of one batch row split by sequence rows over a cluster of
// CTAs, shared by encoder_layer.cu (enc3 and enc5) and unet_t4.cu (enc5 and
// the bottleneck's layers inside the T/4..T/8 region). encoder_layer.cu's
// note gives the design and dhg's rounding points. Here: the layer body
// (`layer_rows`), its product (`gemm16`, which also runs a k3 conv over rows
// with one halo row on each side), one attention head with its key staging,
// the LayerNorms with their FiLM steps, and the constants they share: 16
// warps a CTA, at most 64 rows a CTA, a 2-slot ring of [64, 128] weight
// tiles.

#pragma once

#include <cooperative_groups.h>

#include "tile_ring.cuh"

namespace row_layer {

namespace cg = cooperative_groups;
using namespace wmma16;
using namespace tile_ring;

constexpr int kMaxTc = 64;       // sequence rows a CTA holds
constexpr int kMaxHd = 64;
constexpr int kKC = 64;          // keys a staged chunk of a longer key set
constexpr int kHeldKeys = 256;   // keys staged at once (one softmax pass)
constexpr int kMaxSmem = 232448;
constexpr int kT = 512;          // threads a CTA: 16 warps
constexpr int kW = kT / 32;
constexpr int kRowT = kT / 64;   // threads a row in LayerNorm and softmax (64 rows)
constexpr int kEK = 128;         // depth of a weight tile: [64 outputs, 128 k], 16 KB
constexpr int kETile = kNT * kEK;
constexpr int kEStages = 2;      // slots of the weight ring
using ERing = RingT<kETile, kEStages>;

// Per-layer operand order, as in dhg's _PER_LAYER list.
enum { KH, VH, WQ, BQ, WO, BO, WQ2, BQ2, WK2, BK2, WV2, BV2, WO2, BO2,
       W1, B1, W2, B2, G1, BE1, G2, BE2, G3, BE3, PER_LAYER };

// Bias and FiLM vectors staged in shared memory (D each; fc1's bias 2D).
enum { V_BQ, V_BO, V_BQ2, V_BK2, V_BV2, V_BO2, V_B2, V_G1, V_BE1, V_G2, V_BE2, V_G3, V_BE3,
       V_B1, V_SLOTS = V_B1 + 2 };

__host__ __device__ inline long long up128(long long v) { return (v + 127) & ~127LL; }

// Keys staged at once for a self-attention over T rows: every key up to 256
// (rounded to 16, at least 64), else chunks of 64.
__host__ __device__ inline int staged_keys(int T) {
  const int kr = T <= kHeldKeys ? (T + 15) & ~15 : kKC;
  return kr < kKC ? kKC : kr;
}

// Weight tiles of one layer: wq, wo, wv2, wq2, wk2, wo2 ([D, D]), fc1
// ([2D, D]) and fc2 ([D, 2D]), each as [64 output rows, 128 k] tiles.
__host__ __device__ inline int tiles_of(int rows, int k) {
  return ((rows + kNT - 1) / kNT) * ((k + kEK - 1) / kEK);
}

__host__ __device__ inline int layer_tiles(int D) {
  return 6 * tiles_of(D, D) + tiles_of(2 * D, D) + tiles_of(D, 2 * D);
}

// The operand behind a vector slot below V_B1.
__device__ __forceinline__ int slot_operand(int s) {
  switch (s) {
    case V_BQ: return BQ;
    case V_BO: return BO;
    case V_BQ2: return BQ2;
    case V_BK2: return BK2;
    case V_BV2: return BV2;
    case V_BO2: return BO2;
    case V_B2: return B2;
    case V_G1: return G1;
    case V_BE1: return BE1;
    case V_G2: return G2;
    case V_BE2: return BE2;
    case V_G3: return G3;
    default: return BE3;
  }
}

// A layer's bias and FiLM vectors into vec (V_SLOTS x D), 16 bytes a copy.
// The caller syncs the block before they are read.
__device__ __forceinline__ void stage_layer_vec(bf16* vec, const bf16* const* p, int D) {
  const int cpr = D >> 3;
  for (int i = threadIdx.x; i < V_SLOTS * cpr; i += kT) {
    const int s = i / cpr, col = (i - s * cpr) << 3;
    const bf16* src = s < V_B1 ? p[slot_operand(s)] + col : p[B1] + (s - V_B1) * D + col;
    *reinterpret_cast<uint4*>(vec + s * D + col) = *reinterpret_cast<const uint4*>(src);
  }
}

// SiLU in f32, v / (1 + exp(-v)) with the hardware's exp2 and reciprocal:
// within a few ulp of the f32 value, at the same bf16 rounding point.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// FiLM of a normalised value with gamma and beta given as f32 (bf16 values).
__device__ __forceinline__ float film(bf16 y, float g, float be) {
  return bf(rn(bf(rn(bf(y) * g)) + be));
}

// Sum and max over the 8 adjacent lanes that share a row.
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 1; o < kRowT; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
  for (int o = 1; o < kRowT; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 at p (16 bytes) as f32, and 8 bf16 to p.
__device__ __forceinline__ void ld8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = bf(h[e]);
}

__device__ __forceinline__ void st8(bf16* p, const bf16 (&y)[8]) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(y);
}

// The layer's three LayerNorms (each followed by its FiLM step):
//   NORM_X2:  x2 = film1(LN(A)) + X -> X, and A = x2 + PE;
//   NORM_X3:  x3 = film2(LN(X + A)) -> X, and A = SiLU(x3);
//   NORM_OUT: film3(LN(X + Q)) -> out (row stride ldo; may be X itself).
enum { NORM_X2, NORM_X3, NORM_OUT };

// LayerNorm over D (<= MAXD) of the CTA's n rows (n <= 64), 8 threads a
// row, thread q on the 8-column groups q, q + 8, ... (16-byte accesses); g
// and be are the FiLM gamma and beta. Every thread loads its whole row share
// before it writes, so out may alias X.
template <int MAXD>
__device__ __forceinline__ void norm_rows(int mode, int n, int D, int ld, bf16* X, bf16* A,
                                          const bf16* Qb, const bf16* pe, const bf16* g,
                                          const bf16* be, bf16* out, int ldo) {
  constexpr int kG = MAXD / 8 / kRowT;  // groups a thread
  const int q = threadIdx.x % kRowT, t = threadIdx.x / kRowT, ng = D >> 3;
  float v[kG][8];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    if (t < n && q + kRowT * k < ng) {
      const int c = (q + kRowT * k) * 8;
      ld8((mode == NORM_X2 ? A : X) + t * ld + c, v[k]);
      if (mode != NORM_X2) {
        float o[8];
        ld8((mode == NORM_X3 ? A : Qb) + t * ld + c, o);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = bf(rn(v[k][e] + o[e]));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[k][e];
        s2 += v[k][e] * v[k][e];
      }
    }
  }
  s = row_sum(s);
  s2 = row_sum(s2);
  if (t >= n) return;
  const float mu = s / D;
  const float r = rsqrtf(fmaxf(0.f, s2 / D - mu * mu) + 1e-6f);
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    if (q + kRowT * k >= ng) continue;
    const int c = (q + kRowT * k) * 8;
    float gv[8], bv[8];
    ld8(g + c, gv);
    ld8(be + c, bv);
    bf16 y[8], z[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = rn(film(rn((v[k][e] - mu) * r), gv[e], bv[e]));
    if (mode == NORM_OUT) {
      st8(out + (long long)t * ldo + c, y);
      continue;
    }
    if (mode == NORM_X2) {
      float xv[8], pv[8];
      ld8(X + t * ld + c, xv);
      ld8(pe + (long long)t * D + c, pv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        y[e] = rn(bf(y[e]) + xv[e]);
        z[e] = rn(bf(y[e]) + pv[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = rn(silu_fast(bf(y[e])));
    }
    st8(X + t * ld + c, y);
    st8(A + t * ld + c, z);
  }
}

// Logits of one warp's 16 query rows against 16 staged keys (K rows [0, 16)
// at row stride ldh), keys key0 .. key0 + 15 of nk (those past nk read as
// -inf): bf16(Q K^T) * scale (+ neg[key]).
__device__ __forceinline__ void block_logits(float (&s)[2][4], const uint32_t (&qf)[4][4],
                                             const bf16* K, int ldh, int dk, int key0, int nk,
                                             const bf16* negs, float sc) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxHd / 16; ++kk) {
    if (kk < dk) {
      uint32_t b[4];
      load_b_nk(b, K, ldh, 0, kk * 16);
      mma(s[0], qf[kk], b[0], b[1]);
      mma(s[1], qf[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * tg + (e & 1);
      float lg = -INFINITY;
      if (key < nk) {
        lg = bf(rn(bf(rn(s[j][e])) * sc));
        if (negs) lg = bf(rn(lg + bf(negs[key])));
      }
      s[j][e] = lg;
    }
}

// Where the staged keys, values and logits of one head live.
struct AttnBuf {
  bf16* K;       // [kr, ldh] staged keys
  bf16* V;       // [kr, ldh] staged values
  bf16* S;       // [Tc, lds] logits, then the weights in place
  float2* ml;    // [64] running (max, sum) of a row, two-pass only
  bf16* negs;    // [kr] mask bias of the staged keys
  int kr, ldh, lds;
};

// Where one head's keys and values come from: the text's [L, hd] rows in
// global memory with the row's mask bias (cross-attention), or every CTA's
// K2/V2 rows in distributed shared memory, key j at row j % tc of CTA j / tc
// (self-attention; k and v point at this head's columns in this CTA).
struct KeySrc {
  const bf16* k;
  const bf16* v;
  const bf16* neg;
  int tc, ld;  // self-attention: rows a CTA, row stride
  bool peers;
};

// Keys k0 .. k0 + nk - 1 into rows [0, nk) of b.K (kv & 1, with their mask
// bias) and b.V (kv & 2): thread i copies 16-byte column chunk i % (hd / 8)
// of rows i / (hd / 8), + 512 / (hd / 8), ..., a row's key and value loads
// in flight together (more in flight measured slower: registers).
__device__ __forceinline__ void stage_keys(const KeySrc& src, const AttnBuf& b, int hd, int k0,
                                           int nk, int kv) {
  const int hc = hd >> 3, rpp = kT / hc, cc = threadIdx.x % hc, rr = threadIdx.x / hc;
  cg::cluster_group cl = cg::this_cluster();
  auto from = [&](const bf16* base, int r) {
    const int key = k0 + r;
    if (!src.peers) return reinterpret_cast<const uint4*>(base + (long long)key * hd + cc * 8);
    const int p = key / src.tc;
    return reinterpret_cast<const uint4*>(
        cl.map_shared_rank(base + (key - p * src.tc) * src.ld + cc * 8, p));
  };
  if (rr < rpp) {
    for (int r = rr; r < nk; r += rpp) {
      uint4 vk, vv;
      if (kv & 1) vk = *from(src.k, r);
      if (kv & 2) vv = *from(src.v, r);
      if (kv & 1) *reinterpret_cast<uint4*>(b.K + r * b.ldh + cc * 8) = vk;
      if (kv & 2) *reinterpret_cast<uint4*>(b.V + r * b.ldh + cc * 8) = vv;
    }
  }
  if (!src.peers && (kv & 1))
    for (int i = threadIdx.x; i < nk; i += kT) b.negs[i] = src.neg[k0 + i];
}

// One head: O = softmax(bf16(Q K^T) * scale (+ neg)) V over nkeys keys for
// the CTA's n query rows; Q [n, hd] at row stride ld, O written over it.
// All 16 warps share each product as in `gemm16`: warp w takes query rows
// [16 (w & 3), +16) and every fourth 16-key block (QK) or 16 output columns
// (PV). The logits, rounded as dhg rounds them, go to shared memory; 8
// threads a row turn them into the bf16 weights exp(l - max) * (1 / sum)
// (within an ulp or two of dhg's exp(l - max) / sum in f32, at the same
// rounding point). All threads call it; the keys are staged from src
// (stage_keys). Up to kr keys take one pass; more take two over chunks of
// kr: the rows' max and sum, then the logits again and P V.
__device__ __forceinline__ void attend_head(bf16* Q, int ld, int n, int hd, int nkeys,
                                            const AttnBuf& b, const KeySrc& src, float sc) {
  const bf16* negs = src.peers ? nullptr : b.negs;
  auto stage = [&](int k0, int nk, int kv) { stage_keys(src, b, hd, k0, nk, kv); };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tg = lane & 3, dk = hd >> 4, m0 = wm * 16;
  const int q = threadIdx.x % kRowT, t = threadIdx.x / kRowT;  // the softmax's lane and row
  const bool live = m0 < n, row = t < n, one = nkeys <= b.kr;
  const int ldh = b.ldh, lds = b.lds;
  __syncthreads();  // Q complete; the staging buffers free
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (live && kk < dk) load_a(qf[kk], Q, ld, m0, kk * 16, n);
  float o[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // Rounded logits of the staged keys (nk of them) for this warp's rows.
  auto logits = [&](int nk) {
    if (!live) return;
    for (int kb = wn; kb * 16 < nk; kb += 4) {
      float s[2][4];
      block_logits(s, qf, b.K + kb * 16 * ldh, ldh, dk, kb * 16, nk, negs, sc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kb * 16 + j * 8 + 2 * tg;
        if (m0 + g < n) st2(b.S + (m0 + g) * lds + key, rn(s[j][0]), rn(s[j][1]));
        if (m0 + g + 8 < n) st2(b.S + (m0 + g + 8) * lds + key, rn(s[j][2]), rn(s[j][3]));
      }
    }
  };
  // 8 threads a row (t), thread q on the 8-key groups q, q + 8, ...: the
  // row's logits into v (-inf past nk), and their max over the row.
  constexpr int kRG = kHeldKeys / 8 / kRowT;
  float v[kRG][8];
  auto load_row = [&](int nk) {
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRG; ++k) {
      const int c = 8 * (q + kRowT * k);
      if (row && c < nk) {
        ld8(b.S + t * lds + c, v[k]);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, v[k][e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = -INFINITY;
      }
    }
    return row_max(m);
  };
  // v <- exp(v - m); returns the quad's sum of them.
  auto exp_row = [&](float m) {
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < kRG; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[k][e] = __expf(v[k][e] - m);
        l += v[k][e];
      }
    return row_sum(l);
  };

  if (!one) {  // pass 1: every row's max and sum over all chunks
    for (int k0 = 0; k0 < nkeys; k0 += b.kr) {
      const int nk = min(b.kr, nkeys - k0);
      if (k0) __syncthreads();
      stage(k0, nk, 1);
      __syncthreads();
      logits(nk);
      __syncthreads();
      const float2 old = k0 ? b.ml[t] : make_float2(-INFINITY, 0.f);
      const float m = fmaxf(old.x, load_row(nk));
      const float l = old.y * __expf(old.x - m) + exp_row(m);
      __syncwarp();
      if (row && q == 0) b.ml[t] = make_float2(m, l);
    }
  }
  for (int k0 = 0; k0 < nkeys; k0 += b.kr) {
    const int nk = min(b.kr, nkeys - k0), nkp = (nk + 15) & ~15;
    if (k0 || !one) __syncthreads();
    stage(k0, nk, 3);
    __syncthreads();
    logits(nk);
    __syncthreads();
    float m = load_row(nk), inv;
    if (one) {
      inv = 1.f / exp_row(m);
    } else {
      const float2 st = b.ml[t];
      inv = 1.f / st.y;
      exp_row(st.x);
    }
    if (row) {
#pragma unroll
      for (int k = 0; k < kRG; ++k) {
        const int c = 8 * (q + kRowT * k);
        if (c < nkp) {
          bf16 w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) w[e] = rn(v[k][e] * inv);
          st8(b.S + t * lds + c, w);
        }
      }
    }
    __syncthreads();
    if (live && wn * 16 < hd) {
      for (int kb = 0; kb * 16 < nk; ++kb) {
        uint32_t a[4], bb[4];
        load_a(a, b.S, lds, m0, kb * 16, n);
        load_b_kn(bb, b.V + kb * 16 * ldh, ldh, wn * 16, 0);
        mma(o[0], a, bb[0], bb[1]);
        mma(o[1], a, bb[2], bb[3]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = wn * 16 + j * 8 + 2 * tg, r0 = m0 + g;
    if (c < hd) {
      if (r0 < n) st2(Q + r0 * ld + c, rn(o[j][0]), rn(o[j][1]));
      if (r0 + 8 < n) st2(Q + (r0 + 8) * ld + c, rn(o[j][2]), rn(o[j][3]));
    }
  }
}

// out[t, n] = sum_k A[t, k] W[n, k] for t < n_rows (<= 64), n < N: the
// ring's next product (chunks of 64 outputs, 128-deep swizzled tiles),
// handed to epi(t, c, v(t, c), v(t, c + 1)) for even c. Warp w owns rows
// [16 (w & 3), + 16) and columns [16 (w >> 2), + 16) of each chunk: per
// 16-deep step one ldmatrix of A (rows past n_rows read row n_rows - 1),
// one of the tile, two mma.sync. A warp loads the fragments of 4 steps,
// then issues their 8 mma into two accumulator pairs (even and odd steps),
// so no mma waits on the one before it and the next loads are not held
// behind the mma (faster on the card than one step at a time; 8 steps at
// once spill). A warp whose rows all lie past n_rows skips the products.
// Every warp consumes and releases every tile.
// CONV: a k3 'same' conv, K = 3 cin: A is [n_rows + 2, cin] with the row
// before this CTA's first at 0 and the one after its last at n_rows + 1,
// and column k of the weight (tap k / cin) multiplies A[t + k / cin,
// k % cin] (cin a multiple of 16, so a 16-deep step stays in one tap).
template <bool CONV = false, class Epi>
__device__ __forceinline__ void gemm16(ERing& ring, const bf16* A, int lda, int n_rows, int N,
                                       int K, Epi epi, int cin = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m0 = (warp & 3) * 16;
  const int g = lane >> 2, tg = lane & 3, nc = (warp >> 2) * 16, nk = (K + kEK - 1) / kEK;
  const bool live = m0 < n_rows;
  const bf16* arow = A + min(m0 + (lane & 15), n_rows - 1) * lda + ((lane >> 4) << 3);
  // ldmatrix rows of the tile: chunk c (8 k) of row r sits at c ^ (r & 7).
  const int r = nc + (lane & 7) + ((lane >> 4) << 3), hi = (lane >> 3) & 1;
  for (int n0 = 0; n0 < N; n0 += kNT) {
    float acc[2][2][4];  // [step parity][n8 tile]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int ksteps = min(kEK, K - kt * kEK) >> 4;
      const bf16* Wt = ring.consume() + r * kEK;
      if (live) {
#pragma unroll
        for (int k0 = 0; k0 < kEK / 16; k0 += 4) {
          uint32_t af[4][4], bq[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ks = k0 + j, k = kt * kEK + ks * 16;
            if (ks < ksteps) {
              const bf16* ap = arow + k;
              if (CONV) ap += ((k >= cin) + (k >= 2 * cin)) * (lda - cin);
              ldsm_x4(af[j], ap);
              ldsm_x4(bq[j], Wt + (((2 * ks + hi) ^ (r & 7)) << 3));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k0 + j < ksteps) {
              mma(acc[j & 1][0], af[j], bq[j][0], bq[j][1]);
              mma(acc[j & 1][1], af[j], bq[j][2], bq[j][3]);
            }
          }
        }
      }
      ring.release();
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] += acc[1][j][e];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + nc + j * 8 + 2 * tg;
      if (c < N) {
        if (m0 + g < n_rows) epi(m0 + g, c, acc[0][j][0], acc[0][j][1]);
        if (m0 + g + 8 < n_rows) epi(m0 + g + 8, c, acc[0][j][2], acc[0][j][3]);
      }
    }
  }
}

// out[t, c] = bf16(bf16(A W^T)[t, c] + bias[c]) for the ring's next product
// (N outputs, depth K), t < n.
__device__ __forceinline__ void dense(ERing& ring, const bf16* A, int lda, int n, int N, int K,
                                      const bf16* bias, bf16* out, int ldo) {
  gemm16(ring, A, lda, n, N, K, [&](int t, int c, float v0, float v1) {
    st2(out + t * ldo + c, dense_rn(v0, bias[c]), dense_rn(v1, bias[c + 1]));
  });
}

// A layer's activations in the CTA's shared memory, [Tc, ld] each (Hf
// [Tc, ldf] is fc1's hidden, over K2 and V2).
struct RowBufs {
  bf16 *X, *A, *Q, *K2, *V2, *Hf;
  int ld, ldf;
};

// One EncoderLayer.attend over the CTA's n rows (of T; tc a CTA, the last
// CTA's rows may be fewer) at width D (<= MAXD) with H heads: X -> out (row
// stride ldo; out may be X). vec holds the layer's vectors (stage_layer_vec)
// and b's staging buffers must be finite (zeroed once). pe is this CTA's
// rows of the positional embedding [n, D], neg the batch row's mask bias
// [L], bh = batch row x H (the text K/V's [B, H, L, hd] offset). Every CTA
// of the cluster calls it together (two cluster barriers); the caller syncs
// the block before (X and vec written) and after (out read).
template <int MAXD>
__device__ __forceinline__ void layer_rows(cg::cluster_group& cl, ERing& ring, const RowBufs& s,
                                           const AttnBuf& ab, const bf16* vec, const bf16* const* p,
                                           const bf16* pe, const bf16* neg, long long bh, int n,
                                           int T, int D, int H, int L, int tc, float scale,
                                           bf16* out, int ldo) {
  const int hd = D / H, ld = s.ld, ldf = s.ldf, cpr = D >> 3;
  const float sc = bf(rn(scale));
  bf16 *X = s.X, *A = s.A, *Q = s.Q, *K2 = s.K2, *V2 = s.V2, *Hf = s.Hf;

  // A = x + PE.
  for (int i = threadIdx.x; i < n * cpr; i += kT) {
    const int t = i / cpr, col = (i - t * cpr) << 3;
    uint4 xv = *reinterpret_cast<const uint4*>(X + t * ld + col);
    const uint4 pv = *reinterpret_cast<const uint4*>(pe + (long long)t * D + col);
    bf16* x8 = reinterpret_cast<bf16*>(&xv);
    const bf16* p8 = reinterpret_cast<const bf16*>(&pv);
#pragma unroll
    for (int k = 0; k < 8; ++k) x8[k] = rn(bf(x8[k]) + bf(p8[k]));
    *reinterpret_cast<uint4*>(A + t * ld + col) = xv;
  }
  __syncthreads();

  // Cross-attention: Q = (x + PE) wq, each head against its text K/V.
  dense(ring, A, ld, n, D, D, vec + V_BQ * D, Q, ld);
  for (int h = 0; h < H; ++h) {
    const long long base = (bh + h) * L * hd;
    const KeySrc text = {p[KH] + base, p[VH] + base, neg, 0, 0, false};
    attend_head(Q + h * hd, ld, n, hd, L, ab, text, sc);
  }
  __syncthreads();
  dense(ring, Q, ld, n, D, D, vec + V_BO * D, A, ld);
  __syncthreads();
  norm_rows<MAXD>(NORM_X2, n, D, ld, X, A, nullptr, pe, vec + V_G1 * D, vec + V_BE1 * D,
                  nullptr, 0);
  __syncthreads();

  // Self-attention: V2 = x2 wv2, Q = (x2 + PE) wq2, K2 = (x2 + PE) wk2.
  dense(ring, X, ld, n, D, D, vec + V_BV2 * D, V2, ld);
  dense(ring, A, ld, n, D, D, vec + V_BQ2 * D, Q, ld);
  dense(ring, A, ld, n, D, D, vec + V_BK2 * D, K2, ld);
  cl.sync();  // every CTA's K2 and V2 are complete
  for (int h = 0; h < H; ++h) {
    const KeySrc rows = {K2 + h * hd, V2 + h * hd, nullptr, tc, ld, true};
    attend_head(Q + h * hd, ld, n, hd, T, ab, rows, sc);
  }
  __syncthreads();
  dense(ring, Q, ld, n, D, D, vec + V_BO2 * D, A, ld);
  __syncthreads();
  norm_rows<MAXD>(NORM_X3, n, D, ld, X, A, nullptr, nullptr, vec + V_G2 * D, vec + V_BE2 * D,
                  nullptr, 0);
  cl.sync();  // every peer has read this CTA's K2 and V2: fc1's hidden may overwrite them

  // FFN: SiLU(fc1) -> Hf, fc2 over the whole hidden, residual, LN, FiLM.
  dense(ring, A, ld, n, 2 * D, D, vec + V_B1 * D, Hf, ldf);
  __syncthreads();
  // SiLU over the hidden in its own pass: in fc1's epilogue it would hold
  // up the warp that refills the weight ring.
  for (int i = threadIdx.x; i < n * (D >> 2); i += kT) {
    const int t = i / (D >> 2);
    bf16* h = Hf + t * ldf + ((i - t * (D >> 2)) << 3);
    float v[8];
    bf16 y[8];
    ld8(h, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = rn(silu_fast(v[e]));
    st8(h, y);
  }
  __syncthreads();
  dense(ring, Hf, ldf, n, D, 2 * D, vec + V_B2 * D, Q, ld);
  __syncthreads();
  norm_rows<MAXD>(NORM_OUT, n, D, ld, X, nullptr, Q, nullptr, vec + V_G3 * D, vec + V_BE3 * D,
                  out, ldo);
}

}  // namespace row_layer
