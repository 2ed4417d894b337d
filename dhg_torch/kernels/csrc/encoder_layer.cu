// Hand-written Hopper (sm_90a) kernel for the sampler's enc3 and enc5.
//
// Replaces dhg/kernels/fused_bottleneck.py::fused_encoder_layer (one
// EncoderLayer.attend, used for enc3 and enc5) at the rounding points of
// dhg's `_encoder_layer`:
//   * every Dense is a bf16 x bf16 product with f32 accumulation, rounded
//     once to bf16, then `+ bias` in bf16 (two roundings);
//   * logits are rounded to bf16, `* bf16(1/sqrt(hd))`, then `+ mask bias`;
//     the softmax runs in f32, its weights are rounded to bf16, and P.V
//     accumulates in f32 and rounds once;
//   * LayerNorm statistics are f32 and (x - mu) * rsqrt(var + eps) is taken
//     in f32, then rounded; SiLU is computed in f32;
//   * every FiLM multiply and add rounds in bf16.
// (bottleneck.cu and unet_t4.cu's encoder_layer.cuh share that body.)
//
// Design: one batch row over a thread-block cluster of C CTAs, split by
// sequence rows. CTA c owns rows [c Tc, (c + 1) Tc) at full width D, with
// Tc = ceil(T / C) <= 64 and C the fewest CTAs whose shared memory fits
// (enc3 T 196 -> 4 CTAs of 49 rows; enc5 T 98 -> 2 of 49; a 50-token
// prompt's 404 / 202 -> 7 of 58 / 5 of 41; up to 16, above 8 as a
// non-portable cluster, for T up to 1,024 at enc3's width). Launched with
// cudaLaunchKernelEx and a cluster-dimension attribute.
//   * Every Dense, LayerNorm, FiLM step and the FFN is local to the CTA:
//     whole rows sit in one CTA, so LayerNorm needs no exchange and fc2
//     reduces over the whole hidden with one rounding, as dhg does.
//   * Cross-attention is local too: one head's text K/V at a time is staged
//     in shared memory.
//   * Self-attention is the only exchange: each CTA computes K2 and V2 of
//     its rows, a cluster barrier follows, and each head's keys and values
//     are then copied from every CTA's K2/V2 through distributed shared
//     memory into the staging buffer. A second cluster barrier, before fc1's
//     hidden overwrites K2/V2, ends the exchange: two cluster barriers a
//     layer.
//   * A CTA is 16 warps (512 threads, 128 registers a thread): one CTA fits
//     an SM, so the SM hides latency only across the CTA's own warps.
//   * Attention shares out its work like a product: the 16 warps take the
//     16-row query tiles and every fourth 16-key block (Q K^T) or 16-column
//     group (P V); the rounded logits go to shared memory, where 8 threads a
//     row turn them into the bf16 weights. Up to 256 keys are staged at once
//     (one softmax pass); a longer key set takes two passes over chunks of
//     64 (the rows' max and sum, then P V), which keeps dhg's rounding of
//     the normalised weights.
//   * Weights stream through tile_ring.cuh's ring, here 2 slots of [64
//     outputs, 128 k] tiles (one TMA bulk copy a tile, full/empty
//     mbarriers), from a tiled copy the wrapper makes once per weight set
//     (encoder_layer_tiles in fused_bottleneck.py); every CTA of a cluster
//     streams the same tiles from L2.
//   * Products are mma.sync m16n8k16 (bf16 -> f32) with ldmatrix fragments:
//     a warp owns 16 rows x 16 columns of a 64-column chunk.
//
// Shared memory per CTA (bytes, each part rounded up to 128):
//   5 x 2 Tc (D + 8)        X (running activation), A (the next product's
//                           operand), Q (queries, then the attention output
//                           in place), K2, V2 (fc1's hidden [Tc, 2D + 8]
//                           over both after the second cluster barrier)
//   + 2 x 2 kr (hd + 8)     one head's staged keys and values, kr = every
//                           key up to 256 (rounded to 16), else 64
//   + 2 Tc (kr + 8)         its logits, then weights
//   + 512 [64 rows' running max and sum] + 2 kr [mask bias]
//   + 30 D [bias and FiLM vectors] + 32 [mbarriers] + 32,768 [ring].
// enc3 (T 196, Tc 49, D 192, hd 64, kr 208): 98,560 + 59,904 + 21,248 + 512
// + 512 + 5,760 + 128 + 32,768 = 219,392 of 232,448; enc5 (T 98, Tc 49,
// D 256, kr 112): 215,296.
// Limits: Tc <= 64, at most 16 CTAs (T <= 1,024 at D 192, 992 at D 256);
// D <= 256; hd <= 64 and a multiple of 16; at most 8 heads.
//
// What bounds it on an H100: at batch 96 the work is 0.14 (enc5) to 0.18
// (enc3) GFLOP a row (bf16 tensor-core bound, 989 TFLOP/s). What holds it
// back is a CTA's latency, the same at batch 1 and 256: a weight tile
// costs ~0.5 us whatever the ring's depth (2 to 8 slots measured alike), of
// which the mma.sync and ldmatrix work is under half; the element loops
// (softmax, LayerNorm, SiLU) run at a low issue rate; and at B = 96 enc3
// takes 4 waves of clusters (30 clusters of 4 resident).
//
// Built by dhg_torch/kernels/build.py (nvcc for sm_90a, one object per .cu,
// linked into one shared library); bound from Python with ctypes
// (dhg_torch/kernels/fused_bottleneck.py).

#include <cooperative_groups.h>

#include "tile_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace wmma16;
using namespace tile_ring;

constexpr int kMaxTc = 64;       // sequence rows a CTA holds
constexpr int kMaxCluster = 16;  // non-portable above 8
constexpr int kMaxHeads = 8;
constexpr int kMaxHd = 64;
constexpr int kKC = 64;          // keys a staged chunk of a longer key set
constexpr int kHeldKeys = 256;   // keys staged at once (one softmax pass)
constexpr int kMaxD = 256;
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
__constant__ int kSlotOperand[V_B1] = {BQ, BO, BQ2, BK2, BV2, BO2, B2,
                                       G1, BE1, G2, BE2, G3, BE3};

struct Args {
  const bf16* x;    // [B, T, D]
  const bf16* pe;   // [T, D] positional embedding
  const bf16* neg;  // [B, 1, L] additive mask bias (mask * -1e9)
  bf16* out;        // [B, T, D]
  const bf16* wt;   // [tiles, 64, 64]: the layer's weight tiles in schedule order
  int tiles;
  int T, D, H, L, C, tc;
  float scale;      // 1 / sqrt(D / H), rounded to bf16 in the kernel
  const bf16* p[PER_LAYER];
};

__host__ __device__ inline long long up128(long long v) { return (v + 127) & ~127LL; }

// Byte offsets of the shared-memory parts (see the note at the top).
struct Layout {
  int C, tc, ld, ldh, ldf, kr, lds;
  long long x, a, q, k2, v2, ks, vs, s, ml, negs, vec, bar, ring, total;
};

__host__ __device__ inline Layout layout_tc(int T, int D, int H, int tc) {
  Layout o;
  o.tc = tc;
  o.C = (T + tc - 1) / tc;
  o.ld = D + 8;
  o.ldh = D / H + 8;
  o.ldf = 2 * D + 8;
  // Keys staged at once: every key of a self-attention up to 256, else 64.
  o.kr = T <= kHeldKeys ? (T + 15) & ~15 : kKC;
  if (o.kr < kKC) o.kr = kKC;
  o.lds = o.kr + 8;
  const long long buf = up128(2LL * tc * o.ld), kv = up128(2LL * o.kr * o.ldh);
  o.x = 0;
  o.a = buf;
  o.q = 2 * buf;
  o.k2 = 3 * buf;
  o.v2 = 4 * buf;
  o.ks = 5 * buf;
  o.vs = o.ks + kv;
  o.s = o.vs + kv;
  o.ml = o.s + up128(2LL * tc * o.lds);
  o.negs = o.ml + up128(8LL * kMaxTc);
  o.vec = o.negs + up128(2LL * o.kr);
  o.bar = o.vec + up128(2LL * V_SLOTS * D);
  o.ring = o.bar + up128(16LL * kEStages);
  o.total = o.ring + 2LL * kEStages * kETile;
  return o;
}

// The fewest CTAs of at most 64 rows whose shared memory fits; the last
// layout tried, or one CTA of T rows, when none does (valid() refuses it).
inline Layout layout(int T, int D, int H) {
  Layout o = layout_tc(T, D, H, T);
  for (int c = (T + kMaxTc - 1) / kMaxTc; c <= kMaxCluster; ++c) {
    o = layout_tc(T, D, H, (T + c - 1) / c);
    if (o.total <= kMaxSmem) break;
  }
  return o;
}

// Weight tiles the ring streams: wq, wo, wv2, wq2, wk2, wo2 ([D, D]), fc1
// ([2D, D]) and fc2 ([D, 2D]), each as [64 output rows, 128 k] tiles.
inline int tiles_for(int D) {
  const int n = (D + kNT - 1) / kNT, n2 = (2 * D + kNT - 1) / kNT;
  const int k = (D + kEK - 1) / kEK, k2 = (2 * D + kEK - 1) / kEK;
  return 6 * n * k + n2 * k + n * k2;
}

bool valid(int B, int T, int D, int H, int L) {
  if (B < 1 || T < 1 || L < 1 || H < 1 || H > kMaxHeads || D % H) return false;
  const int hd = D / H;
  if (hd % 16 || hd > kMaxHd || D > kMaxD) return false;
  const Layout o = layout(T, D, H);
  return o.tc <= kMaxTc && o.C <= kMaxCluster && o.total <= kMaxSmem;
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
//   NORM_OUT: film3(LN(X + Q)) -> out (row stride D).
enum { NORM_X2, NORM_X3, NORM_OUT };

// LayerNorm over D (<= 256) of the CTA's n rows (n <= 64), 8 threads a row,
// thread q on the 8-column groups q, q + 8, ... (16-byte accesses); g and
// be are the FiLM gamma and beta.
__device__ __forceinline__ void norm_rows(int mode, int n, int D, int ld, bf16* X, bf16* A,
                                          const bf16* Qb, const bf16* pe, const bf16* g,
                                          const bf16* be, bf16* out) {
  constexpr int kG = kMaxD / 8 / kRowT;  // groups a thread
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
      st8(out + (long long)t * D + c, y);
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
// one of the tile, two mma.sync (16 warps hide each other's latency, so a
// warp keeps few fragments live). Every warp consumes and releases every
// tile.
template <class Epi>
__device__ __forceinline__ void gemm16(ERing& ring, const bf16* A, int lda, int n_rows, int N,
                                       int K, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, m0 = (warp & 3) * 16;
  const int g = lane >> 2, tg = lane & 3, nc = (warp >> 2) * 16, nk = (K + kEK - 1) / kEK;
  const bf16* arow = A + min(m0 + (lane & 15), n_rows - 1) * lda + ((lane >> 4) << 3);
  // ldmatrix rows of the tile: chunk c (8 k) of row r sits at c ^ (r & 7).
  const int r = nc + (lane & 7) + ((lane >> 4) << 3), hi = (lane >> 3) & 1;
  for (int n0 = 0; n0 < N; n0 += kNT) {
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int ksteps = min(kEK, K - kt * kEK) >> 4;
      const bf16* Wt = ring.consume() + r * kEK;
#pragma unroll
      for (int ks = 0; ks < kEK / 16; ++ks) {
        if (ks < ksteps) {
          uint32_t af[4], bq[4];
          ldsm_x4(af, arow + kt * kEK + ks * 16);
          ldsm_x4(bq, Wt + (((2 * ks + hi) ^ (r & 7)) << 3));
          mma(acc[0], af, bq[0], bq[1]);
          mma(acc[1], af, bq[2], bq[3]);
        }
      }
      ring.release();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + nc + j * 8 + 2 * tg;
      if (c < N) {
        if (m0 + g < n_rows) epi(m0 + g, c, acc[j][0], acc[j][1]);
        if (m0 + g + 8 < n_rows) epi(m0 + g + 8, c, acc[j][2], acc[j][3]);
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

__global__ void __launch_bounds__(kT, 1) encoder_layer_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank(), b = blockIdx.y;
  const int T = a.T, D = a.D, H = a.H, L = a.L, hd = D / H, tc = a.tc;
  const Layout lo = layout_tc(T, D, H, tc);
  const int r0 = c * tc, n = min(tc, T - r0);  // this CTA's rows
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* X = reinterpret_cast<bf16*>(sm + lo.x);
  bf16* A = reinterpret_cast<bf16*>(sm + lo.a);
  bf16* Q = reinterpret_cast<bf16*>(sm + lo.q);
  bf16* K2 = reinterpret_cast<bf16*>(sm + lo.k2);
  bf16* V2 = reinterpret_cast<bf16*>(sm + lo.v2);
  bf16* Hf = K2;  // fc1's hidden [Tc, 2D + 8] over K2 and V2
  AttnBuf ab;
  ab.K = reinterpret_cast<bf16*>(sm + lo.ks);
  ab.V = reinterpret_cast<bf16*>(sm + lo.vs);
  ab.S = reinterpret_cast<bf16*>(sm + lo.s);
  ab.ml = reinterpret_cast<float2*>(sm + lo.ml);
  ab.kr = lo.kr;
  ab.ldh = lo.ldh;
  ab.lds = lo.lds;
  ab.negs = reinterpret_cast<bf16*>(sm + lo.negs);
  bf16* vec = reinterpret_cast<bf16*>(sm + lo.vec);
  const int ld = lo.ld, ldf = lo.ldf, cpr = D >> 3;
  const float sc = bf(rn(a.scale));
  const bf16* pe = a.pe + (long long)r0 * D;

  // This CTA's rows of x -> X with cp.async.
  const bf16* x = a.x + ((long long)b * T + r0) * D;
  for (int i = threadIdx.x; i < n * cpr; i += kT) {
    const int r = i / cpr, col = (i - r * cpr) << 3;
    cp_async16(X + r * ld + col, x + (long long)r * D + col);
  }
  cp_async_commit();
  ERing ring;
  ring.src = a.wt;
  ring.base = reinterpret_cast<bf16*>(sm + lo.ring);
  ring.full = reinterpret_cast<uint64_t*>(sm + lo.bar);
  ring.empty = ring.full + kEStages;
  ring.tiles = a.tiles;
  ring.issued = ring.consumed = 0;
  if (threadIdx.x < kEStages) {
    mbar_init(ring.full + threadIdx.x, 1);
    mbar_init(ring.empty + threadIdx.x, kW);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // Bias and FiLM vectors; the staging buffers zeroed once (a chunk's pad
  // rows of V must be finite: their weights are 0).
  for (int i = threadIdx.x; i < (V_B1 + 2) * cpr; i += kT) {
    const int s = i / cpr, col = (i - s * cpr) << 3;
    const bf16* src = s < V_B1 ? a.p[kSlotOperand[s]] + col : a.p[B1] + (s - V_B1) * D + col;
    *reinterpret_cast<uint4*>(vec + s * D + col) = *reinterpret_cast<const uint4*>(src);
  }
  for (long long i = threadIdx.x; i < (lo.s - lo.ks) / 16; i += kT)
    reinterpret_cast<uint4*>(sm + lo.ks)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int s = 0; s < kEStages - 1; ++s) ring.issue();
  cp_async_wait<0>();
  __syncthreads();

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
    const long long base = ((long long)b * H + h) * L * hd;
    const KeySrc text = {a.p[KH] + base, a.p[VH] + base, a.neg + (long long)b * L, 0, 0, false};
    attend_head(Q + h * hd, ld, n, hd, L, ab, text, sc);
  }
  __syncthreads();
  dense(ring, Q, ld, n, D, D, vec + V_BO * D, A, ld);
  __syncthreads();
  norm_rows(NORM_X2, n, D, ld, X, A, nullptr, pe, vec + V_G1 * D, vec + V_BE1 * D, nullptr);
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
  norm_rows(NORM_X3, n, D, ld, X, A, nullptr, nullptr, vec + V_G2 * D, vec + V_BE2 * D, nullptr);
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
  norm_rows(NORM_OUT, n, D, ld, X, nullptr, Q, nullptr, vec + V_G3 * D, vec + V_BE3 * D,
            a.out + ((long long)b * T + r0) * D);
}

// Launches (B > 0) or asks how many clusters fit at once (B == 0, into *n).
cudaError_t run(const Args& a, const Layout& lo, int B, cudaStream_t stream, int* n) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(encoder_layer_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(encoder_layer_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(lo.C, B > 0 ? B : 1);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = (size_t)lo.total;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lo.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (B == 0) return cudaOccupancyMaxActiveClusters(n, encoder_layer_kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, encoder_layer_kernel, a);
}

}  // namespace

extern "C" {

const char* dhg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The launch shape of one row: CTAs in its cluster, rows a CTA (at most
// 64), shared memory of a CTA (bytes). encoder_layer_layout in
// fused_bottleneck.py mirrors it.
long long dhg_encoder_layer_cluster(int T, int D, int H) { return layout(T, D, H).C; }
long long dhg_encoder_layer_rows(int T, int D, int H) { return layout(T, D, H).tc; }
long long dhg_encoder_layer_smem_bytes(int T, int D, int H) { return layout(T, D, H).total; }

// How many clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
int dhg_encoder_layer_max_clusters(int T, int D, int H, int L) {
  if (!valid(1, T, D, H, L)) return -1;
  Args a = {};
  int n = -1;
  return run(a, layout(T, D, H), 0, 0, &n) == cudaSuccess ? n : -1;
}

// One EncoderLayer.attend over a cluster of CTAs per batch row. wt holds the
// layer's `tiles` weight tiles (encoder_layer_tiles in fused_bottleneck.py);
// ops are the 24 per-layer operands (their weights are not read here).
// Returns cudaGetLastError() after the launch.
int dhg_fused_encoder_layer(const void* x, const void* pe, const void* neg,
                            const void* const* ops, const void* wt, int tiles, void* out, int B,
                            int T, int D, int H, int L, void* stream) {
  if (!valid(B, T, D, H, L) || tiles != tiles_for(D)) return (int)cudaErrorInvalidValue;
  const Layout lo = layout(T, D, H);
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.pe = static_cast<const bf16*>(pe);
  a.neg = static_cast<const bf16*>(neg);
  a.out = static_cast<bf16*>(out);
  a.wt = static_cast<const bf16*>(wt);
  a.tiles = tiles;
  a.T = T; a.D = D; a.H = H; a.L = L; a.C = lo.C; a.tc = lo.tc;
  a.scale = (float)(1.0 / sqrt((double)(D / H)));
  for (int k = 0; k < PER_LAYER; ++k) a.p[k] = static_cast<const bf16*>(ops[k]);
  const cudaError_t e = run(a, lo, B, static_cast<cudaStream_t>(stream), nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
