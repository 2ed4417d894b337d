// Hand-written Hopper (sm_90a) kernel for the sampler's whole T/4..T/8 region.
//
// Replaces dhg/kernels/fused_bottleneck.py::fused_unet_t4 (body
// `_make_t4_kernel`). For one batch row x [T4, C2] (the pooled h2):
//   enc4 ConvBlock C2 -> C3, then enc5 EncoderLayer (C3 wide, H5 heads, pe4);
//   window-2 mean, att_dense C3 -> D, then nlayers EncoderLayers (D, H8, pe8);
//   nearest upsample + skip_conv3(h3), then dec3 ConvBlock D -> C3,
// at the Pallas kernel's rounding points:
//   * each k3 conv sums its three taps and its bias in f32 and rounds once
//     (`_conv3_packed`);
//   * in a ConvBlock (dhg's `_conv_block_packed`, bf16, unlike
//     fused_conv_block's f32) SiLU is computed in f32; the FiLM multiplies
//     and adds, the fc's `+ bias` (after its own rounding) and `h + skip`
//     round in bf16;
//   * the pool's pair mean is taken in f32 and rounded once; the upsampled
//     x8 plus skip_conv3's output rounds in bf16;
//   * the EncoderLayers are row_layer.cuh's `layer_rows` (the rounding points
//     listed in encoder_layer.cu).
//
// Design: one batch row over a thread-block cluster of C CTAs split by
// sequence rows (cudaLaunchKernelEx with a cluster-dimension attribute).
// CTA c owns T/4 rows [c tc, c tc + n), tc even, so it also owns T/8 rows
// [c tc / 2, +n / 2): the pool's pairs and the upsample's sources never
// leave a CTA, and every stage runs on the same split, with no
// redistribution. C is the fewest CTAs whose rows fit (the canonical
// T4 = 98: 2 CTAs of 50 and 48 rows): a CTA's time is set by the weight
// tiles it streams, all of them whatever its rows, so more CTAs a row buy
// no latency and cost throughput (PERF.md, PR 6).
//   * The row's activations stay in shared memory from x to dec3's output:
//     the input rows, h3 (kept through the bottleneck for skip_conv3), x8,
//     and per stage a union of buffers (a ConvBlock's input, skip, hidden
//     and SiLU'd conv2 output; an EncoderLayer's A, Q, K2, V2).
//   * A k3 conv is one product with K = 3 Cin over the CTA's rows and one
//     halo row on each side (row_layer.cuh's gemm16<CONV>): the input rows
//     sit at 1..n of a buffer whose rows 0 and n + 1 hold the neighbours'
//     boundary rows. enc4's input reads its halo from global memory; for
//     conv2 of each ConvBlock, skip_conv3 and dec3's input, each CTA pushes
//     its first and last rows into its neighbours' halo rows through
//     distributed shared memory (16-byte stores), then one cluster barrier.
//     The two ends of the cluster hold zero rows ('same' padding). No halo
//     is recomputed. One cluster barrier ends the prologue: a CTA may write
//     a peer's shared memory only once every CTA of the cluster has started.
//   * enc5 and the bottleneck's layers are row_layer.cuh's layer body on the
//     same split (at T/8 with tc / 2 rows a CTA): Dense, LayerNorm, FiLM and
//     FFN stay in the CTA; only the self-attention's K/V cross CTAs.
//   * Weights stream through one ring of [64 outputs, 128 k] tiles (TMA bulk
//     copies, 2 slots, full/empty mbarriers) walking one schedule of all 612
//     of the region's tiles at the canonical widths, from a tiled copy the
//     model makes once per weight set (DiffusionModel.t4_tiles).
//     Every CTA of a cluster streams every tile from L2 (the row split keeps
//     whole rows in a CTA); TMA multicast is not used (see PERF.md).
//   * 16 warps a CTA, mma.sync m16n8k16 with ldmatrix fragments (a warp
//     loads 4 steps' fragments, then issues their mma); a warp whose 16 rows
//     lie past the CTA's skips the products.
//
// Shared memory per CTA (bytes, each part rounded up to 128), tc rows, t8 =
// tc / 2, ldX = X + 8:
//   union: max(enc4's [tc + 2, C2] input + [tc, C3] skip + [tc + 2, C3 / 2]
//          hidden + [tc, C3] SiLU'd conv2 output; dec3's the same with a
//          [tc + 2, D] input; enc5's 4 [tc, C3]; the pooled [t8, C3] + 4
//          [t8, D]), all at row stride ldX
//   + [tc + 2, C3] h3 + [t8, D] x8
//   + 2 [kr, max hd + 8] staged keys / values + [tc, kr + 8] logits, kr the
//     keys staged at once: every key of enc5's self-attention (up to 256),
//     or chunks of 64 (two softmax passes) where that does not fit
//   + 512 [rows' max and sum] + 2 kr [mask bias] + 30 max(C3, D) [vectors]
//   + 32 [mbarriers] + 32,768 [ring].
// Canonical (T4 98, C2 192, C3 256, D 384, tc 50, kr 64): 226,048 of
// 232,448; a 50-token prompt (T4 202, 4 CTAs, tc 52, kr 64) 232,192. C
// starts at 1 and grows to 8 where a row does not fit (held keys first,
// then chunks): at the canonical widths T4 up to 416.
// Limits: tc <= 64, at most 8 CTAs; C3, D <= 384; head dims <= 64, a
// multiple of 16; at most 8 heads; widths multiples of 16.
//
// What bounds it on an H100 (t4_work in chip_smoke.py): ~0.71 GFLOP a row,
// so bf16 tensor-core bound at batch 96 (0.069 ms at 989 TFLOP/s); at batch
// 1 the ~10 MB of weights (3.0 us at 3.35 TB/s). What holds it back is a
// CTA's latency, the same at every batch and with 2 to 7 CTAs a row: the
// 612 weight tiles every CTA multiplies one after another, each costing
// more than its tensor work (the ring's copies arrive at a fixed rate per
// SM whatever the ring's depth; a tile's mma chain is latency bound), then
// the attention layers; 2 CTAs a row hold 66 rows on the card at once.
//
// Built by dhg_torch/kernels/build.py; bound with ctypes
// (dhg_torch/kernels/fused_bottleneck.py).

#include "row_layer.cuh"

namespace {

using namespace row_layer;

constexpr int kMaxLayers = 8;
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxD = 384;      // widest EncoderLayer (enc5's C3, the bottleneck's D)
constexpr int kMaxHeads = 8;

// ConvBlock operand order, as in dhg's _PER_CONV list: the k3 convs
// conv_skip, conv1, conv2 as [Co, 3 Cin] rows, each with its bias; fc [Co,
// Co] (torch Linear layout) and bias; FiLM gamma/beta [Co/2], [Co], [Co].
enum { WSKIP, BSKIP, CW1, CB1, CW2, CB2, WFC, BFC, CG1, CBE1, CG2, CBE2, CG3, CBE3, PER_CONV };

// A ConvBlock's vectors staged in shared memory, Co apart.
enum { C_BSKIP, C_B1, C_B2, C_BFC, C_G1, C_BE1, C_G2, C_BE2, C_G3, C_BE3, C_SLOTS };

struct Args {
  const bf16* x;     // [B, T4, C2]
  const bf16* neg;   // [B, 1, L] additive mask bias
  const bf16* pe4;   // [T4, C3] enc5 positional embedding
  const bf16* pe8;   // [T4 / 2, D] bottleneck positional embedding
  const bf16* ab;    // att_dense bias [D]
  const bf16* sk3b;  // skip_conv3 bias [D]
  const bf16* enc4[PER_CONV];
  const bf16* dec3[PER_CONV];
  const bf16* enc5[PER_LAYER];
  const bf16* att[kMaxLayers][PER_LAYER];
  const bf16* wt;    // [tiles, 64, 128]: every weight tile in schedule order
  bf16* out;         // [B, T4, C3]
  int tiles, T4, C2, C3, D, H5, H8, L, nlayers, C, tc, kr;
  float scale5, scale8;  // 1 / sqrt(head dim) of enc5 and of the bottleneck
};

// A ConvBlock's buffers (byte offsets): the input [tc + 2, cin + 8] with
// halo rows, the skip [tc, co + 8], conv1's SiLU'd output [tc + 2, co / 2
// + 8] with halo rows, conv2's SiLU'd output [tc, co + 8].
struct ConvParts {
  long long xin, sk, hh, hf, end;
};

__host__ __device__ inline ConvParts conv_parts(int tc, int cin, int co) {
  ConvParts p;
  p.xin = 0;
  p.sk = up128(2LL * (tc + 2) * (cin + 8));
  p.hh = p.sk + up128(2LL * tc * (co + 8));
  p.hf = p.hh + up128(2LL * (tc + 2) * (co / 2 + 8));
  p.end = p.hf + up128(2LL * tc * (co + 8));
  return p;
}

// An EncoderLayer's A, Q, K2, V2 [rows, d + 8] from offset o (fc1's hidden
// over K2 and V2).
struct LayerParts {
  long long a, q, k, v, end;
};

__host__ __device__ inline LayerParts layer_parts(long long o, int rows, int d) {
  const long long buf = up128(2LL * rows * (d + 8));
  return {o, o + buf, o + 2 * buf, o + 3 * buf, o + 4 * buf};
}

__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }

// Byte offsets of the shared-memory parts (see the note at the top).
struct Layout {
  int C, tc, kr, hdm;
  ConvParts e4, d3;   // in the union, from 0
  LayerParts l5, l8;  // in the union; l8 after the pooled rows at 0
  long long h3, x8, ks, vs, s, ml, negs, vec, bar, ring, total;
};

// Keys staged at once for both self-attentions: every key up to 256.
__host__ __device__ inline int held_keys(int T4) {
  return staged_keys(T4) > staged_keys(T4 / 2) ? staged_keys(T4) : staged_keys(T4 / 2);
}

__host__ __device__ inline Layout layout_tc(int T4, int C2, int C3, int D, int H5, int H8,
                                            int tc, int kr) {
  Layout o;
  const int t8 = tc / 2;
  o.tc = tc;
  o.C = (T4 + tc - 1) / tc;
  o.kr = kr;
  o.hdm = (C3 / H5 > D / H8 ? C3 / H5 : D / H8) + 8;
  o.e4 = conv_parts(tc, C2, C3);
  o.d3 = conv_parts(tc, D, C3);
  o.l5 = layer_parts(0, tc, C3);
  o.l8 = layer_parts(up128(2LL * t8 * (C3 + 8)), t8, D);
  o.h3 = lmax(lmax(o.e4.end, o.d3.end), lmax(o.l5.end, o.l8.end));
  o.x8 = o.h3 + up128(2LL * (tc + 2) * (C3 + 8));
  o.ks = o.x8 + up128(2LL * t8 * (D + 8));
  o.vs = o.ks + up128(2LL * o.kr * o.hdm);
  o.s = o.vs + up128(2LL * o.kr * o.hdm);
  o.ml = o.s + up128(2LL * tc * (o.kr + 8));
  o.negs = o.ml + up128(8LL * kMaxTc);
  o.vec = o.negs + up128(2LL * o.kr);
  o.bar = o.vec + up128(2LL * V_SLOTS * (C3 > D ? C3 : D));
  o.ring = o.bar + up128(16LL * kEStages);
  o.total = o.ring + 2LL * kEStages * kETile;
  return o;
}

// An even number of rows a CTA, from one CTA up to 8: the first
// whose rows (at most 64) fit, with every self-attention key staged at once
// or, where that does not fit, chunks of 64 (two softmax passes); the last
// tried when none does (valid() refuses it).
inline Layout layout(int T4, int C2, int C3, int D, int H5, int H8) {
  Layout o = layout_tc(T4, C2, C3, D, H5, H8, T4, held_keys(T4));
  for (int c = 1; c <= kMaxCluster; ++c) {
    const int tc = 2 * ((T4 / 2 + c - 1) / c);
    const int keys[2] = {held_keys(T4), kKC};
    for (int kr : keys) {
      o = layout_tc(T4, C2, C3, D, H5, H8, tc, kr);
      if (tc <= kMaxTc && o.total <= kMaxSmem) return o;
    }
  }
  return o;
}

// Weight tiles of the whole schedule: enc4, enc5, att_dense, the layers,
// skip_conv3, dec3.
inline int t4_tiles(int C2, int C3, int D, int nlayers) {
  auto block = [](int cin, int co) {
    return tiles_of(co, 3 * cin) + tiles_of(co / 2, 3 * cin) + tiles_of(co, 3 * (co / 2)) +
           tiles_of(co, co);
  };
  return block(C2, C3) + layer_tiles(C3) + tiles_of(D, C3) + nlayers * layer_tiles(D) +
         tiles_of(D, 3 * C3) + block(D, C3);
}

bool valid(int B, int T4, int C2, int C3, int D, int H5, int H8, int L, int nlayers) {
  if (B < 1 || T4 < 2 || T4 % 2 || L < 1 || nlayers < 1 || nlayers > kMaxLayers) return false;
  if (C2 % 16 || C3 % 32 || D % 16) return false;
  if (C3 > kMaxD || D > kMaxD || H5 < 1 || H8 < 1 || H5 > kMaxHeads || H8 > kMaxHeads) return false;
  if (C3 % H5 || D % H8 || (C3 / H5) % 16 || (D / H8) % 16) return false;
  if (C3 / H5 > kMaxHd || D / H8 > kMaxHd) return false;
  const Layout o = layout(T4, C2, C3, D, H5, H8);
  return o.tc <= kMaxTc && o.C <= kMaxCluster && o.total <= kMaxSmem;
}

__device__ __forceinline__ bf16* at(unsigned char* sm, long long off) {
  return reinterpret_cast<bf16*>(sm + off);
}

// Rows [0, rows) x cols (a multiple of 8) of buf, row stride ld: SiLU in f32,
// rounded, in place.
__device__ __forceinline__ void silu_rows(bf16* buf, int rows, int cols, int ld) {
  const int cpr = cols >> 3;
  for (int i = threadIdx.x; i < rows * cpr; i += kT) {
    const int r = i / cpr;
    bf16* p = buf + r * ld + ((i - r * cpr) << 3);
    float v[8];
    bf16 y[8];
    ld8(p, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = rn(silu_fast(v[e]));
    st8(p, y);
  }
}

// This CTA's first and last rows of a conv input (rows 1 and n of buf, w
// columns, row stride ld) into its neighbours' halo rows: the previous
// CTA's row tc + 1 and the next CTA's row 0, 16-byte distributed-shared-
// memory stores. At the cluster's ends the CTA zeroes its own outer halo
// row instead ('same' padding). The caller syncs the block before and the
// cluster after.
__device__ __forceinline__ void push_halo(cg::cluster_group& cl, bf16* buf, int ld, int n, int tc,
                                          int w, int c, int C) {
  const int cpr = w >> 3;
  for (int i = threadIdx.x; i < 2 * cpr; i += kT) {
    const int side = i / cpr, col = (i - side * cpr) << 3;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (side == 0) {
      if (c > 0) v = *reinterpret_cast<const uint4*>(buf + ld + col);
      bf16* dst = c > 0 ? cl.map_shared_rank(buf + (tc + 1) * ld + col, c - 1) : buf + col;
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      if (c < C - 1) v = *reinterpret_cast<const uint4*>(buf + n * ld + col);
      bf16* dst = c < C - 1 ? cl.map_shared_rank(buf + col, c + 1) : buf + (n + 1) * ld + col;
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

// A ConvBlock's vectors into vec (C_SLOTS x co). The caller syncs the block
// before they are read.
__device__ __forceinline__ void stage_conv_vec(bf16* vec, const bf16* const* w, int co) {
  const int ch = co / 2, cpr = co >> 3;
  const bf16* src[C_SLOTS] = {w[BSKIP], w[CB1], w[CB2], w[BFC], w[CG1],
                              w[CBE1], w[CG2], w[CBE2], w[CG3], w[CBE3]};
  for (int i = threadIdx.x; i < C_SLOTS * cpr; i += kT) {
    const int s = i / cpr, col = (i - s * cpr) << 3;
    const bool half = s == C_B1 || s == C_G1 || s == C_BE1;
    if (!half || col < ch)
      *reinterpret_cast<uint4*>(vec + s * co + col) = *reinterpret_cast<const uint4*>(src[s] + col);
  }
}

// bf16(bf16(bf16(acc + b) * g) + be): a conv (taps and bias in f32, one
// rounding) followed by FiLM.
__device__ __forceinline__ float conv_film(float acc, bf16 b, bf16 g, bf16 be) {
  const float y = bf(rn(acc + bf(b)));
  return bf(rn(bf(rn(y * bf(g))) + bf(be)));
}

// One ConvBlock (dhg's _conv_block_packed) on this CTA's n rows. The input
// is at rows 1..n of p.xin (row stride cin + 8) with the neighbours' rows (or
// zeros) at 0 and n + 1; the output goes to out (row stride ldo). vec must
// be free (the caller syncs the block before).
__device__ __forceinline__ void conv_block(cg::cluster_group& cl, ERing& ring, unsigned char* sm,
                                           const ConvParts& p, const bf16* const* w, bf16* vec,
                                           int n, int tc, int c, int C, int cin, int co,
                                           bf16* out, int ldo) {
  const int ch = co / 2, ldi = cin + 8, ldc = co + 8, ldh = ch + 8;
  bf16 *X = at(sm, p.xin), *SK = at(sm, p.sk), *HH = at(sm, p.hh), *HF = at(sm, p.hf);
  auto v = [&](int slot, int col) { return vec[slot * co + col]; };
  stage_conv_vec(vec, w, co);
  __syncthreads();
  // skip = conv_skip(x).
  gemm16<true>(ring, X, ldi, n, co, 3 * cin, [&](int t, int col, float v0, float v1) {
    st2(SK + t * ldc + col, rn(v0 + bf(v(C_BSKIP, col))), rn(v1 + bf(v(C_BSKIP, col + 1))));
  }, cin);
  __syncthreads();
  silu_rows(X, n + 2, cin, ldi);
  __syncthreads();
  // SiLU(film1(conv1(SiLU(x)))) -> HH rows 1..n, then its halo rows.
  gemm16<true>(ring, X, ldi, n, ch, 3 * cin, [&](int t, int col, float v0, float v1) {
    const float y0 = conv_film(v0, v(C_B1, col), v(C_G1, col), v(C_BE1, col));
    const float y1 = conv_film(v1, v(C_B1, col + 1), v(C_G1, col + 1), v(C_BE1, col + 1));
    st2(HH + (t + 1) * ldh + col, rn(silu_fast(y0)), rn(silu_fast(y1)));
  }, cin);
  __syncthreads();
  push_halo(cl, HH, ldh, n, tc, ch, c, C);
  cl.sync();
  // SiLU(film2(conv2(.))) -> HF.
  gemm16<true>(ring, HH, ldh, n, co, 3 * ch, [&](int t, int col, float v0, float v1) {
    const float y0 = conv_film(v0, v(C_B2, col), v(C_G2, col), v(C_BE2, col));
    const float y1 = conv_film(v1, v(C_B2, col + 1), v(C_G2, col + 1), v(C_BE2, col + 1));
    st2(HF + t * ldc + col, rn(silu_fast(y0)), rn(silu_fast(y1)));
  }, ch);
  __syncthreads();
  // film3(fc(.) + bias) + skip -> out.
  gemm16(ring, HF, ldc, n, co, co, [&](int t, int col, float v0, float v1) {
    const bf16 y0 = rn(film(dense_rn(v0, v(C_BFC, col)), v(C_G3, col), v(C_BE3, col)));
    const bf16 y1 =
        rn(film(dense_rn(v1, v(C_BFC, col + 1)), v(C_G3, col + 1), v(C_BE3, col + 1)));
    const bf16* s = SK + t * ldc + col;
    st2(out + (long long)t * ldo + col, rn(bf(y0) + bf(s[0])), rn(bf(y1) + bf(s[1])));
  });
}

__global__ void __launch_bounds__(kT, 1) unet_t4_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank(), C = a.C, b = blockIdx.y;
  const int T4 = a.T4, C2 = a.C2, C3 = a.C3, D = a.D, L = a.L, tc = a.tc, t8 = tc / 2;
  const Layout lo = layout_tc(T4, C2, C3, D, a.H5, a.H8, tc, a.kr);
  const int r0 = c * tc, n = min(tc, T4 - r0), n8 = n / 2;  // this CTA's rows
  const int ld2 = C2 + 8, ld3 = C3 + 8, ldd = D + 8;
  extern __shared__ __align__(128) unsigned char sm[];
  bf16 *H3 = at(sm, lo.h3), *X8 = at(sm, lo.x8), *vec = at(sm, lo.vec);
  AttnBuf ab;
  ab.K = at(sm, lo.ks);
  ab.V = at(sm, lo.vs);
  ab.S = at(sm, lo.s);
  ab.ml = reinterpret_cast<float2*>(sm + lo.ml);
  ab.negs = at(sm, lo.negs);

  // enc4's input: x rows r0 - 1 .. r0 + n (zero outside the row) with cp.async.
  bf16* XI = at(sm, lo.e4.xin);
  const int cpr2 = C2 >> 3;
  for (int i = threadIdx.x; i < (n + 2) * cpr2; i += kT) {
    const int r = i / cpr2, col = (i - r * cpr2) << 3, g = r0 - 1 + r;
    if (g >= 0 && g < T4)
      cp_async16(XI + r * ld2 + col, a.x + ((long long)b * T4 + g) * C2 + col);
    else
      *reinterpret_cast<uint4*>(XI + r * ld2 + col) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  ERing ring;
  ring.src = a.wt;
  ring.base = at(sm, lo.ring);
  ring.full = reinterpret_cast<uint64_t*>(sm + lo.bar);
  ring.empty = ring.full + kEStages;
  ring.tiles = a.tiles;
  ring.issued = ring.consumed = 0;
  if (threadIdx.x < kEStages) {
    mbar_init(ring.full + threadIdx.x, 1);
    mbar_init(ring.empty + threadIdx.x, kW);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // The staging buffers zeroed once (a chunk's pad rows of V must be finite).
  for (long long i = threadIdx.x; i < (lo.s - lo.ks) / 16; i += kT)
    reinterpret_cast<uint4*>(sm + lo.ks)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // Every CTA of the cluster has started before any writes a peer's shared
  // memory (the first push_halo, in enc4's conv_block).
  cl.sync();
  for (int s = 0; s < kEStages - 1; ++s) ring.issue();
  cp_async_wait<0>();
  // enc4 -> h3 rows 1..n (conv_block syncs the block first).
  conv_block(cl, ring, sm, lo.e4, a.enc4, vec, n, tc, c, C, C2, C3, H3 + ld3, ld3);
  __syncthreads();

  // enc5 in place on h3 (step -1), then the pool and att_dense into x8 and
  // the bottleneck's layers in place on it: one call site of the layer body.
  for (int l = -1; l < a.nlayers; ++l) {
    const bool t8s = l >= 0;
    if (l == 0) {
      // Window-2 mean of h3's rows (pairs never cross a CTA), then att_dense.
      bf16* P8 = at(sm, 0);
      const int cpr3 = C3 >> 3;
      for (int i = threadIdx.x; i < n8 * cpr3; i += kT) {
        const int r = i / cpr3, col = (i - r * cpr3) << 3;
        float u[8], w[8];
        bf16 y[8];
        ld8(H3 + (2 * r + 1) * ld3 + col, u);
        ld8(H3 + (2 * r + 2) * ld3 + col, w);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = rn((u[e] + w[e]) * 0.5f);
        st8(P8 + r * ld3 + col, y);
      }
      for (int i = threadIdx.x; i < (D >> 3); i += kT)
        *reinterpret_cast<uint4*>(vec + 8 * i) = *reinterpret_cast<const uint4*>(a.ab + 8 * i);
      __syncthreads();
      dense(ring, P8, ld3, n8, D, C3, vec, X8, ldd);
      __syncthreads();
    }
    const bf16* const* p = t8s ? a.att[l] : a.enc5;
    const int w = t8s ? D : C3, H = t8s ? a.H8 : a.H5, rows = t8s ? n8 : n, ld = w + 8;
    const LayerParts lp = t8s ? lo.l8 : lo.l5;
    bf16* X = t8s ? X8 : H3 + ld3;
    ab.kr = min(staged_keys(t8s ? T4 / 2 : T4), lo.kr);
    ab.lds = ab.kr + 8;
    ab.ldh = w / H + 8;
    stage_layer_vec(vec, p, w);
    const RowBufs bufs = {X, at(sm, lp.a), at(sm, lp.q), at(sm, lp.k), at(sm, lp.v),
                          at(sm, lp.k), ld, 2 * w + 8};
    layer_rows<kMaxD>(cl, ring, bufs, ab, vec, p,
                      t8s ? a.pe8 + (long long)(r0 / 2) * D : a.pe4 + (long long)r0 * C3,
                      a.neg + (long long)b * L, (long long)b * H, rows, t8s ? T4 / 2 : T4, w, H,
                      L, t8s ? t8 : tc, t8s ? a.scale8 : a.scale5, X, ld);
    __syncthreads();
  }

  // skip_conv3(h3) + the nearest upsample of x8 -> dec3's input rows 1..n.
  push_halo(cl, H3, ld3, n, tc, C3, c, C);
  for (int i = threadIdx.x; i < (D >> 3); i += kT)
    *reinterpret_cast<uint4*>(vec + 8 * i) = *reinterpret_cast<const uint4*>(a.sk3b + 8 * i);
  cl.sync();
  bf16* XD = at(sm, lo.d3.xin);
  gemm16<true>(ring, H3, ld3, n, D, 3 * C3, [&](int t, int col, float v0, float v1) {
    const bf16* u = X8 + (t >> 1) * ldd + col;  // r0 is even: x8's row (r0 + t) / 2
    const bf16 y0 = rn(v0 + bf(vec[col])), y1 = rn(v1 + bf(vec[col + 1]));
    st2(XD + (t + 1) * ldd + col, rn(bf(u[0]) + bf(y0)), rn(bf(u[1]) + bf(y1)));
  }, C3);
  __syncthreads();
  push_halo(cl, XD, ldd, n, tc, D, c, C);
  cl.sync();
  conv_block(cl, ring, sm, lo.d3, a.dec3, vec, n, tc, c, C, D, C3,
             a.out + ((long long)b * T4 + r0) * C3, C3);
}

// Launches (B > 0) or asks how many clusters fit at once (B == 0, into *n).
cudaError_t run(const Args& a, const Layout& lo, int B, cudaStream_t stream, int* n) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(unet_t4_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
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
  if (B == 0) return cudaOccupancyMaxActiveClusters(n, unet_t4_kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, unet_t4_kernel, a);
}

}  // namespace

extern "C" {

// The launch shape of one row: CTAs in its cluster, rows a CTA (even, at
// most 64), keys staged at once, shared memory of a CTA (bytes). t4_layout in fused_bottleneck.py
// mirrors it.
long long dhg_unet_t4_cluster(int T4, int C2, int C3, int D, int H5, int H8) {
  return layout(T4, C2, C3, D, H5, H8).C;
}
long long dhg_unet_t4_rows(int T4, int C2, int C3, int D, int H5, int H8) {
  return layout(T4, C2, C3, D, H5, H8).tc;
}
long long dhg_unet_t4_keys(int T4, int C2, int C3, int D, int H5, int H8) {
  return layout(T4, C2, C3, D, H5, H8).kr;
}
long long dhg_unet_t4_smem_bytes(int T4, int C2, int C3, int D, int H5, int H8) {
  return layout(T4, C2, C3, D, H5, H8).total;
}

// Weight tiles of the whole region (DiffusionModel.t4_tiles).
long long dhg_unet_t4_tiles(int C2, int C3, int D, int nlayers) {
  return t4_tiles(C2, C3, D, nlayers);
}

// How many clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
int dhg_unet_t4_max_clusters(int T4, int C2, int C3, int D, int H5, int H8, int L) {
  if (!valid(1, T4, C2, C3, D, H5, H8, L, 1)) return -1;
  Args a = {};
  int n = -1;
  return run(a, layout(T4, C2, C3, D, H5, H8), 0, 0, &n) == cudaSuccess ? n : -1;
}

// The whole T/4..T/8 region over a cluster of CTAs per batch row. `ops`
// holds the operands in dhg's order: x, neg, pe4, pe8, att_w, att_b,
// skip3_w, skip3_b, then PER_CONV enc4 operands, PER_LAYER enc5 operands,
// PER_CONV dec3 operands and PER_LAYER for each of the nlayers attention
// layers (the weights among them are not read: wt holds them as `tiles`
// tiles). Returns cudaGetLastError() after the launch.
int dhg_fused_unet_t4(const void* const* ops, int nlayers, const void* wt, int tiles, void* out,
                      int B, int T4, int C2, int C3, int D, int H5, int H8, int L,
                      void* stream) {
  if (!valid(B, T4, C2, C3, D, H5, H8, L, nlayers) ||
      tiles != t4_tiles(C2, C3, D, nlayers))
    return (int)cudaErrorInvalidValue;
  const Layout lo = layout(T4, C2, C3, D, H5, H8);
  auto op = [&](int i) { return static_cast<const bf16*>(ops[i]); };
  Args a = {};
  a.x = op(0); a.neg = op(1); a.pe4 = op(2); a.pe8 = op(3); a.ab = op(5); a.sk3b = op(7);
  int k = 8;
  for (int i = 0; i < PER_CONV; ++i) a.enc4[i] = op(k++);
  for (int i = 0; i < PER_LAYER; ++i) a.enc5[i] = op(k++);
  for (int i = 0; i < PER_CONV; ++i) a.dec3[i] = op(k++);
  for (int l = 0; l < nlayers; ++l)
    for (int i = 0; i < PER_LAYER; ++i) a.att[l][i] = op(k++);
  a.wt = static_cast<const bf16*>(wt);
  a.out = static_cast<bf16*>(out);
  a.tiles = tiles;
  a.T4 = T4; a.C2 = C2; a.C3 = C3; a.D = D; a.H5 = H5; a.H8 = H8; a.L = L;
  a.nlayers = nlayers; a.C = lo.C; a.tc = lo.tc; a.kr = lo.kr;
  a.scale5 = (float)(1.0 / sqrt((double)(C3 / H5)));
  a.scale8 = (float)(1.0 / sqrt((double)(D / H8)));
  const cudaError_t e = run(a, lo, B, static_cast<cudaStream_t>(stream), nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
