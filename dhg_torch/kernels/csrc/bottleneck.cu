// Hand-written Hopper (sm_90a) kernel: the sampler's attention bottleneck.
//
// Replaces dhg/kernels/fused_bottleneck.py::fused_bottleneck: att_dense
// [T, Cin] -> [T, D], then `nlayers` EncoderLayer.attend, per batch row, at
// the rounding points of dhg's `_encoder_layer` (listed in encoder_layer.cu):
// every Dense is a bf16 product with f32 accumulation rounded once, then
// `+ bias` in bf16; logits are rounded to bf16, `* bf16(1/sqrt(hd))`, then
// `+ mask bias`; the softmax runs in f32 and its weights are rounded to bf16;
// P V accumulates in f32 and rounds once; LayerNorm statistics are f32; SiLU
// is f32; every FiLM multiply and add rounds in bf16.
//
// Design: one batch row is split over a thread-block cluster of C = H CTAs
// (6 for the canonical model; at most 8, the portable cluster size), launched
// with cudaLaunchKernelEx and a cluster-dimension attribute. CTA h computes
// columns [h hd, (h + 1) hd) of every D-wide Dense and [2h hd, 2(h + 1) hd)
// of fc1; for wq/wk/wv those columns are exactly head h, so both attentions
// of head h run inside CTA h with no exchange. A row that fits (at D 384,
// T up to 73: prompts up to 36 tokens) stays in shared memory and goes
// through no global workspace:
//   * A  [T, D]     the A operand of the next Dense (x + PE, x2, SiLU(x3)),
//                   filled by all CTAs: each writes its column slice into its
//                   own copy, then copies it into its peers' copies with
//                   16-byte distributed-shared-memory stores, then a cluster
//                   barrier;
//   * Xh [T, hd]    this CTA's slice of the running activation (residuals);
//   * R             the attention output ATT [T, D] (gathered like A) with
//                   this head's Q, K, V; or the gathered FFN hidden [T, 2D]
//                   (fc2 gathers its K dimension: each CTA holds the whole
//                   hidden and computes its hd output columns, so fc2 rounds
//                   once, as dhg does); or x_in [T, Cin] for att_dense;
//   * Oh [T, hd]    this CTA's columns of a Dense before its LayerNorm;
//   * stats         per-row LayerNorm partial sums from every CTA: each CTA
//                   sums its hd columns, writes (sum, sum of squares) into
//                   every peer, a cluster barrier, then each CTA normalises
//                   its own columns and broadcasts them;
//   * this layer's bias and FiLM slices and the mask bias, staged once so
//                   that epilogues read no global memory;
//   * a ring of kStages weight tiles [64 rows, 64 k], each filled by one
//                   bulk copy of the tensor memory accelerator that
//                   completes on the slot's mbarrier. Each CTA streams only
//                   its [hd, K] slice of each matrix, from a copy of the
//                   weights the wrapper tiles once per weight set (dense
//                   8 KB tiles in schedule order, 16-byte chunks swizzled by
//                   row for conflict-free ldmatrix); the ring walks one
//                   schedule of all the kernel's products, so the next
//                   product's first tiles are in flight during the current
//                   epilogue, attention and cluster barriers.
// Products are mma.sync m16n8k16 (bf16 -> f32) with ldmatrix fragments; a
// warp owns 16 rows x 32 columns of a 64-column chunk (two row tiles when
// T > 64). The ring and the product loop live in tile_ring.cuh, shared with
// encoder_layer.cu. An attention head keeps its [16, keys] logits in registers.
//
// Shared memory per CTA (bytes, each part rounded up to 128):
//   2 T (hd + 8) [Xh] + 2 T (D + 8) [A]
//   + max(2 T (D + 8) + 2 T (hd + 8) + 4 KP (hd + 8), 2 T (2D + 8), 2 T (Cin + 8)) [R]
//   + 2 T (hd + 8) [Oh] + 8 H T [stats] + 8 T [mu, rstd]
//   + 16 kStages [full and empty mbarriers] + 32 hd [vectors] + 2 L [mask]
//   + 8,192 kStages [ring],
// KP = 64 if max(T, L) <= 64, else 128. Canonical (T 49, Cin 256, D 384,
// H 6, L 50): 7,168 + 38,528 + 76,160 + 7,168 + 2,432 + 512 + 128 + 2,048
// + 128 + 32,768 = 167,040 of 232,448; at D 384 rows fit up to T = 73.
//
// A longer row (T or L over 128, or more than 232,448 bytes above: at D 384
// from T = 74, a 37-token prompt, up to the 101 of a 50-token one) spills:
// the same kernel, with A, A2 = x2 + PE (Q2 and K2's operand) and R in a
// global workspace of 4 T D bf16 a row that the wrapper allocates. Each CTA
// writes its column slices there once instead of into its peers, and the
// products load their A fragments from L2 (ld.global.cg, issued before the
// weight tile is waited for) instead of by ldmatrix. Shared memory keeps
// Xh, Q (which shares Oh's space), K and V of KP = 128 or 256 rows, and the
// parts after Oh above: 2 (2 T + 2 KP) (hd + 8) + 8 H T + 8 T + ... + ring,
// 106,880 bytes at T = 101 and 196,864 at T = 256 (D 384, H 6, L 50).
// Limits: T, L <= 256; hd <= 128; at most 8 heads.
//
// What bounds it on an H100: at batch 96-256 the work is ~314 MFLOP a row
// (bf16 tensor-core bound, 989 TFLOP/s); at batch 1 it is the ~6.3 MB of
// weights (3.35 TB/s). Every cluster reads the whole weight set from L2 once
// per row (1 MB per CTA at the canonical shape), so at large batch the L2 to
// SM traffic, not HBM, is what this design pays. One CTA fits an SM, so the
// card holds 17 such clusters at once (cudaOccupancyMaxActiveClusters) and
// a row's latency sets the time at every batch: batch 96 is 6 waves. That
// latency is the 124 weight tiles of a CTA (each 64-deep tile loaded and
// multiplied by 8 warps, of whose 64 rows only 49 are real at T = 49), the
// 19 cluster barriers of a 2-layer row, and the attention on 4 of 8 warps.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace wmma16;
using namespace tile_ring;

constexpr int kMaxLayers = 8;
constexpr int kMaxHeads = 8;   // portable cluster size
constexpr int kMaxHeld = 128;  // T and L of a row held in shared memory
constexpr int kMaxRows = 256;  // T and L of a spilled row
constexpr int kMaxSmem = 232448;

// Per-layer operand order, as in dhg's _PER_LAYER list (row_layer.cuh).
enum { KH, VH, WQ, BQ, WO, BO, WQ2, BQ2, WK2, BK2, WV2, BV2, WO2, BO2,
       W1, B1, W2, B2, G1, BE1, G2, BE2, G3, BE3, PER_LAYER };

struct Args {
  const bf16* x;    // [B, T, Cin]
  const bf16* ab;   // att_dense bias [D]
  const bf16* pe;   // [T, D]
  const bf16* neg;  // [B, 1, L] additive mask bias (mask * -1e9)
  bf16* out;        // [B, T, D]
  bf16* ws;         // [B, 4 T D] for a spilled row (A, A2 [T, D]; R [T, 2D]), else null
  const bf16* wt;   // [H, tiles, 64, 64]: each CTA's weight tiles in schedule order
  int tiles;        // tiles per CTA
  int T, Cin, D, H, L, nlayers;
  float scale;      // 1 / sqrt(D / H), rounded to bf16 in the kernel
  const bf16* p[kMaxLayers][PER_LAYER];
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline long long up128(long long v) { return (v + 127) & ~127LL; }
__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }

// Byte offsets of the shared-memory parts (see the note at the top); a
// spilled row also needs `ws` elements of global workspace.
struct Layout {
  bool spill;
  int ldh, lda, ldf, ldi, kp;
  long long xh, a, r, qh, kh, vh, oh, st, mr, bar, vec, neg, ring, total, ws;
};

// Per-layer vector slots (hd elements each; fc1's bias takes two).
enum { V_BQ, V_BO, V_BQ2, V_BK2, V_BV2, V_BO2, V_B2, V_G1, V_BE1, V_G2, V_BE2, V_G3, V_BE3,
       V_AB, V_B1, V_SLOTS = V_B1 + 2 };

// The parts after the attention operands, from offset o.st on.
__host__ __device__ inline void layout_tail(Layout& o, int T, int H, int L, int hd) {
  o.mr = o.st + up128(8LL * H * T);
  o.bar = o.mr + up128(8LL * T);
  o.vec = o.bar + up128(16LL * kStages);
  o.neg = o.vec + up128(2LL * V_SLOTS * hd);
  o.ring = o.neg + up128(2LL * L);
  o.total = o.ring + 2LL * kStages * kTileElems;
}

// A row is held in shared memory where it fits; else it spills: shared
// memory keeps this CTA's slices (Xh, Q = Oh, K, V) and the gathered A,
// A2 = x2 + PE and R go to the row's global workspace.
__host__ __device__ inline Layout layout(int T, int Cin, int D, int H, int L) {
  Layout o;
  const int hd = D / H, rows = T > L ? T : L;
  o.ldh = hd + 8;
  o.lda = D + 8;
  o.ldf = 2 * D + 8;
  o.ldi = Cin + 8;
  o.kp = rows > 64 ? 128 : 64;  // 16 KB key rows, the attention's register blocks
  const long long att = 2LL * T * o.lda, q = 2LL * T * o.ldh, kv = 2LL * o.kp * o.ldh;
  const long long r = lmax(att + q + 2 * kv, lmax(2LL * T * o.ldf, 2LL * T * o.ldi));
  o.spill = false;
  o.ws = 0;
  o.xh = 0;
  o.a = o.xh + up128(2LL * T * o.ldh);
  o.r = o.a + up128(2LL * T * o.lda);
  o.qh = o.r + att;
  o.kh = o.qh + q;
  o.vh = o.kh + kv;
  o.oh = o.r + up128(r);
  o.st = o.oh + up128(2LL * T * o.ldh);
  layout_tail(o, T, H, L, hd);
  if (rows <= kMaxHeld && o.total <= kMaxSmem) return o;

  o.spill = true;
  o.lda = D;
  o.ldf = 2 * D;
  o.ldi = Cin;
  o.kp = rows > 128 ? 256 : 128;
  o.ws = 4LL * T * D;
  const long long sl = up128(2LL * T * o.ldh), kvs = up128(2LL * o.kp * o.ldh);
  o.a = o.r = 0;  // in the workspace
  o.xh = 0;
  o.qh = o.oh = sl;
  o.kh = 2 * sl;
  o.vh = o.kh + kvs;
  o.st = o.vh + kvs;
  layout_tail(o, T, H, L, hd);
  return o;
}

// Weight tiles a CTA streams: att_dense, then per layer wq, wo, wv2, wq2,
// wk2, wo2 (hd output columns each, K = D), fc1 (2 hd, K = D), fc2 (hd, 2D).
inline int tiles_per_cta(int Cin, int D, int H, int nlayers) {
  const int hd = D / H;
  auto n = [](int rows, int k) { return ((rows + 63) / 64) * ((k + 63) / 64); };
  return n(hd, Cin) + nlayers * (6 * n(hd, D) + n(2 * hd, D) + n(hd, 2 * D));
}


// Copies rows [0, T) x columns [c0, c0 + w) of buf (row stride ld) from
// this CTA (rank h) to the same place in every other CTA of the cluster, 16
// bytes a store. Callers sync the block before and the cluster after.
__device__ __forceinline__ void broadcast(cg::cluster_group& cl, int C, int h, bf16* buf, int ld,
                                          int T, int c0, int w) {
  const int cpr = w >> 3;
  for (int j = threadIdx.x; j < T * cpr; j += kThreads) {
    const int r = j / cpr;
    bf16* src = buf + r * ld + c0 + ((j - r * cpr) << 3);
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    for (int p = 0; p < C; ++p)
      if (p != h) *reinterpret_cast<uint4*>(cl.map_shared_rank(src, p)) = v;
  }
}



// One head: O = softmax(bf16(Q K^T) * scale (+ neg)) V over `nkeys` keys;
// Q [T, hd], K/V [round16(nkeys), hd] (pad rows zero) at row stride ldh,
// neg in shared memory or null. Row t of O goes to att[t * lda + col0 ..].
// FULL: hd == HDM, so every head-dim step and every key block (16 KB keys,
// the pad rows zero) runs unguarded; else both are bounded at run time.
template <int HDM, int KB, bool FULL>
__device__ __forceinline__ void attend(const bf16* Q, const bf16* K, const bf16* V, int ldh, int T,
                                       int nkeys, int hd, const bf16* neg, bf16 scale, bf16* att,
                                       int lda, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int dk = FULL ? HDM / 16 : hd >> 4, nkb = FULL ? KB : round16(nkeys) >> 4;
  constexpr int kKB = KB;  // key blocks of 16 held in registers
  const float sc = bf(scale);
  for (int mt = warp; mt * 16 < T; mt += kWarps) {
    const int m0 = mt * 16;
    uint32_t qf[HDM / 16][4];
#pragma unroll
    for (int kk = 0; kk < HDM / 16; ++kk)
      if (kk < dk) load_a(qf[kk], Q, ldh, m0, kk * 16, T);
    float s[kKB][2][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kb][j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HDM / 16; ++kk) {
          if (kk < dk) {
            uint32_t b[4];
            load_b_nk(b, K, ldh, kb * 16, kk * 16);
            mma(s[kb][0], qf[kk], b[0], b[1]);
            mma(s[kb][1], qf[kk], b[2], b[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb * 16 + j * 8 + 2 * tg + (e & 1);
            float lg = -INFINITY;
            if (key < nkeys) {
              lg = bf(rn(bf(rn(s[kb][j][e])) * sc));
              if (neg) lg = bf(rn(lg + bf(neg[key])));
            }
            s[kb][j][e] = lg;
            mx[e >> 1] = fmaxf(mx[e >> 1], lg);
          }
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb)
      if (kb < nkb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[kb][j][e] = expf(s[kb][j][e] - mx[e >> 1]);
            sum[e >> 1] += s[kb][j][e];
          }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    float o[HDM / 8][4];
#pragma unroll
    for (int j = 0; j < HDM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
      if (kb < nkb) {
        const uint32_t a[4] = {pack(s[kb][0][0] / sum[0], s[kb][0][1] / sum[0]),
                               pack(s[kb][0][2] / sum[1], s[kb][0][3] / sum[1]),
                               pack(s[kb][1][0] / sum[0], s[kb][1][1] / sum[0]),
                               pack(s[kb][1][2] / sum[1], s[kb][1][3] / sum[1])};
#pragma unroll
        for (int dd = 0; dd < HDM / 16; ++dd) {
          if (dd < dk) {
            uint32_t b[4];
            load_b_kn(b, V, ldh, dd * 16, kb * 16);
            mma(o[2 * dd], a, b[0], b[1]);
            mma(o[2 * dd + 1], a, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < HDM / 8; ++j) {
      if (j < 2 * dk) {
        const int c = col0 + j * 8 + 2 * tg, r0 = m0 + g;
        if (r0 < T) st2(att + r0 * lda + c, rn(o[j][0]), rn(o[j][1]));
        if (r0 + 8 < T) st2(att + (r0 + 8) * lda + c, rn(o[j][2]), rn(o[j][3]));
      }
    }
  }
}

// LayerNorm over the full row D of v(t, c), split over the cluster: this
// CTA owns columns c < hd (global column h hd + c). A quad of threads sums
// each row's hd columns; the partial sums go to every CTA's stats[h][t],
// then a cluster barrier; one thread a row turns the C partials into
// (mu, rstd) in mr[t]; then every thread calls put(t, c, y0, y1) with
// y = bf16(LN(v)) on its (row, column pair) items.
template <class V, class Put>
__device__ __forceinline__ void layer_norm(cg::cluster_group& cl, int C, int h, float* stats,
                                           float2* mr, int T, int D, int hd, V v, Put put) {
  const int q = threadIdx.x & 3, seg = hd >> 2;  // seg: columns per quad thread (even)
  for (int t0 = 0; t0 < T; t0 += kThreads / 4) {
    const int t = t0 + (threadIdx.x >> 2);
    float s = 0.f, s2 = 0.f;
    if (t < T) {
      for (int c = q * seg; c < (q + 1) * seg; c += 2) {
        const float a0 = v(t, c), a1 = v(t, c + 1);
        s += a0 + a1;
        s2 += a0 * a0 + a1 * a1;
      }
    }
    s = quad_sum(s);
    s2 = quad_sum(s2);
    if (t < T)
      for (int p = q; p < C; p += 4)
        *cl.map_shared_rank(reinterpret_cast<float2*>(stats) + h * T + t, p) = make_float2(s, s2);
  }
  cl.sync();
  const float2* st = reinterpret_cast<const float2*>(stats);
  for (int t = threadIdx.x; t < T; t += kThreads) {
    float s = 0.f, s2 = 0.f;
    for (int j = 0; j < C; ++j) {
      const float2 p = st[j * T + t];
      s += p.x;
      s2 += p.y;
    }
    const float mu = s / D;
    mr[t] = make_float2(mu, rsqrtf(fmaxf(0.f, s2 / D - mu * mu) + 1e-6f));
  }
  __syncthreads();
  const int pairs = hd >> 1;
  for (int i = threadIdx.x; i < T * pairs; i += kThreads) {
    const int t = i / pairs, c = (i - t * pairs) << 1;
    const float2 m = mr[t];
    put(t, c, rn((v(t, c) - m.x) * m.y), rn((v(t, c + 1) - m.x) * m.y));
  }
}


// The operand behind a per-layer vector slot (not V_AB or V_B1).
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

// HDM >= hd and 16 KB >= max(T, L) size the attention's register arrays.
// SPILL: the row's gathered operands live in its global workspace (layout).
template <int HDM, int KB, bool SPILL>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = a.H, h = (int)cl.block_rank(), b = blockIdx.y;
  const int T = a.T, D = a.D, L = a.L, hd = D / C;
  const Layout lo = layout(T, a.Cin, D, C, L);
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* ws = SPILL ? a.ws + b * lo.ws : nullptr;
  bf16* Xh = reinterpret_cast<bf16*>(sm + lo.xh);
  bf16* A = SPILL ? ws : reinterpret_cast<bf16*>(sm + lo.a);
  bf16* A2 = SPILL ? ws + (long long)T * D : A;  // Q2 and K2's operand, x2 + PE
  bf16* R = SPILL ? ws + 2LL * T * D : reinterpret_cast<bf16*>(sm + lo.r);  // ATT, HF or x_in
  const bf16* xin = SPILL ? a.x + (long long)b * T * a.Cin : R;
  bf16* Qh = reinterpret_cast<bf16*>(sm + lo.qh);
  bf16* Kh = reinterpret_cast<bf16*>(sm + lo.kh);
  bf16* Vh = reinterpret_cast<bf16*>(sm + lo.vh);
  bf16* Oh = reinterpret_cast<bf16*>(sm + lo.oh);
  float* stats = reinterpret_cast<float*>(sm + lo.st);
  float2* mr = reinterpret_cast<float2*>(sm + lo.mr);
  bf16* vec = reinterpret_cast<bf16*>(sm + lo.vec);
  bf16* negs = reinterpret_cast<bf16*>(sm + lo.neg);
  const int ldh = lo.ldh, lda = lo.lda, ldf = lo.ldf, col0 = h * hd, cpv = hd >> 3;
  const bf16 scale = rn(a.scale);
  const bf16* pe = a.pe;
  constexpr int MI = KB / 4;  // row tiles of 16 per warp: T <= 64 MI
  auto sv = [&](int slot, int c) { return vec[slot * hd + c]; };

  // x_in -> R with cp.async (a spilled row's att_dense reads it in place).
  if (!SPILL) {
    const bf16* x = a.x + (long long)b * T * a.Cin;
    const int cpr = a.Cin >> 3;
    for (int i = threadIdx.x; i < T * cpr; i += kThreads) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      cp_async16(R + r * lo.ldi + c, x + (long long)r * a.Cin + c);
    }
    cp_async_commit();
  }
  Ring ring;
  ring.src = a.wt + (long long)h * a.tiles * kTileElems;
  ring.base = reinterpret_cast<bf16*>(sm + lo.ring);
  ring.full = reinterpret_cast<uint64_t*>(sm + lo.bar);
  ring.tiles = a.tiles;
  ring.issued = ring.consumed = 0;
  ring.empty = ring.full + kStages;
  if (threadIdx.x < kStages) {
    mbar_init(ring.full + threadIdx.x, 1);
    mbar_init(ring.empty + threadIdx.x, kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = threadIdx.x; i < L; i += kThreads) negs[i] = a.neg[(long long)b * L + i];
  for (int i = threadIdx.x; i < cpv; i += kThreads)
    *reinterpret_cast<uint4*>(vec + V_AB * hd + 8 * i) =
        *reinterpret_cast<const uint4*>(a.ab + col0 + 8 * i);
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) ring.issue();
  cp_async_wait<0>();  // x_in, then a barrier publishes every thread's copies
  __syncthreads();

  // Makes this CTA's columns [c0, c0 + w) of buf visible to the cluster:
  // a held row copies them into every peer's copy, a spilled row's buffer
  // is shared; then a cluster barrier.
  auto publish = [&](bf16* buf, int ld, int c0, int w) {
    __syncthreads();
    if (!SPILL) broadcast(cl, C, h, buf, ld, T, c0, w);
    cl.sync();
  };

  // att_dense: Xh = x_in W^T + b; every CTA's A gets x + PE.
  gemm<MI, SPILL>(ring, xin, lo.ldi, T, hd, a.Cin, [&](int t, int c, float v0, float v1) {
    const bf16 y0 = dense_rn(v0, sv(V_AB, c)), y1 = dense_rn(v1, sv(V_AB, c + 1));
    st2(Xh + t * ldh + c, y0, y1);
    const bf16* p = pe + t * D + col0 + c;
    st2(A + t * lda + col0 + c, rn(bf(y0) + bf(p[0])), rn(bf(y1) + bf(p[1])));
  });
  publish(A, lda, col0, hd);

  for (int l = 0; l < a.nlayers; ++l) {
    const bf16* const* w = a.p[l];
    const bool last = l == a.nlayers - 1;
    // This head's text K/V [L, hd] (pad rows zero), and this layer's bias
    // and FiLM slices.
    {
      const long long off = ((long long)b * C + h) * L * hd;
      const int lp = lo.kp;
      for (int i = threadIdx.x; i < lp * cpv; i += kThreads) {
        const int r = i / cpv, c = (i - r * cpv) << 3;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (r < L) {
          kv = *reinterpret_cast<const uint4*>(w[KH] + off + r * hd + c);
          vv = *reinterpret_cast<const uint4*>(w[VH] + off + r * hd + c);
        }
        *reinterpret_cast<uint4*>(Kh + r * ldh + c) = kv;
        *reinterpret_cast<uint4*>(Vh + r * ldh + c) = vv;
      }
      for (int i = threadIdx.x; i < (V_AB + 2) * cpv; i += kThreads) {
        const int s = i / cpv, c = (i - s * cpv) << 3;
        const bf16* src = s < V_AB ? w[slot_operand(s)] + col0 + c
                                   : w[B1] + 2 * col0 + (s - V_AB) * hd + c;
        *reinterpret_cast<uint4*>(vec + (s < V_AB ? s : s + 1) * hd + c) =
            *reinterpret_cast<const uint4*>(src);
      }
      __syncthreads();
    }
    // Cross-attention: Q = (x + PE) wq, head h against the text.
    gemm<MI, SPILL>(ring, A, lda, T, hd, D, [&](int t, int c, float v0, float v1) {
      st2(Qh + t * ldh + c, dense_rn(v0, sv(V_BQ, c)), dense_rn(v1, sv(V_BQ, c + 1)));
    });
    __syncthreads();
    if (hd == HDM) attend<HDM, KB, true>(Qh, Kh, Vh, ldh, T, L, hd, negs, scale, R, lda, col0);
    else attend<HDM, KB, false>(Qh, Kh, Vh, ldh, T, L, hd, negs, scale, R, lda, col0);
    publish(R, lda, col0, hd);
    gemm<MI, SPILL>(ring, R, lda, T, hd, D, [&](int t, int c, float v0, float v1) {
      st2(Oh + t * ldh + c, dense_rn(v0, sv(V_BO, c)), dense_rn(v1, sv(V_BO, c + 1)));
    });
    __syncthreads();
    // x2 = film(LN(o)) + x; every CTA's A gets x2 (wv2's operand); a
    // spilled row's A2 gets x2 + PE here (a held row adds PE to A below).
    layer_norm(cl, C, h, stats, mr, T, D, hd, [&](int t, int c) { return bf(Oh[t * ldh + c]); },
               [&](int t, int c, bf16 y0, bf16 y1) {
                 bf16* x = Xh + t * ldh + c;
                 const bf16 x0 = rn(film(y0, sv(V_G1, c), sv(V_BE1, c)) + bf(x[0]));
                 const bf16 x1 = rn(film(y1, sv(V_G1, c + 1), sv(V_BE1, c + 1)) + bf(x[1]));
                 st2(x, x0, x1);
                 st2(A + t * lda + col0 + c, x0, x1);
                 if (SPILL) {
                   const bf16* p = pe + t * D + col0 + c;
                   st2(A2 + t * lda + col0 + c, rn(bf(x0) + bf(p[0])), rn(bf(x1) + bf(p[1])));
                 }
               });
    publish(A, lda, col0, hd);

    // Self-attention: V = x2 wv2, then Q = K = x2 + PE.
    gemm<MI, SPILL>(ring, A, lda, T, hd, D, [&](int t, int c, float v0, float v1) {
      st2(Vh + t * ldh + c, dense_rn(v0, sv(V_BV2, c)), dense_rn(v1, sv(V_BV2, c + 1)));
    });
    __syncthreads();
    if (!SPILL) {
#pragma unroll 4
      for (int i = threadIdx.x; i < T * (D >> 3); i += kThreads) {
        const int t = i / (D >> 3), c = (i - t * (D >> 3)) << 3;
        uint4 xv = *reinterpret_cast<const uint4*>(A + t * lda + c);
        const uint4 pv = *reinterpret_cast<const uint4*>(pe + t * D + c);
        bf16* x8 = reinterpret_cast<bf16*>(&xv);
        const bf16* p8 = reinterpret_cast<const bf16*>(&pv);
#pragma unroll
        for (int k = 0; k < 8; ++k) x8[k] = rn(bf(x8[k]) + bf(p8[k]));
        *reinterpret_cast<uint4*>(A + t * lda + c) = xv;
      }
    }
    for (int i = threadIdx.x; i < (lo.kp - T) * hd; i += kThreads) {
      const int r = T + i / hd, c = i % hd;
      Kh[r * ldh + c] = Vh[r * ldh + c] = rn(0.f);
    }
    __syncthreads();
    gemm<MI, SPILL>(ring, A2, lda, T, hd, D, [&](int t, int c, float v0, float v1) {
      st2(Qh + t * ldh + c, dense_rn(v0, sv(V_BQ2, c)), dense_rn(v1, sv(V_BQ2, c + 1)));
    });
    gemm<MI, SPILL>(ring, A2, lda, T, hd, D, [&](int t, int c, float v0, float v1) {
      st2(Kh + t * ldh + c, dense_rn(v0, sv(V_BK2, c)), dense_rn(v1, sv(V_BK2, c + 1)));
    });
    __syncthreads();
    if (hd == HDM) attend<HDM, KB, true>(Qh, Kh, Vh, ldh, T, T, hd, nullptr, scale, R, lda, col0);
    else attend<HDM, KB, false>(Qh, Kh, Vh, ldh, T, T, hd, nullptr, scale, R, lda, col0);
    publish(R, lda, col0, hd);
    gemm<MI, SPILL>(ring, R, lda, T, hd, D, [&](int t, int c, float v0, float v1) {
      st2(Oh + t * ldh + c, dense_rn(v0, sv(V_BO2, c)), dense_rn(v1, sv(V_BO2, c + 1)));
    });
    __syncthreads();
    // x3 = film(LN(x2 + o)); every CTA's A gets SiLU(x3) (fc1's operand).
    layer_norm(cl, C, h, stats, mr, T, D, hd,
               [&](int t, int c) { return bf(rn(bf(Xh[t * ldh + c]) + bf(Oh[t * ldh + c]))); },
               [&](int t, int c, bf16 y0, bf16 y1) {
                 const bf16 x0 = rn(film(y0, sv(V_G2, c), sv(V_BE2, c)));
                 const bf16 x1 = rn(film(y1, sv(V_G2, c + 1), sv(V_BE2, c + 1)));
                 st2(Xh + t * ldh + c, x0, x1);
                 st2(A + t * lda + col0 + c, rn(silu(bf(x0))), rn(silu(bf(x1))));
               });
    publish(A, lda, col0, hd);

    // FFN: SiLU(fc1) gathered in R, then fc2 over the whole hidden.
    const int hcol = 2 * col0;
    gemm<MI, SPILL>(ring, A, lda, T, 2 * hd, D, [&](int t, int c, float v0, float v1) {
      const bf16 y0 = dense_rn(v0, sv(V_B1, c)), y1 = dense_rn(v1, sv(V_B1, c + 1));
      st2(R + t * ldf + hcol + c, rn(silu(bf(y0))), rn(silu(bf(y1))));
    });
    publish(R, ldf, hcol, 2 * hd);
    gemm<MI, SPILL>(ring, R, ldf, T, hd, 2 * D, [&](int t, int c, float v0, float v1) {
      st2(Oh + t * ldh + c, dense_rn(v0, sv(V_B2, c)), dense_rn(v1, sv(V_B2, c + 1)));
    });
    __syncthreads();
    // out = film(LN(x3 + o)): the next layer's x (its A gets x + PE), or the result.
    bf16* out = a.out + (long long)b * T * D + col0;
    layer_norm(cl, C, h, stats, mr, T, D, hd,
               [&](int t, int c) { return bf(rn(bf(Xh[t * ldh + c]) + bf(Oh[t * ldh + c]))); },
               [&](int t, int c, bf16 y0, bf16 y1) {
                 const bf16 x0 = rn(film(y0, sv(V_G3, c), sv(V_BE3, c)));
                 const bf16 x1 = rn(film(y1, sv(V_G3, c + 1), sv(V_BE3, c + 1)));
                 if (last) {
                   st2(out + (long long)t * D + c, x0, x1);
                 } else {
                   st2(Xh + t * ldh + c, x0, x1);
                   const bf16* p = pe + t * D + col0 + c;
                   st2(A + t * lda + col0 + c, rn(bf(x0) + bf(p[0])), rn(bf(x1) + bf(p[1])));
                 }
               });
    if (!last) {
      publish(A, lda, col0, hd);
    }
  }
}

template <int HDM, int KB, bool SPILL>
cudaError_t configure(const Args& a, int B, cudaStream_t stream, long long bytes,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(bottleneck_kernel<HDM, KB, SPILL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cfg = {};
  cfg.gridDim = dim3(a.H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Launches (B > 0) or asks how many clusters fit at once (B == 0, into *n),
// with the instantiation the shape needs.
template <int HDM, int KB, bool SPILL>
cudaError_t run(const Args& a, int B, cudaStream_t s, long long bytes, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<HDM, KB, SPILL>(a, B > 0 ? B : 1, s, bytes, cfg, attr);
  if (e != cudaSuccess) return e;
  if (B == 0) return cudaOccupancyMaxActiveClusters(n, bottleneck_kernel<HDM, KB, SPILL>, &cfg);
  return cudaLaunchKernelEx(&cfg, bottleneck_kernel<HDM, KB, SPILL>, a);
}

template <int HDM>
cudaError_t dispatch_hd(const Args& a, const Layout& lo, int B, cudaStream_t s, int* n) {
  if (!lo.spill)
    return lo.kp == 64 ? run<HDM, 4, false>(a, B, s, lo.total, n)
                       : run<HDM, 8, false>(a, B, s, lo.total, n);
  return lo.kp == 128 ? run<HDM, 8, true>(a, B, s, lo.total, n)
                      : run<HDM, 16, true>(a, B, s, lo.total, n);
}

cudaError_t dispatch(const Args& a, int B, cudaStream_t s, int* n) {
  const Layout lo = layout(a.T, a.Cin, a.D, a.H, a.L);
  if (a.D / a.H > 64) return dispatch_hd<128>(a, lo, B, s, n);
  return dispatch_hd<64>(a, lo, B, s, n);
}

bool valid(int B, int T, int Cin, int D, int H, int L, int nlayers) {
  if (B < 1 || T < 1 || L < 1 || H < 1 || H > kMaxHeads || T > kMaxRows || L > kMaxRows) return false;
  if (nlayers < 1 || nlayers > kMaxLayers || Cin % 16 || D % H) return false;
  const int hd = D / H;
  return hd % 16 == 0 && hd <= 128 && layout(T, Cin, D, H, L).total <= kMaxSmem;
}

}  // namespace

extern "C" {

// Shared memory of one CTA (bytes); the wrapper refuses above 232,448.
long long dhg_bottleneck_smem_bytes(int T, int Cin, int D, int H, int L) {
  return layout(T, Cin, D, H, L).total;
}

// Global workspace of one batch row (bf16 elements): 0 for a row held in
// shared memory, 4 T D for a spilled one.
long long dhg_bottleneck_workspace_elems(int T, int Cin, int D, int H, int L) {
  return layout(T, Cin, D, H, L).ws;
}

// How many H-CTA clusters of this shape the card can hold at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
int dhg_bottleneck_max_clusters(int T, int Cin, int D, int H, int L) {
  if (!valid(1, T, Cin, D, H, L, 1)) return -1;
  Args a = {};
  a.T = T; a.Cin = Cin; a.D = D; a.H = H; a.L = L;
  int n = -1;
  return dispatch(a, 0, 0, &n) == cudaSuccess ? n : -1;
}

// att_dense + nlayers EncoderLayers over a cluster of H CTAs per batch row.
// wt holds every CTA's `tiles` weight tiles (bottleneck_tiles in
// fused_bottleneck.py); ops are the per-layer operands (their weights are
// not read here); ws is B rows of dhg_bottleneck_workspace_elems, or null
// where that is 0. Returns cudaGetLastError() after the launch.
int dhg_fused_bottleneck(const void* x, const void* wt, int tiles, const void* ab, const void* pe,
                         const void* neg, const void* const* ops, int nlayers, void* out, void* ws,
                         int B, int T, int Cin, int D, int H, int L, void* stream) {
  if (!valid(B, T, Cin, D, H, L, nlayers) || tiles != tiles_per_cta(Cin, D, H, nlayers) ||
      (layout(T, Cin, D, H, L).spill && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.wt = static_cast<const bf16*>(wt);
  a.tiles = tiles;
  a.x = static_cast<const bf16*>(x);
  a.ab = static_cast<const bf16*>(ab);
  a.pe = static_cast<const bf16*>(pe);
  a.neg = static_cast<const bf16*>(neg);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<bf16*>(ws);
  a.T = T; a.Cin = Cin; a.D = D; a.H = H; a.L = L; a.nlayers = nlayers;
  a.scale = (float)(1.0 / sqrt((double)(D / H)));
  for (int i = 0; i < nlayers; ++i)
    for (int k = 0; k < PER_LAYER; ++k)
      a.p[i][k] = static_cast<const bf16*>(ops[i * PER_LAYER + k]);
  const cudaError_t e = dispatch(a, B, static_cast<cudaStream_t>(stream), nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
