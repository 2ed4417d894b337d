// The weight ring and tile product of the sampler's cluster kernels
// (bottleneck.cu and encoder_layer.cu): a ring of bf16 weight tiles in shared
// memory, each filled by one bulk copy of the tensor memory accelerator (TMA)
// that completes on the slot's mbarrier (RingT; Ring is bottleneck.cu's 4
// slots of [64, 64]), and `gemm`, bottleneck.cu's mma.sync m16n8k16 product
// of a row block against the ring's tiles for blocks of 256 threads (8
// warps), with dhg's Dense and FiLM rounding helpers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_mma.cuh"

namespace tile_ring {

using namespace wmma16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 64;        // weight rows (output columns) per ring tile
constexpr int kKT = 64;        // reduction depth per ring tile
constexpr int kTileElems = kNT * kKT;  // a dense, swizzled [64, 64] tile
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t pack_bf(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void st2(bf16* p, bf16 lo, bf16 hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf(lo, hi);
}

__device__ __forceinline__ float silu(float v) { return v * (1.0f / (1.0f + expf(-v))); }

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// `bytes` (a multiple of 16) from global src to this CTA's shared dst by the
// tensor memory accelerator, counted against bar's transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  while (!mbar_try_wait(bar, (uint32_t)(phase & 1))) {
  }
}

// The weight ring of S slots of TE elements: every tile this CTA multiplies,
// in schedule order, from the wrapper's tiled copy of the weights (one dense
// tile each, its 16-byte chunks swizzled by row). A slot has two mbarriers:
// `full`, which thread 0 arms with the tile's byte count before one bulk
// copy fills the slot, and `empty`, on which each warp arrives once it has
// read the slot. Thread 0 refills a slot after every warp has left it; no block barrier
// couples the warps tile by tile. All threads call consume/release in step.
template <int TE, int S>
struct RingT {
  const bf16* src;   // this CTA's first tile
  bf16* base;
  uint64_t* full;    // S mbarriers (count 1 + the tile's bytes)
  uint64_t* empty;   // S mbarriers (count: the block's warps)
  int tiles, issued, consumed;

  // Thread 0: the next tile into its slot, once every warp has left the
  // slot's previous tile.
  __device__ __forceinline__ void issue() {
    if (issued >= tiles) return;
    if (threadIdx.x == 0) {
      const int slot = issued % S, fill = issued / S;
      if (fill > 0) mbar_wait(empty + slot, fill - 1);
      mbar_expect_tx(full + slot, TE * 2);
      bulk_copy(base + slot * TE, src + (long long)issued * TE, TE * 2, full + slot);
    }
    ++issued;
  }

  // The next tile in schedule order, once it has landed; the tile S - 1
  // ahead is requested first.
  __device__ __forceinline__ const bf16* consume() {
    issue();
    __syncwarp();
    const int slot = consumed % S;
    mbar_wait(full + slot, consumed / S);
    return base + slot * TE;
  }

  // This warp is done with the tile consume returned.
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + consumed % S);
    ++consumed;
  }
};

// The ring of [64, 64] tiles, kStages deep.
using Ring = RingT<kTileElems, kStages>;

// B fragments of two n8 tiles (n0 .. n0 + 15) x k [k0, k0 + 16) of a ring
// tile: row n holds 64 k in 8 chunks of 8, chunk c stored at c ^ (n & 7),
// so the 8 rows one ldmatrix reads lie in 8 different bank groups.
__device__ __forceinline__ void load_b_tile(uint32_t* b, const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3), c = (k0 >> 3) + ((lane >> 3) & 1);
  ldsm_x4(b, tile + n * kKT + ((c ^ (n & 7)) << 3));
}

// A fragment (rows g / g + 8 at r0 / r1, columns k .. k + 15) straight from
// global memory, cached in L2 only: a spilled row's operands are written by
// the cluster's other CTAs.
__device__ __forceinline__ void load_a_global(uint32_t* a, const bf16* r0, const bf16* r1, int k) {
  a[0] = __ldcg(reinterpret_cast<const unsigned int*>(r0 + k));
  a[1] = __ldcg(reinterpret_cast<const unsigned int*>(r1 + k));
  a[2] = __ldcg(reinterpret_cast<const unsigned int*>(r0 + k + 8));
  a[3] = __ldcg(reinterpret_cast<const unsigned int*>(r1 + k + 8));
}

// out[t, n] = sum_k A[t, k] W[n, k] for t < T, n < N (this CTA's slice of
// the ring's current product), handed to epi(t, n, v(t, n), v(t, n + 1)) for
// even n, in chunks of 64 columns. MI row tiles of 16 per warp (T <= 64 MI);
// a warp skips its tiles at or past T. Rows of a ring tile past N are zero
// and rows of A past T read row T - 1, so a whole 64-deep tile runs
// unguarded: its 12 ldmatrix first, then its 16 mma (per warp, per row
// tile), with the addresses worked out once per product. GA: A is in global
// memory (a spilled row); its fragments are loaded before the weight tile
// is waited for.
template <int MI, bool GA, class Epi>
__device__ __forceinline__ void gemm(Ring& ring, const bf16* A, int lda, int T, int N, int K,
                                     Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3, wm = warp & 3, wn = warp >> 2;
  const int nk = (K + kKT - 1) / kKT;
  const bf16* arow[MI];  // ldmatrix row address, or (GA) row g's fragment address
  const bf16* arow8[MI];  // GA: row g + 8's
  bool live[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m0 = (wm + 4 * mi) * 16;
    live[mi] = m0 < T;
    if (GA) {
      arow[mi] = A + min(m0 + g, T - 1) * lda + 2 * tg;
      arow8[mi] = A + min(m0 + g + 8, T - 1) * lda + 2 * tg;
    } else {
      arow[mi] = A + min(m0 + (lane & 15), T - 1) * lda + ((lane >> 4) << 3);
      arow8[mi] = arow[mi];
    }
  }
  int boff[2][kKT / 16];  // load_b_tile's swizzled offsets, per n16 pair and k-step
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    const int n = wn * 32 + jp * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks)
      boff[jp][ks] = n * kKT + (((2 * ks + ((lane >> 3) & 1)) ^ (n & 7)) << 3);
  }
  for (int n0 = 0; n0 < N; n0 += kNT) {
    const int width = min(kNT, N - n0);
    float acc[MI][4][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int ksteps = min(kKT, K - kt * kKT) >> 4;
      if (ksteps == kKT / 16) {
        uint32_t bq[kKT / 16][2][4], aq[kKT / 16][MI][4];
        if (GA) {
#pragma unroll
          for (int ks = 0; ks < kKT / 16; ++ks)
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
              if (live[mi]) load_a_global(aq[ks][mi], arow[mi], arow8[mi], kt * kKT + ks * 16);
        }
        const bf16* Wt = ring.consume();
#pragma unroll
        for (int ks = 0; ks < kKT / 16; ++ks) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) ldsm_x4(bq[ks][jp], Wt + boff[jp][ks]);
          if (!GA) {
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
              if (live[mi]) ldsm_x4(aq[ks][mi], arow[mi] + kt * kKT + ks * 16);
          }
        }
#pragma unroll
        for (int ks = 0; ks < kKT / 16; ++ks)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            if (live[mi]) {
#pragma unroll
              for (int jp = 0; jp < 2; ++jp) {
                mma(acc[mi][2 * jp], aq[ks][mi], bq[ks][jp][0], bq[ks][jp][1]);
                mma(acc[mi][2 * jp + 1], aq[ks][mi], bq[ks][jp][2], bq[ks][jp][3]);
              }
            }
      } else {  // the last, shallower tile of a K that is not a multiple of 64
        const bf16* Wt = ring.consume();
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t bq[2][4], aq[4];
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) load_b_tile(bq[jp], Wt, wn * 32 + jp * 16, ks * 16);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if (!live[mi]) continue;
            if (GA) load_a_global(aq, arow[mi], arow8[mi], kt * kKT + ks * 16);
            else ldsm_x4(aq, arow[mi] + kt * kKT + ks * 16);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              mma(acc[mi][2 * jp], aq, bq[jp][0], bq[jp][1]);
              mma(acc[mi][2 * jp + 1], aq, bq[jp][2], bq[jp][3]);
            }
          }
        }
      }
      ring.release();
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int mt = wm + 4 * mi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (wn * 32 + j * 8 < width) {
          const int c = n0 + wn * 32 + j * 8 + 2 * tg, r0 = mt * 16 + g;
          if (r0 < T) epi(r0, c, acc[mi][j][0], acc[mi][j][1]);
          if (r0 + 8 < T) epi(r0 + 8, c, acc[mi][j][2], acc[mi][j][3]);
        }
      }
    }
  }
}

// Dense rounding: bf16(bf16(acc) + bias).
__device__ __forceinline__ bf16 dense_rn(float acc, bf16 bias) { return rn(bf(rn(acc)) + bf(bias)); }

// bf16(bf16(y * g) + be), the FiLM of a normalised value.
__device__ __forceinline__ float film(bf16 y, bf16 g, bf16 be) {
  return bf(rn(bf(rn(bf(y) * bf(g))) + bf(be)));
}

}  // namespace tile_ring
