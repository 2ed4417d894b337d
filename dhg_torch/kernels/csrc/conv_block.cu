// Hand-written Hopper (sm_90a) kernel: one fused ConvBlock, forward.
//
// Replaces dhg/kernels/fused_conv_block.py::fused_conv_block
// (`_block_kernel`). Per batch row, in f32 whatever the input type:
//   skip = k3(x)
//   h    = FiLM1(k3(SiLU x))           width Co/2
//   h    = FiLM2(k3(SiLU h))           width Co
//   h    = FiLM3(Dense(SiLU h))        width Co
//   out  = h + skip, rounded once to x's type
// with k3 a 'same' 3-tap conv (zero padding) and FiLM h * gamma[b] + beta[b].
//
// What bounds it on an H100: 2 T (3 Cin Co + 3 Cin Co/2 + 3 Co/2 Co + Co^2)
// flops a row, made f32-accurate on the tensor cores as three TF32 products
// each (two for the skip conv of a bf16 x): 495 TFLOP/s TF32 (H100 SXM data
// sheet) is 165 TFLOP/s of f32-accurate products. Against x, out and the
// weights once at 3.35 TB/s, every training-path block is bound by
// operations.
//
// Products (3xTF32). Each f32 operand a is split in registers at the
// fragment load into big (a with its 13 low mantissa bits cleared: exact in
// TF32) and small = a - big (exact in f32, below 2^-10 |a|; the tensor core
// drops its own low bits, 2^-20 |a|), and mma.sync m16n8k8 tf32 sums
// small*big + big*small + big*big, the small terms first. A bf16 x is exact
// in TF32, so the skip conv on it takes two products. One TF32 pass (a
// 10-bit mantissa) would miss the f32 bar, and bf16 products would change
// dhg's numbers. The tensor core's additions drop low bits too, so each
// ring slot's 32-deep products sum into a zeroed partial that an f32 add
// moves into the running sum: summed on the tensor core alone, a K of
// 1,152 loses about 2^-17 of the result. The weights change every training
// step, so they are split where they are read, never cached. (cvt.rna's
// rounded split takes 4 instructions an operand where this one takes 1;
// the kernel is bound by instruction issue.)
//
// Tiles. One CTA per (batch row, 62 output rows of T). The three chained
// k3 convs need h1 on rows t0-1 .. t0+62 (64 rows) and x on rows t0-2 ..
// t0+63, so every product runs over 64 rows: four m16 tiles, the warps 2
// along rows (32 each) by 4 (Co <= 128: 256 threads, two CTAs an SM) or 8
// (512 threads) along columns, a warp at most 32 columns of a pass (128 or
// 256 columns); the halo costs 2 rows in 64. 16 warps an SM either way:
// a warp's 32 x 32 tile and its split fragments fit in 128 registers. A k3
// conv is one product with K = 3 Cin: tap j reads the tile's rows shifted
// by j against W[j].
//
// Weights. A ring of 2-4 slots in shared memory, each 32 reduction rows by
// one pass's columns, filled by cp.async from L2 (zeros past Cin, Co and
// each tap's last row), one block barrier a slot. Every warp reads every
// slot, so a weight leaves L2 once per 64 rows of T. The ring runs through
// the four products (skip, conv1, conv2, fc) without a break: the next
// product's first slots load while this one ends. Thread 0 plans each
// slot's copy one slot ahead in shared memory, so the other threads only
// add offsets.
//
// Shared memory: x's tile in f32 (68 rows: the skip's discarded last row
// reads row 66), turned into SiLU(x) in place once the skip conv is done;
// SiLU(h1) (66 rows, zero outside [0, T) as conv2's padding, the last two
// zero); SiLU(h2) in x's space once conv1 is done; the ring. Rows are padded
// to 4 mod 32 floats (conflict-free A fragments), slots to 8 mod 32 (B).
// Where Co <= 128 the ring is cut to fit two CTAs an SM. dec3 (Cin 384,
// Co 256) takes 208,032 bytes with 2 slots. The skip conv's sum does not
// fit beside them: it goes to an f32 workspace [B, T, Co] in global memory
// that the wrapper allocates, and the fc epilogue reads each value back in
// the same thread that wrote it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace {

using wmma16::cp_async_commit;
using wmma16::smem_u32;

constexpr int kTile = 62;      // output rows a CTA
constexpr int kRows = 64;      // rows of every product (4 m16 tiles)
constexpr int kXRows = 68;     // x rows t0-2 ..
constexpr int kH1Rows = 66;    // h1 rows t0-1 ..: 64 computed, 2 zero rows
constexpr int kWT = 4;         // n8 tiles a warp covers at most (32 columns)
constexpr int kKS = 32;        // reduction rows a ring slot (four k8 steps)
constexpr int kMaxSlots = 4;
constexpr int kMaxSmem = 232448;
constexpr int kHalfSmem = 115712;  // two CTAs an SM: (228 KB - 2 x 1 KB reserved) / 2

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride (floats) of an activation buffer of c columns.
__host__ __device__ constexpr int ld_act(int c) { return round_up(c, 32) + 4; }

// Warps along the output columns (2 along rows): 4 where Co <= 128 (256
// threads, passes of 128 columns, two CTAs an SM), else 8 (512 threads,
// passes of 256 columns).
__host__ __device__ constexpr int n_warps(int Co) { return Co <= 128 ? 4 : 8; }
__host__ __device__ constexpr int threads_for(int Co) { return 64 * n_warps(Co); }

// Floats of one ring slot: kKS rows of the widest pass, padded to 8 mod 32.
__host__ __device__ constexpr int slot_floats(int Co) {
  const int wn = n_warps(Co), tiles = (Co + 8 * wn - 1) / (8 * wn);
  return kKS * (8 * wn * (tiles < kWT ? tiles : kWT) + 8);
}

// Floats of x's tile, which later holds SiLU(h2).
__host__ __device__ constexpr int x_floats(int Cin, int Co) {
  return kXRows * ld_act(Cin) > kRows * ld_act(Co) ? kXRows * ld_act(Cin) : kRows * ld_act(Co);
}

// One ring slot's copy, worked out by thread 0 a slot ahead of its issue and
// read by every thread from shared memory: the first weight row (row k0 of
// the tap, column n0), the rows to copy (fewer past a tap's K: zeros), the
// columns that exist (past N: zeros), the slot's and the weight's row
// strides. rows = 0 past the schedule's end.
struct SlotCopy {
  const float* src;
  int rows, cols, ldb, N;
};

// Thread 0's schedule position (product, pass, tap, first row of the tap)
// and the copies of the next two slots.
struct Plan {
  SlotCopy copy[2];
  int g, pass, tap, k0;
};
constexpr int kPlanBytes = (sizeof(Plan) + 15) / 16 * 16;

// Bytes of a CTA: x's tile, h1, the ring and the load plan.
long long smem_for(int Cin, int Co, int slots) {
  return 4LL * ((long long)x_floats(Cin, Co) + (long long)kH1Rows * ld_act(Co / 2) +
                (long long)slots * slot_floats(Co)) +
         kPlanBytes;
}

// The most ring slots (4 down to 2) that fit: in half an SM's shared memory
// where Co <= 128 (two CTAs an SM; their registers allow it) and 2 slots
// fit there, else in a whole one. 2 where none fits (refused).
int ring_slots(int Cin, int Co) {
  const long long cap =
      n_warps(Co) == 4 && smem_for(Cin, Co, 2) <= kHalfSmem ? kHalfSmem : kMaxSmem;
  for (int s = kMaxSlots; s > 2; --s)
    if (smem_for(Cin, Co, s) <= cap) return s;
  return 2;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// a = big + small: big is a with its 13 low mantissa bits cleared (exact in
// TF32), small = a - big exactly (|small| < 2^-10 |a|), whose own low bits
// the tensor core drops (2^-20 |a|).
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// c += a b over one m16n8k8 tile; A row-major, B column-major fragments
// (PTX ISA, mma.m16n8k8 .tf32, lane = 4 g + tg): a0..a3 = A(g, tg),
// A(g+8, tg), A(g, tg+4), A(g+8, tg+4); b0, b1 = B(tg, g), B(tg+4, g);
// c0, c1 = C(g, 2tg .. 2tg+1), c2, c3 = C(g+8, ..).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; `bytes` (0 or 16) of them read, the rest zero.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(bytes)
               : "memory");
}

// Wait until at most n (0..2) of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2)
    wmma16::cp_async_wait<2>();
  else if (n == 1)
    wmma16::cp_async_wait<1>();
  else
    wmma16::cp_async_wait<0>();
}

struct Args {
  const void* x;  // [B, T, Cin], type T
  const float *wskip, *bskip, *w1, *b1, *w2, *b2, *wfc, *bfc;
  const float *g1, *be1, *g2, *be2, *g3, *be3;  // [B, C]
  float* skip;  // [B, T, Co] workspace
  void* out;    // [B, T, Co], type T
  int T, Cin, Co, slots;
};

// One of the four products, in the kernel's order: 0 skip, 1 conv1,
// 2 conv2, 3 fc. W is [taps, K, N] row-major (dhg's layout).
struct Product {
  const float* w;
  int taps, K, N;
  int kp;      // K padded to kKS: each tap's rows in the ring
  int chunks;  // ring slots a pass
  int passes;  // passes over the output columns
};

template <int WN>
__device__ __forceinline__ Product product(const Args& a, int g) {
  Product p;
  p.w = g == 0 ? a.wskip : g == 1 ? a.w1 : g == 2 ? a.w2 : a.wfc;
  p.taps = g == 3 ? 1 : 3;
  p.K = g == 2 ? a.Co / 2 : g == 3 ? a.Co : a.Cin;
  p.N = g == 1 ? a.Co / 2 : a.Co;
  p.kp = round_up(p.K, kKS);
  p.chunks = p.taps * p.kp / kKS;
  p.passes = (p.N + 32 * WN - 1) / (32 * WN);
  return p;
}

// n8 tiles a warp covers in pass `pass` of a product N wide.
template <int WN>
__device__ __forceinline__ int pass_nt(int N, int pass) {
  const int left = (N - pass * 32 * WN + 8 * WN - 1) / (8 * WN);
  return left < kWT ? left : kWT;
}

// Thread 0: the copy at the plan's position, then the position one slot on.
template <int WN>
__device__ __forceinline__ SlotCopy plan_next(const Args& a, Plan& pl) {
  SlotCopy c{nullptr, 0, 0, 0, 0};
  if (pl.g >= 4) return c;
  const Product q = product<WN>(a, pl.g);
  const int n0 = pl.pass * 32 * WN, nt = pass_nt<WN>(q.N, pl.pass);
  c.src = q.w + ((long long)pl.tap * q.K + pl.k0) * q.N + n0;
  c.rows = min(kKS, q.K - pl.k0);
  c.cols = min(8 * WN * nt, q.N - n0);
  c.ldb = 8 * WN * nt + 8;
  c.N = q.N;
  if ((pl.k0 += kKS) >= q.kp) {
    pl.k0 = 0;
    if (++pl.tap == q.taps) {
      pl.tap = 0;
      if (++pl.pass == q.passes) {
        pl.pass = 0;
        ++pl.g;
      }
    }
  }
  return c;
}

// All threads: cp.async of one slot's kKS weight rows (row stride ldb),
// zeros past the rows and columns that exist. Thread i copies 16 bytes at
// column 4 (i % 8 WN) of rows i / (8 WN) + 8 m.
template <int WN>
__device__ __forceinline__ void load_slot(const SlotCopy& sc, float* slot) {
  constexpr int kStep = 64 * WN / (8 * WN);
  const int c = 4 * (threadIdx.x % (8 * WN));
  if (sc.rows == 0 || c >= sc.ldb - 8) return;
  const bool col_ok = c < sc.cols;  // 4 | N: a 16-byte run never straddles N
#pragma unroll
  for (int r = threadIdx.x / (8 * WN); r < kKS; r += kStep) {
    const bool ok = col_ok && r < sc.rows;
    cp_async16_zfill(slot + r * sc.ldb + c, ok ? sc.src + (long long)r * sc.N + c : sc.src,
                     ok ? 16 : 0);
  }
}

// acc[mt][j] += A[32 rows, k0 .. k0 + kKS) x slot[kKS, ncol + 8 j ..] for this
// warp's 2 m16 tiles and its first NL n8 tiles. A points at the warp's first
// row. kSplitA false: A is exact in TF32 (bf16 x), two products. The slot's
// products sum into a zeroed partial that an f32 add moves into acc.
template <int NL, bool kSplitA>
__device__ __forceinline__ void slot_product(float (&acc)[2][kWT][4], const float* A, int lda,
                                             int k0, const float* B, int ldb, int ncol) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  float part[2][NL][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NL; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKS / 8; ++ks) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* p = A + (mt * 16 + g) * lda + k0 + ks * 8 + tg;
      const float v[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kSplitA)
          split(v[i], ab[mt][i], as[mt][i]);
        else
          ab[mt][i] = __float_as_uint(v[i]);
      }
    }
    const float* q = B + (ks * 8 + tg) * ldb + ncol + g;
    // Four n8 tiles at a time, so only their B fragments are live.
#pragma unroll
    for (int j0 = 0; j0 < NL; j0 += 4) {
      constexpr int kW = NL < 4 ? NL : 4;
      uint32_t bb[kW][2], bs[kW][2];
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j0 + j < NL) {
          split(q[8 * (j0 + j)], bb[j][0], bs[j][0]);
          split(q[4 * ldb + 8 * (j0 + j)], bb[j][1], bs[j][1]);
        }
      if (kSplitA) {
#pragma unroll
        for (int j = 0; j < kW; ++j)
          if (j0 + j < NL)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j0 + j], as[mt], bb[j][0], bb[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j0 + j < NL)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j0 + j], ab[mt], bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j0 + j < NL)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j0 + j], ab[mt], bb[j][0], bb[j][1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NL; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[mt][j][i];
}

// slot_product with the pass's n8 tiles a warp (1 .. kWT) as a constant.
template <bool kSplitA>
__device__ __forceinline__ void slot_product_nt(float (&acc)[2][kWT][4], const float* A, int lda,
                                                int k0, const float* B, int ldb, int ncol,
                                                int nt) {
#define DHG_CONV_NT_CASE(n)                                                 \
  case n:                                                                   \
    slot_product<n, kSplitA>(acc, A, lda, k0, B, ldb, ncol);                 \
    break;
  switch (nt) {
    DHG_CONV_NT_CASE(1)
    DHG_CONV_NT_CASE(2)
    DHG_CONV_NT_CASE(3)
    DHG_CONV_NT_CASE(4)
  }
#undef DHG_CONV_NT_CASE
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int WN, class T>
__global__ void __launch_bounds__(64 * WN, WN == 4 ? 2 : 1)
    conv_block_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kExactX = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kThreads = 64 * WN;
  const int Cin = a.Cin, Co = a.Co, C2 = a.Co / 2, TT = a.T, S = a.slots;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int ldx = ld_act(Cin), ldh1 = ld_act(C2), ldh2 = ld_act(Co);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp / WN, wn = warp % WN;
  const int slot_sz = slot_floats(Co);
  float* XS = smem;                      // x, then SiLU(x), then SiLU(h2) [64, ldh2]
  float* H1 = XS + x_floats(Cin, Co);    // SiLU(h1) [66, ldh1]
  float* RING = H1 + kH1Rows * ldh1;     // S slots

  // The first S - 1 slots' copies, each planned by thread 0 before a barrier.
  Plan* plan = reinterpret_cast<Plan*>(RING + S * slot_sz);
  if (threadIdx.x == 0) {
    Plan p;
    p.g = p.pass = p.tap = p.k0 = 0;
    p.copy[0] = plan_next<WN>(a, p);
    *plan = p;
  }
  for (int s = 0; s < S - 1; ++s) {
    __syncthreads();
    load_slot<WN>(plan->copy[s & 1], RING + s * slot_sz);
    cp_async_commit();
    if (threadIdx.x == 0) plan->copy[(s + 1) & 1] = plan_next<WN>(a, *plan);
  }
  int slot_use = 0, slot_fill = S - 1;  // ring slots of the next read and the next copy
  int fill = S - 1;                     // schedule index of the next copy

  // x rows t0-2 .., zero outside [0, T) and past Cin; h1's two zero rows.
  const T* x = static_cast<const T*>(a.x) + (long long)b * TT * Cin;
  const int v4 = ldx / 4;
  for (int e = threadIdx.x; e < kXRows * v4; e += kThreads) {
    const int i = e / v4, c = 4 * (e - i * v4), t = t0 - 2 + i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < TT && c < Cin) v = load4(x + (long long)t * Cin + c);
    *reinterpret_cast<float4*>(XS + i * ldx + c) = v;
  }
  for (int e = threadIdx.x; e < 2 * ldh1; e += kThreads) H1[64 * ldh1 + e] = 0.f;

  const float* g1 = a.g1 + (long long)b * C2;
  const float* be1 = a.be1 + (long long)b * C2;
  const float* g2 = a.g2 + (long long)b * Co;
  const float* be2 = a.be2 + (long long)b * Co;
  const float* g3 = a.g3 + (long long)b * Co;
  const float* be3 = a.be3 + (long long)b * Co;
  float* skip = a.skip + (long long)b * TT * Co;
  T* out = static_cast<T*>(a.out) + (long long)b * TT * Co;

  for (int g = 0; g < 4; ++g) {
    const Product q = product<WN>(a, g);
    // Row r of this product reads A rows r + row0 + tap.
    const float* A = g == 2 ? H1 : XS;
    const int lda = g == 2 ? ldh1 : g == 3 ? ldh2 : ldx;
    const int row0 = g == 0 ? 1 : 0;
    for (int pass = 0; pass < q.passes; ++pass) {
      const int n0 = pass * 32 * WN, nt = pass_nt<WN>(q.N, pass), ldb = 8 * WN * nt + 8;
      float acc[2][kWT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < kWT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

      for (int i = 0, tap = 0, k0 = 0; i < q.chunks; ++i) {
        cp_async_wait_upto(S - 2);
        // This slot landed for all; every warp left the previous one; the
        // plan of copy `fill` is written.
        __syncthreads();
        load_slot<WN>(plan->copy[fill & 1], RING + slot_fill * slot_sz);
        cp_async_commit();
        if (threadIdx.x == 0) plan->copy[(fill + 1) & 1] = plan_next<WN>(a, *plan);
        ++fill;
        slot_fill = slot_fill + 1 == S ? 0 : slot_fill + 1;
        const float* Aw = A + (row0 + tap + wm * 32) * lda;
        const float* B = RING + slot_use * slot_sz;
        slot_use = slot_use + 1 == S ? 0 : slot_use + 1;
        if (kExactX && g == 0)
          slot_product_nt<false>(acc, Aw, lda, k0, B, ldb, wn * 8 * nt, nt);
        else
          slot_product_nt<true>(acc, Aw, lda, k0, B, ldb, wn * 8 * nt, nt);
        if ((k0 += kKS) == q.kp) {
          k0 = 0;
          ++tap;
        }
      }

      // Epilogue: row r, columns n and n + 1 of this product.
      const int gq = lane >> 2, tg = lane & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + gq + 8 * h;
#pragma unroll
          for (int j = 0; j < kWT; ++j) {
            if (j >= nt) continue;
            const int n = n0 + wn * 8 * nt + 8 * j + 2 * tg;
            const float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
            if (g == 0) {  // skip row t0 + r -> workspace
              const int t = t0 + r;
              if (r < kTile && t < TT && n < Co)
                store2(skip + (long long)t * Co + n, v0 + a.bskip[n], v1 + a.bskip[n + 1]);
            } else if (g == 1) {  // SiLU(h1) row t0 - 1 + r, zero outside [0, T) and past C2
              if (n >= ldh1 - 4) continue;  // a pass may run past the row's padded width
              const int t = t0 - 1 + r;
              float o0 = 0.f, o1 = 0.f;
              if (t >= 0 && t < TT && n < C2) {
                o0 = silu((v0 + a.b1[n]) * g1[n] + be1[n]);
                o1 = silu((v1 + a.b1[n + 1]) * g1[n + 1] + be1[n + 1]);
              }
              store2(H1 + r * ldh1 + n, o0, o1);
            } else if (g == 2) {  // SiLU(h2) row t0 + r into x's space, zero past Co
              if (n >= ldh2 - 4) continue;
              float o0 = 0.f, o1 = 0.f;
              if (n < Co) {
                o0 = silu((v0 + a.b2[n]) * g2[n] + be2[n]);
                o1 = silu((v1 + a.b2[n + 1]) * g2[n + 1] + be2[n + 1]);
              }
              store2(XS + r * ldh2 + n, o0, o1);
            } else {  // out row t0 + r = FiLM3(fc) + skip
              const int t = t0 + r;
              if (r < kTile && t < TT && n < Co) {
                const float2 s = *reinterpret_cast<const float2*>(skip + (long long)t * Co + n);
                const float o0 = (v0 + a.bfc[n]) * g3[n] + be3[n];
                const float o1 = (v1 + a.bfc[n + 1]) * g3[n + 1] + be3[n + 1];
                store2(out + (long long)t * Co + n, o0 + s.x, o1 + s.y);
              }
            }
          }
        }
    }
    __syncthreads();  // this product's output is complete; its A is free
    if (g == 0) {
      for (int e = threadIdx.x; e < kXRows * v4; e += kThreads) {
        float4* p = reinterpret_cast<float4*>(XS) + e;
        const float4 v = *p;
        *p = make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
      }
      __syncthreads();
    }
  }
}

template <int WN, class T>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(conv_block_kernel<WN, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_block_kernel<WN, T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

bool valid(int B, int T, int Cin, int Co) {
  return B >= 1 && T >= 1 && Cin >= 4 && Cin % 4 == 0 && Co >= 8 && Co % 8 == 0 &&
         smem_for(Cin, Co, ring_slots(Cin, Co)) <= kMaxSmem;
}

template <int WN, class T>
int launch(Args a, int B, cudaStream_t stream) {
  const cudaError_t e = prepare<WN, T>();
  if (e != cudaSuccess) return (int)e;
  a.slots = ring_slots(a.Cin, a.Co);
  const dim3 grid((a.T + kTile - 1) / kTile, B);
  conv_block_kernel<WN, T>
      <<<grid, 64 * WN, (size_t)smem_for(a.Cin, a.Co, a.slots), stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WN, class T>
int ctas_per_sm(int Cin, int Co) {
  int n = 0;
  if (prepare<WN, T>() != cudaSuccess) return 0;
  const size_t bytes = (size_t)smem_for(Cin, Co, ring_slots(Cin, Co));
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_block_kernel<WN, T>, 64 * WN,
                                                    bytes) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

extern "C" {

// The launch shape, for the wrapper's mirror (fused_conv_block.conv_block_layout).
int dhg_conv_block_tile() { return kTile; }
int dhg_conv_block_threads(int Co) { return threads_for(Co); }
int dhg_conv_block_slots(int Cin, int Co) { return ring_slots(Cin, Co); }
long long dhg_conv_block_smem_bytes(int Cin, int Co) {
  return smem_for(Cin, Co, ring_slots(Cin, Co));
}

// CTAs of this shape one SM holds at once (0 if none fits).
int dhg_conv_block_ctas_per_sm(int Cin, int Co, int is_bf16) {
  if (!valid(1, 1, Cin, Co)) return 0;
  if (n_warps(Co) == 4)
    return is_bf16 ? ctas_per_sm<4, __nv_bfloat16>(Cin, Co) : ctas_per_sm<4, float>(Cin, Co);
  return is_bf16 ? ctas_per_sm<8, __nv_bfloat16>(Cin, Co) : ctas_per_sm<8, float>(Cin, Co);
}

// One ConvBlock. ops: wskip [3, Cin, Co], bskip [Co], w1 [3, Cin, Co/2],
// b1 [Co/2], w2 [3, Co/2, Co], b2 [Co], wfc [Co, Co] (in, out), bfc [Co],
// g1, be1 [B, Co/2], g2, be2, g3, be3 [B, Co]: all f32, 16-byte aligned.
// x and out are bfloat16 (is_bf16 = 1) or float32; workspace is f32
// [B, T, Co]. Returns cudaGetLastError() after the launch.
int dhg_fused_conv_block(const void* x, const void* const* ops, void* workspace, void* out, int B,
                         int T, int Cin, int Co, int is_bf16, void* stream) {
  if (!valid(B, T, Cin, Co)) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  const float** w[] = {&a.wskip, &a.bskip, &a.w1, &a.b1, &a.w2, &a.b2, &a.wfc, &a.bfc,
                       &a.g1,    &a.be1,   &a.g2, &a.be2, &a.g3, &a.be3};
  for (int i = 0; i < 14; ++i) *w[i] = static_cast<const float*>(ops[i]);
  a.skip = static_cast<float*>(workspace);
  a.out = out;
  a.T = T;
  a.Cin = Cin;
  a.Co = Co;
  a.slots = 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_warps(Co) == 4)
    return is_bf16 ? launch<4, __nv_bfloat16>(a, B, s) : launch<4, float>(a, B, s);
  return is_bf16 ? launch<8, __nv_bfloat16>(a, B, s) : launch<8, float>(a, B, s);
}

}  // extern "C"
