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
// (bottleneck.cu shares that body; the layer itself is row_layer.cuh's
// `layer_rows`, which unet_t4.cu runs for enc5 and the bottleneck too.)
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

#include "row_layer.cuh"

namespace {

using namespace row_layer;

constexpr int kMaxCluster = 16;  // non-portable above 8
constexpr int kMaxHeads = 8;
constexpr int kMaxD = 256;

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
  o.kr = staged_keys(T);
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

bool valid(int B, int T, int D, int H, int L) {
  if (B < 1 || T < 1 || L < 1 || H < 1 || H > kMaxHeads || D % H) return false;
  const int hd = D / H;
  if (hd % 16 || hd > kMaxHd || D > kMaxD) return false;
  const Layout o = layout(T, D, H);
  return o.tc <= kMaxTc && o.C <= kMaxCluster && o.total <= kMaxSmem;
}

__global__ void __launch_bounds__(kT, 1) encoder_layer_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank(), b = blockIdx.y;
  const int T = a.T, D = a.D, H = a.H, L = a.L, tc = a.tc;
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
  const int ld = lo.ld, cpr = D >> 3;

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
  stage_layer_vec(vec, a.p, D);
  for (long long i = threadIdx.x; i < (lo.s - lo.ks) / 16; i += kT)
    reinterpret_cast<uint4*>(sm + lo.ks)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int s = 0; s < kEStages - 1; ++s) ring.issue();
  cp_async_wait<0>();
  __syncthreads();

  const RowBufs bufs = {X, A, Q, K2, V2, Hf, ld, lo.ldf};
  layer_rows<kMaxD>(cl, ring, bufs, ab, vec, a.p, a.pe + (long long)r0 * D,
                    a.neg + (long long)b * L, (long long)b * H, n, T, D, H, L, tc, a.scale,
                    a.out + ((long long)b * T + r0) * D, D);
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
  if (!valid(B, T, D, H, L) || tiles != layer_tiles(D)) return (int)cudaErrorInvalidValue;
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
