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
// All arithmetic is f32 FMA on the CUDA cores: no TF32 and no bf16 tensor
// cores, which would change the numbers the Pallas kernel produces.
//
// Design (a simple, correct first version): one block of 256 threads per
// (batch row, 32-row tile of T). The Pallas kernel keeps a whole row in
// VMEM; a [480, 384] f32 row is 737 KB against a block's 227 KB, so T is
// tiled and the three chained k3 convs read a halo: x rows t0-2 .. t0+33
// (2 rows each side for the main branch, 1 for the skip). The x tile, h1
// (34 rows, zeroed outside [0, T) so the second conv sees the same zero
// padding), SiLU(h2) and the skip sum live in shared memory; the weights
// ([3, Cin, Co] per conv, [Co, Co] for the Dense, as dhg passes them) are
// read from L2 as float4 rows. A k3 conv over a row-major tile is one GEMM
// with K = 3 Cin: row m of the tile followed by rows m+1 and m+2 is the
// contiguous run A[m Cin .. (m + 3) Cin). Each thread owns 4 rows x 4 columns
// of the output tile.
//
// What bounds it on an H100: 2 T (3 Cin Co + 3 Cin Co/2 + 3 Co/2 Co + Co^2)
// flops a row at the f32 CUDA-core peak (67 TFLOP/s, H100 SXM data sheet)
// against x, out and the weights once (3.35 TB/s): every training-path
// block is bound by operations. This version re-reads the weights from L2
// for every tile and issues four shared-memory loads per 16 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;      // output rows per block
constexpr int kXRows = 40;     // x rows t0-2 ..: 36 used, the rest read only by discarded rows
constexpr int kH1Rows = 36;    // h1 rows t0-1 ..: 34 used
constexpr int kThreads = 256;
constexpr int kRM = 4;         // output rows per thread
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

inline long long smem_bytes(int Cin, int Co) {
  return 4LL * (kXRows * Cin + kH1Rows * (Co / 2) + 2 * kTile * Co);
}

// acc(m, n) = sum_k A[m * lda + k] * W[k * N + n] for m < M, n < N (4 | N),
// handed to epi(m, n, acc). A is in shared memory and must hold readable
// rows up to round_up(M, kRM) - 1 + (K - 1) / lda; W is in global memory.
template <class Epi>
__device__ void block_gemm(const float* A, int lda, int M, int K, const float* __restrict__ W,
                           int N, Epi epi) {
  const int ng = N / 4, mg = (M + kRM - 1) / kRM;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int item = threadIdx.x; item < mg * ng; item += blockDim.x) {
    const int m0 = (item / ng) * kRM, c4 = item % ng;
    float acc[kRM][4];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float* a = A + m0 * lda;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 w = __ldg(W4 + (long long)k * ng + c4);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float av = a[i * lda + k];
        acc[i][0] = fmaf(av, w.x, acc[i][0]);
        acc[i][1] = fmaf(av, w.y, acc[i][1]);
        acc[i][2] = fmaf(av, w.z, acc[i][2]);
        acc[i][3] = fmaf(av, w.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      if (m0 + i < M)
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(m0 + i, 4 * c4 + j, acc[i][j]);
  }
}

struct Args {
  const void* x;  // [B, T, Cin], type T
  const float *wskip, *bskip, *w1, *b1, *w2, *b2, *wfc, *bfc;
  const float *g1, *be1, *g2, *be2, *g3, *be3;  // [B, C]
  void* out;  // [B, T, Co], type T
  int T, Cin, Co;
};

template <class T>
__global__ void __launch_bounds__(kThreads) conv_block_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int Cin = a.Cin, Co = a.Co, C2 = a.Co / 2, TT = a.T;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  float* XS = smem;                   // [kXRows, Cin]: x rows t0-2 ..
  float* H1 = XS + kXRows * Cin;      // [kH1Rows, C2]: SiLU(h1) rows t0-1 ..
  float* H2 = H1 + kH1Rows * C2;      // [kTile, Co]: SiLU(h2) rows t0 ..
  float* SK = H2 + kTile * Co;        // [kTile, Co]: skip rows t0 ..
  const T* x = static_cast<const T*>(a.x) + (long long)b * TT * Cin;
  T* out = static_cast<T*>(a.out) + (long long)b * TT * Co;

  for (int i = threadIdx.x; i < kXRows * Cin; i += kThreads) {
    const int t = t0 - 2 + i / Cin;
    XS[i] = (t >= 0 && t < TT) ? to_f(x[(long long)t * Cin + i % Cin]) : 0.f;
  }
  __syncthreads();

  // skip row j (t = t0 + j) reads x rows t-1 .. t+1 = XS rows j+1 .. j+3.
  const float* bskip = a.bskip;
  block_gemm(XS + Cin, Cin, kTile, 3 * Cin, a.wskip, Co, [=](int m, int n, float acc) {
    SK[m * Co + n] = acc + bskip[n];
  });
  __syncthreads();
  for (int i = threadIdx.x; i < kXRows * Cin; i += kThreads) XS[i] = silu(XS[i]);
  __syncthreads();

  // h1 row j (t = t0 - 1 + j) reads SiLU(x) rows t-1 .. t+1 = XS rows j .. j+2.
  const float* g1 = a.g1 + (long long)b * C2;
  const float* be1 = a.be1 + (long long)b * C2;
  const float* b1 = a.b1;
  block_gemm(XS, Cin, kTile + 2, 3 * Cin, a.w1, C2, [=](int m, int n, float acc) {
    const int t = t0 - 1 + m;
    const float h = (acc + b1[n]) * g1[n] + be1[n];
    H1[m * C2 + n] = (t >= 0 && t < TT) ? silu(h) : 0.f;
  });
  __syncthreads();

  // h2 row j (t = t0 + j) reads SiLU(h1) rows t-1 .. t+1 = H1 rows j .. j+2.
  const float* g2 = a.g2 + (long long)b * Co;
  const float* be2 = a.be2 + (long long)b * Co;
  const float* b2 = a.b2;
  block_gemm(H1, C2, kTile, 3 * C2, a.w2, Co, [=](int m, int n, float acc) {
    H2[m * Co + n] = silu((acc + b2[n]) * g2[n] + be2[n]);
  });
  __syncthreads();

  const float* g3 = a.g3 + (long long)b * Co;
  const float* be3 = a.be3 + (long long)b * Co;
  const float* bfc = a.bfc;
  block_gemm(H2, Co, kTile, Co, a.wfc, Co, [=](int m, int n, float acc) {
    const int t = t0 + m;
    if (t < TT) {
      const float h = (acc + bfc[n]) * g3[n] + be3[n];
      out[(long long)t * Co + n] = from_f<T>(h + SK[m * Co + n]);
    }
  });
}

template <class T>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool attr_set = false;
  const long long bytes = smem_bytes(a.Cin, a.Co);
  if (B < 1 || a.T < 1 || a.Cin < 4 || a.Cin % 4 || a.Co % 8 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((a.T + kTile - 1) / kTile, B);
  conv_block_kernel<T><<<grid, kThreads, (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One ConvBlock. ops: wskip [3, Cin, Co], bskip [Co], w1 [3, Cin, Co/2],
// b1 [Co/2], w2 [3, Co/2, Co], b2 [Co], wfc [Co, Co] (in, out), bfc [Co],
// g1, be1 [B, Co/2], g2, be2, g3, be3 [B, Co]: all f32. x and out are
// bfloat16 (is_bf16 = 1) or float32. Returns cudaGetLastError() after the
// launch.
int dhg_fused_conv_block(const void* x, const void* const* ops, void* out, int B, int T, int Cin,
                         int Co, int is_bf16, void* stream) {
  Args a;
  a.x = x;
  const float** w[] = {&a.wskip, &a.bskip, &a.w1, &a.b1, &a.w2, &a.b2, &a.wfc, &a.bfc,
                       &a.g1,    &a.be1,   &a.g2, &a.be2, &a.g3, &a.be3};
  for (int i = 0; i < 14; ++i) *w[i] = static_cast<const float*>(ops[i]);
  a.out = out;
  a.T = T;
  a.Cin = Cin;
  a.Co = Co;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}

}  // extern "C"
