// Hand-written Hopper (sm_90a) kernel: scaled-dot-product attention, forward.
//
// Replaces dhg/kernels/fused_attention.py::fused_attention (`_attn_kernel`):
//   out = softmax(Q K^T * (1/sqrt(D)) + mask * -1e9) V   per (batch, head)
// at the Pallas kernel's rounding points: Q K^T accumulates in f32 and stays
// f32; the scale 1/sqrt(D) is an f32 computed in f32; the mask bias is f32;
// the row max, exp, sum and division run in f32; the weights are rounded to
// V's type; P V accumulates in f32 and is rounded once to Q's type.
// Instantiated for bfloat16 (the training config) and float32.
//
// Design (a simple, correct first version): one block of 8 warps per
// (batch*head, 64 query rows). K and V of that (b, h) are staged once in
// shared memory as f32 (K rows padded to D + 1 floats, so 32 lanes reading
// 32 different keys hit 32 different banks); each warp walks its query
// rows: lane j computes the logits of keys j, j+32, ..., the warp reduces
// max and sum with shuffles, and lane d accumulates output columns d, d+32.
// Keys are not padded to a multiple of 8 as on the TPU: padded columns there
// only ever add exp(-1e9 - max) = 0.
//
// What bounds it on an H100: the work is 4 B H Tq Tk D flops on bf16 inputs
// (989 TFLOP/s on the tensor cores) against a few MB of Q/K/V/out (3.35
// TB/s); at the training shapes (Tq, Tk <= 240, D <= 64) the bf16 bound is
// the bytes. This version runs f32 FMAs on the CUDA cores and is bound by
// shared-memory loads (two per FMA); mma/wgmma tiles are a later step.
//
// Limit: K and V of one (b, h) must fit in shared memory:
// 4 * (Tk (2D + 1) + 8 (D + Tk)) <= 232,448 bytes (Tk up to ~420 at D = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline long long smem_bytes(int Tk, int D) {
  return 4LL * ((long long)Tk * (2 * D + 1) + (long long)kWarps * (D + Tk));
}

// q [BH, Tq, D], k/v [BH, Tk, D], mask [B, Tk] f32 (1.0 = padded key) or
// null, out [BH, Tq, D]. Grid (ceil(Tq / kRows), B * H).
template <class T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ out, int H, int Tq, int Tk,
                     int D, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int ldk = D + 1;
  float* Ks = smem;                 // [Tk, D + 1]
  float* Vs = Ks + Tk * ldk;        // [Tk, D]
  float* Qw = Vs + Tk * D;          // [kWarps, D]: the warp's query row
  float* Ww = Qw + kWarps * D;      // [kWarps, Tk]: the warp's logits, then weights
  const T* kb = k + (long long)bh * Tk * D;
  const T* vb = v + (long long)bh * Tk * D;
  for (int i = threadIdx.x; i < Tk * D; i += kThreads) {
    const int l = i / D;
    Ks[i + l] = to_f(kb[i]);  // row l starts at l * (D + 1)
    Vs[i] = to_f(vb[i]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qs = Qw + warp * D;
  float* ws = Ww + warp * Tk;
  const float* mrow = mask ? mask + (long long)(bh / H) * Tk : nullptr;
  const int r_end = min(Tq, (int)(blockIdx.x + 1) * kRows);
  for (int r = blockIdx.x * kRows + warp; r < r_end; r += kWarps) {
    const long long row = (long long)bh * Tq + r;
    for (int d = lane; d < D; d += 32) qs[d] = to_f(q[row * D + d]);
    __syncwarp();
    float mx = -INFINITY;
    for (int l = lane; l < Tk; l += 32) {
      const float* kr = Ks + l * ldk;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qs[d], kr[d], acc);
      float lg = __fmul_rn(acc, scale);
      if (mrow) lg = __fadd_rn(lg, __fmul_rn(mrow[l], -1e9f));
      ws[l] = lg;
      mx = fmaxf(mx, lg);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int l = lane; l < Tk; l += 32) {
      const float e = expf(ws[l] - mx);
      ws[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < Tk; l += 32) ws[l] = to_f(from_f<T>(ws[l] / sum));
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < Tk; ++l) acc = fmaf(ws[l], Vs[l * D + d], acc);
      out[row * D + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <class T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int H, int Tq, int Tk, int D, cudaStream_t stream) {
  static bool attr_set = false;
  const long long bytes = smem_bytes(Tk, D);
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  attention_kernel<T><<<grid, kThreads, (size_t)bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), H, Tq, Tk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// softmax(q k^T / sqrt(D) + mask * -1e9) v. is_bf16 selects bfloat16 (1)
// or float32 (0) for q, k, v and out; mask is f32 [B, Tk] or null.
// Returns cudaGetLastError() after the launch.
int dhg_fused_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                        int B, int H, int Tq, int Tk, int D, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Tq, Tk, D, s);
  return launch<float>(q, k, v, mask, out, B, H, Tq, Tk, D, s);
}

}  // extern "C"
