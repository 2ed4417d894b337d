// Hand-written Hopper (sm_90a) kernel for the sampler's enc3 and enc5.
//
// Replaces dhg/kernels/fused_bottleneck.py::fused_encoder_layer (one
// EncoderLayer.attend, used for enc3 and enc5) through the __device__
// routine `encoder_layer` (encoder_layer.cuh, also used by unet_t4.cu), at
// the rounding points of dhg's `_encoder_layer`:
//   * every Dense is a bf16 x bf16 product with f32 accumulation, rounded
//     once to bf16, then `+ bias` in bf16 (two roundings);
//   * logits are rounded to bf16, `* bf16(1/sqrt(hd))`, then `+ mask bias`;
//     the softmax runs in f32, its weights are rounded to bf16, and P.V
//     accumulates in f32 and rounds once;
//   * LayerNorm statistics are f32 and (x - mu) * rsqrt(var + eps) is taken
//     in f32, then rounded; SiLU is computed in f32;
//   * every FiLM multiply and add rounds in bf16.
// (dhg's fused_bottleneck, which shares that body, is bottleneck.cu.)
//
// Design (a simple, correct first version):
//   * one thread block per batch row; stages separated by __syncthreads();
//   * every matrix product runs on the tensor cores through warp-level
//     mma.sync m16n8k16 (bf16 in, f32 accumulate), each warp owning 16x32
//     output tiles and loading its fragments straight from global memory;
//   * intermediates live in a per-row global workspace that the wrapper
//     allocates (torch.empty), so the whole layer, self-attention included,
//     is one launch: a row's K2/V2 are complete after a block-wide barrier.
//
// What bounds it on an H100: at batch 96 the work is 0.14 (enc5) to 0.18
// (enc3) GFLOP a row (bf16 tensor-core bound, 989 TFLOP/s). Known weakness: one block per row,
// fragments from L1/L2 rather than a shared-memory ring (bottleneck.cu has
// the cluster/ring design this layer has not adopted yet).
//
// Built by dhg_torch/kernels/build.py (nvcc for sm_90a, one object per .cu,
// linked into one shared library); bound from Python with ctypes
// (dhg_torch/kernels/fused_bottleneck.py).

#include "encoder_layer.cuh"

struct Args {
  const bf16* x;    // [B, T, D]
  const bf16* pe;   // [T, D] positional embedding
  const bf16* neg;  // [B, 1, L] additive mask bias (mask * -1e9)
  bf16* out;        // [B, T, D]
  bf16* ws;         // [B, ws_elems(T, D, L)] scratch
  int T, D, H, L;
  float scale;      // 1 / sqrt(D / H), rounded to bf16 in the kernel
  LayerW layer;
};

__global__ void __launch_bounds__(DHG_THREADS)
    encoder_layer_kernel(const __grid_constant__ Args a) {
  const int row = blockIdx.x;
  const long long td = (long long)a.T * a.D;
  bf16* ws = a.ws + row * ws_elems(a.T, a.D, a.L);
  const LayerCfg c = {a.pe, a.T, a.D, a.H, a.L, a.scale};
  encoder_layer(c, a.layer, a.x + row * td, a.out + row * td, ws, a.neg + row * a.L, row);
}

extern "C" {

// Scratch elements (bf16) per batch row; the wrapper allocates B times this.
long long dhg_workspace_elems(int T, int D, int L) { return ws_elems(T, D, L); }

const char* dhg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One EncoderLayer.attend. Returns cudaGetLastError() after the launch.
int dhg_fused_encoder_layer(const void* x, const void* pe, const void* neg,
                            const void* const* ops, void* out, void* ws, int B, int T, int D,
                            int H, int L, void* stream) {
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.pe = static_cast<const bf16*>(pe);
  a.neg = static_cast<const bf16*>(neg);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<bf16*>(ws);
  a.T = T; a.D = D; a.H = H; a.L = L;
  a.scale = (float)(1.0 / sqrt((double)(D / H)));
  fill_layers(&a.layer, ops, 1);
  encoder_layer_kernel<<<B, DHG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
