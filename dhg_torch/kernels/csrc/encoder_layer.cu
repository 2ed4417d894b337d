// Hand-written Hopper (sm_90a) kernels for the sampler's attention layers.
//
// Replaces dhg/kernels/fused_bottleneck.py::fused_bottleneck (att_dense + the
// whole att_layers stack) and ::fused_encoder_layer (one EncoderLayer.attend,
// used for enc3 and enc5). Both Pallas kernels share one body,
// `_encoder_layer`; here both entry points share one __device__ routine,
// `encoder_layer` (encoder_layer.cuh, also used by unet_t4.cu), at the same
// rounding points:
//   * every Dense is a bf16 x bf16 product with f32 accumulation, rounded
//     once to bf16, then `+ bias` in bf16 (two roundings);
//   * logits are rounded to bf16, `* bf16(1/sqrt(hd))`, then `+ mask bias`;
//     the softmax runs in f32, its weights are rounded to bf16, and P.V
//     accumulates in f32 and rounds once;
//   * LayerNorm statistics are f32 and (x - mu) * rsqrt(var + eps) is taken
//     in f32, then rounded; SiLU is computed in f32;
//   * every FiLM multiply and add rounds in bf16.
//
// Design (a simple, correct first version):
//   * one thread block per batch row; stages separated by __syncthreads();
//   * every matrix product runs on the tensor cores through warp-level
//     mma.sync m16n8k16 (bf16 in, f32 accumulate), each warp owning 16x32
//     output tiles and loading its fragments straight from global memory;
//   * intermediates live in a per-row global workspace that the wrapper
//     allocates (torch.empty), so the whole layer, self-attention included,
//     is one launch: a row's K2/V2 are complete after a block-wide barrier.
//   The TPU design kept a layer stack's weights resident in VMEM (about
//   6.1 MB bf16 for the bottleneck); a block has at most 227 KB of shared
//   memory, so here the weights stream from L2/HBM on every use.
//
// What bounds it on an H100: at batch 96-256 the work is ~314 MFLOP per row
// for the bottleneck (bf16 tensor-core bound, 989 TFLOP/s); at batch 1 it is
// the ~6.3 MB of weights (3.35 TB/s). Known weakness: one block per row, so
// batch 1 occupies 1 SM of 132, and fragments come from L1/L2 rather than a
// shared-memory ring fed by TMA (no wgmma yet).
//
// Built by dhg_torch/kernels/build.py (nvcc for sm_90a, one object per .cu,
// linked into one shared library); bound from Python with ctypes
// (dhg_torch/kernels/fused_bottleneck.py).

#include "encoder_layer.cuh"

struct Args {
  const bf16* x;    // [B, T, Cin] (bottleneck) or [B, T, D] (single layer)
  const bf16* aw;   // att_dense weight [D, Cin] (bottleneck only)
  const bf16* ab;   // att_dense bias [D]
  const bf16* pe;   // [T, D] positional embedding
  const bf16* neg;  // [B, 1, L] additive mask bias (mask * -1e9)
  bf16* out;        // [B, T, D]
  bf16* ws;         // [B, ws_elems(T, D, L)] scratch
  int T, Cin, D, H, L, nlayers;
  float scale;      // 1 / sqrt(D / H), rounded to bf16 in the kernel
  LayerW layers[DHG_MAX_LAYERS];
};

__global__ void __launch_bounds__(DHG_THREADS)
    encoder_layer_kernel(const __grid_constant__ Args a) {
  const int row = blockIdx.x;
  const long long td = (long long)a.T * a.D;
  bf16* ws = a.ws + row * ws_elems(a.T, a.D, a.L);
  const LayerCfg c = {a.pe, a.T, a.D, a.H, a.L, a.scale};
  encoder_layer(c, a.layers[0], a.x + row * td, a.out + row * td, ws, a.neg + row * a.L, row);
}

__global__ void __launch_bounds__(DHG_THREADS)
    bottleneck_kernel(const __grid_constant__ Args a) {
  const int row = blockIdx.x;
  const long long td = (long long)a.T * a.D;
  bf16* ws = a.ws + row * ws_elems(a.T, a.D, a.L);
  bf16* X = ws;  // the running activation, [T, D]
  const LayerCfg c = {a.pe, a.T, a.D, a.H, a.L, a.scale};
  dense(a.x + row * (long long)a.T * a.Cin, a.Cin, a.aw, a.ab, X, a.D, a.T, a.D, a.Cin);
  __syncthreads();
  for (int i = 0; i < a.nlayers; ++i) {
    bf16* xout = i == a.nlayers - 1 ? a.out + row * td : X;
    encoder_layer(c, a.layers[i], X, xout, ws, a.neg + row * a.L, row);
  }
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
  a.T = T; a.Cin = D; a.D = D; a.H = H; a.L = L; a.nlayers = 1;
  a.scale = (float)(1.0 / sqrt((double)(D / H)));
  fill_layers(a.layers, ops, 1);
  encoder_layer_kernel<<<B, DHG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// att_dense + nlayers EncoderLayers. Returns cudaGetLastError() after the launch.
int dhg_fused_bottleneck(const void* x, const void* aw, const void* ab, const void* pe,
                         const void* neg, const void* const* ops, int nlayers, void* out,
                         void* ws, int B, int T, int Cin, int D, int H, int L, void* stream) {
  if (nlayers < 1 || nlayers > DHG_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.aw = static_cast<const bf16*>(aw);
  a.ab = static_cast<const bf16*>(ab);
  a.pe = static_cast<const bf16*>(pe);
  a.neg = static_cast<const bf16*>(neg);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<bf16*>(ws);
  a.T = T; a.Cin = Cin; a.D = D; a.H = H; a.L = L; a.nlayers = nlayers;
  a.scale = (float)(1.0 / sqrt((double)(D / H)));
  fill_layers(a.layers, ops, nlayers);
  bottleneck_kernel<<<B, DHG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
