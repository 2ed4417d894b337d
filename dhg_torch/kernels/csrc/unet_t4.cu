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
//   * in a ConvBlock, SiLU is computed in f32; the FiLM multiplies and adds,
//     the fc's `+ bias` (after its own rounding) and `h + skip` round in bf16;
//   * the pool's pair mean is taken in f32 and rounded once;
//   * the EncoderLayers are encoder_layer.cuh's routine (the rounding points
//     listed in encoder_layer.cu).
//
// Design (a simple, correct first version):
//   * one thread block per batch row; stages separated by __syncthreads();
//     a per-row global workspace that the wrapper allocates (torch.empty);
//   * each k3 conv is ONE mma.sync GEMM with K = 3*Cin: the row is copied
//     with a zero row at each end into P [T4 + 2, Cin], so row t of the
//     GEMM's A operand is the 3*Cin contiguous values P[t..t+2] =
//     x[t-1..t+1], and the weights come as [Co, 3*Cin] rows (column
//     k*Cin + i multiplies x[t + k - 1, i]);
//   * enc5 and the bottleneck run encoder_layer.cuh's routine, as the
//     sampler's other two kernels do.
//   The Pallas kernel kept the region's weights in VMEM; here they (about
//   10 MB of bf16 at the canonical widths) stream from L2/HBM on every use.
//
// What bounds it on an H100 (canonical model, T4 = 98): ~0.71 GFLOP a row,
// so bf16 tensor-core bound at batch 96 (~0.069 ms at 989 TFLOP/s); at batch
// 1 the ~10 MB of weights (~3.0 us at 3.35 TB/s). Known weakness: one block
// per row, so batch 1 runs on 1 SM of 132, fragments come from L1/L2 with
// 4-byte loads, and there is no TMA or wgmma yet.

#include "encoder_layer.cuh"

// ConvBlock operand order, as in dhg's _PER_CONV list: the k3 convs
// conv_skip, conv1, conv2 as [Co, 3*Cin] rows, each with its bias; fc
// [Co, Co] (torch Linear layout) and bias; FiLM gamma/beta [Co/2], [Co], [Co].
enum {
  WSKIP, BSKIP, CW1, CB1, CW2, CB2, WFC, BFC, CG1, CBE1, CG2, CBE2, CG3, CBE3, PER_CONV
};

struct ConvW {
  const bf16* p[PER_CONV];
};

struct T4Args {
  const bf16* x;     // [B, T4, C2]
  const bf16* neg;   // [B, 1, L] additive mask bias
  const bf16* pe4;   // [T4, C3] enc5 positional embedding
  const bf16* pe8;   // [T4 / 2, D] bottleneck positional embedding
  const bf16* aw;    // att_dense [D, C3]
  const bf16* ab;    // [D]
  const bf16* sk3w;  // skip_conv3 [D, 3 * C3]
  const bf16* sk3b;  // [D]
  ConvW enc4, dec3;
  LayerW enc5;
  LayerW att[DHG_MAX_LAYERS];
  bf16* out;  // [B, T4, C3]
  bf16* ws;   // [B, t4_ws(...).total] scratch
  int T4, C2, C3, D, H5, H8, L, nlayers;
  float scale5, scale8;  // 1 / sqrt(head dim) of enc5 and of the bottleneck
};

// Per-row scratch, in bf16 elements: offsets of each region and the total.
// Every region is a multiple of 16 elements when the widths are.
struct T4Ws {
  long long h3, x8, xin, p, sk, hh, hf, el, total;
};

__host__ __device__ inline T4Ws t4_ws(int T4, int C2, int C3, int D, int L) {
  const int T8 = T4 / 2;
  int cp = C2 > C3 ? C2 : C3;
  cp = cp > D ? cp : D;
  const long long e5 = ws_elems(T4, C3, L), e8 = ws_elems(T8, D, L);
  T4Ws w;
  long long o = 0;
  w.h3 = o;  o += (long long)T4 * C3;        // enc4, then enc5 output
  w.x8 = o;  o += (long long)T8 * D;         // the bottleneck's activation
  w.xin = o; o += (long long)T4 * D;         // pooled h3, later dec3's input
  w.p = o;   o += (long long)(T4 + 2) * cp;  // zero-padded conv input
  w.sk = o;  o += (long long)T4 * (C3 > D ? C3 : D);  // a conv skip
  w.hh = o;  o += (long long)T4 * (C3 / 2);  // conv1 output
  w.hf = o;  o += (long long)T4 * C3;        // conv2 output
  w.el = o;  o += e5 > e8 ? e5 : e8;         // encoder_layer's scratch
  w.total = (o + 15) & ~15LL;
  return w;
}

// P[(t + 1) * C + c] = x[t * C + c] for t < T (SiLU'd in f32 when act), with
// zero rows at t = -1 and t = T: the k3 conv's 'same' padding.
static __device__ void pad_rows(bf16* P, const bf16* x, int T, int C, bool act) {
  const int n = (T + 2) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = 0.f;
    if (i >= C && i < n - C) {
      v = bf(x[i - C]);
      if (act) v = v * (1.0f / (1.0f + expf(-v)));
    }
    P[i] = rn(v);
  }
}

// Y [T, Co] = bf16(conv(x) + b), then bf16(bf16(y * g) + be) when g is given.
// One GEMM over the padded rows P [T + 2, Cin] with K = 3 * Cin.
static __device__ void conv3(const bf16* P, int Cin, const bf16* W, const bf16* b, const bf16* g,
                             const bf16* be, bf16* Y, int T, int Co) {
  const int K = 3 * Cin;
  block_gemm(P, Cin, W, K, 1, T, Co, K, K, [=](int m, int n, float acc) {
    float y = bf(rn(acc + bf(b[n])));
    if (g) {
      y = bf(rn(y * bf(g[n])));
      y = bf(rn(y + bf(be[n])));
    }
    Y[(long long)m * Co + n] = rn(y);
  });
}

struct ConvWs {
  bf16 *P, *SK, *HH, *HF;
};

// One ConvBlock (dhg's _conv_block_packed) on one row: x [T, Cin] ->
// out [T, Co]. out must not alias x or the scratch.
static __device__ void conv_block(const ConvW& w, const bf16* x, bf16* out, const ConvWs& s,
                                  int T, int Cin, int Co) {
  const int Ch = Co / 2;
  pad_rows(s.P, x, T, Cin, false);
  __syncthreads();
  conv3(s.P, Cin, w.p[WSKIP], w.p[BSKIP], nullptr, nullptr, s.SK, T, Co);
  __syncthreads();
  pad_rows(s.P, x, T, Cin, true);
  __syncthreads();
  conv3(s.P, Cin, w.p[CW1], w.p[CB1], w.p[CG1], w.p[CBE1], s.HH, T, Ch);
  __syncthreads();
  pad_rows(s.P, s.HH, T, Ch, true);
  __syncthreads();
  conv3(s.P, Ch, w.p[CW2], w.p[CB2], w.p[CG2], w.p[CBE2], s.HF, T, Co);
  __syncthreads();
  silu(s.HF, s.HF, T * Co);
  __syncthreads();
  const bf16 *bfc = w.p[BFC], *g3 = w.p[CG3], *be3 = w.p[CBE3], *sk = s.SK;
  block_gemm(s.HF, Co, w.p[WFC], Co, 1, T, Co, Co, Co, [=](int m, int n, float acc) {
    const long long o = (long long)m * Co + n;
    float y = bf(rn(bf(rn(acc)) + bf(bfc[n])));
    y = bf(rn(y * bf(g3[n])));
    y = bf(rn(y + bf(be3[n])));
    out[o] = rn(y + bf(sk[o]));
  });
  __syncthreads();
}

__global__ void __launch_bounds__(DHG_THREADS) unet_t4_kernel(const __grid_constant__ T4Args a) {
  const int row = blockIdx.x;
  const int T4 = a.T4, T8 = T4 / 2, C3 = a.C3, D = a.D;
  const T4Ws o = t4_ws(T4, a.C2, C3, D, a.L);
  bf16* ws = a.ws + row * o.total;
  bf16 *H3 = ws + o.h3, *X8 = ws + o.x8, *XIN = ws + o.xin, *EL = ws + o.el;
  const ConvWs cs = {ws + o.p, ws + o.sk, ws + o.hh, ws + o.hf};
  const bf16* neg = a.neg + (long long)row * a.L;

  // enc4 ConvBlock, then enc5 EncoderLayer in place: h3 [T4, C3].
  conv_block(a.enc4, a.x + (long long)row * T4 * a.C2, H3, cs, T4, a.C2, C3);
  const LayerCfg c5 = {a.pe4, T4, C3, a.H5, a.L, a.scale5};
  encoder_layer(c5, a.enc5, H3, H3, EL, neg, row);

  // Window-2 mean, att_dense, then the attention stack at T/8.
  for (int i = threadIdx.x; i < T8 * C3; i += blockDim.x) {
    const int t = i / C3, c = i % C3;
    XIN[i] = rn((bf(H3[2 * t * C3 + c]) + bf(H3[(2 * t + 1) * C3 + c])) * 0.5f);
  }
  __syncthreads();
  dense(XIN, C3, a.aw, a.ab, X8, D, T8, D, C3);
  __syncthreads();
  const LayerCfg c8 = {a.pe8, T8, D, a.H8, a.L, a.scale8};
  for (int i = 0; i < a.nlayers; ++i) encoder_layer(c8, a.att[i], X8, X8, EL, neg, row);

  // Nearest upsample + skip_conv3(h3), then dec3 ConvBlock back at T/4.
  pad_rows(cs.P, H3, T4, C3, false);
  __syncthreads();
  conv3(cs.P, C3, a.sk3w, a.sk3b, nullptr, nullptr, cs.SK, T4, D);
  __syncthreads();
  for (int i = threadIdx.x; i < T4 * D; i += blockDim.x) {
    const int t = i / D, c = i % D;
    XIN[i] = rn(bf(X8[(t / 2) * D + c]) + bf(cs.SK[i]));
  }
  __syncthreads();
  conv_block(a.dec3, XIN, a.out + (long long)row * T4 * C3, cs, T4, D, C3);
}

extern "C" {

// Scratch elements (bf16) per batch row; the wrapper allocates B times this.
long long dhg_unet_t4_workspace_elems(int T4, int C2, int C3, int D, int L) {
  return t4_ws(T4, C2, C3, D, L).total;
}

// The whole T/4..T/8 region. `ops` holds the operands in dhg's order: x, neg,
// pe4, pe8, att_w, att_b, skip3_w, skip3_b, then PER_CONV enc4 operands,
// PER_LAYER enc5 operands, PER_CONV dec3 operands and PER_LAYER for each of
// the nlayers attention layers. Returns cudaGetLastError() after the launch.
int dhg_fused_unet_t4(const void* const* ops, int nlayers, void* out, void* ws, int B, int T4,
                      int C2, int C3, int D, int H5, int H8, int L, void* stream) {
  if (nlayers < 1 || nlayers > DHG_MAX_LAYERS) return (int)cudaErrorInvalidValue;
  auto op = [&](int i) { return static_cast<const bf16*>(ops[i]); };
  T4Args a = {};
  a.x = op(0); a.neg = op(1); a.pe4 = op(2); a.pe8 = op(3);
  a.aw = op(4); a.ab = op(5); a.sk3w = op(6); a.sk3b = op(7);
  int k = 8;
  for (int i = 0; i < PER_CONV; ++i) a.enc4.p[i] = op(k++);
  fill_layers(&a.enc5, ops + k, 1);
  k += PER_LAYER;
  for (int i = 0; i < PER_CONV; ++i) a.dec3.p[i] = op(k++);
  fill_layers(a.att, ops + k, nlayers);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<bf16*>(ws);
  a.T4 = T4; a.C2 = C2; a.C3 = C3; a.D = D; a.H5 = H5; a.H8 = H8; a.L = L;
  a.nlayers = nlayers;
  a.scale5 = (float)(1.0 / sqrt((double)(C3 / H5)));
  a.scale8 = (float)(1.0 / sqrt((double)(D / H8)));
  unet_t4_kernel<<<B, DHG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
