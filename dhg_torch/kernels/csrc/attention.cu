// Hand-written Hopper (sm_90a) kernel: scaled-dot-product attention, forward.
//
// Replaces dhg/kernels/fused_attention.py::fused_attention (`_attn_kernel`):
//   out = softmax(Q K^T * (1/sqrt(D)) + mask * -1e9) V   per (batch, head)
// at the Pallas kernel's rounding points: Q K^T accumulates in f32 and stays
// f32; the scale 1/sqrt(D) is an f32 computed in f32; the mask bias is f32;
// the row max, exp, sum and division run in f32; the weights are normalised
// (e / sum) before they are rounded to V's type; P V accumulates in f32 and
// is rounded once to Q's type. No online (flash) softmax: rescaling an
// unnormalised bf16 P would move a rounding point.
//
// bfloat16 (the training config) runs on the tensor cores: one block of 4
// warps per (batch * head, 64 query rows), each warp owning 16 query rows.
// Q, K and V of that (b, h) are staged once in shared memory as bf16 with
// 16-byte cp.async (rows of round16(D) + 8 elements: the 8-element pad puts
// the 8 rows an ldmatrix reads in 8 different bank groups); keys are padded
// to a multiple of 16 with zero rows and padded keys are kept out of the max
// and the sum; D is padded to a multiple of 16 with zero columns. Fragments
// are read with ldmatrix (.trans for V) into mma.sync m16n8k16 bf16 -> f32.
// Two ways to get the normalised weights, both with the same rounding points,
// chosen by Tk:
//   * registers (Tk <= 256): the warp's [16, Tk_pad] f32 logits stay in
//     registers (NK16 key blocks of 16, a template parameter), the row max
//     and sum are exact over them, then P is packed to bf16 A fragments
//     straight from the logit registers. At the training shapes this was
//     13-14% faster than two passes (Tk 120 and 240, H100, PERF.md PR 4);
//   * two passes (Tk > 256, up to what fits in shared memory): pass 1
//     computes Q K^T block by block for the row max and the f32 sum (a
//     running max, the sum rescaled in f32); pass 2 recomputes Q K^T,
//     normalises and runs P V.
// float32 (f32 configs, on no timed path) keeps the CUDA-core loop of the
// first version: TF32 tensor cores would miss the 1e-4 f32 bar. One warp
// walks one query row at a time, K/V widened to f32 in shared memory.
//
// What bounds it on an H100: the work is 4 B H Tq Tk D flops on bf16 inputs
// (989 TFLOP/s on the tensor cores) against Q, K, V, out and the mask once
// (3.35 TB/s); at the training shapes (Tq, Tk <= 240, D <= 64) that is the
// bytes. Each block re-reads its (b, h)'s K and V from L2 (Tq / 64 blocks
// per head) and pays one cp.async round trip before any math.
//
// Limits: bf16 needs D <= 128 and 2 (64 + 2 round16(Tk)) (round16(D) + 8)
// bytes of shared memory <= 232,448 (Tk up to 768 at D = 64); f32 needs
// 4 (Tk (2D + 1) + 8 (D + Tk)) <= 232,448 (Tk up to ~420 at D = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "warp_mma.cuh"

namespace {

using namespace wmma16;

constexpr int kMaxSmem = 232448;

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kQRows = 64;      // query rows per block
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kMaxD = 128;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

inline long long mma_smem_bytes(int Tk, int D) {
  return 2LL * (kQRows + 2LL * round16(Tk)) * (round16(D) + 8);
}

// rows x D of src (row stride D) into dst (row stride ld), zero-filling the
// columns D .. round16(D) and the rows rows .. prows.
__device__ void stage(bf16* dst, int ld, const bf16* src, int rows, int prows, int D) {
  const int dp = round16(D);
  if ((D & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int cpr = D >> 3;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      cp_async16(dst + r * ld + c, src + (long long)r * D + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      dst[r * ld + i - r * D] = src[i];
    }
  }
  const bf16 z = rn(0.f);
  const int padc = dp - D;
  for (int i = threadIdx.x; i < rows * padc; i += blockDim.x) {
    const int r = i / padc;
    dst[r * ld + D + i - r * padc] = z;
  }
  for (int i = threadIdx.x; i < (prows - rows) * dp; i += blockDim.x) {
    const int r = i / dp;
    dst[(rows + r) * ld + i - r * dp] = z;
  }
}

// q [BH, Tq, D], k/v [BH, Tk, D], mask [B, Tk] f32 (1.0 = padded key) or
// null, out [BH, Tq, D]. Grid (ceil(Tq / 64), B * H). NK16 > 0: logits in
// registers, Tk <= 16 NK16; NK16 == 0: two passes. DM >= round16(D) sizes
// the Q-fragment and output registers (64 or kMaxD).
template <int NK16, int DM>
__global__ void __launch_bounds__(kMmaThreads)
    attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ mask,
                         bf16* __restrict__ out, int H, int Tq, int Tk, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.y, q0 = blockIdx.x * kQRows;
  const int dp = round16(D), ld = dp + 8, tkp = round16(Tk), nkb = tkp >> 4, dk = dp >> 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kQRows * ld;
  bf16* Vs = Ks + tkp * ld;
  const int qrows = min(kQRows, Tq - q0);
  stage(Qs, ld, q + ((long long)bh * Tq + q0) * D, qrows, kQRows, D);
  stage(Ks, ld, k + (long long)bh * Tk * D, Tk, tkp, D);
  stage(Vs, ld, v + (long long)bh * Tk * D, Tk, tkp, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3, m0 = warp * 16;
  if (m0 >= qrows) return;
  const float* mrow = mask ? mask + (long long)(bh / H) * Tk : nullptr;

  uint32_t qf[DM / 16][4];
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk)
    if (kk < dk) load_a(qf[kk], Qs, ld, m0, kk * 16, kQRows);

  // f32 logits of one 16-key block: s[0] keys kb*16 .. +7, s[1] keys +8 .. +15.
  auto logits = [&](int kb, float (*s)[4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      if (kk < dk) {
        uint32_t b[4];
        load_b_nk(b, Ks, ld, kb * 16, kk * 16);
        mma(s[0], qf[kk], b[0], b[1]);
        mma(s[1], qf[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * 16 + j * 8 + 2 * tg + (e & 1);
        float lg = -INFINITY;
        if (key < Tk) {
          lg = __fmul_rn(s[j][e], scale);
          if (mrow) lg = __fadd_rn(lg, __fmul_rn(mrow[key], -1e9f));
        }
        s[j][e] = lg;
      }
  };

  float o[DM / 8][4];
#pragma unroll
  for (int j = 0; j < DM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // P V for one 16-key block whose normalised weights are p (f32).
  auto pv = [&](int kb, float (*p)[4]) {
    const uint32_t a[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                           pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
#pragma unroll
    for (int dd = 0; dd < DM / 16; ++dd) {
      if (dd < dk) {
        uint32_t b[4];
        load_b_kn(b, Vs, ld, dd * 16, kb * 16);
        mma(o[2 * dd], a, b[0], b[1]);
        mma(o[2 * dd + 1], a, b[2], b[3]);
      }
    }
  };

  // Row max and sum for rows g (index 0) and g + 8 (index 1).
  float mx[2], sum[2];
  if constexpr (NK16 > 0) {
    float s[NK16][2][4];
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int kb = 0; kb < NK16; ++kb) {
      if (kb < nkb) {
        logits(kb, s[kb]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[kb][j][0], s[kb][j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[kb][j][2], s[kb][j][3]));
        }
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    sum[0] = sum[1] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NK16; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[kb][j][e] = expf(s[kb][j][e] - mx[e >> 1]);
            sum[e >> 1] += s[kb][j][e];
          }
      }
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
#pragma unroll
    for (int kb = 0; kb < NK16; ++kb) {
      if (kb < nkb) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kb][j][e] = s[kb][j][e] / sum[e >> 1];
        pv(kb, s[kb]);
      }
    }
  } else {
    mx[0] = mx[1] = -INFINITY;
    sum[0] = sum[1] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      float s[2][4];
      logits(kb, s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float bm = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                               fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        const float nm = fmaxf(mx[r], bm);
        if (nm == -INFINITY) continue;  // this lane has seen only padded keys
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) add += expf(s[j][2 * r] - nm) + expf(s[j][2 * r + 1] - nm);
        sum[r] = (mx[r] == -INFINITY ? 0.f : sum[r] * expf(mx[r] - nm)) + add;
        mx[r] = nm;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // merge the quad's (max, sum) pairs
      const float m = quad_max(mx[r]);
      sum[r] = quad_sum(mx[r] == -INFINITY ? 0.f : sum[r] * expf(mx[r] - m));
      mx[r] = m;
    }
    for (int kb = 0; kb < nkb; ++kb) {
      float s[2][4];
      logits(kb, s);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e >> 1]) / sum[e >> 1];
      pv(kb, s);
    }
  }

  const int r0 = q0 + m0 + g;
#pragma unroll
  for (int j = 0; j < DM / 8; ++j) {
    const int c = j * 8 + 2 * tg;
    if (j < 2 * dk && c < D) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + half * 8;
        if (r >= Tq) continue;
        bf16* dst = out + ((long long)bh * Tq + r) * D + c;
        if ((D & 1) == 0) {  // c + 1 < D: store the pair at once
          const uint32_t v2 = pack(o[j][2 * half], o[j][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(dst) = v2;
        } else {
          dst[0] = rn(o[j][2 * half]);
          if (c + 1 < D) dst[1] = rn(o[j][2 * half + 1]);
        }
      }
    }
  }
}

// ---- float32: CUDA cores --------------------------------------------------

constexpr int kRows = 64;      // query rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline long long f32_smem_bytes(int Tk, int D) {
  return 4LL * ((long long)Tk * (2 * D + 1) + (long long)kWarps * (D + Tk));
}

__global__ void __launch_bounds__(kThreads)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ mask,
                         float* __restrict__ out, int H, int Tq, int Tk, int D, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int ldk = D + 1;
  float* Ks = smem;                 // [Tk, D + 1]
  float* Vs = Ks + Tk * ldk;        // [Tk, D]
  float* Qw = Vs + Tk * D;          // [kWarps, D]: the warp's query row
  float* Ww = Qw + kWarps * D;      // [kWarps, Tk]: the warp's logits, then weights
  const float* kb = k + (long long)bh * Tk * D;
  const float* vb = v + (long long)bh * Tk * D;
  for (int i = threadIdx.x; i < Tk * D; i += kThreads) {
    const int l = i / D;
    Ks[i + l] = kb[i];  // row l starts at l * (D + 1)
    Vs[i] = vb[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qs = Qw + warp * D;
  float* ws = Ww + warp * Tk;
  const float* mrow = mask ? mask + (long long)(bh / H) * Tk : nullptr;
  const int r_end = min(Tq, (int)(blockIdx.x + 1) * kRows);
  for (int r = blockIdx.x * kRows + warp; r < r_end; r += kWarps) {
    const long long row = (long long)bh * Tq + r;
    for (int d = lane; d < D; d += 32) qs[d] = q[row * D + d];
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
    for (int l = lane; l < Tk; l += 32) ws[l] = ws[l] / sum;
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < Tk; ++l) acc = fmaf(ws[l], Vs[l * D + d], acc);
      out[row * D + d] = acc;
    }
    __syncwarp();
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = e == cudaSuccess;
  return e;
}

template <int NK16, int DM>
int launch_mma(const void* q, const void* k, const void* v, const float* mask, void* out, int B,
               int H, int Tq, int Tk, int D, float scale, long long bytes, cudaStream_t stream) {
  static bool attr_set = false;
  const cudaError_t e = allow_smem(attention_mma_kernel<NK16, DM>, attr_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + kQRows - 1) / kQRows, B * H);
  attention_mma_kernel<NK16, DM><<<grid, kMmaThreads, (size_t)bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, static_cast<bf16*>(out), H, Tq, Tk, D, scale);
  return (int)cudaGetLastError();
}

template <int DM>
int dispatch(const void* q, const void* k, const void* v, const float* m, void* out, int B, int H,
             int Tq, int Tk, int D, float scale, long long bytes, cudaStream_t s) {
  if (Tk > 256) return launch_mma<0, DM>(q, k, v, m, out, B, H, Tq, Tk, D, scale, bytes, s);
  if (Tk <= 64) return launch_mma<4, DM>(q, k, v, m, out, B, H, Tq, Tk, D, scale, bytes, s);
  if (Tk <= 128) return launch_mma<8, DM>(q, k, v, m, out, B, H, Tq, Tk, D, scale, bytes, s);
  return launch_mma<16, DM>(q, k, v, m, out, B, H, Tq, Tk, D, scale, bytes, s);
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes): is_bf16 selects the tensor-core
// kernel's layout, else the f32 kernel's.
long long dhg_attention_smem_bytes(int Tk, int D, int is_bf16) {
  return is_bf16 ? mma_smem_bytes(Tk, D) : f32_smem_bytes(Tk, D);
}

// softmax(q k^T / sqrt(D) + mask * -1e9) v. is_bf16 selects bfloat16 (1)
// or float32 (0) for q, k, v and out; mask is f32 [B, Tk] or null. Returns
// cudaGetLastError() after the launch.
int dhg_fused_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                        int B, int H, int Tq, int Tk, int D, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float scale = 1.0f / sqrtf((float)D);
  const long long bytes = dhg_attention_smem_bytes(Tk, D, is_bf16);
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (!is_bf16) {
    static bool attr_set = false;
    const cudaError_t e = allow_smem(attention_f32_kernel, attr_set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Tq + kRows - 1) / kRows, B * H);
    attention_f32_kernel<<<grid, kThreads, (size_t)bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        m, static_cast<float*>(out), H, Tq, Tk, D, scale);
    return (int)cudaGetLastError();
  }
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
  if (round16(D) <= 64) return dispatch<64>(q, k, v, m, out, B, H, Tq, Tk, D, scale, bytes, s);
  return dispatch<kMaxD>(q, k, v, m, out, B, H, Tq, Tk, D, scale, bytes, s);
}

}  // extern "C"
