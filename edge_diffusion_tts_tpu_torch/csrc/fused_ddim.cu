// The diffusion decoder's sampling loops over EdgeDiffusionDecoder, each
// launched from one C host function with no return to Python between
// launches:
//   edt_fused_ddim  the few-step eta=0 DDIM loop; replaces the TPU kernel
//                   edge_diffusion_tts_tpu/ops/fused_denoise.py::_denoise_kernel
//   edt_fused_ddpm  full-schedule ancestral DDPM (1000 steps); replaces
//                   fused_denoise.py::_ddpm_kernel
// Both run the same decoder step (decoder_step below).  The TPU kernels run
// the whole loop in one launch with every weight resident in VMEM.  On the
// H100 the ~6 MB of f32 weights do not fit a block's 227 KB of shared
// memory, so a step is a fixed sequence of hand-written kernels, each over
// all B*T rows:
//   in_proj GEMM (+bias +positional row)
//   L x [ AdaLN-RMS row norm -> qkv GEMM -> banded self-attention (|i-j|<=w,
//         key<T) -> attn-proj GEMM (+bias +residual) -> RMS row norm ->
//         cross-q GEMM -> cross-attention over the precomputed K/V (key<S)
//         -> cross-out GEMM (+residual) -> AdaLN-RMS row norm -> fc1 GEMM
//         with a SwiGLU epilogue -> fc2 GEMM (+bias +residual) ]
//   LayerNorm -> out_proj GEMM (+bias)
// followed by the sampler's update kernel: DDIM with x0 clip, or DDPM with a
// Gaussian draw per element and step.
// What bounds it: at the flagship shape a decoder forward is ~1.7 GFLOP of
// float32 work, so the loops are bound by float32 arithmetic (no TF32, to
// hold the 1e-4 parity bar), at small per-kernel grids: 4 DDIM steps 0.103 ms,
// 1000 DDPM steps 25.8 ms at 67 TFLOP/s.  Every product is a hand-written
// float32 FMA kernel: a shared-memory-tiled GEMM (32x64 output tile, 4x4 per
// thread) and the banded attention of attention.cuh.  Weights stream from L2
// (50 MB holds them all, and DDPM's 10 MB AdaLN table); activations stay in
// one workspace.  One persistent launch, a CUDA graph, or wgmma/TMA tiles
// are later work.
//
// DDPM noise: the TPU kernel draws from the core's hardware PRNG.  Here it
// is Philox4x32-10 (Salmon et al., SC'11; Random123's constants), written
// out below: counter (flat element index in [B, T, M], step index, 0, 0),
// 64-bit key from the caller; words 0 and 1 become two uniforms in [0, 1)
// (their top 23 bits), and Box-Muller with log1p(-u1), finite at u1 = 0,
// turns them into one normal.  ops/fused_denoise.py repeats the same integer
// arithmetic in torch (philox4x32_10), bit for bit.
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

constexpr int GBM = 32;   // output rows per block
constexpr int GBN = 64;   // output columns per block
constexpr int GBK = 16;   // reduction depth per shared-memory stage
constexpr int GTHREADS = 128;

// C[m, n] = sum_k A[m, k] * W[n, k] + bias[n] + pos[m % pos_rows, n] + R[m, n]
// (each term only where its pointer is non-null).  A [M, K], W [N, K] (the
// torch Linear layout), C and R [M, N], all row-major and contiguous.  R may
// alias C: each element is read and written by the same thread.
// SWIGLU: W has 2*N rows (value rows first, then gate rows) and
// C[m, n] = (A W[n] + bias[n]) * silu(A W[N + n] + bias[N + n]).
template <bool SWIGLU>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
            const float* __restrict__ bias, const float* __restrict__ pos, int pos_rows,
            const float* R, float* C, int M, int N, int K) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Ws[GBK][GBN + 4];
  __shared__ float Gs[SWIGLU ? GBK : 1][GBN + 4];

  const int m0 = blockIdx.y * GBM;
  const int n0 = blockIdx.x * GBN;
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each

  float acc[4][4];
  float accg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = accg[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int e = threadIdx.x; e < GBM * GBK; e += GTHREADS) {
      const int mm = e / GBK, kk = e % GBK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[(long long)gm * K + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < GBN * GBK; e += GTHREADS) {
      const int nn = e / GBK, kk = e % GBK;
      const int gn = n0 + nn, gk = k0 + kk;
      const bool ok = gn < N && gk < K;
      Ws[kk][nn] = ok ? W[(long long)gn * K + gk] : 0.f;
      if constexpr (SWIGLU) Gs[kk][nn] = ok ? W[(long long)(N + gn) * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float av[4], wv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[j] = Ws[kk][tx * 4 + j];
        if constexpr (SWIGLU) gv[j] = Gs[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
          if constexpr (SWIGLU) accg[i][j] = fmaf(av[i], gv[j], accg[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float c = acc[i][j];
      if (bias) c += bias[gn];
      if constexpr (SWIGLU) {
        float g = accg[i][j];
        if (bias) g += bias[N + gn];
        c = c * (g / (1.f + expf(-g)));
      }
      if (pos) c += pos[(long long)(gm % pos_rows) * N + gn];
      const long long idx = (long long)gm * N + gn;
      if (R) c = R[idx] + c;
      C[idx] = c;
    }
  }
}

int gemm(const float* A, const float* W, const float* bias, const float* pos, int pos_rows,
         const float* R, float* C, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<false><<<grid, GTHREADS, 0, st>>>(A, W, bias, pos, pos_rows, R, C, M, N, K);
  return (int)cudaGetLastError();
}

int gemm_swiglu(const float* A, const float* W, const float* bias, float* C, int M, int N,
                int K, cudaStream_t st) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<true><<<grid, GTHREADS, 0, st>>>(A, W, bias, nullptr, 1, nullptr, C, M, N, K);
  return (int)cudaGetLastError();
}

constexpr int NORM_WARPS = 4;

// out[m, :] = norm(x[m, :]) * scale + shift (shift optional), one warp per
// row.  RMS: x * 1/sqrt(mean(x^2) + eps).  LN: (x - mean) / sqrt(var + eps).
template <bool LN>
__global__ void __launch_bounds__(NORM_WARPS * 32)
rownorm_kernel(const float* __restrict__ x, float* __restrict__ out,
               const float* __restrict__ scale, const float* __restrict__ shift, int M,
               int N, float eps) {
  const int row = blockIdx.x * NORM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (long long)row * N;
  float mu = 0.f;
  if (LN) {
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += xr[c];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    mu = s / N;
  }
  float ss = 0.f;
  for (int c = lane; c < N; c += 32) {
    const float d = xr[c] - mu;
    ss = fmaf(d, d, ss);
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = 1.f / sqrtf(ss / N + eps);
  float* orow = out + (long long)row * N;
  for (int c = lane; c < N; c += 32) {
    float y = (xr[c] - mu) * inv * scale[c];
    if (shift) y += shift[c];
    orow[c] = y;
  }
}

template <bool LN>
int rownorm(const float* x, float* out, const float* scale, const float* shift, int M, int N,
            cudaStream_t st) {
  const int grid = (M + NORM_WARPS - 1) / NORM_WARPS;
  rownorm_kernel<LN><<<grid, NORM_WARPS * 32, 0, st>>>(x, out, scale, shift, M, N, 1e-6f);
  return (int)cudaGetLastError();
}

// eta=0 DDIM update with x0 clip; coef = (sqrt ab_t, sqrt(1-ab_t),
// sqrt ab_prev, sqrt(1-ab_prev)).  x is updated in place, x0 written out.
__global__ void ddim_kernel(float* __restrict__ x, const float* __restrict__ pred,
                            float* __restrict__ x0_out, const float* __restrict__ coef,
                            long long n, int v_pred, float clip) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float sab = coef[0], s1m = coef[1], sabp = coef[2], s1mp = coef[3];
  const float xv = x[idx];
  const float p = pred[idx];
  const float eps = v_pred ? s1m * xv + sab * p : p;
  const float x0 = fminf(fmaxf((xv - s1m * eps) / sab, -clip), clip);
  x[idx] = sabp * x0 + s1mp * eps;
  x0_out[idx] = x0;
}

// Philox4x32-10 on counter c with key (k0, k1), in place.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float unit_uniform(uint32_t w) {
  return (float)(w >> 9) * (1.0f / 8388608.0f);  // [0, 1), exact in float32
}

// Ancestral DDPM update for loop index `step`; coef = (sqrt ab, sqrt(1-ab),
// 1/sqrt(alpha), beta/sqrt(1-ab), sigma), sigma = 0 at t = 0:
//   eps = pred (or sqrt(1-ab) x + sqrt(ab) pred for v);
//   x <- 1/sqrt(alpha) (x - beta/sqrt(1-ab) eps) + sigma z.
// z is noise[b, step] when noise is given ([B, steps, T*M]), else a Philox
// normal.  Each product and sum is rounded on its own (no FMA contraction),
// in the plain version's order.
__global__ void ddpm_kernel(float* __restrict__ x, const float* __restrict__ pred,
                            const float* __restrict__ coef, const float* __restrict__ noise,
                            int step, int steps, long long per_b, long long n, int v_pred,
                            uint32_t k0, uint32_t k1) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float xv = x[idx];
  const float p = pred[idx];
  const float eps = v_pred ? __fadd_rn(__fmul_rn(coef[1], xv), __fmul_rn(coef[0], p)) : p;
  const float mean = __fmul_rn(coef[2], __fsub_rn(xv, __fmul_rn(coef[3], eps)));
  float z;
  if (noise) {
    const long long b = idx / per_b;
    z = noise[(b * steps + step) * per_b + (idx - b * per_b)];
  } else {
    uint32_t c[4] = {(uint32_t)idx, (uint32_t)step, 0u, 0u};
    philox4x32_10(c, k0, k1);
    const float u1 = unit_uniform(c[0]), u2 = unit_uniform(c[1]);
    z = __fmul_rn(sqrtf(__fmul_rn(-2.0f, log1pf(-u1))),
                  cosf(__fmul_rn(6.283185307179586f, u2)));
  }
  x[idx] = __fadd_rn(mean, __fmul_rn(coef[4], z));
}

// The decoder's step-invariant weights and per-call buffers (see
// edt_fused_ddim for the layouts).
struct Decoder {
  const float *pos, *in_w, *in_b, *n2w, *qkv_w, *proj_w, *proj_b, *cq_w, *ckv, *co_w;
  const float *fc1_w, *fc1_b, *fc2_w, *fc2_b, *fn_s, *fn_b, *out_w, *out_b;
  int B, T, S, M, H, L, F;
  float *h, *hn, *qkv, *ao, *cq, *f, *pred, *x;  // workspace
  edt::AttnArgs self_attn, cross;
};

Decoder make_decoder(float* work, const float* pos, const float* in_w, const float* in_b,
                     const float* n2w, const float* qkv_w, const float* proj_w,
                     const float* proj_b, const float* cq_w, const float* ckv, const float* co_w,
                     const float* fc1_w, const float* fc1_b, const float* fc2_w,
                     const float* fc2_b, const float* fn_s, const float* fn_b, const float* out_w,
                     const float* out_b, int B, int T, int S, int M, int H, int heads, int L,
                     int F, int window) {
  Decoder d{pos,   in_w,  in_b,  n2w,  qkv_w, proj_w, proj_b, cq_w, ckv, co_w,
            fc1_w, fc1_b, fc2_w, fc2_b, fn_s,  fn_b,   out_w,  out_b, B,   T,
            S,     M,     H,     L,    F};
  const long long rows = (long long)B * T;
  const long long RH = rows * H;
  d.h = work;
  d.hn = d.h + RH;
  d.qkv = d.hn + RH;
  d.ao = d.qkv + 3 * RH;
  d.cq = d.ao + RH;
  d.f = d.cq + RH;
  d.pred = d.f + rows * F;
  d.x = d.pred + rows * M;
  const int dh = H / heads;
  const float scale = (float)pow((double)dh, -0.5);

  edt::AttnArgs& sa = d.self_attn;
  sa.q = d.qkv;
  sa.k = d.qkv + H;
  sa.v = d.qkv + 2 * H;
  sa.o = d.ao;
  sa.q_sb = sa.kv_sb = (long long)T * 3 * H;
  sa.q_sh = sa.kv_sh = dh;
  sa.q_sr = sa.kv_sr = 3 * H;
  sa.o_sb = (long long)T * H;
  sa.o_sh = dh;
  sa.o_sr = H;
  sa.heads = heads;
  sa.tq = T;
  sa.tk = T;
  sa.d = dh;
  sa.window = window < 2 * T ? window : 2 * T;
  sa.kv_len = T;
  sa.scale = scale;

  edt::AttnArgs& ca = d.cross;
  ca = sa;
  ca.q = d.cq;
  ca.q_sb = (long long)T * H;
  ca.q_sh = dh;
  ca.q_sr = H;
  ca.kv_sb = (long long)S * 2 * H;
  ca.kv_sh = dh;
  ca.kv_sr = 2 * H;
  ca.tk = S;
  ca.window = T + S;  // full attention
  ca.kv_len = S;
  return d;
}

#define EDT_TRY(call)    \
  do {                   \
    const int e_ = (call); \
    if (e_) return e_;   \
  } while (0)

// One decoder forward of x [B, T, M] with this step's AdaLN table md
// [L, 4, H]; the prediction lands in d.pred.
int decoder_step(Decoder& d, const float* x, const float* md, cudaStream_t st) {
  const int rows = d.B * d.T;
  const int H = d.H, F = d.F;
  const long long HH = (long long)H * H;
  EDT_TRY(gemm(x, d.in_w, d.in_b, d.pos, d.T, nullptr, d.h, rows, H, d.M, st));
  for (int l = 0; l < d.L; ++l) {
    const float* ml = md + (long long)l * 4 * H;
    EDT_TRY(rownorm<false>(d.h, d.hn, ml, ml + H, rows, H, st));
    EDT_TRY(gemm(d.hn, d.qkv_w + l * 3 * HH, nullptr, nullptr, 1, nullptr, d.qkv, rows, 3 * H,
                 H, st));
    EDT_TRY(edt::launch_attention(d.self_attn, d.B, st));
    EDT_TRY(gemm(d.ao, d.proj_w + l * HH, d.proj_b + (long long)l * H, nullptr, 1, d.h, d.h,
                 rows, H, H, st));
    EDT_TRY(rownorm<false>(d.h, d.hn, d.n2w + (long long)l * H, nullptr, rows, H, st));
    EDT_TRY(gemm(d.hn, d.cq_w + l * HH, nullptr, nullptr, 1, nullptr, d.cq, rows, H, H, st));
    d.cross.k = d.ckv + (long long)l * d.B * d.S * 2 * H;
    d.cross.v = d.cross.k + H;
    EDT_TRY(edt::launch_attention(d.cross, d.B, st));
    EDT_TRY(gemm(d.ao, d.co_w + l * HH, nullptr, nullptr, 1, d.h, d.h, rows, H, H, st));
    EDT_TRY(rownorm<false>(d.h, d.hn, ml + 2 * H, ml + 3 * H, rows, H, st));
    EDT_TRY(gemm_swiglu(d.hn, d.fc1_w + (long long)l * 2 * F * H,
                        d.fc1_b + (long long)l * 2 * F, d.f, rows, F, H, st));
    EDT_TRY(gemm(d.f, d.fc2_w + (long long)l * H * F, d.fc2_b + (long long)l * H, nullptr, 1,
                 d.h, d.h, rows, H, F, st));
  }
  EDT_TRY(rownorm<true>(d.h, d.hn, d.fn_s, d.fn_b, rows, H, st));
  return gemm(d.hn, d.out_w, d.out_b, nullptr, 1, nullptr, d.pred, rows, d.M, H, st);
}

constexpr int UPDATE_THREADS = 256;

}  // namespace

// Floats of scratch that edt_fused_ddim and edt_fused_ddpm need.
extern "C" long long edt_fused_ddim_workspace(int B, int T, int H, int F, int M) {
  const long long rows = (long long)B * T;
  return rows * (7LL * H + F + 2LL * M);
}

// The whole num_steps DDIM loop.  Pointers are contiguous float32 on the
// current device; weights use the torch Linear layout [out, in], stacked over
// the L layers:
//   x_T, x0_out [B, T, M]; work [edt_fused_ddim_workspace(...)]
//   pos [T, H]; in_w [H, M]; in_b [H]
//   mods [steps, L, 4, H] = AdaLN (norm1 scale, norm1 shift, norm3 scale,
//        norm3 shift), each scale already folded with its RMSNorm weight
//   n2w [L, H]; qkv_w [L, 3H, H]; proj_w [L, H, H]; proj_b [L, H]
//   cq_w [L, H, H]; ckv [L, B, S, 2H] (cross K = first H columns, V = last H)
//   co_w [L, H, H]; fc1_w [L, 2F, H]; fc1_b [L, 2F]; fc2_w [L, H, F]; fc2_b [L, H]
//   fn_s, fn_b [H]; out_w [M, H]; out_b [M]; coef [steps, 4]
// Returns the first non-zero cudaError_t of any launch, else 0.
extern "C" int edt_fused_ddim(const float* x_T, float* x0_out, float* work, const float* pos,
                              const float* in_w, const float* in_b, const float* mods,
                              const float* n2w, const float* qkv_w, const float* proj_w,
                              const float* proj_b, const float* cq_w, const float* ckv,
                              const float* co_w, const float* fc1_w, const float* fc1_b,
                              const float* fc2_w, const float* fc2_b, const float* fn_s,
                              const float* fn_b, const float* out_w, const float* out_b,
                              const float* coef, int B, int T, int S, int M, int H, int heads,
                              int L, int F, int window, int steps, int v_pred, float x0_clip,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Decoder d = make_decoder(work, pos, in_w, in_b, n2w, qkv_w, proj_w, proj_b, cq_w, ckv, co_w,
                           fc1_w, fc1_b, fc2_w, fc2_b, fn_s, fn_b, out_w, out_b, B, T, S, M, H,
                           heads, L, F, window);
  const long long n_out = (long long)B * T * M;
  cudaMemcpyAsync(d.x, x_T, sizeof(float) * n_out, cudaMemcpyDeviceToDevice, st);
  EDT_TRY((int)cudaGetLastError());
  for (int i = 0; i < steps; ++i) {
    EDT_TRY(decoder_step(d, d.x, mods + (long long)i * L * 4 * H, st));
    ddim_kernel<<<(unsigned)((n_out + UPDATE_THREADS - 1) / UPDATE_THREADS), UPDATE_THREADS, 0,
                  st>>>(d.x, d.pred, x0_out, coef + 4 * i, n_out, v_pred, x0_clip);
    EDT_TRY((int)cudaGetLastError());
  }
  return 0;
}

// The whole `steps`-step ancestral DDPM loop (t = steps-1 .. 0, loop index
// i).  Arguments as edt_fused_ddim, except:
//   x_out [B, T, M] receives the final x (and holds x during the loop);
//   mods [steps, L, 4, H] holds each step's AdaLN table (step_idx 0);
//   coef [steps, 5] = (sqrt ab, sqrt(1-ab), 1/sqrt(alpha), beta/sqrt(1-ab),
//        sigma) of t = steps-1-i, sigma = 0 at t = 0;
//   noise [B, steps, T, M] injects the draws, or is null for Philox with the
//        key (key0, key1).
extern "C" int edt_fused_ddpm(const float* x_T, float* x_out, float* work, const float* pos,
                              const float* in_w, const float* in_b, const float* mods,
                              const float* n2w, const float* qkv_w, const float* proj_w,
                              const float* proj_b, const float* cq_w, const float* ckv,
                              const float* co_w, const float* fc1_w, const float* fc1_b,
                              const float* fc2_w, const float* fc2_b, const float* fn_s,
                              const float* fn_b, const float* out_w, const float* out_b,
                              const float* coef, const float* noise, int B, int T, int S, int M,
                              int H, int heads, int L, int F, int window, int steps, int v_pred,
                              unsigned key0, unsigned key1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Decoder d = make_decoder(work, pos, in_w, in_b, n2w, qkv_w, proj_w, proj_b, cq_w, ckv, co_w,
                           fc1_w, fc1_b, fc2_w, fc2_b, fn_s, fn_b, out_w, out_b, B, T, S, M, H,
                           heads, L, F, window);
  const long long per_b = (long long)T * M;
  const long long n_out = B * per_b;
  cudaMemcpyAsync(x_out, x_T, sizeof(float) * n_out, cudaMemcpyDeviceToDevice, st);
  EDT_TRY((int)cudaGetLastError());
  for (int i = 0; i < steps; ++i) {
    EDT_TRY(decoder_step(d, x_out, mods + (long long)i * L * 4 * H, st));
    ddpm_kernel<<<(unsigned)((n_out + UPDATE_THREADS - 1) / UPDATE_THREADS), UPDATE_THREADS, 0,
                  st>>>(x_out, d.pred, coef + 5 * i, noise, i, steps, per_b, n_out, v_pred, key0,
                        key1);
    EDT_TRY((int)cudaGetLastError());
  }
  return 0;
}
#undef EDT_TRY
