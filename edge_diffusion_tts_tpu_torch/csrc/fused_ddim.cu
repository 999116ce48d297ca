// The few-step DDIM denoise loop over EdgeDiffusionDecoder, launched from one
// C host function with no return to Python between launches.
//
// Replaces the TPU kernel edge_diffusion_tts_tpu/ops/fused_denoise.py::
// _denoise_kernel, which runs the whole loop in one launch with every weight
// resident in VMEM.  On the H100 the ~6 MB of f32 weights do not fit a
// block's 227 KB of shared memory, so this port is a fixed sequence of
// hand-written kernels per step, each over all B*T rows:
//   in_proj GEMM (+bias +positional row)
//   L x [ AdaLN-RMS row norm -> qkv GEMM -> banded self-attention (|i-j|<=w,
//         key<T) -> attn-proj GEMM (+bias +residual) -> RMS row norm ->
//         cross-q GEMM -> cross-attention over the precomputed K/V (key<S)
//         -> cross-out GEMM (+residual) -> AdaLN-RMS row norm -> fc1 GEMM
//         with a SwiGLU epilogue -> fc2 GEMM (+bias +residual) ]
//   LayerNorm -> out_proj GEMM (+bias) -> DDIM update with x0 clip
// What bounds it: at the flagship shape a decoder forward is ~1.7 GFLOP of
// float32 work, so four steps are bound by float32 arithmetic (no TF32, to
// hold the 1e-4 parity bar), at small per-kernel grids.  Every product is a
// hand-written float32 FMA kernel: a shared-memory-tiled GEMM (32x64 output
// tile, 4x4 per thread) and the banded attention of attention.cuh.  Weights
// stream from L2 (50 MB holds them all); activations stay in one workspace.
// One persistent launch, a CUDA graph, or wgmma/TMA tiles are later work.
#include <math.h>

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

}  // namespace

// Floats of scratch that edt_fused_ddim needs.
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
  const int rows = B * T;
  const long long RH = (long long)rows * H;
  float* h = work;
  float* hn = h + RH;
  float* qkv = hn + RH;
  float* ao = qkv + 3 * RH;
  float* cq = ao + RH;
  float* f = cq + RH;
  float* pred = f + (long long)rows * F;
  float* x = pred + (long long)rows * M;
  const int dh = H / heads;
  const float scale = (float)pow((double)dh, -0.5);

  cudaMemcpyAsync(x, x_T, sizeof(float) * rows * M, cudaMemcpyDeviceToDevice, st);
  int err = (int)cudaGetLastError();
  if (err) return err;
#define EDT_TRY(call)   \
  do {                  \
    err = (call);       \
    if (err) return err; \
  } while (0)

  edt::AttnArgs self_attn;
  self_attn.q = qkv;
  self_attn.k = qkv + H;
  self_attn.v = qkv + 2 * H;
  self_attn.o = ao;
  self_attn.q_sb = self_attn.kv_sb = (long long)T * 3 * H;
  self_attn.q_sh = self_attn.kv_sh = dh;
  self_attn.q_sr = self_attn.kv_sr = 3 * H;
  self_attn.o_sb = (long long)T * H;
  self_attn.o_sh = dh;
  self_attn.o_sr = H;
  self_attn.heads = heads;
  self_attn.tq = T;
  self_attn.tk = T;
  self_attn.d = dh;
  self_attn.window = window < 2 * T ? window : 2 * T;
  self_attn.kv_len = T;
  self_attn.scale = scale;

  edt::AttnArgs cross = self_attn;
  cross.q = cq;
  cross.q_sb = (long long)T * H;
  cross.q_sh = dh;
  cross.q_sr = H;
  cross.kv_sb = (long long)S * 2 * H;
  cross.kv_sh = dh;
  cross.kv_sr = 2 * H;
  cross.tk = S;
  cross.window = T + S;  // full attention
  cross.kv_len = S;

  const long long n_out = (long long)rows * M;
  for (int i = 0; i < steps; ++i) {
    EDT_TRY(gemm(x, in_w, in_b, pos, T, nullptr, h, rows, H, M, st));
    for (int l = 0; l < L; ++l) {
      const float* md = mods + ((long long)i * L + l) * 4 * H;
      const long long HH = (long long)H * H;
      EDT_TRY(rownorm<false>(h, hn, md, md + H, rows, H, st));
      EDT_TRY(gemm(hn, qkv_w + l * 3 * HH, nullptr, nullptr, 1, nullptr, qkv, rows, 3 * H, H,
                   st));
      EDT_TRY(edt::launch_attention(self_attn, B, st));
      EDT_TRY(gemm(ao, proj_w + l * HH, proj_b + (long long)l * H, nullptr, 1, h, h, rows, H, H,
                   st));
      EDT_TRY(rownorm<false>(h, hn, n2w + (long long)l * H, nullptr, rows, H, st));
      EDT_TRY(gemm(hn, cq_w + l * HH, nullptr, nullptr, 1, nullptr, cq, rows, H, H, st));
      cross.k = ckv + (long long)l * B * S * 2 * H;
      cross.v = cross.k + H;
      EDT_TRY(edt::launch_attention(cross, B, st));
      EDT_TRY(gemm(ao, co_w + l * HH, nullptr, nullptr, 1, h, h, rows, H, H, st));
      EDT_TRY(rownorm<false>(h, hn, md + 2 * H, md + 3 * H, rows, H, st));
      EDT_TRY(gemm_swiglu(hn, fc1_w + (long long)l * 2 * F * H, fc1_b + (long long)l * 2 * F, f,
                          rows, F, H, st));
      EDT_TRY(gemm(f, fc2_w + (long long)l * H * F, fc2_b + (long long)l * H, nullptr, 1, h, h,
                   rows, H, F, st));
    }
    EDT_TRY(rownorm<true>(h, hn, fn_s, fn_b, rows, H, st));
    EDT_TRY(gemm(hn, out_w, out_b, nullptr, 1, nullptr, pred, rows, M, H, st));
    const int threads = 256;
    ddim_kernel<<<(unsigned)((n_out + threads - 1) / threads), threads, 0, st>>>(
        x, pred, x0_out, coef + 4 * i, n_out, v_pred, x0_clip);
    EDT_TRY((int)cudaGetLastError());
  }
#undef EDT_TRY
  return 0;
}
