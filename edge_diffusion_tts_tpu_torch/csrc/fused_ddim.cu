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
// all B*T rows (2 + 8L + 1 launches: 35 at L = 4; 3 more with the depthwise
// pre-net, 38 at L = 4):
//   in_proj GEMM (+bias +positional row)
//     or, with the pre-net (use_depthwise): in_proj GEMM (+bias) -> depthwise
//     k=3 conv along T within each batch row (rows outside [0, T) zero) ->
//     pointwise GEMM (+bias) -> GroupNorm statistics per (batch row, group)
//     and h + gelu_erf(norm * scale + shift) + positional row, one pass
//   L x [ qkv GEMM with an AdaLN-RMS prologue -> banded self-attention
//         (|i-j|<=w, key<T) -> attn-proj GEMM (+bias +residual) -> cross-q
//         GEMM with an RMS x n2w prologue -> cross-attention over the
//         precomputed K/V (key<S) -> cross-out GEMM (+residual) -> fc1 GEMM
//         with an AdaLN-RMS prologue and a SwiGLU epilogue -> fc2 GEMM
//         (+bias +residual) ]
//   out_proj GEMM with a LayerNorm prologue (+bias)
// followed by the sampler's update kernel: DDIM with x0 clip, or DDPM with a
// Gaussian draw per element and step.
// What bounds it: at the flagship shape (B*T = 500 rows, hidden 160, 4
// layers) a decoder forward is ~1.73 GFLOP of float32 work, ~26 us at the
// card's 67 TFLOP/s (no TF32, to hold the parity bars): 4 DDIM steps 0.103
// ms, 1000 DDPM steps 25.8 ms.  Every operand is L2-resident: ~6 MB of
// weights, DDPM's 10 MB AdaLN table and the ~2 MB of activations fit the
// 50 MB L2, so HBM bounds nothing.  What a step loses its time to is the
// size of each launch: every kernel does 0.01-0.08 GFLOP, a few us of work
// if it keeps all 132 SMs busy, and pays launch latency and the latency
// of its first loads.  So the design goes for full grids and few launches:
//   * one GEMM (gemm.cuh) with the output tile picked per shape so that
//     every product of the step fills the SMs at 500 rows, K staged whole in
//     shared memory by cp.async, and no split-K (a deterministic sum order:
//     the same seed gives the same output);
//   * the row norms in that GEMM's prologue: the four GEMMs whose input is
//     a normed h (K = H) normalise their staged rows in shared memory, so
//     the norms' 13 launches per step and the round trip of a normed copy
//     of h leave the step;
//   * attention (attention.cuh) with a 16-row x 4-thread tile: 128 blocks
//     at T = 500 with 4 heads, where a 64-row tile gives 32.
// Measured on the card, a step is ~0.4 ms: each GEMM 5-14 us, bound by its
// blocks' wait for their operands from L2 and by its products' reads of
// shared memory (gemm.cuh); each attention ~15 us, bound by each thread's
// chain of keys; and ~1.8 us of host time between launches.
// The row norms' statistics are summed in a 32-lane warp's tree order and
// each query row's keys split over 4 threads in chunks at multiples of 64
// keys: the float32 sums of one warp per row and of the 64-row tile, the
// summation order the 1000-step DDPM parity rule was set on.  An order with
// 8 threads per row crossed that rule's elementwise bar.
// The pre-net's GroupNorm takes one block per (batch row, group) and sums
// in a fixed order (each thread's elements in sequence, then a warp tree,
// then the warps in order; no atomics): the mean first, then the variance
// around it, so the same input gives the same bits.  At the flagship shape
// that is 8 blocks of 10,000 elements each, a few us; the pre-net adds
// 2*500*160*160 = 25.6 MFLOP per forward, all in the pointwise GEMM.
// Activations live in one workspace; the pre-net's two [B*T, H] scratch
// tensors (the depthwise output and the pointwise output) reuse the
// attention-output and cross-query buffers, which the step fills only
// after the pre-net.  One persistent launch, a CUDA graph, and wgmma/TMA
// or tensor-core tiles are later work.
//
// The bf16 variant (the `bf16` argument; the TPU kernels' compute_dtype
// bfloat16) runs the same launches: every GEMM in gemm.cuh's bf16 variant
// (both operands of each product rounded to bf16, float32 sums, on tensor
// cores: gemm_wgmma.cuh's wgmma + TMA kernel or gemm16_kernel's mma.sync,
// by the tile rule), both attentions in attention16.cuh's kernel (bf16
// q/k/v and cross K/V, S and PV on mma.sync, the softmax in float32, P
// normalised and then rounded to bf16 before it weights v).  The weights
// of the products and the cross K/V come packed in bf16; q/k/v, the
// attention outputs, the cross q and the SwiGLU output live in bf16 in the
// workspace (each feeds only products, so storing it rounded is the same
// as rounding it at its use); the residual stream h, the norms, the
// softmax, the biases, the AdaLN table, the pre-net's depthwise conv and
// GroupNorm (its pointwise GEMM rounds its operands as every product
// does), the prediction and the updates stay float32.  The bf16
// workspace's pre-net scratch is the qkv buffer (the depthwise output) and
// the attention-output and cross-query buffers together (the pointwise
// output), as float32.
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
#include "attention16.cuh"
#include "relpos_attention16.cuh"
#include "gemm.cuh"

namespace {

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

// The depthwise pre-net's first kernel: d[b, t, c] = w[c, 0] h[b, t-1, c] +
// w[c, 1] h[b, t, c] + w[c, 2] h[b, t+1, c], the rows outside [0, T) of the
// same b read as zero (flax's SAME padding, 1 and 1), no bias.  Each product
// and sum rounded on its own, in the plain version's order.
__global__ void depthwise3_kernel(const float* __restrict__ h, const float* __restrict__ w,
                                  float* __restrict__ out, int T, int H, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = (int)(idx % H);
  const int t = (int)((idx / H) % T);
  const float prev = t > 0 ? h[idx - H] : 0.f;
  const float next = t + 1 < T ? h[idx + H] : 0.f;
  out[idx] = __fadd_rn(__fadd_rn(__fmul_rn(prev, w[3 * c]), __fmul_rn(h[idx], w[3 * c + 1])),
                       __fmul_rn(next, w[3 * c + 2]));
}

constexpr int PRENET_GROUPS = 8;     // GroupNorm groups (GroupNorm(min(8, H)), H % 8 == 0)
constexpr int PRENET_THREADS = 1024;  // one block per (batch row, group)

// The block's sum of each thread's v, in a fixed order: a 32-lane
// __shfl_xor tree per warp, then the warps' sums in warp order by thread 0.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < PRENET_THREADS / 32; ++i) s += red[i];
    red[32] = s;
  }
  __syncthreads();
  const float s = red[32];
  __syncthreads();  // red is reused by the next call
  return s;
}

// The pre-net's last kernel, block (g, b): GroupNorm statistics of u over
// the T rows x H/8 channels of group g in batch row b (mean, then the mean
// square around it, eps 1e-6), then
//   out[b, t, c] = hin[b, t, c] + gelu_erf((u - mean) rstd gs[c] + gb[c])
//                  + pos[t, c]
// for the group's channels.  out may alias hin (each element is read and
// written by one thread).
__global__ void __launch_bounds__(PRENET_THREADS)
    prenet_norm_kernel(const float* hin, float* out, const float* __restrict__ u,
                       const float* __restrict__ pos, const float* __restrict__ gs,
                       const float* __restrict__ gb, int T, int H) {
  __shared__ float red[33];
  const int cg = H / PRENET_GROUPS;
  const int c0 = blockIdx.x * cg;
  const long long base = (long long)blockIdx.y * T * H + c0;
  const int n = T * cg;
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += PRENET_THREADS) {
    const int t = e / cg;
    s += u[base + (long long)t * H + (e - t * cg)];
  }
  const float mean = block_sum(s, red) / (float)n;
  s = 0.f;
  for (int e = threadIdx.x; e < n; e += PRENET_THREADS) {
    const int t = e / cg;
    const float d = u[base + (long long)t * H + (e - t * cg)] - mean;
    s = fmaf(d, d, s);
  }
  const float rstd = 1.f / sqrtf(block_sum(s, red) / (float)n + 1e-6f);
  for (int e = threadIdx.x; e < n; e += PRENET_THREADS) {
    const int t = e / cg, c = c0 + (e - t * cg);
    const long long i = base + (long long)t * H + (e - t * cg);
    const float y = (u[i] - mean) * rstd * gs[c] + gb[c];
    const float act = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
    out[i] = hin[i] + act + pos[(long long)t * H + c];
  }
}

// The depthwise pre-net's weights (all null: no pre-net): taps [H, 3],
// pointwise weight [H, H] (at the step's compute dtype) and bias [H],
// GroupNorm scale and shift [H].
struct Prenet {
  const float* dw;
  const void* pw;
  const float *pb, *gs, *gb;
};

// The decoder's step-invariant weights and per-call buffers (see
// edt_fused_ddim for the layouts).  The products' weights, the cross K/V
// and the buffers that feed only products (qkv, ao, cq, f) are float32, or
// bf16 in the bf16 variant.
struct Decoder {
  const float* pos;
  const void* in_w;
  const float *in_b, *n2w;
  const void *qkv_w, *proj_w;
  const float* proj_b;
  const void *cq_w, *ckv, *co_w, *fc1_w;
  const float* fc1_b;
  const void* fc2_w;
  const float *fc2_b, *fn_s, *fn_b;
  const void* out_w;
  const float* out_b;
  int B, T, S, M, H, L, F;
  int bf16;
  float* h;              // workspace: the residual stream
  void *qkv, *ao, *cq, *f;
  float *pred, *x;
  float *pre1, *pre2;  // the pre-net's two [B*T, H] float32 scratch buffers
  edt::AttnArgs self_attn, cross;
  Prenet pre;
};

// Element i of a float32 array, or of a bf16 one where bf16.
const void* offset(const void* p, long long i, int bf16) {
  return static_cast<const char*>(p) + i * (bf16 ? 2 : 4);
}

// Bytes of the workspace: h [rows, H], qkv [rows, 3H], ao and cq [rows, H],
// f [rows, F] (bf16 or float32), then pred and x [rows, M] float32.
long long workspace_bytes(int B, int T, int H, int F, int M, int bf16) {
  const long long rows = (long long)B * T;
  return rows * (4LL * H + (bf16 ? 2 : 4) * (5LL * H + F) + 8LL * M);
}

Decoder make_decoder(void* work, const float* pos, const void* in_w, const float* in_b,
                     const float* n2w, const void* qkv_w, const void* proj_w,
                     const float* proj_b, const void* cq_w, const void* ckv, const void* co_w,
                     const void* fc1_w, const float* fc1_b, const void* fc2_w,
                     const float* fc2_b, const float* fn_s, const float* fn_b, const void* out_w,
                     const float* out_b, int B, int T, int S, int M, int H, int heads, int L,
                     int F, int window, int bf16) {
  Decoder d{pos,   in_w,  in_b,  n2w,  qkv_w, proj_w, proj_b, cq_w, ckv, co_w,
            fc1_w, fc1_b, fc2_w, fc2_b, fn_s,  fn_b,   out_w,  out_b, B,   T,
            S,     M,     H,     L,    F,    bf16};
  const long long rows = (long long)B * T;
  const long long RH = rows * H;
  const int es = bf16 ? 2 : 4;  // bytes per element of qkv, ao, cq, f
  char* p = static_cast<char*>(work);
  d.h = reinterpret_cast<float*>(p);
  d.qkv = p += 4 * RH;
  d.ao = p += es * 3 * RH;
  d.cq = p += es * RH;
  d.f = p += es * RH;
  d.pred = reinterpret_cast<float*>(p += es * rows * F);
  d.x = d.pred + rows * M;
  // float32: the attention-output and cross-query buffers; bf16: the qkv
  // buffer, and the two halves-as-wide buffers together.
  d.pre1 = static_cast<float*>(bf16 ? d.qkv : d.ao);
  d.pre2 = static_cast<float*>(bf16 ? d.ao : d.cq);
  const int dh = H / heads;
  const float scale = (float)pow((double)dh, -0.5);

  edt::AttnArgs& sa = d.self_attn;
  sa.q = d.qkv;
  sa.k = offset(d.qkv, H, bf16);
  sa.v = offset(d.qkv, 2 * H, bf16);
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
  sa.bf16 = bf16;

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

long long g_launches = 0;  // kernels this library launched (edt_kernel_launches)

#define EDT_TRY(call)      \
  do {                     \
    const int e_ = (call); \
    if (e_) return e_;     \
  } while (0)
#define EDT_LAUNCH(call) \
  do {                   \
    ++g_launches;        \
    EDT_TRY(call);       \
  } while (0)

// The step's attention: float32 in attention.cuh's tile of 16 query rows x 4
// threads per block (the bits of a 64-row tile, on 4x the blocks); bf16 on
// tensor cores (attention16.cuh).
int attention(const edt::AttnArgs& a, int batch, cudaStream_t st) {
  return a.bf16 ? edt::launch_attention16(a, batch, st)
                : edt::launch_attention<16, 4>(a, batch, st);
}

// A GEMM over the step's rows: C [rows, N] = A [rows, K] W^T, no extras, in
// the step's variant (bf16: A and C float32 unless flagged).
edt::GemmArgs rows_gemm(const Decoder& d, const void* A, const void* W, void* C, int N, int K) {
  edt::GemmArgs g;
  g.A = A;
  g.W = W;
  g.C = C;
  g.M = d.B * d.T;
  g.N = N;
  g.K = K;
  g.bf16 = d.bf16;
  return g;
}

// The pre-net on hin [B*T, H] into out (may alias hin): the depthwise
// kernel into d1, the pointwise GEMM (+bias; bf16 products where bf16) into
// d2, then the GroupNorm / GELU / residual / positional pass.  Three
// launches.
int prenet(const Prenet& p, const float* hin, float* out, float* d1, float* d2,
           const float* pos, int B, int T, int H, int bf16, cudaStream_t st) {
  const long long n = (long long)B * T * H;
  constexpr int threads = 256;
  ++g_launches;
  depthwise3_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(hin, p.dw, d1,
                                                                                T, H, n);
  EDT_TRY((int)cudaGetLastError());
  edt::GemmArgs g;
  g.A = d1;
  g.W = p.pw;
  g.C = d2;
  g.M = B * T;
  g.N = H;
  g.K = H;
  g.bias = p.pb;
  g.bf16 = bf16;
  EDT_LAUNCH(edt::gemm(g, st));
  ++g_launches;
  prenet_norm_kernel<<<dim3(PRENET_GROUPS, B), PRENET_THREADS, 0, st>>>(hin, out, d2, pos, p.gs,
                                                                       p.gb, T, H);
  return (int)cudaGetLastError();
}

// Checks a pre-net's pointers: all null (no pre-net) or none, and a hidden
// width the GroupNorm kernel takes.  Returns a cudaError_t.
int check_prenet(const Prenet& p, int H) {
  const bool any = p.dw || p.pw || p.pb || p.gs || p.gb;
  const bool all = p.dw && p.pw && p.pb && p.gs && p.gb;
  if (any && (!all || H % PRENET_GROUPS)) return (int)cudaErrorInvalidValue;
  return 0;
}

// One decoder forward of x [B, T, M] with this step's AdaLN table md
// [L, 4, H] (norm1 scale, norm1 shift, norm3 scale, norm3 shift); the
// prediction lands in d.pred.  26 GEMMs, 8 attentions at L = 4, and the
// pre-net's 3 launches when the decoder has one.
int decoder_step(Decoder& d, const float* x, const float* md, cudaStream_t st) {
  const int H = d.H, F = d.F;
  const auto at = [&d](const void* p, long long i) { return offset(p, i, d.bf16); };
  const long long HH = (long long)H * H;
  edt::GemmArgs g = rows_gemm(d, x, d.in_w, d.h, H, d.M);
  g.bias = d.in_b;
  if (d.pre.pw) {
    EDT_LAUNCH(edt::gemm(g, st));
    EDT_TRY(prenet(d.pre, d.h, d.h, d.pre1, d.pre2, d.pos, d.B, d.T, H, d.bf16, st));
  } else {
    g.pos = d.pos;
    g.pos_rows = d.T;
    EDT_LAUNCH(edt::gemm(g, st));
  }
  for (int l = 0; l < d.L; ++l) {
    const float* ml = md + (long long)l * 4 * H;
    g = rows_gemm(d, d.h, at(d.qkv_w, l * 3 * HH), d.qkv, 3 * H, H);
    g.norm_scale = ml;
    g.norm_shift = ml + H;
    g.c_bf16 = d.bf16;
    EDT_LAUNCH(edt::gemm(g, st));
    EDT_LAUNCH(attention(d.self_attn, d.B, st));
    g = rows_gemm(d, d.ao, at(d.proj_w, l * HH), d.h, H, H);
    g.bias = d.proj_b + (long long)l * H;
    g.R = d.h;
    g.a_bf16 = d.bf16;
    EDT_LAUNCH(edt::gemm(g, st));
    g = rows_gemm(d, d.h, at(d.cq_w, l * HH), d.cq, H, H);
    g.norm_scale = d.n2w + (long long)l * H;
    g.c_bf16 = d.bf16;
    EDT_LAUNCH(edt::gemm(g, st));
    d.cross.k = at(d.ckv, (long long)l * d.B * d.S * 2 * H);
    d.cross.v = at(d.ckv, (long long)l * d.B * d.S * 2 * H + H);
    EDT_LAUNCH(attention(d.cross, d.B, st));
    g = rows_gemm(d, d.ao, at(d.co_w, l * HH), d.h, H, H);
    g.R = d.h;
    g.a_bf16 = d.bf16;
    EDT_LAUNCH(edt::gemm(g, st));
    g = rows_gemm(d, d.h, at(d.fc1_w, (long long)l * 2 * F * H), d.f, F, H);
    g.bias = d.fc1_b + (long long)l * 2 * F;
    g.norm_scale = ml + 2 * H;
    g.norm_shift = ml + 3 * H;
    g.swiglu = 1;
    g.c_bf16 = d.bf16;
    EDT_LAUNCH(edt::gemm(g, st));
    g = rows_gemm(d, d.f, at(d.fc2_w, (long long)l * H * F), d.h, H, F);
    g.bias = d.fc2_b + (long long)l * H;
    g.R = d.h;
    g.a_bf16 = d.bf16;
    EDT_LAUNCH(edt::gemm(g, st));
  }
  g = rows_gemm(d, d.h, d.out_w, d.pred, d.M, H);
  g.bias = d.out_b;
  g.norm_scale = d.fn_s;
  g.norm_shift = d.fn_b;
  g.ln = 1;
  EDT_LAUNCH(edt::gemm(g, st));
  return 0;
}

constexpr int UPDATE_THREADS = 256;

}  // namespace

// Floats (4-byte words) of scratch that edt_fused_ddim and edt_fused_ddpm
// need, in the float32 layout or (bf16) the bf16 one.
extern "C" long long edt_fused_ddim_workspace(int B, int T, int H, int F, int M, int bf16) {
  return workspace_bytes(B, T, H, F, M, bf16) / 4;
}

// Kernels launched by this library since it was loaded (every GEMM,
// attention and update launch of the loops, of edt_decoder_gemm and of
// edt_step_attention).
extern "C" long long edt_kernel_launches() { return g_launches; }

// Launches of one bf16 kernel since the last edt_zero_kernel_launches:
// kind 1 gemm_wgmma_kernel, 2 gemm16_kernel, 3 attention16_kernel, 4
// relpos_attention16_kernel (-1 for another kind).
extern "C" long long edt_kernel_launches_of(int kind) {
  switch (kind) {
    case 1: return edt::g_wgmma_launches;
    case 2: return edt::g_mma16_launches;
    case 3: return edt::g_attn16_launches[0] + edt::g_attn16_launches[1];
    case 4: return edt::g_relpos_launches;
    default: return -1;
  }
}

extern "C" void edt_zero_kernel_launches() {
  edt::g_wgmma_launches = edt::g_mma16_launches = edt::g_relpos_launches = 0;
  for (long long& n : edt::g_attn16_launches) n = 0;
}

// WavLM's gated relative-position attention (relpos_attention16.cuh), the
// encoder's and not the loop's: o [B, S, heads x 64] bf16 from y [B, S, ld]
// bf16 (q, k, v, then each head's 8 gate projections), rel [heads, 2S - 1]
// and gconst [heads] float32.  Counted by kind 4 of edt_kernel_launches_of,
// not by edt_kernel_launches.  Returns a cudaError_t.
extern "C" int edt_relpos_attention16(const void* y, const float* rel, const float* gconst,
                                      void* o, int B, int heads, int S, int ld, void* stream) {
  edt::RelposArgs a;
  a.y = static_cast<const edt::bf16*>(y);
  a.rel = rel;
  a.gconst = gconst;
  a.o = static_cast<edt::bf16*>(o);
  a.heads = heads;
  a.S = S;
  a.ld = ld;
  return edt::launch_relpos_attention16(a, B, (cudaStream_t)stream);
}

// w2v-BERT's relative-key attention (relpos_attention16.cuh), the encoder's:
// o [B, S, heads x 64] bf16 from y [B, S, 3 heads 64] bf16 (q, k, v) and the
// distance table E [rows, 64] bf16, offset d at row clamp(d, -left, rows - 1
// - left) + left.  Counted by edt_relkey_launches alone.  Returns a
// cudaError_t.
extern "C" int edt_relkey_attention16(const void* y, const void* E, void* o, int B, int heads,
                                      int S, int rows, int left, void* stream) {
  edt::RelkeyArgs a;
  a.y = static_cast<const edt::bf16*>(y);
  a.E = static_cast<const edt::bf16*>(E);
  a.o = static_cast<edt::bf16*>(o);
  a.heads = heads;
  a.S = S;
  a.rows = rows;
  a.left = left;
  return edt::launch_relkey_attention16(a, B, (cudaStream_t)stream);
}

// Launches of relkey_attention16_kernel since the library was loaded.
extern "C" long long edt_relkey_launches() { return edt::g_relkey_launches; }

// The decoder step's GEMM alone (gemm.cuh), as a test and timing hook, in
// tile `tile` of the bf16 variant's list (edt_gemm_bf16_tile_shape; < 0:
// the host's pick, as the decoder step takes it):
// C [M, N] = P(A) W^T (+bias) (SwiGLU if swiglu) (+pos[m % pos_rows])
// (+R), P the RMS (ln = 0) or LayerNorm (ln = 1) row norm with norm_scale
// (and norm_shift if non-null) when norm_scale is non-null.  A [M, K] and W
// [N or 2N, K] contiguous with 16-byte-aligned rows, float32, or with bf16
// the bf16 variant: W bf16, A bf16 where a_bf16, C written as bf16 where
// c_bf16; R (float32) may alias C.  Returns a cudaError_t.
extern "C" int edt_decoder_gemm(const void* A, const void* W, const float* bias,
                                const float* pos, const float* R, void* C,
                                const float* norm_scale, const float* norm_shift, int M, int N,
                                int K, int pos_rows, int swiglu, int ln, int bf16, int a_bf16,
                                int c_bf16, int tile, void* stream) {
  edt::GemmArgs g;
  g.A = A;
  g.W = W;
  g.C = C;
  g.M = M;
  g.N = N;
  g.K = K;
  g.bias = bias;
  g.pos = pos;
  g.pos_rows = pos_rows;
  g.R = R;
  g.norm_scale = norm_scale;
  g.norm_shift = norm_shift;
  g.ln = ln;
  g.swiglu = swiglu;
  g.bf16 = bf16;
  g.a_bf16 = a_bf16;
  g.c_bf16 = c_bf16;
  EDT_LAUNCH(edt::gemm(g, (cudaStream_t)stream, tile));
  return 0;
}

// The pre-net's three kernels alone, as a test and timing hook: out [B, T,
// H] = hin + gelu_erf(GroupNorm(pointwise(depthwise3(hin)) + pb)) + pos (see
// prenet_norm_kernel); work holds 2 B*T*H floats; out may alias hin.
// Weights as edt_fused_ddim's pre-net (pc_pw bf16 where bf16).  Returns a
// cudaError_t.
extern "C" int edt_decoder_prenet(const float* hin, float* out, float* work, const float* pos,
                                  const float* pc_dw, const void* pc_pw, const float* pc_pb,
                                  const float* pc_gs, const float* pc_gb, int B, int T, int H,
                                  int bf16, void* stream) {
  const Prenet p{pc_dw, pc_pw, pc_pb, pc_gs, pc_gb};
  if (!pc_pw || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  EDT_TRY(check_prenet(p, H));
  float* d1 = work;
  float* d2 = work + (long long)B * T * H;
  return prenet(p, hin, out, d1, d2, pos, B, T, H, bf16, (cudaStream_t)stream);
}

namespace {

// The AttnArgs of contiguous q [B, heads, tq, d], k and v [B, heads, tk, d]
// and o [B, heads, tq, d] (every key for a window < 0).
edt::AttnArgs hook_attention(const void* q, const void* k, const void* v, void* o, int heads,
                             int tq, int tk, int d, int window, int bf16) {
  edt::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sr = a.kv_sr = a.o_sr = d;
  a.q_sh = a.o_sh = (long long)tq * d;
  a.q_sb = a.o_sb = heads * a.q_sh;
  a.kv_sh = (long long)tk * d;
  a.kv_sb = heads * a.kv_sh;
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.window = window < 0 || window > tq + tk ? tq + tk : window;
  a.kv_len = tk;
  a.scale = (float)pow((double)d, -0.5);
  a.bf16 = bf16;
  return a;
}

}  // namespace

// The step's attention alone (attention.cuh in the step's tile, or
// attention16.cuh's kernel with bf16), as a test hook: o [B, heads, tq, d] =
// softmax(q k^T / sqrt(d)) v over the keys j of row i with |i - j| <=
// window (every key for a window < 0, the cross-attention), q [B, heads,
// tq, d], k and v [B, heads, tk, d], all contiguous, float32, or bf16 with
// bf16 (P normalised, then rounded to bf16 before PV, o bf16), then in
// `tile` (0 the key tile, 1 the row tile; < 0 the host's rule, as the step
// takes it; bf16 only).  Returns a cudaError_t.
extern "C" int edt_step_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int heads, int tq, int tk, int d, int window, int bf16,
                                  int tile, void* stream) {
  const edt::AttnArgs a = hook_attention(q, k, v, o, heads, tq, tk, d, window, bf16);
  if (tile >= 0 && !bf16) return (int)cudaErrorInvalidValue;
  EDT_LAUNCH(bf16 ? edt::launch_attention16(a, B, (cudaStream_t)stream, tile)
                  : attention(a, B, (cudaStream_t)stream));
  return 0;
}

// The tile of attention16.cuh's kernel the host's rule takes for a bf16
// step attention of B x heads pairs over tq query rows: 0 the key tile, 1
// the row tile (edt_step_attention's `tile`).
extern "C" int edt_attention16_pick_tile(int B, int heads, int tq) {
  return edt::att16_pick_tile(B, heads, tq);
}

// Launches of attention16_kernel by tile since the last
// edt_zero_kernel_launches: out[tile], the key tile's and the row tile's;
// returns the number of tiles.
extern "C" int edt_attention16_tile_launches(long long* out) {
  for (int t = 0; t < edt::ATT16_NTILES; ++t) out[t] = edt::g_attn16_launches[t];
  return edt::ATT16_NTILES;
}

// edt_step_attention in attention.cuh's float32-FMA kernel at either dtype
// (with bf16 the variant the bf16 step ran before attention16.cuh: P rounded
// against a thread's running max), kept as a yardstick.
extern "C" int edt_step_attention_fma(const void* q, const void* k, const void* v, void* o, int B,
                                      int heads, int tq, int tk, int d, int window, int bf16,
                                      void* stream) {
  const edt::AttnArgs a = hook_attention(q, k, v, o, heads, tq, tk, d, window, bf16);
  EDT_LAUNCH((edt::launch_attention<16, 4>(a, B, (cudaStream_t)stream)));
  return 0;
}

// The rows and columns (bm_bn[0], bm_bn[1]) of the output tile the host
// picks for an M x N output of edt_decoder_gemm and the decoder step, in
// the float32 kernel or (bf16) the bf16 variant from a float32 A, no SwiGLU
// (whose launch takes gemm16_kernel's tile where the wgmma tile's shared
// memory would not fit).
extern "C" void edt_decoder_gemm_tile(int M, int N, int bf16, int* bm_bn) {
  if (bf16) {
    const int tile = edt::gemm_bf16_pick_tile(M, N, false, false);
    bm_bn[0] = edt::bf16_tile_bm(tile);
    bm_bn[1] = edt::bf16_tile_bn(tile);
    return;
  }
  const int tile = edt::gemm_pick_tile(M, N);
  bm_bn[0] = edt::GEMM_TILE_BM[tile];
  bm_bn[1] = edt::GEMM_TILE_BN[tile];
}

// The index in the bf16 variant's tile list of the tile picked for an M x N
// output (SwiGLU's where swiglu) from a float32 (a_bf16 0) or bf16 A by the
// host's rule (which 0), by gemm16_kernel's own rule (1: the mma.sync
// kernel alone) or by gemm_wgmma_kernel's own (2).
extern "C" int edt_gemm_bf16_tile(int M, int N, int a_bf16, int swiglu, int which) {
  switch (which) {
    case 0: return edt::gemm_bf16_pick_tile(M, N, a_bf16, swiglu);
    case 1: return edt::gemm16_pick_tile(M, N);
    case 2: return edt::wgmma_pick_tile(M, a_bf16, swiglu);
    default: return -1;
  }
}

// Tile `tile` of the bf16 variant's list: out = (rows, columns, 1 for the
// wgmma kernel or 0 for gemm16_kernel, warpgroups of 128 threads); returns
// the list's length, or -1 past its end.
extern "C" int edt_gemm_bf16_tile_shape(int tile, int* out) {
  if (tile < 0 || tile >= edt::GEMM_BF16_NTILES) return -1;
  out[0] = edt::bf16_tile_bm(tile);
  out[1] = edt::bf16_tile_bn(tile);
  out[2] = edt::bf16_tile_wgmma(tile);
  out[3] = edt::bf16_tile_wgs(tile);
  return edt::GEMM_BF16_NTILES;
}

#ifdef EDT_GEMM_TIMERS
// The timed build's hooks (port_profile.py --gemm-timers).  Force tile
// `tile` of gemm.cuh's list (-1: the host's pick) on every later GEMM launch;
// its rows and columns go to bm_bn.  Returns -1 if there is no such tile.
extern "C" int edt_gemm_force_tile(int tile, int* bm_bn) {
  if (tile >= edt::GEMM_NTILES) return -1;
  edt::g_gemm_forced_tile = tile;
  if (tile >= 0) {
    bm_bn[0] = edt::GEMM_TILE_BM[tile];
    bm_bn[1] = edt::GEMM_TILE_BN[tile];
  }
  return tile;
}

// The stamps of the last GEMM launch's first `blocks` blocks, [blocks][8]:
// start and end (ns), then the clock64 cycles of its six phases.
extern "C" int edt_gemm_timers(long long* out, int blocks) {
  blocks = blocks < edt::GEMM_TIMER_BLOCKS ? blocks : edt::GEMM_TIMER_BLOCKS;
  return (int)cudaMemcpyFromSymbol(out, edt::g_gemm_timers, sizeof(long long) * 8 * blocks);
}
#endif

// The whole num_steps DDIM loop.  Pointers are contiguous float32 on the
// current device, but for bf16 = 1 (the bf16 variant): in_w, qkv_w, proj_w,
// cq_w, ckv, co_w, fc1_w, fc2_w, out_w and pc_pw are then bf16.  Weights use
// the torch Linear layout [out, in], stacked over the L layers:
//   x_T, x0_out [B, T, M]; work [edt_fused_ddim_workspace(...)]
//   pos [T, H]; in_w [H, M]; in_b [H]
//   mods [steps, L, 4, H] = AdaLN (norm1 scale, norm1 shift, norm3 scale,
//        norm3 shift), each scale already folded with its RMSNorm weight
//   n2w [L, H]; qkv_w [L, 3H, H]; proj_w [L, H, H]; proj_b [L, H]
//   cq_w [L, H, H]; ckv [L, B, S, 2H] (cross K = first H columns, V = last H)
//   co_w [L, H, H]; fc1_w [L, 2F, H]; fc1_b [L, 2F]; fc2_w [L, H, F]; fc2_b [L, H]
//   fn_s, fn_b [H]; out_w [M, H]; out_b [M]; coef [steps, 4]
//   pc_dw [H, 3] (tap 0 reads row t-1); pc_pw [H, H]; pc_pb, pc_gs, pc_gb [H]:
//        the depthwise pre-net (use_depthwise; H % 8 == 0), all null for a
//        decoder without it, whose launches are then those of the step
//        without a pre-net, unchanged
// Returns the first non-zero cudaError_t of any launch, else 0.
extern "C" int edt_fused_ddim(const float* x_T, float* x0_out, void* work, const float* pos,
                              const void* in_w, const float* in_b, const float* mods,
                              const float* n2w, const void* qkv_w, const void* proj_w,
                              const float* proj_b, const void* cq_w, const void* ckv,
                              const void* co_w, const void* fc1_w, const float* fc1_b,
                              const void* fc2_w, const float* fc2_b, const float* fn_s,
                              const float* fn_b, const void* out_w, const float* out_b,
                              const float* coef, const float* pc_dw, const void* pc_pw,
                              const float* pc_pb, const float* pc_gs, const float* pc_gb, int B,
                              int T, int S, int M, int H, int heads, int L, int F, int window,
                              int steps, int v_pred, float x0_clip, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Decoder d = make_decoder(work, pos, in_w, in_b, n2w, qkv_w, proj_w, proj_b, cq_w, ckv, co_w,
                           fc1_w, fc1_b, fc2_w, fc2_b, fn_s, fn_b, out_w, out_b, B, T, S, M, H,
                           heads, L, F, window, bf16);
  d.pre = Prenet{pc_dw, pc_pw, pc_pb, pc_gs, pc_gb};
  EDT_TRY(check_prenet(d.pre, H));
  const long long n_out = (long long)B * T * M;
  cudaMemcpyAsync(d.x, x_T, sizeof(float) * n_out, cudaMemcpyDeviceToDevice, st);
  EDT_TRY((int)cudaGetLastError());
  for (int i = 0; i < steps; ++i) {
    EDT_TRY(decoder_step(d, d.x, mods + (long long)i * L * 4 * H, st));
    ++g_launches;
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
//        key (key0, key1);
//   the pre-net's pointers follow noise.
extern "C" int edt_fused_ddpm(const float* x_T, float* x_out, void* work, const float* pos,
                              const void* in_w, const float* in_b, const float* mods,
                              const float* n2w, const void* qkv_w, const void* proj_w,
                              const float* proj_b, const void* cq_w, const void* ckv,
                              const void* co_w, const void* fc1_w, const float* fc1_b,
                              const void* fc2_w, const float* fc2_b, const float* fn_s,
                              const float* fn_b, const void* out_w, const float* out_b,
                              const float* coef, const float* noise, const float* pc_dw,
                              const void* pc_pw, const float* pc_pb, const float* pc_gs,
                              const float* pc_gb, int B, int T, int S, int M, int H, int heads,
                              int L, int F, int window, int steps, int v_pred, unsigned key0,
                              unsigned key1, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Decoder d = make_decoder(work, pos, in_w, in_b, n2w, qkv_w, proj_w, proj_b, cq_w, ckv, co_w,
                           fc1_w, fc1_b, fc2_w, fc2_b, fn_s, fn_b, out_w, out_b, B, T, S, M, H,
                           heads, L, F, window, bf16);
  d.pre = Prenet{pc_dw, pc_pw, pc_pb, pc_gs, pc_gb};
  EDT_TRY(check_prenet(d.pre, H));
  const long long per_b = (long long)T * M;
  const long long n_out = B * per_b;
  cudaMemcpyAsync(x_out, x_T, sizeof(float) * n_out, cudaMemcpyDeviceToDevice, st);
  EDT_TRY((int)cudaGetLastError());
  for (int i = 0; i < steps; ++i) {
    EDT_TRY(decoder_step(d, x_out, mods + (long long)i * L * 4 * H, st));
    ++g_launches;
    ddpm_kernel<<<(unsigned)((n_out + UPDATE_THREADS - 1) / UPDATE_THREADS), UPDATE_THREADS, 0,
                  st>>>(x_out, d.pred, coef + 5 * i, noise, i, steps, per_b, n_out, v_pred, key0,
                        key1);
    EDT_TRY((int)cudaGetLastError());
  }
  return 0;
}
#undef EDT_LAUNCH
#undef EDT_TRY
