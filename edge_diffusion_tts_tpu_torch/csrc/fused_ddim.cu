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
// all B*T rows (2 + 8L + 1 launches: 35 at L = 4):
//   in_proj GEMM (+bias +positional row)
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
// Activations live in one workspace.  One persistent launch, a CUDA graph,
// and wgmma/TMA or tensor-core tiles are later work.
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

// The decoder's step-invariant weights and per-call buffers (see
// edt_fused_ddim for the layouts).
struct Decoder {
  const float *pos, *in_w, *in_b, *n2w, *qkv_w, *proj_w, *proj_b, *cq_w, *ckv, *co_w;
  const float *fc1_w, *fc1_b, *fc2_w, *fc2_b, *fn_s, *fn_b, *out_w, *out_b;
  int B, T, S, M, H, L, F;
  float *h, *qkv, *ao, *cq, *f, *pred, *x;  // workspace
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
  d.qkv = d.h + RH;
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

// The step's attention tile: 16 query rows x 4 threads per block (the bits
// of a 64-row tile, on 4x the blocks).
int attention(const edt::AttnArgs& a, int batch, cudaStream_t st) {
  return edt::launch_attention<16, 4>(a, batch, st);
}

// A GEMM over the step's rows: C [rows, N] = A [rows, K] W^T, no extras.
edt::GemmArgs rows_gemm(const Decoder& d, const float* A, const float* W, float* C, int N,
                        int K) {
  edt::GemmArgs g;
  g.A = A;
  g.W = W;
  g.C = C;
  g.M = d.B * d.T;
  g.N = N;
  g.K = K;
  return g;
}

// One decoder forward of x [B, T, M] with this step's AdaLN table md
// [L, 4, H] (norm1 scale, norm1 shift, norm3 scale, norm3 shift); the
// prediction lands in d.pred.  26 GEMMs, 8 attentions at L = 4.
int decoder_step(Decoder& d, const float* x, const float* md, cudaStream_t st) {
  const int H = d.H, F = d.F;
  const long long HH = (long long)H * H;
  edt::GemmArgs g = rows_gemm(d, x, d.in_w, d.h, H, d.M);
  g.bias = d.in_b;
  g.pos = d.pos;
  g.pos_rows = d.T;
  EDT_LAUNCH(edt::gemm(g, st));
  for (int l = 0; l < d.L; ++l) {
    const float* ml = md + (long long)l * 4 * H;
    g = rows_gemm(d, d.h, d.qkv_w + l * 3 * HH, d.qkv, 3 * H, H);
    g.norm_scale = ml;
    g.norm_shift = ml + H;
    EDT_LAUNCH(edt::gemm(g, st));
    EDT_LAUNCH(attention(d.self_attn, d.B, st));
    g = rows_gemm(d, d.ao, d.proj_w + l * HH, d.h, H, H);
    g.bias = d.proj_b + (long long)l * H;
    g.R = d.h;
    EDT_LAUNCH(edt::gemm(g, st));
    g = rows_gemm(d, d.h, d.cq_w + l * HH, d.cq, H, H);
    g.norm_scale = d.n2w + (long long)l * H;
    EDT_LAUNCH(edt::gemm(g, st));
    d.cross.k = d.ckv + (long long)l * d.B * d.S * 2 * H;
    d.cross.v = d.cross.k + H;
    EDT_LAUNCH(attention(d.cross, d.B, st));
    g = rows_gemm(d, d.ao, d.co_w + l * HH, d.h, H, H);
    g.R = d.h;
    EDT_LAUNCH(edt::gemm(g, st));
    g = rows_gemm(d, d.h, d.fc1_w + (long long)l * 2 * F * H, d.f, F, H);
    g.bias = d.fc1_b + (long long)l * 2 * F;
    g.norm_scale = ml + 2 * H;
    g.norm_shift = ml + 3 * H;
    g.swiglu = 1;
    EDT_LAUNCH(edt::gemm(g, st));
    g = rows_gemm(d, d.f, d.fc2_w + (long long)l * H * F, d.h, H, F);
    g.bias = d.fc2_b + (long long)l * H;
    g.R = d.h;
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

// Floats of scratch that edt_fused_ddim and edt_fused_ddpm need.
extern "C" long long edt_fused_ddim_workspace(int B, int T, int H, int F, int M) {
  const long long rows = (long long)B * T;
  return rows * (6LL * H + F + 2LL * M);
}

// Kernels launched by this library since it was loaded (every GEMM,
// attention and update launch of the loops and of edt_decoder_gemm).
extern "C" long long edt_kernel_launches() { return g_launches; }

// The decoder step's GEMM alone (gemm.cuh), as a test and timing hook:
// C [M, N] = P(A) W^T (+bias) (SwiGLU if swiglu) (+pos[m % pos_rows])
// (+R), P the RMS (ln = 0) or LayerNorm (ln = 1) row norm with norm_scale
// (and norm_shift if non-null) when norm_scale is non-null.  A [M, K] and W
// [N or 2N, K] contiguous float32 with 16-byte-aligned rows; R may alias C.
// Returns a cudaError_t.
extern "C" int edt_decoder_gemm(const float* A, const float* W, const float* bias,
                                const float* pos, const float* R, float* C,
                                const float* norm_scale, const float* norm_shift, int M, int N,
                                int K, int pos_rows, int swiglu, int ln, void* stream) {
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
  EDT_LAUNCH(edt::gemm(g, (cudaStream_t)stream));
  return 0;
}

// The rows and columns (bm_bn[0], bm_bn[1]) of the output tile the host
// picks for an M x N output of edt_decoder_gemm and the decoder step.
extern "C" void edt_decoder_gemm_tile(int M, int N, int* bm_bn) {
  const int tile = edt::gemm_pick_tile(M, N);
  bm_bn[0] = edt::GEMM_TILE_BM[tile];
  bm_bn[1] = edt::GEMM_TILE_BN[tile];
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
