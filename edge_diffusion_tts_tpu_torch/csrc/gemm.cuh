// The decoder step's float32 GEMM, with the row norms folded into its
// prologue and the bias / SwiGLU / positional / residual terms into its
// epilogue.  Used by fused_ddim.cu (the DDIM and DDPM loops' decoder step and
// the edt_decoder_gemm test hook).
//
//   C[m, n] = sum_k P(A)[m, k] * W[n, k] (+ bias[n]) (+ pos[m % pos_rows, n])
//             (+ R[m, n])
// A [M, K], W [N, K] (the torch Linear layout), C and R [M, N], contiguous
// row-major; R may alias C (each element is read and written by one thread).
// SwiGLU: W has 2N rows (value rows, then gate rows) and
//   C[m, n] = (A W[n] + bias[n]) * silu(A W[N + n] + bias[N + n]).
// P is the identity or a row norm over all K columns of the row, eps 1e-6:
//   RMS: x / sqrt(mean(x^2) + eps) * scale (+ shift)
//   LN:  (x - mean) / sqrt(mean((x - mean)^2) + eps) * scale (+ shift)
// (the variance taken around the mean, not as E[x^2] - mean^2).
//
// What bounds it on the H100: at the decoder step's shapes (M = B*T = 500,
// N in {80, 160, 320 (x2 for SwiGLU), 480}, K in {80, 160, 320}) a product
// is 13-77 MFLOP, about 1 us of the card's float32 FMA rate, and its
// weights (<= 410 KB) sit in the 50 MB L2 with the rest of the step's.  So
// it is bound by latency and by how many SMs it keeps busy, not by HBM.
// Per-block timers on an H100 (the EDT_GEMM_TIMERS build below, run by
// port_profile.py --gemm-timers) put the rest: at about one block per SM,
// a 16x32 block issuing the copies of its ~30 KB of A and W rows is held
// ~5,000 cycles until they land (some 6
// bytes per SM cycle from L2), about as long as its products take from
// shared memory (2x2 outputs per thread: 4 float4 reads per 16 FMAs).  A
// pipeline of 16-column chunks two ahead measured slower than issuing every
// copy up front: the copies do not arrive sooner, and the products then
// wait on each chunk.  Fewer bytes per SM (larger tiles once a step's rows
// fill them) or bulk copies are the next step.
// Design:
//   * the output tile (BM x BN, from {32x64, 32x32, 16x32, 8x32}) is picked
//     per shape on the host: the largest whose grid fills every SM (>= 132
//     blocks on the H100 at M = 500), else the smallest;
//   * a block stages all K of its A rows and W rows in shared memory at
//     once, in GEMM_STAGES K-chunks, each one cp.async group of 16-byte
//     copies (zero-filled past the edge), and starts on chunk 0 while the
//     later chunks are in flight; above 48 KB the kernel asks for more
//     dynamic shared memory (up to 227 KB: K <= 718 with SwiGLU).  The
//     epilogue's bias, positional and residual operands are loaded into
//     registers before the products, so that their latency hides too;
//   * a row-norm prologue waits for all of A (and the norm's scale and
//     shift, staged beside it), takes each row's statistics
//     with GEMM_THREADS / BM threads per row (two passes for LN), summed in
//     the order of a 32-lane warp tree whatever the threads per row, and
//     normalises the staged rows in place, so no normed copy of h goes
//     through memory and the step needs no separate norm launches;
//   * 128 threads (8 row groups x 16 column groups) each own BM/8 x BN/16
//     outputs (rows tr + 8i, columns tc + 16j) and read A and W as float4
//     along k: a quarter-warp reads one A row (broadcast) and eight
//     consecutive W rows, whose stride (K + 4 or K + 8 floats, K/4 + 1 or
//     K/4 + 2 odd in float4s) puts them in distinct banks;
//   * every output sums its K products in k order, one FMA each: no
//     split-K, so the result does not depend on the tile and a run repeats
//     bit for bit.
//
// The bf16 variant (GemmArgs::bf16; gemm16_kernel below) computes what the
// TPU kernel's `mm` computes at compute_dtype bfloat16
// (fused_denoise.py::_denoise_kernel, :179-194): both operands of the
// product rounded to bf16, the sum in float32.  W is bf16 (rounded once,
// when packed); A is float32 (x, h, the pre-net's depthwise output) or bf16
// (the attention and SwiGLU outputs, which feed only products); C is
// float32 or, where it feeds only products (q/k/v, cross q, the SwiGLU
// output), bf16.  A float32 A is staged whole, normed in float32 by the
// same prologue (its statistics in the same order), and only then rounded
// to bf16 into a second shared tile; bias, positional, residual and SwiGLU
// stay float32 in the epilogue.  The products run on tensor cores:
// mma.sync m16n8k16 (bf16 in, float32 accumulate) fed by ldmatrix
// (bf16.cuh), 4 warps per block, each a (BM / WM) x (BN / WN) sub-tile of
// 16 x 8 fragments.  Shared rows are K rounded up to 16 plus 8 elements, an
// odd number of 16-byte units, so that an ldmatrix phase's 8 rows fall on
// distinct banks; the columns past K are zero.  No split-K: each output's
// sum runs over k in the order of the mma chain, the same for every tile's
// fragment, so a run repeats bit for bit.  The tile is picked by the same
// rule from {64x64, 32x64, 32x32, 16x32} (the mma's 16 rows are the least),
// skipping a tile whose shared memory would not fit.  At the decoder
// step's B = 1 (500 rows) the step is bound by latency and launches, as in
// float32; at B = 8 (4,000 rows) the products' share grows and the tensor
// cores can show.  wgmma and TMA are later work.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"
#include "cp_async.cuh"
#include "device.cuh"

namespace edt {

constexpr int GEMM_THREADS = 128;
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_MAX_SMEM = 232448;  // bytes a block may use on the H100

#ifdef EDT_GEMM_TIMERS
// The timed build (nvcc -DEDT_GEMM_TIMERS, port_profile.py --gemm-timers):
// each block of a launch stamps its start and end (%globaltimer, ns) and its
// phases (clock64, thread 0) into g_gemm_timers, and g_gemm_forced_tile,
// when >= 0, takes the place of the host's pick of the tile.
constexpr int GEMM_TIMER_BLOCKS = 8192;
__device__ long long g_gemm_timers[GEMM_TIMER_BLOCKS][8];
inline int g_gemm_forced_tile = -1;
#define EDT_GEMM_STAMP(i) gemm_clk[i] = clock64()
#else
#define EDT_GEMM_STAMP(i) \
  do {                    \
  } while (0)
#endif

struct GemmArgs {
  const void* A = nullptr;  // float32, or bf16 where a_bf16
  const void* W = nullptr;  // float32, or bf16 in the bf16 variant
  void* C = nullptr;        // float32, or bf16 where c_bf16
  int M = 0, N = 0, K = 0;
  const float* bias = nullptr;
  const float* pos = nullptr;
  int pos_rows = 1;
  const float* R = nullptr;           // may alias C
  const float* norm_scale = nullptr;  // non-null: row-norm prologue
  const float* norm_shift = nullptr;
  int ln = 0;                         // LayerNorm (else RMS) prologue
  int swiglu = 0;
  int bf16 = 0;    // the bf16 variant: W bf16, products on tensor cores
  int a_bf16 = 0;  // A holds bf16 (the bf16 variant, no norm)
  int c_bf16 = 0;  // C is written as bf16 (the bf16 variant)
};

// Output tiles (rows x columns per block), largest first.
constexpr int GEMM_NTILES = 4;
constexpr int GEMM_TILE_BM[GEMM_NTILES] = {32, 32, 16, 8};
constexpr int GEMM_TILE_BN[GEMM_NTILES] = {64, 32, 32, 32};

// Shared-memory row stride in floats: a multiple of 4 (16-byte cp.async
// destinations) that is an odd number of float4s.
__host__ __device__ inline int gemm_ld(int K) { return K + ((K / 4) % 2 == 0 ? 4 : 8); }

// A and W tiles, then the norm's scale and shift rows [2][K].
inline int gemm_smem_bytes(int tile, int K, bool swiglu, bool norm) {
  return ((GEMM_TILE_BM[tile] + (swiglu ? 2 : 1) * GEMM_TILE_BN[tile]) * gemm_ld(K) +
          (norm ? 2 * K : 0)) * 4;
}

inline long long gemm_blocks(int tile, int M, int N) {
  return (long long)((M + GEMM_TILE_BM[tile] - 1) / GEMM_TILE_BM[tile]) *
         ((N + GEMM_TILE_BN[tile] - 1) / GEMM_TILE_BN[tile]);
}

// The tile the host picks for an M x N output.
inline int gemm_pick_tile(int M, int N) {
  for (int t = 0; t < GEMM_NTILES; ++t)
    if (gemm_blocks(t, M, N) >= sm_count()) return t;
  return GEMM_NTILES - 1;
}

// Wait until at most `n` (< GEMM_STAGES) of this thread's groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(GEMM_STAGES == 4, "one case per stage");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// The sum of 32 partial sums, p[v] of the G adjacent lanes standing for lane
// (lane % G) + G * v of a 32-lane warp, added in the order of a 32-lane
// __shfl_xor tree (offsets 16, 8, .., 1): the same float32 result as a warp
// per row, for any G that divides 32.
template <int G>
__device__ __forceinline__ float warp_tree_sum(float (&p)[32 / G]) {
  constexpr int V = 32 / G;
#pragma unroll
  for (int dv = V / 2; dv > 0; dv >>= 1)  // offsets 16 .. G: within the thread
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (!(v & dv)) p[v] += p[v | dv];
  float s = p[0];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The row norm's statistics of a staged row of K floats, taken by the G
// adjacent lanes `lane` of G (the mean for LN, else 0, then the inverse
// root of the mean square around it + 1e-6), summed in a 32-lane warp's
// tree order whatever G.
template <int G>
__device__ __forceinline__ void row_norm_stats(const float* row, int K, int ln, int lane,
                                               float& mu, float& inv) {
  constexpr int V = 32 / G;
  float p[V];
  mu = 0.f;
  if (ln) {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = 0.f;
    for (int c0 = lane; c0 < K; c0 += 32)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (c0 + G * v < K) p[v] += row[c0 + G * v];
    mu = warp_tree_sum<G>(p) / K;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = 0.f;
  for (int c0 = lane; c0 < K; c0 += 32)
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (c0 + G * v < K) {
        const float d = row[c0 + G * v] - mu;
        p[v] = fmaf(d, d, p[v]);
      }
  inv = 1.f / sqrtf(warp_tree_sum<G>(p) / K + 1e-6f);
}

template <int BM, int BN, bool SWIGLU>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  constexpr int TM = BM / 8;
  constexpr int TN = BN / 16;
  constexpr int WROWS = SWIGLU ? 2 * BN : BN;
  extern __shared__ __align__(16) float smem[];
#ifdef EDT_GEMM_TIMERS
  long long gemm_t0, gemm_clk[7] = {};
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gemm_t0));
  EDT_GEMM_STAMP(0);
#endif
  const float* gA = static_cast<const float*>(g.A);
  const float* gW = static_cast<const float*>(g.W);
  float* gC = static_cast<float*>(g.C);
  const int K = g.K;
  const int ld = gemm_ld(K);
  float* As = smem;            // [BM][ld]
  float* Ws = smem + BM * ld;  // [WROWS][ld]: value rows, then gate rows
  float* Ns = Ws + WROWS * ld;  // [2][K]: the norm's scale and shift
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int k4 = K / 4;
  int chunk4 = 1, shift = 0;  // float4s of a row per stage: a power of two
  while (chunk4 * GEMM_STAGES < k4) {
    chunk4 <<= 1;
    ++shift;
  }

  for (int s = 0; s < GEMM_STAGES; ++s) {
    const int q_lo = s * chunk4;
    const int q_hi = min(k4, q_lo + chunk4);
    for (int e = tid; e < (BM << shift); e += GEMM_THREADS) {
      const int r = e >> shift, c = 4 * (q_lo + (e & (chunk4 - 1)));
      const bool ok = m0 + r < g.M;
      if (c < 4 * q_hi)
        cp_async16(As + r * ld + c, ok ? gA + (long long)(m0 + r) * K + c : gA, ok);
    }
    for (int e = tid; e < (WROWS << shift); e += GEMM_THREADS) {
      const int r = e >> shift, c = 4 * (q_lo + (e & (chunk4 - 1)));
      const bool gate = SWIGLU && r >= BN;
      const int n = n0 + (gate ? r - BN : r);
      const bool ok = n < g.N;
      const long long wrow = gate ? (long long)g.N + n : n;
      if (c < 4 * q_hi) cp_async16(Ws + r * ld + c, ok ? gW + wrow * K + c : gW, ok);
    }
    if (g.norm_scale && s == 0) {
      for (int c = 4 * tid; c < K; c += 4 * GEMM_THREADS) {
        cp_async16(Ns + c, g.norm_scale + c, true);
        cp_async16(Ns + K + c, g.norm_shift ? g.norm_shift + c : g.norm_scale, g.norm_shift);
      }
    }
    cp_async_commit();  // possibly empty when K is short
  }

  EDT_GEMM_STAMP(1);  // the copies are issued
  // The epilogue's operands, loaded now so that their latency hides behind
  // the staging and the products.  R may alias C: only this thread reads
  // and writes its elements.
  const int tr = tid / 16;
  const int tc = tid % 16;
  float eb[TN], egb[SWIGLU ? TN : 1], ep[TM][TN], er[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tc + 16 * j;
    const bool okn = gn < g.N;
    eb[j] = g.bias && okn ? g.bias[gn] : 0.f;
    if constexpr (SWIGLU) egb[j] = g.bias && okn ? g.bias[g.N + gn] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + tr + 8 * i;
      const bool ok = okn && gm < g.M;
      ep[i][j] = g.pos && ok ? g.pos[(long long)(gm % g.pos_rows) * g.N + gn] : 0.f;
      er[i][j] = g.R && ok ? g.R[(long long)gm * g.N + gn] : 0.f;
    }
  }

  EDT_GEMM_STAMP(2);
  if (g.norm_scale) {
    cp_async_wait<0>();
    __syncthreads();
    constexpr int G = GEMM_THREADS / BM;  // threads per row, adjacent lanes
    float* row = As + (tid / G) * ld;
    const int lane = tid % G;
    float mu, inv;
    row_norm_stats<G>(row, K, g.ln, lane, mu, inv);
    for (int c = lane; c < K; c += G) {
      float y = (row[c] - mu) * inv * Ns[c];
      if (g.norm_shift) y += Ns[K + c];
      row[c] = y;
    }
    __syncthreads();
  }

  EDT_GEMM_STAMP(3);
  float acc[TM][TN];
  float accg[SWIGLU ? TM : 1][SWIGLU ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      if constexpr (SWIGLU) accg[i][j] = 0.f;
    }

  for (int s = 0; s < GEMM_STAGES; ++s) {
    if (!g.norm_scale) {
      cp_async_wait_pending(GEMM_STAGES - 1 - s);
      __syncthreads();
    }
    if (s == 0) EDT_GEMM_STAMP(4);  // the first chunk has landed
    const int q_lo = s * chunk4;
    const int q_hi = min(k4, q_lo + chunk4);
#pragma unroll 2
    for (int q = q_lo; q < q_hi; ++q) {
      float4 a[TM], w[TN], gw[SWIGLU ? TN : 1];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (tr + 8 * i) * ld + 4 * q);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        w[j] = *reinterpret_cast<const float4*>(Ws + (tc + 16 * j) * ld + 4 * q);
        if constexpr (SWIGLU)
          gw[j] = *reinterpret_cast<const float4*>(Ws + (BN + tc + 16 * j) * ld + 4 * q);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float c = acc[i][j];
          c = fmaf(a[i].x, w[j].x, c);
          c = fmaf(a[i].y, w[j].y, c);
          c = fmaf(a[i].z, w[j].z, c);
          c = fmaf(a[i].w, w[j].w, c);
          acc[i][j] = c;
          if constexpr (SWIGLU) {
            float e = accg[i][j];
            e = fmaf(a[i].x, gw[j].x, e);
            e = fmaf(a[i].y, gw[j].y, e);
            e = fmaf(a[i].z, gw[j].z, e);
            e = fmaf(a[i].w, gw[j].w, e);
            accg[i][j] = e;
          }
        }
    }
  }

  EDT_GEMM_STAMP(5);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr + 8 * i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn >= g.N) continue;
      float c = acc[i][j];
      if (g.bias) c += eb[j];
      if constexpr (SWIGLU) {
        float gt = accg[i][j];
        if (g.bias) gt += egb[j];
        c = c * (gt / (1.f + expf(-gt)));
      }
      if (g.pos) c += ep[i][j];
      if (g.R) c = er[i][j] + c;
      gC[(long long)gm * g.N + gn] = c;
    }
  }
#ifdef EDT_GEMM_TIMERS
  __syncthreads();
  long long gemm_t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gemm_t1));
  EDT_GEMM_STAMP(6);
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0 && blk < GEMM_TIMER_BLOCKS) {
    long long* t = g_gemm_timers[blk];
    t[0] = gemm_t0;
    t[1] = gemm_t1;
    for (int p = 0; p < 6; ++p) t[2 + p] = gemm_clk[p + 1] - gemm_clk[p];
  }
#endif
}

template <int BM, int BN, bool SWIGLU>
int launch_gemm_tile(const GemmArgs& g, int smem, cudaStream_t st) {
  static bool opted_in[kMaxDevices] = {};  // the kernel may use more than 48 KB
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<BM, BN, SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm_kernel<BM, BN, SWIGLU><<<grid, GEMM_THREADS, smem, st>>>(g);
  return (int)cudaGetLastError();
}

template <bool SWIGLU>
int launch_gemm_sw(const GemmArgs& g, int tile, int smem, cudaStream_t st) {
  switch (tile) {
    case 0: return launch_gemm_tile<32, 64, SWIGLU>(g, smem, st);
    case 1: return launch_gemm_tile<32, 32, SWIGLU>(g, smem, st);
    case 2: return launch_gemm_tile<16, 32, SWIGLU>(g, smem, st);
    default: return launch_gemm_tile<8, 32, SWIGLU>(g, smem, st);
  }
}

// ---- the bf16 variant -----------------------------------------------------

constexpr int GEMM16_NTILES = 4;
constexpr int GEMM16_TILE_BM[GEMM16_NTILES] = {64, 32, 32, 16};
constexpr int GEMM16_TILE_BN[GEMM16_NTILES] = {64, 64, 32, 32};
constexpr int GEMM16_TILE_WM[GEMM16_NTILES] = {2, 2, 2, 1};  // warps along rows, of 4

// Shared row stride in bf16 elements: K rounded up to 16 (the mma's depth),
// then 8 more, an odd number of 16-byte units.
__host__ __device__ inline int gemm16_ld(int K) { return (K + 15) / 16 * 16 + 8; }

// A float32 A tile (as the float32 kernel stages it), the norm's scale and
// shift rows [2][K], then the bf16 A and W tiles.
inline int gemm16_smem_bytes(int tile, int K, bool swiglu, bool norm, bool a_f32) {
  const int bm = GEMM16_TILE_BM[tile], bn = GEMM16_TILE_BN[tile];
  return (a_f32 ? bm * gemm_ld(K) * 4 : 0) + (norm ? 8 * K : 0) +
         (bm + (swiglu ? 2 : 1) * bn) * gemm16_ld(K) * 2;
}

inline long long gemm16_blocks(int tile, int M, int N) {
  return (long long)((M + GEMM16_TILE_BM[tile] - 1) / GEMM16_TILE_BM[tile]) *
         ((N + GEMM16_TILE_BN[tile] - 1) / GEMM16_TILE_BN[tile]);
}

inline long long g_mma16_launches = 0;  // launches of gemm16_kernel

// The float32 kernel's rule: the largest tile whose grid fills every SM,
// else the smallest.
inline int gemm16_pick_tile(int M, int N) {
  for (int t = 0; t < GEMM16_NTILES; ++t)
    if (gemm16_blocks(t, M, N) >= sm_count()) return t;
  return GEMM16_NTILES - 1;
}

template <int BM, int BN, int WM, bool SWIGLU, bool A16, bool C16>
__global__ void __launch_bounds__(GEMM_THREADS) gemm16_kernel(GemmArgs g) {
  constexpr int WN = GEMM_THREADS / 32 / WM;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's sub-tile
  constexpr int MI = WTM / 16, NI = WTN / 8;   // its 16 x 8 fragments
  constexpr int WROWS = SWIGLU ? 2 * BN : BN;
  static_assert(MI >= 1 && NI >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "mma fragments");
  using OutT = typename std::conditional<C16, bf16, float>::type;
  extern __shared__ __align__(16) float smem[];
  const int K = g.K;
  const int ld = gemm16_ld(K);
  const int kp = ld - 8;  // K rounded up to 16
  const int ld32 = gemm_ld(K);
  float* Af = smem;                              // [BM][ld32]: a float32 A
  float* Ns = Af + (A16 ? 0 : BM * ld32);        // [2][K]: the norm's scale and shift
  bf16* As = reinterpret_cast<bf16*>(Ns + (g.norm_scale ? 2 * K : 0));  // [BM][ld]
  bf16* Ws = As + BM * ld;                       // [WROWS][ld]: value rows, then gate rows
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  // Everything in one group: the products need all of A normed first.
  const int u16 = kp / 8;  // 16-byte units of a bf16 row, zero-filled past K
  if constexpr (A16) {
    const bf16* A = static_cast<const bf16*>(g.A);
    for (int e = tid; e < BM * u16; e += GEMM_THREADS) {
      const int r = e / u16, c = 8 * (e % u16);
      const bool ok = m0 + r < g.M && c < K;
      cp_async16(As + r * ld + c, ok ? A + (long long)(m0 + r) * K + c : A, ok);
    }
  } else {
    const float* A = static_cast<const float*>(g.A);
    const int k4 = K / 4;
    for (int e = tid; e < BM * k4; e += GEMM_THREADS) {
      const int r = e / k4, c = 4 * (e % k4);
      const bool ok = m0 + r < g.M;
      cp_async16(Af + r * ld32 + c, ok ? A + (long long)(m0 + r) * K + c : A, ok);
    }
  }
  const bf16* W = static_cast<const bf16*>(g.W);
  for (int e = tid; e < WROWS * u16; e += GEMM_THREADS) {
    const int r = e / u16, c = 8 * (e % u16);
    const bool gate = SWIGLU && r >= BN;
    const int n = n0 + (gate ? r - BN : r);
    const bool ok = n < g.N && c < K;
    const long long wrow = gate ? (long long)g.N + n : n;
    cp_async16(Ws + r * ld + c, ok ? W + wrow * K + c : W, ok);
  }
  if (g.norm_scale) {
    for (int c = 4 * tid; c < K; c += 4 * GEMM_THREADS) {
      cp_async16(Ns + c, g.norm_scale + c, true);
      cp_async16(Ns + K + c, g.norm_shift ? g.norm_shift + c : g.norm_scale, g.norm_shift);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A float32 A: the row norm in float32 (the float32 kernel's prologue),
  // then each value rounded to bf16 once, into the bf16 tile.
  if constexpr (!A16) {
    constexpr int G = GEMM_THREADS / BM;  // threads per row, adjacent lanes
    const float* row = Af + (tid / G) * ld32;
    bf16* out = As + (tid / G) * ld;
    const int lane = tid % G;
    float mu = 0.f, inv = 1.f;
    if (g.norm_scale) row_norm_stats<G>(row, K, g.ln, lane, mu, inv);
    for (int c = lane; c < kp; c += G) {
      float y = 0.f;
      if (c < K) {
        y = row[c];
        if (g.norm_scale) {
          y = (y - mu) * inv * Ns[c];
          if (g.norm_shift) y += Ns[K + c];
        }
      }
      out[c] = __float2bfloat16_rn(y);
    }
    __syncthreads();
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wr = WTM * (warp / WN), wc = WTN * (warp % WN);  // the warp's sub-tile
  float acc[MI][NI][4];
  float accg[SWIGLU ? MI : 1][SWIGLU ? NI : 1][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        if constexpr (SWIGLU) accg[i][j][e] = 0.f;
      }
  // B fragments of W rows wrow0 + wc + 8j (NI of them) at depth k0.
  auto load_b = [&](unsigned (&b)[NI][2], int wrow0, int k0) {
#pragma unroll
    for (int j = 0; j + 1 < NI; j += 2) {
      unsigned r[4];
      ldsm_x4(r, Ws + (wrow0 + wc + 8 * j + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     8 * ((lane >> 3) & 1));
      b[j][0] = r[0], b[j][1] = r[1];
      b[j + 1][0] = r[2], b[j + 1][1] = r[3];
    }
    if constexpr (NI % 2 == 1) {
      unsigned r[2];
      ldsm_x2(r, Ws + (wrow0 + wc + 8 * (NI - 1) + (lane & 7)) * ld + k0 + 8 * ((lane >> 3) & 1));
      b[NI - 1][0] = r[0], b[NI - 1][1] = r[1];
    }
  };
  for (int k0 = 0; k0 < kp; k0 += 16) {
    unsigned a[MI][4], b[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldsm_x4(a[i], As + (wr + 16 * i + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
    load_b(b, 0, k0);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    if constexpr (SWIGLU) {
      load_b(b, BN, k0);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(accg[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // Fragment (i, j) element e: row wr + 16i + lane/4 (+8 for e >= 2),
  // column wc + 8j + 2 (lane % 4) + (e & 1).  R may alias C: only this
  // thread reads and writes its elements.
  OutT* C = static_cast<OutT*>(g.C);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wr + 16 * i + (lane >> 2) + 8 * h;
      if (gm >= g.M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wc + 8 * j + 2 * (lane & 3) + e;
          if (gn >= g.N) continue;
          float c = acc[i][j][2 * h + e];
          if (g.bias) c += g.bias[gn];
          if constexpr (SWIGLU) {
            float gt = accg[i][j][2 * h + e];
            if (g.bias) gt += g.bias[g.N + gn];
            c = c * (gt / (1.f + expf(-gt)));
          }
          if (g.pos) c += g.pos[(long long)(gm % g.pos_rows) * g.N + gn];
          if (g.R) c = g.R[(long long)gm * g.N + gn] + c;
          store1(C + (long long)gm * g.N + gn, c);
        }
    }
}

template <int BM, int BN, int WM, bool SWIGLU, bool A16, bool C16>
int launch_gemm16_tile(const GemmArgs& g, int smem, cudaStream_t st) {
  const auto kernel = gemm16_kernel<BM, BN, WM, SWIGLU, A16, C16>;
  static bool opted_in[kMaxDevices] = {};  // the kernel may use more than 48 KB
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  kernel<<<grid, GEMM_THREADS, smem, st>>>(g);
  const int e = (int)cudaGetLastError();
  if (!e) ++g_mma16_launches;
  return e;
}

template <bool SWIGLU, bool A16, bool C16>
int launch_gemm16_sw(const GemmArgs& g, int tile, int smem, cudaStream_t st) {
  switch (tile) {
    case 0: return launch_gemm16_tile<64, 64, 2, SWIGLU, A16, C16>(g, smem, st);
    case 1: return launch_gemm16_tile<32, 64, 2, SWIGLU, A16, C16>(g, smem, st);
    case 2: return launch_gemm16_tile<32, 32, 2, SWIGLU, A16, C16>(g, smem, st);
    default: return launch_gemm16_tile<16, 32, 1, SWIGLU, A16, C16>(g, smem, st);
  }
}

template <bool SWIGLU>
int launch_gemm16_io(const GemmArgs& g, int tile, int smem, cudaStream_t st) {
  if (g.a_bf16)
    return g.c_bf16 ? launch_gemm16_sw<SWIGLU, true, true>(g, tile, smem, st)
                    : launch_gemm16_sw<SWIGLU, true, false>(g, tile, smem, st);
  return g.c_bf16 ? launch_gemm16_sw<SWIGLU, false, true>(g, tile, smem, st)
                  : launch_gemm16_sw<SWIGLU, false, false>(g, tile, smem, st);
}

}  // namespace edt

#include "gemm_wgmma.cuh"  // the wgmma kernel, which uses the definitions above

namespace edt {

// The bf16 variant's tiles: 0 .. 3 gemm16_kernel's (mma.sync; 64x64, 32x64,
// 32x32, 16x32), then gemm_wgmma_kernel's (wgmma; 64 rows x WG_TILE_BNW
// columns x WG_TILE_WGS warpgroups: 64 x 96, 64 x 160, 64 x 16).
constexpr int GEMM_BF16_NTILES = GEMM16_NTILES + WG_NTILES;
inline bool bf16_tile_wgmma(int t) { return t >= GEMM16_NTILES; }
inline int bf16_tile_bm(int t) { return bf16_tile_wgmma(t) ? WG_BM : GEMM16_TILE_BM[t]; }
// Warpgroups (128 threads) of a block: gemm16_kernel's tiles take one.
inline int bf16_tile_wgs(int t) {
  return bf16_tile_wgmma(t) ? WG_TILE_WGS[t - GEMM16_NTILES] : 1;
}
inline int bf16_tile_bn(int t) {
  return bf16_tile_wgmma(t) ? WG_TILE_BNW[t - GEMM16_NTILES] * bf16_tile_wgs(t)
                            : GEMM16_TILE_BN[t];
}

// Shared bytes of tile t's launch.
inline int gemm_bf16_smem(int t, int K, bool swiglu, bool norm, bool a_f32) {
  if (bf16_tile_wgmma(t))
    return wgmma_smem_bytes(WG_TILE_BNW[t - GEMM16_NTILES], bf16_tile_wgs(t), K, swiglu, a_f32);
  return gemm16_smem_bytes(t, K, swiglu, norm, a_f32);
}

// The wgmma kernel's own rule: 64 x 16 in one warpgroup for a bf16 A under
// 1,024 rows (no prologue: the most blocks), else four warpgroups, 64 x 96,
// or 64 x 160 for SwiGLU (its value and gate rows, 320 of W, in one tile).
inline int wgmma_pick_tile(int M, bool a_bf16, bool swiglu) {
  return GEMM16_NTILES + (M < 1024 && a_bf16 ? 2 : swiglu ? 1 : 0);
}

// The tile the host picks for an M x N output of the bf16 variant from an A
// of float32 (a_bf16 false) or bf16, by measurement on the H100 (PERF.md,
// chip_smoke.py phase 3): the wgmma kernel's, but gemm16_kernel's (its own
// tile rule) for a float32 A under 1,024 rows, where a 64-row block's
// float32 prologue measured slower than its 16- and 32-row tiles.
inline int gemm_bf16_pick_tile(int M, int N, bool a_bf16, bool swiglu) {
  if (!a_bf16 && M < 1024) return gemm16_pick_tile(M, N);
  return wgmma_pick_tile(M, a_bf16, swiglu);
}

// One launch of the bf16 variant in tile `tile` (< 0: the host's pick, and
// gemm16_kernel's pick where the wgmma tile's shared memory would not fit,
// then its next narrower tile while that one's would not).  cudaErrorInvalidValue for what it does not take: K % 8 (16-byte
// bf16 rows), A, W, scale and shift not 16-byte aligned, a norm on a bf16
// A, a tile that does not exist or does not fit.
inline int gemm16(const GemmArgs& g, cudaStream_t st, int tile) {
  const bool norm = g.norm_scale != nullptr;
  if (g.K <= 0 || g.K % 8 || g.pos_rows <= 0 || (norm && g.a_bf16) ||
      tile >= GEMM_BF16_NTILES ||
      ((uintptr_t)g.A | (uintptr_t)g.W | (uintptr_t)g.norm_scale | (uintptr_t)g.norm_shift) % 16)
    return (int)cudaErrorInvalidValue;
  const auto smem_of = [&](int t) { return gemm_bf16_smem(t, g.K, g.swiglu, norm, !g.a_bf16); };
  int smem;
  if (tile >= 0) {
    smem = smem_of(tile);
  } else {
    tile = gemm_bf16_pick_tile(g.M, g.N, g.a_bf16, g.swiglu);
    smem = smem_of(tile);
    if (smem > GEMM_MAX_SMEM && bf16_tile_wgmma(tile)) {
      tile = gemm16_pick_tile(g.M, g.N);
      smem = smem_of(tile);
    }
    while (smem > GEMM_MAX_SMEM && tile + 1 < GEMM16_NTILES) smem = smem_of(++tile);
  }
  if (smem > GEMM_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (bf16_tile_wgmma(tile))
    return g.swiglu ? launch_wgmma_sw<true>(g, tile - GEMM16_NTILES, smem, st)
                    : launch_wgmma_sw<false>(g, tile - GEMM16_NTILES, smem, st);
  return g.swiglu ? launch_gemm16_io<true>(g, tile, smem, st)
                  : launch_gemm16_io<false>(g, tile, smem, st);
}

// One GEMM launch, in the tile the host picks (or, for the bf16 variant,
// `tile` >= 0 of its list): the bf16 variant where g.bf16, else the
// float32 kernel.  Returns a cudaError_t: cudaErrorInvalidValue for a shape
// or alignment the kernel does not take (K % 4, 16-byte A and W, shared
// memory; bf16 A or C without g.bf16; a tile for the float32 kernel).
inline int gemm(const GemmArgs& g, cudaStream_t st, int tile = -1) {
  if (g.M <= 0 || g.N <= 0) return 0;
  if (g.bf16) return gemm16(g, st, tile);
  if (g.a_bf16 || g.c_bf16 || tile >= 0) return (int)cudaErrorInvalidValue;
  tile = gemm_pick_tile(g.M, g.N);
#ifdef EDT_GEMM_TIMERS
  if (g_gemm_forced_tile >= 0) tile = g_gemm_forced_tile;
#endif
  if (g.K <= 0 || g.K % 4 || g.pos_rows <= 0 ||
      ((uintptr_t)g.A | (uintptr_t)g.W | (uintptr_t)g.norm_scale | (uintptr_t)g.norm_shift) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = gemm_smem_bytes(tile, g.K, g.swiglu, g.norm_scale);
  if (smem > GEMM_MAX_SMEM) return (int)cudaErrorInvalidValue;
  return g.swiglu ? launch_gemm_sw<true>(g, tile, smem, st)
                  : launch_gemm_sw<false>(g, tile, smem, st);
}

}  // namespace edt
