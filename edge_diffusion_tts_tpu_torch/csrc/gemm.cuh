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
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  const float* A = nullptr;
  const float* W = nullptr;
  float* C = nullptr;
  int M = 0, N = 0, K = 0;
  const float* bias = nullptr;
  const float* pos = nullptr;
  int pos_rows = 1;
  const float* R = nullptr;           // may alias C
  const float* norm_scale = nullptr;  // non-null: row-norm prologue
  const float* norm_shift = nullptr;
  int ln = 0;                         // LayerNorm (else RMS) prologue
  int swiglu = 0;
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

inline int sm_count() {
  static int n[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return 132;
  if (n[dev] <= 0 &&
      (cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
       n[dev] <= 0))
    n[dev] = 132;
  return n[dev];
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
        cp_async16(As + r * ld + c, ok ? g.A + (long long)(m0 + r) * K + c : g.A, ok);
    }
    for (int e = tid; e < (WROWS << shift); e += GEMM_THREADS) {
      const int r = e >> shift, c = 4 * (q_lo + (e & (chunk4 - 1)));
      const bool gate = SWIGLU && r >= BN;
      const int n = n0 + (gate ? r - BN : r);
      const bool ok = n < g.N;
      const long long wrow = gate ? (long long)g.N + n : n;
      if (c < 4 * q_hi) cp_async16(Ws + r * ld + c, ok ? g.W + wrow * K + c : g.W, ok);
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
    constexpr int V = 32 / G;
    float p[V];
    float mu = 0.f;
    if (g.ln) {
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
    const float inv = 1.f / sqrtf(warp_tree_sum<G>(p) / K + 1e-6f);
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
      g.C[(long long)gm * g.N + gn] = c;
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

// One GEMM launch, in the tile the host picks.  Returns a cudaError_t:
// cudaErrorInvalidValue for a shape or alignment the kernel does not take
// (K % 4, 16-byte A and W, shared memory).
inline int gemm(const GemmArgs& g, cudaStream_t st) {
  if (g.M <= 0 || g.N <= 0) return 0;
  int tile = gemm_pick_tile(g.M, g.N);
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
