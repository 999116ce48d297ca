// The bf16 step GEMM on Hopper's warpgroup products: wgmma.mma_async
// m64nNk16 with both operands in shared memory, loaded by TMA.  Included by
// gemm.cuh after GemmArgs, warp_tree_sum and the float32 kernel's timer
// stamps, which it uses; edt::gemm launches it for the bf16 GEMMs of the
// decoder step where the tile rule (gemm.cuh, gemm_bf16_pick_tile) picks
// one of its tiles.
//
// It computes what gemm16_kernel computes, which is what the TPU kernel's
// `mm` computes at compute_dtype bfloat16 (edge_diffusion_tts_tpu/ops/
// fused_denoise.py::_denoise_kernel, :179-194): both operands rounded to
// bf16, float32 sums; the row norm (none, RMS, LN, AdaLN-RMS) taken in
// float32 over the whole row, in gemm.cuh's statistics order (a 32-lane
// warp tree), and rounded to bf16 only after; bias, positional, residual
// and SwiGLU in the float32 epilogue; the output float32 or bf16 as
// GemmArgs says.
//
// What bounds it on the H100: at the step's shapes (M = 500 or 4,000 rows,
// N <= 480, K <= 320) a product is 13-614 MFLOP, 0.01-0.6 us at the bf16
// tensor-core rate, and every operand sits in L2: the time goes to getting
// each block's operands from L2 into shared memory, to the float32 row
// norm, and to the latency of the epilogue's loads and of the launch.
// gemm16_kernel staged both operands with 16-byte cp.async copies issued by
// every thread, a float32 A staged whole and rounded into a second tile,
// then ldmatrix and mma.sync from shared memory.  Here:
//   * W (bf16 [N, K], or [2N, K] for SwiGLU: value rows, then gate rows) and
//     a bf16 A come by TMA, one thread issuing every box at the start: a
//     K stage is 64 columns (128 bytes of bf16) in the 128-byte swizzle
//     that wgmma reads, and all of K is in flight at once (K <= 320 at the
//     flagship: at most 5 stages), each stage completing on its own
//     mbarrier, so the products of stage 0 start while later stages land.
//     Rows past M or N and columns past K land as zeros.  The tensor maps
//     are encoded once per (matrix, box) on the host and cached (tmap_2d),
//     not per launch;
//   * a float32 A (x, h, the pre-net's depthwise output) comes by TMA too,
//     in unswizzled float32 stages.  The row statistics are taken a warp
//     per row (lane l at columns l + 32q, conflict-free; summed by shuffles
//     in the warp tree; four rows at a time, so that their chains overlap;
//     a row's division and root by one lane) and every thread then rounds
//     normed values to bf16 8 columns at a time into the swizzled tile
//     (float4 reads, one 16-byte store), fenced to the async proxy before
//     the products read it.  That prologue
//     is the kernel's longest serial part (per-block clock stamps of the
//     EDT_GEMM_TIMERS build, chip_smoke.py --gemm16-timers), and a warp's
//     instruction stream is what a block waits on;
//   * so a block is WGS warpgroups (128 threads each) over 64 rows, each
//     owning BNW columns (wgmma N = BNW; SwiGLU's gate columns a second
//     wgmma into a second accumulator); a stage of W is one TMA box of the
//     block's rows (two for SwiGLU: value rows, then gate rows), since each
//     box adds to its issuing thread's time (clock stamps): at 4,000 rows
//     four warpgroups spread the prologue over 16 warps of 4 rows and share
//     one A tile over 96 or 160 columns; at 500 rows a bf16 A (no prologue)
//     takes one warpgroup of 16 columns, the most blocks.  Every output sums
//     its k16 products in k order inside one accumulator: no split-K, so a
//     seeded call repeats bit for bit, whatever the tile;
//   * the epilogue's bias, positional and residual values are loaded into
//     registers before the products, with no store between them, so their
//     latencies overlap (loaded inside the epilogue, each waited on alone
//     between stores that may alias them, they held the wider tiles several
//     times longer); C is written from the
//     accumulators, two adjacent columns per store, masked past M and N.
// The tile is picked per shape by gemm.cuh's rule.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace edt {

constexpr int WG_BM = 64;  // rows of a block: one wgmma m64
constexpr int WG_KS = 64;  // columns of a K stage: 128 bytes of bf16
// The wgmma tiles: a block of WG_TILE_WGS warpgroups owns 64 rows and
// WG_TILE_BNW columns per warpgroup.
constexpr int WG_NTILES = 3;
constexpr int WG_TILE_BNW[WG_NTILES] = {24, 40, 16};
constexpr int WG_TILE_WGS[WG_NTILES] = {4, 4, 1};

inline long long g_wgmma_launches = 0;  // launches of gemm_wgmma_kernel

// Shared bytes of a launch: 1 KB of alignment slack, the bf16 A and W
// stages, for a float32 A its stages, the norm's rows and the rows'
// statistics, and the barriers.
inline int wgmma_smem_bytes(int bnw, int wgs, int K, bool swiglu, bool a_f32) {
  const int ns = (K + WG_KS - 1) / WG_KS;
  return 1024 + ns * (WG_BM + wgs * (swiglu ? 2 : 1) * bnw) * WG_KS * 2 +
         (a_f32 ? (ns * WG_BM * WG_KS + 2 * ns * WG_KS + 2 * WG_BM) * 4 : 0) + (ns + 1) * 8;
}

template <int BNW, int WGS, bool SWIGLU>
__global__ void __launch_bounds__(128 * WGS)
    gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tw,
                      __grid_constant__ const CUtensorMap ta, GemmArgs g) {
  constexpr int THREADS = 128 * WGS;
  constexpr int NW = SWIGLU ? 2 * BNW : BNW;  // a warpgroup's W rows: values (and gates)
  constexpr int NACC = BNW / 2;               // a thread's accumulators (of each)
  constexpr int NJ = BNW / 8;                 // its 8-column fragments of the output
  constexpr int NX = SWIGLU ? 1 : 2 * NJ * 2;  // its prefetched residual / positional values
  static_assert(BNW % 8 == 0 && WGS * BNW <= 256, "wgmma widths, a TMA box's rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
#ifdef EDT_GEMM_TIMERS
  long long gemm_t0, gemm_clk[7] = {};
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gemm_t0));
  EDT_GEMM_STAMP(0);
#endif
  const int K = g.K;
  const int ns = (K + WG_KS - 1) / WG_KS;
  const bool a16 = g.a_bf16;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* As = reinterpret_cast<bf16*>(base);              // [ns][64][64], swizzled
  bf16* Ws = As + ns * WG_BM * WG_KS;  // [ns][values, gates][WGS BNW][64], swizzled
  float* Af = reinterpret_cast<float*>(Ws + ns * WGS * NW * WG_KS);  // [ns][64][64]
  const int kp = ns * WG_KS;            // columns to the stages' end
  float* Ns = Af + ns * WG_BM * WG_KS;  // [2][kp]: the norm's scale and shift, zeros past K
  float* Mu = Ns + 2 * kp;              // [64]: the rows' means (0 for RMS)
  float* Inv = Mu + WG_BM;              // [64]: their inverse roots
  uint64_t* bars = reinterpret_cast<uint64_t*>(a16 ? Af : Inv + WG_BM);
  uint64_t* bar_a = bars + ns;  // a float32 A, all stages
  const int m0 = blockIdx.y * WG_BM;
  const int n0 = blockIdx.x * BNW * WGS;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int nw0 = n0 + wg * BNW;        // this warpgroup's first column

  if (tid == 0) {
    prefetch_tmap(&tw);
    prefetch_tmap(&ta);
    for (int s = 0; s <= ns; ++s) mbar_init(&bars[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (!a16) {
      mbar_expect_tx(bar_a, ns * WG_BM * WG_KS * 4);
      for (int s = 0; s < ns; ++s) tma_load_2d(Af + s * WG_BM * WG_KS, &ta, bar_a, s * WG_KS, m0);
    }
    const uint32_t bytes = (WGS * NW + (a16 ? WG_BM : 0)) * WG_KS * 2;
    for (int s = 0; s < ns; ++s) {
      mbar_expect_tx(&bars[s], bytes);
      bf16* dst = Ws + s * WGS * NW * WG_KS;  // one box of the block's value rows
      tma_load_2d(dst, &tw, &bars[s], s * WG_KS, n0);
      if constexpr (SWIGLU)  // and one of its gate rows
        tma_load_2d(dst + WGS * BNW * WG_KS, &tw, &bars[s], s * WG_KS, g.N + n0);
      if (a16) tma_load_2d(As + s * WG_BM * WG_KS, &ta, &bars[s], s * WG_KS, m0);
    }
  }
  EDT_GEMM_STAMP(1);  // the loads are issued

  // The epilogue's operands, loaded now (no store comes between them, so
  // their latencies overlap, and behind the products): fragment j, element
  // e of row half h is row m0 + 16 warp + lane/4 + 8h, column nw0 + 8j + 2
  // (lane % 4) + e.  ex holds R, or pos where there is no R (loaded in the
  // epilogue instead for SwiGLU, whose accumulators take the registers).
  // R may alias C: only this thread reads and writes its elements.
  float eb[NJ][2], egb[SWIGLU ? NJ : 1][2], ex[NX];
  const float* exs = g.R ? g.R : g.pos;
  long long exrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + 16 * warp + lane / 4 + 8 * h;
    exrow[h] = exs && gm < g.M ? (g.R ? gm : gm % g.pos_rows) * (long long)g.N : -1;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = nw0 + 8 * j + 2 * (lane % 4) + e;
      const bool okn = gn < g.N;
      eb[j][e] = g.bias && okn ? g.bias[gn] : 0.f;
      if constexpr (SWIGLU) {
        egb[j][e] = g.bias && okn ? g.bias[g.N + gn] : 0.f;
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ex[(h * NJ + j) * 2 + e] = okn && exrow[h] >= 0 ? exs[exrow[h] + gn] : 0.f;
      }
    }
  EDT_GEMM_STAMP(2);

  if (!a16) {
    // A float32 A (landed by TMA, zeros past M and K).  The statistics a
    // warp per row, lane l summing columns l + 32q in order and the lanes
    // in the 32-lane warp tree (row_norm_stats' order), four rows at a time
    // so that their chains overlap, each row's division and root taken
    // once, by lane i for row i; then every thread rounds normed values to
    // bf16, 8 columns at a time (float4 reads of x, scale and shift, one
    // 16-byte store into the swizzled stage; past K the scale and shift are
    // zeros, so the values are, to the stages' end).
    constexpr int RPW = WG_BM / (4 * WGS);  // rows per warp
    constexpr int RB = RPW < 4 ? RPW : 4;
    static_assert(RPW % RB == 0, "rows of a warp");
    const int nq = 2 * ns;  // 32-column groups up to the stages' end
    for (int c = tid; c < kp; c += THREADS) {
      Ns[c] = c < K ? (g.norm_scale ? g.norm_scale[c] : 1.f) : 0.f;
      Ns[kp + c] = c < K && g.norm_shift ? g.norm_shift[c] : 0.f;
    }
    mbar_wait(bar_a, 0);
    if (g.norm_scale) {
      const int rw = (tid / 32) * RPW;  // the warp's first row
#pragma unroll
      for (int r0 = 0; r0 < RPW; r0 += RB) {
        float mu[RB], p[RB][1], own = 0.f, own_mu = 0.f;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          mu[i] = 0.f;
          p[i][0] = 0.f;
        }
        const float* row = Af + (rw + r0) * WG_KS + lane;
        if (g.ln) {
          for (int q = 0; q < nq; ++q)
#pragma unroll
            for (int i = 0; i < RB; ++i)  // zeros past K
              p[i][0] += row[(q / 2) * WG_BM * WG_KS + i * WG_KS + 32 * (q % 2)];
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float sum = warp_tree_sum<32>(p[i]);
            if (lane == i) own = sum;
            p[i][0] = 0.f;
          }
          own_mu = own / K;
#pragma unroll
          for (int i = 0; i < RB; ++i) mu[i] = __shfl_sync(0xffffffffu, own_mu, i);
        }
        for (int q = 0; q < nq && lane + 32 * q < K; ++q)
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float d = row[(q / 2) * WG_BM * WG_KS + i * WG_KS + 32 * (q % 2)] - mu[i];
            p[i][0] = fmaf(d, d, p[i][0]);
          }
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float sum = warp_tree_sum<32>(p[i]);
          if (lane == i) own = sum;
        }
        const float inv = 1.f / sqrtf(own / K + 1e-6f);
        if (lane < RB) {
          Mu[rw + r0 + lane] = own_mu;
          Inv[rw + r0 + lane] = inv;
        }
      }
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s)
      for (int e = tid; e < WG_BM * (WG_KS / 8); e += THREADS) {
        const int r = e / (WG_KS / 8), c = s * WG_KS + 8 * (e % (WG_KS / 8));
        const float* x = Af + s * WG_BM * WG_KS + r * WG_KS + c % WG_KS;
        const float4 x0 = *reinterpret_cast<const float4*>(x);
        const float4 x1 = *reinterpret_cast<const float4*>(x + 4);
        float y[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        if (g.norm_scale) {
          const float mu = Mu[r], inv = Inv[r];
          const float4 a0 = *reinterpret_cast<const float4*>(Ns + c);
          const float4 a1 = *reinterpret_cast<const float4*>(Ns + c + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(Ns + kp + c);
          const float4 b1 = *reinterpret_cast<const float4*>(Ns + kp + c + 4);
          const float sc[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float sh[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            y[k] = (y[k] - mu) * inv * sc[k];
            if (g.norm_shift) y[k] += sh[k];
          }
        }
        uint4 q;
        q.x = pack_bf16(y[0], y[1]);
        q.y = pack_bf16(y[2], y[3]);
        q.z = pack_bf16(y[4], y[5]);
        q.w = pack_bf16(y[6], y[7]);
        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(As) +
                                  s * (WG_BM * WG_KS * 2) + r * 128 +
                                  (((c % WG_KS) / 8) ^ (r % 8)) * 16) = q;
      }
    fence_proxy_async();
    __syncthreads();
  }
  EDT_GEMM_STAMP(3);

  float acc[NACC], accg[SWIGLU ? NACC : 1];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  fence_regs(acc);
  if constexpr (SWIGLU) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) accg[i] = 0.f;
    fence_regs(accg);
  }
  for (int s = 0; s < ns; ++s) {
    mbar_wait(&bars[s], 0);
    if (s == 0) EDT_GEMM_STAMP(4);  // the first stage has landed
    const bf16* w = Ws + s * WGS * NW * WG_KS + wg * BNW * WG_KS;
    const uint64_t da = wgmma_desc_sw128(As + s * WG_BM * WG_KS);
    const uint64_t db = wgmma_desc_sw128(w);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_KS / 16; ++kk) {  // past K both operands hold zeros
      Wgmma<BNW>::mma(acc, da + 2 * kk, db + 2 * kk);
      if constexpr (SWIGLU) {
        const uint64_t dg = wgmma_desc_sw128(w + WGS * BNW * WG_KS);
        Wgmma<BNW>::mma(accg, da + 2 * kk, dg + 2 * kk);
      }
    }
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_regs(acc);
  if constexpr (SWIGLU) fence_regs(accg);
  EDT_GEMM_STAMP(5);

  const bool pairs = g.N % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + 16 * warp + lane / 4 + 8 * h;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int gn = nw0 + 8 * j + 2 * (lane % 4);
      if (gn >= g.N) continue;
      float c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = min(gn + e, g.N - 1);  // a pair's second column past N: unused
        float v = acc[4 * j + 2 * h + e];
        if (g.bias) v += eb[j][e];
        if constexpr (SWIGLU) {
          float gt = accg[4 * j + 2 * h + e];
          if (g.bias) gt += egb[j][e];
          // silu with the fast exp and division: the IEEE ones held the epilogue
          v = v * __fdividef(gt, 1.f + __expf(-gt));
          if (g.pos) v += g.pos[(long long)(gm % g.pos_rows) * g.N + n];
          if (g.R) v = g.R[(long long)gm * g.N + n] + v;
        } else {
          const float x = ex[(h * NJ + j) * 2 + e];
          if (g.pos) v += g.R ? g.pos[(long long)(gm % g.pos_rows) * g.N + n] : x;
          if (g.R) v = x + v;
        }
        c[e] = v;
      }
      const long long o = (long long)gm * g.N + gn;
      if (g.c_bf16) {
        bf16* C = static_cast<bf16*>(g.C);
        if (pairs && gn + 1 < g.N) {
          store2(C + o, c[0], c[1]);
        } else {
          store1(C + o, c[0]);
          if (gn + 1 < g.N) store1(C + o + 1, c[1]);
        }
      } else {
        float* C = static_cast<float*>(g.C);
        if (pairs && gn + 1 < g.N) {
          store2(C + o, c[0], c[1]);
        } else {
          store1(C + o, c[0]);
          if (gn + 1 < g.N) store1(C + o + 1, c[1]);
        }
      }
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

// ---- host side ------------------------------------------------------------

struct TmapKey {
  const void* p;
  long long rows;
  int cols, box_rows, f32;
  bool operator==(const TmapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols && box_rows == o.box_rows && f32 == o.f32;
  }
};

struct TmapHash {
  size_t operator()(const TmapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    for (long long v : {k.rows, (long long)k.cols, (long long)k.box_rows, (long long)k.f32})
      h = h * 0x9E3779B97F4A7C15ull + std::hash<long long>()(v);
    return h;
  }
};

// The tensor map of a row-major [rows, cols] matrix, bf16 (read in boxes of
// box_rows x 64 columns, 128-byte swizzled: wgmma's operand tiles) or
// float32 (f32: boxes of box_rows x 64, unswizzled: the float32 A's
// stages), zeros out of bounds.  A map is a function of these arguments
// alone, so each is encoded once and kept (a packed weight's, a workspace
// buffer's, for every later launch).  Returns a cudaError_t.
inline int tmap_2d(const void* p, long long rows, int cols, int box_rows, bool f32,
                   CUtensorMap* out) {
  static std::mutex mu;
  static std::unordered_map<TmapKey, CUtensorMap, TmapHash> cache;
  const TmapKey key{p, rows, cols, box_rows, f32};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)WG_KS, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap m;
  if (enc(&m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
          const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, m);
  *out = m;
  return 0;
}

template <int BNW, int WGS, bool SWIGLU>
int launch_wgmma_tile(const GemmArgs& g, int smem, cudaStream_t st) {
  const auto kernel = gemm_wgmma_kernel<BNW, WGS, SWIGLU>;
  static bool opted_in[kMaxDevices] = {};  // the kernel uses more than 48 KB
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  CUtensorMap tw, ta;
  int e = tmap_2d(g.W, (SWIGLU ? 2LL : 1LL) * g.N, g.K, BNW * WGS, false, &tw);
  if (!e) e = tmap_2d(g.A, g.M, g.K, WG_BM, !g.a_bf16, &ta);
  if (e) return e;
  const dim3 grid((g.N + BNW * WGS - 1) / (BNW * WGS), (g.M + WG_BM - 1) / WG_BM);
  kernel<<<grid, 128 * WGS, smem, st>>>(tw, ta, g);
  e = (int)cudaGetLastError();
  if (!e) ++g_wgmma_launches;
  return e;
}

template <bool SWIGLU>
int launch_wgmma_sw(const GemmArgs& g, int tile, int smem, cudaStream_t st) {
  static_assert(WG_NTILES == 3, "one case per tile");
  switch (tile) {
    case 0: return launch_wgmma_tile<WG_TILE_BNW[0], WG_TILE_WGS[0], SWIGLU>(g, smem, st);
    case 1: return launch_wgmma_tile<WG_TILE_BNW[1], WG_TILE_WGS[1], SWIGLU>(g, smem, st);
    case 2: return launch_wgmma_tile<WG_TILE_BNW[2], WG_TILE_WGS[2], SWIGLU>(g, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace edt
