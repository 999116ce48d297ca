// The bf16 frontend's conv1-6 on Hopper's warpgroup products: an implicit
// GEMM on wgmma.mma_async, both operands in shared memory, loaded by TMA.
// Included by conv_frontend.cu, whose bf16 launcher runs it for the layers
// whose tiles fill the card (the host's tile rule, ops/fused_frontend.py::
// frontend_tile); conv_slab_bf16_kernel (mma.sync, split-K) keeps the rest.
//
// It computes what conv_slab_bf16_kernel computes, which is the TPU kernel
// at compute_dtype bfloat16 (edge_diffusion_tts_tpu/ops/fused_frontend.py::
// _conv_k3s2 / _conv_k2s2, :88-120): a stride-2 conv of KT taps over bf16
// activations in [B, Tin, C] with bf16 weights W [C_out, KT*C_in] (tap
// outer), float32 sums, erf-GELU in float32, the result rounded to bf16
// (RNE) or, for conv6, stored as float32.
//
// What bounds it: at [256, 32000] (a training batch of 2 s clips) conv1 is
// 1.29 TFLOP, 1.30 ms at 989 TFLOP/s, against 1.68 GB of input (0.50 ms at
// 3.35 TB/s): operations.  So the products must reach the tensor cores'
// rate, which only wgmma does, fed by TMA so that no thread spends
// instructions on copies.  Design:
//   * GEMM: M = output frames of one batch row, N = C_out, K = KT * C_in in
//     stages of 64 input channels (128 bytes of bf16: one row of the
//     128-byte swizzle that TMA writes and wgmma reads), tap outer.  A block
//     owns 128 frames x BN channels (BN = 256 or 128): two consumer
//     warpgroups of 64 frames each issue m64nBNk16 into BN / 2 float32
//     registers a thread;
//   * the stride-2 taps by the tensor map, not by a layout: output frame t,
//     tap j reads input frame 2t + j, so a stage's A box is 128 frames 2
//     apart from frame 2 t0 + j (elementStrides 2 on the frame axis: a box
//     of 256 frames traversed at stride 2 lands as 128 dense rows).  Every
//     layer then reads and writes the natural [B, T, C] layout that
//     conv0, the mma.sync kernel, the split-K sum and the per-layer hook
//     already use; a parity-split layout would have needed all of them
//     rewritten.  The map is 3-D (channels, frames, batch): a box never
//     reads across the end of one batch row into the next, and frames past
//     Tin land as zeros;
//   * warp specialisation: warp 8 is the producer, one thread issuing both
//     boxes of a stage (A, then W's BN rows) into a ring of 4 (BN = 256) or
//     6 (BN = 128) stages of 48 or 32 KB, each stage a full and an empty
//     mbarrier; warps 0-7 are the consumers.  A consumer warpgroup releases
//     a stage once the products that read it have completed (wgmma
//     wait_group 1: one stage's products stay in flight);
//   * a persistent grid, one block per SM over the tiles (channels fastest,
//     so the blocks in flight share their A boxes in L2; batch outermost),
//     so the producer runs on into the next tile's stages while the
//     consumers finish the last one's epilogue;
//   * the epilogue: GELU on each accumulator, rounded to OutT, staged 64
//     columns at a time into a warpgroup's own 64 x 64 tile (16-byte units
//     XOR-swizzled by row, so that both the fragment writes and the row
//     reads are conflict-free), then written as coalesced 16-byte stores,
//     rows past M left out.
// Every output sums its k16 products in k order inside one accumulator: no
// split-K and no atomics, so a call repeats bit for bit.  Every mbarrier
// wait traps after seconds rather than hang the card.
//
// The LayerNorm mode (LN, WavLM's stack: a LayerNorm over the C channels of
// each frame after every conv, eps 1e-5, then GELU) needs each row's
// statistics over all C channels, but a tile holds BN of them.  So it runs
// as a cluster of C / BN blocks along the channel axis (2 at BN = 256, 4 at
// BN = 128), block rank r taking channels [r BN, (r + 1) BN) of every tile
// its cluster walks; the mainloop, the ring and the producer are the ones
// above.  In the epilogue each quad sums its row over the block's columns
// (shuffles), writes that partial into every block's exchange buffer
// (distributed shared memory, slot = its rank) and arrives on that block's
// exchange barrier; once the 64 * (C / BN) arrivals of the phase are in,
// every block sums the C / BN partials in rank order, so all hold the same
// mean.  A second exchange does the same for the sum of squared deviations
// from it.  Then (acc - mean) * rstd * gamma + beta, GELU, and the staged
// store, 128-byte rows in either output type.  One buffer and one barrier
// per exchange suffice: a block writes the next tile's partials only after
// its wait on this tile's other exchange, which needs every block's lanes
// to have read this one first.  No exchange runs in the GroupNorm mode,
// which compiles to what it was.
//
// Measured on the H100 (PERF.md §6, conv1 at [256, 32000]): 2.55 ms,
// 0.51 of the bound, against cuDNN's 4.01 on the same bf16 operands.
// Scratch builds put the time in the stages' round trip and the epilogue,
// not in the products: without the products 2.19 ms, without the GELU and
// stores 1.91, without the W loads or the A loads 2.30 each; a 2-CTA
// cluster that shared W by TMA multicast (a third fewer L2 reads a tile)
// took 3.64 ms and was not kept.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <array>
#include <mutex>
#include <unordered_map>

#include "bf16.cuh"
#include "device.cuh"
#include "hopper.cuh"

namespace edt {

constexpr int CW_BM = 128;         // output frames of a tile: two consumer warpgroups of 64
constexpr int CW_KS = 64;          // input channels of a stage: 128 bytes of bf16
constexpr int CW_THREADS = 288;    // warps 0-7 consume, warp 8 produces
constexpr int CW_RING = 196608;    // bytes of the stage ring
constexpr int CW_EPI = 64;         // output columns per epilogue pass
constexpr int CW_NTILES = 2;       // the wgmma tiles: BN = CW_TILE_BN[i]
constexpr int CW_TILE_BN[CW_NTILES] = {256, 128};

__host__ __device__ constexpr int cw_stage_bytes(int bn) { return (CW_BM + bn) * CW_KS * 2; }
__host__ __device__ constexpr int cw_stages(int bn) { return CW_RING / cw_stage_bytes(bn); }
// Dynamic shared bytes: 1 KB of alignment slack, the ring, the consumer
// warpgroups' epilogue tiles (64 x 64, sized for float32 output), the full
// and empty barriers.
__host__ __device__ constexpr int cw_smem_bytes(int bn) {
  return 1024 + cw_stages(bn) * cw_stage_bytes(bn) + 2 * 64 * CW_EPI * 4 + 2 * cw_stages(bn) * 8;
}
static_assert(cw_smem_bytes(256) <= 232448 && cw_smem_bytes(128) <= 232448, "a block's smem");

// The LayerNorm mode's shared bytes at a cluster of cl blocks: the ring, the
// consumer warpgroups' epilogue tiles of 128-byte rows, the block's gamma
// and beta, the two exchange buffers [cl][CW_BM], the full, empty and two
// exchange barriers.
constexpr int CW_LN_MAX_C = 1024;  // the widest LayerNorm stack: a cluster of at most 8 blocks
constexpr float CW_LN_EPS = 1e-5f;
__host__ __device__ constexpr int cw_smem_bytes_ln(int bn, int cl) {
  return 1024 + cw_stages(bn) * cw_stage_bytes(bn) + 2 * 64 * 128 + 2 * bn * 4 +
         2 * cl * CW_BM * 4 + (2 * cw_stages(bn) + 2) * 8;
}
static_assert(cw_smem_bytes_ln(256, CW_LN_MAX_C / 256) <= 232448 &&
                  cw_smem_bytes_ln(128, CW_LN_MAX_C / 128) <= 232448,
              "the LayerNorm mode's smem");

__device__ __forceinline__ float cw_gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The LayerNorm mode's exchange `buf` (0: the rows' sums, 1: their squared
// deviations): v[h], this quad's partial over the block's columns of block
// rows rb and rb + 8, becomes the sum over the cluster's cl blocks in rank
// order.  Lane l of the quad sends the pair to blocks l, l + 4, ... and
// arrives on their barrier; the wait then sees all 64 * cl arrivals of this
// phase (the __syncwarp orders the warp's reads of the buffer's last
// phase before the arrivals that let other blocks rewrite it).
__device__ __forceinline__ void cw_ln_exchange(float (&v)[2], float* xs, uint64_t* xbar, int buf,
                                               uint32_t parity, uint32_t rank, int cl, int rb,
                                               int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
    v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
  }
  float* bx = xs + buf * cl * CW_BM;
  __syncwarp();
  const uint32_t slot = smem_u32(bx + rank * CW_BM + rb), bar = smem_u32(xbar + buf);
  for (int k = lane & 3; k < cl; k += 4) {
    const uint32_t dst = mapa(slot, k);
    st_cluster(dst, v[0]);
    st_cluster(dst + 8 * 4, v[1]);
    mbar_arrive_cluster(mapa(bar, k));
  }
  mbar_wait_cluster_or_trap(xbar + buf, parity);
  v[0] = v[1] = 0.f;
  for (int k = 0; k < cl; ++k) {
    v[0] += bx[k * CW_BM + rb];
    v[1] += bx[k * CW_BM + rb + 8];
  }
}

// ta: the activations [B][Tin][C] bf16 (3-D, boxes 64 x 256 frames at
// stride 2 x 1); tw: W [C][KT C] bf16 (2-D, boxes 64 x BN).  out [B, M, C]
// as OutT.  tiles = B * tiles_m * (C / BN); grid <= tiles.  With LN, the
// layer's LayerNorm gamma and beta [C], and a launch in clusters of C / BN
// blocks (grid a multiple of it).
template <int KT, int BN, typename OutT, bool LN = false>
__global__ void __launch_bounds__(CW_THREADS, 1)
    conv_wgmma_kernel(__grid_constant__ const CUtensorMap ta, __grid_constant__ const CUtensorMap tw,
                      OutT* __restrict__ out, int M, int C, int tiles_m, int tiles,
                      const float* __restrict__ gamma, const float* __restrict__ beta) {
  constexpr int S = cw_stages(BN);
  constexpr int STAGE = cw_stage_bytes(BN);
  constexpr int A_BYTES = CW_BM * CW_KS * 2;
  constexpr int NACC = BN / 2;
  constexpr int EPI = LN ? 128 / (int)sizeof(OutT) : CW_EPI;  // output columns per epilogue pass
  constexpr int ROWB = EPI * (int)sizeof(OutT);  // bytes of a staged epilogue row
  constexpr int UPR = ROWB / 16;                 // its 16-byte units
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* epi = base + S * STAGE;                              // [2][64][ROWB]
  const int tiles_n = C / BN;
  float* gb = reinterpret_cast<float*>(epi + 2 * 64 * (LN ? ROWB : CW_EPI * 4));  // LN: gamma, beta
  float* xs = gb + (LN ? 2 * BN : 0);                            // LN: the exchange buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + (LN ? 2 * tiles_n * CW_BM : 0));
  uint64_t* empty = full + S;
  uint64_t* xbar = empty + S;  // LN: the exchange barriers
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ksteps = KT * (C / CW_KS);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases
    }
    if constexpr (LN) {
      mbar_init(&xbar[0], 64 * tiles_n);  // each quad of each block of the cluster arrives
      mbar_init(&xbar[1], 64 * tiles_n);
    }
    mbar_fence_init();
  }
  uint32_t rank = 0;
  if constexpr (LN) {
    // The schedule below gives block b the channel tile b % tiles_n: its
    // rank when the grid is whole clusters of tiles_n.
    rank = cluster_ctarank();
    if ((int)cluster_nctarank() != tiles_n || blockIdx.x % tiles_n != rank ||
        gridDim.x % tiles_n)
      __trap();
    for (int i = tid; i < BN; i += CW_THREADS) {
      gb[i] = gamma[rank * BN + i];
      gb[BN + i] = beta[rank * BN + i];
    }
    __syncthreads();
    cluster_sync();  // every block's barriers are set before any remote arrival
  } else {
    __syncthreads();
  }

  if (warp == 8) {  // the producer
    if (lane == 0) {
      prefetch_tmap(&ta);
      prefetch_tmap(&tw);
      uint32_t it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int nt = t % tiles_n, mt = t / tiles_n % tiles_m, b = t / (tiles_n * tiles_m);
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % S;
          mbar_wait_or_trap(&empty[s], (it / S & 1) ^ 1);  // the first round passes at once
          unsigned char* st = base + s * STAGE;
          const int j = ks / (C / CW_KS), c = ks % (C / CW_KS);
          mbar_expect_tx(&full[s], STAGE);
          tma_load_3d(st, &ta, &full[s], c * CW_KS, 2 * mt * CW_BM + j, b);
          tma_load_2d(st + A_BYTES, &tw, &full[s], ks * CW_KS, nt * BN);
        }
      }
    }
    return;
  }

  const int cw = warp / 4, w4 = warp % 4;  // consumer warpgroup, warp within it
  unsigned char* ep = epi + cw * 64 * ROWB;
  float acc[NACC];
  uint32_t it = 0, ln_parity = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int nt = t % tiles_n, mt = t / tiles_n % tiles_m, b = t / (tiles_n * tiles_m);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % S;
      mbar_wait_or_trap(&full[s], it / S & 1);
      const unsigned char* st = base + s * STAGE;
      const uint64_t da = wgmma_desc_sw128(st + cw * 64 * 128);  // this warpgroup's 64 frames
      const uint64_t db = wgmma_desc_sw128(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CW_KS / 16; ++kk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products have read their operands
      if (ks > 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % S]);

    // Accumulator 4j + e: row 16 w4 + lane/4 + 8 (e / 2), column 8j + 2 (lane
    // % 4) + e % 2 of the warpgroup's 64 x BN.
    const int m0 = mt * CW_BM + cw * 64, n0 = nt * BN;
    float mean[2] = {0.f, 0.f}, rstd[2] = {1.f, 1.f};
    if constexpr (LN) {  // the rows' statistics over all C channels, two exchanges
      const int rb = cw * 64 + 16 * w4 + lane / 4;
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NACC; ++i) v[(i >> 1) & 1] += acc[i];
      cw_ln_exchange(v, xs, xbar, 0, ln_parity, rank, tiles_n, rb, lane);
      mean[0] = v[0] / C, mean[1] = v[1] / C;
      v[0] = v[1] = 0.f;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const float d = acc[i] - mean[(i >> 1) & 1];
        v[(i >> 1) & 1] = fmaf(d, d, v[(i >> 1) & 1]);
      }
      cw_ln_exchange(v, xs, xbar, 1, ln_parity, rank, tiles_n, rb, lane);
      rstd[0] = rsqrtf(v[0] / C + CW_LN_EPS), rstd[1] = rsqrtf(v[1] / C + CW_LN_EPS);
      ln_parity ^= 1;
    }
#pragma unroll
    for (int p = 0; p < BN / EPI; ++p) {
#pragma unroll
      for (int jj = 0; jj < EPI / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w4 + lane / 4 + 8 * h;
          const int byte = (8 * jj + 2 * (lane % 4)) * (int)sizeof(OutT);
          const int a = 4 * (EPI / 8 * p + jj) + 2 * h;
          float y0 = acc[a], y1 = acc[a + 1];
          if constexpr (LN) {
            const int c = EPI * p + 8 * jj + 2 * (lane % 4);  // of the block's BN channels
            const float2 g = *reinterpret_cast<const float2*>(gb + c);
            const float2 be = *reinterpret_cast<const float2*>(gb + BN + c);
            y0 = fmaf((y0 - mean[h]) * rstd[h], g.x, be.x);
            y1 = fmaf((y1 - mean[h]) * rstd[h], g.y, be.y);
          }
          store2(reinterpret_cast<OutT*>(ep + r * ROWB + ((byte / 16) ^ (r & 7)) * 16 + byte % 16),
                 cw_gelu(y0), cw_gelu(y1));
        }
      named_sync(1 + cw, 128);
      for (int e = tid % 128; e < 64 * UPR; e += 128) {
        const int r = e / UPR, u = e % UPR;
        if (m0 + r < M)
          *reinterpret_cast<uint4*>(out + ((long long)b * M + m0 + r) * C + n0 + EPI * p +
                                    u * (16 / (int)sizeof(OutT))) =
              *reinterpret_cast<const uint4*>(ep + r * ROWB + (u ^ (r & 7)) * 16);
      }
      named_sync(1 + cw, 128);  // the tile is rewritten by the next pass
    }
  }
}

// ---- host side ------------------------------------------------------------

inline long long g_conv_wgmma_launches = 0;  // launches of conv_wgmma_kernel

// A tiled tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..), bf16, 128-byte swizzle, zeros out of bounds.  Encoded once per
// argument set and kept: a workspace buffer's maps are reused by every
// later call the allocator hands the same pointer.  Returns a cudaError_t.
inline int conv_tmap(const void* p, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, const cuuint32_t* estr, CUtensorMap* out) {
  using Key = std::array<unsigned long long, 15>;
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = 0;
      for (unsigned long long v : k) h = h * 0x9E3779B97F4A7C15ull + std::hash<unsigned long long>()(v);
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  Key key{};
  key[0] = reinterpret_cast<uintptr_t>(p);
  key[1] = (unsigned long long)rank;
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[5 + i] = box[i];
    key[8 + i] = estr[i];
    if (i + 1 < rank) key[11 + i] = strides[i];
  }
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap m;
  if (enc(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(p), dims,
          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, m);
  *out = m;
  return 0;
}

// A stride-2, KT-tap conv layer on the wgmma kernel in tile BN: in [B, Tin,
// C] bf16, W [C, KT C] bf16, out [B, M, C] as OutT.  With LN, in the
// LayerNorm mode with the layer's gamma and beta [C] (C <= CW_LN_MAX_C),
// launched in clusters of C / BN blocks, as many as can be resident at
// once.  Returns a cudaError_t.
template <int KT, int BN, typename OutT, bool LN = false>
int conv_wgmma(const bf16* in, int Tin, int C, const bf16* W, OutT* out, int M, int B,
               cudaStream_t st, const float* gamma = nullptr, const float* beta = nullptr) {
  if (C % BN || C % CW_KS || (LN && C > CW_LN_MAX_C)) return (int)cudaErrorInvalidValue;
  const auto kernel = conv_wgmma_kernel<KT, BN, OutT, LN>;
  const int cl = C / BN;
  const int smem = LN ? cw_smem_bytes_ln(BN, cl) : cw_smem_bytes(BN);
  static bool opted_in[kMaxDevices] = {};
  static int clusters[kMaxDevices][CW_LN_MAX_C / 128 + 1] = {};  // LN: resident clusters, by size
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LN ? cw_smem_bytes_ln(BN, CW_LN_MAX_C / BN) : cw_smem_bytes(BN));
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  CUtensorMap ta, tw;
  const cuuint64_t a_dims[3] = {(cuuint64_t)C, (cuuint64_t)Tin, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)Tin * C * 2};
  const cuuint32_t a_box[3] = {CW_KS, 2 * CW_BM, 1}, a_estr[3] = {1, 2, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)KT * C, (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)KT * C * 2};
  const cuuint32_t w_box[2] = {CW_KS, BN}, w_estr[2] = {1, 1};
  int e = conv_tmap(in, 3, a_dims, a_strides, a_box, a_estr, &ta);
  if (!e) e = conv_tmap(W, 2, w_dims, w_strides, w_box, w_estr, &tw);
  if (e) return e;
  const int tiles_m = (M + CW_BM - 1) / CW_BM;
  const long long tiles = (long long)B * tiles_m * (C / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if constexpr (LN) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cl), cfg.blockDim = dim3(CW_THREADS), cfg.dynamicSmemBytes = smem;
    cfg.stream = st, cfg.attrs = attr, cfg.numAttrs = 1;
    if (!clusters[dev][cl]) {
      int n = 0;
      const cudaError_t q = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (q != cudaSuccess) return (int)q;
      if (n < 1) return (int)cudaErrorInvalidConfiguration;
      clusters[dev][cl] = n;
    }
    const long long most = (long long)clusters[dev][cl] * cl;
    cfg.gridDim = dim3((unsigned)(tiles < most ? tiles : most));
    e = (int)cudaLaunchKernelEx(&cfg, kernel, ta, tw, out, M, C, tiles_m, (int)tiles, gamma, beta);
  } else {
    const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
    kernel<<<grid, CW_THREADS, smem, st>>>(ta, tw, out, M, C, tiles_m, (int)tiles, nullptr,
                                           nullptr);
    e = (int)cudaGetLastError();
  }
  if (!e) ++g_conv_wgmma_launches;
  return e;
}

}  // namespace edt
