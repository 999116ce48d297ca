// The HuBERT-base conv feature extractor: wav [B, Twav] -> features
// [B, frames, C], launched from one C host function.
//
// Replaces the TPU kernel edge_diffusion_tts_tpu/ops/fused_frontend.py::
// _frontend_kernel.  It computes, in float32, seven VALID convs with kernels
// [10,3,3,3,3,2,2] and strides [5,2,2,2,2,2,2], no bias, GroupNorm (one
// group per channel) on conv0, and erf-GELU after every layer: what
// models/hubert.py::FeatureExtractor computes.  That float32 variant uses no
// TF32 or bf16 (bf16 flips ~4% of the FSQ tokens downstream); the bf16
// variant below is the one a bf16 trainer asks for.
//
// The TPU kernel climbs all seven layers per time tile in VMEM; on the H100
// the conv0 tile alone ([3616, 512] f32, 7.4 MB) is 32x a block's 227 KB of
// shared memory.  So the layers run as a fixed sequence of launches,
// activations channels-last ([B, frames, C]) in a two-buffer workspace.
//
// What bounds it: at B=1, 5 s (80,000 samples) the work is 24.53 GFLOP of
// float32 (conv1 12.58, conv2 6.29, conv3 3.14, conv4 1.57, conv5 0.52,
// conv6 0.26, conv0 0.16), 0.366 ms at 67 TFLOP/s; the weights are 16.8 MB
// and the wav 0.32 MB, so it is bound by operations.  The products must then
// be fed from shared memory at a rate the FMA pipes can take, and from L2 at
// a rate an SM can pull: a 64x64 tile that fetched a 16-deep slice of A and
// W per 131 kFLOP (16 FLOP per byte) ran at 30% of the bound.
//
// conv1-6 (conv_slab_kernel): M = output frames, N = C, K = k*C.  A block
// computes a 128 x 128 output tile, 8 x 8 outputs per thread, and walks K in
// chunks of 16 input channels.  For each chunk it stages, once, the slab of
// input frames its rows touch (2*(128-1)+k frames x 16 channels: output
// frame t of a stride-2 conv reads frames 2t .. 2t+k-1, so neighbouring
// rows share frames) and the chunk's weights for all k taps, and takes all
// k taps from that slab: 2*128*128*k*16 FLOP per (257*16 + k*128*16) floats,
// 38 FLOP per byte at k = 3.  The chunks stream through a ring of 4 stages
// in dynamic shared memory (164 KB at k = 3: one block per SM), filled by
// 16-byte cp.async whose offsets each thread works out once per block, one
// __syncthreads per chunk.  Shared rows are XOR-swizzled by 16-byte unit so
// that a warp's float4 reads of 4 frames or 8 channels hit distinct banks
// (the layout TMA's 64-byte swizzle would give).  The sum over
// K runs chunk by chunk, and within a chunk over channel groups of 4, taps,
// then the 4 channels.  Layers whose tiles alone would not fill the card
// split K over whole chunks (the host's plan, ops/fused_frontend.py::
// frontend_plan, passes the factor per layer): each split writes its
// partial sums to the workspace and split_sum_gelu_kernel adds them in split
// order and applies GELU.  No atomics: two calls give the same bits.
//
// conv0 (conv0_kernel): C_in = 1, K = 10, stride 5: 0.16 GFLOP, bound by
// writing its [B, frames, C] output (32.8 MB at 5 s).  A block holds the
// wav samples of 16 output frames in shared memory (1000 blocks at 5 s, so
// enough warps are in flight to cover the stores); each thread keeps the
// weights of 4 channels in registers and writes one float4 per frame.  The
// epilogue applies the GroupNorm as a per-(batch, channel) scale and shift
// and then GELU.  The GroupNorm statistics need the whole time axis; they
// follow analytically from the [B, 10] patch mean and [B, 10, 10] patch Gram,
// which the Python wrapper computes with tensor ops (fused_frontend.py), so
// no second pass over conv0's output is needed.
//
// The bf16 variant (edt_conv_frontend_bf16, edt_conv_layer_bf16) computes
// the TPU kernel at compute_dtype=bfloat16: conv0, its GroupNorm and GELU in
// float32 on float32 patches, then a round to bf16 (RNE); conv1-5 on bf16
// activations and bf16 weights (rounded once, when packed), summed in
// float32, GELU in float32, rounded to bf16; conv6 the same but written as
// float32 features.  At [256, 32000] (a training batch of 2 s utterances)
// the stack is 2.51 TFLOP, bound by operations at 2.5 ms on bf16 tensor
// cores against 37.5 ms in float32 without them; the activations in bf16
// halve the bytes between layers.  conv1-6 (conv_slab_bf16_kernel) keep the
// float32 kernel's 128 x 128 tile and its cp.async ring, but the products
// run on tensor cores: mma.sync m16n8k16 (bf16 in, float32 accumulate),
// operands loaded from shared memory by ldmatrix.  Each of 8 warps owns a
// 64 x 32 sub-tile (4 x 4 mma tiles).  A chunk is 32 input channels (64-byte
// rows); the slab of input frames is stored de-interleaved (even frames,
// then odd), so that output frame t's tap j reads row t + j/2 of one
// parity and a warp's 8 ldmatrix rows are consecutive; a row's four 16-byte
// units are XOR-swizzled by (row >> 1) & 3, which puts any 8 consecutive
// rows on distinct banks.  4 stages of 41 KB (k = 3) or 33 KB (k = 2):
// 160.5 KB of the 227 KB a block may hold, one block per SM.  Split-K keeps
// float32 partial sums and the same fixed-order reduction, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <type_traits>

#include "cp_async.cuh"
#include "device.cuh"

namespace {

constexpr int LAYERS = 7;
constexpr int KERNEL[LAYERS] = {10, 3, 3, 3, 3, 2, 2};
constexpr int STRIDE[LAYERS] = {5, 2, 2, 2, 2, 2, 2};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

using bf16 = __nv_bfloat16;

// Stores of float32 results as float32 or as bf16 (RNE, as `.astype`).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);  // a first
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---- conv0 ------------------------------------------------------------------

constexpr int K0 = 10, S0 = 5;  // conv0's kernel and stride (scalars: device code reads them)
constexpr int ROWS0 = 16;       // output frames per block
constexpr int SEG0 = S0 * (ROWS0 - 1) + K0;  // wav samples they read

// out[b, t, n] = gelu(scale[b, n] * sum_j wav[b, 5t + j] * w0[n, j] + shift[b, n]),
// all in float32, stored as OutT (float32, or bf16 for the bf16 variant);
// C / 4 threads, 4 channels each.
template <typename OutT>
__global__ void __launch_bounds__(1024)
conv0_kernel(const float* __restrict__ wav, int Twav, const float* __restrict__ w0,
             const float* __restrict__ scale, const float* __restrict__ shift,
             OutT* __restrict__ out, int M, int C) {
  __shared__ float seg[SEG0];
  const int b = blockIdx.y, t0 = blockIdx.x * ROWS0;
  const long long x0 = (long long)S0 * t0;
  for (int i = threadIdx.x; i < SEG0; i += blockDim.x)
    seg[i] = x0 + i < Twav ? wav[(long long)b * Twav + x0 + i] : 0.f;
  const int n = 4 * threadIdx.x;
  float w[4 * K0];  // channels n .. n+3, 10 taps each: 40 floats, 16-byte aligned
  const float4* wp = reinterpret_cast<const float4*>(w0 + (long long)n * K0);
#pragma unroll
  for (int q = 0; q < K0; ++q) {
    const float4 v = wp[q];
    w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(scale + (long long)b * C + n);
  const float4 sh = *reinterpret_cast<const float4*>(shift + (long long)b * C + n);
  const float scs[4] = {sc.x, sc.y, sc.z, sc.w}, shs[4] = {sh.x, sh.y, sh.z, sh.w};
  __syncthreads();
  for (int r = 0; r < ROWS0 && t0 + r < M; ++r) {
    const float* p = seg + S0 * r;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K0; ++j) acc = fmaf(p[j], w[c * K0 + j], acc);
      v[c] = gelu(acc * scs[c] + shs[c]);
    }
    store4(out + ((long long)b * M + t0 + r) * C + n, v[0], v[1], v[2], v[3]);
  }
}

template <typename OutT>
int conv0(const float* wav, int Twav, const float* w0, const float* scale, const float* shift,
          OutT* out, int M, int C, int B, cudaStream_t st) {
  conv0_kernel<OutT><<<dim3((M + ROWS0 - 1) / ROWS0, B), C / 4, 0, st>>>(wav, Twav, w0, scale,
                                                                       shift, out, M, C);
  return (int)cudaGetLastError();
}

// ---- conv1-6 ----------------------------------------------------------------

constexpr int BM = 128;     // output frames per block
constexpr int BN = 128;     // output channels per block
constexpr int CH = 16;      // input channels per K chunk
constexpr int UNITS = CH / 4;  // 16-byte units per staged row
constexpr int STAGES = 4;   // chunks in the cp.async ring
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

// One ring stage for a conv of KT taps, stride 2: the slab of input frames
// [FRAMES][CH] and the weights [KT][BN][CH], in floats.
template <int KT>
struct Stage {
  static constexpr int FRAMES = 2 * (BM - 1) + KT;
  static constexpr int SLAB = FRAMES * CH;
  static constexpr int FLOATS = SLAB + KT * BN * CH;
  static constexpr int BYTES = STAGES * FLOATS * 4;  // the ring
};

// 16-byte unit g of staged row `row` lives at unit g ^ ((row >> 1) & 3): a
// warp's reads of 4 frames 2 apart or of 8 consecutive weight rows then fall
// on distinct banks.
__device__ __forceinline__ int swz(int row, int g) { return row * CH + 4 * (g ^ ((row >> 1) & 3)); }

// This thread's share of staging a chunk, fixed for the block and worked
// out once: for each of its 16-byte copies the source offset from the
// chunk's first channel (slab rows from the block's first input frame,
// weight rows from W) and the swizzled destination in the stage.  A slab
// copy past Tin is zero-filled (source -1); a destination -1 is no copy.
template <int KT>
struct Copies {
  static constexpr int NA = (Stage<KT>::FRAMES * UNITS + THREADS - 1) / THREADS;
  static constexpr int NW = KT * BN * UNITS / THREADS;
  static_assert(KT * BN * UNITS % THREADS == 0, "weight copies split evenly");
  int a_src[NA], a_dst[NA], w_src[NW], w_dst[NW];

  __device__ __forceinline__ Copies(int Tin, int C, int f0, int n0) {
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int e = threadIdx.x + k * THREADS, f = e / UNITS, g = e % UNITS;
      a_dst[k] = e < Stage<KT>::FRAMES * UNITS ? swz(f, g) : -1;
      a_src[k] = f0 + f < Tin ? f * C + 4 * g : -1;
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int g = e % UNITS, n = (e / UNITS) % BN, j = e / (UNITS * BN);
      w_dst[k] = Stage<KT>::SLAB + swz(j * BN + n, g);
      w_src[k] = (n0 + n) * KT * C + j * C + 4 * g;
    }
  }

  // Stage channels [c0, c0 + CH) of the slab (input frames from the block's
  // first, A) and of the weights into `st`.
  __device__ __forceinline__ void copy_chunk(float* st, const float* A, const float* W,
                                             int c0) const {
#pragma unroll
    for (int k = 0; k < NA; ++k)
      if (a_dst[k] >= 0) edt::cp_async16(st + a_dst[k], A + max(a_src[k], 0) + c0, a_src[k] >= 0);
#pragma unroll
    for (int k = 0; k < NW; ++k) edt::cp_async16(st + w_dst[k], W + w_src[k] + c0, true);
  }
};

// acc[i][c] += sum over the chunk's channels and taps of A[2(ty+16i)+j][ch] *
// W[j][tx+16c][ch].
template <int KT>
__device__ __forceinline__ void chunk_products(const float* st, int tx, int ty,
                                               float (&acc)[8][8]) {
  const float* ws = st + Stage<KT>::SLAB;
#pragma unroll
  for (int g = 0; g < UNITS; ++g) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float4 w[8];
      const float* wrow = ws + swz(j * BN + tx, g);  // rows tx + 16c share the swizzle
#pragma unroll
      for (int c = 0; c < 8; ++c) w[c] = *reinterpret_cast<const float4*>(wrow + 16 * c * CH);
      const float* arow = st + swz(2 * ty + j, g);  // frames 2ty + j + 32i share it too
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(arow + 32 * i * CH);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a.x, w[c].x, acc[i][c]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a.y, w[c].y, acc[i][c]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a.z, w[c].z, acc[i][c]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a.w, w[c].w, acc[i][c]);
      }
    }
  }
}

// Split s of `splits` of a stride-2, KT-tap conv over in [B, Tin, C], W
// [C, KT*C] (tap outer): with one split, out [B, M, C] = gelu(sum); else
// part gets the partial sums [splits, B, M, C] of input-channel chunks
// [s*Q/splits, (s+1)*Q/splits), Q = C / CH.  Grid (C / BN, ceil(M / BM),
// B * splits).
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
conv_slab_kernel(const float* __restrict__ in, int Tin, int C, const float* __restrict__ W,
                 float* __restrict__ out, float* __restrict__ part, int M, int splits) {
  extern __shared__ __align__(16) float ring[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int B = gridDim.z / splits, b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int q0 = s * (C / CH) / splits, chunks = (s + 1) * (C / CH) / splits - q0;
  const float* A = in + ((long long)b * Tin + 2 * m0) * C;  // the block's first input frame
  const Copies<KT> copies(Tin, C, 2 * m0, n0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (lane & 7) + 8 * (warp & 1);   // a warp: 8 consecutive columns
  const int ty = (lane >> 3) + 4 * (warp >> 1);  // x 4 consecutive rows

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < chunks) copies.copy_chunk(ring + p * Stage<KT>::FLOATS, A, W, (q0 + p) * CH);
    edt::cp_async_commit();
  }
  for (int q = 0; q < chunks; ++q) {
    edt::cp_async_wait<STAGES - 2>();  // chunk q has landed (this thread's copies)
    __syncthreads();                   // everyone's, and stage q-1 is free again
    const int next = q + STAGES - 1;
    if (next < chunks)
      copies.copy_chunk(ring + (next % STAGES) * Stage<KT>::FLOATS, A, W, (q0 + next) * CH);
    edt::cp_async_commit();
    chunk_products<KT>(ring + (q % STAGES) * Stage<KT>::FLOATS, tx, ty, acc);
  }

  float* dst = (splits == 1 ? out + (long long)b * M * C : part + (long long)(s * B + b) * M * C) +
               n0 + tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      dst[(long long)m * C + 16 * c] = splits == 1 ? gelu(acc[i][c]) : acc[i][c];
  }
}

// out[e] = gelu(part[0][e] + part[1][e] + ... + part[splits-1][e]), in that
// order, stored as OutT; n4 float4s per split.
template <typename OutT>
__global__ void split_sum_gelu_kernel(const float4* __restrict__ part, OutT* __restrict__ out,
                                      long long n4, int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n4;
       e += (long long)gridDim.x * blockDim.x) {
    float4 v = part[e];
    for (int s = 1; s < splits; ++s) {
      const float4 p = part[s * n4 + e];
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
    store4(out + 4 * e, gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
  }
}

void frame_counts(int Twav, int frames[LAYERS]) {
  int n = Twav;
  for (int i = 0; i < LAYERS; ++i) {
    n = (n - KERNEL[i]) / STRIDE[i] + 1;
    frames[i] = n;
  }
}

bool shapes_ok(int C, int splits) {
  return C % BN == 0 && C % CH == 0 && C / 4 <= 1024 && splits >= 1 && splits <= C / CH;
}

// ---- the bf16 variant ---------------------------------------------------------

constexpr int CHB = 32;           // bf16: input channels per K chunk (64-byte rows)
constexpr int UNITS_B = CHB / 8;  // 16-byte units per staged row
constexpr int HALF = BM + 1;      // slab rows of one parity (even frames: up to BM + 1)

// One ring stage, in bf16 elements: the slab [2][HALF][CHB] (even input
// frames, then odd) and the weights [KT][BN][CHB].
template <int KT>
struct StageB {
  static constexpr int FRAMES = 2 * (BM - 1) + KT;
  static constexpr int SLAB = 2 * HALF * CHB;
  static constexpr int ELEMS = SLAB + KT * BN * CHB;
  static constexpr int BYTES = STAGES * ELEMS * 2;  // the ring
};
static_assert(StageB<3>::BYTES <= 232448, "the k = 3 ring fits a block's shared memory");

// Unit g of staged row `row` lives at unit g ^ ((row >> 1) & 3): any 8
// consecutive rows (an ldmatrix phase) then fall on distinct banks.
__device__ __forceinline__ int swzb(int row, int g) {
  return row * CHB + 8 * (g ^ ((row >> 1) & 3));
}

// The slab row of input frame f (from the block's first): its parity's
// half, then f / 2.
__device__ __forceinline__ int slab_row(int f) { return (f & 1) * HALF + (f >> 1); }

// Copies<KT> for bf16 stages: per thread, the source offsets (elements
// from the chunk's first channel) and swizzled destinations of its 16-byte
// copies; a slab copy past Tin is zero-filled (source -1).
template <int KT>
struct CopiesB {
  static constexpr int NA = (StageB<KT>::FRAMES * UNITS_B + THREADS - 1) / THREADS;
  static constexpr int NW = KT * BN * UNITS_B / THREADS;
  static_assert(KT * BN * UNITS_B % THREADS == 0, "weight copies split evenly");
  int a_src[NA], a_dst[NA], w_src[NW], w_dst[NW];

  __device__ __forceinline__ CopiesB(int Tin, int C, int f0, int n0) {
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int e = threadIdx.x + k * THREADS, f = e / UNITS_B, g = e % UNITS_B;
      a_dst[k] = e < StageB<KT>::FRAMES * UNITS_B ? swzb(slab_row(f), g) : -1;
      a_src[k] = f0 + f < Tin ? f * C + 8 * g : -1;
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int g = e % UNITS_B, n = (e / UNITS_B) % BN, j = e / (UNITS_B * BN);
      w_dst[k] = StageB<KT>::SLAB + swzb(j * BN + n, g);
      w_src[k] = (n0 + n) * KT * C + j * C + 8 * g;
    }
  }

  __device__ __forceinline__ void copy_chunk(bf16* st, const bf16* A, const bf16* W,
                                             int c0) const {
#pragma unroll
    for (int k = 0; k < NA; ++k)
      if (a_dst[k] >= 0) edt::cp_async16(st + a_dst[k], A + max(a_src[k], 0) + c0, a_src[k] >= 0);
#pragma unroll
    for (int k = 0; k < NW; ++k) edt::cp_async16(st + w_dst[k], W + w_src[k] + c0, true);
  }
};

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][q] (the warp's 16 x 8 tile i, q of its 64 x 32) += the chunk's
// products over its taps and 32 channels: A rows are output frames (frame
// t, tap j reads slab frame 2t + j), B columns output channels.
template <int KT>
__device__ __forceinline__ void chunk_mma(const bf16* st, int lane, int wm, int wn,
                                          float (&acc)[4][4][4]) {
  const bf16* ws = st + StageB<KT>::SLAB;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int kk = 0; kk < CHB / 16; ++kk) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 64 * wm + 16 * i + (lane & 15);  // lanes 16-31: the upper 8 channels
        ldsm_x4(a[i], st + swzb((j & 1) * HALF + t + (j >> 1), 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int n = 32 * wn + 16 * pp + (lane & 7) + ((lane >> 4) << 3);
        unsigned r[4];
        ldsm_x4(r, ws + swzb(j * BN + n, 2 * kk + ((lane >> 3) & 1)));
        b[2 * pp][0] = r[0], b[2 * pp][1] = r[1];
        b[2 * pp + 1][0] = r[2], b[2 * pp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_bf16(acc[i][q], a[i], b[q][0], b[q][1]);
    }
  }
}

// conv_slab_kernel's work with bf16 operands on tensor cores: split s of
// `splits` over in [B, Tin, C] bf16 and W [C, KT*C] bf16; with one split,
// out [B, M, C] = gelu(sum) as OutT (bf16, or float32 for the last layer);
// else float32 partial sums [splits, B, M, C] into part.  Grid (C / BN,
// ceil(M / BM), B * splits); 8 warps, 2 (rows) x 4 (channels).
template <int KT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
conv_slab_bf16_kernel(const bf16* __restrict__ in, int Tin, int C, const bf16* __restrict__ W,
                      OutT* __restrict__ out, float* __restrict__ part, int M, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int B = gridDim.z / splits, b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int q0 = s * (C / CHB) / splits, chunks = (s + 1) * (C / CHB) / splits - q0;
  const bf16* A = in + ((long long)b * Tin + 2 * m0) * C;
  const CopiesB<KT> copies(Tin, C, 2 * m0, n0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < chunks) copies.copy_chunk(ring + p * StageB<KT>::ELEMS, A, W, (q0 + p) * CHB);
    edt::cp_async_commit();
  }
  for (int q = 0; q < chunks; ++q) {
    edt::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = q + STAGES - 1;
    if (next < chunks)
      copies.copy_chunk(ring + (next % STAGES) * StageB<KT>::ELEMS, A, W, (q0 + next) * CHB);
    edt::cp_async_commit();
    chunk_mma<KT>(ring + (q % STAGES) * StageB<KT>::ELEMS, lane, wm, wn, acc);
  }

  // Fragment (i, q) element e: row 16i + lane/4 (+8 for e >= 2), columns
  // 8q + 2 (lane % 4) + (e & 1) of the warp's sub-tile.
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 32 * wn + 8 * q + 2 * tq;
        const float v0 = acc[i][q][2 * h], v1 = acc[i][q][2 * h + 1];
        if (splits == 1)
          store2(out + ((long long)b * M + m) * C + n, gelu(v0), gelu(v1));
        else
          store2(part + ((long long)(s * B + b) * M + m) * C + n, v0, v1);
      }
    }
}

// ---- the launchers of both variants -------------------------------------------

// A stride-2, KT-tap conv layer: the float32 slab kernel (InT float) or the
// bf16 one, then, with splits > 1, the split sum of its partial sums.
template <int KT, typename InT, typename OutT>
int conv_slab(const InT* in, int Tin, int C, const InT* W, OutT* out, float* part, int M, int B,
              int splits, cudaStream_t st) {
  constexpr bool f32 = std::is_same<InT, float>::value;
  static_assert(!f32 || std::is_same<OutT, float>::value, "the float32 kernel writes float32");
  constexpr int bytes = f32 ? Stage<KT>::BYTES : StageB<KT>::BYTES;
  // The attribute is per device: set once on each, before any graph capture.
  static bool smem_set[edt::kMaxDevices] = {};
  const int dev = edt::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t err;
    if constexpr (f32)
      err = cudaFuncSetAttribute(conv_slab_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    else
      err = cudaFuncSetAttribute(conv_slab_bf16_kernel<KT, OutT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return (int)err;
    smem_set[dev] = true;
  }
  const dim3 grid(C / BN, (M + BM - 1) / BM, B * splits);
  if constexpr (f32)
    conv_slab_kernel<KT><<<grid, THREADS, bytes, st>>>(in, Tin, C, W, out, part, M, splits);
  else
    conv_slab_bf16_kernel<KT, OutT><<<grid, THREADS, bytes, st>>>(in, Tin, C, W, out, part, M,
                                                                  splits);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long n4 = (long long)B * M * C / 4;
  const long long blocks = (n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056;
  split_sum_gelu_kernel<OutT><<<(int)blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(part),
                                                           out, n4, splits);
  return (int)cudaGetLastError();
}

// Layer `layer` (0-6): in -> out, partial sums (split > 1) in `part`.
int conv_layer(const float* in, float* out, float* part, const float* W, const float* scale,
               const float* shift, int layer, int B, int Tin, int C, int splits,
               cudaStream_t st) {
  if (!shapes_ok(C, splits)) return (int)cudaErrorInvalidValue;
  const int M = (Tin - KERNEL[layer]) / STRIDE[layer] + 1;
  if (layer == 0) return conv0(in, Tin, W, scale, shift, out, M, C, B, st);
  if (KERNEL[layer] == 3) return conv_slab<3>(in, Tin, C, W, out, part, M, B, splits, st);
  return conv_slab<2>(in, Tin, C, W, out, part, M, B, splits, st);
}

bool shapes_ok_bf16(int C, int splits) {
  return C % BN == 0 && C % CHB == 0 && C / 4 <= 1024 && splits >= 1 && splits <= C / CHB;
}

// Layer `layer` of the bf16 variant: in is the float32 wav (layer 0) or bf16
// [B, Tin, C]; out bf16 [B, Tout, C] (layers 0-5) or float32 (layer 6); W
// float32 w0 (layer 0) or bf16 [C, k*C].
int conv_layer_bf16(const void* in, void* out, float* part, const void* W, const float* scale,
                    const float* shift, int layer, int B, int Tin, int C, int splits,
                    cudaStream_t st) {
  if (!shapes_ok_bf16(C, splits)) return (int)cudaErrorInvalidValue;
  const int M = (Tin - KERNEL[layer]) / STRIDE[layer] + 1;
  if (layer == 0)
    return conv0(static_cast<const float*>(in), Tin, static_cast<const float*>(W), scale, shift,
                 static_cast<bf16*>(out), M, C, B, st);
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* w = static_cast<const bf16*>(W);
  if (layer == LAYERS - 1)
    return conv_slab<2>(x, Tin, C, w, static_cast<float*>(out), part, M, B, splits, st);
  if (KERNEL[layer] == 3)
    return conv_slab<3>(x, Tin, C, w, static_cast<bf16*>(out), part, M, B, splits, st);
  return conv_slab<2>(x, Tin, C, w, static_cast<bf16*>(out), part, M, B, splits, st);
}

}  // namespace

// Floats of scratch that edt_conv_frontend needs with the split-K factors
// splits[7] (splits[0] is conv0's, 1): conv0's and conv1's outputs (every
// later layer fits in one of the two), then the largest split layer's
// partial sums.
extern "C" long long edt_conv_frontend_workspace(int B, int Twav, int C, const int* splits) {
  int f[LAYERS];
  frame_counts(Twav, f);
  long long partials = 0;
  for (int i = 1; i < LAYERS; ++i)
    if (splits[i] > 1) partials = std::max(partials, (long long)splits[i] * f[i]);
  return (long long)B * C * ((long long)f[0] + f[1] + partials);
}

// One layer alone (a test and timing hook): in [B, Tin] (layer 0, with
// scale and shift [B, C]) or [B, Tin, C]; out [B, Tout, C]; W the layer's
// packed weights; work [splits * B * Tout * C] floats when splits > 1.
extern "C" int edt_conv_layer(const float* in, float* out, float* work, const float* W,
                              const float* scale, const float* shift, int layer, int B,
                              int Tin, int C, int splits, void* stream) {
  if (layer < 0 || layer >= LAYERS) return (int)cudaErrorInvalidValue;
  return conv_layer(in, out, work, W, scale, shift, layer, B, Tin, C, layer ? splits : 1,
                    (cudaStream_t)stream);
}

// wav [B, Twav]; out [B, frames, C] with frames = the last conv's count (the
// caller checks it is >= 1); work [edt_conv_frontend_workspace(...)].
// w0 [C, 10]; wk3 [4, C, 3C] (conv1-4) and wk2 [2, C, 2C] (conv5-6), each
// [C_out, k*C_in] with the tap index outer; scale, shift [B, C] (conv0's
// GroupNorm folded); splits [7], the split-K factor of each layer.  All
// contiguous float32 on the current device.
// Returns the first non-zero cudaError_t of any launch, else 0.
extern "C" int edt_conv_frontend(const float* wav, float* out, float* work, const float* w0,
                                 const float* wk3, const float* wk2, const float* scale,
                                 const float* shift, int B, int Twav, int C, const int* splits,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int f[LAYERS];
  frame_counts(Twav, f);
  float* buf[2] = {work, work + (long long)B * f[0] * C};
  float* part = buf[1] + (long long)B * f[1] * C;
  int err = conv_layer(wav, buf[0], nullptr, w0, scale, shift, 0, B, Twav, C, 1, st);
  for (int i = 1; i < LAYERS && !err; ++i) {
    const int K = KERNEL[i] * C;
    const float* W = i <= 4 ? wk3 + (long long)(i - 1) * C * K : wk2 + (long long)(i - 5) * C * K;
    err = conv_layer(buf[(i - 1) % 2], i == LAYERS - 1 ? out : buf[i % 2], part, W, nullptr,
                     nullptr, i, B, f[i - 1], C, splits[i], st);
  }
  return err;
}

// Bytes of scratch that edt_conv_frontend_bf16 needs: conv0's and conv1's
// outputs in bf16, then the largest split layer's float32 partial sums.
extern "C" long long edt_conv_frontend_bf16_workspace(int B, int Twav, int C, const int* splits) {
  int f[LAYERS];
  frame_counts(Twav, f);
  long long partials = 0;
  for (int i = 1; i < LAYERS; ++i)
    if (splits[i] > 1) partials = std::max(partials, (long long)splits[i] * f[i]);
  return (long long)B * C * (2 * ((long long)f[0] + f[1]) + 4 * partials);
}

// One layer of the bf16 variant alone (a test and timing hook): in the
// float32 wav [B, Tin] (layer 0, with scale and shift) or bf16 [B, Tin, C];
// out bf16 [B, Tout, C] (layers 0-5) or float32 (layer 6); W float32 w0 or
// the layer's packed bf16 weights; work [splits * B * Tout * C] floats when
// splits > 1.
extern "C" int edt_conv_layer_bf16(const void* in, void* out, float* work, const void* W,
                                   const float* scale, const float* shift, int layer, int B,
                                   int Tin, int C, int splits, void* stream) {
  if (layer < 0 || layer >= LAYERS) return (int)cudaErrorInvalidValue;
  return conv_layer_bf16(in, out, work, W, scale, shift, layer, B, Tin, C, layer ? splits : 1,
                         (cudaStream_t)stream);
}

// edt_conv_frontend at compute_dtype bf16: wav [B, Twav], w0, scale, shift
// float32; wk3 [4, C, 3C] and wk2 [2, C, 2C] bf16; out [B, frames, C]
// float32; work [edt_conv_frontend_bf16_workspace(...)] bytes.
extern "C" int edt_conv_frontend_bf16(const float* wav, float* out, void* work, const float* w0,
                                      const void* wk3, const void* wk2, const float* scale,
                                      const float* shift, int B, int Twav, int C,
                                      const int* splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int f[LAYERS];
  frame_counts(Twav, f);
  bf16* buf[2] = {static_cast<bf16*>(work), static_cast<bf16*>(work) + (long long)B * f[0] * C};
  float* part = reinterpret_cast<float*>(buf[1] + (long long)B * f[1] * C);
  const bf16* w3 = static_cast<const bf16*>(wk3);
  const bf16* w2 = static_cast<const bf16*>(wk2);
  int err = conv_layer_bf16(wav, buf[0], nullptr, w0, scale, shift, 0, B, Twav, C, 1, st);
  for (int i = 1; i < LAYERS && !err; ++i) {
    const int K = KERNEL[i] * C;
    const bf16* W = i <= 4 ? w3 + (long long)(i - 1) * C * K : w2 + (long long)(i - 5) * C * K;
    void* dst = i == LAYERS - 1 ? static_cast<void*>(out) : static_cast<void*>(buf[i % 2]);
    err = conv_layer_bf16(buf[(i - 1) % 2], dst, part, W, nullptr, nullptr, i, B, f[i - 1], C,
                          splits[i], st);
  }
  return err;
}
