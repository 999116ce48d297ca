// The HuBERT-base conv feature extractor: wav [B, Twav] -> features
// [B, frames, C], launched from one C host function.
//
// Replaces the TPU kernel edge_diffusion_tts_tpu/ops/fused_frontend.py::
// _frontend_kernel.  It computes, in float32, seven VALID convs with kernels
// [10,3,3,3,3,2,2] and strides [5,2,2,2,2,2,2], no bias, GroupNorm (one
// group per channel) on conv0, and erf-GELU after every layer: what
// models/hubert.py::FeatureExtractor computes.
//
// Design.  The TPU kernel climbs all seven layers per time tile in VMEM; on
// the H100 the conv0 tile alone ([3616, 512] f32, 7.4 MB) is 32x a block's
// 227 KB of shared memory.  So the layers run as a fixed sequence of seven
// launches, activations channels-last ([B, frames, C]) in a two-buffer
// workspace.  Each layer is one implicit-GEMM kernel: in channels-last
// layout, output frame t of a (k, s) conv reads input frames s*t .. s*t+k-1,
// which are k*C contiguous floats, so row t of the GEMM's A matrix is the
// input buffer at offset t*s*C with length K = k*C (rows overlap when k > s):
// no im2col tensor, and no even/odd phase reshapes (those exist on the TPU
// only because Mosaic has no strided slicing).  M = frames, N = C, K = k*C;
// the weights are packed [C_out, k*C_in] with k outer.  conv0 is the same
// GEMM with C_in = 1: A row t is wav + 5t, K = 10.  The epilogue applies, for
// conv0, the GroupNorm as a per-(batch, channel) scale and shift, and then
// GELU with erff.  The GroupNorm statistics need the whole time axis; they
// follow analytically from the [B, 10] patch mean and [B, 10, 10] patch Gram,
// which the Python wrapper computes with tensor ops (fused_frontend.py), so
// no second pass over conv0's output is needed.
//
// What bounds it: at B=1, 5 s (80,000 samples) the work is 24.53 GFLOP of
// float32 (conv1 12.58, conv2 6.29, conv3 3.14, conv4 1.57, conv5 0.52,
// conv6 0.26, conv0 0.16), 0.366 ms at 67 TFLOP/s; the weights are 16.8 MB
// and the wav 0.32 MB, so it is bound by operations.  This first version is
// a plain tiled FMA GEMM (64x64 output tile, 4x4 per thread, the next
// k-slice prefetched into registers while the current one is consumed).
// Tensor cores (wgmma, TMA) and a conv0->conv1 fusion that avoids the 32 MB
// conv0 round trip are later work.  No TF32 or bf16: bf16 flips ~4% of the
// FSQ tokens downstream.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;  // output frames per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // reduction depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int LOADS = BM * BK / THREADS;  // A (and W) elements each thread stages

// Load this thread's LOADS elements of the A and W k-slices at k0 into
// registers (zeros outside M, N, K).  Consecutive threads read consecutive k
// of one row: 64-byte runs of contiguous floats.
__device__ __forceinline__ void fetch_tile(const float* __restrict__ A, int lda,
                                           const float* __restrict__ W, int K, int M, int N,
                                           int m0, int n0, int k0, float (&a_reg)[LOADS],
                                           float (&w_reg)[LOADS]) {
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int row = e / BK, gk = k0 + e % BK;
    const int gm = m0 + row, gn = n0 + row;
    a_reg[i] = (gm < M && gk < K) ? A[(long long)gm * lda + gk] : 0.f;
    w_reg[i] = (gn < N && gk < K) ? W[(long long)gn * K + gk] : 0.f;
  }
}

// Store the fetched registers into the k-major shared tiles.
__device__ __forceinline__ void stage_tile(float (&As)[BK][BM + 4], float (&Ws)[BK][BN + 4],
                                           const float (&a_reg)[LOADS],
                                           const float (&w_reg)[LOADS]) {
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    As[e % BK][e / BK] = a_reg[i];
    Ws[e % BK][e / BK] = w_reg[i];
  }
}

// out[b, m, n] = gelu(acc * scale[b, n] + shift[b, n])  (GN)  or  gelu(acc),
// acc = sum_k in[b * in_bs + m * lda + k] * W[n * K + k],  m < M, n < N.
template <bool GN>
__global__ void __launch_bounds__(THREADS)
conv_gemm_kernel(const float* __restrict__ in, long long in_bs, int lda,
                 const float* __restrict__ W, int K, const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ out, long long out_bs,
                 int M, int N) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float* A = in + (long long)b * in_bs;
  const int tx = threadIdx.x % 16;  // 4 output channels each
  const int ty = threadIdx.x / 16;  // 4 output frames each
  float a_reg[LOADS], w_reg[LOADS];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch_tile(A, lda, W, K, M, N, m0, n0, 0, a_reg, w_reg);
  stage_tile(As, Ws, a_reg, w_reg);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch_tile(A, lda, W, K, M, N, m0, n0, k0 + BK, a_reg, w_reg);  // in flight
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage_tile(As, Ws, a_reg, w_reg);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if constexpr (GN) v = v * scale[(long long)b * N + gn] + shift[(long long)b * N + gn];
      v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      out[(long long)b * out_bs + (long long)gm * N + gn] = v;
    }
  }
}

template <bool GN>
int conv_gemm(const float* in, long long in_bs, int lda, const float* W, int K,
              const float* scale, const float* shift, float* out, long long out_bs, int M,
              int N, int B, cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, B);
  conv_gemm_kernel<GN><<<grid, THREADS, 0, st>>>(in, in_bs, lda, W, K, scale, shift, out,
                                                 out_bs, M, N);
  return (int)cudaGetLastError();
}

constexpr int LAYERS = 7;
constexpr int KERNEL[LAYERS] = {10, 3, 3, 3, 3, 2, 2};
constexpr int STRIDE[LAYERS] = {5, 2, 2, 2, 2, 2, 2};

void frame_counts(int Twav, int frames[LAYERS]) {
  int n = Twav;
  for (int i = 0; i < LAYERS; ++i) {
    n = (n - KERNEL[i]) / STRIDE[i] + 1;
    frames[i] = n;
  }
}

}  // namespace

// Floats of scratch that edt_conv_frontend needs: conv0's and conv1's
// outputs (every later layer fits in one of the two).
extern "C" long long edt_conv_frontend_workspace(int B, int Twav, int C) {
  int f[LAYERS];
  frame_counts(Twav, f);
  return (long long)B * ((long long)f[0] + f[1]) * C;
}

// wav [B, Twav]; out [B, frames, C] with frames = the last conv's count (the
// caller checks it is >= 1); work [edt_conv_frontend_workspace(...)].
// w0 [C, 10]; wk3 [4, C, 3C] (conv1-4) and wk2 [2, C, 2C] (conv5-6), each
// [C_out, k*C_in] with the tap index outer; scale, shift [B, C] (conv0's
// GroupNorm folded).  All contiguous float32 on the current device.
// Returns the first non-zero cudaError_t of any launch, else 0.
extern "C" int edt_conv_frontend(const float* wav, float* out, float* work, const float* w0,
                                 const float* wk3, const float* wk2, const float* scale,
                                 const float* shift, int B, int Twav, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int f[LAYERS];
  frame_counts(Twav, f);
  float* buf[2] = {work, work + (long long)B * f[0] * C};
  int err = conv_gemm<true>(wav, Twav, STRIDE[0], w0, KERNEL[0], scale, shift, buf[0],
                            (long long)f[0] * C, f[0], C, B, st);
  if (err) return err;
  for (int i = 1; i < LAYERS; ++i) {
    const int K = KERNEL[i] * C;
    const float* W = i <= 4 ? wk3 + (long long)(i - 1) * C * K : wk2 + (long long)(i - 5) * C * K;
    float* dst = i == LAYERS - 1 ? out : buf[i % 2];
    err = conv_gemm<false>(buf[(i - 1) % 2], (long long)f[i - 1] * C, STRIDE[i] * C, W, K,
                           nullptr, nullptr, dst, (long long)f[i] * C, f[i], C, B, st);
    if (err) return err;
  }
  return 0;
}
