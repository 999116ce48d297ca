// Banded / full attention device code shared by band_attention.cu and
// fused_ddim.cu.
//
// Replaces the TPU kernel edge_diffusion_tts_tpu/ops/window_attention.py::
// _band_kernel (and the banded softmax inside fused_denoise.py::
// _denoise_kernel).  Query row i attends key j iff |i - j| <= window and
// j < kv_len; the softmax and every product run in float32.
//
// What bounds it on the H100: the arithmetic is ~4*d*(2w+1) FLOP per query
// row, far below what the card does per byte, so it is bound by moving q, k,
// v, o through HBM once and by latency at small T.  Design:
//   * one block per (batch*head, ATT_ROWS query rows); blocks are
//     independent, so the TPU kernel's sequential k-tile grid becomes a loop
//     inside the block over only the key chunks the block's band touches;
//   * each ATT_KEYS-key chunk of K and V is staged in shared memory once and
//     read by all the block's rows; the head is padded to DP (a multiple of
//     8) with zeros, and each shared row is padded by one float so that rows
//     read together fall in different banks;
//   * ATT_SPLIT adjacent threads share a query row: each keeps an online
//     softmax (running max, denominator, DP-wide accumulator) in registers
//     over every ATT_SPLIT-th key, and the partial states merge with warp
//     shuffles at the end.  A row with no admissible key writes zeros.
// Strides are explicit, so the fused kernel reads q/k/v straight out of its
// [B, T, 3H] qkv buffer and the cross K/V out of its [B, S, 2H] buffer.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace edt {

struct AttnArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_sr;     // batch, head and row strides of q
  long long kv_sb, kv_sh, kv_sr;  // the same for k and v
  long long o_sb, o_sh, o_sr;     // the same for o
  int heads;
  int tq;      // query rows
  int tk;      // key rows
  int d;       // head dim
  int window;  // attend iff |i - j| <= window
  int kv_len;  // attend iff j < kv_len
  float scale;
};

constexpr int ATT_ROWS = 64;
constexpr int ATT_SPLIT = 4;
constexpr int ATT_KEYS = 64;
constexpr int ATT_THREADS = ATT_ROWS * ATT_SPLIT;

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS) band_attention_kernel(AttnArgs a) {
  __shared__ float ks[ATT_KEYS][DP + 1];
  __shared__ float vs[ATT_KEYS][DP + 1];

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * ATT_ROWS;
  const int r = threadIdx.x / ATT_SPLIT;
  const int s = threadIdx.x % ATT_SPLIT;
  const int i = q0 + r;
  const bool row_ok = i < a.tq;

  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.kv_sb + h * a.kv_sh;
  const float* vb = a.v + b * a.kv_sb + h * a.kv_sh;

  float q[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    q[c] = (row_ok && c < a.d) ? qb[(long long)i * a.q_sr + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int kend = min(a.tk, a.kv_len);
  const int lo = max(0, q0 - a.window);
  const int hi = min(kend, q0 + ATT_ROWS + a.window);
  for (int c0 = lo; c0 < hi; c0 += ATT_KEYS) {
    const int n = min(ATT_KEYS, hi - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < ATT_KEYS * DP; e += ATT_THREADS) {
      const int kr = e / DP;
      const int c = e % DP;
      float kv = 0.f, vv = 0.f;
      if (kr < n && c < a.d) {
        const long long off = (long long)(c0 + kr) * a.kv_sr + c;
        kv = kb[off];
        vv = vb[off];
      }
      ks[kr][c] = kv;
      vs[kr][c] = vv;
    }
    __syncthreads();
    if (row_ok) {
      const int jlo = max(c0, i - a.window);
      const int jhi = min(c0 + n, i + a.window + 1);
      for (int j = jlo + s; j < jhi; j += ATT_SPLIT) {
        const float* kr = ks[j - c0];
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) dot = fmaf(q[c], kr[c], dot);
        const float sc = dot * a.scale;
        if (sc > m) {
          const float alpha = expf(m - sc);
          l *= alpha;
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[c] *= alpha;
          m = sc;
        }
        const float p = expf(sc - m);
        l += p;
        const float* vr = vs[j - c0];
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
    }
  }

  // Merge the ATT_SPLIT partial softmax states of a row (adjacent lanes).
  float mx = m;
#pragma unroll
  for (int off = 1; off < ATT_SPLIT; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float alpha = (m == -INFINITY) ? 0.f : expf(m - mx);
  l *= alpha;
#pragma unroll
  for (int off = 1; off < ATT_SPLIT; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    float x = acc[c] * alpha;
#pragma unroll
    for (int off = 1; off < ATT_SPLIT; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    acc[c] = x;
  }
  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* ob = a.o + b * a.o_sb + h * a.o_sh + (long long)i * a.o_sr;
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c % ATT_SPLIT == s && c < a.d) ob[c] = acc[c] * inv;
  }
}

// Launch over `batch` * a.heads (batch, head) pairs; returns a cudaError_t.
static inline int launch_attention(const AttnArgs& a, int batch, cudaStream_t stream) {
  if (a.tq <= 0 || batch <= 0) return 0;
  const dim3 grid((a.tq + ATT_ROWS - 1) / ATT_ROWS, batch * a.heads);
  switch ((a.d + 7) / 8 * 8) {
    case 8: band_attention_kernel<8><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 16: band_attention_kernel<16><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 24: band_attention_kernel<24><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 32: band_attention_kernel<32><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 40: band_attention_kernel<40><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 48: band_attention_kernel<48><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 56: band_attention_kernel<56><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    case 64: band_attention_kernel<64><<<grid, ATT_THREADS, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace edt
