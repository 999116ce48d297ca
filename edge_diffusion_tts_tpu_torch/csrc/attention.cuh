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
// v, o through HBM once and, at the decoder step's T = 500, by latency and
// by how many SMs its grid keeps busy.  Design:
//   * one block per (batch*head, ROWS query rows); blocks are independent,
//     so the TPU kernel's sequential k-tile grid becomes a loop inside the
//     block over only the key chunks the block's band touches.  ROWS and
//     SPLIT (threads per query row) are template parameters; the decoder
//     step and the long-form call take 16 x 4, so that T = 500 with 4
//     heads gives 128 blocks where a 64-row tile gives 32 (at T = 4000 the
//     16-row tile measured 7-8% faster too, with the same bits);
//   * each chunk of K and V (64 keys, 32 above a head of 40) starts at a
//     multiple of its size and is staged in shared memory once, read by
//     all the block's rows, double-buffered: 16-byte cp.async copies of
//     the next chunk are in flight while the block works on this one.  The
//     head is padded to DP (a multiple of 8) with zeros; rows are read as
//     float4s;
//   * SPLIT adjacent threads share a query row: each keeps an online
//     softmax (running max, denominator, DP-wide accumulator) in registers
//     over every SPLIT-th key, in key order, and the partial states merge
//     with warp shuffles at the end.  A row with no admissible key writes
//     zeros.  Since the chunks are aligned, a row's keys fall to the same
//     thread in the same order under every ROWS: at equal SPLIT any two
//     tiles give the same bits, and a thread takes the dot products of two
//     of its keys together only to overlap their FMA chains.
// A head dim that is a multiple of 4, and 16-byte-aligned q/k/v rows, are
// required (the wrappers check them).
// Strides are explicit, so the fused kernel reads q/k/v straight out of its
// [B, T, 3H] qkv buffer and the cross K/V out of its [B, S, 2H] buffer.
//
// The bf16 variant (AttnArgs::bf16; the decoder step at compute_dtype
// bfloat16) reads q, k, v and writes o as bf16 (a head dim that is a
// multiple of 8: 16-byte copies of 8 elements), widens every load to
// float32 and computes S and the softmax in float32 as above.  What the TPU
// kernel's bf16 `mm` rounds (fused_denoise.py::_decoder_forward) it rounds:
// q and k arrive rounded (the qkv GEMM writes bf16), and each probability
// goes to bf16 before it weights v.  The TPU kernel rounds the normalised
// P; the online softmax here rounds each p = exp(s - m) against the running
// max and divides by the float32 sum of the unrounded p at the end (the
// plain version rounds where the TPU kernel does; the two differ by a
// rounding of each weight).  The products are float32 FMA on the widened
// values (a product of two bf16 values is exact in float32).  The bf16
// decoder step runs attention16.cuh's tensor-core kernel instead; this
// variant stays as the yardstick it is timed against (edt_step_attention's
// `fma` argument).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16.cuh"
#include "cp_async.cuh"

namespace edt {

struct AttnArgs {
  const void* q;  // q, k, v and o: float32, or bf16 where bf16
  const void* k;
  const void* v;
  void* o;
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
  int bf16;    // q, k, v and o hold bf16; P rounded to bf16
};

// Keys per staged chunk: two buffers of K and V stay under 48 KB.
__host__ __device__ constexpr int att_keys(int dp) { return dp <= 40 ? 64 : 32; }

template <int DP, int ROWS, int SPLIT, typename T>
__global__ void __launch_bounds__(ROWS * SPLIT) band_attention_kernel(AttnArgs a) {
  constexpr bool LOW = std::is_same<T, bf16>::value;
  constexpr int THREADS = ROWS * SPLIT;
  constexpr int KEYS = att_keys(DP);
  constexpr int D4 = DP / 4;
  constexpr int EV = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int DV = DP / EV;
  constexpr int NB = 2;  // keys whose dot products overlap
  // Rows of DP + 4 floats: 16-byte aligned, and DP/4 + 1 float4s apart,
  // so that the (up to 5) keys a quarter-warp reads together sit in
  // distinct banks (bf16: DP + 8 elements, 16-byte aligned).
  __shared__ __align__(16) T ks[2][KEYS][DP + EV];
  __shared__ __align__(16) T vs[2][KEYS][DP + EV];

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * ROWS;
  const int r = threadIdx.x / SPLIT;
  const int s = threadIdx.x % SPLIT;
  const int i = q0 + r;
  const bool row_ok = i < a.tq;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.kv_sb + h * a.kv_sh;

  const int kend = min(a.tk, a.kv_len);
  // Chunks start at multiples of KEYS, whatever the tile: a row's keys fall
  // to the same thread, in the same order, under every ROWS.
  const int lo = max(0, q0 - a.window) / KEYS * KEYS;
  const int hi = min(kend, q0 + ROWS + a.window);
  // Copy keys c0 .. min(c0 + KEYS, hi) - 1 into buffer `buf`, as one group.
  auto stage = [&](int c0, int buf) {
    const int n = min(KEYS, hi - c0);
    for (int e = threadIdx.x; e < n * DV; e += THREADS) {
      const int kr = e / DV;
      const int c = EV * (e % DV);
      const bool ok = c < a.d;  // zeros past the head
      const long long off = ok ? (long long)(c0 + kr) * a.kv_sr + c : 0;
      cp_async16(&ks[buf][kr][c], kb + off, ok);
      cp_async16(&vs[buf][kr][c], vb + off, ok);
    }
    cp_async_commit();
  };
  if (lo < hi) stage(lo, 0);

  float q[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    q[c] = (row_ok && c < a.d) ? to_f32(qb[(long long)i * a.q_sr + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  int buf = 0;
  for (int c0 = lo; c0 < hi; c0 += KEYS, buf ^= 1) {
    const int n = min(KEYS, hi - c0);
    if (c0 + KEYS < hi)
      stage(c0 + KEYS, buf ^ 1);
    else
      cp_async_commit();  // an empty group, so that one wait fits every chunk
    cp_async_wait<1>();   // this chunk's group has landed
    __syncthreads();
    if (row_ok) {
      const int jlo = max(c0, i - a.window);
      const int jhi = min(c0 + n, i + a.window + 1);
      // Online softmax over this thread's keys j = jlo + s, + SPLIT, ...,
      // in order; the dot products of NB keys are taken together, so that
      // their FMA chains overlap.
      auto update = [&](float dot, const T* vrow) {
        const float sc = dot * a.scale;
        if (sc > m) {
          const float alpha = expf(m - sc);
          l *= alpha;
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[c] *= alpha;
          m = sc;
        }
        float p = expf(sc - m);
        l += p;
        if constexpr (LOW) p = round_bf16(p);
#pragma unroll
        for (int c = 0; c < D4; ++c) {
          const float4 v4 = load4(vrow + 4 * c);
          acc[4 * c] = fmaf(p, v4.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, v4.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, v4.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, v4.w, acc[4 * c + 3]);
        }
      };
      for (int j = jlo + s; j < jhi; j += NB * SPLIT) {
        const T* kr[NB];
#pragma unroll
        for (int t = 0; t < NB; ++t)  // past jhi: a valid row, its dot unused
          kr[t] = ks[buf][(j + t * SPLIT < jhi ? j + t * SPLIT : j) - c0];
        float dot[NB];
#pragma unroll
        for (int t = 0; t < NB; ++t) dot[t] = 0.f;
#pragma unroll
        for (int c = 0; c < D4; ++c) {
#pragma unroll
          for (int t = 0; t < NB; ++t) {
            const float4 x = load4(kr[t] + 4 * c);
            dot[t] = fmaf(q[4 * c], x.x, dot[t]);
            dot[t] = fmaf(q[4 * c + 1], x.y, dot[t]);
            dot[t] = fmaf(q[4 * c + 2], x.z, dot[t]);
            dot[t] = fmaf(q[4 * c + 3], x.w, dot[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < NB; ++t)
          if (j + t * SPLIT < jhi) update(dot[t], vs[buf][j + t * SPLIT - c0]);
      }
    }
    __syncthreads();  // the buffer is restaged two chunks on
  }

  // Merge the SPLIT partial softmax states of a row (adjacent lanes).
  float mx = m;
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float alpha = (m == -INFINITY) ? 0.f : expf(m - mx);
  l *= alpha;
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    float x = acc[c] * alpha;
#pragma unroll
    for (int off = 1; off < SPLIT; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    acc[c] = x;
  }
  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + (long long)i * a.o_sr;
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c % SPLIT == s && c < a.d) store1(ob + c, acc[c] * inv);
  }
}

template <int ROWS, int SPLIT, typename E>
int launch_attention_t(const AttnArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.tq + ROWS - 1) / ROWS, batch * a.heads);
  constexpr int T = ROWS * SPLIT;
  switch ((a.d + 7) / 8 * 8) {
    case 8: band_attention_kernel<8, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 16: band_attention_kernel<16, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 24: band_attention_kernel<24, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 32: band_attention_kernel<32, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 40: band_attention_kernel<40, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 48: band_attention_kernel<48, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 56: band_attention_kernel<56, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    case 64: band_attention_kernel<64, ROWS, SPLIT, E><<<grid, T, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launch over `batch` * a.heads (batch, head) pairs with ROWS query rows and
// SPLIT threads per row in a block, float32 or bf16 by a.bf16; returns a
// cudaError_t (cudaErrorInvalidValue for a bf16 head dim that is not a
// multiple of 8).
template <int ROWS, int SPLIT>
int launch_attention(const AttnArgs& a, int batch, cudaStream_t stream) {
  static_assert(SPLIT <= 32 && 32 % SPLIT == 0, "a row's threads share a warp");
  if (a.tq <= 0 || batch <= 0) return 0;
  if (!a.bf16) return launch_attention_t<ROWS, SPLIT, float>(a, batch, stream);
  if (a.d % 8) return (int)cudaErrorInvalidValue;
  return launch_attention_t<ROWS, SPLIT, bf16>(a, batch, stream);
}

}  // namespace edt
