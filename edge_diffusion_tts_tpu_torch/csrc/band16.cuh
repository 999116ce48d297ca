// The long-form band kernel on bf16 q, k, v, on tensor cores: included by
// band_attention.cu, whose edt_banded_attention launches it for 2-byte
// elements (band_tile_kernel keeps float32).
//
// It computes what JAX's _band_kernel computes on bf16 inputs (edge_
// diffusion_tts_tpu/ops/window_attention.py:48-121): q and k widened to
// float32 and S = q k^T * d^-0.5 in float32; query row i attends key j iff
// |i - j| <= window and j < seq_len; an online softmax in float32; P stays
// float32, never rounded to bf16, and P V sums in float32; out = acc / l in
// q's dtype (bf16, RNE); a row with no admissible key gives zeros.
//
// What bounds it on the H100: at [1,4,4000,40], w=64, the products are
// ~6 d (2w + 1) FLOP per query row on tensor cores, 0.49 GFLOP, 0.5 us at
// 989 TFLOP/s, against 5.12 MB of bf16 q, k, v and o, 1.53 us at 3.35 TB/s:
// bytes.  band_tile_kernel<bf16> widened the operands and ran the float32
// kernel's FMA chains.  Here:
//   * S = Q K^T by mma.sync m16n8k16, bf16 in, float32 sums: a product of
//     two bf16 values is exact in float32, so S differs from a float32 dot
//     only in the order of its sums.  The head dim is zero-padded to DP, a
//     multiple of 16 (48 for 40);
//   * P V with P kept to ~16 significant bits: P = P_hi + P_lo, P_hi =
//     bf16(P), P_lo = bf16(P - P_hi) (|P - P_hi - P_lo| <= 2^-18 P), two
//     mma.sync into one float32 accumulator per 16-key step; V in bf16 is
//     exact.  Rounding P to bf16 alone (what the decoder step's
//     attention16.cuh does, as the TPU's step kernel does) would put an
//     error of 2^-9 P on every weight, which the band kernel does not have;
//   * a block owns ROWS query rows (a warp 16 of them); Q is staged once,
//     and the K and V of the block's band [q0 - w, q0 + ROWS + w) stream
//     through a ring of B16_STAGES chunks of B16_KEYS keys by 16-byte
//     cp.async, rows of DP + 8 elements (an odd number of 16-byte units, so
//     ldmatrix's 8 rows fall on distinct banks), zeros past the head and
//     past the band; Q's A fragments, K's B fragments (ldmatrix) and V's
//     (ldmatrix.trans) come from shared memory, P goes from the S
//     accumulators to the PV A fragments in registers;
//   * the softmax online, once per chunk, in JAX's form: the chunk's row
//     max over the 4 lanes of a row, alpha = exp(m_old - m_new) rescales the
//     accumulator and the running sum, p = exp(s - m_new) (exp2 of scores in
//     log2 units); each lane sums its own keys and the 4 lanes are added at
//     the end;
//   * a warp skips a chunk that lies wholly outside its 16 rows' band, and
//     masks only the chunks that cross the band's edge or seq_len;
//   * q, k, v and o through explicit strides (the last dimension
//     unit-stride, rows 16-byte aligned; a head of 4 mod 8 reads its last 8
//     bytes alone), so the layer hands over views of its qkv projection and
//     takes o in [B, T, H, d] memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bf16.cuh"
#include "cp_async.cuh"

namespace edt {

struct BandArgs {
  const void* q;  // float32, or bf16 for band16_kernel
  const void* k;
  const void* v;
  void* o;
  long long s[4][3];  // batch, head and row strides of q, k, v, o (elements)
  int heads;
  int T;       // query and key rows
  int d;       // head dim
  int window;  // attend iff |i - j| <= window
  int kend;    // attend iff j < kend
  float scale_log2;  // d^-0.5 * log2(e)
};

constexpr int B16_KEYS = 64;   // keys per chunk
constexpr int B16_STAGES = 3;  // chunks in the ring

__host__ __device__ constexpr int b16_head_pad(int d) { return (d + 15) / 16 * 16; }
// Dynamic shared bytes: Q [rows][DP + 8] and the ring [stages][K, V][keys][DP + 8], bf16.
__host__ __device__ constexpr long long b16_smem_bytes(int rows, int dp) {
  return 2LL * (dp + 8) * (rows + 2LL * B16_STAGES * B16_KEYS);
}

// Two floats as P_hi = bf16 (RNE) and P_lo = bf16(x - P_hi), each pair in
// one 32-bit register (an mma A operand's pair).
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

template <int DP, int ROWS>
__global__ void __launch_bounds__(ROWS / 16 * 32) band16_kernel(BandArgs a) {
  constexpr int THREADS = ROWS / 16 * 32;
  constexpr int LD = DP + 8;  // elements per shared row
  constexpr int U = DP / 8;   // 16-byte units of a staged row
  constexpr int NO = DP / 8;  // 8-column fragments of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* ring = qs + ROWS * LD;                   // [STAGES][K, V][KEYS][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * ROWS;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.s[0][0] + h * a.s[0][1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.s[1][0] + h * a.s[1][1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.s[2][0] + h * a.s[2][1];
  // Bytes of a 16-byte copy at column c inside the head (zeros past it).
  const auto inside = [&](int c) { return c < a.d ? min(16, (a.d - c) * 2) : 0; };

  const int lo = max(0, q0 - a.window);
  const int hi = min(a.kend, q0 + ROWS + a.window);
  const int chunks = lo < hi ? (hi - lo + B16_KEYS - 1) / B16_KEYS : 0;

  // Q rides in the first group, with chunk 0.
  for (int e = threadIdx.x; e < ROWS * U; e += THREADS) {
    const int r = e / U, c = 8 * (e % U);
    const int n = q0 + r < a.T ? inside(c) : 0;
    cp_async16_n(qs + r * LD + c, n ? qb + (q0 + r) * a.s[0][2] + c : qb, n);
  }
  // Chunk `ch` into its ring slot, as one commit group (empty past the end).
  auto stage = [&](int ch) {
    if (ch < chunks) {
      const int c0 = lo + ch * B16_KEYS;
      bf16* ks = ring + (ch % B16_STAGES) * 2 * B16_KEYS * LD;
      bf16* vs = ks + B16_KEYS * LD;
      for (int e = threadIdx.x; e < B16_KEYS * U; e += THREADS) {
        const int kr = e / U, c = 8 * (e % U);
        const int n = c0 + kr < hi ? inside(c) : 0;
        cp_async16_n(ks + kr * LD + c, n ? kb + (c0 + kr) * a.s[1][2] + c : kb, n);
        cp_async16_n(vs + kr * LD + c, n ? vb + (c0 + kr) * a.s[2][2] + c : vb, n);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < B16_STAGES - 1; ++ch) stage(ch);

  const int w0 = q0 + 16 * warp;  // the warp's first row
  const int row[2] = {w0 + g, w0 + g + 8};  // this lane's two rows
  unsigned qa[DP / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<B16_STAGES - 2>();  // chunk ch (and Q) have landed
    __syncthreads();                   // ... for every thread; slot ch - 1 is free
    stage(ch + B16_STAGES - 1);
    if (ch == 0)
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd)
        ldsm_x4(qa[kd], qs + (16 * warp + (lane & 15)) * LD + 16 * kd + 8 * (lane >> 4));
    const int c0 = lo + ch * B16_KEYS;  // the chunk's keys c0 .. c0 + KEYS - 1
    // Warp-uniform: skip keys wholly outside the band of rows w0 .. w0+15.
    if (w0 >= a.T || c0 > w0 + 15 + a.window || c0 + B16_KEYS - 1 < w0 - a.window) continue;
    const bf16* ks = ring + (ch % B16_STAGES) * 2 * B16_KEYS * LD;
    const bf16* vs = ks + B16_KEYS * LD;

    // S[u][e]: row row[e / 2], key c0 + 8u + 2 t4 + e % 2.
    float S[B16_KEYS / 8][4];
#pragma unroll
    for (int u = 0; u < B16_KEYS / 8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[u][e] = 0.f;
#pragma unroll
    for (int j = 0; j < B16_KEYS / 16; ++j)
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        unsigned r[4];
        ldsm_x4(r, ks + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kd +
                       8 * ((lane >> 3) & 1));
        mma_bf16(S[2 * j], qa[kd], r[0], r[1]);
        mma_bf16(S[2 * j + 1], qa[kd], r[2], r[3]);
      }

    // Mask where the chunk crosses the band's edge or seq_len, then the
    // online softmax.
    const bool whole = c0 + B16_KEYS <= a.kend && c0 >= w0 + 15 - a.window &&
                       c0 + B16_KEYS - 1 <= w0 + a.window;
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int u = 0; u < B16_KEYS / 8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = c0 + 8 * u + 2 * t4 + (e & 1);
        const bool ok = whole || (j < a.kend && abs(row[e >> 1] - j) <= a.window);
        S[u][e] = ok ? S[u][e] * a.scale_log2 : -INFINITY;
        cm[e >> 1] = fmaxf(cm[e >> 1], S[u][e]);
      }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
      cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
      const float mn = fmaxf(m[r], cm[r]);
      base[r] = mn == -INFINITY ? 0.f : mn;  // no key yet: every p and alpha is 0
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int u = 0; u < B16_KEYS / 8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[u][e] = exp2f(S[u][e] - base[e >> 1]);
        rs[e >> 1] += S[u][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], rs[r]);  // this lane's keys only
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];

    // O += P_hi V + P_lo V, 16 keys a step: the accumulators of S tiles 2j
    // and 2j + 1 are the step's A fragment.
#pragma unroll
    for (int j = 0; j < B16_KEYS / 16; ++j) {
      unsigned ph[4], pl[4];
      split_bf16(S[2 * j][0], S[2 * j][1], ph[0], pl[0]);
      split_bf16(S[2 * j][2], S[2 * j][3], ph[1], pl[1]);
      split_bf16(S[2 * j + 1][0], S[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(S[2 * j + 1][2], S[2 * j + 1][3], ph[3], pl[3]);
      const bf16* Vk = vs + 16 * j * LD;
#pragma unroll
      for (int dn = 0; dn < NO; dn += 2) {  // V's columns past the head are zeros
        unsigned r[4];
        ldsm_x4_trans(r, Vk + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * dn +
                             8 * (lane >> 4));
        mma_bf16(o[dn], ph, r[0], r[1]);
        mma_bf16(o[dn + 1], ph, r[2], r[3]);
        mma_bf16(o[dn], pl, r[0], r[1]);
        mma_bf16(o[dn + 1], pl, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (Q's, when there is no chunk)

  // Each lane summed its own keys: add the 4 lanes of a row, divide, write.
  bf16* ob = static_cast<bf16*>(a.o) + b * a.s[3][0] + h * a.s[3][1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row[r] >= a.T) continue;
    bf16* orow = ob + row[r] * a.s[3][2];
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int c = 8 * dn + 2 * t4;  // d is even: both columns or neither
      if (c < a.d)
        store2(orow + c, sum > 0.f ? o[dn][2 * r] / sum : 0.f,
               sum > 0.f ? o[dn][2 * r + 1] / sum : 0.f);
    }
  }
}

}  // namespace edt
