// The decoder step's bf16 attention on tensor cores: the banded
// self-attention and the cross-attention of fused_ddim.cu's decoder step at
// compute_dtype bfloat16 (AttnArgs::bf16), in place of attention.cuh's
// float32-FMA kernel, which the float32 step keeps.
//
// It computes what the TPU kernel computes at compute_dtype bfloat16
// (edge_diffusion_tts_tpu/ops/fused_denoise.py::_denoise_kernel, :87-102,
// `mm`/`mm_t`): S = q k^T from bf16 q and k (the qkv and cross-q GEMMs write
// them rounded) with float32 sums, times the scale; the softmax in float32
// over the keys j of row i with |i - j| <= window and j < kv_len (every key
// below kv_len for the cross-attention): the row's max first, then the sum
// of exp(s - max), then P = exp(s - max) / sum, normalised before it is
// rounded to bf16, and P V with float32 sums, rounded to bf16 as it feeds
// the attn-proj / cross-out GEMM.  A row with no admissible key gives zeros.
//
// What bounds it on the H100: ~4 d (2w + 1) FLOP per query row, 0.33 GFLOP
// per self-attention at 4,000 rows, a fraction of a microsecond at the bf16
// tensor-core rate; q, k, v and o (~2 MB at 4,000 rows) sit in L2.  So it
// is bound by latency: how long a block waits for its K and V, and the
// serial instruction stream of each warp (at B=1 a warp per SM partition at
// most: nothing hides a warp's own latencies).  attention.cuh's bf16
// variant chained float32 FMAs over each row's keys, 4 threads per row, and
// a first tensor-core version with a warp per 16 rows took as long, for
// want of parallel warps.  Design:
//   * a block owns 16 query rows and stages them and the K and V of their
//     band, [q0 - w, q0 + 16 + w) or every key for the cross-attention, by
//     16-byte cp.async (K, then V in a second group, so the scores start
//     before V lands); rows of DP + 8 elements (DP the head dim rounded up
//     to 16, zero-padded: 48 for a head of 40), an odd number of 16-byte
//     units, so ldmatrix's 8 rows fall on distinct banks.  A band of up to
//     ATT16_MAX_KEYS keys is staged once; a longer one (a cross-attention
//     over more keys) is staged ATT16_KEYS keys at a time;
//   * its 4 warps split the band's 16-key steps (warp w takes steps w, w +
//     4, ...), so each holds at most 4 steps' scores in registers per
//     ATT16_KEYS keys;
//   * S = Q K^T by mma.sync m16n8k16 (bf16, float32 sums): Q's A fragments
//     (ldmatrix) stay in registers, K's B fragments come by ldmatrix from
//     its key rows; scores in log2 units (the scale times log2 e folded
//     in), masked only in the steps that cross a band's edge;
//   * the softmax in the TPU kernel's order, not an online softmax: the
//     row's max over all its keys (over the 4 lanes that share a row, then
//     over the warps through shared memory), then exp(s - max) and their
//     sum (likewise, the warps in order), then P = exp(s - max) x (1 /
//     sum); so P is normalised before it is rounded.  Where the band spans
//     more than ATT16_KEYS keys, the scores are recomputed in each of the
//     three passes (the products are cheap; registers are not);
//   * P V by mma.sync: the m16n8 accumulator of two adjacent 8-key S tiles
//     is the A fragment of a 16-key PV step, so P goes from registers to
//     the tensor cores, rounded to bf16 in the packing; V's B fragments
//     come by ldmatrix.trans from its key rows; the warps' partial outputs
//     are summed in warp order through shared memory and rounded once;
//   * strides stay explicit, so q/k/v are read out of the step's [B, T, 3H]
//     qkv buffer and the cross K/V out of [B, S, 2H].
// A head dim that is a multiple of 8 up to 64 and 16-byte-aligned rows are
// required (the step's and the hook's checks).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "bf16.cuh"
#include "cp_async.cuh"
#include "device.cuh"

namespace edt {

constexpr int ATT16_KW = 4;          // warps of a block, splitting its keys
constexpr int ATT16_KEYS = 256;      // keys of a super-chunk: 16 steps of 16, 4 per warp
constexpr int ATT16_MAX_KEYS = 512;  // a band of at most this many keys is staged once
constexpr int ATT16_MAX_SMEM = 232448;

inline long long g_attn16_launches = 0;  // launches of attention16_kernel

// Shared bytes: the 16 q rows and `keys` rows of K and of V, each DP + 8
// elements, then the warps' row maxima and sums and their partial outputs.
inline int att16_smem(int dp, int keys) {
  return (16 + 2 * keys) * (dp + 8) * 2 + ATT16_KW * 16 * (2 + dp) * 4;
}

template <int DP>
__global__ void __launch_bounds__(32 * ATT16_KW) attention16_kernel(AttnArgs a, int keys) {
  constexpr int THREADS = 32 * ATT16_KW;
  constexpr int LD = DP + 8;
  constexpr int U = DP / 8;                        // 16-byte units of a staged row
  constexpr int NSW = ATT16_KEYS / 16 / ATT16_KW;  // a warp's 16-key steps of a super-chunk
  constexpr int NO = DP / 8;                       // 8-column fragments of the output (even)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [16][LD]
  bf16* Ks = Qs + 16 * LD;                         // [keys][LD]
  bf16* Vs = Ks + keys * LD;                       // [keys][LD]
  float* red_m = reinterpret_cast<float*>(Vs + keys * LD);  // [KW][16]
  float* red_s = red_m + ATT16_KW * 16;                     // [KW][16]
  float* Op = red_s + ATT16_KW * 16;                        // [KW][16][DP]

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * 16;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.kv_sb + h * a.kv_sh;

  const int kend = min(a.tk, a.kv_len);
  const int lo = max(0, q0 - a.window);
  const int hi = min(kend, q0 + 16 + a.window);
  const int nsc = hi > lo ? (hi - lo + ATT16_KEYS - 1) / ATT16_KEYS : 0;  // super-chunks
  const bool resident = hi - lo <= keys;

  // Rows r0 .. r0 + n - 1 of src (row stride sr) into dst, zeros past
  // `valid` rows and past the head.
  auto stage = [&](bf16* dst, const bf16* src, long long sr, int r0, int n, int valid) {
    for (int e = tid; e < n * U; e += THREADS) {
      const int r = e / U, c = 8 * (e % U);
      const bool ok = r0 + r < valid && c < a.d;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * sr + c : src, ok);
    }
  };
  stage(Qs, qb, a.q_sr, q0, 16, a.tq);
  if (resident) {
    const int n = (hi - lo + 15) / 16 * 16;
    stage(Ks, kb, a.kv_sr, lo, n, hi);
    cp_async_commit();
    stage(Vs, vb, a.kv_sr, lo, n, hi);
    cp_async_commit();
    cp_async_wait<1>();  // q and K
  } else {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + g, row1 = row0 + 8;  // this lane's two rows
  unsigned qa[DP / 16][4];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd)
    ldsm_x4(qa[kd], Qs + (lane & 15) * LD + 16 * kd + 8 * (lane >> 4));
  // The scores in log2 units: exp(s - max) = exp2(s log2(e) - max log2(e)).
  const float scale2 = a.scale * 1.4426950408889634f;

  // This warp's step i of super-chunk sc: keys j0 = lo + ATT16_KEYS sc +
  // 16 (warp + KW i), at row j0 - base of the staged K and V.
  auto key0 = [&](int sc, int i) { return lo + ATT16_KEYS * sc + 16 * (warp + ATT16_KW * i); };
  // S of this warp's steps of super-chunk sc, -inf where a key is not
  // admissible: S[i][u][e] is row row0 (e < 2) or row1, key j0 + 8u + 2 t4
  // + e % 2.  A step wholly inside every row's band is not masked.
  auto scores = [&](float (&S)[NSW][2][4], int sc, int base) {
#pragma unroll
    for (int i = 0; i < NSW; ++i) {
      const int j0 = key0(sc, i);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[i][u][e] = -INFINITY;
      if (j0 >= hi) continue;  // warp-uniform
      float s[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        unsigned r[4];
        ldsm_x4(r, Ks + (j0 - base + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kd +
                       8 * ((lane >> 3) & 1));
        mma_bf16(s[0], qa[kd], r[0], r[1]);
        mma_bf16(s[1], qa[kd], r[2], r[3]);
      }
      const bool inside = j0 + 16 <= hi && j0 >= q0 + 15 - a.window && j0 + 15 <= q0 + a.window;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * u + 2 * t4 + (e & 1);
          const int r = e < 2 ? row0 : row1;
          if (inside || (j < hi && abs(r - j) <= a.window)) S[i][u][e] = s[u][e] * scale2;
        }
    }
  };
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
  auto row_max = [&](const float (&S)[NSW][2][4]) {
#pragma unroll
    for (int i = 0; i < NSW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], fmaxf(S[i][0][e], S[i][1][e]));
  };
  // exp(s - max) in place, 0 where a key is not admissible (its score -inf),
  // and the row sums.
  auto exps = [&](float (&S)[NSW][2][4]) {
#pragma unroll
    for (int i = 0; i < NSW; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[i][u][e] = S[i][u][e] == -INFINITY ? 0.f : exp2f(S[i][u][e] - mx[e >> 1]);
          sum[e >> 1] += S[i][u][e];
        }
  };
  // A row's max or sum over the 4 lanes that share it, then over the warps
  // (in warp order, through shared memory).
  auto reduce = [&](float (&v)[2], float* red, bool is_max) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v[r], off);
        v[r] = is_max ? fmaxf(v[r], o) : v[r] + o;
      }
      if (t4 == 0) red[warp * 16 + g + 8 * r] = v[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = red[g + 8 * r];
#pragma unroll
      for (int w = 1; w < ATT16_KW; ++w)
        x = is_max ? fmaxf(x, red[w * 16 + g + 8 * r]) : x + red[w * 16 + g + 8 * r];
      v[r] = x;
    }
  };
  // O += P V over this warp's steps of super-chunk sc, P = e / sum rounded to
  // bf16 in the packing.
  float o[NO][4] = {};
  auto pv = [&](const float (&S)[NSW][2][4], int sc, int base) {
#pragma unroll
    for (int i = 0; i < NSW; ++i) {
      const int j0 = key0(sc, i);
      if (j0 >= hi) continue;  // warp-uniform
      const unsigned pa[4] = {
          pack_bf16(S[i][0][0] * inv[0], S[i][0][1] * inv[0]),
          pack_bf16(S[i][0][2] * inv[1], S[i][0][3] * inv[1]),
          pack_bf16(S[i][1][0] * inv[0], S[i][1][1] * inv[0]),
          pack_bf16(S[i][1][2] * inv[1], S[i][1][3] * inv[1])};
      const bf16* Vk = Vs + (j0 - base) * LD;
#pragma unroll
      for (int dn = 0; dn < NO; dn += 2) {  // V's columns past the head are zeros
        unsigned r[4];
        ldsm_x4_trans(r, Vk + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * dn +
                             8 * (lane >> 4));
        mma_bf16(o[dn], pa, r[0], r[1]);
        mma_bf16(o[dn + 1], pa, r[2], r[3]);
      }
    }
  };
  // Super-chunk sc's K (and V) at shared row 0, where the band is not
  // resident; returns the key at that row.
  auto restage = [&](int sc, bool with_v) {
    const int k0 = lo + ATT16_KEYS * sc;
    __syncthreads();
    stage(Ks, kb, a.kv_sr, k0, ATT16_KEYS, hi);
    if (with_v) stage(Vs, vb, a.kv_sr, k0, ATT16_KEYS, hi);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    return k0;
  };
  auto set_inv = [&] {
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = sum[r] > 0.f ? 1.f / sum[r] : 0.f;
  };

  if (nsc <= 1) {  // the band in one super-chunk (resident): S stays in registers
    float S[NSW][2][4];
    if (nsc == 1) scores(S, 0, lo);
    if (nsc == 1) row_max(S);
    reduce(mx, red_m, true);
    if (nsc == 1) exps(S);
    reduce(sum, red_s, false);
    set_inv();
    cp_async_wait<0>();  // V
    __syncthreads();
    if (nsc == 1) pv(S, 0, lo);
  } else {  // three passes over the super-chunks, S recomputed in each
    for (int sc = 0; sc < nsc; ++sc) {
      float S[NSW][2][4];
      scores(S, sc, resident ? lo : restage(sc, false));
      row_max(S);
    }
    reduce(mx, red_m, true);
    for (int sc = 0; sc < nsc; ++sc) {
      float S[NSW][2][4];
      scores(S, sc, resident ? lo : restage(sc, false));
      exps(S);
    }
    reduce(sum, red_s, false);
    set_inv();
    if (resident) {
      cp_async_wait<0>();  // V
      __syncthreads();
    }
    for (int sc = 0; sc < nsc; ++sc) {
      float S[NSW][2][4];
      const int base = resident ? lo : restage(sc, true);
      scores(S, sc, base);
      float keep[2] = {sum[0], sum[1]};
      exps(S);
      sum[0] = keep[0], sum[1] = keep[1];
      pv(S, sc, base);
    }
  }

  // The warps' partial outputs, summed in warp order.
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Op[(warp * 16 + g + 8 * (e >> 1)) * DP + 8 * dn + 2 * t4 + (e & 1)] = o[dn][e];
  __syncthreads();
  bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int e = tid; e < 16 * a.d; e += THREADS) {
    const int r = e / a.d, c = e % a.d;
    if (q0 + r >= a.tq) continue;
    float x = Op[r * DP + c];
#pragma unroll
    for (int w = 1; w < ATT16_KW; ++w) x += Op[(w * 16 + r) * DP + c];
    store1(ob + (long long)(q0 + r) * a.o_sr + c, x);
  }
}

template <int DP>
int launch_attention16_dp(const AttnArgs& a, int batch, cudaStream_t stream) {
  const auto kernel = attention16_kernel<DP>;
  const int kend = min(a.tk, a.kv_len);
  const long long span = min((long long)kend, 16LL + 2LL * a.window);
  // The band's keys rounded up to 16, or one super-chunk's where it is longer
  // than ATT16_MAX_KEYS.
  int keys = span <= ATT16_MAX_KEYS ? (int)((span + 15) / 16 * 16) : ATT16_KEYS;
  keys = keys > 0 ? keys : 16;
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT16_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((a.tq + 15) / 16, batch * a.heads);
  kernel<<<grid, 32 * ATT16_KW, att16_smem(DP, keys), stream>>>(a, keys);
  const int e = (int)cudaGetLastError();
  if (!e) ++g_attn16_launches;
  return e;
}

// Launch over `batch` * a.heads (batch, head) pairs, bf16 q, k, v and o;
// returns a cudaError_t (cudaErrorInvalidValue for a head dim that is not a
// multiple of 8 up to 64).
inline int launch_attention16(const AttnArgs& a, int batch, cudaStream_t stream) {
  if (a.tq <= 0 || batch <= 0) return 0;
  if (a.d <= 0 || a.d % 8 || a.d > 64) return (int)cudaErrorInvalidValue;
  switch ((a.d + 15) / 16 * 16) {
    case 16: return launch_attention16_dp<16>(a, batch, stream);
    case 32: return launch_attention16_dp<32>(a, batch, stream);
    case 48: return launch_attention16_dp<48>(a, batch, stream);
    default: return launch_attention16_dp<64>(a, batch, stream);
  }
}

}  // namespace edt
