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
// below kv_len for the cross-attention): the row's max, the sum of exp(s -
// max), then P = exp(s - max) / sum, normalised before it is rounded to
// bf16, and P V with float32 sums, rounded to bf16 as it feeds the
// attn-proj / cross-out GEMM.  A row with no admissible key gives zeros.
//
// Both tiles share the fragments: S = Q K^T by mma.sync m16n8k16 (bf16,
// float32 sums), Q's A fragments (ldmatrix) held in registers, K's B
// fragments by ldmatrix from its key rows, scores masked only in the 16-key
// steps that cross a band's edge; P V by mma.sync, the m16n8 accumulator of
// two adjacent 8-key S tiles being the A fragment of a 16-key PV step, so P
// goes from registers to the tensor cores, rounded to bf16 in the packing,
// V's B fragments by ldmatrix.trans.  q, k and v are staged by 16-byte
// cp.async in rows of DP + 8 elements (DP the head dim rounded up to 16,
// zero-padded: 48 for a head of 40), an odd number of 16-byte units, so
// ldmatrix's 8 rows fall on distinct banks.  Strides stay explicit, so q/k/v
// are read out of the step's [B, T, 3H] qkv buffer and the cross K/V out of
// [B, S, 2H].  exp is the SFU's ex2 (att16_exp2).
//
// What bounds it on the H100: per score 6 DP FLOP of products (S twice, P V
// once: ~0.3 ps at the card's 989 TFLOP/s) and two exps (~0.54 ps at its 16
// SFU lanes an SM), plus the ldmatrix reads of K and V for every 16 rows;
// q, k, v and o sit in L2.
// The two tiles differ in how a block's warps divide the work, and the
// host's rule (att16_pick_tile) takes one by the grid it would launch:
//
//   * the row tile (ROWS = 64) where its grid, batch x heads x ceil(tq /
//     64) blocks, has a block for at least ATT16_ROWS_MIN_FILL % of the
//     SMs (the batched calls).  A block owns 64 query rows of one (batch,
//     head); each of its 4 warps owns 16 rows and walks every key of its
//     rows' band, skipping (warp-uniformly) the 16-key steps outside it, so
//     a row's max, sum and output never leave the warp: no reduction
//     through shared memory, no barrier but the ring's.  K and V come
//     through a ring of ATT16_ROW_STAGES tiles of 64 keys shared by the
//     block, read from L2 once per 64 rows: a block's keys that fit in the
//     ring (the band self-attention at window 64, a cross-attention over up
//     to 192 keys) are staged once, K then V; more keys stream, K alone for
//     pass 1 and K and V for pass 2, ATT16_ROW_STAGES - 1 tiles ahead, so
//     no key count needs another path.  ~50 KB of shared memory and at most
//     128 registers give 4 blocks (16 warps) an SM.  Two passes: pass 1
//     keeps each lane's running max and its sum of exp(s - max), rescaled
//     where a 64-key tile raises the max (float32; the 4 lanes of a row
//     combined at its end); pass 2 recomputes S and forms P = exp(s - max)
//     x (1 / sum), rounded after it is normalised, into P V.  The same
//     arithmetic as the key tile's in another float32 order.  At the bf16
//     token cell's largest call (B = 64, T = 1000, S = 500) its cross-
//     attention runs ~250 µs against ~70 of SFU time: per SM the SFU, the
//     tensor cores, shared memory and L2 each take a comparable share, and
//     16 warps overlap them only in part;
//   * the key tile (ROWS = 16) otherwise (B = 1: the edge call's 500 rows
//     make 32 row-tile blocks for 132 SMs; it has 4x the blocks).  A block
//     owns 16 query rows and stages them and the K and V of their band, [q0
//     - w, q0 + 16 + w) or every key for the cross-attention (K, then V in
//     a second group, so the scores start before V lands); a band of up to
//     ATT16_MAX_KEYS keys is staged once, a longer one ATT16_KEYS keys at a
//     time.  Its 4 warps split the band's 16-key steps (warp w takes steps
//     w, w + 4, ...), so 4 warps work on each 16 rows; each row's max and
//     sum go over the warps through shared memory (the warps in order), and
//     the warps' partial outputs are summed there in warp order and rounded
//     once.  Where the band spans more than ATT16_KEYS keys (the registers
//     one warp's scores may hold), the scores are recomputed in each of
//     three passes (max, sum, P V).  Bound: at B = 1 at most a warp per SM
//     partition, so the serial chain of loads, mma and exps of each warp.
//     At batch its shared memory (a whole cross band a block) and its
//     copies of K and V per 16 rows cost it: 4x the row tile's time at the
//     cell's largest call.
//
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

constexpr int ATT16_KW = 4;          // key tile: warps of a block, splitting its keys
constexpr int ATT16_KEYS = 256;      // key tile: keys of a super-chunk, 16 steps of 16, 4 per warp
constexpr int ATT16_MAX_KEYS = 512;  // key tile: a band of at most this many keys is staged once
constexpr int ATT16_MAX_SMEM = 232448;
constexpr int ATT16_ROW_KEYS = 64;   // row tile: keys of a ring tile
constexpr int ATT16_ROW_STAGES = 3;  // row tile: tiles the ring holds
constexpr int ATT16_ROWS_MIN_FILL = 75;  // the rule: the row tile from blocks = 75% of the SMs

// The tiles, as the hooks and the counters number them.
enum { ATT16_TILE_KEYS = 0, ATT16_TILE_ROWS = 1, ATT16_NTILES = 2 };

// 2^x by the SFU alone (ex2.approx.ftz): exp2f's own instruction without
// its fix-up for results below 2^-126, which flushes those to 0 (a
// probability that small moves no bf16 output).
__device__ __forceinline__ float att16_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

inline long long g_attn16_launches[ATT16_NTILES] = {};  // launches of attention16_kernel by tile

// Key tile's shared bytes: the 16 q rows and `keys` rows of K and of V,
// each DP + 8 elements, then the warps' row maxima and sums and their
// partial outputs.
inline int att16_smem(int dp, int keys) {
  return (16 + 2 * keys) * (dp + 8) * 2 + ATT16_KW * 16 * (2 + dp) * 4;
}

// Row tile's shared bytes: `rows` q rows, then the ring's stages of K and V.
inline int att16_rows_smem(int dp, int rows) {
  return (rows + 2 * ATT16_ROW_STAGES * ATT16_ROW_KEYS) * (dp + 8) * 2;
}

// Rows r0 .. r0 + n - 1 of src (row stride sr) into dst (rows of DP + 8),
// zeros past `valid` rows and past the head dim d, by `threads` threads.
template <int DP>
__device__ __forceinline__ void att16_stage(bf16* dst, const bf16* src, long long sr, int r0,
                                            int n, int valid, int d, int tid, int threads) {
  constexpr int LD = DP + 8, U = DP / 8;
  for (int e = tid; e < n * U; e += threads) {
    const int r = e / U, c = 8 * (e % U);
    const bool ok = r0 + r < valid && c < d;
    cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * sr + c : src, ok);
  }
}

// The A fragments of the 16 q rows at Qs.
template <int DP>
__device__ __forceinline__ void att16_q(unsigned (&qa)[DP / 16][4], const bf16* Qs, int lane) {
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd)
    ldsm_x4(qa[kd], Qs + (lane & 15) * (DP + 8) + 16 * kd + 8 * (lane >> 4));
}

// s = Q K^T of one 16-key step, K's rows at Ks: s[u][e] is row g (e < 2) or
// g + 8, key 8u + 2 t4 + e % 2 of the step (g = lane / 4, t4 = lane % 4).
template <int DP>
__device__ __forceinline__ void att16_qk(float (&s)[2][4], const unsigned (&qa)[DP / 16][4],
                                         const bf16* Ks, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[u][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    unsigned r[4];
    ldsm_x4(r, Ks + ((lane & 7) + ((lane >> 4) << 3)) * (DP + 8) + 16 * kd +
                   8 * ((lane >> 3) & 1));
    mma_bf16(s[0], qa[kd], r[0], r[1]);
    mma_bf16(s[1], qa[kd], r[2], r[3]);
  }
}

// o += P V of one 16-key step, P's A fragment pa, V's rows at Vs (V's
// columns past the head are zeros).
template <int DP>
__device__ __forceinline__ void att16_pv(float (&o)[DP / 8][4], const unsigned (&pa)[4],
                                         const bf16* Vs, int lane) {
#pragma unroll
  for (int dn = 0; dn < DP / 8; dn += 2) {
    unsigned r[4];
    ldsm_x4_trans(r, Vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * (DP + 8) + 8 * dn +
                         8 * (lane >> 4));
    mma_bf16(o[dn], pa, r[0], r[1]);
    mma_bf16(o[dn + 1], pa, r[2], r[3]);
  }
}

// The key tile: a block of 16 query rows, its 4 warps splitting the keys.
template <int DP>
__device__ __forceinline__ void att16_keys(const AttnArgs& a, int keys, unsigned char* smem_raw) {
  constexpr int THREADS = 32 * ATT16_KW;
  constexpr int LD = DP + 8;
  constexpr int NSW = ATT16_KEYS / 16 / ATT16_KW;  // a warp's 16-key steps of a super-chunk
  constexpr int NO = DP / 8;                       // 8-column fragments of the output (even)
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

  auto stage = [&](bf16* dst, const bf16* src, long long sr, int r0, int n, int valid) {
    att16_stage<DP>(dst, src, sr, r0, n, valid, a.d, tid, THREADS);
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
  att16_q<DP>(qa, Qs, lane);
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
      float s[2][4];
      att16_qk<DP>(s, qa, Ks + (j0 - base) * LD, lane);
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
          S[i][u][e] = S[i][u][e] == -INFINITY ? 0.f : att16_exp2(S[i][u][e] - mx[e >> 1]);
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
      att16_pv<DP>(o, pa, Vs + (j0 - base) * LD, lane);
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

// The row tile: a block of ROWS query rows, a warp's 16 each, K and V
// through the ring.
template <int DP, int ROWS>
__device__ __forceinline__ void att16_rows(const AttnArgs& a, unsigned char* smem_raw) {
  constexpr int THREADS = 2 * ROWS;  // a warp per 16 rows
  constexpr int LD = DP + 8;
  constexpr int KT = ATT16_ROW_KEYS;
  constexpr int NST = ATT16_ROW_STAGES;
  constexpr int NO = DP / 8;
  constexpr int STEPS = KT / 16;  // 16-key steps of a ring tile
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* ring = Qs + ROWS * LD;                   // [NST] x (K [KT][LD], V [KT][LD])

  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.kv_sb + h * a.kv_sh;

  const int kend = min(a.tk, a.kv_len);
  const int lo = max(0, q0 - a.window);
  const int hi = min(kend, min(a.tq, q0 + ROWS) + a.window);
  const int nt = hi > lo ? (hi - lo + KT - 1) / KT : 0;  // ring tiles of the block's keys
  const bool resident = nt <= NST;
  // This warp's rows and the keys of their band: steps outside [wlo, whi)
  // are skipped (warp-uniform), and a warp past the last row computes
  // nothing (it still loads and waits with the block).
  const int r0 = q0 + 16 * warp;
  const bool active = r0 < a.tq;
  const int wlo = max(lo, r0 - a.window), whi = min(hi, r0 + 16 + a.window);
  const int g = lane / 4, t4 = lane % 4;
  const float scale2 = a.scale * 1.4426950408889634f;

  // Tile t's K (and V) into ring stage st.
  auto load = [&](int t, int st, bool with_k, bool with_v) {
    bf16* Ks = ring + st * 2 * KT * LD;
    if (with_k) att16_stage<DP>(Ks, kb, a.kv_sr, lo + KT * t, KT, hi, a.d, tid, THREADS);
    if (with_v) att16_stage<DP>(Ks + KT * LD, vb, a.kv_sr, lo + KT * t, KT, hi, a.d, tid,
                                THREADS);
  };
  unsigned qa[DP / 16][4];
  // S of the 16-key step at key j0 (K's rows at Ks), -inf where a key is not
  // admissible for this lane's row r0 + g (e < 2) or r0 + g + 8; a step
  // wholly inside every row's band is not masked.
  auto scores = [&](float (&s)[2][4], const bf16* Ks, int j0) {
    att16_qk<DP>(s, qa, Ks, lane);
    if (j0 + 16 <= hi && j0 >= r0 + 15 - a.window && j0 + 15 <= r0 + a.window) return;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * u + 2 * t4 + (e & 1);
        if (!(j < hi && abs(r0 + g + 8 * (e >> 1) - j) <= a.window)) s[u][e] = -INFINITY;
      }
  };
  auto skip = [&](int j0) { return j0 >= whi || j0 + 16 <= wlo; };

  // Pass 1: each lane's running max (in the scores' own units; a finite
  // floor, so that exp2 never sees -inf - -inf) and its sum of exp(s - max),
  // rescaled where a tile raises the max.
  float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
  auto pass1 = [&](int t, int st) {
    const bf16* Ks = ring + st * 2 * KT * LD;
    const int k0 = lo + KT * t;
    float s[STEPS][2][4];
    float m[2] = {mx[0], mx[1]};
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (skip(k0 + 16 * i)) continue;  // warp-uniform
      scores(s[i], Ks + 16 * i * LD, k0 + 16 * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], fmaxf(s[i][0][e], s[i][1][e]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m[r] > mx[r]) {
        sum[r] *= att16_exp2((mx[r] - m[r]) * scale2);
        mx[r] = m[r];
      }
    const float top[2] = {mx[0] * scale2, mx[1] * scale2};
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (skip(k0 + 16 * i)) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[e >> 1] += att16_exp2(fmaf(s[i][u][e], scale2, -top[e >> 1]));
    }
  };
  // The row's max and sum over the 4 lanes that share it.
  float m2[2], inv[2];
  auto finish = [&] {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = mx[r];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float x = sum[r] * att16_exp2((mx[r] - m) * scale2);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      m2[r] = m * scale2;
      inv[r] = x > 0.f ? 1.f / x : 0.f;
    }
  };
  // Pass 2: O += P V, P = exp(s - max) x (1 / sum) rounded to bf16 in the
  // packing.
  float o[NO][4] = {};
  auto pass2 = [&](int t, int st) {
    const bf16* Ks = ring + st * 2 * KT * LD;
    const int k0 = lo + KT * t;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (skip(k0 + 16 * i)) continue;
      float s[2][4];
      scores(s, Ks + 16 * i * LD, k0 + 16 * i);
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[u][e] = att16_exp2(fmaf(s[u][e], scale2, -m2[e >> 1])) * inv[e >> 1];
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      att16_pv<DP>(o, pa, Ks + (KT + 16 * i) * LD, lane);
    }
  };

  att16_stage<DP>(Qs, qb, a.q_sr, q0, ROWS, a.tq, a.d, tid, THREADS);
  if (resident) {  // every tile in its own stage: K (with q), then V
    for (int t = 0; t < nt; ++t) load(t, t, true, false);
    cp_async_commit();
    for (int t = 0; t < nt; ++t) load(t, t, false, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      att16_q<DP>(qa, Qs + 16 * warp * LD, lane);
      for (int t = 0; t < nt; ++t) pass1(t, t);
      finish();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (active)
      for (int t = 0; t < nt; ++t) pass2(t, t);
  } else {  // 2 nt loads through the ring: K alone for pass 1, K and V for pass 2
    const int nl = 2 * nt;
#pragma unroll
    for (int l = 0; l < NST - 1; ++l) {  // nt > NST: these are pass 1's
      load(l, l, true, false);
      cp_async_commit();
    }
    for (int l = 0; l < nl; ++l) {
      cp_async_wait<NST - 2>();  // load l (and q with load 0)
      __syncthreads();           // ... for every thread; stage (l - 1) % NST is free
      const int next = l + NST - 1;
      if (next < nl) load(next < nt ? next : next - nt, next % NST, true, next >= nt);
      cp_async_commit();
      if (!active) continue;
      if (l == 0) att16_q<DP>(qa, Qs + 16 * warp * LD, lane);
      if (l < nt) {
        pass1(l, l % NST);
      } else {
        if (l == nt) finish();
        pass2(l - nt, l % NST);
      }
    }
  }
  if (!active) return;
  bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    const int c = 8 * dn + 2 * t4;
    if (c >= a.d) continue;  // d % 8 == 0: a pair is wholly inside or outside
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < a.tq) store2(ob + (long long)row * a.o_sr + c, o[dn][2 * r], o[dn][2 * r + 1]);
    }
  }
}

// One function for both tiles, so the trace names both attention16_kernel:
// ROWS 16 is the key tile, 64 the row tile.
template <int DP, int ROWS>
__global__ void __launch_bounds__(ROWS == 16 ? 32 * ATT16_KW : 2 * ROWS, ROWS == 16 ? 1 : 4)
    attention16_kernel(AttnArgs a, int keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (ROWS == 16)
    att16_keys<DP>(a, keys, smem_raw);
  else
    att16_rows<DP, ROWS>(a, smem_raw);
}

// The tile the host's rule takes for batch x heads (batch, head) pairs of
// tq query rows: the row tile where its grid has blocks for
// ATT16_ROWS_MIN_FILL % of the SMs or more, the key tile (4x the blocks)
// otherwise.  On the H100, 4 heads
// of 40: the key tile is faster at 64 row-tile blocks (B = 2, T = 500: 12.3
// against 21.3 µs for both attentions), the row tile from 128 (B = 4, T =
// 500: 22.4 against 23.3; B = 2, T = 1000: 34.3 against 47.2).
inline int att16_pick_tile(int batch, int heads, int tq) {
  const long long blocks = (long long)batch * heads * ((tq + 63) / 64);
  return blocks * 100 >= (long long)ATT16_ROWS_MIN_FILL * sm_count() ? ATT16_TILE_ROWS
                                                                     : ATT16_TILE_KEYS;
}

template <int DP, int ROWS>
int launch_attention16_tile(const AttnArgs& a, int batch, int keys, int smem,
                            cudaStream_t stream) {
  const auto kernel = attention16_kernel<DP, ROWS>;
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT16_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((a.tq + ROWS - 1) / ROWS, batch * a.heads);
  kernel<<<grid, ROWS == 16 ? 32 * ATT16_KW : 2 * ROWS, smem, stream>>>(a, keys);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_attention16_dp(const AttnArgs& a, int batch, int tile, cudaStream_t stream) {
  if (tile == ATT16_TILE_ROWS)
    return launch_attention16_tile<DP, 64>(a, batch, 0, att16_rows_smem(DP, 64), stream);
  const int kend = min(a.tk, a.kv_len);
  const long long span = min((long long)kend, 16LL + 2LL * a.window);
  // The band's keys rounded up to 16, or one super-chunk's where it is longer
  // than ATT16_MAX_KEYS.
  int keys = span <= ATT16_MAX_KEYS ? (int)((span + 15) / 16 * 16) : ATT16_KEYS;
  keys = keys > 0 ? keys : 16;
  return launch_attention16_tile<DP, 16>(a, batch, keys, att16_smem(DP, keys), stream);
}

// Launch over `batch` * a.heads (batch, head) pairs, bf16 q, k, v and o, in
// `tile` (ATT16_TILE_KEYS or ATT16_TILE_ROWS; < 0: att16_pick_tile's);
// returns a cudaError_t (cudaErrorInvalidValue for a head dim that is not a
// multiple of 8 up to 64, or another tile).
inline int launch_attention16(const AttnArgs& a, int batch, cudaStream_t stream, int tile = -1) {
  if (a.tq <= 0 || batch <= 0) return 0;
  if (a.d <= 0 || a.d % 8 || a.d > 64 || tile >= ATT16_NTILES) return (int)cudaErrorInvalidValue;
  if (tile < 0) tile = att16_pick_tile(batch, a.heads, a.tq);
  int e;
  switch ((a.d + 15) / 16 * 16) {
    case 16: e = launch_attention16_dp<16>(a, batch, tile, stream); break;
    case 32: e = launch_attention16_dp<32>(a, batch, tile, stream); break;
    case 48: e = launch_attention16_dp<48>(a, batch, tile, stream); break;
    default: e = launch_attention16_dp<64>(a, batch, tile, stream); break;
  }
  if (!e) ++g_attn16_launches[tile];
  return e;
}

}  // namespace edt
