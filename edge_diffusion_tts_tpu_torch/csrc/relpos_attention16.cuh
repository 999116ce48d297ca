// WavLM's gated relative-position self-attention on tensor cores, bf16, head
// dim 64 (models/hubert.py::Attention with cfg.num_buckets, at compute_dtype
// bfloat16 on the card).  It computes what the module's plain route
// computes:
//
//   z[i, j] = (q_i . k_j) / 8 + g[b, h, i] * r[h, j - i]      (float32)
//   P = softmax_j(z), normalised, rounded to bf16;  o_i = P V  (float32 sums)
//
// with q, k and v bf16 (the packed GEMM writes them rounded), r the call's
// per-head offset vector [heads, 2S - 1] (float32, offset j - i at index j -
// i + S - 1) and g the per-row gate, which the kernel forms itself from the
// same GEMM's 8 gate projections of (b, i, h): sigmoids a and b of the sums
// of the two groups of 4 (float32, in order), g = a (b c_h - 1) + 2.  The
// [B, heads, S, S] bias is never formed: each score reads its offset's
// value from shared memory.
//
// The block is attention16.cuh's row tile with the bias added to S and no
// band: 64 query rows of one (batch, head), a warp's 16 each; every key
// comes through a ring of RP_STAGES tiles of 64 keys shared by the block
// (a block whose keys fit the ring stages them once, K then V; more keys
// stream, K alone for pass 1 and K and V for pass 2); the fragments (Q's
// A fragments in registers, K's and V's by ldmatrix, mma.sync m16n8k16) are
// attention16.cuh's.  Two passes in the scores' log2 units: pass 1 keeps
// each lane's running max and its sum of exp2(z - max), rescaled where a
// tile raises the max, the row's 4 lanes combined at its end; pass 2
// recomputes z and forms P = exp2(z - max) x (1 / sum).  The block also
// stages the part of r its rows read (offsets -(q0 + 63) .. S - 1 - q0):
// a lane's 8 scores of a step read 14 consecutive words, no
// bank conflict.
//
// What bounds it on the H100: per score 3 x 64 x 2 FLOP of products (S
// twice, P V once) and two exps, plus an FMA and a shared read for the
// bias in each pass; K and V come from L2 once per 64 rows.
//
// q, k, v and the gate projections are read from one [B, S, ld] bf16
// buffer: q at column h 64, k at H + h 64, v at 2 H + h 64 (H = heads x 64),
// the gate projections at 3 H + h 8; ld a multiple of 8.  o is [B, S, H].
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention16.cuh"

namespace edt {

constexpr int RP_ROWS = 64;    // query rows of a block, a warp's 16 each
constexpr int RP_KT = 64;      // keys of a ring tile
constexpr int RP_STAGES = 3;   // tiles the ring holds
constexpr int RP_DP = 64;      // the head dim
constexpr int RP_MAX_S = 8192;  // positions: the offset window's floats fit shared memory

struct RelposArgs {
  const bf16* y;        // [B, S, ld]: q, k, v and the gate projections
  const float* rel;     // [heads, 2S - 1]
  const float* gconst;  // [heads]
  bf16* o;              // [B, S, heads * 64]
  int heads, S, ld;
};

inline long long g_relpos_launches = 0;  // launches of relpos_attention16_kernel

// Floats of a block's window of r: offsets -(q0 + 63) .. S - 1 - q0, and 16
// more that the last step's keys past S read (their scores are then -inf).
inline __host__ __device__ int relpos_window(int S) { return S + RP_ROWS + 16; }

// Shared bytes: the 64 q rows, the ring's stages of K and V (rows of 64 + 8
// elements), then the block's window of r.
inline int relpos_smem(int S) {
  return (RP_ROWS + 2 * RP_STAGES * RP_KT) * (RP_DP + 8) * 2 + relpos_window(S) * 4;
}

__global__ void __launch_bounds__(2 * RP_ROWS, 3) relpos_attention16_kernel(RelposArgs a) {
  constexpr int DP = RP_DP, LD = DP + 8, KT = RP_KT, NST = RP_STAGES, NO = DP / 8;
  constexpr int STEPS = KT / 16;
  constexpr int THREADS = 2 * RP_ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* ring = Qs + RP_ROWS * LD;                // [NST] x (K [KT][LD], V [KT][LD])
  float* rs = reinterpret_cast<float*>(ring + NST * 2 * KT * LD);  // r at j - i + q0 + 63

  const int S = a.S;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * RP_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int H = a.heads * DP;
  const bf16* yb = a.y + (long long)b * S * a.ld;
  const bf16* qb = yb + h * DP;
  const bf16* kb = yb + H + h * DP;
  const bf16* vb = yb + 2 * H + h * DP;
  const long long sr = a.ld;

  const int nt = (S + KT - 1) / KT;  // ring tiles of the keys
  const bool resident = nt <= NST;
  const int r0 = q0 + 16 * warp;
  const bool active = r0 < S;
  const int g = lane / 4, t4 = lane % 4;
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale2 = 0.125f * LOG2E;  // 64^-1/2 in log2 units

  // Tile t's K (and V) into ring stage st.
  auto load = [&](int t, int st, bool with_k, bool with_v) {
    bf16* Ks = ring + st * 2 * KT * LD;
    if (with_k) att16_stage<DP>(Ks, kb, sr, KT * t, KT, S, DP, tid, THREADS);
    if (with_v) att16_stage<DP>(Ks + KT * LD, vb, sr, KT * t, KT, S, DP, tid, THREADS);
  };

  // This lane's gates for rows r0 + g and r0 + g + 8, in log2 units.
  float gl[2] = {0.f, 0.f};
  const float c = a.gconst[h];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const uint4 u = *reinterpret_cast<const uint4*>(yb + row * sr + 3 * H + 8 * h);
    const bf16* p = reinterpret_cast<const bf16*>(&u);
    float pa = to_f32(p[0]), pb = to_f32(p[4]);
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      pa += to_f32(p[e]);
      pb += to_f32(p[4 + e]);
    }
    const float ga = 1.f / (1.f + expf(-pa)), gb = 1.f / (1.f + expf(-pb));
    gl[r] = (ga * (gb * c - 1.f) + 2.f) * LOG2E;
  }

  unsigned qa[DP / 16][4];
  // z of the 16-key step at key j0 (K's rows at Ks) for this lane's row r0 +
  // g (e < 2) or r0 + g + 8 and key j0 + 8 u + 2 t4 + e % 2, in log2 units;
  // -inf past the last key.
  auto scores = [&](float (&z)[2][4], const bf16* Ks, int j0) {
    att16_qk<DP>(z, qa, Ks, lane);
    const float* rw = rs + (j0 - r0 + q0 + 63) + 2 * t4 - g;  // offset of (u, e) = (0, 0)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        z[u][e] = fmaf(z[u][e], scale2, gl[e >> 1] * rw[8 * u + (e & 1) - 8 * (e >> 1)]);
    if (j0 + 16 <= S) return;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + 8 * u + 2 * t4 + (e & 1) >= S) z[u][e] = -INFINITY;
  };

  // Pass 1: each lane's running max (a finite floor, so that exp2 never
  // sees -inf - -inf) and its sum of exp2(z - max), rescaled where a tile
  // raises the max.
  float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
  auto pass1 = [&](int t, int st) {
    const bf16* Ks = ring + st * 2 * KT * LD;
    const int k0 = KT * t;
    float z[STEPS][2][4];
    float m[2] = {mx[0], mx[1]};
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (k0 + 16 * i >= S) continue;  // block-uniform
      scores(z[i], Ks + 16 * i * LD, k0 + 16 * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], fmaxf(z[i][0][e], z[i][1][e]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m[r] > mx[r]) {
        sum[r] *= att16_exp2(mx[r] - m[r]);
        mx[r] = m[r];
      }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (k0 + 16 * i >= S) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += att16_exp2(z[i][u][e] - mx[e >> 1]);
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
      float x = sum[r] * att16_exp2(mx[r] - m);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      m2[r] = m;
      inv[r] = x > 0.f ? 1.f / x : 0.f;
    }
  };
  // Pass 2: O += P V.  P = exp2(z - max) x (1 / sum) is rounded to bf16
  // here, in the packing of the A fragments, after it is normalised.
  float o[NO][4] = {};
  auto pass2 = [&](int t, int st) {
    const bf16* Ks = ring + st * 2 * KT * LD;
    const int k0 = KT * t;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (k0 + 16 * i >= S) continue;
      float z[2][4];
      scores(z, Ks + 16 * i * LD, k0 + 16 * i);
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[u][e] = att16_exp2(z[u][e] - m2[e >> 1]) * inv[e >> 1];
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      att16_pv<DP>(o, pa, Ks + (KT + 16 * i) * LD, lane);
    }
  };

  att16_stage<DP>(Qs, qb, sr, q0, RP_ROWS, S, DP, tid, THREADS);
  {  // the block's window of r: index t holds offset t - q0 - 63
    const float* rh = a.rel + (long long)h * (2 * S - 1);
    for (int t = tid; t < relpos_window(S); t += THREADS) {
      const int idx = t - q0 - 63 + S - 1;
      rs[t] = idx >= 0 && idx < 2 * S - 1 ? rh[idx] : 0.f;
    }
  }
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
  bf16* ob = a.o + (long long)b * S * H + h * DP;
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    const int col = 8 * dn + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < S) store2(ob + (long long)row * H + col, o[dn][2 * r], o[dn][2 * r + 1]);
    }
  }
}

// Launch over batch x a.heads (batch, head) pairs; returns a cudaError_t
// (cudaErrorInvalidValue for a row stride that is not a multiple of 8 or
// more than RP_MAX_S positions).
inline int launch_relpos_attention16(const RelposArgs& a, int batch, cudaStream_t stream) {
  if (a.S <= 0 || batch <= 0) return 0;
  if (a.ld % 8 || a.S > RP_MAX_S || a.heads <= 0 || a.ld < a.heads * (3 * RP_DP + 8))
    return (int)cudaErrorInvalidValue;
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        relpos_attention16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT16_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((a.S + RP_ROWS - 1) / RP_ROWS, batch * a.heads);
  relpos_attention16_kernel<<<grid, 2 * RP_ROWS, relpos_smem(a.S), stream>>>(a);
  const int e = (int)cudaGetLastError();
  if (!e) ++g_relpos_launches;
  return e;
}

// ---------------------------------------------------------------------------
// w2v-BERT's relative-key self-attention on tensor cores, bf16, head dim 64
// (models/w2v_bert.py::RelKeyAttention at compute_dtype bfloat16 on the
// card).  It computes what the module's plain route (relkey_attention)
// computes:
//
//   z[i, j] = (q_i . k_j + q_i . E[clamp(j - i, -left, right) + left]) / 8
//   P = softmax_j(z), normalised, rounded to bf16;  o_i = P V  (float32 sums)
//
// with q, k, v and the layer's distance table E [rows = left + right + 1, 64]
// bf16.  Unlike WavLM's bias the position term depends on the query, so the
// block first forms its 64 rows of Q E^T (64 x rows, rows padded to 80 with
// zeros: five 16-column steps of the same mma.sync fragments as Q K^T) and
// keeps them in shared memory, over the staged Q and E, which are then dead
// (Q's A fragments stay in registers).  A 16-key step whose keys all lie left
// of i - left (right of i + right) for every row of the warp adds one value a
// row, the table's first (last) column, held in registers; only the steps on
// the band of 73 offsets around the diagonal read the table per score.  The
// [B, heads, S, S] scores and the [S, S, 64] gathered table are never formed.
//
// The rest is relpos_attention16_kernel's: the 64-row tile, the ring of
// RP_STAGES tiles of 64 keys (staged once where they fit, else streamed: K
// alone for pass 1, K and V for pass 2), the two passes in log2 units, P
// rounded to bf16 after it is normalised.
//
// What bounds it on the H100: per score 3 x 64 x 2 FLOP of products and two
// exps, plus per query row 80 x 64 x 2 FLOP for Q E^T; K and V come from L2
// once per 64 rows.
//
// q, k and v are read from one [B, S, 3 H] bf16 buffer (H = heads x 64): q at
// column h 64, k at H + h 64, v at 2 H + h 64.  o is [B, S, H].
constexpr int RK_EROWS = 80;   // rows of E a block stages: five 16-column steps of Q E^T
constexpr int RK_QE_LD = 80;   // floats of a row of Q E^T in shared memory

struct RelkeyArgs {
  const bf16* y;  // [B, S, 3 heads 64]: q, k, v
  const bf16* E;  // [rows, 64]
  bf16* o;        // [B, S, heads * 64]
  int heads, S, rows, left;
};

inline long long g_relkey_launches = 0;  // launches of relkey_attention16_kernel

// Shared bytes: the 64 q rows and E's 80 rows (rows of 64 + 8 elements),
// whose place Q E^T then takes, and the ring's stages of K and V.
inline int relkey_smem() { return (RP_ROWS + RK_EROWS + 2 * RP_STAGES * RP_KT) * (RP_DP + 8) * 2; }
static_assert(RP_ROWS * RK_QE_LD * 4 <= (RP_ROWS + RK_EROWS) * (RP_DP + 8) * 2,
              "Q E^T fits the place of the staged Q and E");

__global__ void __launch_bounds__(2 * RP_ROWS, 3) relkey_attention16_kernel(RelkeyArgs a) {
  constexpr int DP = RP_DP, LD = DP + 8, KT = RP_KT, NST = RP_STAGES, NO = DP / 8;
  constexpr int STEPS = KT / 16;
  constexpr int THREADS = 2 * RP_ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* Es = Qs + RP_ROWS * LD;                  // [EROWS][LD]
  bf16* ring = Es + RK_EROWS * LD;               // [NST] x (K [KT][LD], V [KT][LD])
  float* qe = reinterpret_cast<float*>(smem_raw);  // [ROWS][QE_LD], once Qs and Es are read

  const int S = a.S;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int q0 = blockIdx.x * RP_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int H = a.heads * DP;
  const long long sr = 3LL * H;
  const bf16* yb = a.y + (long long)b * S * sr;
  const bf16* qb = yb + h * DP;
  const bf16* kb = yb + H + h * DP;
  const bf16* vb = yb + 2 * H + h * DP;

  const int nt = (S + KT - 1) / KT;  // ring tiles of the keys
  const bool resident = nt <= NST;
  const int r0 = q0 + 16 * warp;
  const bool active = r0 < S;
  const int g = lane / 4, t4 = lane % 4;
  const int left = a.left, right = a.rows - 1 - a.left;
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale2 = 0.125f * LOG2E;  // 64^-1/2 in log2 units

  // Tile t's K (and V) into ring stage st.
  auto load = [&](int t, int st, bool with_k, bool with_v) {
    bf16* Ks = ring + st * 2 * KT * LD;
    if (with_k) att16_stage<DP>(Ks, kb, sr, KT * t, KT, S, DP, tid, THREADS);
    if (with_v) att16_stage<DP>(Ks + KT * LD, vb, sr, KT * t, KT, S, DP, tid, THREADS);
  };

  unsigned qa[DP / 16][4];
  const float* qw = qe + 16 * warp * RK_QE_LD;  // this warp's 16 rows of Q E^T
  float cl[2] = {0.f, 0.f}, cr[2] = {0.f, 0.f};  // this lane's rows at offsets <= -left, >= right
  // z of the 16-key step at key j0 (K's rows at Ks) for this lane's row r0 +
  // g (e < 2) or r0 + g + 8 and key j0 + 8 u + 2 t4 + e % 2, in log2 units;
  // -inf past the last key.
  auto scores = [&](float (&z)[2][4], const bf16* Ks, int j0) {
    att16_qk<DP>(z, qa, Ks, lane);
    if (j0 + 15 - r0 <= -left) {  // every offset of the step clamps to -left
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[u][e] = (z[u][e] + cl[e >> 1]) * scale2;
    } else if (j0 - r0 - 15 >= right) {  // ... to right
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[u][e] = (z[u][e] + cr[e >> 1]) * scale2;
    } else {
      const int d0 = j0 - r0 + 2 * t4 - g;  // offset of (u, e) = (0, 0)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = min(max(d0 + 8 * u + (e & 1) - 8 * (e >> 1), -left), right) + left;
          z[u][e] = (z[u][e] + qw[(g + 8 * (e >> 1)) * RK_QE_LD + d]) * scale2;
        }
    }
    if (j0 + 16 <= S) return;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + 8 * u + 2 * t4 + (e & 1) >= S) z[u][e] = -INFINITY;
  };

  // Pass 1: each lane's running max (a finite floor, so that exp2 never
  // sees -inf - -inf) and its sum of exp2(z - max), rescaled where a tile
  // raises the max.
  float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
  auto pass1 = [&](int t, int st) {
    const bf16* Ks = ring + st * 2 * KT * LD;
    const int k0 = KT * t;
    float z[STEPS][2][4];
    float m[2] = {mx[0], mx[1]};
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (k0 + 16 * i >= S) continue;  // block-uniform
      scores(z[i], Ks + 16 * i * LD, k0 + 16 * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], fmaxf(z[i][0][e], z[i][1][e]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m[r] > mx[r]) {
        sum[r] *= att16_exp2(mx[r] - m[r]);
        mx[r] = m[r];
      }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (k0 + 16 * i >= S) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += att16_exp2(z[i][u][e] - mx[e >> 1]);
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
      float x = sum[r] * att16_exp2(mx[r] - m);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      m2[r] = m;
      inv[r] = x > 0.f ? 1.f / x : 0.f;
    }
  };
  // Pass 2: O += P V.  P = exp2(z - max) x (1 / sum) is rounded to bf16
  // here, in the packing of the A fragments, after it is normalised.
  float o[NO][4] = {};
  auto pass2 = [&](int t, int st) {
    const bf16* Ks = ring + st * 2 * KT * LD;
    const int k0 = KT * t;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (k0 + 16 * i >= S) continue;
      float z[2][4];
      scores(z, Ks + 16 * i * LD, k0 + 16 * i);
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[u][e] = att16_exp2(z[u][e] - m2[e >> 1]) * inv[e >> 1];
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      att16_pv<DP>(o, pa, Ks + (KT + 16 * i) * LD, lane);
    }
  };

  // Q and E (zeros past E's rows) as their own group, then the first loads
  // of the keys, which Q E^T does not wait for.
  att16_stage<DP>(Qs, qb, sr, q0, RP_ROWS, S, DP, tid, THREADS);
  att16_stage<DP>(Es, a.E, DP, 0, RK_EROWS, a.rows, DP, tid, THREADS);
  cp_async_commit();
  if (resident) {  // every tile in its own stage: K, then V
    for (int t = 0; t < nt; ++t) load(t, t, true, false);
    cp_async_commit();
    for (int t = 0; t < nt; ++t) load(t, t, false, true);
    cp_async_commit();
    cp_async_wait<2>();
  } else {  // 2 nt loads through the ring: K alone for pass 1, K and V for pass 2
#pragma unroll
    for (int l = 0; l < NST - 1; ++l) {  // nt > NST: these are pass 1's
      load(l, l, true, false);
      cp_async_commit();
    }
    cp_async_wait<NST - 1>();
  }
  __syncthreads();
  float qv[RK_EROWS / 16][2][4];
  if (active) {
    att16_q<DP>(qa, Qs + 16 * warp * LD, lane);
#pragma unroll
    for (int s = 0; s < RK_EROWS / 16; ++s) att16_qk<DP>(qv[s], qa, Es + 16 * s * LD, lane);
  }
  __syncthreads();  // every warp has read Qs and Es: Q E^T takes their place
  if (active) {
    float* qo = qe + 16 * warp * RK_QE_LD;
#pragma unroll
    for (int s = 0; s < RK_EROWS / 16; ++s)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qo[(g + 8 * (e >> 1)) * RK_QE_LD + 16 * s + 8 * u + 2 * t4 + (e & 1)] = qv[s][u][e];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cl[r] = qw[(g + 8 * r) * RK_QE_LD];
      cr[r] = qw[(g + 8 * r) * RK_QE_LD + a.rows - 1];
    }
  }
  if (resident) {
    cp_async_wait<1>();  // K
    __syncthreads();
    if (active) {
      for (int t = 0; t < nt; ++t) pass1(t, t);
      finish();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (active)
      for (int t = 0; t < nt; ++t) pass2(t, t);
  } else {
    const int nl = 2 * nt;
    for (int l = 0; l < nl; ++l) {
      cp_async_wait<NST - 2>();  // load l
      __syncthreads();           // ... for every thread; stage (l - 1) % NST is free
      const int next = l + NST - 1;
      if (next < nl) load(next < nt ? next : next - nt, next % NST, true, next >= nt);
      cp_async_commit();
      if (!active) continue;
      if (l < nt) {
        pass1(l, l % NST);
      } else {
        if (l == nt) finish();
        pass2(l - nt, l % NST);
      }
    }
  }
  if (!active) return;
  bf16* ob = a.o + (long long)b * S * H + h * DP;
#pragma unroll
  for (int dn = 0; dn < NO; ++dn) {
    const int col = 8 * dn + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < S) store2(ob + (long long)row * H + col, o[dn][2 * r], o[dn][2 * r + 1]);
    }
  }
}

// Launch over batch x a.heads (batch, head) pairs; returns a cudaError_t
// (cudaErrorInvalidValue for a table of more than RK_EROWS rows or a left
// reach outside it).
inline int launch_relkey_attention16(const RelkeyArgs& a, int batch, cudaStream_t stream) {
  if (a.S <= 0 || batch <= 0) return 0;
  if (a.heads <= 0 || a.rows <= 0 || a.rows > RK_EROWS || a.left < 0 || a.left >= a.rows)
    return (int)cudaErrorInvalidValue;
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        relkey_attention16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, relkey_smem());
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((a.S + RP_ROWS - 1) / RP_ROWS, batch * a.heads);
  relkey_attention16_kernel<<<grid, 2 * RP_ROWS, relkey_smem(), stream>>>(a);
  const int e = (int)cudaGetLastError();
  if (!e) ++g_relkey_launches;
  return e;
}

}  // namespace edt
