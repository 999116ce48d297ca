// Banded attention for the long-form route, designed for the H100.  Bound
// from Python with ctypes by ops/window_attention.py, which also holds the
// launch plan (band_plan) and the plain version.
//
// Replaces the TPU kernel edge_diffusion_tts_tpu/ops/window_attention.py::
// _band_kernel: query row i attends key j iff |i - j| <= window and
// j < kv_len; softmax in float32; a row with no admissible key gives zeros.
// (The fused decoder step keeps its own attention, attention.cuh, whose
// float32 summation order the 1000-step DDPM check rests on.)
//
// What bounds it on the H100: about 4*d*(2w+1) FLOP per query row, 0.33
// GFLOP at [1,4,4000,40], w=64, against 10 MB of q, k, v and o: float32 FMA
// at 67 TFLOP/s bounds it (4.9 µs), not HBM (3.1 µs).  Design:
//   * one block per (batch, head, ROWS query rows); warps of 16 query rows,
//     lanes as 4 row groups x 8 key groups; the host's plan (band_plan)
//     picks ROWS per shape;
//   * Q staged once; K and V of the block's band [q0 - w, q0 + ROWS + w)
//     walked once in chunks of KEYS keys through a ring of STAGES
//     chunks, filled by 16-byte cp.async while earlier chunks are in use
//     (dynamic shared memory; rows padded to DP + 4 floats, an odd number of
//     float4s, so that a warp's float4 reads of 8 keys or 4 rows hit
//     distinct banks; the head dim zero-padded to DP, a multiple of 8);
//   * S = Q K^T per chunk as a register tile of 4 rows x 4 keys per thread
//     (rows tr + 4r, keys tc + 8t), 8 float4 loads per 64 FMAs;
//   * the softmax once per chunk (FlashAttention-2 form): the row max over
//     the 8 lanes of a row group by shuffles, the running sum and the
//     accumulator rescaled once per chunk, one exp2 per score (the scale and
//     log2(e) folded into S), no branch per key;
//   * P through a warp-private shared tile, then O += P V as a register tile
//     of 4 rows x DP/8 columns per thread (float4 columns 32g + 4tc, then
//     single columns), 3 loads per 20 FMAs at d = 40;
//   * a warp skips keys that lie wholly outside its 16 rows' band; the
//     scores are masked;
//   * q, k, v and o are read and written through explicit strides (the
//     last dimension unit-stride, rows 16-byte aligned), so the layer hands
//     over views of its qkv projection and gets o in [B, T, H, d] memory.
// All arithmetic is float32 FMA: 3xTF32 tensor-core products (mma.sync)
// were faster but 3.7x the float32 error against float64, more than the 2x
// allowed (PERF.md).  What holds the kernel near a quarter of its bound is
// each block's serial chain of chunk waits, syncs, masks and softmax, about
// half the time at T = 4000 (port_profile.py --band-strip; PERF.md).
//
// bf16 q, k, v (the TPU kernel's casts, window_attention.py:88-89, :107)
// take band16.cuh's kernel on tensor cores (its header gives the design):
// S exact in float32 but for the order of its sums, P kept to ~16 bits as
// two bf16 products, o rounded to bf16 once.
#include <cuda_runtime.h>
#include <math.h>

#include "band16.cuh"
#include "bf16.cuh"
#include "cp_async.cuh"
#include "device.cuh"

// A diagnostic build (port_profile.py --band-strip N, -DEDT_BAND_STRIP=N)
// leaves work out to show where the time goes: 1 every product and the
// softmax (staging alone), 2 O += P V, 3 S = Q K^T.  Its output is wrong.
#ifndef EDT_BAND_STRIP
#define EDT_BAND_STRIP 0
#endif

namespace {

constexpr int KEYS = 32;       // keys per chunk
constexpr int STAGES = 3;      // chunks in the ring
constexpr int WARP_ROWS = 16;  // query rows per warp
constexpr int PSTRIDE = KEYS + 8;  // floats per row of a warp's P tile (banks: 8*tr + tc)

__host__ __device__ constexpr int head_pad(int d) { return (d + 7) / 8 * 8; }
__host__ __device__ constexpr int threads_for(int rows) { return rows / WARP_ROWS * 32; }
// Floats per shared row of Q, K, V: DP + 4 (an odd number of float4s).
__host__ __device__ constexpr int row_elems(int dp) { return dp + 4; }
__host__ __device__ constexpr long long smem_bytes(int rows, int dp) {
  return 4LL * ((long long)rows * row_elems(dp) + 2LL * STAGES * KEYS * row_elems(dp)) +
         4LL * rows * PSTRIDE;
}

using edt::BandArgs;

__device__ __forceinline__ float comp(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

template <int DP, int ROWS>
__global__ void __launch_bounds__(ROWS / WARP_ROWS * 32) band_tile_kernel(BandArgs a) {
  constexpr int THREADS = threads_for(ROWS);
  constexpr int RS = row_elems(DP);  // floats per shared row of Q, K, V
  constexpr int D4 = DP / 4;
  constexpr int EV = 4;  // floats per 16-byte copy
  constexpr int DV = DP / EV;
  constexpr int N4 = DP / 32;          // float4 output columns per thread
  constexpr int NS = (DP % 32) / 8;    // single output columns per thread
  constexpr int NC = 4 * N4 + NS;      // = DP / 8
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [ROWS][RS]
  float* ring = qs + ROWS * RS;       // [STAGES][K, V][KEYS][RS]
  const int warp = threadIdx.x / 32;  // the warp's rows: 16 warp .. 16 warp + 15 of the block's
  const int lane = threadIdx.x % 32;
  float* ps = ring + STAGES * 2 * KEYS * RS + warp * WARP_ROWS * PSTRIDE;  // [16][PSTRIDE]
  const int tr = lane / 8;  // row group: rows tr + 4r of the warp's 16
  const int tc = lane % 8;  // key group: keys tc + 8t of a chunk; columns of O

  const int b = blockIdx.y / a.heads;
  const int h = blockIdx.y % a.heads;
  const int q0 = blockIdx.x * ROWS;
  const float* qb = static_cast<const float*>(a.q) + b * a.s[0][0] + h * a.s[0][1];
  const float* kb = static_cast<const float*>(a.k) + b * a.s[1][0] + h * a.s[1][1];
  const float* vb = static_cast<const float*>(a.v) + b * a.s[2][0] + h * a.s[2][1];
  // Bytes of a 16-byte copy at column c that lie inside the head (zeros
  // past it).
  const auto inside = [&](int c) { return c < a.d ? min(16, (a.d - c) * 4) : 0; };

  const int lo = max(0, q0 - a.window);
  const int hi = min(a.kend, q0 + ROWS + a.window);
  const int chunks = lo < hi ? (hi - lo + KEYS - 1) / KEYS : 0;

  // Q rides in the first group, with chunk 0.
  for (int e = threadIdx.x; e < ROWS * DV; e += THREADS) {
    const int r = e / DV;
    const int c = EV * (e % DV);
    const int n = q0 + r < a.T ? inside(c) : 0;  // zeros past T and past the head
    edt::cp_async16_n(qs + r * RS + c, n ? qb + (q0 + r) * a.s[0][2] + c : qb, n);
  }
  // Chunk `ch` into its ring slot, as one commit group (empty past the end).
  auto stage = [&](int ch) {
    if (ch < chunks) {
      const int c0 = lo + ch * KEYS;
      float* ks = ring + (ch % STAGES) * 2 * KEYS * RS;
      float* vs = ks + KEYS * RS;
      for (int e = threadIdx.x; e < KEYS * DV; e += THREADS) {
        const int kr = e / DV;
        const int c = EV * (e % DV);
        const int n = c0 + kr < hi ? inside(c) : 0;
        edt::cp_async16_n(ks + kr * RS + c, n ? kb + (c0 + kr) * a.s[1][2] + c : kb, n);
        edt::cp_async16_n(vs + kr * RS + c, n ? vb + (c0 + kr) * a.s[2][2] + c : vb, n);
      }
    }
    edt::cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < STAGES - 1; ++ch) stage(ch);

  const int w0 = q0 + warp * WARP_ROWS;  // the warp's first row
  const float* qw = qs + (warp * WARP_ROWS + tr) * RS;
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < NC; ++x) acc[r][x] = 0.f;
  }

  for (int ch = 0; ch < chunks; ++ch) {
    edt::cp_async_wait<STAGES - 2>();  // chunk ch (and Q) have landed
    __syncthreads();              // ... for every thread; slot ch - 1 is free
    stage(ch + STAGES - 1);
    const int c0 = lo + ch * KEYS;  // the chunk's keys c0 .. c0 + KEYS - 1
    // Warp-uniform: skip keys wholly outside the band of rows w0 .. w0+15.
    if (w0 >= a.T || c0 > w0 + WARP_ROWS - 1 + a.window || c0 + KEYS - 1 < w0 - a.window ||
        EDT_BAND_STRIP == 1)
      continue;
    const float* ks = ring + (ch % STAGES) * 2 * KEYS * RS;
    const float* vs = ks + KEYS * RS;

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[r][t] = 0.f;
#pragma unroll
    for (int c = 0; c < (EDT_BAND_STRIP == 3 ? 0 : D4); ++c) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = edt::load4(qw + 4 * r * RS + 4 * c);
#pragma unroll
      for (int t = 0; t < 4; ++t) kv[t] = edt::load4(ks + (tc + 8 * t) * RS + 4 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[r][t] = fmaf(qv[r].x, kv[t].x, s[r][t]);
          s[r][t] = fmaf(qv[r].y, kv[t].y, s[r][t]);
          s[r][t] = fmaf(qv[r].z, kv[t].z, s[r][t]);
          s[r][t] = fmaf(qv[r].w, kv[t].w, s[r][t]);
        }
    }

    // Mask, then the online softmax once per chunk; P into the warp's tile.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = w0 + tr + 4 * r;
      float cm = -INFINITY;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = c0 + tc + 8 * t;
        const bool ok = j < a.kend && abs(i - j) <= a.window;
        s[r][t] = ok ? s[r][t] * a.scale_log2 : -INFINITY;
        cm = fmaxf(cm, s[r][t]);
      }
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
      const float mn = fmaxf(m[r], cm);
      const float base = mn == -INFINITY ? 0.f : mn;  // no key yet: every p and alpha is 0
      const float alpha = exp2f(m[r] - base);
      m[r] = mn;
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p = exp2f(s[r][t] - base);
        rs += p;
        ps[(tr + 4 * r) * PSTRIDE + tc + 8 * t] = p;
      }
      l[r] = fmaf(l[r], alpha, rs);  // this lane's keys only; summed at the end
#pragma unroll
      for (int x = 0; x < NC; ++x) acc[r][x] *= alpha;
    }
    __syncwarp();

    if (EDT_BAND_STRIP == 2) continue;
    // O += P V over the chunk's keys.
#pragma unroll 2
    for (int j = 0; j < KEYS; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(ps + (tr + 4 * r) * PSTRIDE + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // unrolled: comp() picks a register
        const float* vr = vs + (j + u) * RS;
#pragma unroll
        for (int g = 0; g < N4; ++g) {
          const float4 x = edt::load4(vr + 32 * g + 4 * tc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = comp(pv[r], u);
            acc[r][4 * g] = fmaf(p, x.x, acc[r][4 * g]);
            acc[r][4 * g + 1] = fmaf(p, x.y, acc[r][4 * g + 1]);
            acc[r][4 * g + 2] = fmaf(p, x.z, acc[r][4 * g + 2]);
            acc[r][4 * g + 3] = fmaf(p, x.w, acc[r][4 * g + 3]);
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float x = vr[32 * N4 + tc + 8 * n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r][4 * N4 + n] = fmaf(comp(pv[r], u), x, acc[r][4 * N4 + n]);
        }
      }
    }
    __syncwarp();  // the P tile is rewritten by the next chunk
  }
  edt::cp_async_wait<0>();  // no copy outlives the block (Q's, when there is no chunk)

  // Each lane summed its own keys: add the 8 lanes of a row group, write.
  float* ob = static_cast<float*>(a.o) + b * a.s[3][0] + h * a.s[3][1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const int i = w0 + tr + 4 * r;
    if (i >= a.T) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    float* orow = ob + i * a.s[3][2];
#pragma unroll
    for (int g = 0; g < N4; ++g) {
      const int c = 32 * g + 4 * tc;
      if (c < a.d)
        edt::store4(orow + c, acc[r][4 * g] * inv, acc[r][4 * g + 1] * inv,
                    acc[r][4 * g + 2] * inv, acc[r][4 * g + 3] * inv);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = 32 * N4 + tc + 8 * n;
      if (c < a.d) edt::store1(orow + c, acc[r][4 * N4 + n] * inv);
    }
  }
}

template <int DP, int ROWS>
int launch(const BandArgs& a, int batch, cudaStream_t stream) {
  const auto kernel = band_tile_kernel<DP, ROWS>;
  constexpr long long bytes = smem_bytes(ROWS, DP);
  // Above 48 KB only after opting in, once per instance on each device.
  static bool opted_in[edt::kMaxDevices] = {};
  const int dev = edt::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((a.T + ROWS - 1) / ROWS, batch * a.heads);
  kernel<<<grid, threads_for(ROWS), bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch_tile(const BandArgs& a, int batch, cudaStream_t stream) {
  switch (head_pad(a.d)) {
    case 8: return launch<8, ROWS>(a, batch, stream);
    case 16: return launch<16, ROWS>(a, batch, stream);
    case 24: return launch<24, ROWS>(a, batch, stream);
    case 32: return launch<32, ROWS>(a, batch, stream);
    case 40: return launch<40, ROWS>(a, batch, stream);
    case 48: return launch<48, ROWS>(a, batch, stream);
    case 56: return launch<56, ROWS>(a, batch, stream);
    case 64: return launch<64, ROWS>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int DP, int ROWS>
int launch16(const BandArgs& a, int batch, cudaStream_t stream) {
  const auto kernel = edt::band16_kernel<DP, ROWS>;
  constexpr long long bytes = edt::b16_smem_bytes(ROWS, DP);
  static bool opted_in[edt::kMaxDevices] = {};
  const int dev = edt::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((a.T + ROWS - 1) / ROWS, batch * a.heads);
  kernel<<<grid, threads_for(ROWS), bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch16_tile(const BandArgs& a, int batch, cudaStream_t stream) {
  switch (edt::b16_head_pad(a.d)) {
    case 16: return launch16<16, ROWS>(a, batch, stream);
    case 32: return launch16<32, ROWS>(a, batch, stream);
    case 48: return launch16<48, ROWS>(a, batch, stream);
    case 64: return launch16<64, ROWS>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiles the host's plan may pick: 32 or 64 query rows per block;
// elements of 4 bytes (float32) or 2 (bf16).
bool geometry_ok(int rows, int d, int es) {
  return (rows == 32 || rows == 64) && d >= 4 && d <= 64 && d % 4 == 0 && (es == 4 || es == 2);
}

// {threads, keys per chunk, ring stages, dynamic shared bytes} of a launch.
void geometry(int rows, int d, int es, int* out) {
  out[0] = threads_for(rows);
  out[1] = es == 4 ? KEYS : edt::B16_KEYS;
  out[2] = es == 4 ? STAGES : edt::B16_STAGES;
  out[3] = (int)(es == 4 ? smem_bytes(rows, head_pad(d))
                         : edt::b16_smem_bytes(rows, edt::b16_head_pad(d)));
}

}  // namespace

// The geometry this library was built for, at `rows` query rows per block,
// head dim `d` and `es`-byte elements (4: float32, 2: bf16): out =
// {threads per block, keys per chunk, ring stages, dynamic shared bytes}.
// Returns cudaErrorInvalidValue for a tile, head dim or element size the
// kernel does not take.
extern "C" int edt_band_geometry(int rows, int d, int es, int* out) {
  if (!geometry_ok(rows, d, es)) return (int)cudaErrorInvalidValue;
  geometry(rows, d, es, out);
  return 0;
}

// q, k, v, o: [B, H, T, d], float32 (es = 4) or bf16 (es = 2), with
// strides[12] = (batch, head, row) strides in elements of q, k, v, o (the
// last dimension unit-stride, rows 16-byte aligned); `rows`, `threads` and
// `smem` are the host's plan, which must equal this library's geometry
// (else cudaErrorInvalidConfiguration).  Returns the launch's cudaError_t
// (0 on success).
extern "C" int edt_banded_attention(const void* q, const void* k, const void* v, void* o,
                                    const long long* strides, int B, int H, int T, int d,
                                    int window, int seq_len, int rows, int threads, int smem,
                                    int es, void* stream) {
  if (!geometry_ok(rows, d, es)) return (int)cudaErrorInvalidValue;
  int geo[4];
  geometry(rows, d, es, geo);
  if (threads != geo[0] || smem != geo[3]) return (int)cudaErrorInvalidConfiguration;
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  BandArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int t = 0; t < 4; ++t)
    for (int x = 0; x < 3; ++x) a.s[t][x] = strides[3 * t + x];
  a.heads = H;
  a.T = T;
  a.d = d;
  a.window = window < 0 ? 0 : (window > T ? T : window);
  a.kend = seq_len < 0 ? 0 : (seq_len > T ? T : seq_len);
  a.scale_log2 = (float)(pow((double)d, -0.5) * 1.4426950408889634);
  const cudaStream_t st = (cudaStream_t)stream;
  if (es == 2) return rows == 64 ? launch16_tile<64>(a, B, st) : launch16_tile<32>(a, B, st);
  return rows == 64 ? launch_tile<64>(a, B, st) : launch_tile<32>(a, B, st);
}
