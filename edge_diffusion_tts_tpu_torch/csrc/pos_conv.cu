// The speech encoder's positional conv embedding at float32, in one launch:
// h [B, S, C] -> h + gelu(conv(h) + bias) [B, S, C].
//
// It replaces no TPU kernel: the JAX package leaves this grouped conv to
// XLA (edge_diffusion_tts_tpu/models/hubert.py's PositionalConvEmbedding).
// It computes models/hubert.py::PositionalConvEmbedding and the residual add
// of HubertEncoder.forward: a Conv1d of C channels in G groups of CPG (48 for
// HuBERT-base's 768, 64 for WavLM-Large's 1024), 128 taps, padding 64, a bias,
// the last output frame trimmed, then erf-GELU, then h added:
//
//   y[b, t, g CPG + o] = bias[g CPG + o]
//       + sum_{c < CPG, j < 128} h[b, t + j - 64, g CPG + c] W[g CPG + o, c, j]
//
// for the S frames kept after the trim, frames outside [0, S) read as zero.
// h is read in the layout it lies in, [B, S, C] (the module transposes it to
// [B, C, S] for cuDNN and back).  The products are float32 FMAs and nothing
// else: no TF32, no 3xTF32 (the float32 cells' limit on the mel's RMS gap,
// 2.5e-4, lies below what TF32 products read there, 8.45e-4).
//
// What bounds it on the H100: 2 B S C CPG 128 FLOP, 105 GFLOP at [32, 347,
// 768] (1.56 ms at 67 TFLOP/s); its bytes (h read and the output written
// once, the packed weights, 18.9 MB at CPG 48) are ~90 MB, 27 us at 3.35
// TB/s: operations bound it.  Per group it is a GEMM of M = B S frames, N =
// CPG and K = CPG x 128 = 6,144; N is small, so a tile cannot take the usual
// square shape, and cuDNN's implicit_convolve_sgemm runs it at ~7% of the
// bound.
//
// Design.  A block takes one group, one batch row and TM = 128 output
// frames: 128 threads, each holding an 8-frame x (CPG / 8)-channel register
// tile (frames r, r + 16, ..., r + 112 of the tile; channels og, og + 8,
// ...).  The block stages the slab of input frames its outputs read,
// [TM + 127 frames, CPG channels], in shared memory once, by 16-byte cp.async
// with the halo's zeros from masked copies; each frame's row is padded to
// CPG + 4 floats, so that the 4 consecutive frames a warp reads at once lie
// on distinct banks.  The weights stream through a 3-stage cp.async ring,
// one stage for every (tap residue j0 < 16, 4-channel chunk): its taps are
// j0, j0 + 16, ..., j0 + 112, all CPG outputs.  That order is what lets the
// frames slide: output frame r + 16 i at tap j0 + 16 u reads input frame
// r + j0 + 16 (i + u), so a stage's 8 x 8 (frame, tap) products of a thread
// read 15 slab values, not 64 (15 + CPG 16-byte shared loads for 32 CPG
// FMAs: 24 FMAs a load at CPG 48).  The weights stream and the frames
// stay: a block's slab is 53 KB and the group's weights 1.18 MB, so the
// slab stays whole and the weights come from L2
// (18.9 MB packed once, [G, 16, CPG / 4, 8, CPG, 4], which stays in the
// 50 MB L2).  A stage's products sum in the order 4-channel chunk, tap,
// channel; a thread's frames of one tap share a weight load.  The epilogue
// adds the bias, applies erf-GELU and adds the residual, read from the slab
// (the frames the block computes are in it), and writes each thread's
// outputs; frames past S are not written.
//
// At CPG 48 a block takes 71.5 KB of shared memory, three blocks an SM; at
// CPG 64, 94 KB, two.  edt_pos_conv_launches counts the launches.
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>

#include "cp_async.cuh"
#include "device.cuh"

namespace {

constexpr int TAPS = 128;             // kernel taps; padding TAPS / 2, the last frame trimmed
constexpr int PAD = TAPS / 2;
constexpr int TM = 128;               // output frames per block
constexpr int TF = 8;                 // output frames per thread: r, r + RT, ..., r + 7 RT
constexpr int RT = TM / TF;           // a block's threads along the frames: 16
constexpr int OG = 8;                 // ... along the channels: og takes og, og + 8, ...
constexpr int THREADS = RT * OG;      // 128
constexpr int U = TAPS / RT;          // taps of a stage: j0, j0 + RT, ..., j0 + 7 RT
constexpr int STAGES = 3;             // stages the ring holds
constexpr int SLAB = TM + TAPS - 1;   // input frames a block reads
constexpr int AK = TF + U - 1;        // slab frames a thread reads per stage

template <int CPG>
struct Geo {
  static constexpr int TO = CPG / OG;         // output channels per thread
  static constexpr int ROW = CPG + 4;         // floats of a staged frame (padded)
  static constexpr int C4 = CPG / 4;          // 4-channel chunks
  static constexpr int STAGE = U * CPG * 4;   // a stage's floats: [U taps][CPG out][4 channels]
  static constexpr int NQ = RT * C4;          // stages a block walks
  static constexpr int SLAB_FLOATS = SLAB * ROW;
  static constexpr int BYTES = (SLAB_FLOATS + STAGES * STAGE) * 4;
  static constexpr int MIN_BLOCKS = CPG == 48 ? 3 : 2;  // blocks an SM (shared memory)
  static_assert(CPG % OG == 0 && STAGE / 4 % THREADS == 0, "a stage splits evenly");
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// out[b, t, g CPG + o] = h[b, t, g CPG + o] + gelu(y[b, t, g CPG + o]) for
// the tile's frames t < S.  w is packed [G][RT][C4][U][CPG][4]: stage q = j0
// C4 + c4 of group g holds W[g CPG + o, 4 c4 + e, j0 + RT u] at [u][o][e].
// Grid (ceil(S / TM), G, B).
template <int CPG>
__global__ void __launch_bounds__(THREADS, Geo<CPG>::MIN_BLOCKS)
pos_conv_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, int S, int C) {
  using G = Geo<CPG>;
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;  // [SLAB][ROW]: input frames t0 - PAD ...
  float* ring = smem + G::SLAB_FLOATS;
  const int t0 = blockIdx.x * TM, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int og = lane & 7, r = (lane >> 3) + 4 * (tid >> 5);  // a warp: 8 channels x 4 frames
  const float* hg = h + (long long)b * S * C + g * CPG;
  const float* wg = w + (long long)g * G::NQ * G::STAGE;

  for (int e = tid; e < SLAB * G::C4; e += THREADS) {
    const int s = e / G::C4, k = e % G::C4, f = t0 - PAD + s;
    const bool inside = f >= 0 && f < S;
    edt::cp_async16(slab + s * G::ROW + 4 * k, hg + (long long)(inside ? f : 0) * C + 4 * k,
                    inside);
  }
  auto copy_stage = [&](int q) {
    const float* src = wg + (long long)q * G::STAGE;
    float* dst = ring + (q % STAGES) * G::STAGE;
#pragma unroll
    for (int k = 0; k < G::STAGE / 4 / THREADS; ++k)
      edt::cp_async16(dst + 4 * (tid + k * THREADS), src + 4 * (tid + k * THREADS), true);
  };
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {  // the slab lands with stage 0
    copy_stage(p);
    edt::cp_async_commit();
  }

  float acc[TF][G::TO];
#pragma unroll
  for (int i = 0; i < TF; ++i)
#pragma unroll
    for (int o = 0; o < G::TO; ++o) acc[i][o] = 0.f;

#pragma unroll 1
  for (int q = 0; q < G::NQ; ++q) {
    edt::cp_async_wait<STAGES - 2>();  // stage q has landed (this thread's copies)
    __syncthreads();                   // everyone's, and stage q - 1's slot is free again
    if (q + STAGES - 1 < G::NQ) copy_stage(q + STAGES - 1);
    edt::cp_async_commit();
    const int j0 = q / G::C4, c4 = q % G::C4;
    const float* ws = ring + (q % STAGES) * G::STAGE + 4 * og;
    const float* as = slab + (r + j0) * G::ROW + 4 * c4;
    float4 a[AK];  // input frames r + j0 + RT k, channels 4 c4 .. 4 c4 + 3
#pragma unroll
    for (int k = 0; k < AK; ++k) a[k] = *reinterpret_cast<const float4*>(as + RT * k * G::ROW);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = 0; o < G::TO; ++o) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + 4 * (u * CPG + OG * o));
#pragma unroll
        for (int i = 0; i < TF; ++i) {
          float v = acc[i][o];
          v = fmaf(a[i + u].x, wv.x, v);
          v = fmaf(a[i + u].y, wv.y, v);
          v = fmaf(a[i + u].z, wv.z, v);
          acc[i][o] = fmaf(a[i + u].w, wv.w, v);
        }
      }
    }
  }

  float bv[G::TO];
#pragma unroll
  for (int o = 0; o < G::TO; ++o) bv[o] = bias[g * CPG + og + OG * o];
#pragma unroll
  for (int i = 0; i < TF; ++i) {
    const int m = r + RT * i;
    if (t0 + m >= S) continue;
    const float* res = slab + (m + PAD) * G::ROW + og;  // h at frame t0 + m
    float* dst = out + ((long long)b * S + t0 + m) * C + g * CPG + og;
#pragma unroll
    for (int o = 0; o < G::TO; ++o) dst[OG * o] = res[OG * o] + gelu(acc[i][o] + bv[o]);
  }
}

std::atomic<long long> g_launches{0};

template <int CPG>
int set_smem() {
  // The attribute is per device: set once on each, before any graph capture.
  static bool done[edt::kMaxDevices] = {};
  const int dev = edt::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        pos_conv_kernel<CPG>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<CPG>::BYTES);
    if (err) return (int)err;
    done[dev] = true;
  }
  return 0;
}

template <int CPG>
int launch(const float* h, const float* w, const float* bias, float* out, int B, int S, int C,
           cudaStream_t st) {
  const int err = set_smem<CPG>();
  if (err) return err;
  const dim3 grid((S + TM - 1) / TM, C / CPG, B);
  pos_conv_kernel<CPG><<<grid, THREADS, Geo<CPG>::BYTES, st>>>(h, w, bias, out, S, C);
  return (int)cudaGetLastError();
}

template <int CPG>
int geometry(int* out) {
  int err = set_smem<CPG>(), blocks = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pos_conv_kernel<CPG>,
                                                             THREADS, Geo<CPG>::BYTES);
  const int v[7] = {TAPS, TM, RT, U, THREADS, Geo<CPG>::BYTES, blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return err;
}

}  // namespace

// h [B, S, C], w packed [C / cpg][16][cpg / 4][8][cpg][4] (see
// pos_conv_kernel), bias [C], out [B, S, C]: all contiguous float32 on the
// current device, out apart from h.  cpg (channels a group) 48 or 64.
// Returns the launch's cudaError_t.
extern "C" int edt_pos_conv(const float* h, const float* w, const float* bias, float* out, int B,
                            int S, int C, int cpg, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || cpg < 1 || C % cpg || C / cpg > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (cpg == 48)
    err = launch<48>(h, w, bias, out, B, S, C, st);
  else if (cpg == 64)
    err = launch<64>(h, w, bias, out, B, S, C, st);
  else
    return (int)cudaErrorInvalidValue;
  if (!err) ++g_launches;
  return err;
}

// The kernel's geometry at cpg channels a group, to hold the host's packing
// against: out = {taps, frames a block, threads along the frames (the tap
// stride of a stage), taps a stage, threads a block, dynamic shared bytes,
// blocks an SM on the current device}.
extern "C" int edt_pos_conv_geometry(int cpg, int* out) {
  if (cpg == 48) return geometry<48>(out);
  if (cpg == 64) return geometry<64>(out);
  return (int)cudaErrorInvalidValue;
}

// Launches since the library was loaded.
extern "C" long long edt_pos_conv_launches() { return g_launches.load(); }
