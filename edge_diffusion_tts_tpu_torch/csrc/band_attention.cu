// C entry point of the banded-attention kernel (see attention.cuh for the
// design).  Bound from Python with ctypes by ops/window_attention.py.
#include <math.h>

#include "attention.cuh"

// q, k, v, o: contiguous float32 [B, H, T, d] on the current device; blocks
// of 16 query rows x 4 threads each, the decoder step's tile.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int edt_banded_attention(const float* q, const float* k, const float* v, float* o,
                                    int B, int H, int T, int d, int window, int seq_len,
                                    void* stream) {
  edt::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sr = a.kv_sr = a.o_sr = d;
  a.q_sh = a.kv_sh = a.o_sh = (long long)T * d;
  a.q_sb = a.kv_sb = a.o_sb = (long long)H * T * d;
  a.heads = H;
  a.tq = T;
  a.tk = T;
  a.d = d;
  a.window = window;
  a.kv_len = seq_len;
  a.scale = (float)pow((double)d, -0.5);
  return edt::launch_attention<16, 4>(a, B, (cudaStream_t)stream);
}
