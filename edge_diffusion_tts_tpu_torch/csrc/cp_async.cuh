// cp.async (sm_80+) helpers shared by the kernels: 16-byte copies from
// global to shared memory that bypass registers, zero-filled where `full`
// is false (the source address is then not read, but must be valid), and
// completed per thread in commit groups.
#pragma once

#include <cuda_runtime.h>

namespace edt {

// A 16-byte copy of which only the first `bytes` (0 to 16) are read from
// src; the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  cp_async16_n(dst, src, full ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace edt
