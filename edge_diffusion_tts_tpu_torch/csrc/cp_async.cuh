// cp.async (sm_80+) helpers shared by the kernels: 16-byte copies from
// global to shared memory that bypass registers, zero-filled where `full`
// is false (the source address is then not read, but must be valid), and
// completed per thread in commit groups.
#pragma once

#include <cuda_runtime.h>

namespace edt {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace edt
