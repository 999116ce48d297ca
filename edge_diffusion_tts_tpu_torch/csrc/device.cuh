// Per-device host state shared by the kernels' launchers.  One process may
// launch on several devices (make_dp_generate keeps a decoder replica on
// each), and the SM count and the >48 KB shared-memory opt-in are facts of
// one device: each launcher keeps them in a table indexed by the current
// device, sized by kMaxDevices.
#pragma once

#include <cuda_runtime.h>

namespace edt {

constexpr int kMaxDevices = 64;

// The current device's index, or -1 when it cannot be read or lies past
// the tables.
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

}  // namespace edt
