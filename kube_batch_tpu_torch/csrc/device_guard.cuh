// Make a device current for one launch, and the caller's device current
// again after it. A launch goes to a stream that belongs to one device; the
// calling thread may have another device current (a mesh over several
// cards launches on each from one thread), and CUDA refuses a launch onto
// another device's stream.

#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1, device;
  cudaError_t err;

  explicit DeviceGuard(int d) : device(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
  }
};
