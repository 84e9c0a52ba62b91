// What every library of the port shares at its C interface: running a
// launch on the caller's device, and the text of a CUDA error code.

#pragma once

#include <cuda_runtime.h>

namespace {

// Run fn() with ``device`` current, then restore the caller's device; the
// first CUDA error wins.  When ``device`` is already current (the usual
// case) nothing is switched.  A refused call (a shared-memory request past
// a CTA's limit) also stays the thread's last error, which the next entry's
// cudaGetLastError would report as its own launch's: clear it here.
template <typename Fn>
inline int on_device(int device, Fn fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  err = fn();
  if (err != cudaSuccess) cudaGetLastError();
  const cudaError_t restore = prev != device ? cudaSetDevice(prev) : cudaSuccess;
  return err != cudaSuccess ? err : restore;
}

}  // namespace

extern "C" const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
