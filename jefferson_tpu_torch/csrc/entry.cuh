// What every library of the port shares at its C interface: running a
// launch on the caller's device, raising a kernel's shared-memory limit
// once, and the text of a CUDA error code.

#pragma once

#include <atomic>

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

// cudaFuncSetAttribute for a kernel's dynamic shared memory, once per
// process and device: ``done`` is the kernel's mask of devices already set
// (a runtime call on every launch is host time on the live block's path).
template <typename Kernel>
inline cudaError_t allow_smem_once(Kernel kernel, size_t bytes,
                                   std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
