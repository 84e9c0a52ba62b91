// Asynchronous global-to-shared copies (cp.async, sm_80 and up), shared by
// the kernels that stage their operands in shared memory this way:
// dma_blend.cu, the few-row form of row 8 in fused_step_onehot.cu, and
// launch A's tiled-product form and launch B's split form in
// fused_forward.cuh.
//
// A thread's copies join a group at cp_async_commit(); cp_async_wait<N>()
// returns once at most N of the thread's groups are still in flight.  Each
// thread waits only for its own copies: a __syncthreads() after the wait
// makes every thread's copies of the group visible to the CTA.

#pragma once

namespace {

// 16 bytes; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 4 bytes; both addresses 4-byte aligned (through L1: .cg takes 16 only).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// cp_async_wait with a count known only at run time, 0..3.
__device__ __forceinline__ void cp_async_wait_n(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

}  // namespace
