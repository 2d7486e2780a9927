// Asynchronous global -> shared copies (cp.async), the only inline PTX of the
// grid kernels.  Kept apart so that a host rehearsal of the kernels can swap
// in plain copies.
#pragma once

#include <cuda_runtime.h>

// Copy one float from global to shared memory without passing through
// registers; `valid` false fills the destination with 0 and reads nothing
// (src-size 0), which gives the grid's edge and absent slots for free.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Copy 16 bytes (4 floats, both addresses 16-byte aligned) from global to
// shared memory, past L1; `valid` false fills 0 and reads nothing.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Close the group of the copies this thread issued since the last commit (a
// group may be empty).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's committed groups are still
// in flight (a __syncthreads() after it makes every thread's landed copies
// visible to the block).  Above 7 it waits for 7, which is never fewer.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    case 4: cp_async_wait_group<4>(); break;
    case 5: cp_async_wait_group<5>(); break;
    case 6: cp_async_wait_group<6>(); break;
    default: cp_async_wait_group<7>(); break;
  }
}
