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

// Wait until every copy this thread issued has landed in shared memory (a
// __syncthreads() after it makes every thread's copies visible to the block).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

