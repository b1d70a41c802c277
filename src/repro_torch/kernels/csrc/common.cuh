// Shared pieces of the port's SVM kernels for Hopper (sm_90a): the
// ticket counter of the kernels whose last block combines and the RBF
// epilogue the Gram kernels share (rbf_gram.cu's block, matvec and row
// entries). The tensor-core and copy helpers live in mma.cuh, and
// rff_features / decision stage their tiles through tile_f32.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace svm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Add one to a ticket counter in device memory and return the count
// before it, with acquire and release at gpu scope: what a block read or
// wrote before its ticket happens before what the block that takes the
// last ticket does after it (rbf_gram.cu's cached row entry,
// kkt_select.cu's ticket route). No __threadfence around it.
__device__ __forceinline__ unsigned take_ticket(int* t) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

// exp(-gamma * max(a2 + b2 - 2 dot, 0)), rounded step by step as the
// reference writes it (the _rn intrinsics keep nvcc from contracting
// the epilogue into FMAs the reference does not do).
__device__ __forceinline__ float rbf_epilogue(float a2, float b2, float dot,
                                              float gamma) {
  const float d2 = __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.f, dot));
  return expf(__fmul_rn(-gamma, fmaxf(d2, 0.f)));
}

}  // namespace svm
