// Shared pieces of the port's SVM kernels for Hopper (sm_90a): the
// ticket counter of the kernels whose last block combines, the RBF
// epilogue the Gram kernels share (rbf_gram.cu's block, matvec and row
// entries), and the tiles of the LM-substrate kernels. The Gram block
// route's tensor-core tiles live in rbf_gram.cu, and rff_features /
// decision stage theirs through tile_f32.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace svm {

constexpr int TILE = 64;     // rows of A and of B per LM tile
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

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


// ---- tiles of the LM-substrate kernels (flash_attn.cu, ssd_diag.cu) ----
// Both contract a 64-row tile of A against a 64-row tile of B over a
// feature width of up to 128 (scores), then a 64 x 64 weight tile
// against 64 rows of a value matrix (outputs). 256 threads as above:
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4)
// and columns tx + 16 j; the 16 threads of one row group are 16
// neighbouring lanes of one warp, so a row reduction is 4 shuffles.
constexpr int LM_MAX_D = 128;   // feature / value width a tile takes
constexpr int LM_LD = TILE + 1; // row length of a transposed tile

// Rows [row0, row0 + TILE) x columns [0, d) of a matrix whose rows are
// `ld` elements apart, transposed into s[c * LM_LD + r]; rows at or past
// `nrows` are zero. Neighbouring threads read neighbouring columns.
template <typename T>
__device__ __forceinline__ void stage_rows_t(float* s, const T* src,
                                             int64_t ld, int row0, int nrows,
                                             int d) {
  for (int e = threadIdx.x; e < TILE * d; e += THREADS) {
    const int r = e / d, c = e % d;
    const int gr = row0 + r;
    s[c * LM_LD + r] = gr < nrows ? to_f32(src[gr * ld + c]) : 0.f;
  }
}

// The same rows kept row-major: s[r * d + c].
template <typename T>
__device__ __forceinline__ void stage_rows(float* s, const T* src, int64_t ld,
                                           int row0, int nrows, int d) {
  for (int e = threadIdx.x; e < TILE * d; e += THREADS) {
    const int r = e / d, c = e % d;
    const int gr = row0 + r;
    s[e] = gr < nrows ? to_f32(src[gr * ld + c]) : 0.f;
  }
}

// acc[i][j] = sum_c at[c][ty + 16 i] * bt[c][tx + 16 j] over c < d, in
// order, from two transposed tiles (stage_rows_t).
__device__ __forceinline__ void tile_scores(const float* at, const float* bt,
                                            int d, float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = at[c * LM_LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bt[c * LM_LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k w[ty + 16 i][k] * v[k][tx + 16 j] over k < TILE, in
// order: w is a TILE x LM_LD weight tile, v a row-major TILE x dv tile
// (stage_rows); columns at or past dv are left alone.
template <int NJ>
__device__ __forceinline__ void tile_weighted_sum(const float* w,
                                                  const float* v, int dv,
                                                  float acc[4][NJ]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(ty + 16 * i) * LM_LD + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) {
        const float vv = v[k * dv + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], vv, acc[i][j]);
      }
    }
  }
}

// Sum (or max) over the 16 threads that share a row group.
__device__ __forceinline__ float row_group_sum(float v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}
__device__ __forceinline__ float row_group_max(float v) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

}  // namespace svm
