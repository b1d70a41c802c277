// Shared pieces of the port's SVM kernels for Hopper (sm_90a).
//
// The rbf_gram block kernel contracts a tile of A rows against a tile
// of B rows over the feature axis (rff_features and decision, which did
// too, now use tile_f32.cuh). SVM features are narrow (d = 4..102), so
// the product is short and the tile machinery stays plain: a 64 x 64 output
// tile per 256-thread block, features staged through shared memory in
// chunks of 32, 4 x 4 outputs per thread, IEEE float32 FMAs (no TF32:
// the parity bounds against the float32 reference do not allow it).
// bf16 operands are widened to float32 as they enter shared memory, so
// products of bf16 values are exact and accumulate in float32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace svm {

constexpr int TILE = 64;     // rows of A and of B per block tile
constexpr int DK = 32;       // feature chunk staged in shared memory
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct TileSmem {
  float a[DK][TILE + 1];  // k-major; +1 keeps the transposing stores
  float b[DK][TILE + 1];  // free of bank conflicts
  float norm[2 * TILE];   // [0, TILE): A row norms, [TILE, 2 TILE): B
};

// Stage rows [row0, row0 + TILE) x features [k0, k0 + DK) of a
// row-major (nrows, d) matrix into s[k][r]; the ragged edges of both
// axes are filled with zeros (zero features add nothing to a dot or a
// norm, and rows past the edge are never stored).
template <typename T>
__device__ __forceinline__ void stage(float (*s)[TILE + 1], const T* src,
                                      int row0, int nrows, int k0, int d) {
  for (int e = threadIdx.x; e < TILE * DK; e += THREADS) {
    const int r = e / DK, c = e % DK;
    const int gr = row0 + r, gc = k0 + c;
    float v = 0.f;
    if (gr < nrows && gc < d) v = to_f32(src[(size_t)gr * d + gc]);
    s[c][r] = v;
  }
}

// acc[i][j] = <A[a0 + ty + 16 i], B[b0 + tx + 16 j]> over all d features,
// summed in feature order, A (na, d) and B (nb, d) row-major. With `norms`,
// sm.norm also receives the squared norms of the staged A and B rows
// (f32 of the rounded operands, as the reference computes them). Ends
// with a barrier, so the caller may read sm.norm right away; starts
// with one, so the caller may still be reading sm.norm of the previous
// tile.
template <typename T>
__device__ __forceinline__ void tile_dot(TileSmem& sm, const T* A, int a0,
                                         int na, const T* B, int b0, int nb,
                                         int d, bool norms,
                                         float acc[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float sq = 0.f;
  for (int k0 = 0; k0 < d; k0 += DK) {
    __syncthreads();
    stage(sm.a, A, a0, na, k0, d);
    stage(sm.b, B, b0, nb, k0, d);
    __syncthreads();
    if (norms && tid < 2 * TILE) {
      float(*s)[TILE + 1] = tid < TILE ? sm.a : sm.b;
      const int r = tid % TILE;
#pragma unroll 8
      for (int k = 0; k < DK; ++k) sq = fmaf(s[k][r], s[k][r], sq);
    }
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();
  if (norms && tid < 2 * TILE) sm.norm[tid] = sq;
  __syncthreads();
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
