// Tile machinery of the redesigned Gram-shaped kernels (rff_features.cu,
// decision.cu) for Hopper (sm_90a).
//
// common.cuh's tile_dot stages 32 features at a time, element by element,
// between two barriers, and reads one float a thread per operand and
// feature: 8 shared-memory loads for 16 FMAs, which caps it at half the
// card's float32 FMA rate (a warp's load costs a wavefront per float a
// thread, broadcast or not, and an SM serves one wavefront a clock
// against four warp-wide FMAs). Here:
//
// * Operands are staged whole along the feature axis when it is narrow
//   (d rounded up to a multiple of 4, up to RES_WIDTH features), or in
//   chunks past that (the host's plan picks the width), by asynchronous
//   copies (cp.async, 16, 8 or 4 bytes a copy, as the rows' alignment
//   allows) that zero-fill every element past a ragged edge, so a masked
//   row or feature adds 0.
// * Shared tiles keep the global layout, rows of features, so a copy
//   moves contiguous bytes; a thread reads 2 or 4 consecutive features
//   of a row as one float2 or float4. Rows are `ld` floats apart with
//   ld / 4 odd, so 8 threads reading 8 different rows at one feature
//   offset hit 32 different banks.
// * bfloat16 and float16 operands are widened to float32 as they land
//   (ordinary loads, a batch of 8 in flight a thread, of two elements
//   each where the rows allow: a copy cannot convert), so products of
//   bf16 or fp16 values are exact and accumulate in float32. The
//   widening is exact, so a 16-bit operand gives the bits its float32
//   upcast gives.
// * Or a 16-bit operand is staged as it is stored (stage_raw16: copies of
//   8 or 4 bytes, loads where a row's pairs are not 4-byte aligned) at
//   the same row stride in elements, and widened in registers where it
//   is read (ld4w: four features, one 8-byte load). A stride whose
//   quarter is odd keeps 16 rows read at one offset on 32 different
//   banks; the 16-byte copies a copy of 8 features would take need
//   16-byte aligned rows, which put those rows two to a bank.
//
// All products are IEEE float32 fmaf (no TF32: the parity bounds against
// the float32 reference do not allow it).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <atomic>

namespace svm {
namespace f32tile {

constexpr int RES_WIDTH = 128;   // widest feature axis staged whole
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Row stride of a staged tile of `width` features: a multiple of 4 (rows
// stay 16-byte aligned) whose quarter is odd (conflict-free float4 reads
// of 8 rows at one offset).
__host__ __device__ constexpr int row_stride(int width) {
  return (round4(width) / 4) % 2 ? round4(width) : round4(width) + 4;
}

// Widest copy (in floats: 4, 2 or 1) that keeps every row of a
// row-major float32 matrix with rows of `len` elements aligned, from a
// base pointer `p`.
inline int copy_width(const void* p, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % 16 == 0 && len % 4 == 0) return 4;
  if (a % 8 == 0 && len % 2 == 0) return 2;
  return 1;
}

// The same for a 16-bit matrix, in elements: 2 where every row's pairs
// are 4-byte aligned, else 1.
template <typename H>
inline int copy_width16(const H* p, int len) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && len % 2 == 0 ? 2 : 1;
}

// Lets `kern` take all the dynamic shared memory a block may opt in to
// on the current device (the opt-in limit less its static shared
// memory), once per device: `done` is the kernel's own flag a device.
// The limit does not change occupancy, and a one-row serving call then
// pays no attribute call. Returns a cudaError_t.
template <typename Kernel>
inline int allow_max_smem(Kernel kern,
                          std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && done[dev].load()) return 0;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return static_cast<int>(e);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;   // 0 source bytes: zero-fill
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NT, int VEC>
__device__ __forceinline__ void stage_copy(float* s, int ld, const float* g,
                                           int len, int row0, int nrows,
                                           int col0, int rows, int width) {
  const int per = width / VEC;
  for (int e = threadIdx.x; e < rows * per; e += NT) {
    const int r = e / per, c = (e - r * per) * VEC;
    const int gr = row0 + r, gc = col0 + c;
    const bool valid = gr < nrows && gc < len;  // VEC divides len and gc
    cp_async<4 * VEC>(s + r * ld + c,
                      valid ? g + (size_t)gr * len + gc : g, valid);
  }
}

// Stage rows [row0, row0 + rows) x columns [col0, col0 + width) of a
// row-major (nrows, len) matrix into s[r * ld + c]; entries past either
// edge are 0. float32 goes by asynchronous copies of `vec` floats
// (copy_width of the matrix; the caller commits and waits), bfloat16 by
// loads widened to float32. `width` is a multiple of 4; the block has NT
// threads.
template <int NT>
__device__ __forceinline__ void stage(float* s, int ld, const float* g,
                                      int len, int row0, int nrows, int col0,
                                      int rows, int width, int vec) {
  if (vec == 4)
    stage_copy<NT, 4>(s, ld, g, len, row0, nrows, col0, rows, width);
  else if (vec == 2)
    stage_copy<NT, 2>(s, ld, g, len, row0, nrows, col0, rows, width);
  else
    stage_copy<NT, 1>(s, ld, g, len, row0, nrows, col0, rows, width);
}

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 widen2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// Widest copy (in elements: 4, 2 or 1) of a row-major 16-bit matrix with
// rows of `len` elements for stage_raw16: 8 bytes where every row's
// quads are 8-byte aligned, 4 where its pairs are 4-byte aligned, else
// single elements (loads).
template <typename H>
inline int copy_width_raw16(const H* p, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % 8 == 0 && len % 4 == 0) return 4;
  if (a % 4 == 0 && len % 2 == 0) return 2;
  return 1;
}

// A 16-bit operand: loads of VEC elements (1, or 2 when the rows' pairs
// are aligned: copy_width16), BATCH of them issued a thread before any
// is widened and stored, so the loads overlap.
template <int NT, int VEC, typename H>
__device__ __forceinline__ void stage_widen(float* s, int ld, const H* g,
                                            int len, int row0, int nrows,
                                            int col0, int rows, int width) {
  constexpr int BATCH = 8;
  const int per = width / VEC, total = rows * per;
  for (int e0 = threadIdx.x; e0 < total; e0 += NT * BATCH) {
    float2 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * NT;
      const int r = e / per, c = (e - r * per) * VEC;
      const int gr = row0 + r, gc = col0 + c;
      v[u] = make_float2(0.f, 0.f);
      if (e < total && gr < nrows && gc < len) {   // VEC divides len, gc
        const H* p = g + (size_t)gr * len + gc;
        if constexpr (VEC == 2)
          v[u] = widen2(p);
        else
          v[u].x = widen(*p);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * NT;
      if (e >= total) break;
      const int r = e / per, c = (e - r * per) * VEC;
      s[r * ld + c] = v[u].x;
      if constexpr (VEC == 2) s[r * ld + c + 1] = v[u].y;
    }
  }
}

// bfloat16 and float16: loads widened to float32 (`vec` from
// copy_width16, or 1).
template <int NT, typename H>
__device__ __forceinline__ void stage16(float* s, int ld, const H* g,
                                        int len, int row0, int nrows,
                                        int col0, int rows, int width,
                                        int vec) {
  if (vec == 2)
    stage_widen<NT, 2>(s, ld, g, len, row0, nrows, col0, rows, width);
  else
    stage_widen<NT, 1>(s, ld, g, len, row0, nrows, col0, rows, width);
}

template <int NT>
__device__ __forceinline__ void stage(float* s, int ld,
                                      const __nv_bfloat16* g, int len,
                                      int row0, int nrows, int col0, int rows,
                                      int width, int vec) {
  stage16<NT>(s, ld, g, len, row0, nrows, col0, rows, width, vec);
}

template <int NT>
__device__ __forceinline__ void stage(float* s, int ld, const __half* g,
                                      int len, int row0, int nrows, int col0,
                                      int rows, int width, int vec) {
  stage16<NT>(s, ld, g, len, row0, nrows, col0, rows, width, vec);
}

// A 16-bit tile staged as stored: asynchronous copies of VEC elements
// (VEC = 4 or 2: 8 or 4 bytes; the caller commits and waits), entries
// past either edge zero-filled.
template <int NT, int VEC, typename H>
__device__ __forceinline__ void stage_raw16_copy(H* s, int ld, const H* g,
                                                 int len, int row0,
                                                 int nrows, int col0,
                                                 int rows, int width) {
  const int per = width / VEC;
  for (int e = threadIdx.x; e < rows * per; e += NT) {
    const int r = e / per, c = (e - r * per) * VEC;
    const int gr = row0 + r, gc = col0 + c;
    const bool valid = gr < nrows && gc < len;  // VEC divides len and gc
    cp_async<2 * VEC>(s + r * ld + c,
                      valid ? g + (size_t)gr * len + gc : g, valid);
  }
}

// Rows whose pairs are not 4-byte aligned: element loads, BATCH of them
// issued a thread before any is stored.
template <int NT, typename H>
__device__ __forceinline__ void stage_raw16_load(H* s, int ld, const H* g,
                                                 int len, int row0,
                                                 int nrows, int col0,
                                                 int rows, int width) {
  constexpr int BATCH = 8;
  const int total = rows * width;
  for (int e0 = threadIdx.x; e0 < total; e0 += NT * BATCH) {
    H v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * NT;
      const int r = e / width, c = e - r * width;
      const int gr = row0 + r, gc = col0 + c;
      v[u] = H(0.f);
      if (e < total && gr < nrows && gc < len)
        v[u] = g[(size_t)gr * len + gc];
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * NT;
      if (e >= total) break;
      const int r = e / width;
      s[r * ld + e - r * width] = v[u];
    }
  }
}

// Stage rows [row0, row0 + rows) x columns [col0, col0 + width) of a
// row-major (nrows, len) 16-bit matrix into s[r * ld + c] at its own
// dtype; entries past either edge are 0. `vec` from copy_width_raw16;
// `width` a multiple of 4.
template <int NT, typename H>
__device__ __forceinline__ void stage_raw16(H* s, int ld, const H* g,
                                            int len, int row0, int nrows,
                                            int col0, int rows, int width,
                                            int vec) {
  if (vec == 4)
    stage_raw16_copy<NT, 4>(s, ld, g, len, row0, nrows, col0, rows, width);
  else if (vec == 2)
    stage_raw16_copy<NT, 2>(s, ld, g, len, row0, nrows, col0, rows, width);
  else
    stage_raw16_load<NT>(s, ld, g, len, row0, nrows, col0, rows, width);
}

template <int NT>
__device__ __forceinline__ void stage(__nv_bfloat16* s, int ld,
                                      const __nv_bfloat16* g, int len,
                                      int row0, int nrows, int col0, int rows,
                                      int width, int vec) {
  stage_raw16<NT>(s, ld, g, len, row0, nrows, col0, rows, width, vec);
}

template <int NT>
__device__ __forceinline__ void stage(__half* s, int ld, const __half* g,
                                      int len, int row0, int nrows, int col0,
                                      int rows, int width, int vec) {
  stage_raw16<NT>(s, ld, g, len, row0, nrows, col0, rows, width, vec);
}

// Four consecutive features of a staged row as float32: a float4 load,
// or one 8-byte load of four 16-bit values widened in registers (exact:
// a bf16 value is the high half of its float32, an fp16 value converts
// without rounding).
__device__ __forceinline__ float4 ld4w(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4w(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4w(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One staged feature as float32.
__device__ __forceinline__ float ld1w(const float* p) { return *p; }
__device__ __forceinline__ float ld1w(const __nv_bfloat16* p) {
  return widen(*p);
}
__device__ __forceinline__ float ld1w(const __half* p) { return widen(*p); }

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Exact sum of two floats as a (hi, lo) pair (Knuth's TwoSum); every
// step rounded on its own.
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (h, l) += (h2, l2) for values kept as unevaluated sums hi + lo. The
// result does not depend on the order of the two operands, so both
// lanes of a butterfly shuffle hold the same pair.
__device__ __forceinline__ void add_pair(float& h, float& l, float h2,
                                         float l2) {
  float s, e;
  two_sum(h, h2, s, e);
  l = __fadd_rn(__fadd_rn(l, l2), e);
  h = s;
}

}  // namespace f32tile
}  // namespace svm
