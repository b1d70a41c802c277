// rff_features: the random-Fourier-feature map of the low-rank tier.
//
// Replaces `rff_features_pallas` / `_rff_kernel`
// (src/repro/kernels/feature_map.py), reached through
// `ops.rff_features` from `approx.RFFMap.transform`:
//   Phi = scale * cos(X Omega + phase)      X (n, d), Omega (d, k)
// with the float32 epilogue fused before the single store of Phi; the
// (n, k) pre-activation X Omega never exists in device memory.
//
// Bound: 2 n k d multiply-adds against reading X and Omega once and
// writing Phi (4 n k bytes). At the main path's 29,491 x 1,024 x 102
// that is 6.16 GFLOP (0.092 ms at the 67 TFLOP/s float32 rate) against
// 121 MB (0.036 ms at 3.35 TB/s): operations bound it, as they do the
// Gram block. Design: the Gram block kernel's tile machinery
// (common.cuh: 64 x 64 output tile per 256-thread block, features
// staged through shared memory in chunks of 32, IEEE float32 FMAs, no
// TF32) with the RBF epilogue swapped for the cosine. Omega is read as
// stored, (d, k) row-major: that is already the feature-major layout of
// the shared B tile, so it needs no transposed copy (`stage_kmajor`).
// The epilogue keeps its add and multiply unfused (__fadd_rn /
// __fmul_rn) as the reference writes them, and uses the accurate cosf:
// the arguments reach tens of radians, where __cosf's error grows.
// bf16 operands are widened to float32 as they enter shared memory
// (exact products, float32 accumulation). Ragged n, k and d are masked
// in the kernel; the reference pads, and its padded columns would hold
// scale * cos(0), which never leave this kernel. Rows of X are grid.x
// (up to 2^31 - 1 tiles), columns grid.y.
#include "common.cuh"

namespace {

using namespace svm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rff_features_kernel(const T* __restrict__ x, const T* __restrict__ omega,
                    const float* __restrict__ phase, float* __restrict__ out,
                    int n, int k, int d, float scale) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.x * TILE, col0 = blockIdx.y * TILE;
  float acc[4][4];
  tile_dot<T, /*B_KMAJOR=*/true>(sm, x, row0, n, omega, col0, k, d,
                                 /*norms=*/false, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= k) continue;
      out[(size_t)r * k + c] =
          __fmul_rn(scale, cosf(__fadd_rn(acc[i][j], phase[c])));
    }
  }
}

}  // namespace

extern "C" {

int svm_rff_features(const void* x, const void* omega, const float* phase,
                     float* out, int n, int k, int d, float scale, int bf16,
                     void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, (k + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rff_features_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(omega), phase, out, n, k, d, scale);
  else
    rff_features_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(omega),
        phase, out, n, k, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
