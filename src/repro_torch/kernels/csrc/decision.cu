// decision / multitask_decision: the fused serving contraction.
//
// Replaces `decision_pallas` / `_decision_kernel` and
// `multitask_decision_pallas` / `_multitask_kernel`
// (src/repro/kernels/decision.py), reached through `ops.decision` and
// `ops.multitask_decision`:
//   f_t(z) = sum_i coef[t, i] * K(sv[t, i], z)        (bias added outside)
// with K the RBF (or, multitask only, the linear) kernel. The (nt, w)
// kernel block is never written to memory.
//
// Bound: per task, 3 nt w d operations (d multiply-adds and the
// epilogue) against reading z, the bank and coef once; at SVM widths
// the float32 FMA rate sets it (2 nt w d / 67 TFLOP/s) once nt and w
// reach a few hundred. Design: a block holds a 64-row tile of test rows
// and loops over 64-row tiles of support vectors (common.cuh), fuses
// the RBF epilogue and the contraction with coef in registers, and
// keeps in each thread a compensated (Kahan) float32 sum of its
// partials across SV tiles, in a fixed order; the 16 threads that share
// a test row add their sums with shuffles once, at the end. A task's
// terms cancel (coef = alpha y of both signs, often one class's rows
// first), so a running total reduced tile by tile rounds at the size of
// the sum of their magnitudes, hundreds of times the decision; per
// thread and compensated, it rounds at the size of one tile's partial.
// Ragged nt, w and d are masked, not padded. One device function
// serves both entry points, so a T = 1 multitask call is the
// single-task kernel bit for bit; the task axis is grid.y.
#include "common.cuh"

namespace {

using namespace svm;

template <typename T>
__device__ __forceinline__ void decide_tile(const T* __restrict__ z, int nt,
                                            const T* __restrict__ sv,
                                            const float* __restrict__ coef,
                                            int w, int d, float gamma, int rbf,
                                            float* __restrict__ out) {
  __shared__ TileSmem sm;
  const int t0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float total[4] = {0.f, 0.f, 0.f, 0.f};
  float comp[4] = {0.f, 0.f, 0.f, 0.f};  // the rounding total[] lost
  for (int s0 = 0; s0 < w; s0 += TILE) {
    float dot[4][4];
    tile_dot(sm, z, t0, nt, sv, s0, w, d, /*norms=*/rbf != 0, dot);
    float cf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s0 + tx + 16 * j;
      cf[j] = c < w ? coef[c] : 0.f;  // SV rows past the edge add 0
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float k =
            rbf ? rbf_epilogue(sm.norm[ty + 16 * i],
                               sm.norm[TILE + tx + 16 * j], dot[i][j], gamma)
                : dot[i][j];
        part = fmaf(k, cf[j], part);
      }
      const float y = __fsub_rn(part, comp[i]);
      const float sum = __fadd_rn(total[i], y);
      comp[i] = __fsub_rn(__fsub_rn(sum, total[i]), y);
      total[i] = sum;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = __fsub_rn(total[i], comp[i]);
    // the 16 threads of one test row are 16 consecutive lanes
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    const int r = t0 + ty + 16 * i;
    if (tx == 0 && r < nt) out[r] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decision_kernel(const T* z, int nt, const T* sv, const float* coef, int w,
                int d, float gamma, float* out) {
  decide_tile(z, nt, sv, coef, w, d, gamma, /*rbf=*/1, out);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
multitask_decision_kernel(const T* z, int nt, const T* sv, const float* coef,
                          int w, int d, float gamma, int rbf, float* out) {
  const size_t t = blockIdx.y;
  decide_tile(z, nt, sv + t * w * d, coef + t * w, w, d, gamma, rbf,
              out + t * nt);
}

}  // namespace

extern "C" {

int svm_decision(const void* z, const void* sv, const float* coef,
                 float* out, int nt, int w, int d, float gamma, int bf16,
                 void* stream) {
  const dim3 grid((nt + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    decision_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), nt,
        static_cast<const __nv_bfloat16*>(sv), coef, w, d, gamma, out);
  else
    decision_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(z), nt,
                                             static_cast<const float*>(sv),
                                             coef, w, d, gamma, out);
  return static_cast<int>(cudaGetLastError());
}

int svm_multitask_decision(const void* z, const void* sv, const float* coef,
                           float* out, int nt, int ntasks, int w, int d,
                           float gamma, int rbf, int bf16, void* stream) {
  const dim3 grid((nt + TILE - 1) / TILE, ntasks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    multitask_decision_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), nt,
        static_cast<const __nv_bfloat16*>(sv), coef, w, d, gamma, rbf, out);
  else
    multitask_decision_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(z), nt, static_cast<const float*>(sv), coef,
        w, d, gamma, rbf, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
