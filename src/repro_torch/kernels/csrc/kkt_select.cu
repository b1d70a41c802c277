// kkt_select: the SMO working-set selection.
//
// Replaces `kkt_select_pallas` / `_kkt_kernel`
// (src/repro/kernels/kkt_select.py), finished there by
// `ops._kkt_select_padded`: the masked
//   (b_up, i_up)   = min / argmin of f over I_up
//   (b_low, i_low) = max / argmax of f over I_low
// with +inf / -inf standing in for samples outside each set. This port
// takes the solver's per-sample box [lo, hi] with membership epsilon
// 1e-6 (hi - lo) (repro/core/smo.py:130-153); with lo = 0, hi = C it is
// the Pallas kernel's fixed box and its eps = 1e-6 C, bit for bit.
//
// Ties go to the lowest index, as jnp.argmin / argmax break them: the
// SMO trajectory depends on it. Each sample becomes a 64-bit key
//   (order-preserving bits of the value) << 32 | index
// so one unsigned minimum is value-then-lowest-index, in any order of
// evaluation (the max side keys on -f). An all-masked input therefore
// gives (+inf, 0, -inf, 0), like argmin over all-inf.
//
// Bound: reading f, alpha, y, lo, hi (4 bytes each) and the mask (1
// byte) once, 21 n bytes / 3.35 TB/s; at n ~ 3e4 that is well under a
// microsecond, so launch latency dominates. Design: pass 1 has each
// block reduce a grid-strided slice to two keys (warp shuffles, then
// shared memory); pass 2, one block, reduces the per-block keys and
// writes (b_up, b_low) and (i_up, i_low) to device memory — the solver
// never reads them on the host.
//
// Task axis: a multiclass bucket of T binary tasks passes (T, n) inputs;
// task t is blockIdx.y of pass 1 and blockIdx.x of pass 2, its keys live
// in its own slice of the scratch, and it writes vals[t] = b_up,
// vals[T + t] = b_low (idx likewise). Each task's selection is the one
// a T = 1 launch makes; T = 1 is that launch.
#include "common.cuh"

namespace {

constexpr int KKT_THREADS = 256;

__device__ __forceinline__ float inf_f32() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t ordered(float v) {
  if (v == 0.f) v = 0.f;  // -0 and +0 compare equal: one key for both
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint64_t make_key(float v, int i) {
  return (static_cast<uint64_t>(ordered(v)) << 32) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

// block-wide min of two keys; the result is valid in thread 0
__device__ __forceinline__ void block_min2(uint64_t& k0, uint64_t& k1) {
  __shared__ uint64_t s0[KKT_THREADS / 32], s1[KKT_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    k0 = umin64(k0, __shfl_xor_sync(0xffffffffu, k0, s));
    k1 = umin64(k1, __shfl_xor_sync(0xffffffffu, k1, s));
  }
  if (lane == 0) { s0[warp] = k0; s1[warp] = k1; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < KKT_THREADS / 32; ++w) {
      k0 = umin64(k0, s0[w]);
      k1 = umin64(k1, s1[w]);
    }
  }
}

__global__ void __launch_bounds__(KKT_THREADS)
kkt_partial_kernel(const float* __restrict__ f, const float* __restrict__ alpha,
                   const float* __restrict__ y, const float* __restrict__ lo,
                   const float* __restrict__ hi, const bool* __restrict__ mask,
                   int n, uint64_t* __restrict__ part) {
  const int64_t task = blockIdx.y, off = task * n;
  f += off; alpha += off; y += off; lo += off; hi += off; mask += off;
  uint64_t k_up = ~0ull, k_low = ~0ull;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float a = alpha[i], l = lo[i], h = hi[i];
    const float eps = __fmul_rn(1e-6f, __fsub_rn(h, l));
    const bool not_upper = a < __fsub_rn(h, eps);  // can increase
    const bool not_lower = a > __fadd_rn(l, eps);  // can decrease
    const bool pos = y[i] > 0.f;
    const bool m = mask[i];
    const bool up = m && ((pos && not_upper) || (!pos && not_lower));
    const bool low = m && ((pos && not_lower) || (!pos && not_upper));
    const float fi = f[i];
    k_up = umin64(k_up, make_key(up ? fi : inf_f32(), i));
    k_low = umin64(k_low, make_key(low ? -fi : inf_f32(), i));
  }
  block_min2(k_up, k_low);
  if (threadIdx.x == 0) {  // up keys of every task, then the low keys
    const int64_t b = task * gridDim.x + blockIdx.x;
    part[b] = k_up;
    part[(int64_t)gridDim.x * gridDim.y + b] = k_low;
  }
}

__global__ void __launch_bounds__(KKT_THREADS)
kkt_finish_kernel(const uint64_t* __restrict__ part, int nblocks,
                  float* __restrict__ vals, int64_t* __restrict__ idx) {
  const int task = blockIdx.x, n_tasks = gridDim.x;
  const uint64_t* up = part + (int64_t)task * nblocks;
  const uint64_t* low = up + (int64_t)n_tasks * nblocks;
  uint64_t k_up = ~0ull, k_low = ~0ull;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    k_up = umin64(k_up, up[b]);
    k_low = umin64(k_low, low[b]);
  }
  block_min2(k_up, k_low);
  if (threadIdx.x == 0) {
    vals[task] = unordered(static_cast<uint32_t>(k_up >> 32));
    // 0 - x, not -x: a zero f keys as +0 and comes back as +0
    vals[n_tasks + task] =
        __fsub_rn(0.f, unordered(static_cast<uint32_t>(k_low >> 32)));
    idx[task] = static_cast<int64_t>(k_up & 0xffffffffu);
    idx[n_tasks + task] = static_cast<int64_t>(k_low & 0xffffffffu);
  }
}

}  // namespace

extern "C" {

// inputs (n_tasks, n); part: 2 * n_tasks * nblocks uint64 scratch;
// vals: (b_up of each task, then b_low of each); idx: (i_up..., i_low...)
int svm_kkt_select(const float* f, const float* alpha, const float* y,
                   const float* lo, const float* hi, const bool* mask,
                   int n_tasks, int n, uint64_t* part, int nblocks,
                   float* vals, int64_t* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kkt_partial_kernel<<<dim3(nblocks, n_tasks), KKT_THREADS, 0, s>>>(
      f, alpha, y, lo, hi, mask, n, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kkt_finish_kernel<<<n_tasks, KKT_THREADS, 0, s>>>(part, nblocks, vals,
                                                    idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
