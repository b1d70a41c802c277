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
// byte) once, 21 n bytes: 0.18 us at n = 29,491 on the H100's 3.35
// TB/s. What bounded PR 11's kernel on the H100 (4.8-5.0 us device) was
// launches and round trips, not bytes: a partial pass over up to 264
// blocks (most threads with one sample or none) wrote keys to a scratch
// array that a second, one-block launch read back, and the wrapper
// allocated that scratch on every call. Design: one launch a call.
// Blocks of 256 threads (29 a task at n = 29,491), each thread one
// float4 of every input and 4 mask bytes (a scalar head and tail where a
// task's row is not 16-byte aligned); each block reduces its keys by
// warp shuffles and shared memory, writes its two keys to a per-stream
// array and takes a ticket (an acquire-release atomic count); the last
// block of the task reads the keys back, writes the result and sets the
// ticket back to 0 for the next launch on the stream. What is left is
// the launch and three dependent trips to L2 (the inputs, the ticket,
// the keys). A thread-block cluster a task that combines its keys
// through distributed shared memory, with no trip to L2 for them, took
// longer on the H100 at every shape the solver gives it: its launch
// costs more than the trips it saves (PERF.md, PR 16).
//
// Task axis: a multiclass bucket of T binary tasks passes (T, n) inputs;
// task t is the blocks at blockIdx.y and writes vals[t] = b_up,
// vals[T + t] = b_low (idx likewise). Each task's selection is the one
// a T = 1 launch makes (the keys' minimum does not depend on the
// blocks); T = 1 is that launch.
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

// sample i's two keys folded into (k_up, k_low)
__device__ __forceinline__ void take(float fi, float a, float yv, float l,
                                     float h, bool m, int i, uint64_t& k_up,
                                     uint64_t& k_low) {
  const float eps = __fmul_rn(1e-6f, __fsub_rn(h, l));
  const bool not_upper = a < __fsub_rn(h, eps);  // can increase
  const bool not_lower = a > __fadd_rn(l, eps);  // can decrease
  const bool pos = yv > 0.f;
  const bool up = m && ((pos && not_upper) || (!pos && not_lower));
  const bool low = m && ((pos && not_lower) || (!pos && not_upper));
  k_up = umin64(k_up, make_key(up ? fi : inf_f32(), i));
  k_low = umin64(k_low, make_key(low ? -fi : inf_f32(), i));
}

__device__ __forceinline__ void warp_min2(uint64_t& k0, uint64_t& k1) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    k0 = umin64(k0, __shfl_xor_sync(0xffffffffu, k0, s));
    k1 = umin64(k1, __shfl_xor_sync(0xffffffffu, k1, s));
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Thread g of `stride` folds its samples of one task into (k_up, k_low).
__device__ __forceinline__ void scan(const float* __restrict__ f,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ y,
                                     const float* __restrict__ lo,
                                     const float* __restrict__ hi,
                                     const bool* __restrict__ mask, int n,
                                     int g, int stride, uint64_t& k_up,
                                     uint64_t& k_low) {

  // h samples up to f's first 16-byte boundary; float4 groups past it if
  // every float input is at the same offset from a boundary and the
  // mask's 4 bytes of a group are 4-byte aligned
  const int h = static_cast<int>(
      ((16 - reinterpret_cast<uintptr_t>(f) % 16) % 16) / 4);
  const bool vec = h <= n && aligned16(alpha + h) && aligned16(y + h) &&
                   aligned16(lo + h) && aligned16(hi + h) &&
                   reinterpret_cast<uintptr_t>(mask + h) % 4 == 0;
  int body = 0, groups = 0;   // body = h + 4 groups, vectorized
  if (vec) {
    groups = (n - h) / 4;
    body = h + 4 * groups;
    for (int q = g; q < groups; q += stride) {
      const int i = h + 4 * q;
      const float4 fv = *reinterpret_cast<const float4*>(f + i);
      const float4 av = *reinterpret_cast<const float4*>(alpha + i);
      const float4 yv = *reinterpret_cast<const float4*>(y + i);
      const float4 lv = *reinterpret_cast<const float4*>(lo + i);
      const float4 hv = *reinterpret_cast<const float4*>(hi + i);
      const uint32_t mv = *reinterpret_cast<const uint32_t*>(mask + i);
      take(fv.x, av.x, yv.x, lv.x, hv.x, mv & 0xffu, i, k_up, k_low);
      take(fv.y, av.y, yv.y, lv.y, hv.y, (mv >> 8) & 0xffu, i + 1, k_up,
           k_low);
      take(fv.z, av.z, yv.z, lv.z, hv.z, (mv >> 16) & 0xffu, i + 2, k_up,
           k_low);
      take(fv.w, av.w, yv.w, lv.w, hv.w, mv >> 24, i + 3, k_up, k_low);
    }
  }
  // the scalar rest: a head and a tail of at most 3 samples each, or the
  // whole task where the inputs are not aligned alike
  const int head = vec ? h : 0, rest = vec ? head + (n - body) : n;
  for (int q = g; q < rest; q += stride) {
    const int i = q < head ? q : (vec ? body + (q - head) : q);
    take(f[i], alpha[i], y[i], lo[i], hi[i], mask[i], i, k_up, k_low);
  }
}

// block-wide minimum of two keys; valid in warp 0
__device__ __forceinline__ void block_min2(uint64_t& k_up, uint64_t& k_low) {
  constexpr int NW = KKT_THREADS / 32;
  __shared__ uint64_t s_up[NW], s_low[NW];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  warp_min2(k_up, k_low);
  if (lane == 0) { s_up[warp] = k_up; s_low[warp] = k_low; }
  __syncthreads();
  if (warp == 0) {
    k_up = lane < NW ? s_up[lane] : ~0ull;
    k_low = lane < NW ? s_low[lane] : ~0ull;
    warp_min2(k_up, k_low);
  }
}

__device__ __forceinline__ void write_result(uint64_t k_up, uint64_t k_low,
                                             int64_t task, int n_tasks,
                                             float* vals, int64_t* idx) {
  vals[task] = unordered(static_cast<uint32_t>(k_up >> 32));
  // 0 - x, not -x: a zero f keys as +0 and comes back as +0
  vals[n_tasks + task] =
      __fsub_rn(0.f, unordered(static_cast<uint32_t>(k_low >> 32)));
  idx[task] = static_cast<int64_t>(k_up & 0xffffffffu);
  idx[n_tasks + task] = static_cast<int64_t>(k_low & 0xffffffffu);
}

// blockIdx.x of task blockIdx.y writes its two keys to part, and the
// last block of the task to take a ticket reduces them and writes the
// result.
__global__ void __launch_bounds__(KKT_THREADS)
kkt_select_kernel(const float* __restrict__ f, const float* __restrict__ alpha,
                  const float* __restrict__ y, const float* __restrict__ lo,
                  const float* __restrict__ hi, const bool* __restrict__ mask,
                  int n, uint64_t* __restrict__ part, int* __restrict__ ticket,
                  float* __restrict__ vals, int64_t* __restrict__ idx) {
  __shared__ int s_last;
  const int64_t task = blockIdx.y, off = task * n;
  const int nb = gridDim.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint64_t k_up = ~0ull, k_low = ~0ull;
  scan(f + off, alpha + off, y + off, lo + off, hi + off, mask + off, n,
       blockIdx.x * KKT_THREADS + threadIdx.x, nb * KKT_THREADS, k_up,
       k_low);
  block_min2(k_up, k_low);
  uint64_t* up = part + task * 2 * nb;
  if (threadIdx.x == 0) {
    up[blockIdx.x] = k_up;
    up[nb + blockIdx.x] = k_low;
    s_last = svm::take_ticket(ticket + task) == nb - 1u;
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  k_up = k_low = ~0ull;
  for (int b = lane; b < nb; b += 32) {
    k_up = umin64(k_up, __ldcg(up + b));
    k_low = umin64(k_low, __ldcg(up + nb + b));
  }
  warp_min2(k_up, k_low);
  if (lane == 0) {
    write_result(k_up, k_low, task, gridDim.y, vals, idx);
    ticket[task] = 0;
  }
}

}  // namespace

extern "C" {

// inputs (n_tasks, n); `blocks` blocks a task; part: 2 n_tasks blocks
// keys; ticket: n_tasks ints, 0 between launches on the stream;
// vals: (b_up of each task, then b_low of each); idx: (i_up..., i_low...)
int svm_kkt_select(const float* f, const float* alpha, const float* y,
                   const float* lo, const float* hi, const bool* mask,
                   int n_tasks, int n, int blocks, void* part, int* ticket,
                   float* vals, int64_t* idx, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  kkt_select_kernel<<<dim3(blocks, n_tasks), KKT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      f, alpha, y, lo, hi, mask, n, static_cast<uint64_t*>(part), ticket,
      vals, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
