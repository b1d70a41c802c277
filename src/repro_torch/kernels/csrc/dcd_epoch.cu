// dcd_epoch: one epoch of the low-rank tier's dual coordinate descent.
//
// No Pallas counterpart. The reference runs the epoch as an XLA device
// loop (`lax.fori_loop` over `coord` in `dcd_qp`,
// src/repro/core/linear.py:121-151); in eager PyTorch the same loop
// would issue about eight launches per coordinate, so the whole epoch is
// this one launch, reached through `ops.dcd_epoch`. For t = 0 .. n-1,
// with i = perm[t]:
//   g    = y_i (phi_i . w + bias wb) + p_i
//   pg   = g projected at an active bound of [lo_i, hi_i]
//   viol = max(viol, |pg|)                       over live coordinates
//   d    = clip(beta_i - g / q_i, lo_i, hi_i) - beta_i   (0 if not live)
//   beta_i += d;  w += d y_i phi_i;  wb += d y_i bias
// Coordinates are strictly sequential: each step's dot product reads the
// w the previous step wrote.
//
// Bound: one read of Phi (4 n k bytes, 121 MB at 29,491 x 1,024, 0.036
// ms at 3.35 TB/s) sets the byte bound, but the dependency chain sets
// the real floor: n steps of (block-wide reduction + one barrier +
// scalar Newton step). Design: ONE thread block of 256 threads on one
// SM. w lives in shared memory, and thread t owns the slots j = t + 256 r
// (it alone reads and writes them, so w needs no barrier). For k <= 1024
// (the tier's ranks) the row phi_i is held in registers, four per
// thread, and the next coordinate's row and scalars are loaded while the
// current one reduces (perm is on the device, so the next index is known
// a step ahead); larger k reads the row from memory (L1/L2) each time.
// One register width suffices: the step is bound by the latency of the
// next row's load, not by where the current row sits. The dot product
// is a per-thread partial, a warp shuffle tree, and the eight warp
// partials summed in one fixed order by every thread, through a
// double-buffered shared slot, so each coordinate costs one
// __syncthreads; every thread then takes the same Newton step
// redundantly (no second barrier for a broadcast). The scalar step
// rounds each operation (__f*_rn) as the plain version does; the dot
// product is reduced in another order than the reference's, so results
// match at a tolerance. k is limited by the 227 KB of shared memory a
// block may opt in to: svm_dcd_epoch refuses larger k.
#include "common.cuh"

namespace {

constexpr int DCD_THREADS = 256;
constexpr int DCD_WARPS = DCD_THREADS / 32;

struct Coord {
  float y, p, lo, hi, q, beta;
  bool live;
};

__device__ __forceinline__ Coord load_coord(
    int64_t i, const float* __restrict__ y, const float* __restrict__ p,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ qd, const bool* __restrict__ live,
    const float* beta) {
  return Coord{y[i], p[i], lo[i], hi[i], qd[i], beta[i], live[i]};
}

// R > 0: phi_i held in R registers per thread (k <= R * DCD_THREADS);
// R == 0: phi_i read from memory at each use.
template <int R>
__global__ void __launch_bounds__(DCD_THREADS)
dcd_epoch_kernel(const float* __restrict__ phi, const float* __restrict__ y,
                 const float* __restrict__ p, const float* __restrict__ lo,
                 const float* __restrict__ hi, const float* __restrict__ qd,
                 const bool* __restrict__ live,
                 const int64_t* __restrict__ perm, float* beta,
                 float* __restrict__ w_io, float* __restrict__ wb_io,
                 float* __restrict__ viol_out, int n, int k, float bias) {
  extern __shared__ float w[];
  __shared__ float part[2][DCD_WARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int j = tid; j < k; j += DCD_THREADS) w[j] = w_io[j];
  float wb = *wb_io, viol = 0.f;

  float cur[R > 0 ? R : 1], nxt[R > 0 ? R : 1];
  int64_t i = n > 0 ? perm[0] : 0;
  Coord c{};
  if (n > 0) {
    c = load_coord(i, y, p, lo, hi, qd, live, beta);
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = tid + r * DCD_THREADS;
        cur[r] = j < k ? phi[i * k + j] : 0.f;
      }
    }
  }
  for (int t = 0; t < n; ++t) {
    // the next coordinate's index, scalars and row, loaded a step ahead
    const bool more = t + 1 < n;
    const int64_t inext = more ? perm[t + 1] : i;
    Coord cn = c;
    if (more) {
      cn = load_coord(inext, y, p, lo, hi, qd, live, beta);
      if constexpr (R > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = tid + r * DCD_THREADS;
          nxt[r] = j < k ? phi[inext * k + j] : 0.f;
        }
      }
    }
    const float* row = phi + i * k;

    float acc = 0.f;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = tid + r * DCD_THREADS;
        if (j < k) acc = fmaf(cur[r], w[j], acc);
      }
    } else {
      for (int j = tid; j < k; j += DCD_THREADS) acc = fmaf(row[j], w[j], acc);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    float* buf = part[t & 1];
    if (lane == 0) buf[warp] = acc;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < DCD_WARPS; ++q) dot = __fadd_rn(dot, buf[q]);

    const float g = __fadd_rn(
        __fmul_rn(c.y, __fadd_rn(dot, __fmul_rn(bias, wb))), c.p);
    const bool at_lo = c.beta <= c.lo, at_hi = c.beta >= c.hi;
    const float pg = at_lo ? fminf(g, 0.f) : (at_hi ? fmaxf(g, 0.f) : g);
    if (c.live) viol = fmaxf(viol, fabsf(pg));
    const float b_new =
        fminf(fmaxf(__fsub_rn(c.beta, __fdiv_rn(g, c.q)), c.lo), c.hi);
    const float d = c.live ? __fsub_rn(b_new, c.beta) : 0.f;
    if (d != 0.f) {  // uniform: every thread computed the same d
      const float dy = __fmul_rn(d, c.y);
      if constexpr (R > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = tid + r * DCD_THREADS;
          if (j < k) w[j] = __fadd_rn(w[j], __fmul_rn(dy, cur[r]));
        }
      } else {
        for (int j = tid; j < k; j += DCD_THREADS)
          w[j] = __fadd_rn(w[j], __fmul_rn(dy, row[j]));
      }
      wb = __fadd_rn(wb, __fmul_rn(dy, bias));
      const float b_out = __fadd_rn(c.beta, d);
      if (tid == 0) beta[i] = b_out;
      if (inext == i) cn.beta = b_out;  // a repeated index sees its update
    }
    i = inext;
    c = cn;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) cur[r] = nxt[r];
    }
  }
  for (int j = tid; j < k; j += DCD_THREADS) w_io[j] = w[j];
  if (tid == 0) {
    *wb_io = wb;
    *viol_out = viol;
  }
}

// the largest k whose w fits the shared memory a block may opt in to on
// sm_90 (232,448 bytes), beside the static partial-sum slots; the
// Python wrapper checks the same number (ops.DCD_MAX_RANK)
constexpr int MAX_RANK =
    (232448 - 2 * DCD_WARPS * static_cast<int>(sizeof(float))) /
    static_cast<int>(sizeof(float));

template <int R>
int launch(const float* phi, const float* y, const float* p, const float* lo,
           const float* hi, const float* qd, const bool* live,
           const int64_t* perm, float* beta, float* w, float* wb, float* viol,
           int n, int k, float bias, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)k;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dcd_epoch_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dcd_epoch_kernel<R><<<1, DCD_THREADS, smem, s>>>(
      phi, y, p, lo, hi, qd, live, perm, beta, w, wb, viol, n, k, bias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int svm_dcd_epoch(const float* phi, const float* y, const float* p,
                  const float* lo, const float* hi, const float* qd,
                  const bool* live, const int64_t* perm, float* beta,
                  float* w, float* wb, float* viol, int n, int k, float bias,
                  void* stream) {
  if (k < 1 || k > MAX_RANK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 4 * DCD_THREADS)
    return launch<4>(phi, y, p, lo, hi, qd, live, perm, beta, w, wb, viol, n,
                     k, bias, s);
  return launch<0>(phi, y, p, lo, hi, qd, live, perm, beta, w, wb, viol, n,
                   k, bias, s);
}

}  // extern "C"
