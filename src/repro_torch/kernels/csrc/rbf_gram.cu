// rbf_gram: the Gram block and the Gram row of the SMO solver.
//
// Replaces `rbf_gram_pallas` / `_rbf_gram_kernel`
// (src/repro/kernels/rbf_gram.py), reached through `ops.rbf_gram` and
// `ops.gram_row_fn`:
//   K = exp(-gamma * max(|a|^2 + |b|^2 - 2 a.b^T, 0))   (mode rbf)
//   K = a.b^T                                            (mode linear)
// with the squared norms computed by the caller in float32 from the
// rounded operands, as rbf_gram.py:112-113 does.
//
// Two entry points, for the two shapes the solver asks for:
//
// * Block mode (n, m), for matvec / cross / block / full. Each output
//   is d multiply-adds against 4 bytes written, so at SVM widths
//   (d <= 102) the write of K bounds it: (n m 4) / 3.35 TB/s. Design: a
//   64 x 64 tile per block from shared-memory staged feature chunks
//   (common.cuh), the epilogue fused before the single store of K.
// * Row mode (n, 1), twice per SMO iteration: K(X, x_i). It is a GEMV,
//   bounded by reading X once: (n d bytes) / 3.35 TB/s. Design: x_i is
//   staged in shared memory, one warp per row reads the row's contiguous
//   features (coalesced) and reduces with shuffles. The row index i, and
//   the LRU-cache slot and hit flag, are read from device memory, so the
//   solver never syncs with the host for them: on a cache hit the
//   kernel exits at once, on a miss it writes straight into the slot.
//   Task axis: a multiclass bucket of T binary tasks stacks X as
//   (T, n, d) with norms (T, n) and one index per task; task t is
//   blockIdx.y and writes row t of a (T, n) output, so one launch
//   serves the whole bucket (the reference vmaps its row call over the
//   bucket). Each task's row is the arithmetic of the T = 1 launch,
//   value for value; T = 1 is that launch.
#include "common.cuh"

namespace {

using namespace svm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rbf_gram_block_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ a2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int n, int m, int d, float gamma, int rbf) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  float acc[4][4];
  tile_dot(sm, a, row0, n, b, col0, m, d, /*norms=*/false, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= m) continue;
      out[(size_t)r * m + c] =
          rbf ? rbf_epilogue(a2[r], b2[c], acc[i][j], gamma) : acc[i][j];
    }
  }
}

constexpr int ROW_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
rbf_gram_row_kernel(const T* __restrict__ x, const float* __restrict__ x2,
                    const int64_t* __restrict__ idx, float* __restrict__ out,
                    const int64_t* __restrict__ slot,
                    const bool* __restrict__ skip, int n, int d, float gamma,
                    int rbf) {
  if (skip != nullptr && *skip) return;  // LRU hit: the row is cached
  extern __shared__ float z[];
  const int64_t task = blockIdx.y;
  x += task * n * (int64_t)d;
  x2 += task * n;
  const int64_t i = idx[task];
  float* o = out + (slot != nullptr ? *slot : task) * (int64_t)n;
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    z[k] = to_f32(x[i * d + k]);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const float zi2 = rbf ? x2[i] : 0.f;
  for (int r = blockIdx.x * warps + warp; r < n; r += gridDim.x * warps) {
    const T* xr = x + (size_t)r * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) acc = fmaf(to_f32(xr[k]), z[k], acc);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) o[r] = rbf ? rbf_epilogue(x2[r], zi2, acc, gamma) : acc;
  }
}

}  // namespace

extern "C" {

int svm_rbf_gram_block(const void* a, const void* b, const float* a2,
                       const float* b2, float* out, int n, int m, int d,
                       float gamma, int rbf, int bf16, void* stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rbf_gram_block_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), a2, b2, out, n, m, d, gamma,
        rbf);
  else
    rbf_gram_block_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), a2, b2,
        out, n, m, d, gamma, rbf);
  return static_cast<int>(cudaGetLastError());
}

// x (n_tasks, n, d), x2 (n_tasks, n), idx (n_tasks,), out (n_tasks, n);
// slot / skip (the LRU row store of one task) only with n_tasks = 1
int svm_rbf_gram_row(const void* x, const float* x2, const int64_t* idx,
                     float* out, const int64_t* slot, const bool* skip,
                     int n_tasks, int n, int d, float gamma, int rbf,
                     int bf16, void* stream) {
  const int warps = ROW_THREADS / 32;
  // about 132 x 16 blocks in all; warps then loop over rows
  int cap = 132 * 16 / n_tasks;
  if (cap < 1) cap = 1;
  int blocks = (n + warps - 1) / warps;
  if (blocks > cap) blocks = cap;
  const dim3 grid(blocks, n_tasks);
  const size_t smem = sizeof(float) * (size_t)d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rbf_gram_row_kernel<<<grid, ROW_THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), x2, idx, out, slot, skip, n, d,
        gamma, rbf);
  else
    rbf_gram_row_kernel<<<grid, ROW_THREADS, smem, s>>>(
        static_cast<const float*>(x), x2, idx, out, slot, skip, n, d, gamma,
        rbf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
