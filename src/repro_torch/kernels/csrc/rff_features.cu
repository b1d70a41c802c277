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
// writing Phi (4 n k bytes). At the low-rank fit's 29,491 x 1,024 x 102
// that is 6.16 GFLOP (0.092 ms at the 67 TFLOP/s float32 rate) against
// 121 MB (0.036 ms at 3.35 TB/s): the FMA rate bounds it.
//
// Design (tile_f32.cuh). The first version rode a 64 x 64 FMA tile, 4 x 4
// outputs a thread, features in chunks of 32 (d = 102 cost 128 FMAs an
// output) staged element by element between two barriers each; 0.377 ms at the fit's shape on the H100, 24 % of
// the bound. Now:
// * a block computes a BM x 128 tile of Phi (BM = 128, or 64 where the
//   128-row grid would not give every SM a block: `rff_plan` in
//   kernels/feature_map.py) with 256 threads of 8 (or 4) rows x 8
//   columns, two blocks an SM;
// * X's rows and Omega's rows (stored (d, k): already the layout the B
//   tile wants) are staged once, whole along d rounded up to 4 (106 KB
//   at d = 102), by 16/8/4-byte cp.async copies that zero-fill ragged
//   edges; then one barrier and the whole contraction. Past RES_WIDTH
//   features the same loop runs over 64-feature chunks through a
//   two-stage ring, the next chunk's copies in flight while the current
//   one is contracted;
// * each step of 2 features reads per thread one float2 of X per row —
//   the 16 threads of a row group read the same address — and 4 float4
//   of Omega. What bounds it now is shared memory: every load a thread
//   issues costs the warp a wavefront per float, 16 for 64 FMAs, and
//   that alone matches the SMs' FMA rate. Steps of 4 features spill at
//   the 128 registers two blocks an SM allow; 128-thread blocks of 16 x
//   8 outputs load less per FMA but leave 8 warps an SM to hide latency
//   and ran 1.7x slower (PERF.md, PR 14);
// * the epilogue is unchanged: __fmul_rn(scale, cosf(__fadd_rn(acc,
//   phase))), unfused as the reference writes it, with the accurate cosf
//   (the arguments reach tens of radians, where __cosf's error grows) —
//   about a quarter of the kernel's time at the fit's shape — and rows
//   are stored as float4 where k allows.
// bf16 operands are widened to float32 as they land (exact products,
// float32 accumulation). Rows of X are grid.x, columns grid.y.
#include "tile_f32.cuh"

namespace {

using namespace svm::f32tile;

constexpr int NT = 256;   // threads a block: 16 (ty) x 16 (tx)
constexpr int BN = 128;   // columns of Phi a block computes

// floats of one ring stage: a BM x chunk tile of X, a chunk x BN one of
// Omega (the host sizes the dynamic shared memory with it)
__host__ __device__ constexpr int stage_floats(int bm, int chunk) {
  return bm * row_stride(chunk) + chunk * BN;
}

template <typename T, int RG>   // RG groups of 64 rows: BM = 64 RG
__global__ void __launch_bounds__(NT, 2)
rff_features_kernel(const T* __restrict__ x, const T* __restrict__ omega,
                    const float* __restrict__ phase, float* __restrict__ out,
                    int n, int k, int d, float scale, int chunk, int vx,
                    int vo, int vout) {
  constexpr int BM = 64 * RG, RM = 4 * RG;
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int dpad = round4(d), nch = (dpad + chunk - 1) / chunk;
  const int lda = row_stride(chunk), sf = stage_floats(BM, chunk);

  auto load = [&](int ch) {
    float* a = smem + (ch & 1) * sf;
    const int k0 = ch * chunk, cw = min(chunk, dpad - k0);
    stage<NT>(a, lda, x, d, row0, n, k0, BM, cw, vx);
    stage<NT>(a + BM * lda, BN, omega, k, k0, d, col0, cw, BN, vo);
    cp_async_commit();
  };

  // thread (ty, tx) owns rows g 64 + ty 4 + ii and columns h 64 + tx 4 + jj
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a = smem + (ch & 1) * sf;
    const float* b = a + BM * lda;
    const int cw = min(chunk, dpad - ch * chunk);
#pragma unroll 1
    for (int kk = 0; kk < cw; kk += 2) {
      float4 bv[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bv[q][h] = ld4(b + (kk + q) * BN + h * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float2 av = ld2(a + ((i / 4) * 64 + ty * 4 + i % 4) * lda + kk);
        const float as[2] = {av.x, av.y};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[i][4 * h + 0] = fmaf(as[q], bv[q][h].x, acc[i][4 * h + 0]);
            acc[i][4 * h + 1] = fmaf(as[q], bv[q][h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(as[q], bv[q][h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(as[q], bv[q][h].w, acc[i][4 * h + 3]);
          }
      }
    }
    __syncthreads();   // the stage is refilled two chunks on
  }

  float ph[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + (j / 4) * 64 + tx * 4 + j % 4;
    ph[j] = c < k ? phase[c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = __fmul_rn(scale,
                          cosf(__fadd_rn(acc[i][4 * h + jj], ph[4 * h + jj])));
      float* o = out + (size_t)r * k + c;
      if (vout && c + 3 < k) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (c + jj < k) o[jj] = v[jj];
      }
    }
  }
}

template <typename T, int RG>
int launch(const T* x, const T* omega, const float* phase, float* out, int n,
           int k, int d, float scale, int chunk, int smem_bytes, int vx,
           int vo, cudaStream_t s) {
  const int nch = (round4(d) + chunk - 1) / chunk;
  const int smem = (nch > 1 ? 2 : 1) * stage_floats(64 * RG, chunk) * 4;
  if (smem != smem_bytes)   // the host's plan sizes the tile otherwise
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rff_features_kernel<T, RG>;
  static std::atomic<bool> allowed[MAX_DEVICES];
  if (const int e = allow_max_smem(kern, allowed)) return e;
  const int vout = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((n + 64 * RG - 1) / (64 * RG), (k + BN - 1) / BN);
  kern<<<grid, NT, smem, s>>>(x, omega, phase, out, n, k, d, scale,
                                   chunk, vx, vo, vout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* x, const T* omega, const float* phase, float* out,
             int n, int k, int d, float scale, int rows, int chunk,
             int smem_bytes, int vx, int vo, cudaStream_t s) {
  if (chunk < 4 || chunk % 4 || chunk > RES_WIDTH || (k + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 128)
    return launch<T, 2>(x, omega, phase, out, n, k, d, scale, chunk,
                        smem_bytes, vx, vo, s);
  if (rows == 64)
    return launch<T, 1>(x, omega, phase, out, n, k, d, scale, chunk,
                        smem_bytes, vx, vo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// rows (64 or 128), chunk (features a stage holds, a multiple of 4 up
// to RES_WIDTH) and smem_bytes (the block's dynamic shared memory, which
// must equal this side's count) come from kernels/feature_map.py's
// rff_plan.
int svm_rff_features(const void* x, const void* omega, const float* phase,
                     float* out, int n, int k, int d, float scale, int bf16,
                     int rows, int chunk, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(omega), phase, out, n,
                    k, d, scale, rows, chunk, smem_bytes, 1, 1, s);
  return dispatch(static_cast<const float*>(x),
                  static_cast<const float*>(omega), phase, out, n, k, d,
                  scale, rows, chunk, smem_bytes, copy_width(x, d),
                  copy_width(omega, k), s);
}

}  // extern "C"
