// ssd_diag: the intra-chunk term of the SSD (Mamba-2) scan.
//
// Replaces `ssd_diag_pallas` / `_ssd_diag_kernel`
// (src/repro/kernels/ssd_diag.py): per (chunk, head),
//   Y[q, p] = sum_{k <= q} (C_q . B_k) * exp(cs_q - cs_k) * dt_k * x[k, p]
// with C, B (BC, Q, N) shared by the heads (one group), x (BC, H, Q, P),
// dt, cs (BC, H, Q) and Y (BC, H, Q, P), all float32. The weight is
// formed as the reference forms it, ((C_q . B_k) * L[q, k]) * dt_k, and
// exp is evaluated only where k <= q: above the diagonal cs_q - cs_k is
// positive and may overflow, and inf * 0 would be NaN (the reference
// selects with `where`; here the exp is never taken).
//
// Bound on the H100: the causal half of the (Q, Q) score tile per chunk
// and of the weighted sum per head, Q(Q+1)/2 (2N + 2P + ~4) flops, against
// reading C, B, x, dt, cs and writing Y once; at mamba2_780m's Q = 256,
// N = 128, P = 64 the operations bound it (float32, 67 TFLOP/s, no tensor
// cores in this first version). Design: one block per (chunk, head) — the
// reference's grid — walking 64-row query tiles; for each, the 64-row key
// tiles up to it: scores from two transposed shared-memory tiles by IEEE
// float32 FMAs, the decay and dt applied in registers and written to a
// shared weight tile, then x staged into the buffer B used and summed
// into 64 x 64 output tiles held in registers (P is walked 64 columns at
// a time). The (Q, Q) matrices never leave the SM.
#include "common.cuh"

namespace {

using namespace svm;

size_t ssd_smem_bytes(int n) {
  // C^T (n x 65); one buffer for B^T (n x 65), then x (64 x 64); weights;
  // cs of the query tile, cs and dt of the key tile
  const size_t bx = (size_t)n * LM_LD > (size_t)TILE * TILE
                        ? (size_t)n * LM_LD : (size_t)TILE * TILE;
  return sizeof(float) * ((size_t)n * LM_LD + bx + (size_t)TILE * LM_LD
                          + 3 * TILE);
}

__global__ void __launch_bounds__(THREADS)
ssd_diag_kernel(const float* __restrict__ cmat, const float* __restrict__ bmat,
                const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ cs, float* __restrict__ out, int q,
                int n, int h, int p) {
  extern __shared__ float smem[];
  const int bx_size = n * LM_LD > TILE * TILE ? n * LM_LD : TILE * TILE;
  float* ct = smem;                 // C tile, transposed
  float* bx = ct + n * LM_LD;       // B tile transposed, then x tile
  float* wt = bx + bx_size;         // TILE x LM_LD weights
  float* cs_q = wt + TILE * LM_LD;  // cs of the query tile
  float* cs_k = cs_q + TILE;        // cs of the key tile
  float* dt_k = cs_k + TILE;        // dt of the key tile

  const int head = blockIdx.x, chunk = blockIdx.y;
  const float* cb = cmat + (int64_t)chunk * q * n;
  const float* bb = bmat + (int64_t)chunk * q * n;
  const int64_t ch = (int64_t)chunk * h + head;
  const float* xb = x + ch * q * p;
  const float* dtb = dt + ch * q;
  const float* csb = cs + ch * q;
  float* yb = out + ch * q * p;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int q0 = 0; q0 < q; q0 += TILE) {
    __syncthreads();  // the previous query tile is done with ct / cs_q
    stage_rows_t(ct, cb, n, q0, q, n);
    if (threadIdx.x < TILE)
      cs_q[threadIdx.x] = q0 + threadIdx.x < q ? csb[q0 + threadIdx.x] : 0.f;
    for (int p0 = 0; p0 < p; p0 += TILE) {
      const int pc = min(TILE, p - p0);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 <= q0; k0 += TILE) {
        __syncthreads();  // x and the weights of the last key tile are used
        stage_rows_t(bx, bb, n, k0, q, n);
        if (threadIdx.x < TILE) {
          const int kk = k0 + threadIdx.x;
          cs_k[threadIdx.x] = kk < q ? csb[kk] : 0.f;
          dt_k[threadIdx.x] = kk < q ? dtb[kk] : 0.f;
        }
        __syncthreads();
        float s[4][4];
        tile_scores(ct, bx, n, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            float w = 0.f;
            if (k0 + c <= q0 + r && q0 + r < q) {  // k <= q < Q
              const float decay = expf(__fsub_rn(cs_q[r], cs_k[c]));
              w = __fmul_rn(__fmul_rn(s[i][j], decay), dt_k[c]);
            }
            wt[r * LM_LD + c] = w;
          }
        }
        __syncthreads();  // scores are done with B; weights are written
        stage_rows(bx, xb + p0, p, k0, q, pc);
        __syncthreads();
        tile_weighted_sum<4>(wt, bx, pc, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < pc) yb[(int64_t)r * p + p0 + c] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// cmat, bmat (bc, q, n); x (bc, h, q, p); dt, cs (bc, h, q); out like x.
// Needs n <= 256 (shared memory; the wrapper checks).
int svm_ssd_diag(const float* cmat, const float* bmat, const float* x,
                 const float* dt, const float* cs, float* out, int bc, int h,
                 int q, int n, int p, void* stream) {
  const size_t smem = ssd_smem_bytes(n);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_diag_kernel<<<dim3(h, bc), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      cmat, bmat, x, dt, cs, out, q, n, h, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
