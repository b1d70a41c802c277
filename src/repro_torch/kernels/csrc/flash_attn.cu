// flash_attention: softmax attention with an online softmax, never
// storing the (S, S) score matrix.
//
// Replaces `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attn.py), reached through
// `ops.flash_attention` (src/repro/kernels/ops.py): per head,
//   O = softmax(Q K^T * d^-0.5  [causal: key > query masked]) V
// with the reference's numerics: scores, running max, running sum and
// accumulator in float32 whatever the operand type; the running max
// starts at -1e30 (not -inf) and masked scores are -1e30, so
// exp(-1e30 - m) underflows to exactly 0 and nothing is ever inf - inf;
// the running sum is clamped at 1e-20 before the final division; the
// output is rounded once, to the output type, at the end.
//
// Layout as the op takes it: q (B, Sq, H, D), k / v (B, Sk, Hkv, D),
// out (B, Sq, H, D). Grouped-query heads are read in place (query head
// h reads kv head h / (H / Hkv)); nothing is padded or copied. Keys at
// or past kv_len are masked; the causal mask compares global positions.
//
// Bound on the H100: 2 S_q S_k D multiply-adds per head (half that with
// the causal mask) against reading q, k, v and writing o once, so at
// D = 128 it is bound by operations — 4 B H S^2 D flops (2 B H S^2 D
// causal) over the float32 rate of 67 TFLOP/s (no tensor cores in this
// first version). Design: one block per (batch x head, 64-query tile);
// the query tile stays in shared memory (transposed) while the block
// walks 64-key tiles: scores by IEEE float32 FMAs from two transposed
// tiles, the row max and sum by shuffles within each 16-thread row
// group, the weights written to shared memory, then V staged into the
// buffer K used and accumulated into 64 x D outputs held in registers.
// Under the causal mask the walk stops at the query tile's last row:
// the skipped tiles are fully masked, and a fully masked tile leaves
// the running state unchanged bit for bit in the reference too.
#include "common.cuh"

namespace {

using namespace svm;

constexpr float NEG_BIG = -1e30f;  // the reference's NEG_INF
constexpr int NJ = LM_MAX_D / 16;  // output columns per thread

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t flash_smem_bytes(int d) {
  // q^T (d x 65); one buffer for k^T (d x 65), then v (64 x d); weights
  return sizeof(float) * (2 * (size_t)d * LM_LD + (size_t)TILE * LM_LD);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, OutT* __restrict__ out, int sq, int sk,
             int h, int hkv, int d, int kv_len, float scale, int causal) {
  extern __shared__ float smem[];
  float* qt = smem;                       // d x LM_LD, transposed
  float* kv = qt + d * LM_LD;             // k^T, then v (row-major)
  float* wt = kv + d * LM_LD;             // TILE x LM_LD weights

  const int bh = blockIdx.y, b = bh / h, head = bh % h;
  const int kvhead = head / (h / hkv);
  const int q0 = blockIdx.x * TILE;
  const int64_t q_ld = (int64_t)h * d, kv_ld = (int64_t)hkv * d;
  const T* qb = q + ((int64_t)b * sq * h + head) * d;
  const T* kb = k + ((int64_t)b * sk * hkv + kvhead) * d;
  const T* vb = v + ((int64_t)b * sk * hkv + kvhead) * d;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_rows_t(qt, qb, q_ld, q0, sq, d);
  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;
  }
  int n_tiles = (kv_len + TILE - 1) / TILE;
  if (causal) {
    const int last_q = min(q0 + TILE, sq) - 1;
    n_tiles = min(n_tiles, last_q / TILE + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // the previous tile's v and weights are consumed
    stage_rows_t(kv, kb, kv_ld, k0, sk, d);
    __syncthreads();
    float s[4][4];
    tile_scores(qt, kv, d, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], scale);
        if ((causal && kpos > qpos) || kpos >= kv_len) x = NEG_BIG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_group_max(mx));
      const float corr = expf(__fsub_rn(m[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        wt[(ty + 16 * i) * LM_LD + tx + 16 * j] = p;
        sum = __fadd_rn(sum, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), row_group_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] = __fmul_rn(o[i][j], corr);
    }
    __syncthreads();  // scores are done with k; weights are written
    stage_rows(kv, vb, kv_ld, k0, sk, d);
    __syncthreads();
    tile_weighted_sum<NJ>(wt, kv, d, o);
  }
  OutT* ob = out + ((int64_t)b * sq * h + head) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(&ob[r * q_ld + c], __fdiv_rn(o[i][j], den));
    }
  }
}

template <typename T, typename OutT>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int hkv, int d, int kv_len, float scale,
           int causal, cudaStream_t s) {
  const size_t smem = flash_smem_bytes(d);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + TILE - 1) / TILE, b * h);
  flash_kernel<T, OutT><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<OutT*>(out), sq, sk, h, hkv, d,
      kv_len, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16_in: q/k/v are bfloat16 (else float32); out is of their type, or
// float32 under f32_out. Needs d <= 128, h % hkv == 0, 1 <= kv_len <= sk
// (the wrapper checks).
int svm_flash_attention(const void* q, const void* k, const void* v,
                        void* out, int b, int sq, int sk, int h, int hkv,
                        int d, int kv_len, float scale, int causal,
                        int bf16_in, int f32_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_in)
    return launch<float, float>(q, k, v, out, b, sq, sk, h, hkv, d, kv_len,
                                scale, causal, s);
  if (f32_out)
    return launch<__nv_bfloat16, float>(q, k, v, out, b, sq, sk, h, hkv, d,
                                        kv_len, scale, causal, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, b, sq, sk, h,
                                              hkv, d, kv_len, scale, causal,
                                              s);
}

}  // extern "C"
