// flash_attention_bwd: the gradient of flash_attention (flash_attn.cu).
//
// No Pallas counterpart: the reference trains through `full_attention` /
// `chunked_attention` (src/repro/models/layers.py:119, :136) and takes
// their gradient by XLA's autodiff; its Pallas kernel has no custom_vjp.
// This is the gradient of the same function, by the standard recompute:
// with the forward's row log-sum-exp lse (flash_attn.cu writes it),
//   P   = exp(scale Q K^T - lse)      (0 where the causal mask, key > row
//                                      by global position, or a key past
//                                      Sk masks it)
//   D_i = sum_d dO[i, d] O[i, d]
//   dS  = P o (dO V^T - D)
//   dQ  = scale dS K,   dK = scale dS^T Q,   dV = P^T dO
// for q (B, Sq, H, D), k / v (B, Sk, Hkv, D), o / dO (B, Sq, H, D), lse
// (B, H, Sq) float32; dq, dk, dv come back in the operands' type (float32
// or bfloat16), o and dO may be float32 beside bfloat16 operands (a
// float32 forward output). Grouped-query heads: dK and dV of a kv head
// sum over its H / Hkv query heads.
//
// Bound on the H100: five products of 2 D operations a causal pair (S,
// dP, dV, dK, dQ) against reading q, k, v, o, dO once and writing dq,
// dk, dv once: at D = 64 the operations bound it (86 GFLOP of bf16
// tensor-core work, 0.087 ms, at zamba2_1p2b's (2, 2,048, 32, 64)). This
// kernel does seven (the dQ launch recomputes S and dP), on the CUDA
// cores. Design (a first version: right and simple; TMA, wgmma and the
// tensor cores are later work):
//
// * Every product runs as IEEE float32 FMAs on the CUDA cores, operands
//   widened from bfloat16 exactly as they are staged; P and dS stay
//   float32 and never go through the tensor cores, so a bf16 gradient
//   differs from its plain version by the rounding of the result only.
// * Three launches, no atomics, a fixed order of every sum, so two calls
//   give the same bits. (1) D, one warp a row, its lanes' partial sums
//   folded by a fixed butterfly. (2) dK and dV: a block per (batch, kv
//   head, tile of 64 keys) holds K and V in shared memory and its dK and
//   dV in registers, and walks the group's query heads and, for each, the
//   query tiles the mask lets see its keys (from the diagonal on), so the
//   head sum is the block's own. (3) dQ: a block per (batch, head, tile of
//   64 query rows), the longest causal walk first, walks the key tiles up
//   to its diagonal. Blocks keep nothing between them.
// * A block is 256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i
//   and columns tx + 16 j of every 64-row tile product. Shared tiles are
//   rows of width + 1 floats (width: d rounded up to 32, 64 or 128, zeros
//   past d and past the last row), so the 16 column threads and the two
//   row groups of a warp read 32 different banks, or one broadcast word.
// * Rows past Sq get lse = +inf (P = 0) and keys past Sk are masked, so a
//   ragged S needs no padding; a row the forward saw no key for has lse
//   = +inf as well.
#include "tile_f32.cuh"

#include <algorithm>
#include <atomic>

namespace {

using namespace svm;

constexpr int FB_TILE = 64;        // query rows / keys of a tile
constexpr int FB_THREADS = 256;    // 16 x 16
constexpr int FB_LDS = FB_TILE + 1;   // row stride of the P and dS tiles
constexpr float FB_LOG2E = 1.4426950408889634f;

// the staged width of a row of d elements (flash_attn.bwd_width)
__host__ __device__ constexpr int fb_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// shared memory of the dK / dV launch: K, V, Q and dO tiles, P and dS,
// lse and D of the query tile (flash_attn.bwd_smem_bytes)
__host__ __device__ constexpr int fb_kv_smem(int w) {
  return 4 * (4 * FB_TILE * (w + 1) + 2 * FB_TILE * FB_LDS + 2 * FB_TILE);
}
// the dQ launch: the same tiles, dS alone
__host__ __device__ constexpr int fb_q_smem(int w) {
  return 4 * (4 * FB_TILE * (w + 1) + FB_TILE * FB_LDS + 2 * FB_TILE);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  float* delta;       // (B, H, Sq) scratch: D
  int b, sq, sk, h, hkv, d;
  float scale, scale_log2;
  int causal, bf16_in, bf16_o;
};

__device__ __forceinline__ float ld_elem(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_elem(void* p, int64_t i, float v,
                                        int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Rows [row0, row0 + 64) of one head of a (B, S, heads, d) tensor (`base`
// the element offset of (b, 0, head, 0), rows `stride` elements apart)
// into s[r * (W + 1) + c], widened to float32; zero past d or past row n.
template <int W>
__device__ __forceinline__ void fb_load(float* s, const void* g, int bf16,
                                        int64_t base, int64_t stride, int d,
                                        int row0, int n) {
  for (int e = threadIdx.x; e < FB_TILE * W; e += FB_THREADS) {
    const int r = e / W, c = e % W;
    float val = 0.f;
    if (row0 + r < n && c < d)
      val = ld_elem(g, base + (int64_t)(row0 + r) * stride + c, bf16);
    s[r * (W + 1) + c] = val;
  }
}

// acc[i][j] += sum_{k < depth} A(ty + 16 i, k) B(k, tx + 16 j): A stored
// a[r * lda + k] (or a[k * lda + r] under AT), B stored b[k * ldb + c]
// (or b[c * ldb + k] under BT); one fmaf a term, k in order.
template <bool AT, bool BT, int NI, int NJ>
__device__ __forceinline__ void mm(float (&acc)[NI][NJ], const float* a,
                                   int lda, const float* b, int ldb,
                                   int depth, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float av[NI], bv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + 16 * i;
      av[i] = AT ? a[k * lda + r] : a[r * lda + k];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      bv[j] = BT ? b[c * ldb + k] : b[k * ldb + c];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// lse (in log2 units) and D of query rows [q0, q0 + 64) of one head
__device__ __forceinline__ void fb_rows(float* lse_s, float* del_s,
                                        const BwdArgs& a, int64_t r_base,
                                        int q0) {
  if (threadIdx.x < FB_TILE) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < a.sq ? __fmul_rn(a.lse[r_base + r], FB_LOG2E)
                                  : __int_as_float(0x7f800000);
    del_s[threadIdx.x] = r < a.sq ? a.delta[r_base + r] : 0.f;
  }
}

// The thread's 4 x 4 block of scores (unscaled, query rows q0 + ty + 16 i,
// keys k0 + tx + 16 j) turned into P in place: 0 where masked.
__device__ __forceinline__ void fb_p(float (&s)[4][4], const BwdArgs& a,
                                     const float* lse_s, int q0, int k0,
                                     int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      float p = 0.f;
      if (key < a.sk && !(a.causal && key > q0 + r))
        p = exp2f(__fsub_rn(__fmul_rn(s[i][j], a.scale_log2), lse_s[r]));
      s[i][j] = p;
    }
  }
}

// (1) D = rowsum(dO o O): one warp a (b, row, head), in memory order
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_delta_kernel(const BwdArgs a) {
  const int64_t w = (int64_t)blockIdx.x * (FB_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (int64_t)a.b * a.sq * a.h) return;
  float acc = 0.f;
  for (int c = lane; c < a.d; c += 32)
    acc = fmaf(ld_elem(a.dout, w * a.d + c, a.bf16_o),
               ld_elem(a.o, w * a.d + c, a.bf16_o), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) {
    const int head = w % a.h;
    const int64_t br = w / a.h;   // b * sq + row
    const int row = br % a.sq, bb = br / a.sq;
    a.delta[((int64_t)bb * a.h + head) * a.sq + row] = acc;
  }
}

// (2) dK, dV of keys [k0, k0 + 64) of one kv head; tile 0 (the longest
// causal walk) first
template <int W>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_kv_kernel(const BwdArgs a) {
  extern __shared__ float fb_kv_sm[];
  constexpr int LD = W + 1, NJ = W / 16;
  float* ks = fb_kv_sm;
  float* vs = ks + FB_TILE * LD;
  float* qs = vs + FB_TILE * LD;
  float* dos = qs + FB_TILE * LD;
  float* ps = dos + FB_TILE * LD;
  float* dss = ps + FB_TILE * FB_LDS;
  float* lse_s = dss + FB_TILE * FB_LDS;
  float* del_s = lse_s + FB_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.hkv, kh = blockIdx.x % a.hkv;
  const int k0 = blockIdx.y * FB_TILE;
  const int grp = a.h / a.hkv;
  const int64_t kv_base = (int64_t)b * a.sk * a.hkv * a.d + (int64_t)kh * a.d;
  fb_load<W>(ks, a.k, a.bf16_in, kv_base, (int64_t)a.hkv * a.d, a.d, k0,
             a.sk);
  fb_load<W>(vs, a.v, a.bf16_in, kv_base, (int64_t)a.hkv * a.d, a.d, k0,
             a.sk);
  float dk[4][NJ], dv[4][NJ];
  zero(dk);
  zero(dv);
  // the first query tile with a row that sees key k0 (rows >= k0)
  const int q_first = a.causal ? (k0 / FB_TILE) * FB_TILE : 0;
  for (int hh = 0; hh < grp; ++hh) {
    const int head = kh * grp + hh;
    const int64_t q_base =
        (int64_t)b * a.sq * a.h * a.d + (int64_t)head * a.d;
    const int64_t r_base = ((int64_t)b * a.h + head) * a.sq;
    for (int q0 = q_first; q0 < a.sq; q0 += FB_TILE) {
      __syncthreads();   // the last tile's reads of qs, dos, ps, dss done
      fb_load<W>(qs, a.q, a.bf16_in, q_base, (int64_t)a.h * a.d, a.d, q0,
                 a.sq);
      fb_load<W>(dos, a.dout, a.bf16_o, q_base, (int64_t)a.h * a.d, a.d, q0,
                 a.sq);
      fb_rows(lse_s, del_s, a, r_base, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mm<false, true>(s, qs, LD, ks, LD, W, ty, tx);     // Q K^T
      mm<false, true>(dp, dos, LD, vs, LD, W, ty, tx);   // dO V^T
      fb_p(s, a, lse_s, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          ps[r * FB_LDS + c] = s[i][j];
          dss[r * FB_LDS + c] =
              __fmul_rn(s[i][j], __fsub_rn(dp[i][j], del_s[r]));
        }
      __syncthreads();
      mm<true, false>(dv, ps, FB_LDS, dos, LD, FB_TILE, ty, tx);   // P^T dO
      mm<true, false>(dk, dss, FB_LDS, qs, LD, FB_TILE, ty, tx);   // dS^T Q
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.sk) continue;
    const int64_t base = kv_base + (int64_t)key * a.hkv * a.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= a.d) continue;
      st_elem(a.dk, base + c, __fmul_rn(dk[i][j], a.scale), a.bf16_in);
      st_elem(a.dv, base + c, dv[i][j], a.bf16_in);
    }
  }
}

// (3) dQ of query rows [q0, q0 + 64) of one head; the last tile (the
// longest causal walk) first
template <int W>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_q_kernel(const BwdArgs a) {
  extern __shared__ float fb_q_sm[];
  constexpr int LD = W + 1, NJ = W / 16;
  float* qs = fb_q_sm;
  float* dos = qs + FB_TILE * LD;
  float* ks = dos + FB_TILE * LD;
  float* vs = ks + FB_TILE * LD;
  float* dss = vs + FB_TILE * LD;
  float* lse_s = dss + FB_TILE * FB_LDS;
  float* del_s = lse_s + FB_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / a.h, head = blockIdx.x % a.h;
  const int kh = head / (a.h / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FB_TILE;
  const int64_t q_base = (int64_t)b * a.sq * a.h * a.d + (int64_t)head * a.d;
  const int64_t kv_base = (int64_t)b * a.sk * a.hkv * a.d + (int64_t)kh * a.d;
  fb_load<W>(qs, a.q, a.bf16_in, q_base, (int64_t)a.h * a.d, a.d, q0, a.sq);
  fb_load<W>(dos, a.dout, a.bf16_o, q_base, (int64_t)a.h * a.d, a.d, q0,
             a.sq);
  fb_rows(lse_s, del_s, a, ((int64_t)b * a.h + head) * a.sq, q0);
  float dq[4][NJ];
  zero(dq);
  const int k_end = a.causal ? min(a.sk, q0 + FB_TILE) : a.sk;
  for (int k0 = 0; k0 < k_end; k0 += FB_TILE) {
    __syncthreads();   // the last tile's reads of ks, dss done
    fb_load<W>(ks, a.k, a.bf16_in, kv_base, (int64_t)a.hkv * a.d, a.d, k0,
               a.sk);
    fb_load<W>(vs, a.v, a.bf16_in, kv_base, (int64_t)a.hkv * a.d, a.d, k0,
               a.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm<false, true>(s, qs, LD, ks, LD, W, ty, tx);
    mm<false, true>(dp, dos, LD, vs, LD, W, ty, tx);
    fb_p(s, a, lse_s, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        dss[r * FB_LDS + c] =
            __fmul_rn(s[i][j], __fsub_rn(dp[i][j], del_s[r]));
      }
    __syncthreads();
    mm<false, false>(dq, dss, FB_LDS, ks, LD, FB_TILE, ty, tx);   // dS K
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
    const int64_t base = q_base + (int64_t)row * a.h * a.d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < a.d)
        st_elem(a.dq, base + c, __fmul_rn(dq[i][j], a.scale), a.bf16_in);
    }
  }
}

template <int W>
int fb_launch(const BwdArgs& a, int smem_kv, int smem_q, cudaStream_t s) {
  static std::atomic<bool> kv_ok[f32tile::MAX_DEVICES];
  static std::atomic<bool> q_ok[f32tile::MAX_DEVICES];
  auto kv = flash_bwd_kv_kernel<W>;
  auto qk = flash_bwd_q_kernel<W>;
  if (const int e = f32tile::allow_max_smem(kv, kv_ok)) return e;
  if (const int e = f32tile::allow_max_smem(qk, q_ok)) return e;
  const int64_t rows = (int64_t)a.b * a.sq * a.h;
  const int per = FB_THREADS / 32;
  flash_bwd_delta_kernel<<<(unsigned)((rows + per - 1) / per), FB_THREADS, 0,
                           s>>>(a);
  if (const int e = static_cast<int>(cudaGetLastError())) return e;
  kv<<<dim3(a.b * a.hkv, (a.sk + FB_TILE - 1) / FB_TILE), FB_THREADS,
       smem_kv, s>>>(a);
  if (const int e = static_cast<int>(cudaGetLastError())) return e;
  qk<<<dim3(a.b * a.h, (a.sq + FB_TILE - 1) / FB_TILE), FB_THREADS, smem_q,
       s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (b, sq, h, d), k / v (b, sk, hkv, d) of bf16_in's type, o / dout
// (b, sq, h, d) bfloat16 under bf16_o (else float32), lse (b, h, sq)
// float32 natural log from svm_flash_attention; dq, dk, dv like q, k, v;
// delta a (b, h, sq) float32 scratch. Needs d <= 128, h % hkv == 0; the
// plan of flash_attn.bwd_plan: the staged width and the two launches'
// shared memory. scale = d^-0.5, scale_log2 = scale log2(e).
int svm_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const float* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* delta, int b, int sq, int sk, int h,
                            int hkv, int d, float scale, float scale_log2,
                            int causal, int bf16_in, int bf16_o, int width,
                            int smem_kv, int smem_q, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      width != fb_width(d) || smem_kv != fb_kv_smem(width) ||
      smem_q != fb_q_smem(width))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.scale = scale;
  a.scale_log2 = scale_log2;
  a.causal = causal;
  a.bf16_in = bf16_in;
  a.bf16_o = bf16_o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 32) return fb_launch<32>(a, smem_kv, smem_q, s);
  if (width == 64) return fb_launch<64>(a, smem_kv, smem_q, s);
  return fb_launch<128>(a, smem_kv, smem_q, s);
}

}  // extern "C"
