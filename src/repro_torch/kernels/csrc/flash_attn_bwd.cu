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
// tensor-core work, 0.087 ms, at zamba2_1p2b's (2, 2,048, 32, 64)). The
// first version ran seven products as float32 FMAs on the CUDA cores
// (5.22 ms there, 17x SDPA's backward). Design (flash_attn.bwd_plan is
// the launch plan; the host side below refuses any other):
//
// * Every product on the tensor cores by mma.sync, FA2-style. bfloat16
//   operands (q, k, v and o all bf16): S = Q K^T and dP = dO V^T are one
//   m16n8k16 pass each with float32 sums, exactly as the forward takes
//   its scores; P and dS are formed in float32 in registers and, for
//   dV = P^T dO, dK = dS^T Q and dQ = dS K, split into a bf16 high part
//   and the bf16 rounding of the rest (two passes), as the forward splits
//   P for P V, so the gradient keeps ~16 bits of P and dS. Otherwise
//   (float32 operands, or a float32 o beside bf16 ones, whose operands
//   are widened exactly as they are staged) every product is 3xTF32:
//   each operand split into a TF32 high part and the rest, lo*hi, hi*lo,
//   hi*hi accumulated in float32.
// * Three launches, no atomics, a fixed order of every sum, so two calls
//   give the same bits. (1) D, one warp a row, its lanes' partial sums
//   folded by a fixed butterfly. (2) dK and dV: a block of four warps per
//   (batch, kv head, tile of 64 keys; eight and 128 on the TF32 route)
//   keeps K and V in shared memory and, warp w, the dK and dV rows of keys
//   16 w + [0, 16) in registers, and
//   walks the group's query heads and, for each, the query tiles the mask
//   lets see its keys (from the diagonal on; key tile 0, the longest
//   walk, first). It works transposed: S^T = K Q^T and dP^T = V dO^T put
//   a key's scores in the warp's own rows, so the C fragments of P^T and
//   dS^T are the A fragments of P^T dO and dS^T Q and no tile crosses
//   warps. (3) dQ: a block of four warps per (batch, head, tile of 64
//   query rows), the longest causal walk first, walks the key tiles up to
//   its diagonal and recomputes S and dP (seven products where five would
//   do: the price of no atomics). The head sum of (2) is the block's own.
//   On the H100, dK / dV blocks of eight warps (half the Q and dO tiles
//   copied a key) took phi4's float32 backward from 8.6 to 7.0 ms, but
//   eight-warp blocks slowed the bf16 route (0.84 -> 0.90 ms at zamba2's
//   shape, 1.97 -> 2.11 at phi4's), whose 4-warp blocks run two an SM.
// * Staging: a ring of two stages of the walked tiles, Q and dO with
//   their lse and D rows in (2), K and V in (3), filled by 16-byte
//   cp.async from every thread one tile ahead, so the next tile's copies
//   overlap the current tile's products; one block barrier a tile. Rows
//   are padded to a stride of 4 (mod 8) words, so ldmatrix's eight rows
//   and the float2 loads of the TF32 B fragments hit 32 different banks.
//   Rows that are not 16-byte multiples, unaligned pointers and bf16
//   operands of the TF32 route are staged by loads (widened) into the
//   same layout; elements past d, rows past Sq and keys past Sk land as
//   zeros.
// * TF32 products whose A operand is a C fragment (P^T dO, dS^T Q, dS K)
//   run their 8 keys (queries) in the order 0, 2, 4, 6, 1, 3, 5, 7, as
//   the forward's P V does: C is then A as it lies, and the B fragment is
//   two float2 loads a pair of 8-column tiles. The tensor cores truncate
//   each float32 sum toward zero, so these products are summed a tile at
//   a time and each tile's sum added to the walk's dK, dV or dQ rounded
//   to nearest: one running sum over phi4's 12,288 query rows of a kv
//   head drifted 1.3e-4 of the largest gradient.
// * Tiles: query tiles of 64 rows in (2) (32 at D 128, so a warp's dK
//   and dV, 2 x 16 x 128 floats, stay in registers beside S^T and dP^T),
//   key tiles of 64 in (3). lse and D stage as zeros past Sq, and the
//   row mask (row < Sq) makes P 0 there; keys past Sk are masked too, so
//   a ragged S needs no padding. A row the forward saw no key for has
//   lse = +inf (P = 0).
#include "mma.cuh"
#include "tile_f32.cuh"

#include <atomic>

namespace {

using namespace svm;

constexpr int FB_ROWS = 64;       // query rows of a dQ block: 4 warps
constexpr int FB_THREADS = 128;
constexpr int FB_KT = 64;         // keys of a dQ block's key tile
constexpr int FB_DELTA_THREADS = 256;
constexpr int FB_RING = 2;        // stages of each launch's ring
constexpr int FB_MAX_SMEM = 232448;
constexpr float FB_LOG2E = 1.4426950408889634f;

// the staged width of a row of d elements (flash_attn.bwd_width)
__host__ __device__ constexpr int fb_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}
// query rows of a dK / dV tile (flash_attn.bwd_q_tile)
__host__ __device__ constexpr int fb_qtile(int w) { return w == 128 ? 32 : 64; }
// warps of a dK / dV block, 16 keys each (flash_attn.bwd_kv_keys): 8 for
// the TF32 route, 4 for bf16
__host__ __device__ constexpr int fb_kv_warps(int elem) {
  return elem == 4 ? 8 : 4;
}
// 32-bit words of a staged row: w elements of `elem` bytes and 4 words of
// padding (a stride of 4 mod 8 words; flash_attn.bwd_row_words)
__host__ __device__ constexpr int fb_ls(int w, int elem) {
  return w * elem / 4 + 4;
}
// shared memory of the dK / dV launch: K and V tiles, then a ring of Q and
// dO tiles with their lse and D rows (flash_attn.bwd_smem_kv)
__host__ __device__ constexpr int fb_kv_smem(int w, int elem) {
  return 4 * (2 * 16 * fb_kv_warps(elem) * fb_ls(w, elem) +
              FB_RING * (2 * fb_qtile(w) * fb_ls(w, elem) + 2 * fb_qtile(w)));
}
// the dQ launch: Q and dO tiles with their lse and D, then a ring of K and
// V tiles (flash_attn.bwd_smem_q)
__host__ __device__ constexpr int fb_q_smem(int w, int elem) {
  return 4 * (2 * FB_ROWS * (fb_ls(w, elem) + 1) +
              FB_RING * 2 * FB_KT * fb_ls(w, elem));
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
  int async_qkv, async_o;    // rows staged by cp.async (else loads)
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

// Rows [row0, row0 + rows) of one head of a (B, S, heads, d) tensor (`base`
// the element offset of (b, 0, head, 0), rows `ld` elements apart) into
// s[r * LS + word] as T (bf16 pairs or float32 words); zero past d or past
// row n. By 16-byte cp.async (the caller commits) under `async` (a source
// of type T, d * sizeof(T) a multiple of 16, aligned), else by loads,
// widened from bfloat16 where the source is (`src_bf16`); NT threads.
template <typename T, int W, int NT>
__device__ __forceinline__ void fb_stage(uint32_t* s, int rows, const void* g,
                                         int src_bf16, int64_t base,
                                         int64_t ld, int d, int row0, int n,
                                         int async) {
  constexpr int RW = W * static_cast<int>(sizeof(T)) / 4;   // words a row
  constexpr int LS = RW + 4;
  if (async) {
    constexpr int CH = RW / 4;                      // 16-byte chunks a row
    constexpr int EPC = 16 / static_cast<int>(sizeof(T));
    const T* gp = static_cast<const T*>(g);
    for (int e = threadIdx.x; e < rows * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      const bool valid = row0 + r < n && c * EPC < d;
      const T* src = valid ? gp + base + (int64_t)(row0 + r) * ld + c * EPC
                           : gp;
      f32tile::cp_async<16>(s + r * LS + 4 * c, src, valid);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * RW; e += NT) {
    const int r = e / RW, w = e % RW;
    uint32_t val = 0;
    if (row0 + r < n) {
      const int64_t at = base + (int64_t)(row0 + r) * ld;
      if constexpr (sizeof(T) == 2) {   // the bf16 route: a bf16 source
        const unsigned short* gp = static_cast<const unsigned short*>(g);
        if (2 * w < d) val = gp[at + 2 * w];
        if (2 * w + 1 < d) val |= static_cast<uint32_t>(gp[at + 2 * w + 1])
                                  << 16;
      } else if (w < d) {
        val = __float_as_uint(ld_elem(g, at + w, src_bf16));
      }
    }
    s[r * LS + w] = val;
  }
}

// `rows` floats of a (b, h, sq) row run from row0 (zero at or past n); NT
// threads
template <int NT>
__device__ __forceinline__ void fb_run(float* s, int rows, const float* g,
                                       int row0, int n) {
  for (int e = threadIdx.x; e < rows; e += NT) {
    const bool valid = row0 + e < n;
    f32tile::cp_async<4>(s + e, valid ? g + row0 + e : g, valid);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// s[j] += A B^T over a row of KS MMA steps: A the 16 rows of `a` from row
// arow (ldmatrix), B the NP pairs of 8-row tiles of `bt` from row 0
// (ldmatrix); bf16 m16n8k16, or 3xTF32 m16n8k8. s[j]: rows g, g + 8,
// columns (B's rows) 8 j + 2 t (+1).
template <bool BF16, int KS, int NP, int LS>
__device__ __forceinline__ void fb_scores(float (&s)[2 * NP][4],
                                          const uint32_t* a,
                                          const uint32_t* bt, int arow,
                                          int lane) {
  const int qq = lane / 8, rr = lane % 8;
  const int ra = arow + rr + (qq & 1) * 8;   // this lane's ldmatrix rows
  const int rb = (qq >> 1) * 8 + rr;
  // four steps unrolled: a whole D 128 row's fragments hoisted at once
  // spilled the bf16 dK / dV kernel
#pragma unroll 4
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t x[4];
    ldsm_x4(x, a + ra * LS + ks * 8 + (qq >> 1) * 4);
    if constexpr (BF16) {
#pragma unroll
      for (int jp = 0; jp < NP; ++jp) {
        uint32_t y[4];
        ldsm_x4(y, bt + (jp * 16 + rb) * LS + ks * 8 + (qq & 1) * 4);
        mma_bf16(s[2 * jp], x, y);
        mma_bf16(s[2 * jp + 1], x, y + 2);
      }
    } else {
      uint32_t xh[4], xl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_trunc(x[e], xh[e], xl[e]);
#pragma unroll
      for (int jp = 0; jp < NP; ++jp) {
        uint32_t y[4], yh[4], yl[4];
        ldsm_x4(y, bt + (jp * 16 + rb) * LS + ks * 8 + (qq & 1) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_trunc(y[e], yh[e], yl[e]);
        mma_3xtf32(s[2 * jp], xh, xl, yh, yl);
        mma_3xtf32(s[2 * jp + 1], xh, xl, yh + 2, yl + 2);
      }
    }
  }
}

// acc[j] += X B over NK 8-wide steps of the depth: X a warp's NK 16 x 8 C
// fragments in registers (P^T, dS^T or dS), B the staged tile `bt` with
// the depth along its rows (row 0 is X's column 0) and NJ 8-column tiles.
// bf16: X split into bf16 high and low parts, B by ldmatrix.trans. TF32:
// step j takes depth rows 8 j + (0, 2, 4, 6, 1, 3, 5, 7), so A's words t,
// t + 4 are x[j]'s columns 2t, 2t + 1 (C is A as it lies), and B is two
// float2 loads a pair of 8-column tiles (fb_col gives the columns).
template <bool BF16, int NK, int NJ, int LS>
__device__ __forceinline__ void fb_accum(float (&acc)[NJ][4],
                                         const float (&x)[NK][4],
                                         const uint32_t* bt, int lane) {
  const int g = lane / 4, t = lane % 4, qq = lane / 8, rr = lane % 8;
  if constexpr (BF16) {
    const int rv = (qq & 1) * 8 + rr;   // ldmatrix.trans rows of a step
#pragma unroll
    for (int k16 = 0; k16 < NK / 2; ++k16) {
      uint32_t xh[4], xl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* c = x[2 * k16 + (e >> 1)] + 2 * (e & 1);
        split_bf16x2(c[0], c[1], xh[e], xl[e]);
      }
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t y[4];
        ldsm_x4_t(y, bt + (k16 * 16 + rv) * LS + jp * 8 + (qq >> 1) * 4);
        mma_bf16(acc[2 * jp], xl, y);
        mma_bf16(acc[2 * jp], xh, y);
        mma_bf16(acc[2 * jp + 1], xl, y + 2);
        mma_bf16(acc[2 * jp + 1], xh, y + 2);
      }
    }
  } else {
    // a tile's products summed apart, then added into acc rounded to
    // nearest: the tensor cores truncate each float32 sum, so a running
    // sum over a long walk (12,288 query rows of a phi4 kv head) would
    // lose ~1 ulp of itself a step, always toward zero. Up to four pairs
    // of 8-column tiles a pass: eight independent sums in flight.
    const float* f = reinterpret_cast<const float*>(bt);
    constexpr int JQ = NJ / 2 < 4 ? NJ / 2 : 4;
#pragma unroll
    for (int jp0 = 0; jp0 < NJ / 2; jp0 += JQ) {
      float part[2 * JQ][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t xh[4], xl[4];
        split_tf32_trunc(__float_as_uint(x[j][0]), xh[0], xl[0]);
        split_tf32_trunc(__float_as_uint(x[j][2]), xh[1], xl[1]);
        split_tf32_trunc(__float_as_uint(x[j][1]), xh[2], xl[2]);
        split_tf32_trunc(__float_as_uint(x[j][3]), xh[3], xl[3]);
        const float* r0 = f + (8 * j + 2 * t) * LS + 2 * g;
        const float* r1 = r0 + LS;
#pragma unroll
        for (int q = 0; q < JQ; ++q) {
          // tile 2 jp: columns 16 jp + 2 g; tile 2 jp + 1: 16 jp + 2 g + 1
          const int jp = jp0 + q;
          const float2 u0 = *reinterpret_cast<const float2*>(r0 + 16 * jp);
          const float2 u1 = *reinterpret_cast<const float2*>(r1 + 16 * jp);
          uint32_t yh[4], yl[4];
          split_tf32_trunc(__float_as_uint(u0.x), yh[0], yl[0]);
          split_tf32_trunc(__float_as_uint(u1.x), yh[1], yl[1]);
          split_tf32_trunc(__float_as_uint(u0.y), yh[2], yl[2]);
          split_tf32_trunc(__float_as_uint(u1.y), yh[3], yl[3]);
          mma_3xtf32(part[2 * q], xh, xl, yh, yl);
          mma_3xtf32(part[2 * q + 1], xh, xl, yh + 2, yl + 2);
        }
      }
#pragma unroll
      for (int q = 0; q < 2 * JQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[2 * jp0 + q][e] = __fadd_rn(acc[2 * jp0 + q][e], part[q][e]);
    }
  }
}

// The column of element e of 8-column tile j of an accumulator fb_accum
// filled: bf16 8 j + 2 t + e % 2; TF32 (permuted pairs of tiles)
// 16 (j / 2) + 4 t + 2 (e % 2) + j % 2
template <bool BF16>
__device__ __forceinline__ int fb_col(int j, int e, int t) {
  return BF16 ? 8 * j + 2 * t + (e & 1)
              : 16 * (j / 2) + 4 * t + 2 * (e & 1) + (j & 1);
}

// (1) D = rowsum(dO o O): one warp a (b, row, head), in memory order
__global__ void __launch_bounds__(FB_DELTA_THREADS)
flash_bwd_delta_kernel(const BwdArgs a) {
  const int64_t w = (int64_t)blockIdx.x * (FB_DELTA_THREADS / 32) +
                    threadIdx.x / 32;
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

// (2) dK, dV of keys [k0, k0 + KEYS) of one kv head (KEYS = 16 a warp);
// warp w owns keys k0 + 16 w + [0, 16); key tile 0 (the longest causal
// walk) first
template <typename T, int W>
__global__ void __launch_bounds__(32 * fb_kv_warps(sizeof(T)), 1)
flash_bwd_kv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) uint32_t fb_kv_sm[];
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int LS = fb_ls(W, sizeof(T));
  constexpr int KS = (LS - 4) / 8;    // MMA steps over a row
  constexpr int QT = fb_qtile(W);     // query rows of a tile
  constexpr int NQ = QT / 8;          // 8-query tiles of S^T
  constexpr int NJ = W / 8;           // 8-column tiles of dK, dV
  constexpr int STAGE = 2 * QT * LS + 2 * QT;   // words of a ring stage
  constexpr int KEYS = 16 * fb_kv_warps(sizeof(T));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.hkv, kh = blockIdx.x % a.hkv;
  const int k0 = blockIdx.y * KEYS, kw0 = k0 + 16 * warp;
  const int grp = a.h / a.hkv;
  uint32_t* sk = fb_kv_sm;
  uint32_t* sv = sk + KEYS * LS;
  uint32_t* ring = sv + KEYS * LS;
  const int64_t kv_ld = (int64_t)a.hkv * a.d, q_ld = (int64_t)a.h * a.d;
  const int64_t kv_base = (int64_t)b * a.sk * kv_ld + (int64_t)kh * a.d;
  // the first query tile with a row that sees key k0 (rows >= k0)
  const int q_first = a.causal ? k0 / QT : 0;
  const int nqt = max(0, (a.sq + QT - 1) / QT - q_first);
  const int n = grp * nqt;   // tiles of the walk: (head, query tile)

  auto issue = [&](int it) {
    const int hh = it / nqt, q0 = (q_first + it % nqt) * QT;
    const int head = kh * grp + hh;
    uint32_t* st = ring + (it % FB_RING) * STAGE;
    const int64_t qb = (int64_t)b * a.sq * q_ld + (int64_t)head * a.d;
    fb_stage<T, W, 2 * KEYS>(st, QT, a.q, a.bf16_in, qb, q_ld, a.d, q0,
                             a.sq, a.async_qkv);
    fb_stage<T, W, 2 * KEYS>(st + QT * LS, QT, a.dout, a.bf16_o, qb, q_ld,
                             a.d, q0, a.sq, a.async_o);
    const int64_t rb = ((int64_t)b * a.h + head) * a.sq;
    float* f = reinterpret_cast<float*>(st + 2 * QT * LS);
    fb_run<2 * KEYS>(f, QT, a.lse + rb, q0, a.sq);
    fb_run<2 * KEYS>(f + QT, QT, a.delta + rb, q0, a.sq);
  };

  fb_stage<T, W, 2 * KEYS>(sk, KEYS, a.k, a.bf16_in, kv_base, kv_ld, a.d,
                           k0, a.sk, a.async_qkv);
  fb_stage<T, W, 2 * KEYS>(sv, KEYS, a.v, a.bf16_in, kv_base, kv_ld, a.d,
                           k0, a.sk, a.async_qkv);
  if (n > 0) issue(0);
  f32tile::cp_async_commit();

  float dk[NJ][4], dv[NJ][4];
  zero(dk);
  zero(dv);
  const bool keys_live = kw0 < a.sk;
  for (int it = 0; it < n; ++it) {
    f32tile::cp_async_wait<0>();
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n) issue(it + 1);
    f32tile::cp_async_commit();
    const int q0 = (q_first + it % nqt) * QT;
    if (!keys_live || (a.causal && q0 + QT - 1 < kw0)) continue;
    const uint32_t* sq = ring + (it % FB_RING) * STAGE;
    const uint32_t* sdo = sq + QT * LS;
    const float* lse_s = reinterpret_cast<const float*>(sdo + QT * LS);
    const float* del_s = lse_s + QT;

    // S^T = K Q^T: keys (rows) g, g + 8 of the warp's 16, queries
    // (columns) 8 j + 2 t (+1); then P^T in place and dV += P^T dO, before
    // dP^T = V dO^T takes its registers (dK and dV stay live throughout)
    float st[NQ][4], dp[NQ][4];
    zero(st);
    fb_scores<BF16, KS, NQ / 2, LS>(st, sk, sq, 16 * warp, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw0 + g + 8 * (e >> 1);
        const int ql = 8 * j + 2 * t + (e & 1), query = q0 + ql;
        float p = 0.f;
        if (key < a.sk && query < a.sq && !(a.causal && key > query))
          p = ex2(__fsub_rn(__fmul_rn(st[j][e], a.scale_log2),
                            __fmul_rn(lse_s[ql], FB_LOG2E)));
        st[j][e] = p;
      }
    fb_accum<BF16, NQ, NJ, LS>(dv, st, sdo, lane);
    // dS^T = P^T o (dP^T - D) in place of dP^T; dK += dS^T Q
    zero(dp);
    fb_scores<BF16, KS, NQ / 2, LS>(dp, sv, sdo, 16 * warp, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1);
        dp[j][e] = __fmul_rn(st[j][e], __fsub_rn(dp[j][e], del_s[ql]));
      }
    fb_accum<BF16, NQ, NJ, LS>(dk, dp, sq, lane);
  }
  f32tile::cp_async_wait<0>();
  if (!keys_live) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kw0 + g + 8 * (e >> 1), c = fb_col<BF16>(j, e, t);
      if (key >= a.sk || c >= a.d) continue;
      const int64_t at = kv_base + (int64_t)key * kv_ld + c;
      st_elem(a.dk, at, __fmul_rn(dk[j][e], a.scale), a.bf16_in);
      st_elem(a.dv, at, dv[j][e], a.bf16_in);
    }
}

// (3) dQ of query rows [q0, q0 + 64) of one head; warp w owns rows
// q0 + 16 w + [0, 16); the last tile (the longest causal walk) first
template <typename T, int W>
__global__ void __launch_bounds__(FB_THREADS, 1)
flash_bwd_q_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) uint32_t fb_q_sm[];
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int LS = fb_ls(W, sizeof(T));
  constexpr int KS = (LS - 4) / 8;
  constexpr int NJ = W / 8;           // 8-column tiles of dQ
  constexpr int STAGE = 2 * FB_KT * LS;
  constexpr int ROWS = FB_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.h, head = blockIdx.x % a.h;
  const int kh = head / (a.h / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS, qw0 = q0 + 16 * warp;
  uint32_t* sq = fb_q_sm;
  uint32_t* sdo = sq + ROWS * LS;
  float* lse_s = reinterpret_cast<float*>(sdo + ROWS * LS);
  float* del_s = lse_s + ROWS;
  uint32_t* ring = reinterpret_cast<uint32_t*>(del_s + ROWS);
  const int64_t kv_ld = (int64_t)a.hkv * a.d, q_ld = (int64_t)a.h * a.d;
  const int64_t q_base = (int64_t)b * a.sq * q_ld + (int64_t)head * a.d;
  const int64_t kv_base = (int64_t)b * a.sk * kv_ld + (int64_t)kh * a.d;
  const int64_t r_base = ((int64_t)b * a.h + head) * a.sq;
  const int k_end = a.causal ? min(a.sk, min(a.sq, q0 + ROWS)) : a.sk;
  const int n = (k_end + FB_KT - 1) / FB_KT;

  auto issue = [&](int it) {
    uint32_t* st = ring + (it % FB_RING) * STAGE;
    fb_stage<T, W, FB_THREADS>(st, FB_KT, a.k, a.bf16_in, kv_base, kv_ld,
                               a.d, it * FB_KT, a.sk, a.async_qkv);
    fb_stage<T, W, FB_THREADS>(st + FB_KT * LS, FB_KT, a.v, a.bf16_in,
                               kv_base, kv_ld, a.d, it * FB_KT, a.sk,
                               a.async_qkv);
  };

  fb_stage<T, W, FB_THREADS>(sq, ROWS, a.q, a.bf16_in, q_base, q_ld, a.d, q0,
                             a.sq, a.async_qkv);
  fb_stage<T, W, FB_THREADS>(sdo, ROWS, a.dout, a.bf16_o, q_base, q_ld, a.d,
                             q0, a.sq, a.async_o);
  fb_run<FB_THREADS>(lse_s, ROWS, a.lse + r_base, q0, a.sq);
  fb_run<FB_THREADS>(del_s, ROWS, a.delta + r_base, q0, a.sq);
  if (n > 0) issue(0);
  f32tile::cp_async_commit();

  float dq[NJ][4];
  zero(dq);
  const bool rows_live = qw0 < a.sq;
  for (int it = 0; it < n; ++it) {
    f32tile::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n) issue(it + 1);
    f32tile::cp_async_commit();
    const int k0 = it * FB_KT;
    if (!rows_live || (a.causal && k0 > qw0 + 15)) continue;
    const uint32_t* skt = ring + (it % FB_RING) * STAGE;
    const uint32_t* svt = skt + FB_KT * LS;

    // S = Q K^T and dP = dO V^T: rows g, g + 8 of the warp's 16, keys
    // 8 j + 2 t (+1)
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    fb_scores<BF16, KS, 4, LS>(s, sq, skt, 16 * warp, lane);
    fb_scores<BF16, KS, 4, LS>(dp, sdo, svt, 16 * warp, lane);
    float lse2[2], del[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = 16 * warp + g + 8 * hh;
      lse2[hh] = __fmul_rn(lse_s[rl], FB_LOG2E);
      del[hh] = del_s[rl];
    }
    // dS in place of S
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qw0 + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (row < a.sq && key < a.sk && !(a.causal && key > row))
          p = ex2(__fsub_rn(__fmul_rn(s[j][e], a.scale_log2), lse2[e >> 1]));
        s[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], del[e >> 1]));
      }
    // dQ += dS K
    fb_accum<BF16, 8, NJ, LS>(dq, s, skt, lane);
  }
  f32tile::cp_async_wait<0>();
  if (!rows_live) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qw0 + g + 8 * (e >> 1), c = fb_col<BF16>(j, e, t);
      if (row < a.sq && c < a.d)
        st_elem(a.dq, q_base + (int64_t)row * q_ld + c,
                __fmul_rn(dq[j][e], a.scale), a.bf16_in);
    }
}

template <typename T, int W>
int fb_launch(const BwdArgs& a, int smem_kv, int smem_q, cudaStream_t s) {
  static std::atomic<bool> kv_ok[f32tile::MAX_DEVICES];
  static std::atomic<bool> q_ok[f32tile::MAX_DEVICES];
  auto kv = flash_bwd_kv_kernel<T, W>;
  auto qk = flash_bwd_q_kernel<T, W>;
  if (const int e = f32tile::allow_max_smem(kv, kv_ok)) return e;
  if (const int e = f32tile::allow_max_smem(qk, q_ok)) return e;
  const int64_t rows = (int64_t)a.b * a.sq * a.h;
  const int per = FB_DELTA_THREADS / 32;
  flash_bwd_delta_kernel<<<(unsigned)((rows + per - 1) / per),
                           FB_DELTA_THREADS, 0, s>>>(a);
  if (const int e = static_cast<int>(cudaGetLastError())) return e;
  constexpr int keys = 16 * fb_kv_warps(sizeof(T));
  kv<<<dim3(a.b * a.hkv, (a.sk + keys - 1) / keys), 2 * keys, smem_kv,
       s>>>(a);
  if (const int e = static_cast<int>(cudaGetLastError())) return e;
  qk<<<dim3(a.b * a.h, (a.sq + FB_ROWS - 1) / FB_ROWS), FB_THREADS, smem_q,
       s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fb_route(const BwdArgs& a, int width, int smem_kv, int smem_q,
             cudaStream_t s) {
  if (width == 32) return fb_launch<T, 32>(a, smem_kv, smem_q, s);
  if (width == 64) return fb_launch<T, 64>(a, smem_kv, smem_q, s);
  return fb_launch<T, 128>(a, smem_kv, smem_q, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// q (b, sq, h, d), k / v (b, sk, hkv, d) of bf16_in's type, o / dout
// (b, sq, h, d) bfloat16 under bf16_o (else float32), lse (b, h, sq)
// float32 natural log from svm_flash_attention; dq, dk, dv like q, k, v;
// delta a (b, h, sq) float32 scratch. Needs d <= 128, h % hkv == 0; the
// plan of flash_attn.bwd_plan: the staged width, the dK / dV query tile
// and the two launches' shared memory (bf16 tiles when q and o are both
// bfloat16, else float32). scale = d^-0.5, scale_log2 = scale
// log2(e).
int svm_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const float* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* delta, int b, int sq, int sk, int h,
                            int hkv, int d, float scale, float scale_log2,
                            int causal, int bf16_in, int bf16_o, int width,
                            int q_tile, int smem_kv, int smem_q,
                            void* stream) {
  const bool bf = bf16_in && bf16_o;   // the bf16 route
  const int elem = bf ? 2 : 4;
  if (d < 1 || d > 128 || hkv < 1 || h % hkv != 0 || sq < 1 || sk < 1 ||
      width != fb_width(d) || q_tile != fb_qtile(width) ||
      smem_kv != fb_kv_smem(width, elem) || smem_q != fb_q_smem(width, elem) ||
      smem_kv > FB_MAX_SMEM || smem_q > FB_MAX_SMEM)
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
  // a source of the staged type, rows of whole 16-byte chunks, aligned
  const bool rows16 = (d * elem) % 16 == 0;
  a.async_qkv = (bf16_in != 0) == bf && rows16 && aligned16(q) &&
                aligned16(k) && aligned16(v);
  a.async_o = (bf16_o != 0) == bf && rows16 && aligned16(dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf ? fb_route<__nv_bfloat16>(a, width, smem_kv, smem_q, s)
            : fb_route<float>(a, width, smem_kv, smem_q, s);
}

}  // extern "C"
