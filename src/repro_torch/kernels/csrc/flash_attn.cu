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
// Bound on the H100: 2 S_q S_k D multiply-adds a head (half that under
// the causal mask) against reading q, k, v and writing o once: at D =
// 128 the operations bound it. The first version ran them as IEEE float32
// FMAs on the CUDA cores (6.56 ms at phi4_mini_3p8b's shape, 23 % of the
// 67 TFLOP/s bound). Design (flash_attn.flash_plan is the launch plan;
// the host side below refuses any other):
//
// * Both products on the tensor cores by mma.sync, FA2-style: a block
//   owns a tile of 64 or 128 query rows, one MMA warp per 16 rows, and
//   walks key tiles of 64. float32 operands as 3xTF32 (each operand
//   split into a TF32 high part and the rest; lo*hi, hi*lo, hi*hi
//   accumulate in float32): one TF32 pass would not hold the float32
//   parity bound. bfloat16 operands: one m16n8k16 product for Q K^T
//   (bf16 products are exact in float32, as the reference computes
//   them) and, for P V, P split into a bf16 high part and the bf16
//   rounding of the rest, two products against V: P rounded to bf16
//   once would miss the bound on early rows (row 1 has two keys).
// * The scores never leave registers. A row's 64 scores of a tile lie in
//   the four lanes of a quad, so the row max and sum are two shuffles.
//   bf16: the m16n8k16 C fragment of two score tiles is the A fragment
//   of P V. TF32 (m16n8k8): C holds columns 2t, 2t + 1 and A wants t,
//   t + 4, so the P V step runs its 8 keys in the order 0, 2, 4, 6, 1,
//   3, 5, 7: C is then A as it lies, and V's B fragment reads keys 2t and
//   2t + 1. V's fragment is two float2 loads a pair of 8-column tiles
//   (the first tile's columns even, the second's odd), conflict-free.
// * One producer warp fills a ring of 2 or 3 K and V tile stages by TMA
//   through tensor maps over (B, S, H, D) (a head's rows are H_kv D
//   elements apart: a box of 64 rows x 128 bytes is one copy, where one
//   bulk copy a row cost ~70 cycles of the SM's copy engine and bounded
//   the bf16 route), with a full and an empty mbarrier a stage, so the
//   MMA warps run out of step with the copies and with one another.
//   Boxes land with the 128-byte swizzle (mma.cuh swz), so the ldmatrix
//   of 8 rows and V's float2 loads hit 32 banks; elements past d, Sq or
//   Sk land as zeros, and keys past Sk are masked. Rows that are not
//   16-byte multiples (or unaligned pointers) are staged by the
//   producer's loads into the same layout instead.
// * Q stays in shared memory; its fragments come by ldmatrix each step
//   (held in registers, they would spill the accumulators at d = 128).
// * Softmax in base 2: scores scaled by d^-0.5 log2(e) (one __fmul_rn),
//   ex2.approx (~2 ulp). Only the diagonal tile and the kv_len tail are
//   masked; under the causal mask the walk stops at the query tile's last
//   row (the skipped tiles are fully masked, and a fully masked tile
//   leaves the running state unchanged bit for bit), a warp skips the
//   tiles past its own last row, and the heaviest query tiles are issued
//   first.
// * Bits depend only on the inputs: no atomics, no split over keys; a
//   row's walk is the same whatever the plan's tile of rows.
// * For the backward (flash_attn_bwd.cu) the kernel can also write each
//   row's log-sum-exp, float32 (B, H, Sq) in natural log: (m + log2 l)
//   ln 2 from the running max m and sum l it keeps anyway (+inf for a
//   row with no key, so the backward's exp gives 0). The output's bits do
//   not depend on whether it is written.
#include "mma.cuh"
#include "tile_f32.cuh"

#include <atomic>

namespace {

using namespace svm;

constexpr float NEG_BIG = -1e30f;  // the reference's NEG_INF
constexpr float LN2 = 0.6931471805599453f;
constexpr int FA_KEYS = 64;        // keys of a key tile
constexpr int FA_MAX_ROWS = 128;   // query rows of a block, at most
constexpr int FA_MAX_STAGES = 3;   // K / V stages in the ring, at most

// 128-byte boxes a staged row takes: d_tiles x 8 elements, at least one
__host__ __device__ constexpr int fa_boxes(int d_tiles, int elem) {
  return d_tiles * elem / 16 > 0 ? d_tiles * elem / 16 : 1;
}

// 1024 bytes to align the tiles, the query tile, the ring of K and V
// tiles, the mbarriers (a full and an empty one a stage, one for Q);
// flash_attn.smem_bytes computes the same
__host__ __device__ constexpr int fa_smem_bytes(int rows, int stages,
                                                int d_tiles, int elem) {
  return 1024 + 128 * fa_boxes(d_tiles, elem) * (rows + 2 * stages * FA_KEYS) +
         8 * (2 * stages + 1);
}

struct FlashArgs {
  CUtensorMap tq, tk, tv;   // (B, S, H, D) boxes of 128 bytes x rows
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;         // (B, H, Sq) natural-log log-sum-exp, or null
  int sq, sk, h, hkv, d, kv_len;
  float scale_log2;   // d^-0.5 log2(e)
  int causal, f32_out;
  int rows, stages;   // the plan
  int q_tiles;
  int tma;            // rows 16-byte aligned: tensor maps, else loads
};

// out[i] = v, rounded once to bf16 unless the output is float32
__device__ __forceinline__ void store_out(void* out, int64_t i, float v,
                                          int f32_out) {
  if (f32_out) static_cast<float*>(out)[i] = v;
  else static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// The producer's loads of rows [row0, row0 + rows) of a head's matrix
// (rows ld elements apart, d elements each) into the swizzled layout of
// `nb` boxes TMA would give: every word written, zero past d or past row
// n. For rows a tensor map cannot take.
template <typename T>
__device__ __forceinline__ void fa_load(uint32_t* s, int rows, int nb,
                                        const T* g, int64_t ld, int d,
                                        int row0, int n, int lane) {
  constexpr int PER = 4 / sizeof(T);   // elements a word
  for (int e = lane; e < rows * nb * 32; e += 32) {
    const int r = e / (nb * 32), w = e % (nb * 32);
    uint32_t v = 0;
    if (row0 + r < n) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = w * PER + i;
        if (c < d) v |= bits(g[(row0 + r) * ld + c]) << (16 * i);
      }
    }
    s[swz(rows, r, w)] = v;
  }
}

// rows / 16 MMA warps and one producer warp; MMA warp w owns query rows
// q0 + 16 w + [0, 16), lane (g, t) = (lane / 4, lane % 4) rows g and
// g + 8 of them. DN: 8-column tiles of the value width (4, 8 or 16).
template <typename T, int DN>
__global__ void __launch_bounds__(2 * FA_MAX_ROWS + 32, 1)
flash_kernel(const __grid_constant__ FlashArgs p) {
  extern __shared__ __align__(1024) unsigned char fsm_raw[];
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int KS = BF16 ? DN / 2 : DN;   // MMA steps over a row's words
  constexpr int NB = fa_boxes(DN, sizeof(T));
  constexpr int BOXW = 128 / sizeof(T);    // elements of a box's row
  constexpr int KV = NB * FA_KEYS * 32;    // words of a K or V tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = p.rows, mwarps = rows / 16;   // producer: warp mwarps
  const int S = p.stages;
  const int bh = blockIdx.x, b = bh / p.h, head = bh % p.h;
  const int kvhead = head / (p.h / p.hkv);
  const int q0 = (p.q_tiles - 1 - blockIdx.y) * rows;   // heaviest first
  uint32_t* sqt = align1024(fsm_raw);         // NB boxes x rows x 32 words
  uint32_t* skv = sqt + NB * rows * 32;       // [S][K | V]
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + S * 2 * KV);
  uint64_t* empty = full + S;
  uint64_t* q_in = empty + S;
  int n_tiles = (p.kv_len + FA_KEYS - 1) / FA_KEYS;
  if (p.causal)
    n_tiles = min(n_tiles, (min(q0 + rows, p.sq) - 1) / FA_KEYS + 1);

  if (threadIdx.x == 0) {
    const int arrivals = p.tma ? 1 : 32;   // lane 0 alone, or every lane
    for (int st = 0; st < S; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(full + st)),
                   "r"(arrivals)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + st)),
                   "r"(mwarps)
                   : "memory");
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(q_in)),
                 "r"(arrivals)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == mwarps) {   // the producer
    if (p.tma) {
      if (lane == 0) {
        mbar_arrive_expect_tx(q_in, NB * rows * 128);
        for (int c = 0; c < NB; ++c)
          tma_tile(sqt + c * rows * 32, &p.tq, c * BOXW, head, q0, b, q_in);
        for (int i = 0; i < n_tiles; ++i) {
          const int st = i % S, round = i / S;
          if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
          uint32_t* kt = skv + st * 2 * KV;
          mbar_arrive_expect_tx(full + st, 2 * KV * 4);
          for (int c = 0; c < NB; ++c) {
            tma_tile(kt + c * FA_KEYS * 32, &p.tk, c * BOXW, kvhead,
                     i * FA_KEYS, b, full + st);
            tma_tile(kt + KV + c * FA_KEYS * 32, &p.tv, c * BOXW, kvhead,
                     i * FA_KEYS, b, full + st);
          }
        }
      }
      return;
    }
    const int64_t q_ld = (int64_t)p.h * p.d, kv_ld = (int64_t)p.hkv * p.d;
    const T* qb = static_cast<const T*>(p.q) +
                  ((int64_t)b * p.sq * p.h + head) * p.d;
    const T* kb = static_cast<const T*>(p.k) +
                  ((int64_t)b * p.sk * p.hkv + kvhead) * p.d;
    const T* vb = static_cast<const T*>(p.v) +
                  ((int64_t)b * p.sk * p.hkv + kvhead) * p.d;
    fa_load(sqt, rows, NB, qb, q_ld, p.d, q0, p.sq, lane);
    mbar_arrive(q_in);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % S, round = i / S;
      if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
      uint32_t* kt = skv + st * 2 * KV;
      fa_load(kt, FA_KEYS, NB, kb, kv_ld, p.d, i * FA_KEYS, p.sk, lane);
      fa_load(kt + KV, FA_KEYS, NB, vb, kv_ld, p.d, i * FA_KEYS, p.sk, lane);
      mbar_arrive(full + st);
    }
    return;
  }

  const int g = lane / 4, t = lane % 4, qq = lane / 8, rr = lane % 8;
  const int r0 = q0 + warp * 16;   // the warp's first query row
  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  // this lane's ldmatrix rows: A (Q rows 16 warp + (qq & 1) * 8 + rr,
  // words (qq >> 1) * 4 of a step), B (K rows (qq >> 1) * 8 + rr of a
  // 16-key pair of tiles, words (qq & 1) * 4)
  const int ra = warp * 16 + rr + (qq & 1) * 8;
  const int rb = (qq >> 1) * 8 + rr;
  mbar_wait(q_in, 0);
  const bool rows_live = r0 < p.sq;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % S, k0 = i * FA_KEYS;
    mbar_wait(full + st, (i / S) & 1);
    if (!rows_live || (p.causal && k0 > r0 + 15)) {   // nothing to add
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      continue;
    }
    const uint32_t* kt = skv + st * 2 * KV;
    const uint32_t* vt = kt + KV;

    // ---- scores: s[j] = the 16 x 8 tile of keys k0 + 8 j
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sqt + swz(rows, ra, ks * 8 + (qq >> 1) * 4));
      if constexpr (BF16) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4];
          ldsm_x4(bf, kt + swz(FA_KEYS, jp * 16 + rb, ks * 8 + (qq & 1) * 4));
          mma_bf16(s[2 * jp], a, bf);
          mma_bf16(s[2 * jp + 1], a, bf + 2);
        }
      } else {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_trunc(a[e], ah[e], al[e]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bf[4], bh[4], bl[4];
          ldsm_x4(bf, kt + swz(FA_KEYS, jp * 16 + rb, ks * 8 + (qq & 1) * 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_trunc(bf[e], bh[e], bl[e]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* c = s[2 * jp + h];
            mma_tf32(c, al, bh + 2 * h);
            mma_tf32(c, ah, bl + 2 * h);
            mma_tf32(c, ah, bh + 2 * h);
          }
        }
      }
    }
    // ---- online softmax, base 2; rows g (h = 0) and g + 8 (h = 1)
    const bool masked = (p.causal && k0 + FA_KEYS - 1 > r0) ||
                        k0 + FA_KEYS > p.kv_len;
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], p.scale_log2);
        if (masked) {
          const int row = r0 + g + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if ((p.causal && key > row) || key >= p.kv_len) x = NEG_BIG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(__fsub_rn(m[h], m_new));
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ex2(__fsub_rn(s[j][e], m[e >> 1]));
        s[j][e] = pv;
        sum[e >> 1] = __fadd_rn(sum[e >> 1], pv);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), sum[h]);
    }
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = __fmul_rn(o[j][e], corr[e >> 1]);

    // ---- o += P V
    if constexpr (BF16) {
      // lane's ldmatrix.trans rows: keys (qq & 1) * 8 + rr of a 16-key
      // step, columns (qq >> 1) * 8 of a pair of 8-column tiles
      const int rv = (qq & 1) * 8 + rr;
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* c = s[2 * k16 + (e >> 1)] + 2 * (e & 1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(c[0], c[1]);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              __fsub_rn(c[0], __low2float(hi)),
              __fsub_rn(c[1], __high2float(hi)));
          ph[e] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[e] = *reinterpret_cast<const uint32_t*>(&lo);
        }
#pragma unroll
        for (int jp = 0; jp < DN / 2; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vt + swz(FA_KEYS, k16 * 16 + rv,
                                 jp * 8 + (qq >> 1) * 4));
          mma_bf16(o[2 * jp], pl, bf);
          mma_bf16(o[2 * jp], ph, bf);
          mma_bf16(o[2 * jp + 1], pl, bf + 2);
          mma_bf16(o[2 * jp + 1], ph, bf + 2);
        }
      }
    } else {
      // step j takes keys k0 + 8 j + (0, 2, 4, 6, 1, 3, 5, 7): A's words
      // t, t + 4 are s[j]'s columns 2t, 2t + 1
      const float* vf = reinterpret_cast<const float*>(vt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t a[4], ah[4], al[4];
        a[0] = __float_as_uint(s[j][0]);
        a[1] = __float_as_uint(s[j][2]);
        a[2] = __float_as_uint(s[j][1]);
        a[3] = __float_as_uint(s[j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_trunc(a[e], ah[e], al[e]);
#pragma unroll
        for (int jp = 0; jp < DN / 2; ++jp) {
          // tile 2 jp: columns 16 jp + 2 g; tile 2 jp + 1: 16 jp + 2 g + 1
          const float2 x0 = *reinterpret_cast<const float2*>(
              vf + swz(FA_KEYS, 8 * j + 2 * t, 16 * jp + 2 * g));
          const float2 x1 = *reinterpret_cast<const float2*>(
              vf + swz(FA_KEYS, 8 * j + 2 * t + 1, 16 * jp + 2 * g));
          uint32_t bh[4], bl[4];
          split_tf32_trunc(__float_as_uint(x0.x), bh[0], bl[0]);
          split_tf32_trunc(__float_as_uint(x1.x), bh[1], bl[1]);
          split_tf32_trunc(__float_as_uint(x0.y), bh[2], bl[2]);
          split_tf32_trunc(__float_as_uint(x1.y), bh[3], bl[3]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* c = o[2 * jp + h];
            mma_tf32(c, al, bh + 2 * h);
            mma_tf32(c, ah, bl + 2 * h);
            mma_tf32(c, ah, bh + 2 * h);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  // ---- out = o / max(l, 1e-20), rounded once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= p.sq) continue;
    if (p.lse != nullptr && t == 0)   // the quad's lanes hold the same m, l
      p.lse[((int64_t)b * p.h + head) * p.sq + row] =
          l[h] > 0.f ? __fmul_rn(__fadd_rn(m[h], log2f(l[h])), LN2)
                     : __int_as_float(0x7f800000);
    const float den = fmaxf(l[h], 1e-20f);
    const int64_t base = ((int64_t)b * p.sq + row) * p.h * p.d +
                         (int64_t)head * p.d;
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // bf16: tile j's columns 8 j + 2 t + e; float32: tile pair
        // jp = j / 2, column 16 jp + 4 t + 2 e + j % 2
        const int c = BF16 ? 8 * j + 2 * t + e
                           : 16 * (j / 2) + 4 * t + 2 * e + (j & 1);
        if (c < p.d)
          store_out(p.out, base + c, __fdiv_rn(o[j][2 * h + e], den),
                    p.f32_out);
      }
  }
}

// A plan flash_attn.flash_plan can make, with the shared memory it takes.
bool flash_plan_ok(int rows, int stages, int d_tiles, int d, int elem,
                   int smem) {
  const int want = d <= 32 ? 4 : d <= 64 ? 8 : 16;
  return (rows == 64 || rows == FA_MAX_ROWS) && stages >= 2 &&
         stages <= FA_MAX_STAGES && d_tiles == want &&
         smem == fa_smem_bytes(rows, stages, d_tiles, elem);
}

template <typename T, int DN>
int flash_launch(const FlashArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  auto kern = flash_kernel<T, DN>;
  if (const int e = f32tile::allow_max_smem(kern, allowed)) return e;
  kern<<<grid, 2 * a.rows + 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_route(const FlashArgs& a, int d_tiles, dim3 grid, int smem,
                cudaStream_t s) {
  if (d_tiles == 4) return flash_launch<T, 4>(a, grid, smem, s);
  if (d_tiles == 8) return flash_launch<T, 8>(a, grid, smem, s);
  return flash_launch<T, 16>(a, grid, smem, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor map of a (b, s, heads, d) tensor: boxes of 128 bytes of a
// row (zero past d) x `rows` positions of one head
int head_map(CUtensorMap* map, const void* base, bool bf16, int b, int s,
             int heads, int d, int rows) {
  const cuuint64_t e = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {d * e, heads * d * e, s * heads * d * e};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), 1, (cuuint32_t)rows, 1};
  return tmap_4d(map, base, bf16, dims, strides, box);
}

}  // namespace

extern "C" {

// bf16_in: q/k/v are bfloat16 (else float32); out is of their type, or
// float32 under f32_out. Needs d <= 128, h % hkv == 0, 1 <= kv_len <= sk
// (the wrapper checks); scale_log2 = d^-0.5 log2(e); the plan of
// flash_attn.flash_plan: query rows a block, ring stages, 8-column tiles
// of the value width, shared memory. lse, when not null, receives each
// row's log-sum-exp (float32, (b, h, sq), natural log).
int svm_flash_attention(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int sq, int sk, int h,
                        int hkv, int d, int kv_len, float scale_log2,
                        int causal,
                        int bf16_in, int f32_out, int rows, int stages,
                        int d_tiles, int smem, void* stream) {
  const int elem = bf16_in ? 2 : 4;
  if (!flash_plan_ok(rows, stages, d_tiles, d, elem, smem) || d > 128 ||
      hkv < 1 || h % hkv != 0 || kv_len < 1 || kv_len > sk)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  a.sq = sq;
  a.sk = sk;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.kv_len = kv_len;
  a.scale_log2 = scale_log2;
  a.causal = causal;
  a.f32_out = bf16_in ? f32_out : 1;
  a.rows = rows;
  a.stages = stages;
  a.q_tiles = (sq + rows - 1) / rows;
  a.tma = (d * elem) % 16 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v);
  if (a.tma) {
    const bool bf = bf16_in != 0;
    if (const int e = head_map(&a.tq, q, bf, b, sq, h, d, rows)) return e;
    if (const int e = head_map(&a.tk, k, bf, b, sk, hkv, d, FA_KEYS))
      return e;
    if (const int e = head_map(&a.tv, v, bf, b, sk, hkv, d, FA_KEYS))
      return e;
  }
  const dim3 grid(b * h, a.q_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_in ? flash_route<__nv_bfloat16>(a, d_tiles, grid, smem, s)
                 : flash_route<float>(a, d_tiles, grid, smem, s);
}

}  // extern "C"
