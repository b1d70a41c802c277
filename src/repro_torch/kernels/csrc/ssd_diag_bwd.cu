// ssd_diag_bwd: the gradient of ssd_diag (ssd_diag.cu), the intra-chunk
// term of the SSD (Mamba-2) scan.
//
// No Pallas counterpart: the reference trains through `ssd_chunked`
// (src/repro/models/mamba2.py:88) and takes its gradient by XLA's
// autodiff. Per (chunk, head), with S = C B^T shared by the heads,
// L[q, k] = exp(cs_q - cs_k) for k <= q (else 0), W = S o L o dt_k and
// the forward's Y = W x, given dY:
//   dW  = dY x^T masked to k <= q      dX  = W^T dY
//   G   = dW o W                        dcs = rowsum(G) - colsum(G)
//   ddt_k = sum_q dW[q, k] S[q, k] L[q, k]   (never colsum(G) / dt)
//   dS_h  = dW o L o dt_k               dC = sum_h dS_h B, dB = sum_h dS_h^T C
// for C, B (BC, Q, N), x, dY (BC, H, Q, P), dt, cs (BC, H, Q), all
// float32.
//
// Bound on the H100: reading the operands and writing the gradients once
// (210 MB at zamba2_1p2b's BC 16, H 64, Q 256, N 64, P 64: 0.063 ms);
// the least work, dW and dX a head and S, dC, dB a chunk (dS summed over
// the heads first), takes 0.054 ms as 3xTF32, so bytes bound it. The
// first version ran five products a (head, pair of tiles) as float32
// FMAs on the CUDA cores, S, dC and dB again for every head, and added
// each pair's dx, dC and dB into device memory (2.43 ms there). Design
// (ssd_diag.bwd_plan is the launch plan; the host side below refuses any
// other):
//
// * Every product on the tensor cores as 3xTF32 mma.sync (each operand
//   split into a TF32 high part and the rest, lo*hi, hi*lo, hi*hi summed
//   in float32). The decay is ex2.approx of (cs_q - cs_k) log2(e), taken
//   only where k <= q (above the diagonal the difference is positive and
//   may overflow; the exp is never formed there, so no inf meets a 0).
// * (1) A block of sixteen warps owns (chunk, group of G heads) and
//   walks the key tiles j of 64 keys and, for each, the query tiles i >=
//   j. For a pair (i, j) it computes S_ij = C_i B_j^T once (N in chunks of
//   64), into registers, then for each head of the group: dW = dY_i x_j^T
//   (warp (rw, cw): rows 16 rw, keys 16 cw of the 64 x 64 tile, the same
//   warp tile as S), W, G, the ddt terms and dS_h in registers, and sums
//   dS_h over the group's heads in registers. W goes to shared memory
//   (in the place of x_j, which dW no longer needs) for dX_j += W^T dY_i
//   (warp (rw, cw): keys 16 rw, a quarter cw of P's columns), accumulated
//   in shared memory over the query tiles, one tile a head. Row sums of G
//   reduce over the quad by shuffles and over the four column warps
//   through shared memory, column sums of G and of the ddt terms over the
//   row warps; all in a fixed order. What bounds the walk is shared
//   memory: each warp reads its MMA fragments (ldmatrix, float2 loads) for
//   every head, ~3,000 wavefronts a head against ~1,500 MMAs. On the H100
//   a build with every MMA cut still took 0.26 ms of the 0.49 at
//   zamba2's chunk, and sixteen warps of 16 x 16 tiles ran 2 % faster
//   than eight of 16 x 32 (kernel_times.py --lm-sweep). When key tile j's
//   walk ends, dX_j, ddt and dcs of its 64 positions are whole and each is
//   written once. Each pair's group sum of dS goes to scratch once, in the
//   warps' fragment order. Nothing is read back from device memory.
// * (2) A block per (chunk, tile t, dC or dB) sums the groups' dS of
//   each pair in group order and takes dC_t = sum_{j <= t} dS_tj B_j or
//   dB_t = sum_{i >= t} dS_it^T C_i on the tensor cores: two products a
//   (chunk, pair), not two a head. No atomics: two calls give the same
//   bits, and dX, ddt and dcs of a head do not depend on the plan.
// * Staging: a ring of two stages, filled one stage ahead by 16-byte
//   cp.async from every thread: a stage holds
//   either C_i's and B_j's 64-column chunk (for S) or a head's x_j and
//   dY_i rows with its cs of both tiles and dt of the keys. Rows are
//   padded to a stride of 4 (mod 32) words, so ldmatrix's eight rows and
//   the float2 loads of B fragments hit 32 different banks. Elements past
//   N, P or Q land as zeros; rows that are not 16-byte multiples (or
//   unaligned pointers) are staged by loads into the same layout.
// * TF32 products whose A operand is read from a C fragment or a staged
//   tile (W^T dY, dS B, dS^T C) run their 8 depth rows in the order 0, 2,
//   4, 6, 1, 3, 5, 7, as flash_attn.cu's P V does: A is then two adjacent
//   columns and B two float2 loads a pair of 8-column tiles. The tensor
//   cores truncate each float32 sum toward zero, so the sums over tiles
//   (dX over the query tiles, dC and dB over the pairs) add each tile's
//   products rounded to nearest.
#include "mma.cuh"
#include "tile_f32.cuh"

#include <atomic>

namespace {

using namespace svm;

constexpr int SB_T = 64;           // rows / keys of a tile
constexpr int SB_WARPS = 16;       // the walk: a 4 x 4 grid of 16 x 16 tiles
constexpr int SB_THREADS = 32 * SB_WARPS;
constexpr int DC_THREADS = 256;    // launch (2): eight warps
constexpr int SB_LS = 68;          // row stride (floats) of a 64-wide tile
constexpr int SB_DS = 72;          // of the dS tile of launch (2)
constexpr int SB_MAX_SMEM = 232448;
constexpr int SB_RING = 2;         // stages of the walk's ring
constexpr float LOG2E = 1.4426950408889634f;

// columns of x and dY a stage holds: P rounded up to 64 or 128
__host__ __device__ constexpr int sb_pw(int p) { return p <= 64 ? 64 : 128; }
// floats of a ring stage: x and dY tiles (or C and B chunks) and cs / dt
__host__ __device__ constexpr int sb_slot(int p) {
  return 2 * SB_T * (sb_pw(p) + 4) + 3 * SB_T;
}
// shared memory of launch (1) (ssd_diag.bwd_smem_bytes): the ring, the
// group's dX accumulators (64 x PW floats a head), the row sums of G
// over the chunk (Q rounded up to 64 a head), the column sums of G and
// ddt of a key tile (64 a head) and the reduction scratch (4 x 64 floats
// each for the row sums of G and the column sums of G and ddt)
__host__ __device__ constexpr int sb_smem(int q, int p, int group) {
  return 4 * (SB_RING * sb_slot(p) + group * SB_T * sb_pw(p) +
              group * ((q + SB_T - 1) / SB_T) * SB_T + 2 * group * SB_T +
              12 * SB_T);
}
// launch (2) (ssd_diag.bwd_dcdb_smem_bytes): a dS tile and a C or B tile
// of N rounded up to 64 columns
__host__ __device__ constexpr int sb_dcdb_smem(int n) {
  return 4 * (SB_T * SB_DS + SB_T * ((n + SB_T - 1) / SB_T * SB_T + 4));
}

struct SsdBwdArgs {
  const float* c;
  const float* b;
  const float* x;
  const float* dt;
  const float* cs;
  const float* dy;
  float* part;      // (groups, BC, pairs, 4096): each pair's group sum of dS
  float* dc;        // (BC, Q, N)
  float* db;
  float* dx;        // (BC, H, Q, P)
  float* ddt;       // (BC, H, Q)
  float* dcs;
  int bc, h, q, n, p, group, groups;
  int tiles, pairs;
  int async;        // rows staged by cp.async (else loads)
};

// Index of pair (i, j), i >= j, in the walk's order: key tile j, then its
// query tiles i >= j.
__device__ __forceinline__ int sb_pair(int i, int j, int tiles) {
  return j * tiles - j * (j - 1) / 2 + (i - j);
}

// 64 rows (from row0, zero at or past nrows) of columns [col0, col0 +
// width) of a row-major matrix with rows of `len` floats into s[r * ls +
// c]; zero past len. By 16-byte cp.async under `async` (len a multiple
// of 4, aligned), else by loads; NT threads.
template <int NT>
__device__ __forceinline__ void sb_stage(float* s, int ls, const float* g,
                                         int len, int row0, int nrows,
                                         int col0, int width, int async) {
  if (async) {
    const int ch = width / 4;
    for (int e = threadIdx.x; e < SB_T * ch; e += NT) {
      const int r = e / ch, c = 4 * (e % ch);
      const bool valid = row0 + r < nrows && col0 + c < len;
      f32tile::cp_async<16>(
          s + r * ls + c,
          valid ? g + (int64_t)(row0 + r) * len + col0 + c : g, valid);
    }
    return;
  }
  for (int e = threadIdx.x; e < SB_T * width; e += NT) {
    const int r = e / width, c = e % width;
    s[r * ls + c] = row0 + r < nrows && col0 + c < len
                        ? g[(int64_t)(row0 + r) * len + col0 + c]
                        : 0.f;
  }
}

// 64 floats of a run from row0 (zero at or past n)
__device__ __forceinline__ void sb_run(float* s, const float* g, int row0,
                                       int n) {
  for (int e = threadIdx.x; e < SB_T; e += SB_THREADS) {
    const bool valid = row0 + e < n;
    f32tile::cp_async<4>(s + e, valid ? g + row0 + e : g, valid);
  }
}

// acc[j] += A B^T, 3xTF32 over `steps` MMA steps of 8 words: A the 16
// rows of `a` from arow, B the NP pairs of 8-row tiles of `bt` from brow
// (both ldmatrix, row stride `ls`); the small products summed apart and
// added at the end
template <int NP>
__device__ __forceinline__ void sb_nt(float (&acc)[2 * NP][4], const float* a,
                                      const float* bt, int ls, int steps,
                                      int arow, int brow, int lane) {
  const int qq = lane / 8, rr = lane % 8;
  const uint32_t* au = reinterpret_cast<const uint32_t*>(a) +
                       (arow + rr + (qq & 1) * 8) * ls + (qq >> 1) * 4;
  const uint32_t* bu = reinterpret_cast<const uint32_t*>(bt) +
                       (brow + (qq >> 1) * 8 + rr) * ls + (qq & 1) * 4;
  float lo[2 * NP][4];
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[j][e] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t x[4], xh[4], xl[4];
    ldsm_x4(x, au + ks * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32_trunc(x[e], xh[e], xl[e]);
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      uint32_t y[4], yh[4], yl[4];
      ldsm_x4(y, bu + jp * 16 * ls + ks * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_trunc(y[e], yh[e], yl[e]);
      mma_3xtf32_2(acc[2 * jp], lo[2 * jp], xh, xl, yh, yl);
      mma_3xtf32_2(acc[2 * jp + 1], lo[2 * jp + 1], xh, xl, yh + 2, yl + 2);
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], lo[j][e]);
}

// acc[j] += X B, 3xTF32 over depth rows [8 kk, 8 kk + 8): xa the A
// fragment of step kk in the permuted order (words t, t + 4 = depth rows
// 2t, 2t + 1 of the step), B rows from `bt` (stride ls) at columns col0 +
// 16 jp + 2 g (tile 2 jp) and + 1 (tile 2 jp + 1), NJ tiles. The small
// products go to lo (the caller adds it to acc), or to acc as well where
// lo is acc.
template <int NJ>
__device__ __forceinline__ void sb_step(float (&acc)[NJ][4],
                                        float (&lo)[NJ][4],
                                        const uint32_t (&xa)[4],
                                        const float* bt, int ls, int kk,
                                        int col0, int lane) {
  const int g = lane / 4, t = lane % 4;
  uint32_t xh[4], xl[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_trunc(xa[e], xh[e], xl[e]);
  const float* r0 = bt + (8 * kk + 2 * t) * ls + col0 + 2 * g;
  const float* r1 = r0 + ls;
#pragma unroll
  for (int jp = 0; jp < NJ / 2; ++jp) {
    const float2 u0 = *reinterpret_cast<const float2*>(r0 + 16 * jp);
    const float2 u1 = *reinterpret_cast<const float2*>(r1 + 16 * jp);
    uint32_t yh[4], yl[4];
    split_tf32_trunc(__float_as_uint(u0.x), yh[0], yl[0]);
    split_tf32_trunc(__float_as_uint(u1.x), yh[1], yl[1]);
    split_tf32_trunc(__float_as_uint(u0.y), yh[2], yl[2]);
    split_tf32_trunc(__float_as_uint(u1.y), yh[3], yl[3]);
    mma_3xtf32_2(acc[2 * jp], lo[2 * jp], xh, xl, yh, yl);
    mma_3xtf32_2(acc[2 * jp + 1], lo[2 * jp + 1], xh, xl, yh + 2, yl + 2);
  }
}

// Row `row` (< nrows) of an accumulator sb_step filled: tiles 2 jp and
// 2 jp + 1 hold columns col0 + 16 jp + 4 t + (0, 2) and (1, 3); hf picks
// rows g (0) or g + 8 (1). One float4 where the row allows it.
template <int NJ>
__device__ __forceinline__ void sb_store_row(float* dst,
                                             const float (&acc)[NJ][4],
                                             int hf, int col0, int len,
                                             bool vec, int t) {
#pragma unroll
  for (int jp = 0; jp < NJ / 2; ++jp) {
    const int c = col0 + 16 * jp + 4 * t;
    const float v[4] = {acc[2 * jp][2 * hf], acc[2 * jp + 1][2 * hf],
                        acc[2 * jp][2 * hf + 1], acc[2 * jp + 1][2 * hf + 1]};
    if (vec && c + 3 < len) {
      *reinterpret_cast<float4*>(dst + c) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < len) dst[c + e] = v[e];
    }
  }
}

// (1) the walk of one (chunk, head group); PW: columns of x a stage holds.
// Warp (rw, cw) = (w % 4, w / 4) owns rows 16 rw and keys 16 cw of each
// 64 x 64 tile of S, dW and dS; for dX, keys 16 rw and columns PW / 4 cw.
template <int PW>
__global__ void __launch_bounds__(SB_THREADS, 1)
ssd_bwd_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float sb_sm[];
  constexpr int PS = PW + 4;             // row stride of x and dY
  constexpr int SLOT = 2 * SB_T * PS + 3 * SB_T;
  constexpr int NJX = PW / 32;           // 8-column tiles of a warp's dX
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp % 4, cw = warp / 4;
  const int Q = a.q, N = a.n, P = a.p, T = a.tiles;
  // block -> (chunk, group): the full groups of every chunk first
  const int chunk = blockIdx.x % a.bc, gi = blockIdx.x / a.bc;
  const int h0 = gi * a.group, hn = min(a.group, a.h - h0);
  const int nch = (N + SB_T - 1) / SB_T;    // S stages of a pair
  const int per_pair = nch + hn;
  const int n = a.pairs * per_pair;
  const int qp = T * SB_T;
  float* ring = sb_sm;
  float* dxacc = ring + SB_RING * SLOT;           // [group][16 warps][NJX][32][4]
  float* rowg = dxacc + a.group * SB_T * PW;   // [group][qp]
  float* colg = rowg + a.group * qp;        // [group][64]
  float* ddts = colg + a.group * SB_T;      // [group][64]
  float* red_row = ddts + a.group * SB_T;   // [4 cw][64]
  float* red_g = red_row + 4 * SB_T;        // [4 rw][64]
  float* red_d = red_g + 4 * SB_T;          // [4 rw][64]
  const float* cb = a.c + (int64_t)chunk * Q * N;
  const float* bb = a.b + (int64_t)chunk * Q * N;

  // stage `it` of the walk: pair (j, i) and its sub-step
  auto decode = [&](int it, int& j, int& i, int& sub) {
    int pr = it / per_pair;
    sub = it % per_pair;
    j = 0;
    while (pr >= T - j) {
      pr -= T - j;
      ++j;
    }
    i = j + pr;
  };
  auto issue = [&](int it) {
    int j, i, sub;
    decode(it, j, i, sub);
    float* st = ring + (it % SB_RING) * SLOT;
    const int q0 = i * SB_T, k0 = j * SB_T;
    if (sub < nch) {   // C_i's and B_j's columns [64 sub, 64 sub + 64)
      sb_stage<SB_THREADS>(st, SB_LS, cb, N, q0, Q, sub * SB_T, SB_T,
                           a.async);
      sb_stage<SB_THREADS>(st + SB_T * SB_LS, SB_LS, bb, N, k0, Q,
                           sub * SB_T, SB_T, a.async);
      return;
    }
    const int64_t ch = (int64_t)chunk * a.h + h0 + (sub - nch);
    sb_stage<SB_THREADS>(st, PS, a.x + ch * Q * P, P, k0, Q, 0, PW, a.async);
    sb_stage<SB_THREADS>(st + SB_T * PS, PS, a.dy + ch * Q * P, P, q0, Q, 0,
                         PW, a.async);
    float* v = st + 2 * SB_T * PS;   // cs of the query rows, cs / dt of keys
    sb_run(v, a.cs + ch * Q, q0, Q);
    sb_run(v + SB_T, a.cs + ch * Q, k0, Q);
    sb_run(v + 2 * SB_T, a.dt + ch * Q, k0, Q);
  };

  for (int e = threadIdx.x; e < a.group * qp; e += SB_THREADS) rowg[e] = 0.f;
  if (n > 0) issue(0);
  f32tile::cp_async_commit();

  float sc[2][4], dsum[2][4];   // S and the group's dS: rows 16 rw + g
                                // (+8), keys 16 cw + 8 jj + 2 t (+1)
  for (int it = 0; it < n; ++it) {
    f32tile::cp_async_wait<0>();
    __syncthreads();   // stage it landed; stage it - 1 is free
    if (it + 1 < n) issue(it + 1);
    f32tile::cp_async_commit();
    int j, i, sub;
    decode(it, j, i, sub);
    float* st = ring + (it % SB_RING) * SLOT;
    const int q0 = i * SB_T, k0 = j * SB_T;
    if (sub < nch) {   // S_ij += C_i B_j^T over 64 columns of N
      if (sub == 0) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
      }
      sb_nt<1>(sc, st, st + SB_T * SB_LS, SB_LS, 8, 16 * rw, 16 * cw, lane);
      continue;
    }
    const int u = sub - nch;
    float* xs = st;
    const float* dys = st + SB_T * PS;
    const float* csq = dys + SB_T * PS;
    const float* csk = csq + SB_T;
    const float* dtk = csk + SB_T;

    // ---- dW = dY_i x_j^T on the warp's tile, then W, G, dd, dS in place
    float w[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[jj][e] = 0.f;
    sb_nt<1>(w, dys, xs, PS, PW / 8, 16 * rw, 16 * cw, lane);
    float rsum[2] = {0.f, 0.f}, cg[2][2], cd[2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        cg[jj][c] = 0.f;
        cd[jj][c] = 0.f;
      }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 16 * rw + g + 8 * (e >> 1);
        const int kl = 16 * cw + 8 * jj + 2 * t + (e & 1);
        const float dw = w[jj][e];
        float wv = 0.f, gg = 0.f, dd = 0.f, ds = 0.f;
        if (k0 + kl <= q0 + ql && q0 + ql < Q) {
          const float l = ex2(__fmul_rn(__fsub_rn(csq[ql], csk[kl]), LOG2E));
          wv = __fmul_rn(__fmul_rn(sc[jj][e], l), dtk[kl]);
          gg = __fmul_rn(dw, wv);
          dd = __fmul_rn(__fmul_rn(dw, sc[jj][e]), l);
          ds = __fmul_rn(__fmul_rn(dw, l), dtk[kl]);
        }
        w[jj][e] = wv;
        dsum[jj][e] = u == 0 ? ds : __fadd_rn(dsum[jj][e], ds);
        rsum[e >> 1] = __fadd_rn(rsum[e >> 1], gg);
        cg[jj][e & 1] = __fadd_rn(cg[jj][e & 1], gg);
        cd[jj][e & 1] = __fadd_rn(cd[jj][e & 1], dd);
      }
    // the warp's row sums over its 16 keys (the quad), column sums over
    // its 16 rows (the eight row lanes)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rsum[hf] = __fadd_rn(rsum[hf], __shfl_xor_sync(0xffffffffu, rsum[hf], 1));
      rsum[hf] = __fadd_rn(rsum[hf], __shfl_xor_sync(0xffffffffu, rsum[hf], 2));
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cg[jj][c] = __fadd_rn(cg[jj][c],
                                __shfl_xor_sync(0xffffffffu, cg[jj][c], off));
          cd[jj][c] = __fadd_rn(cd[jj][c],
                                __shfl_xor_sync(0xffffffffu, cd[jj][c], off));
        }
    if (t == 0) {
      red_row[cw * SB_T + 16 * rw + g] = rsum[0];
      red_row[cw * SB_T + 16 * rw + g + 8] = rsum[1];
    }
    if (g == 0) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          red_g[rw * SB_T + 16 * cw + 8 * jj + 2 * t + c] = cg[jj][c];
          red_d[rw * SB_T + 16 * cw + 8 * jj + 2 * t + c] = cd[jj][c];
        }
    }
    __syncthreads();   // every warp is done with x_j; the partials are in
    // W (rows q, keys k) in place of x_j
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xs[(16 * rw + g + 8 * (e >> 1)) * SB_LS + 16 * cw + 8 * jj + 2 * t +
           (e & 1)] = w[jj][e];
    __syncthreads();   // W is whole
    // ---- the partial sums, each in a fixed order
    if (threadIdx.x < SB_T) {
      const int r = threadIdx.x;
      if (q0 + r < Q)
        rowg[u * qp + q0 + r] = __fadd_rn(
            rowg[u * qp + q0 + r],
            __fadd_rn(__fadd_rn(__fadd_rn(red_row[r], red_row[SB_T + r]),
                                red_row[2 * SB_T + r]),
                      red_row[3 * SB_T + r]));
    } else if (threadIdx.x < 3 * SB_T) {
      const int c = threadIdx.x % SB_T;
      const float* red = threadIdx.x < 2 * SB_T ? red_g : red_d;
      float* acc = (threadIdx.x < 2 * SB_T ? colg : ddts) + u * SB_T + c;
      const float v = __fadd_rn(
          __fadd_rn(__fadd_rn(red[c], red[SB_T + c]), red[2 * SB_T + c]),
          red[3 * SB_T + c]);
      *acc = i == j ? v : __fadd_rn(*acc, v);
    }
    // ---- dX_j += W^T dY_i: keys 16 rw, columns PW / 4 cw
    {
      float* mine = dxacc + ((u * SB_WARPS + warp) * NJX) * 128 + lane * 4;
      float acc[NJX][4], lo[NJX][4];
#pragma unroll
      for (int jt = 0; jt < NJX; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[jt][e] = 0.f;
          lo[jt][e] = 0.f;
        }
#pragma unroll 4
      for (int kk = 0; kk < 8; ++kk) {
        // A = W^T: keys 16 rw + g (+8), queries 8 kk + 2 t (+1)
        const float* w0 = xs + (8 * kk + 2 * t) * SB_LS + 16 * rw + g;
        const uint32_t xa[4] = {__float_as_uint(w0[0]),
                                __float_as_uint(w0[8]),
                                __float_as_uint(w0[SB_LS]),
                                __float_as_uint(w0[SB_LS + 8])};
        sb_step<NJX>(acc, lo, xa, dys, PS, kk, cw * (PW / 4), lane);
      }
      // the tile's sum added rounded to nearest (the tensor cores truncate
      // each float32 sum toward zero)
#pragma unroll
      for (int jt = 0; jt < NJX; ++jt) {
        float4 v = make_float4(
            __fadd_rn(acc[jt][0], lo[jt][0]), __fadd_rn(acc[jt][1], lo[jt][1]),
            __fadd_rn(acc[jt][2], lo[jt][2]), __fadd_rn(acc[jt][3], lo[jt][3]));
        if (i != j) {
          const float4 o = *reinterpret_cast<const float4*>(mine + jt * 128);
          v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                          __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
        }
        *reinterpret_cast<float4*>(mine + jt * 128) = v;
      }
    }
    if (u == hn - 1) {   // the pair's group sum of dS, in fragment order
      float* dst = a.part +
                   (((int64_t)gi * a.bc + chunk) * a.pairs + sb_pair(i, j, T)) *
                       (SB_T * SB_T) +
                   warp * 256 + lane * 4;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        *reinterpret_cast<float4*>(dst + jj * 128) =
            make_float4(dsum[jj][0], dsum[jj][1], dsum[jj][2], dsum[jj][3]);
    }
    if (i < T - 1 || u < hn - 1) continue;
    // ---- key tile j's walk is done: dX, ddt and dcs of its positions
    __syncthreads();
    const bool vec = a.async != 0;
    for (int uu = 0; uu < hn; ++uu) {
      const int64_t chh = (int64_t)chunk * a.h + h0 + uu;
      const float* mine =
          dxacc + ((uu * SB_WARPS + warp) * NJX) * 128 + lane * 4;
      float acc[NJX][4];
#pragma unroll
      for (int jt = 0; jt < NJX; ++jt) {
        const float4 v = *reinterpret_cast<const float4*>(mine + jt * 128);
        acc[jt][0] = v.x;
        acc[jt][1] = v.y;
        acc[jt][2] = v.z;
        acc[jt][3] = v.w;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = k0 + 16 * rw + g + 8 * hf;
        if (k < Q)
          sb_store_row<NJX>(a.dx + (chh * Q + k) * P, acc, hf,
                            cw * (PW / 4), P, vec, t);
      }
    }
    for (int e = threadIdx.x; e < hn * SB_T; e += SB_THREADS) {
      const int uu = e / SB_T, c = e % SB_T, k = k0 + c;
      if (k >= Q) continue;
      const int64_t at = ((int64_t)chunk * a.h + h0 + uu) * Q + k;
      a.ddt[at] = ddts[uu * SB_T + c];
      a.dcs[at] = __fsub_rn(rowg[uu * qp + k], colg[uu * SB_T + c]);
    }
  }
  f32tile::cp_async_wait<0>();
}

// (2) dC or dB of tile t of a chunk (a block each): dC_t = sum_{j <= t}
// dS_tj B_j, dB_t
// = sum_{i >= t} dS_it^T C_i, each pair's dS the groups' partials summed
// in group order; warp (rw, nh): rows 16 rw, columns NW / 2 nh
template <int NW>
__global__ void __launch_bounds__(DC_THREADS, 1)
ssd_bwd_dcdb_kernel(const SsdBwdArgs a) {
  extern __shared__ __align__(16) float sb_dm[];
  constexpr int NS = NW + 4;
  constexpr int NJ = NW / 16;              // 8-column tiles of a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp % 4, nh = warp / 4;
  const int Q = a.q, N = a.n, T = a.tiles;
  const int chunk = blockIdx.x / (2 * T), tile = blockIdx.x / 2 % T;
  const int phase = blockIdx.x % 2;   // dC, or dB
  float* sd = sb_dm;               // dS tile (64 x SB_DS)
  float* so = sd + SB_T * SB_DS;   // B_j or C_i (64 x NS)
  const float* cb = a.c + (int64_t)chunk * Q * N;
  const float* bb = a.b + (int64_t)chunk * Q * N;
  const bool vec = a.async != 0;
  // a pair's dS, the groups' partials summed in group order, into sd (rows
  // q, keys k; transposed: rows k). Float4 f of a partial is lane f % 32 of
  // launch (1)'s warp f / 64, its tile f / 32 % 2: rows 16 (w % 4) + g
  // (+8), keys 16 (w / 4) + 8 jj + 2 t (+1)
  auto load_ds = [&](int i, int j, bool transpose) {
    const float* src = a.part +
                       ((int64_t)chunk * a.pairs + sb_pair(i, j, T)) *
                           (SB_T * SB_T);
    const int64_t gstride = (int64_t)a.bc * a.pairs * SB_T * SB_T;
    for (int f = threadIdx.x; f < SB_T * SB_T / 4; f += DC_THREADS) {
      float4 s = *reinterpret_cast<const float4*>(src + 4 * f);
#pragma unroll 4
      for (int gg = 1; gg < a.groups; ++gg) {
        const float4 v =
            *reinterpret_cast<const float4*>(src + gg * gstride + 4 * f);
        s.x = __fadd_rn(s.x, v.x);
        s.y = __fadd_rn(s.y, v.y);
        s.z = __fadd_rn(s.z, v.z);
        s.w = __fadd_rn(s.w, v.w);
      }
      const int w = f / 64, jj = f / 32 % 2, l = f % 32;
      const int r0 = 16 * (w % 4) + l / 4;
      const int c0 = 16 * (w / 4) + 8 * jj + 2 * (l % 4);
      const float vals[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), c = c0 + (e & 1);
        if (transpose)
          sd[c * SB_DS + r] = vals[e];
        else
          sd[r * SB_DS + c] = vals[e];
      }
    }
  };
  float acc[NJ][4];
#pragma unroll
  for (int jt = 0; jt < NJ; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
  const int lo = phase == 0 ? 0 : tile, hi = phase == 0 ? tile : T - 1;
  for (int o = lo; o <= hi; ++o) {
    __syncthreads();   // the last product's reads are done
    if (phase == 0) {
      load_ds(tile, o, false);
      sb_stage<DC_THREADS>(so, NS, bb, N, o * SB_T, Q, 0, NW, false);
    } else {
      load_ds(o, tile, true);
      sb_stage<DC_THREADS>(so, NS, cb, N, o * SB_T, Q, 0, NW, false);
    }
    __syncthreads();
    float part[NJ][4];   // the tile's sum, added rounded to nearest
#pragma unroll
    for (int jt = 0; jt < NJ; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[jt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(
          sd + (16 * rw + g) * SB_DS + 8 * kk + 2 * t);
      const float2 x1 = *reinterpret_cast<const float2*>(
          sd + (16 * rw + g + 8) * SB_DS + 8 * kk + 2 * t);
      const uint32_t xa[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                              __float_as_uint(x0.y), __float_as_uint(x1.y)};
      sb_step<NJ>(part, part, xa, so, NS, kk, nh * (NW / 2), lane);
    }
#pragma unroll
    for (int jt = 0; jt < NJ; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[jt][e] = __fadd_rn(acc[jt][e], part[jt][e]);
  }
  float* out = (phase == 0 ? a.dc : a.db) + (int64_t)chunk * Q * N;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = tile * SB_T + 16 * rw + g + 8 * hf;
    if (r < Q)
      sb_store_row<NJ>(out + (int64_t)r * N, acc, hf, nh * (NW / 2), N,
                       vec, t);
  }
}

template <int PW>
int sb_launch_walk(const SsdBwdArgs& a, int smem, cudaStream_t s) {
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  auto kern = ssd_bwd_kernel<PW>;
  if (const int e = f32tile::allow_max_smem(kern, allowed)) return e;
  kern<<<a.bc * a.groups, SB_THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int sb_launch_dcdb(const SsdBwdArgs& a, cudaStream_t s) {
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  auto kern = ssd_bwd_dcdb_kernel<NW>;
  if (const int e = f32tile::allow_max_smem(kern, allowed)) return e;
  kern<<<a.bc * a.tiles * 2, DC_THREADS, sb_dcdb_smem(NW), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// cmat, bmat (bc, q, n); x, dy (bc, h, q, p); dt, cs (bc, h, q): the
// forward's operands and dY, all float32. Writes dc, db (bc, q, n), dx,
// ddt, dcs; part is a (groups, bc, pairs, 4096) float32 scratch (pairs =
// T (T + 1) / 2 of T = ceil(q / 64) tiles). The plan of
// ssd_diag.bwd_plan: heads a block and the walk's shared memory. Needs
// n <= 256, p <= 128.
int svm_ssd_diag_bwd(const float* cmat, const float* bmat, const float* x,
                     const float* dt, const float* cs, const float* dy,
                     float* part, float* dc, float* db, float* dx,
                     float* ddt, float* dcs, int bc, int h, int q, int n,
                     int p, int group, int smem, void* stream) {
  if (bc < 1 || h < 1 || q < 1 || n < 1 || n > 256 || p < 1 || p > 128 ||
      group < 1 || group > h || smem != sb_smem(q, p, group) ||
      smem > SB_MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdBwdArgs a{};
  a.c = cmat;
  a.b = bmat;
  a.x = x;
  a.dt = dt;
  a.cs = cs;
  a.dy = dy;
  a.part = part;
  a.dc = dc;
  a.db = db;
  a.dx = dx;
  a.ddt = ddt;
  a.dcs = dcs;
  a.bc = bc;
  a.h = h;
  a.q = q;
  a.n = n;
  a.p = p;
  a.group = group;
  a.groups = (h + group - 1) / group;
  a.tiles = (q + SB_T - 1) / SB_T;
  a.pairs = a.tiles * (a.tiles + 1) / 2;
  a.async = n % 4 == 0 && p % 4 == 0 && aligned16(cmat) && aligned16(bmat) &&
            aligned16(x) && aligned16(dy) && aligned16(dc) &&
            aligned16(db) && aligned16(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = p <= 64 ? sb_launch_walk<64>(a, smem, s)
                        : sb_launch_walk<128>(a, smem, s);
  if (e) return e;
  if (n <= 64) return sb_launch_dcdb<64>(a, s);
  if (n <= 128) return sb_launch_dcdb<128>(a, s);
  if (n <= 192) return sb_launch_dcdb<192>(a, s);
  return sb_launch_dcdb<256>(a, s);
}

}  // extern "C"
