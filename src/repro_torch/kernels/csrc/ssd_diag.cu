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
// Bound on the H100: it reads x and writes y once (~106 MB at
// mamba2_780m's BC 16, H 48, Q 256, N 128, P 64: 0.032 ms at 3.35 TB/s);
// its products on the tensor cores, the scores once a chunk and the
// weighted sum once a head, take ~0.020 ms as 3xTF32, so bytes bound it.
// The first version recomputed the chunk's scores C B^T for every head (48
// times; two thirds of a head's work at N = 128, P = 64) with float32
// FMAs on the CUDA cores (0.725 ms). Design (ssd_diag.ssd_plan is the
// launch plan; the host side below refuses any other):
//
// * A block takes (chunk, query tile of 64 rows, group of G heads) and
//   computes its score rows C[tile] B[0 : end of tile]^T once, by 3xTF32
//   mma.sync, into shared memory (float32, up to 256 keys: longer chunks
//   walk windows of 256 keys), then walks its G heads. Eight MMA warps:
//   warp w owns the tile's rows 16 (w % 4) + [0, 16); for the scores the
//   two halves (w / 4) split each 64-key chunk's columns, for the heads
//   they take heads 2i and 2i + 1 of the group in step.
// * For a head, a warp forms its 16 x 64 weight tile of a key chunk in
//   registers from the scores, cs and dt (the reference's product order,
//   k <= q only; the decay exp(cs_q - cs_k) as ex2.approx of the
//   difference times log2(e), ~2 ulp), splits it into TF32 high and low
//   parts and then takes W x by 3xTF32 into a 16 x 64 accumulator, its
//   192 MMAs back to back (P past 64 is walked 64 columns at a time). As in flash_attn.cu, the 8 keys of a step run in
//   the order 0, 2, 4, 6, 1, 3, 5, 7, so the weights are read from the
//   scores as float2 pairs straight into the A fragment, and x's B
//   fragment is two float2 loads a pair of 8-column tiles.
// * One producer warp stages the tile's C rows once, then fills a ring
//   of 2 or 3 stages by TMA through tensor maps (boxes of 64 rows x 128
//   bytes, landing with the 128-byte swizzle of mma.cuh swz, so the
//   ldmatrix of 8 rows and x's float2 loads hit 32 banks; elements past
//   N, P or Q land as zeros): B's 64-row key chunks (128 words of depth a
//   stage), then for each head pair and column chunk its x rows, with cs
//   and dt by bulk copies, so head h + 2's x lands while head h computes.
//   One bulk copy a row, the first design, cost ~70 cycles of the SM's
//   copy engine a row and bounded the kernel. Rows that are not 16-byte
//   multiples (or unaligned pointers) are staged by the producer's loads
//   into the same layout instead.
// * Tile 3 of Q = 256 does four times tile 0's work: the heaviest tiles
//   of every chunk and group go first (longest first over the whole
//   grid; keeping a (chunk, group)'s tiles adjacent, so that re-read x
//   rows hit L2, ran 18-37 % slower at 8-16 heads a group on the H100,
//   kernel_times.py --lm-sweep).
// * A window past the first (Q > 256) adds to the Y written by the one
//   before, read back into the same registers: float32 in and out, so
//   the sum's bits do not depend on the windows. A head's bits do not
//   depend on the group or its place in it.
#include "mma.cuh"
#include "tile_f32.cuh"

#include <atomic>

namespace {

using namespace svm;

constexpr int SD_ROWS = 64;        // query rows of a tile; keys of a chunk
constexpr int SD_WIN = 256;        // keys of a score window
constexpr int SD_LDS = SD_WIN + 8; // row stride (floats) of the scores
constexpr int SD_PC = 64;          // columns of x a stage holds
constexpr int SD_BOX = SD_ROWS * 32;   // words of a box: 64 rows x 128 B
constexpr int SD_DC = 4;           // boxes of depth (128 words) a B stage
constexpr int SD_CS = 4 * SD_BOX;  // a stage's cs / dt, after its tiles
constexpr int SD_STAGE = 8704;     // words a stage: tiles, cs / dt, 1 KB
constexpr int SD_MAX_STAGES = 3;
constexpr int SD_MWARPS = 8;       // MMA warps; one producer warp more
constexpr float LOG2E = 1.4426950408889634f;

// 128-byte boxes of a row of n floats
__host__ __device__ constexpr int sd_boxes(int n) { return (n + 31) / 32; }

// 1024 bytes to align the tiles, the scores, the C tile, the ring (a
// stage: a B chunk of up to 4 boxes, or two heads' x rows of 2 boxes
// each, then their cs and dt of the keys and cs of the query rows), the
// mbarriers (a full and an empty one a stage, one for C);
// ssd_diag.smem_bytes computes the same
__host__ __device__ constexpr int sd_smem_bytes(int n, int stages) {
  return 1024 + 4 * (SD_ROWS * SD_LDS + sd_boxes(n) * SD_BOX) +
         4 * stages * SD_STAGE + 8 * (2 * stages + 1);
}

struct SsdArgs {
  CUtensorMap tc, tb, tx;   // boxes of 32 floats x 64 rows
  const float* c;
  const float* b;
  const float* x;
  const float* dt;
  const float* cs;
  float* y;
  int h, q, n, p;
  int bc, group, stages, q_tiles, groups;   // the plan
  int tma;   // rows 16-byte aligned: tensor maps and bulk copies
};

// The producer's loads of 64 rows (from row0, zero at or past nrows) of
// `len` floats, `ld` apart from g, into `nb` swizzled boxes at s (every
// word written, zero past len): for rows a tensor map cannot take.
__device__ __forceinline__ void sd_load(uint32_t* s, int nb, const float* g,
                                        int64_t ld, int len, int row0,
                                        int nrows, int lane) {
  for (int e = lane; e < SD_ROWS * nb * 32; e += 32) {
    const int r = e / (nb * 32), w = e % (nb * 32);
    s[swz(SD_ROWS, r, w)] = row0 + r < nrows && w < len
                                ? __float_as_uint(g[(row0 + r) * ld + w])
                                : 0u;
  }
}

// n floats of a run at g into s (zero past n, up to 64): a bulk copy, or
// the lanes' loads
__device__ __forceinline__ void sd_run(float* s, const float* g, int n,
                                       uint64_t* bar, int tma, int lane) {
  if (tma) {
    if (lane == 0) tma_copy(s, g, 4 * n, bar);
    return;
  }
  for (int e = lane; e < SD_ROWS; e += 32) s[e] = e < n ? g[e] : 0.f;
}

__global__ void __launch_bounds__(32 * SD_MWARPS + 32, 1)
ssd_diag_kernel(const __grid_constant__ SsdArgs a) {
  extern __shared__ __align__(1024) unsigned char ssm_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Q = a.q, N = a.n, P = a.p, S = a.stages;
  // block -> (query tile, group, chunk), the heaviest tiles first
  const int cells = a.groups * a.bc;
  const int qt = a.q_tiles - 1 - blockIdx.x / cells;
  const int gi = blockIdx.x % cells % a.groups;
  const int chunk = blockIdx.x % cells / a.groups;
  const int q0 = qt * SD_ROWS;
  const int kend = min(Q, q0 + SD_ROWS);          // keys the tile needs
  const int windows = (kend + SD_WIN - 1) / SD_WIN;
  const int h0 = gi * a.group, hn = min(a.group, a.h - h0);
  const int pairs = (hn + 1) / 2, pcs = (P + SD_PC - 1) / SD_PC;
  const int nbc = sd_boxes(N), nd = (nbc + SD_DC - 1) / SD_DC;
  const int ksteps = (N + 7) / 8;                 // MMA steps over N
  uint32_t* base = align1024(ssm_raw);
  float* sc = reinterpret_cast<float*>(base);     // 64 x SD_LDS scores
  uint32_t* ct = base + SD_ROWS * SD_LDS;         // nbc boxes of C rows
  uint32_t* ring = ct + nbc * SD_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SD_STAGE);
  uint64_t* empty = full + S;
  uint64_t* c_in = empty + S;
  const float* cb = a.c + (int64_t)chunk * Q * N;
  const float* bb = a.b + (int64_t)chunk * Q * N;

  if (threadIdx.x == 0) {
    const int arrivals = a.tma ? 1 : 32;   // lane 0 alone, or every lane
    for (int st = 0; st < S; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(full + st)),
                   "r"(arrivals)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + st)),
                   "r"(SD_MWARPS)
                   : "memory");
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(c_in)),
                 "r"(arrivals)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == SD_MWARPS) {   // the producer
    if (a.tma && lane == 0) {
      mbar_arrive_expect_tx(c_in, nbc * SD_BOX * 4);
      for (int bx = 0; bx < nbc; ++bx)
        tma_tile(ct + bx * SD_BOX, &a.tc, 32 * bx, q0, chunk, 0, c_in);
    } else if (!a.tma) {
      sd_load(ct, nbc, cb, N, N, q0, Q, lane);
      mbar_arrive(c_in);
    }
    if (a.tma && lane != 0) return;   // lane 0 issues every copy
    int it = 0;
    auto begin = [&](uint32_t bytes) -> uint32_t* {
      const int st = it % S, round = it / S;
      if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
      if (a.tma) mbar_arrive_expect_tx(full + st, bytes);
      return ring + st * SD_STAGE;
    };
    auto end = [&]() {
      if (!a.tma) mbar_arrive(full + it % S);
      ++it;
    };
    for (int win = 0; win < windows; ++win) {
      const int kw0 = win * SD_WIN, kw1 = min(kend, kw0 + SD_WIN);
      for (int k0 = kw0; k0 < kw1; k0 += SD_ROWS)
        for (int c = 0; c < nd; ++c) {
          const int nb = min(SD_DC, nbc - c * SD_DC);
          uint32_t* s = begin(nb * SD_BOX * 4);
          if (a.tma) {
            for (int bx = 0; bx < nb; ++bx)
              tma_tile(s + bx * SD_BOX, &a.tb, 32 * (c * SD_DC + bx), k0,
                       chunk, 0, full + it % S);
          } else {
            sd_load(s, nb, bb + c * SD_DC * 32, N,
                    min(N - c * SD_DC * 32, SD_DC * 32), k0, Q, lane);
          }
          end();
        }
      for (int pr = 0; pr < pairs; ++pr)
        for (int pc = 0; pc < pcs; ++pc) {
          const int len = min(P - pc * SD_PC, SD_PC);
          const int nbx = sd_boxes(len);
          const int heads = min(2, hn - 2 * pr);
          for (int k0 = kw0; k0 < kw1; k0 += SD_ROWS) {
            // x rows, then cs and dt of the keys and cs of the query rows
            const int nk = min(SD_ROWS, Q - k0), nq = min(SD_ROWS, Q - q0);
            uint32_t* s = begin(heads * (nbx * SD_BOX + 2 * nk + nq) * 4);
            for (int hs = 0; hs < heads; ++hs) {
              const int hd = h0 + 2 * pr + hs;
              const int64_t ch = (int64_t)chunk * a.h + hd;
              uint32_t* xs = s + hs * 2 * SD_BOX;
              float* v = reinterpret_cast<float*>(s + SD_CS) + hs * 3 * SD_ROWS;
              if (a.tma) {
                for (int bx = 0; bx < nbx; ++bx)
                  tma_tile(xs + bx * SD_BOX, &a.tx, pc * SD_PC + 32 * bx, k0,
                           hd, chunk, full + it % S);
              } else {
                sd_load(xs, nbx, a.x + ch * Q * P + pc * SD_PC, P, len, k0, Q,
                        lane);
              }
              sd_run(v, a.cs + ch * Q + k0, nk, full + it % S, a.tma, lane);
              sd_run(v + SD_ROWS, a.dt + ch * Q + k0, nk, full + it % S,
                     a.tma, lane);
              sd_run(v + 2 * SD_ROWS, a.cs + ch * Q + q0, nq, full + it % S,
                     a.tma, lane);
            }
            end();
          }
        }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4, qq = lane / 8, rr = lane % 8;
  const int rg = warp % 4, hf = warp / 4;
  const int wr0 = q0 + 16 * rg;   // the warp's first query row
  const int mthreads = 32 * SD_MWARPS;
  // this lane's ldmatrix rows: A (C rows 16 rg + (qq & 1) * 8 + rr, words
  // (qq >> 1) * 4 of a step), B (B rows 32 hf + (qq >> 1) * 8 + rr of a
  // 16-key pair of tiles, words (qq & 1) * 4)
  const int ra = 16 * rg + rr + (qq & 1) * 8;
  const int rb = 32 * hf + (qq >> 1) * 8 + rr;
  mbar_wait(c_in, 0);
  int it = 0;
  for (int win = 0; win < windows; ++win) {
    const int kw0 = win * SD_WIN, kw1 = min(kend, kw0 + SD_WIN);
    if (win > 0) bar_sync(1, mthreads);   // every warp is done with sc

    // ---- scores: rows 16 rg + [0, 16), keys 32 hf + [0, 32) of a chunk
    for (int k0 = kw0; k0 < kw1; k0 += SD_ROWS) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int c = 0; c < nd; ++c) {
        const int st = it % S;
        mbar_wait(full + st, (it / S) & 1);
        const uint32_t* bs = ring + st * SD_STAGE;
        const int steps = min(ksteps - c * SD_DC * 4, SD_DC * 4);
#pragma unroll 2
        for (int ks = 0; ks < steps; ++ks) {
          uint32_t af[4], ah[4], al[4];
          ldsm_x4(af, ct + swz(SD_ROWS, ra,
                               c * SD_DC * 32 + ks * 8 + (qq >> 1) * 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_trunc(af[e], ah[e], al[e]);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bf[4], bh[4], bl[4];
            ldsm_x4(bf, bs + swz(SD_ROWS, rb + jp * 16,
                                 ks * 8 + (qq & 1) * 4));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32_trunc(bf[e], bh[e], bl[e]);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float* cc = acc[2 * jp + hh];
              mma_tf32(cc, al, bh + 2 * hh);
              mma_tf32(cc, ah, bl + 2 * hh);
              mma_tf32(cc, ah, bh + 2 * hh);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);
        ++it;
      }
      // acc[j]: keys k0 + 32 hf + 8 j + 2 t (+1), rows g and g + 8
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              sc + (16 * rg + g + 8 * hh) * SD_LDS + (k0 - kw0) + 32 * hf +
              8 * j + 2 * t) = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
    bar_sync(1, mthreads);   // the window's scores are written
    // ---- heads: warp half hf takes head 2 pr + hf of the group
    for (int pr = 0; pr < pairs; ++pr)
      for (int pc = 0; pc < pcs; ++pc) {
        const int head = h0 + 2 * pr + hf;
        const bool live = 2 * pr + hf < hn && wr0 < Q;
        float* yb = a.y + ((int64_t)chunk * a.h + head) * Q * P + pc * SD_PC;
        const int pcw = min(P - pc * SD_PC, SD_PC);
        float o[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
        if (win > 0 && live) {   // the sum so far, as the last window left it
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = wr0 + g + 8 * (e >> 1);
              const int col = 16 * (j / 2) + 4 * t + 2 * (e & 1) + (j & 1);
              if (row < Q && col < pcw) o[j][e] = yb[(int64_t)row * P + col];
            }
        }
        for (int k0 = kw0; k0 < kw1; k0 += SD_ROWS) {
          const int st = it % S;
          mbar_wait(full + st, (it / S) & 1);
          if (live && k0 <= wr0 + 15) {
            const uint32_t* s = ring + st * SD_STAGE;
            const float* xs = reinterpret_cast<const float*>(s + hf * 2 * SD_BOX);
            const float* cs_k = reinterpret_cast<const float*>(s + SD_CS) +
                                hf * 3 * SD_ROWS;
            const float* dt_k = cs_k + SD_ROWS;
            const float* cs_q = cs_k + 2 * SD_ROWS;
            float csq[2];   // cs of rows g, g + 8
            csq[0] = cs_q[16 * rg + g];
            csq[1] = cs_q[16 * rg + g + 8];
            // the chunk's weights first, as TF32 high and low A fragments
            // (keys k0 + 8 j + 2 t (+1) of rows g, g + 8: words t, t + 4),
            // then its 192 MMAs back to back
            uint32_t wh[8][4], wl[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int kl = 8 * j + 2 * t;
              const float2 ck = *reinterpret_cast<const float2*>(cs_k + kl);
              const float2 dk = *reinterpret_cast<const float2*>(dt_k + kl);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int row = wr0 + g + 8 * hh;
                const float2 sv = *reinterpret_cast<const float2*>(
                    sc + (16 * rg + g + 8 * hh) * SD_LDS + (k0 - kw0) + kl);
                float w0 = 0.f, w1 = 0.f;
                if (k0 + kl <= row && row < Q)
                  w0 = __fmul_rn(__fmul_rn(sv.x, ex2(__fmul_rn(
                                     __fsub_rn(csq[hh], ck.x), LOG2E))),
                                 dk.x);
                if (k0 + kl + 1 <= row && row < Q)
                  w1 = __fmul_rn(__fmul_rn(sv.y, ex2(__fmul_rn(
                                     __fsub_rn(csq[hh], ck.y), LOG2E))),
                                 dk.y);
                split_tf32_trunc(__float_as_uint(w0), wh[j][hh], wl[j][hh]);
                split_tf32_trunc(__float_as_uint(w1), wh[j][2 + hh],
                                 wl[j][2 + hh]);
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int jp = 0; jp < 4; ++jp) {
                const float2 x0 = *reinterpret_cast<const float2*>(
                    xs + swz(SD_ROWS, 8 * j + 2 * t, 16 * jp + 2 * g));
                const float2 x1 = *reinterpret_cast<const float2*>(
                    xs + swz(SD_ROWS, 8 * j + 2 * t + 1, 16 * jp + 2 * g));
                uint32_t bh[4], bl[4];
                split_tf32_trunc(__float_as_uint(x0.x), bh[0], bl[0]);
                split_tf32_trunc(__float_as_uint(x1.x), bh[1], bl[1]);
                split_tf32_trunc(__float_as_uint(x0.y), bh[2], bl[2]);
                split_tf32_trunc(__float_as_uint(x1.y), bh[3], bl[3]);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  float* cc = o[2 * jp + hh];
                  mma_tf32(cc, wl[j], bh + 2 * hh);
                  mma_tf32(cc, wh[j], bl + 2 * hh);
                  mma_tf32(cc, wh[j], bh + 2 * hh);
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + st);
          ++it;
        }
        if (!live) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wr0 + g + 8 * hh;
          if (row >= Q) continue;
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            // columns 16 jp + 4 t + (0, 1, 2, 3)
            const int col = 16 * jp + 4 * t;
            const float v[4] = {o[2 * jp][2 * hh], o[2 * jp + 1][2 * hh],
                                o[2 * jp][2 * hh + 1],
                                o[2 * jp + 1][2 * hh + 1]};
            float* dst = yb + (int64_t)row * P + col;
            if (col + 3 < pcw && (P & 3) == 0 && a.tma) {
              *reinterpret_cast<float4*>(dst) =
                  make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (col + e < pcw) dst[e] = v[e];
            }
          }
        }
      }
  }
}

// A plan ssd_diag.ssd_plan can make, with the shared memory it takes.
bool ssd_plan_ok(int group, int stages, int n, int smem) {
  return group >= 1 && stages >= 2 && stages <= SD_MAX_STAGES && n >= 1 &&
         n <= 256 && smem == sd_smem_bytes(n, stages);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor map of a float32 tensor of dims (innermost first), boxes of
// 32 floats x 64 rows
int rows_map(CUtensorMap* map, const float* base, cuuint64_t d0,
             cuuint64_t d1, cuuint64_t d2, cuuint64_t d3) {
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {4 * d0, 4 * d0 * d1, 4 * d0 * d1 * d2};
  const cuuint32_t box[4] = {32, SD_ROWS, 1, 1};
  return tmap_4d(map, base, false, dims, strides, box);
}

}  // namespace

extern "C" {

// cmat, bmat (bc, q, n); x (bc, h, q, p); dt, cs (bc, h, q); out like x.
// Needs n <= 256 (the wrapper checks); the plan of ssd_diag.ssd_plan:
// heads a block, ring stages, shared memory.
int svm_ssd_diag(const float* cmat, const float* bmat, const float* x,
                 const float* dt, const float* cs, float* out, int bc, int h,
                 int q, int n, int p, int group, int stages, int smem,
                 void* stream) {
  if (!ssd_plan_ok(group, stages, n, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (q + SD_ROWS - 1) / SD_ROWS;
  const int groups = (h + group - 1) / group;
  SsdArgs a{};
  a.c = cmat;
  a.b = bmat;
  a.x = x;
  a.dt = dt;
  a.cs = cs;
  a.y = out;
  a.h = h;
  a.q = q;
  a.n = n;
  a.p = p;
  a.bc = bc;
  a.group = group;
  a.stages = stages;
  a.q_tiles = q_tiles;
  a.groups = groups;
  a.tma = n % 4 == 0 && p % 4 == 0 && q % 4 == 0 && aligned16(cmat) &&
          aligned16(bmat) && aligned16(x) && aligned16(dt) &&
          aligned16(cs) && aligned16(out);
  if (a.tma) {
    if (const int e = rows_map(&a.tc, cmat, n, q, bc, 1)) return e;
    if (const int e = rows_map(&a.tb, bmat, n, q, bc, 1)) return e;
    if (const int e = rows_map(&a.tx, x, p, q, h, bc)) return e;
  }
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  if (const int e = f32tile::allow_max_smem(ssd_diag_kernel, allowed))
    return e;
  ssd_diag_kernel<<<q_tiles * groups * bc, 32 * SD_MWARPS + 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
