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
// the heads first), takes 0.054 ms as 3xTF32, so bytes bound it. This
// kernel does five products a (head, pair of tiles) on the CUDA cores:
// S, dC and dB again for every head. Design (a first version: right and
// simple; the tensor cores are later work):
//
// * Every product runs as IEEE float32 FMAs on the CUDA cores (16 x 16
//   threads, thread (ty, tx) owning rows ty + 16 i and columns tx + 16 j
//   of each 64 x 64 tile product, as flash_attn_bwd.cu does); exp is
//   expf, the difference of cs taken only where k <= q.
// * A block owns (chunk, group of heads) and walks, for each head of the
//   group and each key tile j, the query tiles i >= j: everything the
//   (head, chunk) needs is the block's own, so dX, ddt and dcs are whole
//   when the walk ends. dC and dB sum over the heads: the block adds its
//   group's heads into one partial a group (device memory, each element
//   read and written by one thread in a fixed order), and a last launch
//   sums the groups' partials in group order. No atomics: two calls give
//   the same bits.
// * Row sums of G reduce over the 16 threads of a half-warp by a fixed
//   butterfly; column sums over the 16 row threads through shared memory
//   in row order. dcs of a position is its row sums, in key-tile order,
//   less its column sum, taken once every row sum is in.
#include "tile_f32.cuh"

#include <algorithm>
#include <atomic>

namespace {

using namespace svm;

constexpr int SB_TILE = 64;        // rows / keys of a tile
constexpr int SB_THREADS = 256;    // 16 x 16
constexpr int SB_LDS = SB_TILE + 1;   // row stride of the W and dS tiles

// shared memory of a launch (ssd_diag.bwd_smem_bytes): x and dY tiles (P
// + 1 floats a row), B and C tiles (N + 1), W and dS tiles, cs / dt of
// the key tile and cs of the query tile, two 16 x 64 column-sum scratch
// arrays, and the head's row sums, column sums and ddt over Q
__host__ __device__ constexpr int sb_smem(int q, int n, int p) {
  return 4 * (2 * SB_TILE * (p + 1) + 2 * SB_TILE * (n + 1) +
              2 * SB_TILE * SB_LDS + 3 * SB_TILE + 2 * 16 * SB_TILE + 3 * q);
}

struct SsdBwdArgs {
  const float* c;
  const float* b;
  const float* x;
  const float* dt;
  const float* cs;
  const float* dy;
  float* dc_part;   // (groups, BC, Q, N), zero on entry
  float* db_part;
  float* dx;        // (BC, H, Q, P), zero on entry
  float* ddt;       // (BC, H, Q)
  float* dcs;
  float* dc;        // (BC, Q, N)
  float* db;
  int bc, h, q, n, p, group, groups;
};

// 64 rows (from row0, zero at or past nrows) of `len` floats, rows `len`
// apart from g, into s[r * (len + 1) + c]
__device__ __forceinline__ void sb_load(float* s, const float* g, int len,
                                        int row0, int nrows) {
  for (int e = threadIdx.x; e < SB_TILE * len; e += SB_THREADS) {
    const int r = e / len, c = e % len;
    s[r * (len + 1) + c] =
        row0 + r < nrows ? g[(int64_t)(row0 + r) * len + c] : 0.f;
  }
}

// acc[i][j] += sum_{k < depth} A(ty + 16 i, k) B(k, tx + 16 j), storage as
// in flash_attn_bwd.cu's mm; columns past ncol read 0
template <bool AT, bool BT>
__device__ __forceinline__ void sb_mm(float (&acc)[4][4], const float* a,
                                      int lda, const float* b, int ldb,
                                      int depth, int ncol, int ty, int tx) {
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) live[j] = tx + 16 * j < ncol;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      av[i] = AT ? a[k * lda + r] : a[r * lda + k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      bv[j] = live[j] ? (BT ? b[c * ldb + k] : b[k * ldb + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void sb_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dst[(row0 + r) * ld + col0 + c] += acc for the thread's rows r < nrows
// and columns col0 + c < ncol (each element always the same thread's)
__device__ __forceinline__ void sb_add(float* dst, int64_t ld,
                                       const float (&acc)[4][4], int row0,
                                       int nrows, int col0, int ncol, int ty,
                                       int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < ncol) {
        float* e = dst + (int64_t)r * ld + c;
        *e = __fadd_rn(*e, acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(SB_THREADS)
ssd_bwd_kernel(const SsdBwdArgs a) {
  extern __shared__ float sb_sm[];
  const int Q = a.q, N = a.n, P = a.p;
  const int LP = P + 1, LN = N + 1;
  float* xs = sb_sm;                    // x of the key tile
  float* dys = xs + SB_TILE * LP;       // dY of the query tile
  float* bs = dys + SB_TILE * LP;       // B of the key tile
  float* cts = bs + SB_TILE * LN;       // C of the query tile
  float* ws = cts + SB_TILE * LN;       // W (query rows x keys)
  float* dss = ws + SB_TILE * SB_LDS;   // dS_h
  float* csk = dss + SB_TILE * SB_LDS;
  float* dtk = csk + SB_TILE;
  float* csq = dtk + SB_TILE;
  float* red_g = csq + SB_TILE;         // [16][64] column partials of G
  float* red_d = red_g + 16 * SB_TILE;  // [16][64] of the ddt terms
  float* row_g = red_d + 16 * SB_TILE;  // [Q] the head's row sums of G
  float* col_g = row_g + Q;             // [Q] its column sums
  float* ddt_s = col_g + Q;             // [Q] ddt
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int chunk = blockIdx.x / a.groups, gi = blockIdx.x % a.groups;
  const int h0 = gi * a.group, hn = min(a.group, a.h - h0);
  const int tiles = (Q + SB_TILE - 1) / SB_TILE;
  const float* cb = a.c + (int64_t)chunk * Q * N;
  const float* bb = a.b + (int64_t)chunk * Q * N;
  float* dcp = a.dc_part + ((int64_t)gi * a.bc + chunk) * Q * N;
  float* dbp = a.db_part + ((int64_t)gi * a.bc + chunk) * Q * N;

  for (int e = threadIdx.x; e < 3 * Q; e += SB_THREADS) row_g[e] = 0.f;
  for (int hh = 0; hh < hn; ++hh) {
    const int head = h0 + hh;
    const int64_t ch = (int64_t)chunk * a.h + head;
    const float* xh = a.x + ch * Q * P;
    const float* dyh = a.dy + ch * Q * P;
    float* dxh = a.dx + ch * Q * P;
    for (int j = 0; j < tiles; ++j) {
      const int k0 = j * SB_TILE;
      __syncthreads();   // the last tile's reads of xs, bs, csk, dtk done
      sb_load(xs, xh, P, k0, Q);
      sb_load(bs, bb, N, k0, Q);
      if (threadIdx.x < SB_TILE) {
        const int k = k0 + threadIdx.x;
        csk[threadIdx.x] = k < Q ? a.cs[ch * Q + k] : 0.f;
        dtk[threadIdx.x] = k < Q ? a.dt[ch * Q + k] : 0.f;
      }
      for (int i = j; i < tiles; ++i) {
        const int q0 = i * SB_TILE;
        __syncthreads();   // reads of dys, cts, ws, dss, red_* done
        sb_load(dys, dyh, P, q0, Q);
        sb_load(cts, cb, N, q0, Q);
        if (threadIdx.x < SB_TILE) {
          const int qq = q0 + threadIdx.x;
          csq[threadIdx.x] = qq < Q ? a.cs[ch * Q + qq] : 0.f;
        }
        __syncthreads();
        float s[4][4], dw[4][4];
        sb_zero(s);
        sb_zero(dw);
        sb_mm<false, true>(s, cts, LN, bs, LN, N, SB_TILE, ty, tx);   // C B^T
        sb_mm<false, true>(dw, dys, LP, xs, LP, P, SB_TILE, ty, tx);  // dY x^T
        float gcol[4] = {0.f, 0.f, 0.f, 0.f}, dcol[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = ty + 16 * ii, qg = q0 + r;
          float grow = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = tx + 16 * jj, kg = k0 + c;
            float w = 0.f, g = 0.f, dd = 0.f, ds = 0.f;
            if (kg <= qg && qg < Q) {
              const float l = expf(__fsub_rn(csq[r], csk[c]));
              w = __fmul_rn(__fmul_rn(s[ii][jj], l), dtk[c]);
              g = __fmul_rn(dw[ii][jj], w);
              dd = __fmul_rn(__fmul_rn(dw[ii][jj], s[ii][jj]), l);
              ds = __fmul_rn(__fmul_rn(dw[ii][jj], l), dtk[c]);
            }
            ws[r * SB_LDS + c] = w;
            dss[r * SB_LDS + c] = ds;
            grow = __fadd_rn(grow, g);
            gcol[jj] = __fadd_rn(gcol[jj], g);
            dcol[jj] = __fadd_rn(dcol[jj], dd);
          }
          // the row's sum over its 64 keys: 16 threads of a half-warp
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            grow = __fadd_rn(grow, __shfl_xor_sync(0xffffffffu, grow, off));
          if (tx == 0 && qg < Q) row_g[qg] = __fadd_rn(row_g[qg], grow);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          red_g[ty * SB_TILE + tx + 16 * jj] = gcol[jj];
          red_d[ty * SB_TILE + tx + 16 * jj] = dcol[jj];
        }
        __syncthreads();
        if (threadIdx.x < SB_TILE) {   // column sums over the 16 row threads
          const int c = threadIdx.x, kg = k0 + c;
          float gs = 0.f, ds = 0.f;
          for (int t = 0; t < 16; ++t) {
            gs = __fadd_rn(gs, red_g[t * SB_TILE + c]);
            ds = __fadd_rn(ds, red_d[t * SB_TILE + c]);
          }
          if (kg < Q) {
            col_g[kg] = __fadd_rn(col_g[kg], gs);
            ddt_s[kg] = __fadd_rn(ddt_s[kg], ds);
          }
        }
        // dX[keys] += W^T dY; dB[keys] += dS^T C; dC[rows] += dS B
        for (int c0 = 0; c0 < P; c0 += SB_TILE) {
          float acc[4][4];
          sb_zero(acc);
          sb_mm<true, false>(acc, ws, SB_LDS, dys + c0, LP, SB_TILE,
                             P - c0, ty, tx);
          sb_add(dxh, P, acc, k0, Q, c0, P, ty, tx);
        }
        for (int c0 = 0; c0 < N; c0 += SB_TILE) {
          float acc[4][4];
          sb_zero(acc);
          sb_mm<true, false>(acc, dss, SB_LDS, cts + c0, LN, SB_TILE,
                             N - c0, ty, tx);
          sb_add(dbp, N, acc, k0, Q, c0, N, ty, tx);
          sb_zero(acc);
          sb_mm<false, false>(acc, dss, SB_LDS, bs + c0, LN, SB_TILE,
                              N - c0, ty, tx);
          sb_add(dcp, N, acc, q0, Q, c0, N, ty, tx);
        }
      }
    }
    __syncthreads();   // every row and column sum of the head is in
    for (int e = threadIdx.x; e < Q; e += SB_THREADS) {
      a.dcs[ch * Q + e] = __fsub_rn(row_g[e], col_g[e]);
      a.ddt[ch * Q + e] = ddt_s[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * Q; e += SB_THREADS) row_g[e] = 0.f;
  }
}

// dC, dB: the groups' partials summed in group order
__global__ void __launch_bounds__(SB_THREADS)
ssd_bwd_reduce_kernel(const SsdBwdArgs a) {
  const int64_t total = (int64_t)a.bc * a.q * a.n;
  for (int64_t e = (int64_t)blockIdx.x * SB_THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * SB_THREADS) {
    float sc = 0.f, sb = 0.f;
    for (int g = 0; g < a.groups; ++g) {
      sc = __fadd_rn(sc, a.dc_part[g * total + e]);
      sb = __fadd_rn(sb, a.db_part[g * total + e]);
    }
    a.dc[e] = sc;
    a.db[e] = sb;
  }
}

}  // namespace

extern "C" {

// cmat, bmat (bc, q, n); x, dy (bc, h, q, p); dt, cs (bc, h, q): the
// forward's operands and dY, all float32. Writes dc, db (bc, q, n), dx
// (zero on entry), ddt, dcs; dc_part / db_part are (groups, bc, q, n)
// scratch, zero on entry. The plan of ssd_diag.bwd_plan: heads a block
// and its shared memory. Needs n <= 256, p <= 128.
int svm_ssd_diag_bwd(const float* cmat, const float* bmat, const float* x,
                     const float* dt, const float* cs, const float* dy,
                     float* dc_part, float* db_part, float* dc, float* db,
                     float* dx, float* ddt, float* dcs, int bc, int h, int q,
                     int n, int p, int group, int smem, void* stream) {
  if (bc < 1 || h < 1 || q < 1 || n < 1 || n > 256 || p < 1 || p > 128 ||
      group < 1 || smem != sb_smem(q, n, p))
    return static_cast<int>(cudaErrorInvalidValue);
  SsdBwdArgs a{};
  a.c = cmat;
  a.b = bmat;
  a.x = x;
  a.dt = dt;
  a.cs = cs;
  a.dy = dy;
  a.dc_part = dc_part;
  a.db_part = db_part;
  a.dx = dx;
  a.ddt = ddt;
  a.dcs = dcs;
  a.dc = dc;
  a.db = db;
  a.bc = bc;
  a.h = h;
  a.q = q;
  a.n = n;
  a.p = p;
  a.group = group;
  a.groups = (h + group - 1) / group;
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  if (const int e = f32tile::allow_max_smem(ssd_bwd_kernel, allowed))
    return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd_kernel<<<bc * a.groups, SB_THREADS, smem, s>>>(a);
  if (const int e = static_cast<int>(cudaGetLastError())) return e;
  const int64_t total = (int64_t)bc * q * n;
  const int blocks = (int)std::min<int64_t>((total + SB_THREADS - 1) / SB_THREADS,
                                       4096);
  ssd_bwd_reduce_kernel<<<blocks, SB_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
