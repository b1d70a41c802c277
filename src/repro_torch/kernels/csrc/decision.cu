// decision / multitask_decision: the fused serving contraction.
//
// Replaces `decision_pallas` / `_decision_kernel` and
// `multitask_decision_pallas` / `_multitask_kernel`
// (src/repro/kernels/decision.py), reached through `ops.decision` and
// `ops.multitask_decision`:
//   f_t(z) = sum_i coef[t, i] * K(sv[t, i], z)        (bias added outside)
// with K the RBF (or, multitask only, the linear) kernel. The (nt, w)
// kernel block is never written to memory.
//
// Bound: per task, 3 nt w d operations (d multiply-adds and the
// epilogue) against reading z, the bank and coef once; at SVM widths
// the float32 FMA rate sets it (2 nt w d / 67 TFLOP/s) once nt and w
// reach a few hundred.
//
// Design (tile_f32.cuh). The first version walked the whole bank in one
// block per (64-row tile, task) on a 64 x 64 FMA tile: at a served
// 6-task bank over 1,024 rows that is 96 blocks for 132 SMs, and every
// SV tile re-staged the same test rows and recomputed their norms. Now:
// * a block stages its BM test rows (BM = 128, or 64 for small grids)
//   once, whole along d (past RES_WIDTH features: in 64-wide chunks
//   again for each SV tile), and their squared norms once; SV tiles of
//   64 rows stream through a two-stage cp.async ring, the next tile's
//   copies in flight while the current one is contracted, and each SV
//   tile's norms are computed once as it lands (4 threads a row, in a
//   fixed order);
// * a thread holds 8 (or 4) test rows x 4 SVs; each step of 4 features
//   reads one float4 per row and per SV, the 16 threads of a row group
//   reading the same row address. Shared-memory loads bound the loop (a
//   wavefront a float a thread: 12 for 32 FMAs); wider register tiles
//   need 128-thread blocks, which ran slower for want of warps (PERF.md,
//   PR 14);
// * the SV axis is split over `splits` blocks (gridDim.z) when the
//   (row tile x task) grid cannot fill the card (`decision_plan`,
//   kernels/decision.py): split s takes a contiguous run of SV tiles
//   (whole segments, below).
// * a 16-bit bank (fp16 or bf16: a schema-v3 pack's quantized bank, or
//   the bank of bf16 compute) stays 16-bit until it reaches registers:
//   its SV tiles are copied as stored into a 16-bit ring (cp.async, 8
//   or 4 bytes a copy as the rows' alignment allows; loads for rows of
//   odd d), the next tile's copies in flight during the contraction as
//   for a float32 bank, at half its shared memory. The inner loop reads
//   four features of an SV as one 8-byte load and widens them in
//   registers (tile_f32.cuh's ld4w), then runs the float32 kernel's four
//   FMAs in its order; the SV norms are summed from the widened values
//   in the float32 kernel's order. The widening is exact, so a quantized
//   bank's decisions are the float32 kernel's on the upcast bank, bit
//   for bit. (Widening each tile once as it lands, into a float32 stage
//   written by the norm pass, read up to 2 % faster at the served plans
//   but 15 % slower at 16 splits of the OvR bank: kernel_times.py
//   --quant --sweep, PERF.md.) The test
//   rows and the bank therefore have types of their own (TZ, TS):
//   float32 rows with a float32, fp16 or bf16 bank, or bf16 rows
//   (widened as they are staged) with a bf16 bank.
// A row's decision does not depend on the plan, its batch or its place
// in it: the sum is folded in an order fixed by the bank alone. A task's
// terms cancel (coef = alpha y of both signs, often one class's rows
// first), and a running float32 total would round at the size of the sum
// of their magnitudes, so partial sums are carried as (hi, lo) pairs
// and added by TwoSum:
// * after each SV tile, the 16 threads of a test row add their parts (4
//   products each) along a fixed butterfly over their 16 lanes;
// * the tiles' pairs are added in tile order within a segment of `seg`
//   consecutive tiles (seg is a function of the bank's width alone:
//   `decision_plan`), and the segments' pairs in segment order; the
//   running pairs live in shared memory, one owner thread a row.
// With splits, split s takes a contiguous run of whole segments and
// writes each segment's pair per row; the last block of a (row tile,
// task) to finish — an atomic ticket after a __threadfence — folds the
// pairs of all segments in segment order, the very sequence an unsplit
// block runs, so the result does not depend on the split count or on
// the order in which blocks finish. That block resets the ticket to 0
// for the next launch on the stream; the ticket array is the wrapper's
// (zeroed once). One kernel serves both entry points, so a T = 1
// multitask call is the single-task call bit for bit; the task axis is
// grid.y. Ragged nt, w and d are zero-filled, never read.
#include "common.cuh"
#include "tile_f32.cuh"

namespace {

using namespace svm::f32tile;

constexpr int NT = 256;       // threads a block: 16 (ty) x 16 (tx)
constexpr int SV_TILE = 64;   // SVs a ring stage holds

// bytes of dynamic shared memory: the float32 test-row tile (one, or a
// ring of two when the features come in chunks), two SV stages at the
// bank's element size (sv_bytes: 4, or 2 for a 16-bit bank), the norms,
// and four running sums a test row (segment and block pairs)
__host__ __device__ constexpr int smem_bytes(int bm, int chunk, int nch,
                                             int sv_bytes) {
  return 4 * ((nch == 1 ? 1 : 2) * bm * row_stride(chunk) + bm + SV_TILE +
              4 * bm) +
         2 * SV_TILE * row_stride(chunk) * sv_bytes;
}

template <typename TZ, typename TS, int RM>   // RM rows a thread: BM = 16 RM
__global__ void __launch_bounds__(NT, 2)
decision_kernel(const TZ* __restrict__ z, int nt, const TS* __restrict__ sv,
                const float* __restrict__ coef, int w, int d, float gamma,
                int rbf, int chunk, int seg, int vz, int vs,
                float2* __restrict__ partial, int* __restrict__ ticket,
                float* __restrict__ out) {
  constexpr int BM = 16 * RM, PASSES = BM / 64;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_block;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int t0 = blockIdx.x * BM;
  sv += (size_t)t * w * d;
  coef += (size_t)t * w;
  const int ntiles = (w + SV_TILE - 1) / SV_TILE;
  const int nseg = (ntiles + seg - 1) / seg;
  const int tile0 = (int)((long long)split * nseg / splits) * seg;
  const int tile1 =
      min((int)((long long)(split + 1) * nseg / splits) * seg, ntiles);
  const int dpad = round4(d), nch = (dpad + chunk - 1) / chunk;
  const int ld = row_stride(chunk);
  const bool resident = nch == 1;   // the test rows are staged once
  float* zs = smem;
  float* zn = zs + (resident ? 1 : 2) * BM * ld;
  float* sn = zn + BM;
  float* run = sn + SV_TILE;   // a row's segment pair, then its block pair
  TS* ss = reinterpret_cast<TS*>(run + 4 * BM);   // 16-byte aligned
  for (int e = tid; e < 4 * BM; e += NT) run[e] = 0.f;
  const int items = (tile1 - tile0) * nch;   // (SV tile, feature chunk)

  auto load = [&](int it) {
    const int st = it & 1, k0 = (it % nch) * chunk;
    const int cw = min(chunk, dpad - k0);
    if (!resident || it == 0)
      stage<NT>(zs + (resident ? 0 : st) * BM * ld, ld, z, d, t0, nt, k0, BM,
                cw, vz);
    stage<NT>(ss + st * SV_TILE * ld, ld, sv, d, (tile0 + it / nch) * SV_TILE,
              w, k0, SV_TILE, cw, vs);
    cp_async_commit();
  };

  float dot[RM][4];
  float zsq[PASSES], ssq = 0.f;   // partial squared norms, 4 threads a row
  const int nr = tid >> 2, nq = tid & 3;   // norm row, quarter

  load(0);
  for (int it = 0; it < items; ++it) {
    const int st = it & 1, ch = it % nch, tile = tile0 + it / nch;
    const int cw = min(chunk, dpad - ch * chunk);
    if (it + 1 < items) {
      load(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* za = zs + (resident ? 0 : st) * BM * ld;
    const TS* sb = ss + st * SV_TILE * ld;
    if (ch == 0) {
      ssq = 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
      if (it == 0)
#pragma unroll
        for (int p = 0; p < PASSES; ++p) zsq[p] = 0.f;
    }
    for (int c = nq; c < cw; c += 4) {
      const float v = ld1w(sb + nr * ld + c);
      ssq = fmaf(v, v, ssq);
    }
    if (it < nch)   // the test rows' norms, over the split's first tile
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
        for (int c = nq; c < cw; c += 4) {
          const float v = za[(p * 64 + nr) * ld + c];
          zsq[p] = fmaf(v, v, zsq[p]);
        }
#pragma unroll 1
    for (int kk = 0; kk < cw; kk += 4) {
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ld4w(sb + (tx + 16 * j) * ld + kk);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = ld4(za + (ty + 16 * i) * ld + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // features kk .. kk + 3, in order
          dot[i][j] = fmaf(a.x, b[j].x, dot[i][j]);
          dot[i][j] = fmaf(a.y, b[j].y, dot[i][j]);
          dot[i][j] = fmaf(a.z, b[j].z, dot[i][j]);
          dot[i][j] = fmaf(a.w, b[j].w, dot[i][j]);
        }
      }
    }
    if (ch == nch - 1) {   // the tile's dots are complete
      ssq += __shfl_xor_sync(0xffffffffu, ssq, 1);
      ssq += __shfl_xor_sync(0xffffffffu, ssq, 2);
      if (nq == 0) sn[nr] = ssq;
      if (it < nch)
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          float v = zsq[p];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (nq == 0) zn[p * 64 + nr] = v;
        }
      __syncthreads();
      float cf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tile * SV_TILE + tx + 16 * j;
        cf[j] = c < w ? coef[c] : 0.f;   // SV rows past the edge add 0
      }
      const bool seg_end = (tile + 1) % seg == 0 || tile + 1 == ntiles;
      float h[RM], l[RM];   // the tile's part of each of the thread's rows
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        h[i] = l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float k = rbf ? svm::rbf_epilogue(zn[ty + 16 * i],
                                                  sn[tx + 16 * j], dot[i][j],
                                                  gamma)
                              : dot[i][j];
          h[i] = fmaf(k, cf[j], h[i]);
        }
      }
      // Add each row's parts over the 16 lanes of its row group (16
      // consecutive lanes) along the butterfly m = 8, 4, 2, 1. While a
      // lane holds more than one row, a level hands half of them to the
      // partner lane (lane bit m picks which half it keeps), so a row's
      // pairs meet in the same tree for RM = 4 and 8 and one lane pair
      // ends with each row: 12 or 8 shuffles a lane, not 8 RM.
      int r = 0;   // the row (of the thread's RM) this lane ends with
#pragma unroll
      for (int lv = 0; lv < 4; ++lv) {
        const int m = 8 >> lv, n = RM >> (lv + 1);   // rows kept
        const bool up = tx & m;
        if (n >= 1) {
          r += up ? n : 0;
#pragma unroll
          for (int i = 0; i < n; ++i) {
            const float sh = up ? h[i] : h[i + n], sl = up ? l[i] : l[i + n];
            if (up) h[i] = h[i + n], l[i] = l[i + n];
            const float rh = __shfl_xor_sync(0xffffffffu, sh, m);
            const float rl = lv ? __shfl_xor_sync(0xffffffffu, sl, m) : 0.f;
            add_pair(h[i], l[i], rh, rl);   // level 0: every lo is 0
          }
        } else {
          const float rh = __shfl_xor_sync(0xffffffffu, h[0], m);
          const float rl = __shfl_xor_sync(0xffffffffu, l[0], m);
          add_pair(h[0], l[0], rh, rl);
        }
      }
      if ((tx & (16 / RM - 1)) == 0) {   // one lane of the pair (or four)
        float* p = run + 4 * (ty + 16 * r);
        add_pair(p[0], p[1], h[0], l[0]);
        if (seg_end) {
          const int row = t0 + ty + 16 * r;
          if (splits == 1)
            add_pair(p[2], p[3], p[0], p[1]);
          else if (row < nt)
            partial[((size_t)t * nseg + tile / seg) * nt + row] =
                make_float2(p[0], p[1]);
          p[0] = p[1] = 0.f;
        }
      }
    }
    __syncthreads();   // the stage is refilled two items on
  }

  if (splits == 1) {
    for (int r = tid; r < BM; r += NT)
      if (t0 + r < nt)
        out[(size_t)t * nt + t0 + r] = __fadd_rn(run[4 * r + 2],
                                                 run[4 * r + 3]);
    return;
  }
  __threadfence();
  __syncthreads();
  int* tk = ticket + (size_t)t * gridDim.x + blockIdx.x;
  if (tid == 0) last_block = atomicAdd(tk, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  constexpr int INFLIGHT = 16;   // loads issued before their additions
  for (int r = t0 + tid; r < min(t0 + BM, nt); r += NT) {
    const float2* pr = partial + (size_t)t * nseg * nt + r;
    float h = 0.f, l = 0.f;
    for (int q0 = 0; q0 < nseg; q0 += INFLIGHT) {
      float2 p[INFLIGHT];
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u)
        if (q0 + u < nseg) p[u] = __ldcg(pr + (size_t)(q0 + u) * nt);
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u)   // segment order, as unsplit
        if (q0 + u < nseg) add_pair(h, l, p[u].x, p[u].y);
    }
    out[(size_t)t * nt + r] = __fadd_rn(h, l);
  }
  if (tid == 0) *tk = 0;
}

// what kernels/decision.py's decision_plan chose
struct Plan {
  int rows, chunk, splits, seg, smem_bytes;
};

template <typename TZ, typename TS, int RM>
int launch(const TZ* z, const TS* sv, const float* coef, float* out, int nt,
           int ntasks, int w, int d, float gamma, int rbf, const Plan& pl,
           float2* partial, int* ticket, int vz, int vs, cudaStream_t s) {
  constexpr int BM = 16 * RM;
  const int nch = (round4(d) + pl.chunk - 1) / pl.chunk;
  const int smem = smem_bytes(BM, pl.chunk, nch, sizeof(TS));
  if (smem != pl.smem_bytes)   // the host's plan sizes the tile otherwise
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decision_kernel<TZ, TS, RM>;
  static std::atomic<bool> allowed[MAX_DEVICES];
  if (const int e = allow_max_smem(kern, allowed)) return e;
  const dim3 grid((nt + BM - 1) / BM, ntasks, pl.splits);
  kern<<<grid, NT, smem, s>>>(z, nt, sv, coef, w, d, gamma, rbf, pl.chunk,
                              pl.seg, vz, vs, partial, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TZ, typename TS>
int dispatch(const TZ* z, const TS* sv, const float* coef, float* out, int nt,
             int ntasks, int w, int d, float gamma, int rbf, const Plan& pl,
             float2* partial, int* ticket, int vz, int vs, cudaStream_t s) {
  const int ntiles = (w + SV_TILE - 1) / SV_TILE;
  const int nseg = pl.seg < 1 ? 0 : (ntiles + pl.seg - 1) / pl.seg;
  if (pl.chunk < 4 || pl.chunk % 4 || pl.chunk > RES_WIDTH ||
      pl.splits < 1 || pl.splits > nseg || pl.splits > 65535 ||
      ntasks > 65535 ||
      (pl.splits > 1 && (partial == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pl.rows == 128)
    return launch<TZ, TS, 8>(z, sv, coef, out, nt, ntasks, w, d, gamma, rbf, pl,
                        partial, ticket, vz, vs, s);
  if (pl.rows == 64)
    return launch<TZ, TS, 4>(z, sv, coef, out, nt, ntasks, w, d, gamma, rbf, pl,
                        partial, ticket, vz, vs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes of the bank (sv_dtype below)
constexpr int BANK_FP32 = 0, BANK_FP16 = 1, BANK_BF16 = 2;

extern "C" {

// rows (64 or 128), chunk, splits, seg (SV tiles a segment) and
// smem_bytes (the block's dynamic shared memory, which must equal this
// side's count) come from kernels/decision.py's decision_plan; with
// splits > 1, partial holds (T, ceil(ceil(w / 64) / seg), nt) float2 and
// ticket T x ceil(nt / rows) ints, all 0. bf16 says the test rows are
// bfloat16 (else float32); sv_dtype is the bank's (BANK_*): float32 rows
// take any, bfloat16 rows a bfloat16 bank.
int svm_multitask_decision(const void* z, const void* sv, const float* coef,
                           float* out, int nt, int ntasks, int w, int d,
                           float gamma, int rbf, int bf16, int sv_dtype,
                           int rows, int chunk, int splits, int seg,
                           int smem_bytes, void* partial, void* ticket,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(partial);
  int* tk = static_cast<int*>(ticket);
  const Plan pl{rows, chunk, splits, seg, smem_bytes};
  const auto* zf = static_cast<const float*>(z);
  const auto* sh = static_cast<const __half*>(sv);
  const auto* sb = static_cast<const __nv_bfloat16*>(sv);
  if (bf16) {
    if (sv_dtype != BANK_BF16) return static_cast<int>(cudaErrorInvalidValue);
    const auto* zb = static_cast<const __nv_bfloat16*>(z);
    return dispatch(zb, sb, coef, out, nt, ntasks, w, d, gamma, rbf, pl, p,
                    tk, copy_width16(zb, d), copy_width_raw16(sb, d), s);
  }
  const int vz = copy_width(z, d);
  switch (sv_dtype) {
    case BANK_FP32:
      return dispatch(zf, static_cast<const float*>(sv), coef, out, nt,
                      ntasks, w, d, gamma, rbf, pl, p, tk, vz,
                      copy_width(sv, d), s);
    case BANK_FP16:
      return dispatch(zf, sh, coef, out, nt, ntasks, w, d, gamma, rbf, pl, p,
                      tk, vz, copy_width_raw16(sh, d), s);
    case BANK_BF16:
      return dispatch(zf, sb, coef, out, nt, ntasks, w, d, gamma, rbf, pl, p,
                      tk, vz, copy_width_raw16(sb, d), s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The single-task entry: the same kernel with one task, RBF, the bank in
// the test rows' dtype.
int svm_decision(const void* z, const void* sv, const float* coef,
                 float* out, int nt, int w, int d, float gamma, int bf16,
                 int rows, int chunk, int splits, int seg, int smem_bytes,
                 void* partial, void* ticket, void* stream) {
  return svm_multitask_decision(z, sv, coef, out, nt, 1, w, d, gamma, 1,
                                bf16, bf16 ? BANK_BF16 : BANK_FP32, rows,
                                chunk, splits, seg, smem_bytes, partial,
                                ticket, stream);
}

}  // extern "C"
