// dcd_epoch: one epoch of the low-rank tier's dual coordinate descent.
//
// No Pallas counterpart. The reference runs the epoch as an XLA device
// loop (`lax.fori_loop` over `coord` in `dcd_qp`,
// src/repro/core/linear.py:121-151); in eager PyTorch the same loop
// would issue about eight launches per coordinate, so the whole epoch is
// one launch, reached through `ops.dcd_epoch` (one problem) and
// `ops.dcd_epoch_tasks` (a task axis: one block a task). For t = 0 .. n-1,
// with i = perm[t]:
//   g    = y_i (phi_i . w + bias wb) + p_i
//   pg   = g projected at an active bound of [lo_i, hi_i]
//   viol = max(viol, |pg|)                       over live coordinates
//   d    = clip(beta_i - g / q_i, lo_i, hi_i) - beta_i   (0 if not live)
//   beta_i += d;  w += d y_i phi_i;  wb += d y_i bias
// Coordinates are strictly sequential: each step reads the w that every
// earlier step wrote.
//
// Bound: one read of Phi (4 n k bytes; 121 MB at 29,491 x 1,024, 0.036
// ms at 3.35 TB/s) is the byte bound, but a chain of n dependent steps
// sets the real floor, on one SM per problem. Design (the "ring" route;
// one producer warp and four consumer warps a block):
//
// * Rows staged ahead. The producer walks perm ahead of the sweep and
//   fills a ring of `depth` slots in shared memory, in stages of one
//   window each: a slot gets its coordinate's row by a TMA bulk copy
//   (cp.async.bulk, when k % 4 == 0 and Phi is 16-byte aligned; else
//   4-byte cp.async copies) and the coordinate's index, y, p, lo, hi, q
//   and live flag. Each stage has a "full" mbarrier (one producer
//   arrival plus the copies' bytes) and an "empty" one (one arrival per
//   consumer warp once it is done with the stage): one barrier test a
//   window, not a coordinate, since a test costs ~300 cycles on the
//   H100 even when the phase has completed. A random 4 KB row of a Phi
//   larger than L2 is an HBM round trip; with up to 64 slots in flight
//   the sweep does not wait on it (a build that never copies the rows,
//   timed by kernel_times.py --dcd-sweep, runs no faster).
// * A lookahead window of `window` (L) coordinates. At each window's
//   start the consumer warps compute, in one pass over their columns,
//   u_s = phi_s . w for the window's staged rows and the window's Gram
//   G_st = phi_s . phi_t (s < t), with one block-wide reduction for all
//   of them (a transposing warp reduction, then the four warps'
//   partials added in a fixed order). Every consumer thread then takes
//   the L Newton steps in order, redundantly (no broadcast):
//     g_t = y_t (u_t + sum_{s<t} d_s y_s G_st + bias wb) + p_t,
//   with wb advanced one step at a time and q_t the caller's q_diag;
//   then w += d_s y_s phi_s for s in order, once for the window, over
//   the columns each thread owns. In exact arithmetic each coordinate
//   sees the w of the sequential sweep, so the iterates are those of the
//   same solver; only the rounding of the dot products differs (w's own
//   updates round as the plain version's). The ring holds at least two
//   windows (depth >= 2 L), so the next window's rows arrive while this
//   one is computed.
// * Exact for any perm. beta is not staged by the producer: each window
//   loads the next window's betas once that window's stage is full,
//   after every earlier window has written its own, and takes this
//   window's results forward for an index that repeats across the two;
//   a repeated index inside a window takes the result of its earlier
//   occurrence, and only its last occurrence writes beta back. The
//   check is 2 L - 1 warp shuffles unless an index repeats.
// * The scalar step rounds each operation (__f*_rn) as the plain version
//   does; viol is the max |pg| over live coordinates, each taken before
//   its step; d = 0 on a dead coordinate.
//
// Larger k leaves fewer slots (and a smaller window, L <= depth / 2);
// where two slots and w no longer fit the 227 KB a block may opt in to,
// the "direct" route runs: one 256-thread block reads each row from
// memory, the next coordinate's scalars loaded a step ahead, w in shared
// memory. k is limited
// by w alone (MAX_RANK). The launch plan (route, window, depth, shared
// memory) is chosen by `kernels/dcd.py::dcd_plan` and checked here.
//
// The task axis: block b sweeps task tasks[b] (or b): coordinates
// [offsets[t], offsets[t+1]) of the concatenated y, p, lo, hi, q_diag,
// live, beta, perm (local indices) and rows (row of Phi of each local
// index), w row t of (T, k), wb[t]; viol[b]. Every block runs the
// arithmetic of a one-task launch, so a task's bits do not depend on
// which tasks share the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NC = 4;                     // consumer warps
constexpr int CONS = NC * 32;             // consumer threads
constexpr int RING_THREADS = CONS + 32;   // + the producer warp
constexpr int MAX_DEPTH = 64;
constexpr int SMEM_MAX = 232448;          // opt-in shared memory, sm_90
constexpr int DIRECT_THREADS = 256;
constexpr int DIRECT_WARPS = DIRECT_THREADS / 32;
// the largest k: w alone in the direct route's shared memory, beside its
// static partial-sum slots (ops.DCD_MAX_RANK holds the same number)
constexpr int MAX_RANK =
    (SMEM_MAX - 2 * DIRECT_WARPS * static_cast<int>(sizeof(float))) /
    static_cast<int>(sizeof(float));

struct Args {
  const float* phi;
  const int64_t* rows;     // null: row i of Phi for local index i
  const int64_t* offsets;  // null: one task of n coordinates
  const int64_t* tasks;    // null: block b sweeps task b
  const float *y, *p, *lo, *hi, *qd;
  const bool* live;
  const int64_t* perm;
  float *beta, *w, *wb, *viol;
  int n, k, kpad, depth;
  float bias;
  int tma;
};

struct Segment {
  int task;
  int64_t off;
  int n;
};

__device__ __forceinline__ Segment segment(const Args& a) {
  Segment s;
  s.task = a.tasks ? static_cast<int>(a.tasks[blockIdx.x])
                   : static_cast<int>(blockIdx.x);
  if (a.offsets) {
    s.off = a.offsets[s.task];
    s.n = static_cast<int>(a.offsets[s.task + 1] - s.off);
  } else {
    s.off = 0;
    s.n = a.n;
  }
  return s;
}

// ------------------------------------------------------------ PTX pieces
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_test(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed (a spin on the
// non-blocking test)
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  while (!mbar_test(b, parity)) {
  }
}

// one bulk copy global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void tma_copy(float* dst, const float* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the barrier's phase also waits for this thread's cp.async copies so far
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS) : "memory");
}

// --------------------------------------------------------- window sizes
__host__ __device__ constexpr int entries(int L) { return L * (L + 1) / 2; }
__host__ __device__ constexpr int pow2ceil(int v) {
  return v <= 1 ? 1 : 2 * pow2ceil((v + 1) / 2);
}
// accumulators of the transposing reduction: a power of two up to 32,
// past it a multiple of 32 (five halvings)
__host__ __device__ constexpr int padded(int e) {
  return e <= 32 ? pow2ceil(e) : (e + 31) / 32 * 32;
}
__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}
// G_st (s < t) after the L u_s entries, row-major upper triangle
__host__ __device__ constexpr int pair(int L, int s, int t) {
  return L + s * L - s * (s + 1) / 2 + (t - s - 1);
}

// shared memory of the ring route: ring, w, slot records, partial and
// final sums, barriers (kernels/dcd.py::ring_smem computes the same)
__host__ __device__ constexpr size_t ring_smem(int kpad, int L, int depth) {
  return sizeof(float) * (size_t)kpad * (depth + 1) + 48 * (size_t)depth +
         48 * (size_t)entries(L);
}

// Sum each of N values over the warp's 32 lanes, C of them still live:
// at each level a lane keeps half its values and hands the other half
// to its partner, so the shuffles total ~C, not 5 C. Afterwards, for C
// >= 32 lane l holds entries [l C/32, (l+1) C/32) in v[0..C/32); for C <
// 32 every lane holds entry l >> (5 - log2 C) in v[0]. Each entry's sum
// is added in an order fixed by the lane layout.
template <int N, int C, int O>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[N], int lane) {
  if constexpr (O > 0) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL_MASK, send, O);
      }
      warp_transpose_sum<N, H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(FULL_MASK, v[0], O);
      warp_transpose_sum<N, 1, O / 2>(v, lane);
    }
  }
}

// The indices and current betas of a window's coordinates, once its
// stage of the ring is full (`rec_w`: the stage's records); a missing
// coordinate gets an index distinct from all others.
template <int L>
__device__ __forceinline__ void load_window(int t0, int n, uint64_t* bar,
                                            uint32_t parity,
                                            const float4* rec_w,
                                            const float* beta, float (&b)[L],
                                            int (&ix)[L]) {
  mbar_wait(bar, parity);
#pragma unroll
  for (int s = 0; s < L; ++s) {
    b[s] = 0.f;
    ix[s] = -1 - s;
    if (t0 + s < n) {
      ix[s] = __float_as_int(rec_w[2 * s + 1].z);
      b[s] = __ldcg(beta + ix[s]);
    }
  }
}

// a coordinate's scalars as the ring's slot record holds them, and its
// row of Phi
struct Staged {
  float4 r0;   // y, p, lo, hi
  float4 r1;   // q, live (0 / 1), index (int bits), 0
  int64_t row;
};

__device__ __forceinline__ Staged stage(const Args& a, const Segment& seg,
                                        int64_t i) {
  const int64_t o = seg.off + i;
  return Staged{make_float4(a.y[o], a.p[o], a.lo[o], a.hi[o]),
                make_float4(a.qd[o], a.live[o] ? 1.f : 0.f,
                            __int_as_float(static_cast<int>(i)), 0.f),
                a.rows ? a.rows[o] : i};
}

// The L Newton steps of a window, in order, from u_s (fw[s]) and G
// (fw[pair(L, s, t)]), the records `rec_w` of its stage: dys[s] = d_s
// y_s, bcur[s] the coordinate's beta after its step. A coordinate past
// the window's end (s >= lw) is dead. REPEATS: a later occurrence of an
// index starts from its earlier occurrence's result.
template <int L, bool REPEATS>
__device__ __forceinline__ void newton_steps(
    const float4* rec_w, const float* fw, int lw, float bias,
    const int (&icur)[L], float (&bcur)[L], float (&dys)[L], float& wb,
    float& viol) {
  float4 r0[L], r1[L];
  float corr[L];
#pragma unroll
  for (int s = 0; s < L; ++s) {
    r0[s] = rec_w[2 * s];
    r1[s] = rec_w[2 * s + 1];
    corr[s] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < L; ++s) {
    const float cy = r0[s].x, cp = r0[s].y, clo = r0[s].z, chi = r0[s].w;
    const float cq = r1[s].x;
    const bool clive = r1[s].y != 0.f && s < lw;
    const float b = bcur[s];
    const float dot = __fadd_rn(fw[s], corr[s]);
    const float g =
        __fadd_rn(__fmul_rn(cy, __fadd_rn(dot, __fmul_rn(bias, wb))), cp);
    const bool at_lo = b <= clo, at_hi = b >= chi;
    const float pg = at_lo ? fminf(g, 0.f) : (at_hi ? fmaxf(g, 0.f) : g);
    viol = clive ? fmaxf(viol, fabsf(pg)) : viol;
    const float b_new =
        fminf(fmaxf(__fsub_rn(b, __fdiv_rn(g, cq)), clo), chi);
    const float d = clive ? __fsub_rn(b_new, b) : 0.f;
    const bool moved = d != 0.f;
    const float dy = moved ? __fmul_rn(d, cy) : 0.f;
    wb = moved ? __fadd_rn(wb, __fmul_rn(dy, bias)) : wb;
    const float b_out = moved ? __fadd_rn(b, d) : b;
    dys[s] = dy;
#pragma unroll
    for (int t = s + 1; t < L; ++t)
      corr[t] = fmaf(dy, fw[pair(L, s, t)], corr[t]);
    bcur[s] = b_out;
    if constexpr (REPEATS) {
#pragma unroll
      for (int t = s + 1; t < L; ++t)
        if (icur[t] == icur[s]) bcur[t] = b_out;
    }
  }
}

// ------------------------------------------------------------ ring route
// The ring is `depth` = S L slots in S stages, one window a stage; each
// stage has one "full" and one "empty" barrier.
template <int L>
__global__ void __launch_bounds__(RING_THREADS, 1) dcd_ring_kernel(Args a) {
  constexpr int E = entries(L);
  constexpr int P = padded(E);
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = a.kpad, depth = a.depth, k = a.k;
  const int stages = depth / L;
  float* ring = reinterpret_cast<float*>(smem);
  float* w = ring + (size_t)depth * kpad;
  float4* rec = reinterpret_cast<float4*>(w + kpad);  // [depth][2]
  float4* part = rec + 2 * depth;                     // [2][E]: NC partials
  float* fin = reinterpret_cast<float*>(part + 2 * E);  // [4][E]
  uint64_t* full = reinterpret_cast<uint64_t*>(fin + 4 * E);
  uint64_t* empty = full + depth;

  const Segment seg = segment(a);
  const int n = seg.n;
  const int n_win = (n + L - 1) / L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* wt = a.w + (size_t)seg.task * k;
  for (int j = tid; j < kpad; j += RING_THREADS) w[j] = j < k ? wt[j] : 0.f;
  // a zero ring: pad columns stay zero, and a slot past the end of a
  // short last window holds zeros or an earlier row, finite either way
  for (int e = tid; e < depth * kpad / 4; e += RING_THREADS)
    reinterpret_cast<float4*>(ring)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the zeros land before any copy into the ring
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float* beta = a.beta + seg.off;

  if (warp == NC) {
    // ------------------------------------------------------ producer
    // Batches of whole windows, a lane a position. The consumers hold
    // two stages; a batch takes half the rest (at most 32 positions).
    // While a batch waits for its stages, the next batch's scalars and
    // the indices of the one after are already loading; one wait a
    // batch, on its last stage (the consumers free stages in order),
    // and one arrival a window on its stage's "full" barrier, after
    // every lane of the window has posted its bytes and its record.
    int bw = (stages - 2) / 2;
    bw = bw < 1 ? 1 : (bw * L > 32 ? 32 / L : bw);
    const int batch = bw * L;
    const bool on = lane < batch;
    const int64_t* perm = a.perm + seg.off;
    Staged cur{};
    if (on && lane < n) cur = stage(a, seg, perm[lane]);
    int64_t i_next = on && batch + lane < n ? perm[batch + lane] : 0;
    for (int t0 = 0, w0 = 0; t0 < n; t0 += batch, w0 += bw) {
      const int t = t0 + lane;
      Staged nxt{};
      if (on && t + batch < n) nxt = stage(a, seg, i_next);
      const int64_t i_after =
          on && t + 2 * batch < n ? perm[t + 2 * batch] : 0;
      const int w_last = (w0 + bw < n_win ? w0 + bw : n_win) - 1;
      if (w_last >= stages)
        mbar_wait(&empty[w_last % stages], (w_last / stages - 1) & 1);
      const int st = (w0 + lane / L) % stages;
      if (on && t < n) {
        const int slot = st * L + lane % L;
        float* dst = ring + (size_t)slot * kpad;
        const float* src = a.phi + cur.row * k;
        if (a.tma) {
          mbar_expect_tx(&full[st], static_cast<uint32_t>(k) * 4u);
          tma_copy(dst, src, static_cast<uint32_t>(k) * 4u, &full[st]);
        } else {
          for (int j = 0; j < k; ++j) cp_async4(dst + j, src + j);
          cp_async_arrive(&full[st]);
        }
        rec[2 * slot] = cur.r0;
        rec[2 * slot + 1] = cur.r1;
      }
      __syncwarp();
      if (on && t < n && lane % L == 0) mbar_arrive(&full[st]);
      cur = nxt;
      i_next = i_after;
    }
    // stay until the consumers have released every stage still in use
    const int wj = n_win - 1 - lane;
    if (lane < stages && wj >= 0)
      mbar_wait(&empty[wj % stages], (wj / stages) & 1);
    return;
  }

  // -------------------------------------------------------- consumers
  const int ct = tid;   // 0 .. CONS-1
  const float bias = a.bias;
  float wb = a.wb[seg.task];
  float viol = 0.f;
  float* fw = fin + warp * E;   // this warp's copy of u and G

  // betas and indices of the current window, and of the next one; the
  // current window's stage and the parity of its use
  float bcur[L], bnxt[L];
  int icur[L], inxt[L];
  int st = 0;
  uint32_t parity = 0;
  if (n_win > 0) load_window<L>(0, n, &full[0], 0, rec, beta, bcur, icur);

  for (int win = 0; win < n_win; ++win) {
    const int t0 = win * L;
    const int lw = n - t0 < L ? n - t0 : L;
    const bool more = win + 1 < n_win;
    const int st_next = st + 1 == stages ? 0 : st + 1;
    const uint32_t parity_next = st_next == 0 ? parity ^ 1u : parity;
    // the next window's rows and betas: they arrive while this one runs
    if (more)
      load_window<L>(t0 + L, n, &full[st_next], parity_next,
                     rec + 2 * st_next * L, beta, bnxt, inxt);
    const float* rows_w = ring + (size_t)st * L * kpad;
    const float4* rec_w = rec + 2 * st * L;

    // u_s = phi_s . w and G_st = phi_s . phi_t over this thread's columns
    float acc[P];
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] = 0.f;
#pragma unroll 2
    for (int j = ct; j < kpad; j += CONS) {
      float x[L + 1];
      x[0] = w[j];
#pragma unroll
      for (int s = 0; s < L; ++s) x[s + 1] = rows_w[s * kpad + j];
#pragma unroll
      for (int s = 0; s < L; ++s) acc[s] = fmaf(x[s + 1], x[0], acc[s]);
#pragma unroll
      for (int s = 0; s < L; ++s)
#pragma unroll
        for (int t = s + 1; t < L; ++t)
          acc[pair(L, s, t)] = fmaf(x[s + 1], x[t + 1], acc[pair(L, s, t)]);
    }
    warp_transpose_sum<P, P, 16>(acc, lane);
    float* partf = reinterpret_cast<float*>(part + (win & 1) * E);
    if constexpr (P >= 32) {
#pragma unroll
      for (int i = 0; i < P / 32; ++i) {
        const int e = lane * (P / 32) + i;
        if (e < E) partf[4 * e + warp] = acc[i];
      }
    } else {
      constexpr int SH = 5 - log2i(P);
      const int e = lane >> SH;
      if ((lane & ((1 << SH) - 1)) == 0 && e < E) partf[4 * e + warp] = acc[0];
    }
    consumers_sync();
    // the consumer warps' partials in a fixed order, into this warp's copy
    for (int e = lane; e < E; e += 32) {
      const float4 v = part[(win & 1) * E + e];
      const float pv[4] = {v.x, v.y, v.z, v.w};
      float sum = pv[0];
#pragma unroll
      for (int c = 1; c < NC; ++c) sum = __fadd_rn(sum, pv[c]);
      fw[e] = sum;
    }
    __syncwarp();

    // does an index repeat in this window, or across it and the next?
    int mine = -1000 - lane;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      if (lane == s) mine = icur[s];
      if (more && lane == L + s) mine = inxt[s];
    }
    bool same = false;
#pragma unroll
    for (int o = 1; o < 2 * L; ++o)
      same |= __shfl_sync(FULL_MASK, mine, (lane + o) % (2 * L)) == mine;
    const bool repeats = __any_sync(FULL_MASK, same && lane < 2 * L);

    // the window's Newton steps, in order (every consumer thread alike)
    float dys[L];
    if (repeats)
      newton_steps<L, true>(rec_w, fw, lw, bias, icur, bcur, dys, wb, viol);
    else
      newton_steps<L, false>(rec_w, fw, lw, bias, icur, bcur, dys, wb, viol);
    // each index's last result in the window goes back to beta (from
    // every warp alike, so each warp's later loads see its own write)
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < L; ++s) {
        bool last = s < lw;
        if (repeats) {
#pragma unroll
          for (int t = s + 1; t < L; ++t) last = last && icur[t] != icur[s];
        }
        if (last) beta[icur[s]] = bcur[s];
      }
    }

    // w += d_s y_s phi_s, s in order, over this thread's columns (a
    // coordinate that did not move adds d_s y_s phi_s = 0)
    bool any_moved = false;
#pragma unroll
    for (int s = 0; s < L; ++s) any_moved |= dys[s] != 0.f;
    if (any_moved) {
#pragma unroll 2
      for (int j = ct; j < kpad; j += CONS) {
        float wj = w[j];
#pragma unroll
        for (int s = 0; s < L; ++s)
          wj = __fadd_rn(wj, __fmul_rn(dys[s], rows_w[s * kpad + j]));
        w[j] = wj;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);

    if (more) {   // the next window, with this one's results taken forward
      if (repeats) {
#pragma unroll
        for (int s = 0; s < L; ++s)
#pragma unroll
          for (int r = 0; r < L; ++r)
            if (inxt[s] == icur[r]) bnxt[s] = bcur[r];
      }
#pragma unroll
      for (int s = 0; s < L; ++s) {
        bcur[s] = bnxt[s];
        icur[s] = inxt[s];
      }
    }
    st = st_next;
    parity = parity_next;
  }

  for (int j = ct; j < k; j += CONS) wt[j] = w[j];
  if (ct == 0) {
    a.wb[seg.task] = wb;
    a.viol[blockIdx.x] = viol;
  }
}

// ---------------------------------------------------------- direct route
struct Coord {
  float y, p, lo, hi, q, beta;
  bool live;
};

__device__ __forceinline__ Coord load_coord(int64_t i, const float* y,
                                            const float* p, const float* lo,
                                            const float* hi, const float* qd,
                                            const bool* live,
                                            const float* beta) {
  return Coord{y[i], p[i], lo[i], hi[i], qd[i], beta[i], live[i]};
}

// One block of 256 threads; w in shared memory, thread t owning slots j
// = t + 256 r; each row read from memory at its step, the next
// coordinate's index and scalars a step ahead; one __syncthreads a
// coordinate (the dot product's warp partials through a double-buffered
// slot), the Newton step taken by every thread alike.
__global__ void __launch_bounds__(DIRECT_THREADS)
    dcd_direct_kernel(Args a) {
  extern __shared__ float wsh[];
  __shared__ float part[2][DIRECT_WARPS];
  const Segment seg = segment(a);
  const int n = seg.n, k = a.k;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* wt = a.w + (size_t)seg.task * k;
  for (int j = tid; j < k; j += DIRECT_THREADS) wsh[j] = wt[j];
  __syncthreads();
  const float* y = a.y + seg.off;
  const float* p = a.p + seg.off;
  const float* lo = a.lo + seg.off;
  const float* hi = a.hi + seg.off;
  const float* qd = a.qd + seg.off;
  const bool* live = a.live + seg.off;
  const int64_t* perm = a.perm + seg.off;
  float* beta = a.beta + seg.off;
  const float bias = a.bias;
  float wb = a.wb[seg.task], viol = 0.f;

  int64_t i = n > 0 ? perm[0] : 0;
  Coord c{};
  if (n > 0) c = load_coord(i, y, p, lo, hi, qd, live, beta);
  for (int t = 0; t < n; ++t) {
    const bool more = t + 1 < n;
    const int64_t inext = more ? perm[t + 1] : i;
    Coord cn = c;
    if (more) cn = load_coord(inext, y, p, lo, hi, qd, live, beta);
    const int64_t r = a.rows ? a.rows[seg.off + i] : i;
    const float* row = a.phi + r * k;
    float acc = 0.f;
    for (int j = tid; j < k; j += DIRECT_THREADS)
      acc = fmaf(row[j], wsh[j], acc);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, s);
    float* buf = part[t & 1];
    if (lane == 0) buf[warp] = acc;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < DIRECT_WARPS; ++q) dot = __fadd_rn(dot, buf[q]);

    const float g = __fadd_rn(
        __fmul_rn(c.y, __fadd_rn(dot, __fmul_rn(bias, wb))), c.p);
    const bool at_lo = c.beta <= c.lo, at_hi = c.beta >= c.hi;
    const float pg = at_lo ? fminf(g, 0.f) : (at_hi ? fmaxf(g, 0.f) : g);
    if (c.live) viol = fmaxf(viol, fabsf(pg));
    const float b_new =
        fminf(fmaxf(__fsub_rn(c.beta, __fdiv_rn(g, c.q)), c.lo), c.hi);
    const float d = c.live ? __fsub_rn(b_new, c.beta) : 0.f;
    if (d != 0.f) {   // uniform: every thread computed the same d
      const float dy = __fmul_rn(d, c.y);
      for (int j = tid; j < k; j += DIRECT_THREADS)
        wsh[j] = __fadd_rn(wsh[j], __fmul_rn(dy, row[j]));
      wb = __fadd_rn(wb, __fmul_rn(dy, bias));
      const float b_out = __fadd_rn(c.beta, d);
      if (tid == 0) beta[i] = b_out;
      if (inext == i) cn.beta = b_out;   // a repeated index sees its update
    }
    i = inext;
    c = cn;
  }
  for (int j = tid; j < k; j += DIRECT_THREADS) wt[j] = wsh[j];
  if (tid == 0) {
    a.wb[seg.task] = wb;
    a.viol[blockIdx.x] = viol;
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, int blocks, int threads, size_t smem,
                  const Args& a, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// window 0: the direct route (smem_bytes = 4 k); else the ring route
// with `window` in {1, 2, 4, 8} and 2 window <= depth <= MAX_DEPTH, whose
// shared memory must equal smem_bytes (dcd.py's plan). Returns a
// cudaError_t.
int svm_dcd_epoch(const float* phi, const int64_t* rows,
                  const int64_t* offsets, const int64_t* tasks, int blocks,
                  const float* y, const float* p, const float* lo,
                  const float* hi, const float* qd, const bool* live,
                  const int64_t* perm, float* beta, float* w, float* wb,
                  float* viol, int n, int k, float bias, int window,
                  int depth, int smem_bytes, void* stream) {
  if (k < 1 || k > MAX_RANK || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{phi, rows, offsets, tasks, y, p, lo, hi, qd, live, perm,
         beta, w, wb, viol, n, k, (k + 3) / 4 * 4, depth, bias, 0};
  if (window == 0) {
    if (smem_bytes != static_cast<int>(sizeof(float)) * k)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_kernel(dcd_direct_kernel, blocks, DIRECT_THREADS,
                         static_cast<size_t>(smem_bytes), a, s);
  }
  const size_t smem = ring_smem(a.kpad, window, depth);
  if (depth < 2 * window || depth % window != 0 || depth > MAX_DEPTH ||
      smem > SMEM_MAX ||
      smem != static_cast<size_t>(smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  a.tma = (k % 4 == 0 && reinterpret_cast<uintptr_t>(phi) % 16 == 0) ? 1 : 0;
  switch (window) {
    case 1:
      return launch_kernel(dcd_ring_kernel<1>, blocks, RING_THREADS, smem, a, s);
    case 2:
      return launch_kernel(dcd_ring_kernel<2>, blocks, RING_THREADS, smem, a, s);
    case 4:
      return launch_kernel(dcd_ring_kernel<4>, blocks, RING_THREADS, smem, a, s);
    case 8:
      return launch_kernel(dcd_ring_kernel<8>, blocks, RING_THREADS, smem, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
