// rbf_gram: the Gram block, the Gram matvec and the Gram row of the SMO
// solver.
//
// Replaces `rbf_gram_pallas` / `_rbf_gram_kernel`
// (src/repro/kernels/rbf_gram.py), reached through `ops.rbf_gram`,
// `ops.gram_matvec`, `ops.gram_row` and `ops.gram_row_cached`:
//   K = exp(-gamma * max(|a|^2 + |b|^2 - 2 a.b^T, 0))   (mode rbf)
//   K = a.b^T                                            (mode linear)
// with the squared norms computed by the caller in float32 from the
// rounded operands, as rbf_gram.py:112-113 does.
//
// Block route: one mainloop, two entries. The block entry
// (ops.rbf_gram: the pallas engine's block, cross and full) stores K;
// the matvec entry (ops.gram_matvec: the engine's matvec, with a task
// axis for a multiclass bucket) returns K(X, X) v and never writes K.
// Bound: n m (2d + 6) operations (2 more a pair for the matvec) against
// reading the operands and writing K (4 n m bytes) or the (n,) result.
// On the CUDA cores the operations set it: at 2048 x 29,491 x 102
// 0.189 ms of float32 FMAs against a 0.072 ms K write, and a matvec at
// n = 29,491 is 2.75 ms. The first design, a 64 x 64 FMA tile, ran the
// block at 26 % of that, and the matvec wrote each 2048-row block of K
// to device memory for a GEMV to read back. Design:
//
// * The dots go on the tensor cores by mma.sync. bfloat16 operands as
//   they are (m16n8k16, float32 accumulation: bf16 products are exact).
//   float32 operands as 3xTF32 (m16n8k8): each operand is split into its
//   TF32 rounding (hi) and the TF32 rounding of the rest (lo), and
//   lo*hi, hi*lo, hi*hi accumulate in float32 in that order each step:
//   ~22 bits of each operand, which holds the float32 parity bound
//   (GRAM_TOL) that a single TF32 product (10 bits) would break. The
//   tensor-core bound is then 3 x 2 n m d / 495 TFLOP/s (fp32) or
//   2 n m d / 989 (bf16), and the epilogue's expf (~16 instructions a
//   pair) is of the same order.
// * A block owns a tile of 32, 64 or 128 rows: two MMA warps per 32
//   rows, a warp 32 rows x 64 columns (2 x 8 MMA tiles) whose fragments
//   come by ldmatrix, and one producer warp. The rows stay in shared
//   memory while the block walks column tiles of 128 in a fixed order
//   through a ring of 2 or 3 stages that the producer fills by TMA bulk
//   copies: one a tile where the rows lie in global memory as they do
//   in shared memory (rbf_gram.staged pads them so, and the pallas
//   engines keep their training rows padded so: 102 floats to 108), else
//   one a row, whose rows must lie at 16-byte multiples. Each stage
//   has a full and an empty mbarrier, so the MMA warps run out of step:
//   one warp's epilogue overlaps another's MMAs, and no thread waits on
//   a copy it did not need. Two earlier versions of this design were
//   slower (kernel_times.py --gram-sweep): every thread copying 4 bytes
//   at a time by cp.async between two block barriers a tile spent a
//   third of the time on the copies; one producer warp issuing those
//   copies took longer than the MMAs.
// * The depth is staged whole, up to 128 32-bit words (past that in
//   chunks of 64, the rows then staged again each chunk), and the MMA
//   steps run to a multiple of 8 words (8 floats or 16 bf16: d = 102
//   runs to 104 or 112); the step that reaches past d zeroes the words
//   past it as they are loaded, so whatever the row's padding holds is
//   never read. Staged rows are chunk + 4 words apart, so the 8 rows x
//   16 bytes of an ldmatrix fall on 32 distinct banks.
// * Block epilogue: rbf_epilogue (or the dot), through a per-warp
//   staging in shared memory so that each store writes 32 consecutive
//   floats of a row of K (the accumulator layout spreads a warp's values
//   over 8 rows). The grid splits each row tile's column tiles into
//   groups so that one wave of blocks fills the card.
// * Matvec epilogue: K = 2^min(2 g dot - g |a|^2 - g |b|^2, 0) with
//   g = gamma log2(e) folded into a constant a row and one a column
//   (ex2.approx, ~6 instructions a pair against rbf_epilogue's ~16:
//   870 M pairs a matvec at n = 29,491); each thread multiplies its 16
//   values of a column tile by v[c] (fmaf, in column order) into a
//   partial and adds the partial to its row's running sum; after the
//   last tile a fixed tree (the 4 lanes of a row, then the two warps of
//   a row) leaves one value a row. No atomics: a row's bits depend only
//   on n (the column tiles of 128 and the order inside them), not on the
//   grid, the row tile or T, so row t of a task-axis launch (task =
//   blockIdx.y) equals the lone call on task t bit for bit. The launch
//   plan is rbf_gram.gram_plan's; the host side below refuses any other.
// * What bounds it (kernel_times.py --gram-sweep, H100): the mma.sync
//   TF32 products. A build with one product a step instead of three
//   runs the fp32 matvec in about half the time, and one without MMAs in
//   a tenth: the three products run near mma.sync's TF32 rate, well
//   under the tensor cores' wgmma peak. So the float32 matvec with
//   d <= 104, the one every exact fit runs, has a wgmma route of its own
//   (below); the block entry and bf16 keep this mainloop.
//
// Row mode (n, 1), twice per SMO iteration: K(X, x_i), a GEMV whose
// byte bound is one read of X (n d 4 bytes: 3.6 us at 29,491 x 102 on
// the H100's 3.35 TB/s; X stays in the 50 MB L2 across the SMO loop, so
// the L2 read rate is the nearer floor). What bounded PR 11's row kernel
// on the H100 (8.4 us device, 44 % of the byte bound) was latency, not
// bytes: four dependent round trips (the hit flag, the index, x_i behind
// a block barrier, then the rows) before the first multiply, a 5-step
// shuffle tree per row with a quarter of the lanes idle at d = 102, and,
// around it, ~15 small torch launches of the LRU lookup per row (the
// exact fits are host-bound, so those launches were most of its cost).
// Design:
//
// * A warp owns 32 consecutive rows (its chunk, a contiguous
//   32 d-element slice of X: a multiple of 16 bytes for float32 and
//   bfloat16 alike). Lane 0 starts the chunk's copy into shared memory
//   with one TMA bulk copy (cp.async.bulk, completion on the warp's
//   mbarrier) first thing, before reading the index, the norms or the
//   cache keys: the slice does not depend on them. A chunk whose start
//   is not 16-byte aligned (a task of a bucket with an odd row count),
//   and the ragged end of a task's last chunk, are copied by ordinary
//   loads instead.
// * Meanwhile the block reads i, stages x_i (float32) in shared memory
//   and, in the cached entry, warp 0 performs the LRU lookup; one block
//   barrier, then each lane waits for its warp's chunk and reduces its
//   whole row from shared memory (float2 / bf16x2 reads, conflict-free
//   at d = 102), with no shuffle tail.
// * A row's features are summed in one fixed order that does not depend
//   on the grid, the route or the entry: even features into one
//   accumulator and odd ones into another, each in feature order, then
//   their sum. So the cached entry, the uncached one and row t of a
//   task-axis launch give the same bits for the same row.
// * Eight row warps a block (fewer where their chunks do not fit the
//   227 KB a block may opt in to): every block stages x_i and, cached,
//   reads the keys, all from the same few L2 lines, so fewer and larger
//   blocks finish sooner (kernel_times.py --smo-sweep times a build with
//   four). Very wide rows (one 32-row chunk past that shared memory)
//   read X directly from global memory, with the same arithmetic.
//
// The cached entry (ops.gram_row_cached) folds in the solver's LRU row
// cache (kernel_engine.RowCache: keys, stamp, rows, clock, hits,
// misses), so one launch is one row call. Every block finds the slot
// redundantly (a slot count of 32 is 512 bytes of keys and stamps): the
// first slot whose key is i is a hit, else the first slot with the
// least stamp is the victim. On a miss every block writes its part of
// the row into rows[slot] and into the output; on a hit it copies its
// part of rows[slot] to the output (a block whose rows all hit still
// waits for its copies before it exits). One block then writes keys,
// stamp, clock, hits and misses, as the plain lookup does. That must
// happen after every block has read the keys and stamps, so the writer
// is the last block to take a ticket (an atomic count, set back to 0 by
// the writer for the next launch on the stream): block 0 writing them at
// once could turn a late block's miss into a hit of a row not yet
// written. The lookup is an extra warp's (it owns no rows):
// it reads the first 32 keys and stamps, the clock and the counts before
// the index, with the chunks' copies in flight, publishes the slot
// through a named barrier it arrives at without waiting, and then takes
// the ticket, off the row warps' path.
//
// Task axis: a multiclass bucket of T binary tasks stacks X as
// (T, n, d) with norms (T, n) and one index per task; task t is
// blockIdx.y and writes row t of a (T, n) output, so one launch serves
// the whole bucket (the reference vmaps its row call over the bucket).
// T = 1 is the uncached entry.
//
// Row range (one rank of the data-parallel SMO, core/smo.py
// sharded_solve_qp): the row entries and the matvec take the full, staged
// X and compute only output rows [row0, row0 + count) of it, K(X, x_i)
// for a global i, or rows of K(X, X) v over all n columns. The row
// entries write 0 for an output row past X's last (the padding of the
// last rank's block); the matvec's caller zeroes those. A row's bits do
// not depend on the range: the row kernel computes each entry on its
// own, and a matvec row's order is fixed by n, the column count, so a
// range is a slice of the full call bit for bit.
#include "common.cuh"
#include "mma.cuh"
#include "tile_f32.cuh"

#include <atomic>

namespace {

using namespace svm;

// ----------------------------------------------------------- block route
constexpr int GT_COLS = 128;       // columns of a column tile
constexpr int GT_WARP_COLS = 64;   // columns of a warp's tile
constexpr int GT_KSTEP = 8;        // 32-bit words of depth an MMA step takes
constexpr int GT_MAX_CHUNK = 128;  // widest depth (words) staged whole
constexpr int GT_CHUNK = 64;       // words a stage holds past it
constexpr int GT_MAX_ROWS = 128;   // rows of a row tile, at most
constexpr int GT_MAX_STAGES = 3;   // column-tile stages in the ring, at most
constexpr int GT_OUT_LD = 72;      // row stride (words) of an output staging

// Shared memory of a launch: the row tile (resident, or in the ring with
// the depth chunks), the ring of `stages` column tiles, rows chunk + 4
// words apart, each column stage's norms and v, the matvec's row sums of
// the two column warps or the block entry's output staging (16 rows x 64
// columns a warp), and the mbarriers (a full and an empty one a stage,
// and one for the resident rows). rbf_gram.smem_bytes computes the same.
__host__ __device__ constexpr int gt_smem_bytes(int rows, int chunk,
                                                int chunks, int stages,
                                                bool matvec) {
  return 4 * (((chunks == 1 ? 1 : stages) * rows + stages * GT_COLS) *
                  (chunk + 4) +
              stages * 2 * GT_COLS +
              (matvec ? 2 * GT_MAX_ROWS : rows * GT_OUT_LD)) +
         16 * (stages + 1);
}

struct GramArgs {
  const void* a;    // the n rows, `lda` elements apart; the matvec's
                    // tasks lie m rows apart (a range: rows of b)
  const void* b;    // the m columns: (m, d); the matvec's (T, m, d)
  const float* a2;  // (n,); the matvec's tasks m apart
  const float* b2;  // (m,); the matvec's (T, m)
  const float* v;   // the matvec's (T, m)
  float* out;       // block: (n, m); matvec: (T, n)
  int n, m, d;
  int lda, ldb;     // row strides in elements: 16-byte multiples
  int rows, chunk, chunks, stages;  // the plan
  int col_tiles;    // column tiles a block walks
  float gamma;
  int rbf;
};

// Word w of a staged row of d elements as far as it lies inside the row:
// a float32 word is one element, a bfloat16 word a pair (low half first).
__device__ __forceinline__ uint32_t keep(uint32_t x, int w, int d, float) {
  return w < d ? x : 0u;
}
__device__ __forceinline__ uint32_t keep(uint32_t x, int w, int d,
                                         __nv_bfloat16) {
  return 2 * w + 1 < d ? x : 2 * w < d ? (x & 0xffffu) : 0u;
}

// The producer warp's copies of rows [row0, row0 + rows) of a matrix
// whose rows are `ld_bytes` apart, `bytes` bytes of each from byte `off`
// on, into s[r * ld], by TMA bulk copies completing on `bar`; rows at or
// past `nrows` are not copied. Whole rows that lie in global memory as in
// shared memory (rbf_gram.staged's layout) go by one copy, else one a row.
__device__ __forceinline__ void copy_rows(uint32_t* s, int ld,
                                          const char* g, int ld_bytes,
                                          int off, int bytes, int row0,
                                          int nrows, int rows, uint64_t* bar,
                                          int lane) {
  const int valid = max(0, min(rows, nrows - row0));
  if (bytes == ld * 4 && ld_bytes == bytes) {
    if (lane == 0 && valid > 0)
      tma_copy(s, g + (size_t)row0 * ld_bytes, valid * bytes, bar);
    return;
  }
  for (int r = lane; r < valid; r += 32)
    tma_copy(s + r * ld, g + (size_t)(row0 + r) * ld_bytes + off, bytes,
             bar);
}

// a step's raw fragments: the warp's two 16-row A tiles and four pairs of
// 8-column B tiles, by ldmatrix
__device__ __forceinline__ void load_step(uint32_t xa[2][4],
                                          uint32_t yb[4][4],
                                          const uint32_t* pa,
                                          const uint32_t* pb, int ld,
                                          int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) ldsm_x4(xa[i], pa + i * 16 * ld + k0);
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) ldsm_x4(yb[jp], pb + jp * 16 * ld + k0);
}

// zero the words of a step's fragments that lie past the row's d
// elements (word w of lane t: A x[0], x[1] and B y[0], y[2]; w + 4: the
// others)
template <typename T>
__device__ __forceinline__ void mask_step(uint32_t xa[2][4],
                                          uint32_t yb[4][4], int w, int d) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      xa[i][e] = keep(xa[i][e], w + (e >> 1) * 4, d, T{});
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      yb[jp][e] = keep(yb[jp][e], w + (e & 1) * 4, d, T{});
  }
}

// acc[i][j] += the warp's 32 x 64 tile of dots over words [0, words) of a
// staged depth chunk whose first word is word w0 of its rows: A points
// at the warp's first row, B at its first column, rows `ld` words apart.
// Each step's fragments come by ldmatrix (A: rows g, g + 8 x words t,
// t + 4 of each 16-row tile; B: row g x words t, t + 4 of each 8-column
// tile) while the step before runs its MMAs; in the step that reaches
// past the row's d elements the words past it are zeroed (what lies
// there in shared memory is never read).
template <typename T>
__device__ __forceinline__ void mma_chunk(const uint32_t* A,
                                          const uint32_t* B, int ld,
                                          int words, int w0, int d,
                                          float acc[2][8][4]) {
  const int lane = threadIdx.x % 32, q = lane / 8, rr = lane % 8;
  const int t = lane % 4;
  const int per = sizeof(T) == 2 ? 2 : 1;   // elements a word
  const uint32_t* pa = A + (rr + (q & 1) * 8) * ld + (q >> 1) * 4;
  const uint32_t* pb = B + ((q >> 1) * 8 + rr) * ld + (q & 1) * 4;
  uint32_t xa[2][4], yb[4][4];
  load_step(xa, yb, pa, pb, ld, 0);
  for (int k0 = 0; k0 < words; k0 += GT_KSTEP) {
    uint32_t ca[2][4], cb[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < 2; ++i) ca[i][e] = xa[i][e];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) cb[jp][e] = yb[jp][e];
    }
    if (k0 + GT_KSTEP < words)
      load_step(xa, yb, pa, pb, ld, k0 + GT_KSTEP);
    if (per * (w0 + k0 + GT_KSTEP) > d)
      mask_step<T>(ca, cb, w0 + k0 + t, d);
    Mma<T>::step(ca, cb, acc);
  }
}

// rows / 16 MMA warps and one producer warp. MMA warp (wr, wc) =
// (warp / 2, warp % 2) owns rows wr * 32 + [0, 32) of the row tile and
// columns wc * 64 + [0, 64) of each column tile; its accumulator
// acc[i][j][q] is row i * 16 + g + 8 (q / 2), column j * 8 + 2 t + q % 2
// of that. The producer fills a ring of column stages by TMA bulk
// copies, one a row; each stage has a full barrier (the copies' bytes
// and the producer's 32 lanes, which stage the norms and v by loads) and
// an empty one (each MMA warp arrives when it is done with the stage),
// so the MMA warps run out of step with one another and with the copies.
template <typename T, bool MATVEC>
__global__ void __launch_bounds__(2 * GT_MAX_ROWS + 32, 1)
gram_tc_kernel(GramArgs p) {
  extern __shared__ __align__(16) uint32_t gsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int consumers = p.rows / 16;   // the producer is warp `consumers`
  const int task = MATVEC ? blockIdx.y : 0;
  const int n = p.n, m = p.m, d = p.d;
  const int row0 = blockIdx.x * p.rows;
  const int tile0 = MATVEC ? 0 : blockIdx.y * p.col_tiles;
  const int tiles = min(p.col_tiles, (m + GT_COLS - 1) / GT_COLS - tile0);
  const int elem = static_cast<int>(sizeof(T));
  // a matvec task's rows and columns are one (m, d) matrix (the rows a
  // range of it): both move by m rows a task
  const char* a = static_cast<const char*>(p.a) +
                  (int64_t)task * m * p.lda * elem;
  const char* b = static_cast<const char*>(p.b) +
                  (int64_t)task * m * p.ldb * elem;
  const int lda_bytes = p.lda * elem, ldb_bytes = p.ldb * elem;
  const float* a2 = p.a2 + (int64_t)task * m;
  const float* b2 = p.b2 + (int64_t)task * m;
  const float* v = MATVEC ? p.v + (int64_t)task * m : nullptr;
  const int chunks = p.chunks, S = p.stages, ld = p.chunk + 4;
  const float gl = p.gamma * 1.4426950408889634f;   // gamma log2(e)
  const int a_words = p.rows * ld, b_words = GT_COLS * ld;
  const int a_bufs = chunks == 1 ? 1 : S;
  uint32_t* sa = gsm;
  uint32_t* sb = sa + a_bufs * a_words;
  float* sv = reinterpret_cast<float*>(sb + S * b_words);   // [S][b2|v]
  // the matvec's row sums [2][MAX_ROWS], or the block's output staging
  float* red = sv + S * 2 * GT_COLS;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      red + (MATVEC ? 2 * GT_MAX_ROWS : consumers * 16 * GT_OUT_LD));
  uint64_t* empty = full + S;
  uint64_t* rows_in = empty + S;
  const int stages = max(tiles, 0) * chunks;
  // bytes of a row a depth chunk copies: whole rows where they lie as in
  // shared memory, else the chunk's words inside the row stride
  auto chunk_bytes = [&](int ld_bytes, int c) {
    return chunks == 1 && ld_bytes == ld * 4
               ? ld_bytes
               : min(ld_bytes - c * p.chunk * 4, p.chunk * 4);
  };

  // zero the staged tiles once: rows past the edge are never copied and
  // keep finite values (the matvec multiplies their columns by v = 0)
  for (int i = threadIdx.x; i < (a_bufs * a_words + S * b_words) / 4;
       i += blockDim.x)
    reinterpret_cast<uint4*>(gsm)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(
                       smem_u32(full + st))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + st)),
                   "r"(consumers)
                   : "memory");
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(rows_in))
                 : "memory");
  }
  // the zeros, written by the generic proxy, before the TMA's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == consumers) {   // the producer
    if (chunks == 1) {   // the resident row tile
      const int valid = max(0, min(p.rows, n - row0));
      const int bytes = chunk_bytes(lda_bytes, 0);
      if (lane == 0) mbar_arrive_expect_tx(rows_in, valid * bytes);
      __syncwarp();
      copy_rows(sa, ld, a, lda_bytes, 0, bytes, row0, n, p.rows, rows_in,
                lane);
    }
    for (int s = 0; s < stages; ++s) {
      const int st = s % S, round = s / S;
      const int j = tile0 + s / chunks, c = s % chunks;
      if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
      if (c == chunks - 1) {   // what the epilogue of this stage reads
        float* s2 = sv + st * 2 * GT_COLS;
        for (int k = lane; k < GT_COLS; k += 32) {
          const int col = j * GT_COLS + k;
          // the matvec's exponent takes -gamma log2(e) |b|^2 a column
          if (p.rbf) s2[k] = col < m ? (MATVEC ? -gl : 1.f) * b2[col] : 0.f;
          if (MATVEC) s2[GT_COLS + k] = col < m ? v[col] : 0.f;
        }
      }
      const int bb = chunk_bytes(ldb_bytes, c);
      const int ab = chunks > 1 ? chunk_bytes(lda_bytes, c) : 0;
      const uint32_t total =
          max(0, min(GT_COLS, m - j * GT_COLS)) * bb +
          (chunks > 1 ? max(0, min(p.rows, n - row0)) * ab : 0);
      __syncwarp();
      if (lane == 0) mbar_arrive_expect_tx(full + st, total);
      __syncwarp();
      copy_rows(sb + st * b_words, ld, b, ldb_bytes, c * p.chunk * 4, bb,
                j * GT_COLS, m, GT_COLS, full + st, lane);
      if (chunks > 1)
        copy_rows(sa + st * a_words, ld, a, lda_bytes, c * p.chunk * 4, ab,
                  row0, n, p.rows, full + st, lane);
      if (lane != 0) mbar_arrive(full + st);   // the norms and v
    }
    return;
  }

  const int g = lane / 4, t = lane % 4, wr = warp / 2, wc = warp % 2;
  float a2r[2][2], ra[2][2];   // |a|^2 a row; the matvec: -gl |a|^2
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr * 32 + i * 16 + h * 8 + g;
      a2r[i][h] = p.rbf && r < n ? a2[r] : 0.f;
      ra[i][h] = -gl * a2r[i][h];
    }
  if (chunks == 1) mbar_wait(rows_in, 0);
  float acc[2][8][4];
  float rsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int s = 0; s < stages; ++s) {
    const int st = s % S, c = s % chunks, j = tile0 + s / chunks;
    mbar_wait(full + st, (s / S) & 1);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][jj][q] = 0.f;
    }
    mma_chunk<T>(sa + (chunks > 1 ? st * a_words : 0) + wr * 32 * ld,
                 sb + st * b_words + wc * GT_WARP_COLS * ld, ld, p.chunk,
                 c * p.chunk, d, acc);
    if (c == chunks - 1) {
      const float* s2 = sv + st * 2 * GT_COLS;
      const int cw = wc * GT_WARP_COLS + 2 * t;   // first column of lane
      if constexpr (MATVEC) {
        // K = 2^min(2 gl dot - gl |a|^2 - gl |b|^2, 0), the RBF kernel
        // exp(-gamma max(d2, 0)) with its constants folded per row and
        // per column; each term times v[c] into the row's partial
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float part = 0.f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cl = cw + jj * 8 + e;
                const float dot = acc[i][jj][2 * h + e];
                const float kv =
                    p.rbf ? ex2(fminf(fmaf(2.f * gl, dot,
                                           __fadd_rn(ra[i][h], s2[cl])),
                                      0.f))
                          : dot;
                part = fmaf(kv, s2[GT_COLS + cl], part);
              }
            rsum[i][h] = __fadd_rn(rsum[i][h], part);
          }
      } else {
        // through this warp's staging, 16 rows at a time, so that each
        // store writes 32 consecutive floats of a row of K
        float* stg = red + (warp * 16) * GT_OUT_LD;
        const int col0 = j * GT_COLS + wc * GT_WARP_COLS;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              float kv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dot = acc[i][jj][2 * h + e];
                kv[e] = p.rbf ? rbf_epilogue(a2r[i][h], s2[cw + jj * 8 + e],
                                             dot, p.gamma)
                              : dot;
              }
              *reinterpret_cast<float2*>(
                  stg + (h * 8 + g) * GT_OUT_LD + jj * 8 + 2 * t) =
                  make_float2(kv[0], kv[1]);
            }
          __syncwarp();
          for (int rr = 0; rr < 16; ++rr) {
            const int r = row0 + wr * 32 + i * 16 + rr;
            if (r >= n) break;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int col = col0 + half * 32 + lane;
              if (col < m)
                p.out[(size_t)r * m + col] =
                    stg[rr * GT_OUT_LD + half * 32 + lane];
            }
          }
          __syncwarp();
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  if constexpr (MATVEC) {
    // the fixed tree: the row's 4 lanes, then its two warps
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float r = rsum[i][h];
        r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 2));
        if (t == 0) red[wc * GT_MAX_ROWS + wr * 32 + i * 16 + h * 8 + g] = r;
      }
    bar_sync(1, 32 * consumers);
    for (int rl = threadIdx.x; rl < p.rows; rl += 32 * consumers)
      if (row0 + rl < n)
        p.out[(int64_t)task * n + row0 + rl] =
            __fadd_rn(red[rl], red[GT_MAX_ROWS + rl]);
  }
}

// ------------------------------------------- fp32 matvec on wgmma
// The float32 matvec with d <= 104 (rbf_gram.route_of): the same three
// TF32 products, issued as wgmma (m64n64k8: the rows' TF32 fragments in
// registers, a 64-column stage's high and low parts in shared memory).
// On mma.sync the products ran near 40 % of the TF32 rate and set the
// time (3.8 ms at n = 29,491 on the H100); here they take ~0.5 ms of
// 1.8 (kernel_times.py --gram-sweep). A block owns 128 rows, two
// warpgroups of 64 that split their rows into high and low TF32 parts
// (rounded to nearest) once and keep them in registers for the whole
// walk. A splitter warpgroup lands each 64-column stage by TMA (one bulk
// copy for staged rows) and writes its high part (the TF32 truncation,
// the low 13 bits cleared) and low part (the exact rest, whose top bits
// the tensor cores read) in wgmma's K-major layout without swizzle (core
// matrices of 8 rows x 16 bytes, rows 16 bytes apart: the 64 rows of one
// 4-word column, then the next), two stages deep, while the warpgroups
// run the stage before. One splitter warp was the bottleneck (3.9 ms);
// with four, a build without the split is 0.06 ms faster than the
// shipped one (1.81 ms). The truncated split leaves ~2^-20 of a
// product, well inside the matvec's float64 bound (0.005 of it at
// most). A row's sum order is fixed by n, as in the mma.sync route (its
// own order: a warp's 64 columns of a stage, then the 4 lanes of a row),
// so a bucket task still equals its lone call bit for bit.
constexpr int WG_MAX_KS = 13;                 // k-steps the rows' registers hold
constexpr int WG_COLS = 64;                   // columns a stage
constexpr int WG_STAGES = 2;
constexpr int WG_LD = GT_KSTEP * WG_MAX_KS + 4;   // landing row stride, words
constexpr int WG_KG_BYTES = WG_COLS * 16;     // one 4-word column of a stage
constexpr int WG_PART_BYTES = 2 * WG_MAX_KS * WG_KG_BYTES;
constexpr int WG_LAND_BYTES = WG_COLS * WG_LD * 4;
constexpr int WG_THREADS = 3 * 128;          // two warpgroups and 4 splitters

// [S][hi | lo] parts, [S] landings, [S][b2 | v], mbarriers: full,
// empty and landed a stage
__host__ __device__ constexpr int wg_smem_bytes() {
  return WG_STAGES * (2 * WG_PART_BYTES + WG_LAND_BYTES + 2 * WG_COLS * 4) +
         8 * 3 * WG_STAGES;
}

// wgmma shared-memory descriptor: K-major, no swizzle; 16-byte columns
// of core matrices WG_KG_BYTES apart (K), 8-row groups 128 bytes apart
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(WG_KG_BYTES >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (+)= a b over one k-step: a the warp's 16 x 8 TF32 fragment (the
// mma.sync m16n8k8 A layout), b 8 x 64 in shared memory; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_tf32(float d[32], const uint32_t a[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
        "l"(desc));
}

// keep the compiler from moving accesses of d across a wgmma fence/wait
__device__ __forceinline__ void wg_pin(float d[32]) {
  asm volatile(""
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
               "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
               "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
               "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
               :
               : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// words [4q, 4q + 4) of a landed row, 0 past d elements
__device__ __forceinline__ uint4 wg_words(const uint32_t* row, int q, int d) {
  uint4 f = *reinterpret_cast<const uint4*>(row + 4 * q);
  if (4 * q + 3 >= d) {
    if (4 * q >= d) f.x = 0u;
    if (4 * q + 1 >= d) f.y = 0u;
    if (4 * q + 2 >= d) f.z = 0u;
    f.w = 0u;
  }
  return f;
}

__global__ void __launch_bounds__(WG_THREADS, 1)
gram_wg_matvec_kernel(GramArgs p) {
  extern __shared__ __align__(128) unsigned char wsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int task = blockIdx.y, n = p.n, m = p.m, d = p.d;
  const int row0 = blockIdx.x * 128;
  const int nks = (d + GT_KSTEP - 1) / GT_KSTEP;
  const int ld_bytes = p.lda * 4;
  // the block's rows (n of them: a range of the columns' matrix) and the
  // m columns, tasks m rows apart
  const char* xa = static_cast<const char*>(p.a) + (int64_t)task * m * ld_bytes;
  const char* xb = static_cast<const char*>(p.b) + (int64_t)task * m * ld_bytes;
  const float* a2 = p.a2 + (int64_t)task * m;
  const float* b2 = p.b2 + (int64_t)task * m;
  const float* v = p.v + (int64_t)task * m;
  const float gl = p.gamma * 1.4426950408889634f;   // gamma log2(e)
  const int stages = (m + WG_COLS - 1) / WG_COLS;
  unsigned char* parts = wsm;                        // [S][hi | lo]
  uint32_t* land = reinterpret_cast<uint32_t*>(wsm + WG_STAGES * 2 * WG_PART_BYTES);
  float* sv = reinterpret_cast<float*>(land + WG_STAGES * WG_COLS * WG_LD);
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + WG_STAGES * 2 * WG_COLS);
  uint64_t* empty = full + WG_STAGES;
  uint64_t* landed = empty + WG_STAGES;
  // bytes of a row a landing takes: whole staged rows (one copy a stage)
  // or the row's words, 16 bytes at a time (one copy a row)
  const int row_bytes = ld_bytes == WG_LD * 4 ? ld_bytes
                                              : min(ld_bytes, WG_LD * 4);

  if (threadIdx.x == 0) {
    for (int st = 0; st < WG_STAGES; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 128;\n" ::"r"(
                       smem_u32(full + st))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 8;\n" ::"r"(
                       smem_u32(empty + st))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(landed + st))
                   : "memory");
    }
  }
  // the block's rows, WG_LD words apart in the parts' space, zero past n
  // rows and d elements, for the MMA warps' fragments
  uint32_t* sa = reinterpret_cast<uint32_t*>(parts);
  for (int e = threadIdx.x; e < 128 * (WG_LD / 4); e += blockDim.x) {
    const int r = e / (WG_LD / 4), q = e - r * (WG_LD / 4);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n && 4 * q < d) {
      f = *reinterpret_cast<const float4*>(xa + (size_t)(row0 + r) * ld_bytes +
                                           16 * q);
      if (4 * q + 1 >= d) f.y = 0.f;
      if (4 * q + 2 >= d) f.z = 0.f;
      if (4 * q + 3 >= d) f.w = 0.f;
    }
    *reinterpret_cast<float4*>(sa + r * WG_LD + 4 * q) = f;
  }
  // the landings are written by TMA (the async proxy) from here on
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wgi = warp / 4, w = warp % 4;   // MMA warps: warpgroup, warp
  uint32_t ah[WG_MAX_KS][4], al[WG_MAX_KS][4];
  if (warp < 8) {
    const int q = lane / 8, rr = lane % 8;
    const uint32_t* pa =
        sa + (wgi * 64 + w * 16 + rr + (q & 1) * 8) * WG_LD + (q >> 1) * 4;
#pragma unroll
    for (int ks = 0; ks < WG_MAX_KS; ++ks) {
      uint32_t xa[4];
      ldsm_x4(xa, pa + ks * GT_KSTEP);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(xa[e], ah[ks][e], al[ks][e]);
    }
  }
  __syncthreads();   // the parts' space is the stages' from here on

  if (warp >= 8) {   // the splitters: a row of the stage each, half its
                      // 4-word columns (and its norm and v)
    const int sl = threadIdx.x - 256, r = sl % WG_COLS, q0 = sl / WG_COLS;
    auto land_stage = [&](int s) {   // TMA of stage s's rows (warp 8)
      const int st = s % WG_STAGES;
      const int valid = min(WG_COLS, m - s * WG_COLS);
      if (lane == 0) mbar_arrive_expect_tx(landed + st, valid * row_bytes);
      __syncwarp();
      copy_rows(land + st * WG_COLS * WG_LD, WG_LD, xb, ld_bytes, 0,
                row_bytes, s * WG_COLS, m, WG_COLS, landed + st, lane);
    };
    if (warp == 8)
      for (int s = 0; s < min(stages, WG_STAGES); ++s) land_stage(s);
    for (int s = 0; s < stages; ++s) {
      const int st = s % WG_STAGES, round = s / WG_STAGES;
      const int col = s * WG_COLS + r;
      float cb = 0.f, cv = 0.f;   // loads in flight meanwhile
      if (q0 == 0 && col < m) {
        cb = p.rbf ? -gl * b2[col] : 0.f;
        cv = v[col];
      }
      if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
      mbar_wait(landed + st, round & 1);
      unsigned char* hi = parts + st * 2 * WG_PART_BYTES;
      unsigned char* lo = hi + WG_PART_BYTES;
      const uint32_t* lr = land + (st * WG_COLS + r) * WG_LD;
      const bool row_in = col < m;
      // the high part by truncation to TF32 (the low 13 bits cleared),
      // the low part the exact rest (the tensor cores read its top bits)
      for (int q = q0; q < 2 * nks; q += 2) {
        const uint4 f = row_in ? wg_words(lr, q, d) : make_uint4(0u, 0u, 0u, 0u);
        const uint4 h = make_uint4(f.x & 0xffffe000u, f.y & 0xffffe000u,
                                   f.z & 0xffffe000u, f.w & 0xffffe000u);
        const uint4 l = make_uint4(
            __float_as_uint(__fsub_rn(__uint_as_float(f.x),
                                      __uint_as_float(h.x))),
            __float_as_uint(__fsub_rn(__uint_as_float(f.y),
                                      __uint_as_float(h.y))),
            __float_as_uint(__fsub_rn(__uint_as_float(f.z),
                                      __uint_as_float(h.z))),
            __float_as_uint(__fsub_rn(__uint_as_float(f.w),
                                      __uint_as_float(h.w))));
        const int off = q * WG_KG_BYTES + r * 16;
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
      }
      if (q0 == 0) {
        float* s2 = sv + st * 2 * WG_COLS;
        s2[r] = cb;
        s2[WG_COLS + r] = cv;
      }
      // the generic proxy's stores and loads before the wgmmas' reads and
      // the next TMA's writes of the same shared memory
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + st);
      bar_sync(2, 128);   // every splitter is done with the landing
      if (warp == 8 && s + WG_STAGES < stages) land_stage(s + WG_STAGES);
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  float ra[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wgi * 64 + w * 16 + h * 8 + g;
    ra[h] = p.rbf && r < n ? -gl * a2[r] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int s = 0; s < stages; ++s) {
    const int st = s % WG_STAGES;
    mbar_wait(full + st, (s / WG_STAGES) & 1);
    const unsigned char* hi = parts + st * 2 * WG_PART_BYTES;
    const unsigned char* lo = hi + WG_PART_BYTES;
    wg_pin(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < WG_MAX_KS; ++ks) {
      if (ks < nks) {
        const uint64_t dh = wg_desc(hi + ks * 2 * WG_KG_BYTES);
        const uint64_t dl = wg_desc(lo + ks * 2 * WG_KG_BYTES);
        wgmma_tf32(acc, al[ks], dh, ks > 0);
        wgmma_tf32(acc, ah[ks], dl, 1);
        wgmma_tf32(acc, ah[ks], dh, 1);
      }
    }
    wg_commit();
    wg_wait0();
    wg_pin(acc);
    const float* s2 = sv + st * 2 * WG_COLS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < WG_COLS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 8 + 2 * t + e;
          const float dot = acc[4 * j + 2 * h + e];
          const float kv =
              p.rbf ? ex2(fminf(fmaf(2.f * gl, dot, __fadd_rn(ra[h], s2[cl])),
                                0.f))
                    : dot;
          part = fmaf(kv, s2[WG_COLS + cl], part);
        }
      rsum[h] = __fadd_rn(rsum[h], part);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float r = rsum[h];
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, 2));
    const int row = row0 + wgi * 64 + w * 16 + h * 8 + g;
    if (t == 0 && row < n) p.out[(int64_t)task * n + row] = r;
  }
}

// ------------------------------------------------------------- row mode
constexpr int MAX_ROW_WARPS = 8;  // row warps (chunks) a block, at most
constexpr int CHUNK_ROWS = 32;

// Start copying `count` elements from `src` to the shared `dst` (lane 0
// arms the warp's barrier and issues the bulk copy of the 16-byte
// aligned body; the lanes copy what it cannot take). Every lane then
// waits with mbar_wait(bar, 0) after a __syncwarp.
template <typename T>
__device__ __forceinline__ void start_chunk(T* dst, const T* src, int count,
                                            uint64_t* bar, int lane) {
  const uint32_t bytes = static_cast<uint32_t>(count) * sizeof(T);
  const uint32_t bulk =
      reinterpret_cast<uintptr_t>(src) % 16 == 0 ? (bytes & ~15u) : 0u;
  if (lane == 0) {
    mbar_init(bar);
    if (bulk) {
      mbar_arrive_expect_tx(bar, bulk);
      tma_copy(dst, src, bulk, bar);
    } else {
      mbar_arrive(bar);
    }
  }
  for (int e = bulk / sizeof(T) + lane; e < count; e += 32) dst[e] = src[e];
}

// <x_r, z> over d features: even features into one accumulator, odd ones
// into another, each in feature order, then their sum -- the same bits
// from shared or global memory, by pairs or one at a time.
__device__ __forceinline__ float row_dot(const float* xr, const float* z,
                                         int d) {
  float e = 0.f, o = 0.f;
  if (d % 2 == 0 && reinterpret_cast<uintptr_t>(xr) % 8 == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(xr);
    const float2* z2 = reinterpret_cast<const float2*>(z);
#pragma unroll 4
    for (int k = 0; k < d / 2; ++k) {
      const float2 v = x2[k], w = z2[k];
      e = fmaf(v.x, w.x, e);
      o = fmaf(v.y, w.y, o);
    }
  } else {
    int k = 0;
#pragma unroll 4
    for (; k + 1 < d; k += 2) {
      e = fmaf(xr[k], z[k], e);
      o = fmaf(xr[k + 1], z[k + 1], o);
    }
    if (k < d) e = fmaf(xr[k], z[k], e);
  }
  return __fadd_rn(e, o);
}

__device__ __forceinline__ float row_dot(const __nv_bfloat16* xr,
                                         const float* z, int d) {
  float e = 0.f, o = 0.f;
  if (d % 2 == 0 && reinterpret_cast<uintptr_t>(xr) % 4 == 0) {
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(xr);
    const float2* z2 = reinterpret_cast<const float2*>(z);
#pragma unroll 4
    for (int k = 0; k < d / 2; ++k) {
      const float2 v = __bfloat1622float2(x2[k]), w = z2[k];
      e = fmaf(v.x, w.x, e);
      o = fmaf(v.y, w.y, o);
    }
  } else {
    int k = 0;
#pragma unroll 4
    for (; k + 1 < d; k += 2) {
      e = fmaf(__bfloat162float(xr[k]), z[k], e);
      o = fmaf(__bfloat162float(xr[k + 1]), z[k + 1], o);
    }
    if (k < d) e = fmaf(__bfloat162float(xr[k]), z[k], e);
  }
  return __fadd_rn(e, o);
}

// the solver's LRU row cache (kernel_engine.RowCache), in place
struct Lru {
  int64_t* keys;
  int64_t* stamp;
  float* rows;      // (slots, n)
  int64_t* clock;
  int64_t* hits;
  int64_t* misses;
  int* ticket;      // 0 between launches
  int slots;
};

struct RowArgs {
  const void* x;     // (T, nx, d)
  const float* x2;   // (T, nx)
  const int64_t* idx;  // (T,)
  float* out;        // (T, n): rows row0 + [0, n) of X, 0 past nx
  int nx, row0;      // X's rows a task; the first row of the range
  int n, d, staged;  // staged: chunks through shared memory
  int warps;         // row warps a block
  float gamma;
  int rbf;
};

// z (round4(d) floats), the warps' barriers, then the chunks
__host__ __device__ constexpr size_t z_bytes(int d) {
  return sizeof(float) * ((d + 3) & ~3);
}

template <typename T, bool CACHED>
__global__ void __launch_bounds__(32 * MAX_ROW_WARPS + 32)
gram_row_kernel(RowArgs a, Lru c) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_slot, s_hit;
  const int task = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = a.n, d = a.d;
  const T* x = static_cast<const T*>(a.x) + (int64_t)task * a.nx * d;
  const float* x2 = a.x2 + (int64_t)task * a.nx;
  // the cached entry's extra warp does the lookup and owns no rows
  const int W = a.warps, row_threads = 32 * W;
  const bool cache_warp = CACHED && warp == W;
  const int w = cache_warp ? 0 : warp;
  float* z = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + z_bytes(d)) + w;
  T* chunk = reinterpret_cast<T*>(smem + z_bytes(d) + 8 * MAX_ROW_WARPS) +
             (size_t)w * CHUNK_ROWS * d;
  const int r0 = (blockIdx.x * W + w) * CHUNK_ROWS;
  const int rows = cache_warp ? 0 : max(0, min(CHUNK_ROWS, n - r0));
  // the chunk's rows that lie in X (the rest, a range's padding, are 0)
  const int valid = max(0, min(rows, a.nx - a.row0 - r0));
  const int r = r0 + lane;
  const bool mine = lane < rows, real = lane < valid;
  const T* xc = x + (size_t)(a.row0 + r0) * d;   // the chunk's first row

  // 1. the chunk's copy, which depends on nothing the block reads
  if (a.staged && valid > 0) start_chunk(chunk, xc, valid * d, bar, lane);
  // 2. nor do this row's norm, the cache's first 32 keys and stamps, and
  // the clock and counts
  const bool slot0 = cache_warp && lane < c.slots;
  const int64_t key0 = slot0 ? c.keys[lane] : -1;
  const int64_t stamp0 = slot0 ? c.stamp[lane] : INT64_MAX;
  int64_t clock = 0, hits = 0, misses = 0;
  if (cache_warp && lane == 0) {
    clock = *c.clock;
    hits = *c.hits;
    misses = *c.misses;
  }
  const float r2 = a.rbf && real ? x2[a.row0 + r] : 0.f;
  // 3. the index, x_i, and the lookup
  const int64_t i = a.idx[task];
  const float i2 = a.rbf ? x2[i] : 0.f;
  for (int k = threadIdx.x; k < d && !cache_warp; k += row_threads)
    z[k] = to_f32(x[i * d + k]);
  if (cache_warp) {
    int hit = slot0 && key0 == i ? lane : 0x7fffffff;
    int victim = slot0 ? lane : 0x7fffffff;
    int64_t least = stamp0;
    for (int s = lane + 32; s < c.slots; s += 32) {   // past 32 slots
      const int64_t key = c.keys[s], st = c.stamp[s];
      if (key == i && s < hit) hit = s;
      if (st < least) { least = st; victim = s; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hit = min(hit, __shfl_xor_sync(0xffffffffu, hit, off));
      const int64_t ol = __shfl_xor_sync(0xffffffffu, least, off);
      const int ov = __shfl_xor_sync(0xffffffffu, victim, off);
      if (ol < least || (ol == least && ov < victim)) { least = ol; victim = ov; }
    }
    const bool h = hit != 0x7fffffff;
    const int64_t slot = h ? hit : victim;
    if (lane == 0) {
      s_hit = h;
      s_slot = static_cast<int>(slot);
    }
    // publish the slot without waiting for the row warps, then take the
    // ticket: every block has read the keys and stamps once the last
    // one is taken, and that block writes what the lookup changes
    bar_arrive(1, row_threads + 32);
    if (lane == 0 && take_ticket(c.ticket) == gridDim.x * gridDim.y - 1) {
      c.keys[slot] = i;
      c.stamp[slot] = clock + 1;
      *c.clock = clock + 1;
      if (h) *c.hits = hits + 1; else *c.misses = misses + 1;
      *c.ticket = 0;
    }
    return;
  }
  if (CACHED)
    bar_sync(1, row_threads + 32);   // x_i staged, the slot published
  else
    __syncthreads();                 // x_i staged
  const bool hit = CACHED && s_hit;
  const int64_t slot = CACHED ? s_slot : 0;

  // 4. the row
  float* out = a.out + (int64_t)task * n;
  if (hit && mine) out[r] = c.rows[slot * n + r];
  if (a.staged && valid > 0) {   // also on a hit: the copy must land
    __syncwarp();
    mbar_wait(bar, 0);
  }
  if (!hit && mine) {
    float v = 0.f;
    if (real) {
      const T* xr = (a.staged ? chunk : xc) + (size_t)lane * d;
      const float dot = row_dot(xr, z, d);
      v = a.rbf ? rbf_epilogue(r2, i2, dot, a.gamma) : dot;
    }
    out[r] = v;
    if (CACHED) c.rows[slot * n + r] = v;
  }
}

}  // namespace

namespace {

// A plan rbf_gram.gram_plan can make, with the shared memory it takes.
bool gram_plan_ok(int rows, int chunk, int chunks, int stages, int d,
                  int bf16, int smem, bool matvec) {
  const int words = bf16 ? (d + 1) / 2 : d;
  return (rows == 32 || rows == 64 || rows == GT_MAX_ROWS) && chunks >= 1 &&
         chunk % GT_KSTEP == 0 && chunk >= GT_KSTEP &&
         chunk <= GT_MAX_CHUNK && (chunks == 1 || chunk == GT_CHUNK) &&
         chunk * chunks >= words && stages >= 2 &&
         stages <= GT_MAX_STAGES &&
         smem == gt_smem_bytes(rows, chunk, chunks, stages, matvec);
}

// rows of a matrix at p, `ld` elements of `elem` bytes apart, that TMA
// bulk copies can take: the address and the stride 16-byte multiples
bool rows_ok(const void* p, int ld, int d, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * elem) % 16 == 0 &&
         ld >= d;
}

template <typename T, bool MATVEC>
int launch_gram(const GramArgs& p, dim3 grid, int smem, cudaStream_t s) {
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  auto kern = gram_tc_kernel<T, MATVEC>;
  if (const int e = f32tile::allow_max_smem(kern, allowed)) return e;
  kern<<<grid, 2 * p.rows + 32, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Block and grid of a row launch: up to eight row warps a block, their
// chunks through shared memory when at least one chunk fits the shared
// memory a block may opt in to, else straight from global memory.
template <typename T, bool CACHED>
int launch_row(const RowArgs& args, const Lru& lru, int n_tasks,
               cudaStream_t s) {
  static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
  static std::atomic<int> optin[f32tile::MAX_DEVICES];
  auto kern = gram_row_kernel<T, CACHED>;
  if (const int e = f32tile::allow_max_smem(kern, allowed)) return e;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (dev >= f32tile::MAX_DEVICES) return cudaErrorInvalidDevice;
  if (optin[dev].load() == 0) {
    int v = 0;
    const cudaError_t e = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    optin[dev].store(v);
  }
  RowArgs a = args;
  // as many row warps as the chunks fit (the static s_slot / s_hit come
  // out of the same opt-in limit), at most MAX_ROW_WARPS; none fits:
  // MAX_ROW_WARPS reading X from global memory
  const size_t fixed = z_bytes(a.d) + 8 * MAX_ROW_WARPS + 64;
  const size_t chunk = sizeof(T) * (size_t)CHUNK_ROWS * a.d;
  const size_t room = static_cast<size_t>(optin[dev].load());
  const size_t fit = room > fixed ? (room - fixed) / chunk : 0;
  a.staged = fit >= 1;
  a.warps = a.staged ? static_cast<int>(fit < MAX_ROW_WARPS ? fit
                                                            : MAX_ROW_WARPS)
                     : MAX_ROW_WARPS;
  const size_t smem = fixed - 64 + (a.staged ? chunk * a.warps : 0);
  const int per_block = a.warps * CHUNK_ROWS;
  const dim3 grid((a.n + per_block - 1) / per_block, n_tasks);
  kern<<<grid, 32 * a.warps + (CACHED ? 32 : 0), smem, s>>>(a, lru);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (n, d), b (m, d) with rows lda / ldb elements apart (16-byte
// multiples, 16-byte aligned) and their norms a2 (n,), b2 (m,) ->
// out (n, m); the plan of rbf_gram.gram_plan: rows, chunk, chunks,
// stages, the column groups a row tile is split into, shared memory
int svm_rbf_gram_block(const void* a, const void* b, const float* a2,
                       const float* b2, float* out, int n, int m, int d,
                       int lda, int ldb, float gamma, int rbf, int bf16,
                       int rows, int chunk, int chunks, int stages,
                       int groups, int smem, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (!gram_plan_ok(rows, chunk, chunks, stages, d, bf16, smem, false) ||
      groups < 1 || !rows_ok(a, lda, d, elem) || !rows_ok(b, ldb, d, elem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (m + GT_COLS - 1) / GT_COLS;
  const GramArgs p{a, b, a2, b2, nullptr, out, n, m, d, lda, ldb, rows,
                   chunk, chunks, stages, (tiles + groups - 1) / groups,
                   gamma, rbf};
  const dim3 grid((n + rows - 1) / rows, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_gram<__nv_bfloat16, false>(p, grid, smem, s)
              : launch_gram<float, false>(p, grid, smem, s);
}

// Rows [row0, row0 + count) of K(X_t, X_t) v_t for each task: x
// (n_tasks, n, d) with rows ldx elements apart (tasks n ldx apart), x2
// and v (n_tasks, n) -> out (n_tasks, count), row0 + count <= n (the
// whole product: row0 = 0, count = n); the plan as above (one column
// group); wgmma: the float32 route of gram_wg_matvec_kernel (d <= 104,
// 128 rows, its own shared memory)
int svm_rbf_gram_matvec(const void* x, const float* x2, const float* v,
                        float* out, int n_tasks, int n, int row0, int count,
                        int d, int ldx, float gamma, int rbf, int bf16,
                        int rows, int chunk, int chunks, int stages,
                        int smem, int wgmma, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (!rows_ok(x, ldx, d, elem) || row0 < 0 || count < 1 ||
      row0 + count > n || (n_tasks > 1 && count != n))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* a = static_cast<const char*>(x) + (size_t)row0 * ldx * elem;
  const GramArgs p{a, x, x2 + row0, x2, v, out, count, n, d, ldx, ldx,
                   rows, chunk, chunks, stages, (n + GT_COLS - 1) / GT_COLS,
                   gamma, rbf};
  const dim3 grid((count + rows - 1) / rows, n_tasks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (bf16 || d > GT_KSTEP * WG_MAX_KS || rows != 128 ||
        smem != wg_smem_bytes())
      return static_cast<int>(cudaErrorInvalidValue);
    static std::atomic<bool> allowed[f32tile::MAX_DEVICES];
    if (const int e = f32tile::allow_max_smem(gram_wg_matvec_kernel, allowed))
      return e;
    gram_wg_matvec_kernel<<<grid, WG_THREADS, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (!gram_plan_ok(rows, chunk, chunks, stages, d, bf16, smem, true))
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_gram<__nv_bfloat16, true>(p, grid, smem, s)
              : launch_gram<float, true>(p, grid, smem, s);
}

// x (n_tasks, nx, d), x2 (n_tasks, nx), idx (n_tasks,) -> out
// (n_tasks, n): rows row0 + [0, n) of each task's row, 0 past nx (the
// whole row: row0 = 0, n = nx)
int svm_rbf_gram_row(const void* x, const float* x2, const int64_t* idx,
                     float* out, int n_tasks, int nx, int row0, int n,
                     int d, float gamma, int rbf, int bf16, void* stream) {
  if (row0 < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{x, x2, idx, out, nx, row0, n, d, 0, 0, gamma, rbf};
  const Lru none{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row<__nv_bfloat16, false>(a, none, n_tasks, s)
              : launch_row<float, false>(a, none, n_tasks, s);
}

// One task: x (nx, d), x2 (nx,), the 0-d index idx, out (n,) (rows
// row0 + [0, n), as svm_rbf_gram_row), and the LRU row cache keys /
// stamp (slots,) int64, rows (slots, n) float32, clock / hits / misses
// 0-d int64, all updated in place; ticket: one int, 0 between launches
// on the stream.
int svm_rbf_gram_row_cached(const void* x, const float* x2,
                            const int64_t* idx, float* out, int64_t* keys,
                            int64_t* stamp, float* rows, int64_t* clock,
                            int64_t* hits, int64_t* misses, int slots,
                            int* ticket, int nx, int row0, int n, int d,
                            float gamma, int rbf, int bf16, void* stream) {
  if (row0 < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{x, x2, idx, out, nx, row0, n, d, 0, 0, gamma, rbf};
  const Lru c{keys, stamp, rows, clock, hits, misses, ticket, slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row<__nv_bfloat16, true>(a, c, 1, s)
              : launch_row<float, true>(a, c, 1, s);
}

}  // extern "C"
