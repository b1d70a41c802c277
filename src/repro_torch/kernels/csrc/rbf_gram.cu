// rbf_gram: the Gram block and the Gram row of the SMO solver.
//
// Replaces `rbf_gram_pallas` / `_rbf_gram_kernel`
// (src/repro/kernels/rbf_gram.py), reached through `ops.rbf_gram`,
// `ops.gram_row` and `ops.gram_row_cached`:
//   K = exp(-gamma * max(|a|^2 + |b|^2 - 2 a.b^T, 0))   (mode rbf)
//   K = a.b^T                                            (mode linear)
// with the squared norms computed by the caller in float32 from the
// rounded operands, as rbf_gram.py:112-113 does.
//
// Block mode (n, m), for matvec / cross / block / full. Each output is
// d multiply-adds against 4 bytes written, so at SVM widths (d <= 102)
// the write of K bounds it: (n m 4) / 3.35 TB/s. Design: a 64 x 64 tile
// per block from shared-memory staged feature chunks (common.cuh), the
// epilogue fused before the single store of K.
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
#include "common.cuh"
#include "tile_f32.cuh"

#include <atomic>

namespace {

using namespace svm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rbf_gram_block_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const float* __restrict__ a2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int n, int m, int d, float gamma, int rbf) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  float acc[4][4];
  tile_dot(sm, a, row0, n, b, col0, m, d, /*norms=*/false, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= m) continue;
      out[(size_t)r * m + c] =
          rbf ? rbf_epilogue(a2[r], b2[c], acc[i][j], gamma) : acc[i][j];
    }
  }
}

// ------------------------------------------------------------- row mode
constexpr int MAX_ROW_WARPS = 8;  // row warps (chunks) a block, at most
constexpr int CHUNK_ROWS = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(b))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* b,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's first phase (parity 0) has completed
__device__ __forceinline__ void mbar_wait0(uint64_t* b) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(b))
        : "memory");
  }
}

__device__ __forceinline__ void tma_copy(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Named barrier `id` of `count` threads: wait for all, or arrive (the
// caller's earlier shared-memory writes are then visible to the threads
// that wait) without waiting.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Start copying `count` elements from `src` to the shared `dst` (lane 0
// arms the warp's barrier and issues the bulk copy of the 16-byte
// aligned body; the lanes copy what it cannot take). Every lane then
// waits with mbar_wait0 after a __syncwarp.
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
  const void* x;     // (T, n, d)
  const float* x2;   // (T, n)
  const int64_t* idx;  // (T,)
  float* out;        // (T, n)
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
  const T* x = static_cast<const T*>(a.x) + (int64_t)task * n * d;
  const float* x2 = a.x2 + (int64_t)task * n;
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
  const int r = r0 + lane;
  const bool mine = lane < rows;

  // 1. the chunk's copy, which depends on nothing the block reads
  if (a.staged && rows > 0)
    start_chunk(chunk, x + (size_t)r0 * d, rows * d, bar, lane);
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
  const float r2 = a.rbf && mine ? x2[r] : 0.f;
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
  if (a.staged && rows > 0) {   // also on a hit: the copy must land
    __syncwarp();
    mbar_wait0(bar);
  }
  if (!hit && mine) {
    const T* xr = a.staged ? chunk + (size_t)lane * d : x + (size_t)r * d;
    const float dot = row_dot(xr, z, d);
    const float v = a.rbf ? rbf_epilogue(r2, i2, dot, a.gamma) : dot;
    out[r] = v;
    if (CACHED) c.rows[slot * n + r] = v;
  }
}

}  // namespace

namespace {

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

int svm_rbf_gram_block(const void* a, const void* b, const float* a2,
                       const float* b2, float* out, int n, int m, int d,
                       float gamma, int rbf, int bf16, void* stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rbf_gram_block_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), a2, b2, out, n, m, d, gamma,
        rbf);
  else
    rbf_gram_block_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), a2, b2,
        out, n, m, d, gamma, rbf);
  return static_cast<int>(cudaGetLastError());
}

// x (n_tasks, n, d), x2 (n_tasks, n), idx (n_tasks,), out (n_tasks, n)
int svm_rbf_gram_row(const void* x, const float* x2, const int64_t* idx,
                     float* out, int n_tasks, int n, int d, float gamma,
                     int rbf, int bf16, void* stream) {
  const RowArgs a{x, x2, idx, out, n, d, 0, 0, gamma, rbf};
  const Lru none{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row<__nv_bfloat16, false>(a, none, n_tasks, s)
              : launch_row<float, false>(a, none, n_tasks, s);
}

// One task: x (n, d), x2 (n,), the 0-d index idx, out (n,), and the LRU
// row cache keys / stamp (slots,) int64, rows (slots, n) float32,
// clock / hits / misses 0-d int64, all updated in place; ticket: one
// int, 0 between launches on the stream.
int svm_rbf_gram_row_cached(const void* x, const float* x2,
                            const int64_t* idx, float* out, int64_t* keys,
                            int64_t* stamp, float* rows, int64_t* clock,
                            int64_t* hits, int64_t* misses, int slots,
                            int* ticket, int n, int d, float gamma, int rbf,
                            int bf16, void* stream) {
  const RowArgs a{x, x2, idx, out, n, d, 0, 0, gamma, rbf};
  const Lru c{keys, stamp, rows, clock, hits, misses, ticket, slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row<__nv_bfloat16, true>(a, c, 1, s)
              : launch_row<float, true>(a, c, 1, s);
}

}  // extern "C"
