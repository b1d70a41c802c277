// Tensor-core and copy pieces shared by the port's Hopper (sm_90a)
// kernels rbf_gram.cu, flash_attn.cu, ssd_diag.cu and the backward
// kernels flash_attn_bwd.cu and ssd_diag_bwd.cu: shared-memory
// addresses, mbarriers, TMA bulk copies and named barriers;
// ex2.approx; the TF32 and bf16 splits, mma.sync (TF32 m16n8k8, 3xTF32,
// bf16 m16n8k16) and ldmatrix;
// the Gram block route's MMA step (Mma<>); and TMA tensor maps with the
// 128-byte swizzle.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace svm {

// ------------------------------------------------ shared memory, barriers
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

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
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

// 2^x, x <= 0 (ex2.approx: a relative error of 2^-22 at most; results
// under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo: hi its TF32 rounding, lo the TF32 rounding of the rest
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(__uint_as_float(x));
  lo = to_tf32(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 4-word matrices of shared memory into the mma.sync fragment
// layout: lane (g, t) = (lane / 4, lane % 4) receives word t of row g of
// each; lanes 8q .. 8q + 7 give the row addresses of matrix q.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same four matrices transposed: lane (g, t) receives the 16-bit
// elements (2t, g) and (2t + 1, g) of each 8 x 8 matrix (a bf16 B
// fragment from a tile stored k-major).
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// x = hi + lo exactly: hi the TF32 truncation of x (its low 13 bits
// cleared), lo the float32 rest, of which the tensor cores read the top
// 11 bits: a 3xTF32 product keeps ~2^-20 of each term, in two operations
// an element (split_tf32 rounds both parts).
__device__ __forceinline__ void split_tf32_trunc(uint32_t x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// c += a b as 3xTF32 from split operands: lo*hi, hi*lo, hi*hi
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The same with the two small products summed apart from hi*hi (into
// cl; the caller adds it to ch at the end): two chains of dependent MMAs
// where there was one
__device__ __forceinline__ void mma_3xtf32_2(float ch[4], float cl[4],
                                             const uint32_t ah[4],
                                             const uint32_t al[4],
                                             const uint32_t bh[2],
                                             const uint32_t bl[2]) {
  mma_tf32(cl, al, bh);
  mma_tf32(cl, ah, bl);
  mma_tf32(ch, ah, bh);
}

// (x0, x1) ~ hi + lo as two bf16 pairs: hi the bf16 rounding, lo the bf16
// rounding of the rest (~16 bits of each value kept)
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(x0, __low2float(h)), __fsub_rn(x1, __high2float(h)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------- tensor maps, 128-byte swizzle
// Word offset of word w of row r in a tile of `rows` rows staged as
// 128-byte-swizzled TMA boxes (CU_TENSOR_MAP_SWIZZLE_128B, each box
// 1024-byte aligned): box w / 32 holds words 32 (w / 32) + [0, 32) of
// every row, rows x 128 bytes, and the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8). Eight rows read at one column by ldmatrix, or by
// lanes whose rows differ in r % 8, hit 32 different banks.
__host__ __device__ constexpr int swz(int rows, int r, int w) {
  return (w >> 5) * rows * 32 + r * 32 + ((((w >> 2) & 7) ^ (r & 7)) << 2) +
         (w & 3);
}

// The box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// dst (1024-byte aligned), completing on `bar` with the box's bytes
// (elements out of bounds land as zeros).
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// A 4-D tensor map over float32 or bfloat16 elements: dims[0] contiguous,
// strides (bytes, 16-byte multiples) of dims 1..3, a box of box[i]
// elements whose innermost extent is 128 bytes; 128-byte swizzle, zeros
// out of bounds. cuTensorMapEncodeTiled is found through the runtime's
// entry-point query (no link to libcuda). Returns a cudaError_t.
inline int tmap_4d(CUtensorMap* map, const void* base, bool bf16,
                   const cuuint64_t dims[4], const cuuint64_t strides[3],
                   const cuuint32_t box[4]) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A dynamic shared-memory base rounded up to 1024 bytes (the launch asks
// for 1024 bytes more than its tiles take).
__device__ __forceinline__ uint32_t* align1024(void* p) {
  const uint32_t a = smem_u32(p);
  return reinterpret_cast<uint32_t*>(static_cast<char*>(p) +
                                     ((1024 - (a & 1023)) & 1023));
}

// The Gram block route's step (rbf_gram.cu mma_chunk): a warp's two
// 16-row A tiles against eight 8-column B tiles.
template <typename T>
struct Mma;

template <>
struct Mma<float> {   // 3xTF32: lo*hi, hi*lo, hi*hi a tile and step
  static __device__ __forceinline__ void step(const uint32_t xa[2][4],
                                              const uint32_t yb[4][4],
                                              float acc[2][8][4]) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(xa[i][e], ah[i][e], al[i][e]);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bh[2], bl[2];
        split_tf32(yb[jp][2 * h], bh[0], bl[0]);
        split_tf32(yb[jp][2 * h + 1], bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* c = acc[i][2 * jp + h];
          mma_tf32(c, al[i], bh);
          mma_tf32(c, ah[i], bl);
          mma_tf32(c, ah[i], bh);
        }
      }
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void step(const uint32_t xa[2][4],
                                              const uint32_t yb[4][4],
                                              float acc[2][8][4]) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16(acc[i][2 * jp + h], xa[i], yb[jp] + 2 * h);
  }
};

}  // namespace svm
