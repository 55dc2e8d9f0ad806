// What the tensor-core flash kernels (flash_attention.cu, K2; and
// flash_attention_bwd.cu, K3 and K4) share on sm_90a: the swizzled panel
// layout their TMA copies write and their wgmma descriptors read, the
// mbarriers of their producer/consumer rings, the copies themselves and
// the host-side encoding of the tensor maps.
//
// Panel layout.  A bf16 tile of `rows` rows x HS columns lies in shared
// memory as HS / kCols panels, each `rows` rows of one swizzled kCols-column
// row (128 bytes, 64 at hs 32): what one TMA box of a `make_map` map
// writes.  8-row groups lie 8 * kRowBytes apart.
//  - K-major operand (the contraction runs along HS, e.g. Q and K of
//    Q K^T): a 16-column k-step starts 32 bytes further into the row, a
//    64-column one a panel further; descriptor (16, 8 * kRowBytes).
//  - MN-major operand (the contraction runs along the rows, e.g. V of
//    P V, read transposed): a 16-row k-step starts 16 rows further;
//    descriptor (rows * kRowBytes, 8 * kRowBytes): the leading offset is
//    the panel stride, the next 64 columns of N.
// Panels start on 1024-byte boundaries (the 128-byte swizzle's period).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HS> struct Panel {
  static constexpr int kCols = HS < 64 ? HS : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B or 64B swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the dynamic shared memory rounded up to the swizzle's 1024-byte period
__device__ __forceinline__ unsigned char* smem_aligned(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---- the ring's mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- TMA copies, completing on an mbarrier ----

// one panel (Panel<HS>::kCols columns) of a box's rows of a (hs, T, heads) map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(head) : "memory");
}
// one box of a 1-D map, starting at element `x`
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(x) : "memory");
}

// ---- wgmma operands ----

// shared-memory matrix descriptor: start, leading and stride byte offsets,
// swizzle layout (1 = 128-byte, 2 = 64-byte)
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo, int layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- host: tensor maps, encoded per call ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      encode = nullptr;
  }
  return encode;
}

// a (hs, T, heads) bf16 map whose box is one swizzled panel of `rows` rows;
// rows past T read as zeros.  Returns 0, -2 when cuTensorMapEncodeTiled
// cannot be found, -3 when the encoding is refused.
inline int make_map(CUtensorMap* map, const void* base, int hs, int n_tok, int heads, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[3] = {(cuuint64_t)hs, (cuuint64_t)n_tok, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hs * 2, (cuuint64_t)n_tok * hs * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(hs < 64 ? hs : 64), (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                hs < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : -3;
}

// a 1-D float32 map of n elements with boxes of `box` elements; elements
// past n read as zeros
inline int make_map_1d(CUtensorMap* map, const void* base, int n, int box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unread at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t step[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
                strides, boxes, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : -3;
}

}  // namespace
