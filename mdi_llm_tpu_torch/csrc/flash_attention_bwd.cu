// FlashAttention-2 backward for Hopper (sm_90a): dQ (K3) and dK/dV (K4).
//
// Replaces the Pallas kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// mdi_llm_tpu/ops/flash.py (launched by `_flash_bwd_impl`, the backward of
// `flash_attention` and `flash_attention_lse`).  They compute the same
// functions, over one fresh chunk (q_pos == k_pos == arange(T)):
//
//   q, dout (B, H, T, hs)   queries and the output's cotangent, one dtype
//   k, v    (B, G, T, hs)   keys/values; head h reads group h / (H / G)
//   lse     (B, H, T) f32   the forward's per-query logsumexp
//   dsum    (B, H, T) f32   D = rowsum(dO * O) - dlse
//
//   P  = exp(min(scale * q k^T - lse, 80)) where key j is valid for query i
//        (j < T, and j <= i when causal), else 0
//   dS = P * (dO v^T - D)
//   K3: dq (B, H, T, hs) in q's dtype = scale * dS k
//   K4: dk (B, G, T, hs) f32          = scale * sum over the group's heads of dS^T q
//       dv (B, G, T, hs) f32          = sum over the group's heads of P^T dO
//
// The TPU kernel writes K4's outputs per query head and sums each GQA
// group outside; here the sum runs inside the block, over the group's
// heads in a fixed order, with no atomics: both outputs are deterministic.
//
// Bound on the H100.  The work grows as T^2 while the bytes grow as T, so
// at training lengths both kernels are bound by operations: per valid
// (query, key) pair and head, 6 * hs flops for K3 (S, dP, dQ) and 8 * hs
// for K4 (S, dP, dV, dK).  Only bf16 tensor cores (989 TFLOP/s dense)
// reach that bound; CUDA-core float32 math stops near 67 TFLOP/s.
//
// Two kernels each, chosen by dtype alone:
//
// bfloat16 (the training path): tensor cores, K2's structure (tma.cuh,
// wgmma.cuh).  A block is three warpgroups: two consumers of 64 rows (K3)
// or keys (K4) each and a producer whose one thread issues every TMA copy
// into 128B-swizzled panels (64B at hs 32), rows past T read as zeros.
// `setmaxnreg` moves registers from the producer (24) to the consumers
// (240), which hold four products' accumulators at hs 128.
//  - K4: one block per (128-key tile, KV group, batch row); key tile 0,
//    which the most query tiles see, is launched first.  The tile's K and
//    V are loaded once.  The block loops over the group's H / G heads and,
//    per head, over the Q tiles of 128 rows (64 at hs 128) from the first
//    that sees the tile (causal) to T: Q, dO and the tile's LSE and D
//    stream through a 2-stage ring with full/empty mbarriers.  Per Q tile
//    a consumer forms S^T = K Q^T and dP^T = V dO^T (wgmma m64nNk16, N the
//    tile's rows, both operands from shared memory, K-major), then P^T and
//    dS^T in float32 registers, then dV += P^T dO and dK += dS^T Q with
//    P^T and dS^T as the register A operand and dO, Q read transposed
//    (MN-major).  dK and dV stay in registers across the group's heads and
//    are written once, as float32.
//  - K3: one block per (128-row query tile, head, batch row); causal grids
//    start with the last query tiles, which walk the most keys.  Q and dO
//    are loaded once, 128-key K/V tiles stream through the ring up to the
//    causal frontier; each thread reads its two rows' LSE and D once.  Per
//    tile: S = Q K^T and dP = dO V^T (ss, K-major), P and dS in float32,
//    dQ += dS K (dS the register A operand, K read transposed).  No online
//    softmax: the LSE is known.  dQ * scale is rounded to bf16 once.
//  - The A operands are packed to bf16 before their products are issued
//    and stay untouched until the group completes (otherwise ptxas fences
//    every product).
//  - Masks are evaluated only on tiles that cross the diagonal or T; a
//    consumer whose rows/keys lie wholly on the masked side of a tile (or
//    past T) skips its math but still frees the stage.  The LSE and D of
//    Q rows past T (K4) come from a 1-D map over the whole (B, H, T)
//    array (elements past it read as zeros), so they are never read out
//    of bounds; such rows get P = 0 and dS = 0 by the mask.  Keys past T
//    are never written.
//  - Roundings the plain versions do not make: P (K4, for dV) and dS (K3
//    and K4, for dQ and dK) are rounded to bf16 as the A operand
//    (2^-8 relative at most); dS is formed from the float32 P.  Products
//    of bf16 operands are exact in the float32 accumulators; only the
//    summation order differs.  exp is evaluated as exp2 of a log2e-scaled
//    argument.
//
// float32 (the parity checks' dtype, which needs true float32 products:
// TF32 tensor cores would not do): CUDA cores, as first written.
//  - K3: one block per (query tile of 32 rows, head, batch row); q and dO
//    rows in shared memory, 32-key K/V tiles streamed up to the causal
//    frontier; lane i owns key i in the score phase and dims i, i + 32,
//    ... in the product phase.
//  - K4: one block per (key tile of 32 keys, KV group, batch row), looping
//    over the group's heads and, per head, over 32-row Q/dO tiles from the
//    first that sees the key tile; lane i owns query row i in the score
//    phase and dims i, i + 32, ... of dK and dV in the product phase.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kExpClamp = 80.f;  // the TPU kernels' exp argument cap
constexpr float kLog2e = 1.4426950408889634f;

// ---- float32: CUDA cores ----

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 8;               // rows (K3) or keys (K4) per warp
constexpr int kTile = kWarps * kPerWarp;  // rows/keys per tile, one per lane

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// rows [r0, r0 + kTile) of a row-major (n_tok, HS) matrix -> shared memory
// with row stride ST; rows at or past n_tok are zeros
template <int HS, int ST>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, int r0,
                                           int n_tok, float* dst, int tid) {
  constexpr int VPR = HS / 4;  // 16-byte loads per row
  for (int i = tid; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 4, row = r0 + r;
    const float4 x = row < n_tok ? *reinterpret_cast<const float4*>(src + (size_t)row * HS + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[r * ST + c] = x.x;
    dst[r * ST + c + 1] = x.y;
    dst[r * ST + c + 2] = x.z;
    dst[r * ST + c + 3] = x.w;
  }
}

template <int HS>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dq, int H, int G, int n_tok, float scale,
                int causal) {
  constexpr int DPL = HS / 32;  // output dims per lane
  // K/V rows padded by 4 floats: lane-per-key float4 reads, 8 lanes per
  // phase, land on distinct banks
  constexpr int KST = HS + 4;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;               // kTile x HS
  float* dos = qs + kTile * HS;   // kTile x HS
  float* ks = dos + kTile * HS;   // kTile x KST
  float* vs = ks + kTile * KST;   // kTile x KST

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int row0 = tile * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t hrow = ((size_t)b * H + h) * n_tok;  // this head's row 0
  const float* kg = k + ((size_t)b * G + g) * n_tok * HS;
  const float* vg = v + ((size_t)b * G + g) * n_tok * HS;

  stage_tile<HS, HS>(q + hrow * HS, row0, n_tok, qs, tid);
  stage_tile<HS, HS>(dout + hrow * HS, row0, n_tok, dos, tid);

  const int wrow0 = row0 + warp * kPerWarp;  // this warp's first row
  float lse_r[kPerWarp], d_r[kPerWarp], acc[kPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = wrow0 + i;
    lse_r[i] = row < n_tok ? lse[hrow + row] : 0.f;
    d_r[i] = row < n_tok ? dsum[hrow + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }
  // the causal frontier: no row of this block sees a key past its last row
  const int n_keys = causal ? min(n_tok, row0 + kTile) : n_tok;

  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs/dos are written)
    stage_tile<HS, KST>(kg, k0, n_keys, ks, tid);
    stage_tile<HS, KST>(vg, k0, n_keys, vs, tid);
    __syncthreads();

    // s = q.k and dO.v: lane owns key k0 + lane, for each of the warp's rows
    float sc[kPerWarp], dp[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HS; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(ks + lane * KST + d);
      const float4 vd = *reinterpret_cast<const float4*>(vs + lane * KST + d);
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int r = (warp * kPerWarp + i) * HS + d;
        sc[i] += dot4(*reinterpret_cast<const float4*>(qs + r), kd);
        dp[i] += dot4(*reinterpret_cast<const float4*>(dos + r), vd);
      }
    }
    const int key = k0 + lane;
    float ds[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int row = wrow0 + i;
      const bool ok = row < n_tok && key < n_tok && (!causal || key <= row);
      const float p = ok ? expf(fminf(scale * sc[i] - lse_r[i], kExpClamp)) : 0.f;
      ds[i] = p * (dp[i] - d_r[i]);
    }
    // dQ += dS k: each K row is read from shared memory once for all 8 rows
    for (int j = 0; j < kTile; ++j) {
      float kj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) kj[c] = ks[j * KST + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += dsj * kj[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int row = wrow0 + i;
    if (row >= n_tok) continue;
    float* o = dq + (hrow + row) * HS;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[lane + 32 * c] = acc[i][c] * scale;
  }
}

template <int HS>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int G,
                 int n_tok, float scale, int causal) {
  constexpr int DPL = HS / 32;
  constexpr int QST = HS + 4;  // padded: lane-per-row float4 reads

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;              // kTile x HS
  float* vs = ks + kTile * HS;   // kTile x HS
  float* qs = vs + kTile * HS;   // kTile x QST
  float* dos = qs + kTile * QST; // kTile x QST

  // causal: the first key tiles are seen by the most query tiles, and
  // blockIdx.x 0 is scheduled first
  const int key0 = blockIdx.x * kTile;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_heads = H / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t grow = ((size_t)b * G + g) * n_tok;  // this group's row 0
  stage_tile<HS, HS>(k + grow * HS, key0, n_tok, ks, tid);
  stage_tile<HS, HS>(v + grow * HS, key0, n_tok, vs, tid);

  const int wkey0 = key0 + warp * kPerWarp;  // this warp's first key
  float adk[kPerWarp][DPL], adv[kPerWarp][DPL];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) adk[j][c] = adv[j][c] = 0.f;
  }
  // no query row before key0 sees a key of this tile (query and key tiles
  // have the same size, so that row starts a query tile)
  const int first_row = causal ? key0 : 0;

  // the group's heads in order: their shares sum in the accumulators
  for (int hh = 0; hh < n_heads; ++hh) {
    const size_t hrow = ((size_t)b * H + g * n_heads + hh) * n_tok;  // this head's row 0
    const float* qh = q + hrow * HS;
    const float* doh = dout + hrow * HS;
    for (int r0 = first_row; r0 < n_tok; r0 += kTile) {
      __syncthreads();  // the previous tile is consumed (and ks/vs are written)
      stage_tile<HS, QST>(qh, r0, n_tok, qs, tid);
      stage_tile<HS, QST>(doh, r0, n_tok, dos, tid);
      __syncthreads();

      // s = q.k and dO.v: lane owns query row r0 + lane, for each of the
      // warp's keys
      const int row = r0 + lane;
      const bool row_ok = row < n_tok;
      const float lse_i = row_ok ? lse[hrow + row] : 0.f;
      const float d_i = row_ok ? dsum[hrow + row] : 0.f;
      float sc[kPerWarp], dp[kPerWarp];
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) sc[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HS; d += 4) {
        const float4 qd = *reinterpret_cast<const float4*>(qs + lane * QST + d);
        const float4 dd = *reinterpret_cast<const float4*>(dos + lane * QST + d);
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j) {
          const int r = (warp * kPerWarp + j) * HS + d;
          sc[j] += dot4(qd, *reinterpret_cast<const float4*>(ks + r));
          dp[j] += dot4(dd, *reinterpret_cast<const float4*>(vs + r));
        }
      }
      float p[kPerWarp], ds[kPerWarp];
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const int key = wkey0 + j;
        const bool ok = row_ok && key < n_tok && (!causal || key <= row);
        p[j] = ok ? expf(fminf(scale * sc[j] - lse_i, kExpClamp)) : 0.f;
        ds[j] = p[j] * (dp[j] - d_i);
      }
      // dV += P^T dO and dK += dS^T q over the tile's rows: each Q/dO row
      // is read from shared memory once for all 8 keys
      for (int i = 0; i < kTile; ++i) {
        float qi[DPL], di[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          qi[c] = qs[i * QST + lane + 32 * c];
          di[c] = dos[i * QST + lane + 32 * c];
        }
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j) {
          const float pij = __shfl_sync(0xffffffffu, p[j], i);
          const float dsij = __shfl_sync(0xffffffffu, ds[j], i);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            adv[j][c] += pij * di[c];
            adk[j][c] += dsij * qi[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int key = wkey0 + j;
    if (key >= n_tok) continue;
    const size_t o = (grow + key) * HS;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dk[o + lane + 32 * c] = adk[j][c] * scale;
      dv[o + lane + 32 * c] = adv[j][c];
    }
  }
}

// shared memory of either kernel: two tiles at stride HS, two at HS + 4
template <int HS>
constexpr size_t smem_bytes() {
  return (size_t)(2 * kTile * HS + 2 * kTile * (HS + 4)) * sizeof(float);
}

template <int HS>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int B, int H,
              int G, int n_tok, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_dq_kernel<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<HS>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tok + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem_bytes<HS>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
      static_cast<float*>(dq), H, G, n_tok, scale, causal);
  return (int)cudaGetLastError();
}

template <int HS>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, float* dk, float* dv,
               int B, int H, int G, int n_tok, float scale, int causal,
               cudaStream_t stream) {
  auto kern = flash_dkv_kernel<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<HS>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tok + kTile - 1) / kTile, G, B);
  kern<<<grid, kThreads, smem_bytes<HS>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum, dk,
      dv, H, G, n_tok, scale, causal);
  return (int)cudaGetLastError();
}

// ---- bfloat16: tensor cores (wgmma), fed by TMA ----

constexpr int kWgConsumers = 2;                       // consumer warpgroups
constexpr int kWgThreads = (kWgConsumers + 1) * 128;  // and one producer warpgroup
constexpr int kStages = 2;                            // streamed tiles in the ring
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg
constexpr int kDkvKeys = kWgConsumers * 64;  // K4: keys per block
// K4's streamed tiles: Q rows per tile (128 where the consumers' registers
// hold the four accumulators, 64 at hs 128), and the LSE and D slices: a
// TMA box must start 16 bytes aligned, so a slice's box starts at the
// tile's first element rounded down to a multiple of 4 and holds 4 more;
// slices lie kSliceStride floats apart (128-byte aligned)
template <int HS> struct DkvTile {
  static constexpr int kRows = HS <= 64 ? 128 : 64;
  static constexpr int kSliceBox = kRows + 4;
  static constexpr int kSliceStride = (kSliceBox + 31) / 32 * 32;
};
constexpr int kDqRows = kWgConsumers * 64;   // K3: query rows per block
constexpr int kDqKeys = 128;                 // K3: keys per streamed K/V tile

__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
}
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
}

// d (64 x N) = A B^T for a 64-row A tile and an N-row B tile, both K-major
// panels of HS columns (K = HS); a_rows and b_rows are the tiles' panel
// heights
template <int HS, int N>
__device__ __forceinline__ void wgmma_abt(float (&d)[N / 2], const unsigned char* a, int a_rows,
                                          const unsigned char* bt, int b_rows) {
  static_assert(N == 64 || N == 128, "wgmma_abt: N is 64 or 128");
  constexpr int PC = Panel<HS>::kCols, RB = Panel<HS>::kRowBytes, LAY = Panel<HS>::kLayout;
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk) {
    const int pan = kk / (PC / 16), in = (kk % (PC / 16)) * 32;
    const uint64_t da = wg_desc(a + pan * a_rows * RB + in, 16, 8 * RB, LAY);
    const uint64_t db = wg_desc(bt + pan * b_rows * RB + in, 16, 8 * RB, LAY);
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, kk > 0);
    if constexpr (N == 128) wgmma_ss_n128(d, da, db, kk > 0);
  }
}

// x (64 x N, float32 accumulator layout) rounded to bf16 pairs: the
// register A operand of a product over N, k-step j in a[4j] to a[4j + 3]
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 4], const float (&x)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// acc (64 x HS) += A (64 x N, packed by pack_a) times an N-row tile of HS
// columns read MN-major.  The A registers are read asynchronously: they
// stay untouched until the group's wgmma_wait0.
template <int HS, int N>
__device__ __forceinline__ void wgmma_xb(float (&acc)[HS / 2], const uint32_t (&a)[N / 4],
                                         const unsigned char* b) {
  constexpr int RB = Panel<HS>::kRowBytes, LAY = Panel<HS>::kLayout;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs_tb<HS>(acc, *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * kk]),
                    wg_desc(b + kk * 16 * RB, N * RB, 8 * RB, LAY));
}

template <int HS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wg_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap ml,
                    const __grid_constant__ CUtensorMap md,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int B, int H, int G, int n_tok, float scale, int causal) {
  constexpr int ROWS = DkvTile<HS>::kRows, SLICE = DkvTile<HS>::kSliceStride;
  constexpr int KV_BYTES = kDkvKeys * HS * 2;  // the K (or V) tile
  constexpr int Q_BYTES = ROWS * HS * 2;       // a streamed Q (or dO) tile
  constexpr int ROW_BYTES = DkvTile<HS>::kSliceBox * 4;  // a streamed LSE (or D) slice
  constexpr int PC = Panel<HS>::kCols, RB = Panel<HS>::kRowBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ks = smem_aligned(smem_raw);
  unsigned char* vs = ks + KV_BYTES;
  unsigned char* qs = vs + KV_BYTES;            // kStages Q tiles
  unsigned char* dos = qs + kStages * Q_BYTES;  // kStages dO tiles
  float* ls = reinterpret_cast<float*>(dos + kStages * Q_BYTES);  // kStages slices
  float* dd = ls + kStages * SLICE;
  uint64_t* full = reinterpret_cast<uint64_t*>(dd + kStages * SLICE);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  // key tile 0 of every (group, batch row) first: it sees the most Q tiles
  const int gb = blockIdx.x % (G * B);
  const int g = gb % G, b = gb / G;
  const int k0 = (blockIdx.x / (G * B)) * kDkvKeys;
  const int n_heads = H / G;
  const int first_r = causal ? k0 : 0;  // the first Q tile that sees the key tile
  const int n_qt = (n_tok - first_r + ROWS - 1) / ROWS;  // Q tiles per head
  const int n_iter = n_heads * n_qt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 128);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {  // the producer: one thread issues every copy
    regs_dealloc();
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(kv_bar, 2 * KV_BYTES);
      for (int c = 0; c < HS / PC; ++c) {
        tma_load(ks + c * kDkvKeys * RB, &mk, kv_bar, PC * c, k0, b * G + g);
        tma_load(vs + c * kDkvKeys * RB, &mv, kv_bar, PC * c, k0, b * G + g);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int bh = b * H + g * n_heads + it / n_qt;
        const int r0 = first_r + (it % n_qt) * ROWS;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Q_BYTES + 2 * ROW_BYTES);
        for (int c = 0; c < HS / PC; ++c) {
          tma_load(qs + s * Q_BYTES + c * ROWS * RB, &mq, &full[s], PC * c, r0, bh);
          tma_load(dos + s * Q_BYTES + c * ROWS * RB, &mdo, &full[s], PC * c, r0, bh);
        }
        const int x0 = (bh * n_tok + r0) & ~3;
        tma_load_1d(ls + s * SLICE, &ml, &full[s], x0);
        tma_load_1d(dd + s * SLICE, &md, &full[s], x0);
      }
    }
    return;
  }

  regs_alloc();
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wkey0 = k0 + wg * 64;                 // this warpgroup's first key
  const int key = wkey0 + warp * 16 + lane / 4;   // this thread's keys: key, key + 8
  const float sl2 = scale * kLog2e;
  float adk[HS / 2], adv[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) adk[i] = adv[i] = 0.f;
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int r0 = first_r + (it % n_qt) * ROWS;
    const int bh = b * H + g * n_heads + it / n_qt;
    mbar_wait(&full[s], (it / kStages) & 1);
    // uniform over the warpgroup: its keys past T, or all above the tile's rows
    if (wkey0 < n_tok && (!causal || wkey0 <= r0 + ROWS - 1)) {
      const unsigned char* qt = qs + s * Q_BYTES;
      const unsigned char* dot = dos + s * Q_BYTES;
      float st[ROWS / 2], dpt[ROWS / 2];  // S^T, dP^T: this warpgroup's 64 keys x the tile's rows
      wgmma_fence();
      wgmma_abt<HS, ROWS>(st, ks + wg * 64 * RB, kDkvKeys, qt, ROWS);
      wgmma_abt<HS, ROWS>(dpt, vs + wg * 64 * RB, kDkvKeys, dot, ROWS);
      wgmma_commit();
      wgmma_wait0();

      // the tile's row r0 + c is element ((bh * n_tok + r0) & 3) + c of the slices
      const float* lt = ls + s * SLICE + ((bh * n_tok + r0) & 3);
      const float* dt = dd + s * SLICE + ((bh * n_tok + r0) & 3);
      const bool masked = r0 + ROWS > n_tok || wkey0 + 64 > n_tok ||
                          (causal && wkey0 + 63 > r0);
#pragma unroll
      for (int n = 0; n < ROWS / 8; ++n) {
        const int c = 8 * n + 2 * (lane % 4);  // this thread's rows r0 + c, r0 + c + 1
        const float l2[2] = {lt[c], lt[c + 1]}, d2[2] = {dt[c], dt[c + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = l2[e & 1];
          const float d_c = d2[e & 1];
          float p = exp2f(fminf(st[4 * n + e] * sl2 - lse_c * kLog2e, kExpClamp * kLog2e));
          float ds = p * (dpt[4 * n + e] - d_c);
          if (masked) {
            const int row = r0 + c + (e & 1);
            const int kj = key + (e >= 2 ? 8 : 0);
            if (row >= n_tok || kj >= n_tok || (causal && kj > row)) p = ds = 0.f;
          }
          st[4 * n + e] = p;
          dpt[4 * n + e] = ds;
        }
      }
      uint32_t pa[ROWS / 4], sa[ROWS / 4];  // P^T and dS^T as bf16 A operands
      pack_a<ROWS>(pa, st);
      pack_a<ROWS>(sa, dpt);
      wgmma_fence();
      wgmma_xb<HS, ROWS>(adv, pa, dot);   // dV += P^T dO
      wgmma_xb<HS, ROWS>(adk, sa, qt);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
    }
    mbar_arrive(&empty[s]);
  }

  const size_t grow = ((size_t)b * G + g) * n_tok;  // this group's row 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key + 8 * r;
    if (kj >= n_tok) continue;
    float* dkr = dk + (grow + kj) * HS + 2 * (lane % 4);
    float* dvr = dv + (grow + kj) * HS + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < HS / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(adk[4 * n + 2 * r] * scale, adk[4 * n + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(adv[4 * n + 2 * r], adv[4 * n + 2 * r + 1]);
    }
  }
}

template <int HS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wg_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dq, int H, int G, int n_tok, float scale,
                   int causal) {
  constexpr int Q_BYTES = kDqRows * HS * 2;   // the Q (or dO) tile
  constexpr int KV_BYTES = kDqKeys * HS * 2;  // a streamed K (or V) tile
  constexpr int PC = Panel<HS>::kCols, RB = Panel<HS>::kRowBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_aligned(smem_raw);
  unsigned char* dos = qs + Q_BYTES;
  unsigned char* ks = dos + Q_BYTES;            // kStages K tiles
  unsigned char* vs = ks + kStages * KV_BYTES;  // kStages V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * KV_BYTES);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int row0 = tile * kDqRows;
  // the causal frontier: no row of this block sees a key past its last row
  const int n_keys = causal ? min(n_tok, row0 + kDqRows) : n_tok;
  const int n_tiles = (n_keys + kDqKeys - 1) / kDqKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 128);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {  // the producer: one thread issues every copy
    regs_dealloc();
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_bar, 2 * Q_BYTES);
      for (int c = 0; c < HS / PC; ++c) {
        tma_load(qs + c * kDqRows * RB, &mq, q_bar, PC * c, row0, b * H + h);
        tma_load(dos + c * kDqRows * RB, &mdo, q_bar, PC * c, row0, b * H + h);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        for (int c = 0; c < HS / PC; ++c) {
          tma_load(ks + s * KV_BYTES + c * kDqKeys * RB, &mk, &full[s], PC * c, t * kDqKeys, b * G + g);
          tma_load(vs + s * KV_BYTES + c * kDqKeys * RB, &mv, &full[s], PC * c, t * kDqKeys, b * G + g);
        }
      }
    }
    return;
  }

  regs_alloc();
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wrow0 = row0 + wg * 64;               // this warpgroup's first row
  const int wrow = wrow0 + warp * 16 + lane / 4;  // this thread's rows: wrow, wrow + 8
  const float sl2 = scale * kLog2e;
  const size_t hrow = ((size_t)b * H + h) * n_tok;  // this head's row 0
  float lse2[2], d_r[2];  // per row: lse * log2(e) and D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;
    lse2[r] = row < n_tok ? lse[hrow + row] * kLog2e : 0.f;
    d_r[r] = row < n_tok ? dsum[hrow + row] : 0.f;
  }
  float acc[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kDqKeys;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (!causal || k0 <= wrow0 + 63) {  // uniform over the warpgroup
      const unsigned char* kt = ks + s * KV_BYTES;
      float sc[kDqKeys / 2], dp[kDqKeys / 2];  // S, dP: this warpgroup's 64 rows x the tile's keys
      wgmma_fence();
      wgmma_abt<HS, kDqKeys>(sc, qs + wg * 64 * RB, kDqRows, kt, kDqKeys);
      wgmma_abt<HS, kDqKeys>(dp, dos + wg * 64 * RB, kDqRows, vs + s * KV_BYTES, kDqKeys);
      wgmma_commit();
      wgmma_wait0();

      const bool masked = k0 + kDqKeys > n_tok || (causal && k0 + kDqKeys - 1 > wrow0);
#pragma unroll
      for (int n = 0; n < kDqKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = exp2f(fminf(sc[4 * n + e] * sl2 - lse2[r], kExpClamp * kLog2e));
          float ds = p * (dp[4 * n + e] - d_r[r]);
          if (masked) {
            const int kj = k0 + 8 * n + 2 * (lane % 4) + (e & 1);
            if (kj >= n_tok || (causal && kj > wrow + 8 * r)) ds = 0.f;
          }
          sc[4 * n + e] = ds;
        }
      }
      uint32_t sa[kDqKeys / 4];  // dS as the bf16 A operand
      pack_a<kDqKeys>(sa, sc);
      wgmma_fence();
      wgmma_xb<HS, kDqKeys>(acc, sa, kt);  // dQ += dS K
      wgmma_commit();
      wgmma_wait0();
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;
    if (row >= n_tok) continue;
    __nv_bfloat16* o = dq + (hrow + row) * HS + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < HS / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
  }
}

// the registers setmaxnreg hands out must be there at launch: a kernel
// allocated fewer would wait for them forever
template <typename Kern>
int check_regs(Kern kern) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  return attr.numRegs * kWgThreads >= (kProducerRegs + kWgConsumers * kConsumerRegs) * 128
             ? 0 : -4;
}

template <int HS>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* dsum, float* dk, float* dv, int B,
                  int H, int G, int n_tok, float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv, ml, md;
  int rc = make_map(&mq, q, HS, n_tok, B * H, DkvTile<HS>::kRows);
  if (rc == 0) rc = make_map(&mdo, dout, HS, n_tok, B * H, DkvTile<HS>::kRows);
  if (rc == 0) rc = make_map(&mk, k, HS, n_tok, B * G, kDkvKeys);
  if (rc == 0) rc = make_map(&mv, v, HS, n_tok, B * G, kDkvKeys);
  if (rc == 0) rc = make_map_1d(&ml, lse, B * H * n_tok, DkvTile<HS>::kSliceBox);
  if (rc == 0) rc = make_map_1d(&md, dsum, B * H * n_tok, DkvTile<HS>::kSliceBox);
  if (rc != 0) return rc;
  const size_t smem = (size_t)(2 * kDkvKeys + 2 * kStages * DkvTile<HS>::kRows) * HS * 2 +
                      2 * kStages * DkvTile<HS>::kSliceStride * 4 +
                      (2 * kStages + 1) * sizeof(uint64_t) + 1024;
  auto kern = flash_dkv_wg_kernel<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((rc = check_regs(kern)) != 0) return rc;
  const int n_ktiles = (n_tok + kDkvKeys - 1) / kDkvKeys;
  kern<<<n_ktiles * G * B, kWgThreads, smem, stream>>>(mq, mdo, mk, mv, ml, md, dk, dv, B, H,
                                                       G, n_tok, scale, causal);
  return (int)cudaGetLastError();
}

template <int HS>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* dsum, void* dq, int B, int H, int G,
                 int n_tok, float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int rc = make_map(&mq, q, HS, n_tok, B * H, kDqRows);
  if (rc == 0) rc = make_map(&mdo, dout, HS, n_tok, B * H, kDqRows);
  if (rc == 0) rc = make_map(&mk, k, HS, n_tok, B * G, kDqKeys);
  if (rc == 0) rc = make_map(&mv, v, HS, n_tok, B * G, kDqKeys);
  if (rc != 0) return rc;
  const size_t smem = (size_t)(2 * kDqRows + 2 * kStages * kDqKeys) * HS * 2 +
                      (2 * kStages + 1) * sizeof(uint64_t) + 1024;
  auto kern = flash_dq_wg_kernel<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((rc = check_regs(kern)) != 0) return rc;
  const dim3 grid((n_tok + kDqRows - 1) / kDqRows, H, B);
  kern<<<grid, kWgThreads, smem, stream>>>(mq, mdo, mk, mv, lse, dsum,
                                           static_cast<__nv_bfloat16*>(dq), H, G, n_tok,
                                           scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout alike); lse and dsum
// float32; causal: 0 or 1.  Each returns 0, -1 for an unsupported
// (dtype, hs), -2/-3 when a tensor map cannot be encoded, -4 when the
// tensor-core kernel was built with too few registers for its setmaxnreg
// split, or the cudaError_t of the launch.

extern "C" int flash_attention_dq_launch(
    int dtype, int hs, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dsum, void* dq, int B, int H,
    int G, int n_tok, float scale, int causal, void* stream) {
  if (B == 0 || n_tok == 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_HS(N)                                                                        \
  case N:                                                                               \
    return dtype == 0                                                                   \
               ? launch_dq<N>(q, k, v, dout, l, d, dq, B, H, G, n_tok, scale, causal, st) \
               : launch_dq_tc<N>(q, k, v, dout, l, d, dq, B, H, G, n_tok, scale, causal, st);
  if (dtype != 0 && dtype != 1) return -1;
  switch (hs) {
    DQ_HS(32)
    DQ_HS(64)
    DQ_HS(128)
    default:
      return -1;
  }
#undef DQ_HS
}

extern "C" int flash_attention_dkv_launch(
    int dtype, int hs, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
    int B, int H, int G, int n_tok, float scale, int causal, void* stream) {
  if (B == 0 || n_tok == 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_HS(N)                                                                      \
  case N:                                                                              \
    return dtype == 0 ? launch_dkv<N>(q, k, v, dout, l, d, k_out, v_out, B, H, G, n_tok, \
                                      scale, causal, st)                               \
                      : launch_dkv_tc<N>(q, k, v, dout, l, d, k_out, v_out, B, H, G,   \
                                         n_tok, scale, causal, st);
  if (dtype != 0 && dtype != 1) return -1;
  switch (hs) {
    DKV_HS(32)
    DKV_HS(64)
    DKV_HS(128)
    default:
      return -1;
  }
#undef DKV_HS
}
