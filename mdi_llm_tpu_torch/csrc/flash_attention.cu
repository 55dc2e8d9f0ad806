// Flash self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_kernel` in mdi_llm_tpu/ops/flash.py
// (launched by `_flash_call` for `flash_attention` and
// `flash_attention_lse`).  It computes the same function:
//
//   q    (B, H, T, hs)   queries of one fresh chunk, q_pos = arange(T)
//   k, v (B, G, T, hs)   keys/values of the same chunk, k_pos = arange(T)
//   out  (B, H, T, hs)   softmax(scale * q k^T + mask) v, in q's dtype
//   lse  (B, H, T) f32   optional: m + log(l) per query row, NEG_INF (-1e30)
//                        where the row saw no key (l == 0)
//
// Key j is valid for query i iff j < T, and j <= i when causal.  Head h
// reads KV group h / (H / G).  Logits, softmax and accumulators are
// float32.
//
// Two kernels, chosen by dtype alone:
//
// bfloat16 (the main path of generation and training): tensor cores.
//  - Bound.  At prefill lengths the work grows as T^2 while the bytes grow
//    as T (causal: 4 * B * H * hs * T(T+1)/2 flops), so on the H100 the
//    kernel is bound by operations, and only bf16 tensor cores (989
//    TFLOP/s dense) reach that bound; CUDA-core float32 math cannot get
//    below flops / 67 TFLOP/s.
//  - One block per (query tile of 128 rows, head, batch row) of three
//    warpgroups: two consumers own 64 rows each, one producer thread
//    issues every copy.  Causal grids start with the tiles nearest the end
//    of the chunk, which walk the most keys.
//  - The producer brings the Q tile once and the K/V tiles of 128 keys into
//    a ring of 2 shared-memory stages by TMA (cp.async.bulk.tensor, one box
//    per 64-column panel with the 128-byte swizzle, 32 columns and 64-byte
//    at hs 32; rows past T read as zeros), each stage with a
//    "full" mbarrier (the copies' bytes) and an "empty" one (every consumer
//    thread is done with it), so the next tiles are in flight while this
//    one's math runs and no consumer spends an instruction on a copy.
//  - S = Q K^T by wgmma.m64n128k16 from shared memory (bf16 operands,
//    float32 accumulation, both K-major, swizzled); scale is
//    applied to the float32 scores (for hs = 64 it is 1/8, so this equals
//    the TPU kernel's pre-scaled q exactly).
//  - Online softmax on the accumulator registers: row max and sum over the
//    four threads that share a row by shuffles, all in float32; the mask is
//    evaluated only on tiles that reach past the chunk or the diagonal, and
//    a consumer skips the tiles wholly above its rows' diagonal.
//  - P is rounded to bf16 in registers and is the register A operand of
//    O += P V (wgmma.m64nHSk16, V read transposed from shared memory).
//    That rounding (2^-9 relative per element) is the only one the float32
//    kernel does not make; l sums the unrounded p.
//
// float32 (the parity checks' dtype, which needs true float32 products:
// TF32 tensor cores would not do): CUDA cores.
//  - one block per (query tile of 32 rows, head, batch row); the tile's
//    rows are held in shared memory in float32, pre-scaled; each 32-key
//    K/V tile is staged in shared memory with 16-byte loads;
//  - in the score phase lane i owns key i, in the PV phase lane i owns
//    output dims i, i + 32, ...; every warp owns 8 rows, and keeps their
//    running max m, sum l and accumulator in float32 registers.
//
// Both: a causal block stops at the key tile holding its last row, a
// non-causal one walks all T keys; a row that sees no key gives out 0 and
// lse -1e30.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per K/V tile, one per lane
constexpr float kNegInf = -1e30f;             // the TPU kernel's finite NEG_INF

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// 16 bytes at `src` (16-byte aligned) -> float dst[4]
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- float32: CUDA cores ----

template <typename T, int HS>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int G, int n_tok,
                       float scale, int causal) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HS / VEC;        // 16-byte loads per row
  constexpr int DPL = HS / 32;         // output dims per lane
  // K rows padded by 4 floats: lane-per-key float4 reads, 8 lanes per
  // phase, land on distinct banks
  constexpr int KST = HS + 4;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;              // kRows x HS, scaled
  float* ks = qs + kRows * HS;   // kKeys x KST
  float* vs = ks + kKeys * KST;  // kKeys x HS

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int row0 = tile * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qh = q + ((size_t)b * H + h) * n_tok * HS;
  const T* kg = k + ((size_t)b * G + g) * n_tok * HS;
  const T* vg = v + ((size_t)b * G + g) * n_tok * HS;

  for (int i = tid; i < kRows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC, row = row0 + r;
    float x[VEC];
    if (row < n_tok) {
      load16(qh + (size_t)row * HS + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qs[r * HS + c + e] = x[e] * scale;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }
  const int wrow0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  // the causal frontier: no row of this block sees a key past its last row
  const int n_keys = causal ? min(n_tok, row0 + kRows) : n_tok;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kKeys * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * VEC, key = k0 + j;
      float kv[VEC], vv[VEC];
      if (key < n_keys) {
        load16(kg + (size_t)key * HS + c, kv);
        load16(vg + (size_t)key * HS + c, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * KST + c + e] = kv[e];
        vs[j * HS + c + e] = vv[e];
      }
    }
    __syncthreads();

    // scores: lane owns key k0 + lane, for each of the warp's rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HS; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(ks + lane * KST + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qd =
            *reinterpret_cast<const float4*>(qs + (warp * kRowsPerWarp + i) * HS + d);
        sc[i] += qd.x * kd.x + qd.y * kd.y + qd.z * kd.z + qd.w * kd.w;
      }
    }

    // online softmax: p (lane's key) per row, and the rescale of the rows'
    // state; rows without a valid key here keep m, l and acc unchanged
    const int key = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = wrow0 + i;
      const bool ok = key < n_keys && (!causal || key <= row);
      const float sv = ok ? sc[i] : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sv));
      p[i] = ok ? expf(sv - m_new) : 0.f;
      // m_new == -inf: no valid key so far; leave the row as it is
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
    }
    // PV: each V row is read from shared memory once for all 8 rows
    for (int j = 0; j < kKeys; ++j) {
      float vj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vj[c] = vs[j * HS + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += pj * vj[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = wrow0 + i;
    if (row >= n_tok) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    T* o = out + (((size_t)b * H + h) * n_tok + row) * HS;
#pragma unroll
    for (int c = 0; c < DPL; ++c) store_out(o + lane + 32 * c, acc[i][c] * inv);
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + h) * n_tok + row] = live ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <typename T, int HS>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int G, int n_tok, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = (size_t)(kRows * HS + kKeys * (HS + 4) + kKeys * HS) * sizeof(float);
  auto kern = flash_attention_kernel<T, HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tok + kRows - 1) / kRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, G, n_tok, scale,
      causal);
  return (int)cudaGetLastError();
}

// ---- bfloat16: tensor cores (wgmma), fed by TMA ----

constexpr int kWgConsumers = 2;                      // consumer warpgroups, 64 rows each
constexpr int kWgThreads = (kWgConsumers + 1) * 128;  // and one producer warpgroup
constexpr int kWgRows = kWgConsumers * 64;           // query rows per block
constexpr int kWgKeys = 128;                          // keys per K/V tile
constexpr int kWgStages = 2;                         // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// Tiles in the panel layout of tma.cuh: Q and K (A and B of Q K^T) are
// K-major, V (B of P V) is MN-major, read transposed.
template <int HS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wg_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                          int H, int G, int n_tok, float scale, int causal) {
  constexpr int Q_BYTES = kWgRows * HS * 2;
  constexpr int KV_BYTES = kWgKeys * HS * 2;
  constexpr int NT_O = HS / 8;
  constexpr int PC = Panel<HS>::kCols, RB = Panel<HS>::kRowBytes, LAY = Panel<HS>::kLayout;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ks = qs + Q_BYTES;
  unsigned char* vs = ks + kWgStages * KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kWgStages * KV_BYTES);
  uint64_t* empty = full + kWgStages;
  uint64_t* q_bar = empty + kWgStages;

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int row0 = tile * kWgRows;
  const int n_keys = causal ? min(n_tok, row0 + kWgRows) : n_tok;
  const int n_tiles = (n_keys + kWgKeys - 1) / kWgKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers * 128);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kWgConsumers) {  // the producer: one thread issues every copy
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
      for (int c = 0; c < HS / PC; ++c)
        tma_load(qs + c * kWgRows * RB, &mq, q_bar, PC * c, row0, b * H + h);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) mbar_wait(&empty[s], (t / kWgStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        for (int c = 0; c < HS / PC; ++c) {
          tma_load(ks + s * KV_BYTES + c * kWgKeys * RB, &mk, &full[s], PC * c, t * kWgKeys, b * G + g);
          tma_load(vs + s * KV_BYTES + c * kWgKeys * RB, &mv, &full[s], PC * c, t * kWgKeys, b * G + g);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wrow0 = row0 + wg * 64;                  // this warpgroup's first row
  const int wrow = wrow0 + warp * 16 + lane / 4;     // this thread's rows: wrow, wrow + 8
  float o[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kWgStages;
    const int k0 = t * kWgKeys;
    mbar_wait(&full[s], (t / kWgStages) & 1);
    if (!causal || k0 <= wrow0 + 63) {  // uniform over the warpgroup
      const unsigned char* kt = ks + s * KV_BYTES;
      const unsigned char* vt = vs + s * KV_BYTES;
      float sc[kWgKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        const int pan = kk / (PC / 16), in = (kk % (PC / 16)) * 32;
        wgmma_ss_n128(sc, wg_desc(qs + pan * kWgRows * RB + wg * 64 * RB + in, 16, 8 * RB, LAY),
                    wg_desc(kt + pan * kWgKeys * RB + in, 16, 8 * RB, LAY), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();

      const bool masked = k0 + kWgKeys > n_tok || (causal && k0 + kWgKeys - 1 > wrow0);
#pragma unroll
      for (int n = 0; n < kWgKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * scale;
          if (masked) {
            const int key = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
            const int row = wrow + (e >= 2 ? 8 : 0);
            if (key >= n_tok || (causal && key > row)) x = -INFINITY;
          }
          sc[4 * n + e] = x;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < kWgKeys / 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float base = mx == -INFINITY ? 0.f : mx * kLog2e;
        const float corr = exp2f(m[r] * kLog2e - base);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kWgKeys / 8; ++n) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[4 * n + e] = exp2f(sc[4 * n + e] * kLog2e - base);
            sum += sc[4 * n + e];
          }
        }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          o[4 * n + 2 * r] *= corr;
          o[4 * n + 2 * r + 1] *= corr;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                                pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                                pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                                pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
        wgmma_rs_tb<HS>(o, pa, wg_desc(vt + kk * 16 * RB, kWgKeys * RB, 8 * RB, LAY));
      }
      wgmma_commit();
      wgmma_wait0();
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = wrow + 8 * r;
    if (row >= n_tok) continue;
    const bool live = sum > 0.f;
    const float inv = live ? 1.f / sum : 0.f;
    __nv_bfloat16* orow = out + (((size_t)b * H + h) * n_tok + row) * HS + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)b * H + h) * n_tok + row] = live ? m[r] + logf(sum) : kNegInf;
  }
}

template <int HS>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
              int B, int H, int G, int n_tok, float scale, int causal,
              cudaStream_t stream) {
  if (n_tok == 0) return 0;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, HS, n_tok, B * H, kWgRows);
  if (rc == 0) rc = make_map(&mk, k, HS, n_tok, B * G, kWgKeys);
  if (rc == 0) rc = make_map(&mv, v, HS, n_tok, B * G, kWgKeys);
  if (rc != 0) return rc;
  const size_t smem = (size_t)(kWgRows + 2 * kWgStages * kWgKeys) * HS * 2 +
                      (2 * kWgStages + 1) * sizeof(uint64_t) + 1024;
  auto kern = flash_attention_wg_kernel<HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tok + kWgRows - 1) / kWgRows, H, B);
  kern<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out),
                                           lse, H, G, n_tok, scale, causal);
  return (int)cudaGetLastError();
}

int launch_hs(int dtype, int hs, const void* q, const void* k, const void* v,
              void* out, float* lse, int B, int H, int G, int n_tok, float scale,
              int causal, cudaStream_t stream) {
#define FLASH_HS(N)                                                              \
  case N:                                                                        \
    return dtype == 0                                                            \
               ? launch<float, N>(q, k, v, out, lse, B, H, G, n_tok, scale,      \
                                  causal, stream)                                \
               : launch_tc<N>(q, k, v, out, lse, B, H, G, n_tok, scale, causal,  \
                              stream);
  switch (hs) {
    FLASH_HS(32)
    FLASH_HS(64)
    FLASH_HS(128)
    default:
      return -1;
  }
#undef FLASH_HS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse may be null (no LSE output);
// causal: 0 or 1.  Returns 0, -1 for an unsupported (dtype, hs), or the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(
    int dtype, int hs, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int H, int G, int n_tok, float scale, int causal,
    void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  return launch_hs(dtype, hs, q, k, v, out, static_cast<float*>(lse), B, H, G,
                   n_tok, scale, causal, static_cast<cudaStream_t>(stream));
}
