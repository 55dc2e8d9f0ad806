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
//   K3: dq   (B, H, T, hs) in q's dtype = scale * dS k
//   K4: dk_h (B, H, T, hs) f32         = scale * dS^T q   (per QUERY head)
//       dv_h (B, H, T, hs) f32         = P^T dO           (per QUERY head)
//
// K4's per-head outputs are summed over each GQA group by the caller, as
// the TPU code does outside its kernel.  All arithmetic is float32.
//
// Design.  The TPU kernels hold a head's whole K/V (K3) or Q/dO/LSE/D (K4)
// in VMEM and loop over tiles of it in one program.  Here the streamed
// operand goes through shared memory tile by tile, and the TPU's
// sequential grid becomes a loop inside each block:
//  - K3: one thread block per (query tile of 32 rows, head, batch row).
//    The tile's q and dO rows sit in shared memory in float32; 32-key K/V
//    tiles stream through it up to the causal frontier (the key tile that
//    holds the tile's last row).  In the score phase lane i owns key i and
//    computes s and dO.v for its warp's 8 rows; in the product phase lane i
//    owns output dims i, i + 32, ... and accumulates dS k for the 8 rows in
//    registers, dS broadcast by warp shuffles.  Causal grids start with the
//    last query tiles, which walk the most keys.
//  - K4: one thread block per (key tile of 32 keys, query head, batch
//    row).  The tile's k and v rows sit in shared memory; 32-row Q/dO
//    tiles (with their LSE and D) stream through it from the first query
//    tile that sees the key tile (the tile itself when causal) to T.  In
//    the score phase lane i owns query row i and computes s and dO.v for
//    its warp's 8 keys; in the product phase lane i owns dims i, i + 32,
//    ... and accumulates P^T dO and dS^T q for the 8 keys.
//  - The ragged last tile is masked, never padded: rows and keys past T
//    are staged as zeros, get P = 0 and are never written.
//
// Bound on the H100: like the forward, the work grows as T^2 while the
// bytes grow as T, so at training lengths both kernels are bound by
// operations (per valid (query, key) pair and head, about 6 * hs flops for
// K3 and 8 * hs for K4).  This first version does that math on CUDA cores
// in float32, with no atomics (each output element has one owner, so the
// results are deterministic); tensor cores (mma/wgmma), TMA, overlapping
// the next tile's loads with the current tile's math, and summing the GQA
// group inside K4 are later work.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 8;               // rows (K3) or keys (K4) per warp
constexpr int kTile = kWarps * kPerWarp;  // rows/keys per tile, one per lane
constexpr float kExpClamp = 80.f;         // the TPU kernels' exp argument cap

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T at `src` (16-byte aligned) -> float dst[16 / sizeof(T)]
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// rows [r0, r0 + kTile) of a row-major (n_tok, HS) matrix -> float32 shared
// memory with row stride ST; rows at or past n_tok are zeros
template <typename T, int HS, int ST>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int r0,
                                           int n_tok, float* dst, int tid) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HS / VEC;        // 16-byte loads per row
  for (int i = tid; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC, row = r0 + r;
    float x[VEC];
    if (row < n_tok) {
      load16(src + (size_t)row * HS + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ST + c + e] = x[e];
  }
}

template <typename T, int HS>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                T* __restrict__ dq, int H, int G, int n_tok, float scale,
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
  const T* kg = k + ((size_t)b * G + g) * n_tok * HS;
  const T* vg = v + ((size_t)b * G + g) * n_tok * HS;

  stage_tile<T, HS, HS>(q + hrow * HS, row0, n_tok, qs, tid);
  stage_tile<T, HS, HS>(dout + hrow * HS, row0, n_tok, dos, tid);

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
    stage_tile<T, HS, KST>(kg, k0, n_keys, ks, tid);
    stage_tile<T, HS, KST>(vg, k0, n_keys, vs, tid);
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
    T* o = dq + (hrow + row) * HS;
#pragma unroll
    for (int c = 0; c < DPL; ++c) store_out(o + lane + 32 * c, acc[i][c] * scale);
  }
}

template <typename T, int HS>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
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
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t hrow = ((size_t)b * H + h) * n_tok;  // this head's row 0
  const T* qh = q + hrow * HS;
  const T* doh = dout + hrow * HS;

  stage_tile<T, HS, HS>(k + ((size_t)b * G + g) * n_tok * HS, key0, n_tok, ks, tid);
  stage_tile<T, HS, HS>(v + ((size_t)b * G + g) * n_tok * HS, key0, n_tok, vs, tid);

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

  for (int r0 = first_row; r0 < n_tok; r0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and ks/vs are written)
    stage_tile<T, HS, QST>(qh, r0, n_tok, qs, tid);
    stage_tile<T, HS, QST>(doh, r0, n_tok, dos, tid);
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
    // dV += P^T dO and dK += dS^T q over the tile's rows: each Q/dO row is
    // read from shared memory once for all 8 keys
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

#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int key = wkey0 + j;
    if (key >= n_tok) continue;
    const size_t o = (hrow + key) * HS;
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

template <typename T, int HS>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int B, int H,
              int G, int n_tok, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_dq_kernel<T, HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<HS>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tok + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem_bytes<HS>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), H, G, n_tok, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HS>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, float* dk, float* dv,
               int B, int H, int G, int n_tok, float scale, int causal,
               cudaStream_t stream) {
  auto kern = flash_dkv_kernel<T, HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<HS>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tok + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem_bytes<HS>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum, dk,
      dv, H, G, n_tok, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_hs(int hs, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* dsum, void* dq, int B, int H, int G,
          int n_tok, float scale, int causal, cudaStream_t st) {
  switch (hs) {
    case 32:
      return launch_dq<T, 32>(q, k, v, dout, lse, dsum, dq, B, H, G, n_tok, scale, causal, st);
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, dsum, dq, B, H, G, n_tok, scale, causal, st);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, dsum, dq, B, H, G, n_tok, scale, causal, st);
    default:
      return -1;
  }
}

template <typename T>
int dkv_hs(int hs, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* dsum, float* dk, float* dv, int B,
           int H, int G, int n_tok, float scale, int causal, cudaStream_t st) {
  switch (hs) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, dsum, dk, dv, B, H, G, n_tok, scale, causal, st);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, dsum, dk, dv, B, H, G, n_tok, scale, causal, st);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, dsum, dk, dv, B, H, G, n_tok, scale, causal, st);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout alike); lse and dsum
// float32; causal: 0 or 1.  Each returns 0, -1 for an unsupported
// (dtype, hs), or the cudaError_t of the launch.

extern "C" int flash_attention_dq_launch(
    int dtype, int hs, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dsum, void* dq, int B, int H,
    int G, int n_tok, float scale, int causal, void* stream) {
  if (B == 0 || n_tok == 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dq_hs<float>(hs, q, k, v, dout, l, d, dq, B, H, G, n_tok, scale, causal, st);
  if (dtype == 1)
    return dq_hs<__nv_bfloat16>(hs, q, k, v, dout, l, d, dq, B, H, G, n_tok, scale,
                                causal, st);
  return -1;
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
  if (dtype == 0)
    return dkv_hs<float>(hs, q, k, v, dout, l, d, k_out, v_out, B, H, G, n_tok, scale,
                         causal, st);
  if (dtype == 1)
    return dkv_hs<__nv_bfloat16>(hs, q, k, v, dout, l, d, k_out, v_out, B, H, G, n_tok,
                                 scale, causal, st);
  return -1;
}
