// Ragged paged attention for Hopper (sm_90a), over fp, int8 and float8 pools.
//
// Replaces the Pallas kernel `_unified_kernel` in
// mdi_llm_tpu/ops/ragged_paged_attention.py (launched by
// `ragged_paged_attention`, reached from `paged_attention` and
// `paged_prefill` in mdi_llm_tpu/ops/paged_attention.py).  It computes the
// same function, not the same grid:
//
//   queries  q      (1, n_head, T, hs)  slot-major packed ragged batch
//   pools    k, v   (NB, BS, G, hs)     block-table-indexed KV blocks, stored
//                                       as q's type, int8, e4m3 or e5m2
//   scales   k, v   (NB, G) float32     int8 pools only: per (block, group)
//   tables          (S, MB) int32       slot s's key j lives in block
//                                       tables[s, j / BS] at offset j % BS
//   spans           q_start, q_len, lens (S,) int32
//   q_pos           (T,) int32          absolute position of every token
//
// Token t of slot s (q_start[s] <= t < q_start[s] + q_len[s]) attends key j
// of its slot iff j <= q_pos[t]; heads map to KV groups as h / (n_head/G);
// the softmax is online and in float32.  Rows no slot owns are left as the
// caller's zeros.
//
// Design.  The TPU kernel walks slots in order with one resident output and
// shared scratch.  Here every block owns (slot s, KV group g, a tile of 32
// query rows) and its own accumulators, so blocks run in any order:
//  - a block reads its slot's (q_start, q_len, lens) and its table row
//    itself, and walks only the KV blocks below min(lens, max q_pos + 1)
//    of its rows (no remap to the trash block as the TPU index map does);
//  - the rows are the group's q_per_kv heads x the span's tokens, stacked
//    token-major: what `q_pack` was for on the TPU;
//  - each 32-key KV tile is staged in shared memory with 16-byte loads,
//    converted to float32; in the score phase lane i owns key i, in the PV
//    phase lane i owns output dims i, i+32, ...;
//  - a narrow pool is dequantized in that staging step, inside the block
//    loop (the TPU kernel's `_unified_kernel` quantized branch): one 16-byte
//    load brings 16 int8 or float8 values; int8 values are multiplied in
//    float32 by the scale of (tables[s, key / BS], g), one scalar read per
//    16-byte load, and only for keys below the walk's end, so no scale past
//    `lens` is read; float8 values convert exactly to float32.  No
//    dequantized copy of the pool or of the gathered view is ever built;
//  - the key mask j <= q_pos[t] is per row, and a row that sees no valid key
//    in a tile leaves its state untouched (the finite NEG_INF of the TPU
//    kernel needed explicit row gating for the same reason).
//
// Bound on the H100: decode (one token per slot) reads every K and V row
// below lens once and does ~4 flops per byte read (~8 at one byte per
// element), far below the card's ~295 flops/byte balance point, so it is
// bound by the bytes of K and V under lens (plus the int8 scales).  This first version keeps those bytes to one read per
// (slot, group, row tile) and does its math on CUDA cores; it does not yet
// overlap the next tile's loads with the current tile's math or split long
// contexts over several blocks (split-KV), which is where it loses to the
// bound.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per KV tile, one per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
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
__device__ __forceinline__ void load16(const int8_t* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]);
}
template <typename F8>
__device__ __forceinline__ void load16_fp8(const F8* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_fp8_storage_t* b = reinterpret_cast<const __nv_fp8_storage_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    F8 x;
    x.__x = b[i];
    dst[i] = static_cast<float>(x);
  }
}
__device__ __forceinline__ void load16(const __nv_fp8_e4m3* src, float* dst) {
  load16_fp8(src, dst);
}
__device__ __forceinline__ void load16(const __nv_fp8_e5m2* src, float* dst) {
  load16_fp8(src, dst);
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

// T: q and out (float or bfloat16); KV: pool storage (T, int8_t,
// __nv_fp8_e4m3 or __nv_fp8_e5m2); k_scale/v_scale: (NB, G) float32 for an
// int8 pool, unused otherwise.
template <typename T, typename KV, int HS>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ q_start, const int* __restrict__ q_len,
    const int* __restrict__ lens, const int* __restrict__ q_pos,
    T* __restrict__ out, int n_tok, int n_head, int G, int BS, int MB,
    float scale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte load
  constexpr int VPR = HS / VEC;        // 16-byte loads per key row
  constexpr int DPL = HS / 32;         // output dims per lane
  constexpr int KST = HS + 1;          // padded K row: lane-per-key reads hit distinct banks

  extern __shared__ float smem[];
  float* qs = smem;              // kRows x HS
  float* ks = qs + kRows * HS;   // kKeys x KST
  float* vs = ks + kKeys * KST;  // kKeys x HS
  __shared__ int warp_pos[kWarps];

  const int s = blockIdx.z;
  const int g = blockIdx.y;
  const int len = q_len[s];
  const int qpk = n_head / G;
  const int n_rows = len * qpk;
  const int row0 = blockIdx.x * kRows;
  if (len <= 0 || row0 >= n_rows) return;  // uniform over the block
  const int start = q_start[s];
  const int* table = tables + (size_t)s * MB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // this block's query rows, scaled later in float32 like the reference
  for (int i = tid; i < kRows * HS; i += kThreads) {
    const int r = i / HS, d = i % HS, row = row0 + r;
    float x = 0.f;
    if (row < n_rows) {
      const int t = start + row / qpk, h = g * qpk + row % qpk;
      if (t < n_tok) x = to_float(q[((size_t)h * n_tok + t) * HS + d]);
    }
    qs[i] = x;
  }

  // per-row state; row r = warp + kWarps * i of this tile
  int pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int max_pos = -1;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + kWarps * i;
    const int t = start + row / qpk;
    pos[i] = (row < n_rows && t < n_tok) ? q_pos[t] : -1;
    max_pos = max(max_pos, pos[i]);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }
  if (lane == 0) warp_pos[warp] = max_pos;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) max_pos = max(max_pos, warp_pos[w]);
  // keys past every row's position are masked for all of them: stop there
  const int n_keys = min(min(lens[s], MB * BS), max_pos + 1);

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKeys * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * VEC, key = k0 + j;
      float kv[VEC], vv[VEC];
      if (key < n_keys) {
        const int blk = table[key / BS];
        const size_t base = (((size_t)blk * BS + key % BS) * G + g) * HS + c;
        load16(k_pool + base, kv);
        load16(v_pool + base, vv);
        if constexpr (kInt8) {  // int8 * scale in float32, as the reference
          const float sk = k_scale[(size_t)blk * G + g];
          const float sv = v_scale[(size_t)blk * G + g];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            kv[e] *= sk;
            vv[e] *= sv;
          }
        }
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
    for (int d = 0; d < HS; ++d) {
      const float kd = ks[lane * KST + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        sc[i] += qs[(warp + kWarps * i) * HS + d] * kd;
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool ok = key < n_keys && key <= pos[i];
      const float sv = ok ? sc[i] * scale : -INFINITY;
      const float mx = warp_max(sv);
      if (mx == -INFINITY) continue;  // no valid key for this row here
      const float m_new = fmaxf(m[i], mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);  // 0 on the first valid tile
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] += pj * vs[j * HS + lane + 32 * c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (pos[i] < 0 || l[i] <= 0.f) continue;
    const int row = row0 + warp + kWarps * i;
    const int t = start + row / qpk, h = g * qpk + row % qpk;
    const float inv = 1.f / l[i];
    T* o = out + ((size_t)h * n_tok + t) * HS;
#pragma unroll
    for (int c = 0; c < DPL; ++c) store_out(o + lane + 32 * c, acc[i][c] * inv);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *q_start, *q_len, *lens, *q_pos;
  void* out;
  int n_tok, n_head, G, BS, S, MB;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int HS>
int launch(const Args& a) {
  const size_t smem = (size_t)(kRows * HS + kKeys * (HS + 1) + kKeys * HS) * sizeof(float);
  auto kern = ragged_paged_attention_kernel<T, KV, HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qpk = a.n_head / a.G;
  const dim3 grid((qpk * a.n_tok + kRows - 1) / kRows, a.G, a.S);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.q_start, a.q_len, a.lens, a.q_pos, static_cast<T*>(a.out), a.n_tok,
      a.n_head, a.G, a.BS, a.MB, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch_hs(int hs, const Args& a) {
  switch (hs) {
    case 32: return launch<T, KV, 32>(a);
    case 64: return launch<T, KV, 64>(a);
    case 128: return launch<T, KV, 128>(a);
    default: return -1;
  }
}

// the pool's storage: its own q type, or one of the narrow types
template <typename T>
int launch_kv(int kv_dtype, int hs, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch_hs<T, T>(hs, a);
    case 2: return (a.k_scale && a.v_scale) ? launch_hs<T, int8_t>(hs, a) : -1;
    case 3: return launch_hs<T, __nv_fp8_e4m3>(hs, a);
    case 4: return launch_hs<T, __nv_fp8_e5m2>(hs, a);
    default: return -1;
  }
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (the pools): 0 =
// the same as q, 2 = int8 with k_scale/v_scale (NB, G) float32, 3 =
// float8_e4m3fn, 4 = float8_e5m2; the scale pointers are null for every
// pool but int8.  Returns 0, -1 for an unsupported (dtype, kv_dtype, hs),
// or the cudaError_t of the launch.
extern "C" int ragged_paged_attention_launch(
    int dtype, int kv_dtype, int hs, const void* q, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* q_start, const void* q_len,
    const void* lens, const void* q_pos, void* out, int n_tok, int n_head,
    int G, int BS, int S, int MB, float scale, void* stream) {
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(q_start),
               static_cast<const int*>(q_len), static_cast<const int*>(lens),
               static_cast<const int*>(q_pos), out, n_tok, n_head, G, BS, S, MB,
               scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_kv<float>(kv_dtype, hs, a);
  if (dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, hs, a);
  return -1;
}
