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
// reads KV group h / (H / G).  q is scaled by `scale` in float32 before the
// QK product and P stays float32 through the PV product, as in the TPU
// kernel.
//
// Design.  The TPU kernel holds the whole K/V of a head in VMEM and loops
// over key blocks in one program per (b, h, query tile).  Shared memory is
// far smaller here, so K/V tiles stream from device memory instead:
//  - one thread block per (query tile of 32 rows, head, batch row); causal
//    grids start with the tiles nearest the end of the chunk, which have
//    the most keys to walk, so the long blocks are scheduled first;
//  - the tile's 32 rows are held in shared memory in float32, pre-scaled;
//    each 32-key K/V tile is staged in shared memory with 16-byte loads and
//    converted to float32; a causal block stops at the key tile holding its
//    last row (the causal frontier), a non-causal one walks all T keys;
//  - in the score phase lane i owns key i, in the PV phase lane i owns
//    output dims i, i + 32, ...; every warp owns 8 rows, and keeps their
//    running max m, sum l and accumulator in float32 registers (online
//    softmax); a row with no valid key in a tile leaves its state as it was.
//
// Bound on the H100: over one chunk of T keys each K/V byte is read by
// every query tile of its group's heads, and the work grows as T^2, so at
// prefill lengths (T >= 1024) the kernel is bound by operations, not bytes
// (causal: 4 * B * H * hs * T(T+1)/2 flops).  This first version does that
// math on CUDA cores in float32: tensor cores (mma/wgmma), TMA and
// overlapping the next tile's loads with the current tile's math are where
// it loses to the bound, and are later work.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per K/V tile, one per lane
constexpr float kNegInf = -1e30f;             // the TPU kernel's finite NEG_INF

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

template <typename T>
int launch_hs(int hs, const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int G, int n_tok, float scale,
              int causal, cudaStream_t stream) {
  switch (hs) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, H, G, n_tok, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, G, n_tok, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, G, n_tok, scale, causal, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse may be null (no LSE output);
// causal: 0 or 1.  Returns 0, -1 for an unsupported (dtype, hs), or the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(
    int dtype, int hs, const void* q, const void* k, const void* v, void* out,
    void* lse, int B, int H, int G, int n_tok, float scale, int causal,
    void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hs<float>(hs, q, k, v, out, l, B, H, G, n_tok, scale, causal, st);
  if (dtype == 1)
    return launch_hs<__nv_bfloat16>(hs, q, k, v, out, l, B, H, G, n_tok, scale,
                                    causal, st);
  return -1;
}
