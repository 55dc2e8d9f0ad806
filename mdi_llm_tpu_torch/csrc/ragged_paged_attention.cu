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
// the softmax is online and in float32.  Rows no slot owns come out 0.
//
// Design.  The TPU kernel walks slots in order with one resident output and
// shared scratch.  Here blocks run in any order, each with its own
// accumulators.
//
// Bound on the H100.  Decode (one token per slot) reads every K and V row
// below lens once and does ~4 flops per byte (~8 at one byte per element),
// far below the card's ~295 flops/byte balance point: the kernel is bound
// by the bytes of K and V under lens (plus the int8 scales), and what
// decides its time is how many of those bytes are in flight at once, not
// its math, which stays on CUDA cores in float32.  So:
//
//  - Split-KV.  Every block owns (slot s, KV group g, a tile of 16 query
//    rows, one chunk of `chunk` keys); the wrapper derives `chunk` and the
//    number of chunks from static shapes only (the table's width MB * BS,
//    and T <= S for a pure decode step, which takes smaller chunks), never
//    from lens or q_pos, so no device value is read on the host.  A
//    deep slot is walked by many blocks at once instead of one block tile
//    by tile; a block whose chunk starts past its rows' walk end exits.
//    The walk end is min(lens, MB * BS, the tile's largest q_pos + 1): no
//    scale or table entry past lens is read.
//  - Partials and merge.  A row whose own walk (min(lens, MB * BS,
//    q_pos + 1)) fits in the first chunk is written directly.  Otherwise
//    each chunk the row's walk reaches writes (m, l, unnormalised acc) in
//    float32 to a workspace, and the merge kernel combines them in chunk
//    order (deterministic) by their log-sum-exp, one chunk per lane (at most
//    32 chunks); every chunk it reads holds
//    at least one valid key for the row (its first key), and a partial
//    with m = -inf would carry weight 0 regardless.
//  - An asynchronous tile ring.  Within its chunk a block walks 32-key
//    tiles through 4 shared-memory stages filled by 16-byte cp.async copies
//    (and 4-byte ones for an int8 pool's per-key scales), so three tiles'
//    bytes are in flight while this tile's math runs (a chunk of up to
//    128 keys is requested at once).  K rows are padded
//    by 16 bytes so the lane-per-key 16-byte reads hit distinct banks.
//    Tiles land in the pool's own type; a narrow pool is widened when read
//    from shared memory: int8 values times the scale of (tables[s, key /
//    BS], g) in float32, the reference's `int8 * scale`; float8 values
//    convert exactly.  No dequantized copy of the pool is ever built.
//  - Rows.  A tile's rows are the group's q_per_kv heads x the span's
//    tokens, stacked token-major (what `q_pack` was for on the TPU); warp w
//    owns rows w, w + 4, w + 8, w + 12 and skips the ones the span does not
//    have (decode: 8 rows, 2 per warp), so no warp loops over empty rows.
//    In the score phase lane i owns key i, in the PV phase lane i owns
//    output dims i, i + 32, ...; the per-row mask is j <= q_pos[t], and a
//    row with no valid key in a tile leaves its state untouched (the TPU
//    kernel's finite NEG_INF needed explicit row gating for the same
//    reason).
//  - Every output row is written once: by the attention kernel when its
//    walk fits the first chunk, else by the merge kernel, which also writes
//    0 to rows no slot owns and rows that see no key.  With one chunk only
//    (a table no wider than one chunk) there is no merge, and the rows the
//    attention kernel does not write keep the caller's zeros.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per KV tile, one per lane
constexpr int kStages = 4;                    // KV tiles in the shared-memory ring
constexpr int kMaxChunks = 32;                // the merge holds one chunk per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of KV at `src` (16-byte aligned, shared memory) -> float dst[16 / sizeof(KV)]
template <typename KV>
__device__ __forceinline__ void load16(const KV* src, float* dst) {
  constexpr int VEC = 16 / sizeof(KV);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const KV* e = reinterpret_cast<const KV*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_float(e[i]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// the keys a row at position `pos` of slot s sees: [0, row_end)
__device__ __forceinline__ int row_end(int pos, int len, int W) {
  return pos < 0 ? 0 : min(min(len, W), pos + 1);
}

// T: q and out (float or bfloat16); KV: pool storage (T, int8_t,
// __nv_fp8_e4m3 or __nv_fp8_e5m2); k_scale/v_scale: (NB, G) float32 for an
// int8 pool, unused otherwise.  ws_acc (n_chunks, n_head, n_tok, HS) and
// ws_ml (n_chunks, n_head, n_tok, 2): the partials, used when n_chunks > 1.
template <typename T, typename KV, int HS>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ q_start, const int* __restrict__ q_len,
    const int* __restrict__ lens, const int* __restrict__ q_pos,
    T* __restrict__ out, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int n_tok, int n_head, int G, int BS, int MB, int chunk, int n_chunks,
    float scale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KV);    // elements per 16-byte piece
  constexpr int RB = HS * sizeof(KV);     // bytes per key row
  constexpr int CPR = RB / 16;            // 16-byte pieces per key row
  constexpr int KLD = RB + 16;            // shared K row, padded
  constexpr int STAGE = kKeys * (KLD + RB);  // bytes of one K + V tile
  constexpr int DPL = HS / 32;            // output dims per lane

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kRows x HS
  unsigned char* ring = reinterpret_cast<unsigned char*>(qs + kRows * HS);
  float* scales = reinterpret_cast<float*>(ring + kStages * STAGE);  // stages x 2 x kKeys
  __shared__ int warp_pos[kWarps];

  const int s = blockIdx.z;
  const int g = blockIdx.y;
  const int c = blockIdx.x % n_chunks;
  const int len = q_len[s];
  const int start = q_start[s];
  const int len_kv = lens[s];
  const int qpk = n_head / G;
  const int n_rows = len * qpk;
  const int row0 = (blockIdx.x / n_chunks) * kRows;
  if (len <= 0 || row0 >= n_rows) return;  // uniform over the block
  const int n_real = min(kRows, n_rows - row0);
  const int* table = tables + (size_t)s * MB;
  const int W = MB * BS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_mine = max(0, (n_real - warp + kWarps - 1) / kWarps);  // this warp's rows

  // this block's query rows, scaled later in float32 like the reference
  for (int i = tid; i < n_real * HS; i += kThreads) {
    const int r = i / HS, d = i % HS, row = row0 + r;
    const int t = start + row / qpk, h = g * qpk + row % qpk;
    qs[i] = t < n_tok ? to_float(q[((size_t)h * n_tok + t) * HS + d]) : 0.f;
  }
  int pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int max_pos = -1;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + kWarps * i;
    const int t = start + row / qpk;
    pos[i] = (i < n_mine && t < n_tok) ? q_pos[t] : -1;
    max_pos = max(max_pos, pos[i]);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }
  if (lane == 0) warp_pos[warp] = max_pos;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) max_pos = max(max_pos, warp_pos[w]);
  // keys past every row's position are masked for all of them: stop there
  const int end = min(min(len_kv, W), max_pos + 1);
  const int lo = c * chunk;
  if (lo >= end) return;  // uniform: this chunk lies past the walk
  const int hi = min(end, lo + chunk);
  const int n_tiles = (hi - lo + kKeys - 1) / kKeys;

  auto load_tile = [&](int t) {
    unsigned char* kd = ring + (t % kStages) * STAGE;
    unsigned char* vd = kd + kKeys * KLD;
    const int k0 = lo + t * kKeys;
    for (int i = tid; i < kKeys * CPR; i += kThreads) {
      const int j = i / CPR, p = i % CPR, key = k0 + j;
      const bool ok = key < hi;
      const size_t off = ok
          ? (((size_t)table[key / BS] * BS + key % BS) * G + g) * RB + p * 16 : 0;
      cp_async16(kd + j * KLD + p * 16, reinterpret_cast<const char*>(k_pool) + off, ok);
      cp_async16(vd + j * RB + p * 16, reinterpret_cast<const char*>(v_pool) + off, ok);
    }
    if constexpr (kInt8) {
      if (tid < 2 * kKeys) {
        const int j = tid % kKeys, key = k0 + j;
        const bool ok = key < hi;
        const size_t at = ok ? (size_t)table[key / BS] * G + g : 0;
        const float* src = tid < kKeys ? k_scale : v_scale;
        cp_async4(scales + (t % kStages) * 2 * kKeys + tid, src + at, ok);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t landed, for this thread
    __syncthreads();               // ... for every thread; tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const unsigned char* kt = ring + (t % kStages) * STAGE;
    const KV* vt = reinterpret_cast<const KV*>(kt + kKeys * KLD);
    const float* st = scales + (t % kStages) * 2 * kKeys;
    const int k0 = lo + t * kKeys;
    const int nk = min(kKeys, hi - k0);  // keys in this tile
    const int key = k0 + lane;

    // scores: lane owns key k0 + lane, for each of the warp's rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
    const KV* krow = reinterpret_cast<const KV*>(kt + lane * KLD);
    const float sk = kInt8 ? st[lane] : 1.f;
#pragma unroll 2
    for (int d = 0; d < HS; d += VEC) {
      float kf[VEC];
      load16(krow + d, kf);
      if constexpr (kInt8) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] *= sk;  // int8 * scale in float32
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (i < n_mine) {
          const float* qr = qs + (warp + kWarps * i) * HS + d;
#pragma unroll
          for (int e = 0; e < VEC; ++e) sc[i] += qr[e] * kf[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i >= n_mine) break;
      const bool ok = lane < nk && key <= pos[i];
      const float sv = ok ? sc[i] * scale : -INFINITY;
      const float mx = warp_max(sv);
      if (mx == -INFINITY) continue;  // no valid key for this row here
      const float m_new = fmaxf(m[i], mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);  // 0 on the first valid tile
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float sv_j = kInt8 ? st[kKeys + j] : 1.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          acc[i][d] += pj * (to_float(vt[j * HS + lane + 32 * d]) * sv_j);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (i >= n_mine) break;
    const int nc = (row_end(pos[i], len_kv, W) + chunk - 1) / chunk;
    if (c >= nc) continue;  // the row's walk ends before this chunk
    const int row = row0 + warp + kWarps * i;
    const int t = start + row / qpk, h = g * qpk + row % qpk;
    if (nc == 1) {  // the whole walk is this chunk: the final output
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      T* o = out + ((size_t)h * n_tok + t) * HS;
#pragma unroll
      for (int d = 0; d < DPL; ++d) store_out(o + lane + 32 * d, acc[i][d] * inv);
    } else {
      const size_t at = ((size_t)c * n_head + h) * n_tok + t;
#pragma unroll
      for (int d = 0; d < DPL; ++d) ws_acc[at * HS + lane + 32 * d] = acc[i][d];
      if (lane == 0) {
        ws_ml[2 * at] = m[i];
        ws_ml[2 * at + 1] = l[i];
      }
    }
  }
}

// One warp per (head, token), so every row of `out` is written exactly once
// between the two kernels: a row whose walk spans several chunks gets
// sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c (lane c holds chunk c's m
// and l; the sums run in a fixed order), a row no slot owns or that sees no
// key gets 0, a row the attention kernel wrote directly is left alone.
template <typename T, int HS>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
             const int* __restrict__ q_start, const int* __restrict__ q_len,
             const int* __restrict__ lens, const int* __restrict__ q_pos,
             T* __restrict__ out, int n_tok, int n_head, int S, int W, int chunk) {
  constexpr int DPL = HS / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= n_tok * n_head) return;
  const int h = r / n_tok, t = r % n_tok;
  const int pos = q_pos[t];
  int s = -1;  // the slot that owns token t
  for (int i = lane; i < S; i += 32)
    if (q_len[i] > 0 && q_start[i] <= t && t < q_start[i] + q_len[i]) s = i;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = max(s, __shfl_xor_sync(0xffffffffu, s, o));
  const int nc = s < 0 ? 0 : (row_end(pos, lens[s], W) + chunk - 1) / chunk;
  if (nc == 1) return;  // written by the attention kernel itself
  T* o = out + ((size_t)h * n_tok + t) * HS;
  float mc = -INFINITY, lc = 0.f;
  if (lane < nc) {
    const size_t at = ((size_t)lane * n_head + h) * n_tok + t;
    mc = ws_ml[2 * at];
    lc = ws_ml[2 * at + 1];
  }
  const float mx = warp_max(mc);
  const float w = mc == -INFINITY ? 0.f : expf(mc - mx);  // a chunk without a valid key: 0
  const float den = warp_sum(w * lc);
  float num[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) num[d] = 0.f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float wc = __shfl_sync(0xffffffffu, w, c);
    const float* a = ws_acc + (((size_t)c * n_head + h) * n_tok + t) * HS + lane;
#pragma unroll
    for (int d = 0; d < DPL; ++d) num[d] += wc * a[32 * d];
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
  for (int d = 0; d < DPL; ++d) store_out(o + lane + 32 * d, num[d] * inv);
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *q_start, *q_len, *lens, *q_pos;
  void* out;
  int n_tok, n_head, G, BS, S, MB;
  float scale;
  float* ws;
  int chunk, n_chunks;
  cudaStream_t stream;
};

// dynamic shared memory of one block: the tile's queries in float32, the
// ring of kStages K + V tiles (K rows padded by 16 bytes), the int8 scales
template <typename KV, int HS>
constexpr size_t smem_bytes() {
  return (size_t)kRows * HS * sizeof(float) +
         (size_t)kStages * kKeys * (2 * HS * sizeof(KV) + 16) +
         (size_t)kStages * 2 * kKeys * sizeof(float);
}

template <typename T, typename KV, int HS>
int launch(const Args& a) {
  const size_t smem = smem_bytes<KV, HS>();
  auto kern = ragged_paged_attention_kernel<T, KV, HS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qpk = a.n_head / a.G;
  const int row_tiles = (qpk * a.n_tok + kRows - 1) / kRows;
  const dim3 grid(row_tiles * a.n_chunks, a.G, a.S);
  float* ws_ml = a.ws == nullptr ? nullptr
      : a.ws + (size_t)a.n_chunks * a.n_head * a.n_tok * HS;
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.q_start, a.q_len, a.lens, a.q_pos, static_cast<T*>(a.out), a.ws, ws_ml,
      a.n_tok, a.n_head, a.G, a.BS, a.MB, a.chunk, a.n_chunks, a.scale);
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

template <typename T, int HS>
int launch_merge(const float* ws, const int* q_start, const int* q_len,
                 const int* lens, const int* q_pos, void* out, int n_tok,
                 int n_head, int S, int W, int chunk, int n_chunks,
                 cudaStream_t stream) {
  const int rows = n_tok * n_head;
  merge_kernel<T, HS><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      ws, ws + (size_t)n_chunks * rows * HS, q_start, q_len, lens, q_pos,
      static_cast<T*>(out), n_tok, n_head, S, W, chunk);
  return (int)cudaGetLastError();
}

template <typename KV>
long long smem_hs(int hs) {
  switch (hs) {
    case 32: return (long long)smem_bytes<KV, 32>();
    case 64: return (long long)smem_bytes<KV, 64>();
    case 128: return (long long)smem_bytes<KV, 128>();
    default: return -1;
  }
}

template <typename T>
long long smem_kv(int kv_dtype, int hs) {
  switch (kv_dtype) {
    case 0: return smem_hs<T>(hs);
    case 2: return smem_hs<int8_t>(hs);
    case 3: return smem_hs<__nv_fp8_e4m3>(hs);
    case 4: return smem_hs<__nv_fp8_e5m2>(hs);
    default: return -1;
  }
}

}  // namespace

// The dynamic shared memory (bytes) that ragged_paged_attention_launch
// requests per block for these codes (as below), or -1 for an unsupported
// combination.
extern "C" long long ragged_paged_attention_smem_bytes(int dtype, int kv_dtype, int hs) {
  if (dtype == 0) return smem_kv<float>(kv_dtype, hs);
  if (dtype == 1) return smem_kv<__nv_bfloat16>(kv_dtype, hs);
  return -1;
}

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (the pools): 0 =
// the same as q, 2 = int8 with k_scale/v_scale (NB, G) float32, 3 =
// float8_e4m3fn, 4 = float8_e5m2; the scale pointers are null for every
// pool but int8.  ws: float32 workspace of n_chunks * n_head * n_tok *
// (hs + 2) values, null when n_chunks == 1; the wrapper's split plan gives
// chunk and n_chunks (from static shapes).  Returns 0, -1 for an
// unsupported (dtype, kv_dtype, hs) or plan, or the cudaError_t of the
// launch.
extern "C" int ragged_paged_attention_launch(
    int dtype, int kv_dtype, int hs, const void* q, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* tables, const void* q_start, const void* q_len,
    const void* lens, const void* q_pos, void* out, int n_tok, int n_head,
    int G, int BS, int S, int MB, float scale, void* ws, int chunk,
    int n_chunks, void* stream) {
  if (chunk <= 0 || n_chunks <= 0 || n_chunks > kMaxChunks ||
      (long long)chunk * n_chunks < (long long)MB * BS || (n_chunks > 1 && ws == nullptr))
    return -1;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(q_start),
               static_cast<const int*>(q_len), static_cast<const int*>(lens),
               static_cast<const int*>(q_pos), out, n_tok, n_head, G, BS, S, MB,
               scale, static_cast<float*>(ws), chunk, n_chunks,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_kv<float>(kv_dtype, hs, a);
  if (dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, hs, a);
  return -1;
}

// The merge of the partials that ragged_paged_attention_launch wrote into
// `ws` (same plan, same spans): run after it, on the same stream, when
// n_chunks > 1.
extern "C" int ragged_paged_attention_merge_launch(
    int dtype, int hs, const void* ws, const void* q_start, const void* q_len,
    const void* lens, const void* q_pos, void* out, int n_tok, int n_head,
    int S, int W, int chunk, int n_chunks, void* stream) {
  if (n_chunks < 2 || n_chunks > kMaxChunks) return -1;
  const float* w = static_cast<const float*>(ws);
  const int *qs = static_cast<const int*>(q_start), *ql = static_cast<const int*>(q_len);
  const int *ln = static_cast<const int*>(lens), *qp = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MERGE(T, N)                                                            \
  if (hs == N)                                                                 \
    return launch_merge<T, N>(w, qs, ql, ln, qp, out, n_tok, n_head, S, W,     \
                              chunk, n_chunks, st);
  if (dtype == 0) { MERGE(float, 32) MERGE(float, 64) MERGE(float, 128) }
  if (dtype == 1) {
    MERGE(__nv_bfloat16, 32) MERGE(__nv_bfloat16, 64) MERGE(__nv_bfloat16, 128)
  }
#undef MERGE
  return -1;
}
