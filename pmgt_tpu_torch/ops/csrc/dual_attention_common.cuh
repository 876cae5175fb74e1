// Device helpers shared by the dual-attention kernels
// (dual_attention_fwd.cu, dual_attention_bwd.cu): the tile geometry, the
// 16-byte asynchronous copies that stage a tile of sequences in shared
// memory, the staged additive and keep masks, 16-byte row chunks in f32 or
// bf16, lane-group reductions, and the one-time launch attributes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pmgt {

constexpr int kWarp = 32;
constexpr int kThreads = 128;  // threads per block, both kernels

// Elements of T in one 16-byte chunk (4 f32, 8 bf16).
template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// Shared-memory pitch of a staged row, in elements: d plus 16 bytes, so
// rows r and r + 1 start in different 16-byte bank groups and lanes that
// read eight different rows at one feature index hit eight bank groups.
template <typename T>
__host__ __device__ constexpr int row_pitch(int d) {
  return d + vec_width<T>();
}

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The lane-group width for S keys: one lane per key, a power of two.
__host__ __device__ constexpr int group_width(int S) { return S <= 8 ? 8 : 32; }

// Sequences per tile: every key lane of a block busy where S allows, two
// stages in no more than `smem_target` bytes, and at least two tiles per
// SM where N allows (a short call spreads out). `seq_bytes` is one
// sequence's share of a stage.
inline int tile_size(int S, int G, int N, int sms, size_t seq_bytes,
                     size_t smem_target) {
  int tile = kThreads / (S * G);
  while (tile > 1 && 2 * tile * seq_bytes > smem_target) --tile;
  const int spread = (N + 2 * sms - 1) / (2 * sms);
  if (spread < tile) tile = spread;
  return tile < 1 ? 1 : tile;
}

// x / y for 0 <= x < 2^16 and 1 <= y < 2^16, given inv = 1.f / y: exact,
// since (x + 0.5) / y lies at least 0.5 / y from an integer and the two
// roundings err by less than 2^-7 / y. Two instructions where an integer
// division by a value known only at run time takes about twenty.
__device__ __forceinline__ int div_small(int x, float inv) {
  return __float2int_rd((static_cast<float>(x) + 0.5f) * inv);
}

// Rows of 16-byte chunks spread over the block: thread x takes chunk
// x % chunks of rows first, first + step, ... (threads past the last whole
// row of a pass take none). Row r is (sequence r / S, position r % S); the
// walk keeps both for the thread's current row, so no row divides.
struct RowSlots {
  int chunk, first, step;
  int s0, i0;          // sequence and position of row `first`
  int s_step, i_step;  // step / S, step % S
};

__device__ __forceinline__ RowSlots row_slots(int chunks, int S) {
  const int step = kThreads / chunks;
  const int slot = threadIdx.x / chunks;
  const int first = slot < step ? slot : 1 << 30;
  return {static_cast<int>(threadIdx.x % chunks), first, step,
          slot / S, slot % S, step / S, step % S};
}

// ---- 16-byte chunks: shared memory or global memory, f32 or bf16 -------

__device__ __forceinline__ void load_chunk(const float* p, float (&r)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x;
  r[1] = x.y;
  r[2] = x.z;
  r[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&r)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    r[2 * e] = f.x;
    r[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store_chunk(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float (&r)[8]) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    h[e] = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = x;
}

// The dot product of two staged rows of d elements, in f32: V partial sums
// (one per lane of a chunk) over unrolled chunks, so the loads of several
// chunks are in flight together and no FMA chain is longer than d / V.
template <typename T>
__device__ __forceinline__ float dot_rows(const T* a, const T* b, int d) {
  constexpr int V = vec_width<T>();
  float acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.f;
#pragma unroll 4
  for (int e = 0; e < d; e += V) {
    float x[V], y[V];
    load_chunk(a + e, x);
    load_chunk(b + e, y);
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] += x[u] * y[u];
  }
#pragma unroll
  for (int w = V / 2; w > 0; w >>= 1)
#pragma unroll
    for (int u = 0; u < w; ++u) acc[u] += acc[u + w];
  return acc[0];
}

// acc[b] += sum_t weight(b, t) * x_t for t = 0 .. S-1 in that order, x_t
// the staged chunk at src + t * pitch: the loads of two terms are issued
// before their FMAs, so a thread waits on shared memory once a pair.
template <typename T, int RB, int V, typename W>
__device__ __forceinline__ void accumulate_terms(float (&acc)[RB][V],
                                                 const T* src, int pitch,
                                                 int S, W weight) {
  int t = 0;
  for (; t + 2 <= S; t += 2) {
    float x0[V], x1[V], w0[RB], w1[RB];
    load_chunk(src + t * pitch, x0);
    load_chunk(src + (t + 1) * pitch, x1);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      w0[b] = weight(b, t);
      w1[b] = weight(b, t + 1);
    }
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[b][e] += w0[b] * x0[e];
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[b][e] += w1[b] * x1[e];
  }
  if (t < S) {
    float x[V];
    load_chunk(src + t * pitch, x);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const float w = weight(b, t);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[b][e] += w * x[e];
    }
  }
}

// ---- staging a tile -----------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are still
// in flight; a __syncthreads() must follow before any thread reads what
// another thread copied.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of rows 0..S-1 of the NT tensors `src` for the tile's
// sequences n0 .. n0 + tile - 1 (those below N), 16 bytes a thread: row
// s * S + i of tensor t lands at dst + t * plane + (s * S + i) * pitch. A
// row's chunks go to consecutive threads, so each row is one contiguous
// read; the tensors share their strides, so a row's offset is formed once.
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* const (&src)[NT],
                                           int plane, const RowSlots& rs,
                                           int S, int d, int tile, int n0,
                                           int N, long long pos_stride,
                                           long long seq_stride) {
  constexpr int V = vec_width<T>();
  const int pitch = row_pitch<T>(d);
  int s = rs.s0, i = rs.i0;
  for (int r = rs.first; r < tile * S; r += rs.step) {
    if (n0 + s < N) {
      const long long off = i * pos_stride +
                            static_cast<long long>(n0 + s) * seq_stride +
                            rs.chunk * V;
      T* row = dst + r * pitch + rs.chunk * V;
#pragma unroll
      for (int t = 0; t < NT; ++t) cp_async16(row + t * plane, src[t] + off);
    }
    s += rs.s_step;
    i += rs.i_step;
    if (i >= S) {
      i -= S;
      ++s;
    }
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Issues the copies of the tile's additive mask (s_madd[s * S + j]) and,
// with keep masks, of one 4-byte word per keep-mask element (s_m1, s_m2 at
// (s * S + i) * S + j): the f32 value itself, or for a u8 mask the aligned
// word holding the byte (`keep_factor` picks the byte out). A word never
// leaves the 4-byte-aligned granule of a valid byte, so it stays inside the
// allocation.
__device__ __forceinline__ void stage_masks(
    float* s_madd, uint32_t* s_m1, uint32_t* s_m2, const float* mask,
    const void* m1, const void* m2, int mask_kind, int S, float inv_s,
    int tile, int n0, int N, long long mpos_stride, long long mseq_stride) {
  for (int x = threadIdx.x; x < tile * S; x += kThreads)
    if (n0 + div_small(x, inv_s) < N)
      cp_async4(s_madd + x, mask + static_cast<size_t>(n0) * S + x);
  if (mask_kind == 0) return;
  const int width = mask_kind == 1 ? 1 : 4;
  for (int x = threadIdx.x; x < tile * S * S; x += kThreads) {
    const int r = div_small(x, inv_s);  // s * S + i
    const int s = div_small(r, inv_s);
    const int n = n0 + s;
    if (n >= N) continue;
    const size_t off = (static_cast<size_t>(r - s * S) * mpos_stride +
                        static_cast<size_t>(n) * mseq_stride + (x - r * S)) *
                       width;
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(m1) + off;
    const uintptr_t a2 = reinterpret_cast<uintptr_t>(m2) + off;
    cp_async4(s_m1 + x, reinterpret_cast<const void*>(a1 & ~uintptr_t(3)));
    cp_async4(s_m2 + x, reinterpret_cast<const void*>(a2 & ~uintptr_t(3)));
  }
}

// The keep factor m * (1 / keep) of (position i, sequence n, key j) from
// its staged word; 1 without keep masks.
__device__ __forceinline__ float keep_factor(uint32_t word, const void* m,
                                             int kind, float inv_keep, int i,
                                             int n, int j,
                                             long long mpos_stride,
                                             long long mseq_stride) {
  if (kind == 0) return 1.f;
  if (kind == 2) return __uint_as_float(word) * inv_keep;
  const uintptr_t a = reinterpret_cast<uintptr_t>(m) +
                      static_cast<size_t>(i) * mpos_stride +
                      static_cast<size_t>(n) * mseq_stride + j;
  return static_cast<float>((word >> (8 * (a & 3))) & 0xffu) * inv_keep;
}

// ---- lane groups: G lanes (a power of two dividing 32), one per key ----
// The whole warp calls these together (the loops over score rows are
// uniform over a warp), so the shuffles take the full mask and need no
// convergence check.

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o, G);
  return x;
}

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, G));
  return x;
}

// ---- launch -------------------------------------------------------------

// Opts `kernel` into the device's full dynamic shared memory and the
// largest shared-memory carveout, once per device (the attributes belong
// to the function, so launches captured into a CUDA graph need nothing).
// Returns the opt-in limit in bytes through `optin`.
template <typename K>
cudaError_t configure_once(K kernel, unsigned long long& done, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  done |= bit;
  return cudaSuccess;
}

// Blocks of `kernel` resident on one SM with `smem` dynamic bytes.
template <typename K>
cudaError_t blocks_per_sm(K kernel, size_t smem, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads,
                                                       smem);
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace pmgt
