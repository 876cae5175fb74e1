// PMGT dual-attention forward for Hopper (sm_90a), in either layout.
//
// Replaces the TPU kernels `_pallas_forward_sm` (body `_kernel_sm`, the
// seq-major K1) and `_pallas_forward` (body `_kernel`, the batch-major K3)
// of pmgt_tpu/ops/dual_attention.py; both run the math `_fwd_math`. For
// every sequence n:
//
//   cos  = c c^T / max(|c_i| |c_j|, 1e-12)
//   P1   = softmax(1 - cos + I + M)          (M: additive key mask)
//   P2   = softmax(q k^T / sqrt(d) + M)
//   out  = (beta * P1 * m1/keep + (1 - beta) * P2 * m2/keep) v
//
// Layout: element (position i, sequence n, feature e) of q, k, v, c and
// out sits at i * pos_stride + n * seq_stride + e, so the seq-major
// [S, N, d] layout passes (N * d, d) and the batch-major [N, S, d] layout
// (d, S * d). The additive key mask is [N, S] f32 in both (the JAX
// package's batch-major [N, 1, S] has the same bytes); the optional keep
// masks m1, m2 (u8 or f32) follow the same rule with (mpos_stride,
// mseq_stride): (N * S, S) seq-major, (S, S * S) batch-major. Math is f32
// for f32 and bf16 operands; the output has the operands' type.
//
// What bounds it on an H100: device-memory bytes. Each call must read
// q, k, v, c and write out (5 * S * N * d elements) plus the masks; at the
// training shape N = 3072, S = 6, d = 128 in f32 that is about 47 MB, 14 us
// at 3.35 TB/s, against about 6 * S^2 * N * d = 85 MFLOP (1.3 us at
// 67 TFLOP/s f32). A sequence's products are 6 x 6 x 128: far below a
// 64-row wgmma tile, and TF32 would break the f32 tolerance, so the
// kernel uses no tensor cores.
//
// What the design does about it (the TPU kernel's own idea, with threads
// where the MXU was): a persistent grid (as many blocks of 128 threads as
// fit on the SMs) walks tiles of sequences; a block keeps a ring of two
// tiles in shared memory, so the next tile's copies fly while this one
// computes (one stage where two do not fit, S * d large).
//   1. Stage: the rows of q, k, v and c of a tile go from device memory to
//      shared memory by 16-byte cp.async copies (a row's offset formed
//      once for all four tensors), the additive mask and the keep masks by
//      4-byte ones (a u8 element as its aligned word): every input byte is
//      read from device memory once, and no compute step waits on a global
//      load. Rows are padded by 16 bytes (no bank conflicts when lanes read
//      different rows at one feature index).
//   2a. Dot products: one thread per c_i.c_j and per q_i.k_j (2 S^2 a
//      sequence), each walking d in shared memory with V partial sums, so
//      all lanes of the block run short independent FMA chains.
//   2b. Scores: one lane per (sequence, row i, key j); the S keys of a row
//      are one group of 8 lanes (32 when S > 8), and the norms are the
//      diagonal c_i.c_i. Row max and row sum are 3 (or 5) full-mask
//      shuffle steps (the loop is uniform over a warp). The lane writes its
//      blended weight beta*P1*m1/keep + (1-beta)*P2*m2/keep.
//   3. Output: a thread takes one 16-byte chunk of three output rows, an
//      S-term sum over the staged v rows (two terms' loads ahead of their
//      FMAs), and stores 16 bytes a row.
// No integer division by a run-time value in the loops (pmgt::div_small).
// Sequences past N take part in every barrier and skip their copies and
// stores; no padding of N. Each output element is summed in the same order
// in both layouts, with no atomics: K1 and K3 agree bit for bit.
//
// On an H100 at N = 3072 this runs at about half of the byte bound with a
// cold L2: each tile is a chain of dependent steps (copy wait, dots,
// shuffles, sums) and 16 warps an SM do not hide it all (PERF.md).
//
// Limits: 1 <= S <= 32, 32 <= d <= 256 with d % 32 == 0 (checked here and
// by the Python wrapper). The C entry point returns the launch's error.

#include "dual_attention_common.cuh"

namespace {

using pmgt::kThreads;
using pmgt::row_pitch;
using pmgt::store_chunk;

constexpr int kRowBlock = 3;  // output rows per thread in step 3
constexpr size_t kSmemTarget = 56 * 1024;  // per block, both stages

// Shared bytes of one sequence in one stage: its q, k, v and c
// rows, its additive mask and its two keep-mask tables (a word an element).
template <typename T>
size_t seq_stage_bytes(int S, int d) {
  return sizeof(T) * 4 * static_cast<size_t>(S) * row_pitch<T>(d) +
         sizeof(float) * S * (1 + 2 * S);
}

// Shared bytes of a block: its stages and the tile's tables (the dot
// products c.c and q.k, the weights).
template <typename T>
size_t smem_bytes(int S, int d, int tile, int stages) {
  return stages * pmgt::round16(tile * seq_stage_bytes<T>(S, d)) +
         sizeof(float) * static_cast<size_t>(tile) * 3 * S * S;
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ...; G lanes per
// score row (G >= S).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 4)
    dual_attention_fwd_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ c,
                              const float* __restrict__ mask,
                              const void* __restrict__ m1,
                              const void* __restrict__ m2, int mask_kind,
                              T* __restrict__ out, int S, int N, int d,
                              int tile, int ntiles, int stages,
                              long long pos_stride, long long seq_stride,
                              long long mpos_stride, long long mseq_stride,
                              float beta,
                              float one_minus_beta, float inv_keep,
                              float inv_sqrt_d) {
  constexpr int V = pmgt::vec_width<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = row_pitch<T>(d);
  const int plane = tile * S * pitch;  // one tensor's rows in a stage
  // stage b at b * stage_bytes: 4 row planes, the mask, the keep words
  const size_t stage_bytes = pmgt::round16(
      sizeof(T) * 4 * plane + sizeof(float) * tile * S * (1 + 2 * S));
  // sequence s's dot products at s_dot + s * 2 * S * S: c.c, q.k
  float* s_dot = reinterpret_cast<float*>(smem + stages * stage_bytes);
  float* s_w = s_dot + 2 * tile * S * S;
  const pmgt::RowSlots rs = pmgt::row_slots(d / V, S);
  const int per_seq = 2 * S * S;  // dot products of a sequence
  const int nrb = (S + kRowBlock - 1) / kRowBlock;
  // 1 / divisor for pmgt::div_small
  const float inv_s = 1.f / S, inv_ss = 1.f / (S * S);
  const float inv_per_seq = 1.f / per_seq, inv_nrb = 1.f / nrb;

  // q, k, v, c of tile t into a stage, as 16-byte asynchronous copies.
  const T* const srcs[4] = {q, k, v, c};
  auto issue = [&](unsigned char* stage, int t) {
    const int n0 = t * tile;
    T* st = reinterpret_cast<T*>(stage);
    float* madd = reinterpret_cast<float*>(st + 4 * plane);
    uint32_t* words = reinterpret_cast<uint32_t*>(madd + tile * S);
    pmgt::stage_masks(madd, words, words + tile * S * S, mask, m1, m2,
                      mask_kind, S, inv_s, tile, n0, N, mpos_stride,
                      mseq_stride);
    pmgt::stage_rows(st, srcs, plane, rs, S, d, tile, n0, N, pos_stride,
                     seq_stride);
  };

  const int j = threadIdx.x % G;
  const int group = (threadIdx.x % pmgt::kWarp) / G;  // in its warp
  const int warp_row = threadIdx.x / G - group;  // the warp's first row
  const bool key = j < S;
  const int jj = key ? j : S - 1;  // spare lanes read a real row, add 0

  // The ring: with two stages, tile blockIdx.x + m * gridDim.x goes to
  // stage m % 2 and the next tile's copies fly while one computes; with one
  // (when two do not fit in shared memory) each tile is copied, then used.
  const int stride = gridDim.x;
  if (stages == 2) {
    if (static_cast<int>(blockIdx.x) < ntiles) issue(smem, blockIdx.x);
    pmgt::cp_async_commit();
  }
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += stride, ++it) {
    // ---- 1. copy the next tile while this one computes ----
    if (stages == 2) {
      if (t + stride < ntiles)
        issue(smem + ((it + 1) & 1) * stage_bytes, t + stride);
      pmgt::cp_async_commit();
      pmgt::cp_async_wait<1>();  // this tile's copies have landed
    } else {
      issue(smem, t);
      pmgt::cp_async_commit();
      pmgt::cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = reinterpret_cast<const T*>(
        smem + (stages == 2 ? it & 1 : 0) * stage_bytes);
    const int n0 = t * tile;
    const T* s_q = cur;
    const T* s_k = cur + plane;
    const T* s_v = cur + 2 * plane;
    const T* s_c = cur + 3 * plane;
    const float* s_madd = reinterpret_cast<const float*>(cur + 4 * plane);
    const uint32_t* s_m1 = reinterpret_cast<const uint32_t*>(s_madd + tile * S);
    const uint32_t* s_m2 = s_m1 + tile * S * S;

    // ---- 2a. the dot products c_i.c_j and q_i.k_j: one thread each,
    // 2 * S^2 a sequence, so every lane of the block walks d at once ----
    for (int x = threadIdx.x; x < tile * per_seq; x += kThreads) {
      const int s = pmgt::div_small(x, inv_per_seq);
      const int kind = pmgt::div_small(x - s * per_seq, inv_ss);  // c.c, q.k
      const int ij = x - s * per_seq - kind * S * S;
      const int i = pmgt::div_small(ij, inv_s);
      if (n0 + s >= N) continue;
      const T* a = kind == 0 ? s_c : s_q;
      const T* b = kind == 0 ? s_c : s_k;
      s_dot[x] = pmgt::dot_rows(a + (s * S + i) * pitch,
                                b + (s * S + ij - i * S) * pitch, d);
    }
    __syncthreads();

    // ---- 2b. scores: lane j of the group of row (s, i) owns key j. The
    // loop is uniform over a warp, so its shuffles take the full mask; a
    // group past the last row or past N works on row 0 and stores nothing.
    for (int first = warp_row; first < tile * S; first += kThreads / G) {
      const bool in_tile = first + group < tile * S;
      const int task = in_tile ? first + group : 0;
      const int s = pmgt::div_small(task, inv_s);
      const int i = task - s * S;
      const int n = n0 + s;
      const bool live = in_tile && n < N;
      const float madd = s_madd[s * S + jj];
      const float k1 =
          key ? pmgt::keep_factor(s_m1[task * S + j], m1, mask_kind, inv_keep,
                                  i, n, j, mpos_stride, mseq_stride)
              : 0.f;
      const float k2 =
          key ? pmgt::keep_factor(s_m2[task * S + j], m2, mask_kind, inv_keep,
                                  i, n, j, mpos_stride, mseq_stride)
              : 0.f;
      const float* cc_t = s_dot + s * per_seq;  // then q.k
      const float cc = cc_t[i * S + jj];
      const float qk = cc_t[S * S + i * S + jj];
      const float cosv = cc / fmaxf(sqrtf(cc_t[i * S + i]) *
                                        sqrtf(cc_t[jj * S + jj]),
                                    1e-12f);
      // identity on the cosine scores only; 1/sqrt(d) before the mask
      const float s1 =
          key ? 1.0f - cosv + (j == i ? 1.0f : 0.0f) + madd : -INFINITY;
      const float s2 = key ? qk * inv_sqrt_d + madd : -INFINITY;
      // Subtract the row max before exp: a key masked with the f32 minimum
      // gets P exactly 0.
      const float mx1 = pmgt::group_max<G>(s1);
      const float mx2 = pmgt::group_max<G>(s2);
      const float e1 = key ? expf(s1 - mx1) : 0.f;
      const float e2 = key ? expf(s2 - mx2) : 0.f;
      const float z1 = pmgt::group_sum<G>(e1);
      const float z2 = pmgt::group_sum<G>(e2);
      if (key && live)
        s_w[task * S + j] =
            beta * (e1 / z1) * k1 + one_minus_beta * (e2 / z2) * k2;
    }
    __syncthreads();

    // ---- 3. out_r = sum_t w_rt v_t: a thread takes one 16-byte chunk of
    // kRowBlock rows, so each staged v chunk is read once per row block ----
    for (int u = rs.first; u < tile * nrb; u += rs.step) {
      const int s = pmgt::div_small(u, inv_nrb);
      const int r0 = (u - s * nrb) * kRowBlock;
      const int n = n0 + s;
      if (n >= N) continue;
      const float* w = s_w + s * S * S;
      const T* vt = s_v + s * S * pitch + rs.chunk * V;
      float acc[kRowBlock][V];
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[b][e] = 0.f;
      pmgt::accumulate_terms(acc, vt, pitch, S, [&](int b, int tt) {
        return r0 + b < S ? w[(r0 + b) * S + tt] : 0.f;
      });
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b)
        if (r0 + b < S)
          store_chunk(out + (r0 + b) * pos_stride +
                          static_cast<long long>(n) * seq_stride + rs.chunk * V,
                      acc[b]);
    }
    __syncthreads();  // this stage and s_w are free for the next tile
  }
  pmgt::cp_async_wait<0>();
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* c,
           const float* mask, const void* m1, const void* m2, int mask_kind,
           void* out, int S, int N, int d, long long pos_stride,
           long long seq_stride, long long mpos_stride, long long mseq_stride,
           float beta, float one_minus_beta, float inv_keep, float inv_sqrt_d,
           cudaStream_t stream) {
  static unsigned long long configured = 0;  // one bit per device
  const auto kernel = dual_attention_fwd_kernel<T, G>;
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = pmgt::configure_once(kernel, configured, &optin);
  if (err == cudaSuccess) err = pmgt::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = pmgt::tile_size(S, G, N, sms, seq_stage_bytes<T>(S, d),
                                   kSmemTarget);
  int stages = 2;
  size_t smem = smem_bytes<T>(S, d, tile, stages);
  if (smem > static_cast<size_t>(optin)) {  // one stage where two do not fit
    stages = 1;
    smem = smem_bytes<T>(S, d, tile, stages);
  }
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = pmgt::blocks_per_sm(kernel, smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (N + tile - 1) / tile;
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(c), mask, m1, m2,
      mask_kind, static_cast<T*>(out), S, N, d, tile, ntiles, stages,
      pos_stride, seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta,
      inv_keep, inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, const void* c,
                const float* mask, const void* m1, const void* m2,
                int mask_kind, void* out, int S, int N, int d,
                long long pos_stride, long long seq_stride,
                long long mpos_stride, long long mseq_stride, float beta,
                float one_minus_beta, float inv_keep, float inv_sqrt_d,
                cudaStream_t stream) {
  if (pmgt::group_width(S) == 8)
    return launch<T, 8>(
      q, k, v, c, mask, m1, m2, mask_kind, out, S, N, d, pos_stride,
      seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta, inv_keep,
      inv_sqrt_d, stream);
  return launch<T, 32>(
      q, k, v, c, mask, m1, m2, mask_kind, out, S, N, d, pos_stride,
      seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta, inv_keep,
      inv_sqrt_d, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask_kind: 0 = none, 1 = u8, 2 = f32.
// Strides are in elements (see the layout note above). Launches on
// `stream` without synchronising and returns the launch's CUDA error (0 on
// success).
int pmgt_dual_attention_fwd(const void* q, const void* k, const void* v,
                            const void* c, const float* mask, const void* m1,
                            const void* m2, int mask_kind, void* out, int S,
                            int N, int d, int dtype, long long pos_stride,
                            long long seq_stride, long long mpos_stride,
                            long long mseq_stride, float beta,
                            float one_minus_beta, float inv_keep,
                            float inv_sqrt_d, void* stream) {
  if (S < 1 || S > 32 || d < 32 || d > 256 || d % 32 != 0 || N < 0 ||
      dtype < 0 || dtype > 1 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_type<float>(q, k, v, c, mask, m1, m2, mask_kind, out, S,
                                  N, d, pos_stride, seq_stride, mpos_stride,
                                  mseq_stride, beta, one_minus_beta, inv_keep,
                                  inv_sqrt_d, s)
             : launch_type<__nv_bfloat16>(
                   q, k, v, c, mask, m1, m2, mask_kind, out, S, N, d,
                   pos_stride, seq_stride, mpos_stride, mseq_stride, beta,
                   one_minus_beta, inv_keep, inv_sqrt_d, s);
}

}  // extern "C"
