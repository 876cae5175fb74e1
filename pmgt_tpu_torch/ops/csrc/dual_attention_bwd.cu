// PMGT dual-attention backward for Hopper (sm_90a), in either layout.
//
// Replaces the TPU kernels `_pallas_backward_sm` (body `_bwd_kernel_sm`,
// the seq-major K2) and `_pallas_backward` (body `_bwd_kernel`, the
// batch-major K4) of pmgt_tpu/ops/dual_attention.py; both run the math
// `_bwd_math`. Nothing is saved by the forward: for every sequence n the
// kernel recomputes
//
//   cos = c c^T / max(|c_i| |c_j|, 1e-12)
//   P1  = softmax(1 - cos + I + M),  P2 = softmax(q k^T / sqrt(d) + M)
//   probs = beta * P1 * m1/keep + (1 - beta) * P2 * m2/keep
//
// and then, from the output gradient g,
//
//   dv   = probs^T g,             dprobs = g v^T
//   dP1  = beta * dprobs * m1/keep,  dP2 = (1 - beta) * dprobs * m2/keep
//   dS   = P * (dP - rowsum(dP * P))                  (each softmax)
//   dq   = dS2 k / sqrt(d),       dk = dS2^T q / sqrt(d)
//   G    = -(dS1 + dS1^T)
//   dc_i = sum_j G_ij / max(|c_i||c_j|, 1e-12) c_j
//          - (sum_j G_ij cos_ij / max(|c_i|^2, 1e-12)) c_i
//
// Layout: element (position i, sequence n, feature e) of q, k, v, c, g and
// the four gradients sits at i * pos_stride + n * seq_stride + e, so the
// seq-major [S, N, d] layout passes (N * d, d) and the batch-major
// [N, S, d] layout (d, S * d). The additive key mask is [N, S] f32; the
// optional keep masks (u8 or f32) follow the same rule with (mpos_stride,
// mseq_stride): (N * S, S) seq-major, (S, S * S) batch-major. Math is f32
// for f32 and bf16 operands; the gradients have the operands' type.
//
// What bounds it on an H100: device-memory bytes. Each call must read q,
// k, v, c, g, the mask and the keep masks and write dq, dk, dv, dc: at the
// training shape N = 3072, S = 6, d = 128 in f32 about 85 MB, about 25 us
// at 3.35 TB/s, against about 14 * S^2 * N * d = 198 MFLOP (3 us at
// 67 TFLOP/s f32). No tensor cores: the products are 6 x 6 x 128.
//
// What the design does about it: the forward's design (see
// dual_attention_fwd.cu: persistent blocks, a two-stage cp.async ring of
// tiles in shared memory, no run-time integer division in the loops) with
// five staged tensors (step 1) and four compute steps a tile.
//   2a. Dot products: one thread per c_i.c_j, q_i.k_j and g_i.v_j (3 S^2
//      a sequence), each walking d in shared memory with V partial sums.
//   2b. Scores and their backward: one lane per (sequence, row i, key j),
//      the S keys of a row one group of 8 (or 32) lanes; both softmaxes,
//      dP and the two softmax backwards take 3 (or 5) full-mask shuffle
//      steps per row reduction. probs, dS1, dS2, cos and the norms go to
//      shared memory.
//   3. The dc weights G_rt / max(|c_r||c_t|, 1e-12) and the row terms
//      sum_t G_rt cos_rt / max(|c_r|^2, 1e-12), once per (r, t): G needs
//      dS1^T, so all of dS1 must exist first.
//   4. Gradients: a thread takes one 16-byte chunk of kRowBlock rows of one
//      gradient, an S-term sum over one staged tensor (dq from k, dk from
//      q, dv from g, dc from c) with weights from the S x S tables, and
//      stores 16 bytes a row.
// On an H100 at the training shape this runs at a little over half of the
// byte bound with a cold L2: each tile is a chain of dependent steps (copy
// wait, dots, shuffles, sums, stores) and 24 warps an SM (80 registers,
// 34 KB of shared memory a block) do not hide it all (PERF.md). No atomics,
// and the same order of sums in both layouts: K2 and K4 agree bit for bit.
//
// Limits: 1 <= S <= 32, 32 <= d <= 256 with d % 32 == 0. The C entry point
// returns the launch's error.

#include "dual_attention_common.cuh"

namespace {

using pmgt::kThreads;
using pmgt::load_chunk;
using pmgt::row_pitch;
using pmgt::store_chunk;

// Gradient rows per thread in step 4: six in f32 (a thread's chunk of every
// row of S = 6 at once), three in bf16 (its 8-wide chunks would spill).
template <typename T>
constexpr int kRowBlock = sizeof(T) == 4 ? 6 : 3;
constexpr size_t kSmemTarget = 56 * 1024;  // per block, both stages

// Shared bytes of one sequence in one stage: its q, k, v, c and g
// rows, its additive mask and its two keep-mask tables (a word an element).
template <typename T>
size_t seq_stage_bytes(int S, int d) {
  return sizeof(T) * 5 * static_cast<size_t>(S) * row_pitch<T>(d) +
         sizeof(float) * S * (1 + 2 * S);
}

// Shared floats of the tile's tables: the dot products c.c, q.k, g.v,
// probs, dS1, dS2, cos and the dc weights (S x S each), the squared norms,
// norms and dc row terms (S each).
inline size_t table_floats(int S, int tile) {
  return static_cast<size_t>(tile) * S * (8 * S + 3);
}

// Shared bytes of a block: its stages and the tables.
template <typename T>
size_t smem_bytes(int S, int d, int tile, int stages) {
  return stages * pmgt::round16(tile * seq_stage_bytes<T>(S, d)) +
         sizeof(float) * table_floats(S, tile);
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ...; G lanes per
// score row (G >= S).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 6)
    dual_attention_bwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ c,
        const float* __restrict__ mask, const void* __restrict__ m1,
        const void* __restrict__ m2, int mask_kind,
        const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
        T* __restrict__ dv, T* __restrict__ dc, int S, int N, int d,
        int tile, int ntiles, int stages, long long pos_stride,
        long long seq_stride, long long mpos_stride, long long mseq_stride,
        float beta,
        float one_minus_beta, float inv_keep, float inv_sqrt_d) {
  constexpr int V = pmgt::vec_width<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = row_pitch<T>(d);
  const int plane = tile * S * pitch;  // one tensor's rows in a stage
  // stage b at b * stage_bytes: 5 row planes, the mask, the keep words
  const size_t stage_bytes = pmgt::round16(
      sizeof(T) * 5 * plane + sizeof(float) * tile * S * (1 + 2 * S));
  const int sq = tile * S * S;  // one S x S table for the tile
  // sequence s's dot products at s_dot + s * 3 * S * S: c.c, q.k, g.v
  float* s_dot = reinterpret_cast<float*>(smem + stages * stage_bytes);
  float* s_prob = s_dot + 3 * sq;
  float* s_ds1 = s_prob + sq;
  float* s_ds2 = s_ds1 + sq;
  float* s_cos = s_ds2 + sq;
  float* s_wc = s_cos + sq;  // G_rt / max(|c_r||c_t|, 1e-12)
  float* s_nsq = s_wc + sq;
  float* s_nrm = s_nsq + tile * S;
  float* s_srow = s_nrm + tile * S;  // sum_t G_rt cos_rt / max(|c_r|^2, .)
  const pmgt::RowSlots rs = pmgt::row_slots(d / V, S);
  const int per_seq = 3 * S * S;  // dot products of a sequence
  const int nrb = (S + kRowBlock<T> - 1) / kRowBlock<T>;
  // 1 / divisor for pmgt::div_small
  const float inv_s = 1.f / S, inv_ss = 1.f / (S * S);
  const float inv_per_seq = 1.f / per_seq, inv_nrb = 1.f / nrb;
  const float inv_items = 1.f / (tile * nrb);

  // q, k, v, c, g of tile t into a stage, as 16-byte asynchronous copies.
  const T* const srcs[5] = {q, k, v, c, g};
  auto issue = [&](unsigned char* stage, int t) {
    const int n0 = t * tile;
    T* st = reinterpret_cast<T*>(stage);
    float* madd = reinterpret_cast<float*>(st + 5 * plane);
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
    const T* s_g = cur + 4 * plane;
    const float* s_madd = reinterpret_cast<const float*>(cur + 5 * plane);
    const uint32_t* s_m1 =
        reinterpret_cast<const uint32_t*>(s_madd + tile * S);
    const uint32_t* s_m2 = s_m1 + tile * S * S;

    // ---- 2a. the dot products c_i.c_j, q_i.k_j, g_i.v_j: one thread each,
    // 3 * S^2 a sequence, so every lane of the block walks d at once ----
    for (int x = threadIdx.x; x < tile * per_seq; x += kThreads) {
      const int s = pmgt::div_small(x, inv_per_seq);
      // 0 c.c, 1 q.k, 2 g.v
      const int kind = pmgt::div_small(x - s * per_seq, inv_ss);
      const int ij = x - s * per_seq - kind * S * S;
      const int i = pmgt::div_small(ij, inv_s);
      if (n0 + s >= N) continue;
      const T* a = kind == 0 ? s_c : kind == 1 ? s_q : s_g;
      const T* b = kind == 0 ? s_c : kind == 1 ? s_k : s_v;
      s_dot[x] = pmgt::dot_rows(a + (s * S + i) * pitch,
                                b + (s * S + ij - i * S) * pitch, d);
    }
    __syncthreads();

    // ---- 2b. softmaxes and their backward: lane j of the group of row
    // (s, i) owns key j. The loop is uniform over a warp, so its shuffles
    // take the full mask; a group past the last row or past N works on row
    // 0 and stores nothing.
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
      const float* cc_t = s_dot + s * per_seq;  // then q.k, then g.v
      const float cc = cc_t[i * S + jj];
      const float qk = cc_t[S * S + i * S + jj];
      const float gv = cc_t[2 * S * S + i * S + jj];
      const float ss = cc_t[jj * S + jj];  // c_j.c_j
      const float cosv =
          cc / fmaxf(sqrtf(cc_t[i * S + i]) * sqrtf(ss), 1e-12f);
      // identity on the cosine scores only; 1/sqrt(d) before the mask
      const float s1 =
          key ? 1.0f - cosv + (j == i ? 1.0f : 0.0f) + madd : -INFINITY;
      const float s2 = key ? qk * inv_sqrt_d + madd : -INFINITY;
      // Subtract the row max before exp: a masked key (additive f32 min)
      // gets P exactly 0 and adds nothing to dS.
      const float mx1 = pmgt::group_max<G>(s1);
      const float mx2 = pmgt::group_max<G>(s2);
      const float e1 = key ? expf(s1 - mx1) : 0.f;
      const float e2 = key ? expf(s2 - mx2) : 0.f;
      const float p1 = e1 / pmgt::group_sum<G>(e1);
      const float p2 = e2 / pmgt::group_sum<G>(e2);
      const float dp1 = beta * gv * k1;
      const float dp2 = one_minus_beta * gv * k2;
      const float ds1 = p1 * (dp1 - pmgt::group_sum<G>(dp1 * p1));
      const float ds2 = p2 * (dp2 - pmgt::group_sum<G>(dp2 * p2));
      if (key && live) {
        const int w = task * S + j;
        s_prob[w] = beta * p1 * k1 + one_minus_beta * p2 * k2;
        s_ds1[w] = ds1;
        s_ds2[w] = ds2;
        s_cos[w] = cosv;
      }
      if (j == i && live) {
        s_nsq[task] = ss;
        s_nrm[task] = sqrtf(ss);
      }
    }
    __syncthreads();

    // ---- 3. the dc weights, which need dS1^T: lane t of the group of row
    // (s, r), warp-uniform as step 2b ----
    for (int first = warp_row; first < tile * S; first += kThreads / G) {
      const bool in_tile = first + group < tile * S;
      const int task = in_tile ? first + group : 0;
      const int s = pmgt::div_small(task, inv_s);
      const int r = task - s * S;
      const bool live = in_tile && n0 + s < N;
      const int tab = s * S * S;
      float gc = 0.f;
      if (key) {
        const float gsym = -(s_ds1[tab + r * S + j] + s_ds1[tab + j * S + r]);
        if (live)
          s_wc[tab + r * S + j] =
              gsym / fmaxf(s_nrm[s * S + r] * s_nrm[s * S + j], 1e-12f);
        gc = gsym * s_cos[tab + r * S + j];
      }
      gc = pmgt::group_sum<G>(gc);
      if (j == 0 && live) s_srow[task] = gc / fmaxf(s_nsq[task], 1e-12f);
    }
    __syncthreads();

    // ---- 4. the gradients: a thread takes one 16-byte chunk of
    // kRowBlock<T> rows of one gradient, an S-term sum over one staged
    // tensor (dq from k, dk from q, dv from g, dc from c), so each staged
    // chunk is read once per row block ----
    for (int u = rs.first; u < 4 * tile * nrb; u += rs.step) {
      const int kind = pmgt::div_small(u, inv_items);  // 0 dq, 1 dk, 2 dv, 3 dc
      const int rest = u - kind * tile * nrb;
      const int s = pmgt::div_small(rest, inv_nrb);
      const int r0 = (rest - s * nrb) * kRowBlock<T>;
      const int n = n0 + s;
      if (n >= N) continue;
      // weight of (row r, term t) at tab[r * rstride + t * tstride]
      const int base = s * S * S;
      const float* tab = kind == 0 || kind == 1 ? s_ds2 + base
                         : kind == 2            ? s_prob + base
                                                : s_wc + base;
      const int rstride = kind == 0 || kind == 3 ? S : 1;
      const int tstride = kind == 0 || kind == 3 ? 1 : S;
      const T* src =
          (kind == 0 ? s_k : kind == 1 ? s_q : kind == 2 ? s_g : s_c) +
          s * S * pitch + rs.chunk * V;
      float acc[kRowBlock<T>][V];
#pragma unroll
      for (int b = 0; b < kRowBlock<T>; ++b)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[b][e] = 0.f;
      pmgt::accumulate_terms(acc, src, pitch, S, [&](int b, int tt) {
        return r0 + b < S ? tab[(r0 + b) * rstride + tt * tstride] : 0.f;
      });
      T* dst = kind == 0 ? dq : kind == 1 ? dk : kind == 2 ? dv : dc;
#pragma unroll
      for (int b = 0; b < kRowBlock<T>; ++b) {
        const int r = r0 + b;
        if (r >= S) break;
        if (kind < 2) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[b][e] *= inv_sqrt_d;
        } else if (kind == 3) {
          const float srow = s_srow[s * S + r];
          float cr[V];
          load_chunk(src + r * pitch, cr);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[b][e] -= srow * cr[e];
        }
        store_chunk(dst + r * pos_stride +
                        static_cast<long long>(n) * seq_stride + rs.chunk * V,
                    acc[b]);
      }
    }
    __syncthreads();  // this stage and the tables are free for the next tile
  }
  pmgt::cp_async_wait<0>();
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* c,
           const float* mask, const void* m1, const void* m2, int mask_kind,
           const void* g, void* dq, void* dk, void* dv, void* dc, int S,
           int N, int d, long long pos_stride, long long seq_stride,
           long long mpos_stride, long long mseq_stride, float beta,
           float one_minus_beta, float inv_keep, float inv_sqrt_d,
           cudaStream_t stream) {
  static unsigned long long configured = 0;  // one bit per device
  const auto kernel = dual_attention_bwd_kernel<T, G>;
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
      mask_kind, static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dc), S, N, d,
      tile, ntiles, stages, pos_stride, seq_stride, mpos_stride, mseq_stride,
      beta, one_minus_beta, inv_keep, inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, const void* c,
                const float* mask, const void* m1, const void* m2,
                int mask_kind, const void* g, void* dq, void* dk, void* dv,
                void* dc, int S, int N, int d, long long pos_stride,
                long long seq_stride, long long mpos_stride,
                long long mseq_stride, float beta, float one_minus_beta,
                float inv_keep, float inv_sqrt_d, cudaStream_t stream) {
  if (pmgt::group_width(S) == 8)
    return launch<T, 8>(
      q, k, v, c, mask, m1, m2, mask_kind, g, dq, dk, dv, dc, S, N, d,
      pos_stride, seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta,
      inv_keep, inv_sqrt_d, stream);
  return launch<T, 32>(
      q, k, v, c, mask, m1, m2, mask_kind, g, dq, dk, dv, dc, S, N, d,
      pos_stride, seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta,
      inv_keep, inv_sqrt_d, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask_kind: 0 = none, 1 = u8, 2 = f32.
// Strides are in elements (see the layout note above). Launches on
// `stream` without synchronising and returns the launch's CUDA error (0 on
// success).
int pmgt_dual_attention_bwd(const void* q, const void* k, const void* v,
                            const void* c, const float* mask, const void* m1,
                            const void* m2, int mask_kind, const void* g,
                            void* dq, void* dk, void* dv, void* dc, int S,
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
             ? launch_type<float>(q, k, v, c, mask, m1, m2, mask_kind, g, dq,
                                  dk, dv, dc, S, N, d, pos_stride, seq_stride,
                                  mpos_stride, mseq_stride, beta,
                                  one_minus_beta, inv_keep, inv_sqrt_d, s)
             : launch_type<__nv_bfloat16>(
                   q, k, v, c, mask, m1, m2, mask_kind, g, dq, dk, dv, dc, S,
                   N, d, pos_stride, seq_stride, mpos_stride, mseq_stride,
                   beta, one_minus_beta, inv_keep, inv_sqrt_d, s);
}

}  // extern "C"
