// PMGT dual-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_backward_sm` (body `_bwd_kernel_sm`,
// math `_bwd_math`) of pmgt_tpu/ops/dual_attention.py. Nothing is saved
// by the forward: for every sequence n the kernel recomputes
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
// at 3.35 TB/s, against about 16 * S^2 * N * d = 226 MFLOP (3.4 us at
// 67 TFLOP/s f32).
//
// What the design does about it, simply: one warp per sequence, two
// passes. Pass 1 walks the S x S score pairs; each dot product is a lane
// partial over the lane's d/32 slice reduced with __shfl_xor_sync, and
// lane j keeps column j, so both softmaxes and their backward are lane-
// parallel over keys with warp reductions over the row. The four S x S
// results (probs, dS1, dS2, cos) go to the warp's slice of shared memory,
// because G needs dS1^T: the whole of dS1 must exist before any dc row.
// Pass 2 writes dq, dk, dv and dc row by row, reading the S input rows
// again from L1. No row array is indexed at run time, so nothing spills
// at any S; the price is re-reading rows that a register-resident design
// would keep (a later optimisation). A warp past N returns: no padding.
//
// Limits: 1 <= S <= 32, 32 <= d <= 256 with d % 32 == 0. The C entry point
// returns cudaGetLastError().

#include "dual_attention_common.cuh"

namespace {

using pmgt::keep_value;
using pmgt::kWarp;
using pmgt::load_row;
using pmgt::store_row;
using pmgt::warp_max;
using pmgt::warp_sum;

constexpr int kWarpsPerBlock = 4;

// Shared floats per warp: probs, dS1, dS2 and cos (S x S each), then the
// S norms and S squared norms.
__host__ __device__ constexpr int smem_floats_per_warp(int S) {
  return 4 * S * S + 2 * S;
}

template <int DPL>
__device__ __forceinline__ float dot_slice(const float (&a)[DPL],
                                           const float (&b)[DPL]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < DPL; ++e) s += a[e] * b[e];
  return s;
}

// One warp per sequence n; DPL = d / 32 is the lane slice.
// mask_kind: 0 = no keep masks, 1 = u8, 2 = f32.
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    dual_attention_bwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ c,
        const float* __restrict__ mask, const void* __restrict__ m1,
        const void* __restrict__ m2, int mask_kind,
        const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
        T* __restrict__ dv, T* __restrict__ dc, int S, int N,
        long long pos_stride, long long seq_stride, long long mpos_stride,
        long long mseq_stride, float beta, float one_minus_beta,
        float inv_keep, float inv_sqrt_d) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;  // n is warp-uniform: whole warps leave together

  float* s_prob = smem + warp * smem_floats_per_warp(S);
  float* s_ds1 = s_prob + S * S;
  float* s_ds2 = s_ds1 + S * S;
  float* s_cos = s_ds2 + S * S;
  float* s_norm = s_cos + S * S;
  float* s_nsq = s_norm + S;

  const size_t base = static_cast<size_t>(n) * seq_stride + lane * DPL;
  auto row = [&](const T* p, int i) { return p + i * pos_stride + base; };

  // ---- norms of the context rows ----
  for (int j = 0; j < S; ++j) {
    float cj[DPL];
    load_row<DPL>(row(c, j), cj);
    const float nsq = warp_sum(dot_slice<DPL>(cj, cj));
    if (lane == 0) {
      s_nsq[j] = nsq;
      s_norm[j] = sqrtf(nsq);
    }
  }
  __syncwarp();

  // ---- pass 1: scores, softmaxes and their backward, row by row ----
  const bool key = lane < S;  // lane j owns key column j
  const float madd = key ? mask[static_cast<size_t>(n) * S + lane] : 0.f;
  const float nj = key ? s_norm[lane] : 0.f;
  for (int i = 0; i < S; ++i) {
    float qi[DPL], ci[DPL], gi[DPL];
    load_row<DPL>(row(q, i), qi);
    load_row<DPL>(row(c, i), ci);
    load_row<DPL>(row(g, i), gi);
    float cc = 0.f, qk = 0.f, gv = 0.f;
    for (int j = 0; j < S; ++j) {
      float cj[DPL], kj[DPL], vj[DPL];
      load_row<DPL>(row(c, j), cj);
      load_row<DPL>(row(k, j), kj);
      load_row<DPL>(row(v, j), vj);
      const float pc = warp_sum(dot_slice<DPL>(ci, cj));
      const float pq = warp_sum(dot_slice<DPL>(qi, kj));
      const float pg = warp_sum(dot_slice<DPL>(gi, vj));
      if (lane == j) {
        cc = pc;
        qk = pq;
        gv = pg;
      }
    }
    const float ni = s_norm[i];
    const float cosv = cc / fmaxf(ni * nj, 1e-12f);
    // identity on the cosine scores only; 1/sqrt(d) before the mask
    const float s1 =
        key ? 1.0f - cosv + (lane == i ? 1.0f : 0.0f) + madd : -INFINITY;
    const float s2 = key ? qk * inv_sqrt_d + madd : -INFINITY;
    // Subtract the row max before exp: a masked key (additive f32 min)
    // gets P exactly 0 and adds nothing to dS. Every lane takes part in
    // each shuffle reduction; only key lanes contribute.
    const float mx1 = warp_max(s1), mx2 = warp_max(s2);
    const float e1 = key ? expf(s1 - mx1) : 0.f;
    const float e2 = key ? expf(s2 - mx2) : 0.f;
    const float p1 = e1 / warp_sum(e1);
    const float p2 = e2 / warp_sum(e2);
    float k1 = 1.f, k2 = 1.f;
    if (mask_kind != 0 && key) {
      const size_t mrow = static_cast<size_t>(i) * mpos_stride +
                          static_cast<size_t>(n) * mseq_stride + lane;
      k1 = keep_value(m1, mask_kind, mrow) * inv_keep;
      k2 = keep_value(m2, mask_kind, mrow) * inv_keep;
    }
    const float dp1 = beta * gv * k1;
    const float dp2 = one_minus_beta * gv * k2;
    const float ds1 = p1 * (dp1 - warp_sum(dp1 * p1));
    const float ds2 = p2 * (dp2 - warp_sum(dp2 * p2));
    if (key) {
      s_prob[i * S + lane] = beta * p1 * k1 + one_minus_beta * p2 * k2;
      s_ds1[i * S + lane] = ds1;
      s_ds2[i * S + lane] = ds2;
      s_cos[i * S + lane] = cosv;
    }
  }
  __syncwarp();

  // ---- pass 2: the four gradients, row by row ----
  for (int r = 0; r < S; ++r) {
    float aq[DPL], ak[DPL], av[DPL], ac[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) aq[e] = ak[e] = av[e] = ac[e] = 0.f;
    const float nr = s_norm[r];
    float srow = 0.f;
    for (int t = 0; t < S; ++t) {
      float kt[DPL], qt[DPL], gt[DPL], ct[DPL];
      load_row<DPL>(row(k, t), kt);
      load_row<DPL>(row(q, t), qt);
      load_row<DPL>(row(g, t), gt);
      load_row<DPL>(row(c, t), ct);
      const float w_q = s_ds2[r * S + t];   // dS2[r, t]
      const float w_k = s_ds2[t * S + r];   // dS2[t, r]
      const float w_v = s_prob[t * S + r];  // probs[t, r]
      const float gsym = -(s_ds1[r * S + t] + s_ds1[t * S + r]);
      const float w_c = gsym / fmaxf(nr * s_norm[t], 1e-12f);
      srow += gsym * s_cos[r * S + t];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        aq[e] += w_q * kt[e];
        ak[e] += w_k * qt[e];
        av[e] += w_v * gt[e];
        ac[e] += w_c * ct[e];
      }
    }
    srow /= fmaxf(s_nsq[r], 1e-12f);
    float cr[DPL];
    load_row<DPL>(row(c, r), cr);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      aq[e] *= inv_sqrt_d;
      ak[e] *= inv_sqrt_d;
      ac[e] -= srow * cr[e];
    }
    const size_t out = r * pos_stride + base;
    store_row<DPL>(dq + out, aq);
    store_row<DPL>(dk + out, ak);
    store_row<DPL>(dv + out, av);
    store_row<DPL>(dc + out, ac);
  }
}

template <typename T, int DPL>
int launch_dpl(const void* q, const void* k, const void* v, const void* c,
               const float* mask, const void* m1, const void* m2,
               int mask_kind, const void* g, void* dq, void* dk, void* dv,
               void* dc, int S, int N, long long pos_stride,
               long long seq_stride, long long mpos_stride,
               long long mseq_stride, float beta, float one_minus_beta,
               float inv_keep, float inv_sqrt_d, cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem =
      sizeof(float) * kWarpsPerBlock * smem_floats_per_warp(S);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        dual_attention_bwd_kernel<T, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dual_attention_bwd_kernel<T, DPL><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(c), mask, m1, m2,
      mask_kind, static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dc), S, N,
      pos_stride, seq_stride, mpos_stride, mseq_stride, beta,
      one_minus_beta, inv_keep, inv_sqrt_d);
  return 0;
}

template <typename T>
int launch(int dpl, const void* q, const void* k, const void* v,
           const void* c, const float* mask, const void* m1, const void* m2,
           int mask_kind, const void* g, void* dq, void* dk, void* dv,
           void* dc, int S, int N, long long pos_stride, long long seq_stride,
           long long mpos_stride, long long mseq_stride, float beta,
           float one_minus_beta, float inv_keep, float inv_sqrt_d,
           cudaStream_t stream) {
#define PMGT_DPL_CASE(X)                                                    \
  case X:                                                                   \
    return launch_dpl<T, X>(q, k, v, c, mask, m1, m2, mask_kind, g, dq, dk, \
                            dv, dc, S, N, pos_stride, seq_stride,           \
                            mpos_stride, mseq_stride, beta, one_minus_beta, \
                            inv_keep, inv_sqrt_d, stream);
  switch (dpl) {
    PMGT_DPL_CASE(1)
    PMGT_DPL_CASE(2)
    PMGT_DPL_CASE(3)
    PMGT_DPL_CASE(4)
    PMGT_DPL_CASE(5)
    PMGT_DPL_CASE(6)
    PMGT_DPL_CASE(7)
    PMGT_DPL_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PMGT_DPL_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask_kind: 0 = none, 1 = u8, 2 = f32.
// Strides are in elements (see the layout note above). Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
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
  if (S < 1 || S > 32 || d < 32 || d > 256 || d % kWarp != 0 || N < 0 ||
      dtype < 0 || dtype > 1 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == 0
          ? launch<float>(d / kWarp, q, k, v, c, mask, m1, m2, mask_kind, g,
                          dq, dk, dv, dc, S, N, pos_stride, seq_stride,
                          mpos_stride, mseq_stride, beta, one_minus_beta,
                          inv_keep, inv_sqrt_d, s)
          : launch<__nv_bfloat16>(d / kWarp, q, k, v, c, mask, m1, m2,
                                  mask_kind, g, dq, dk, dv, dc, S, N,
                                  pos_stride, seq_stride, mpos_stride,
                                  mseq_stride, beta, one_minus_beta,
                                  inv_keep, inv_sqrt_d, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
