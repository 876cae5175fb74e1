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
// q, k, v, c and write out (5 * S * N * d elements) plus the mask
// (4 * N * S bytes); at the serving shape N = 768, S = 6, d = 128 in f32
// that is about 11.8 MB, about 3.5 us at 3.35 TB/s, against about
// 6 * S^2 * N * d = 21 MFLOP (0.3 us at 67 TFLOP/s f32). At these shapes
// launch latency is of the same order as the transfer.
//
// What the design does about it: one pass. One warp owns one sequence;
// each lane holds its d/32 slice of the S rows of k, v and c in registers
// (16-byte loads where the slice allows), the S^2 dot products and the S
// norms come from lane partials reduced with __shfl_xor_sync, and both
// softmaxes and the blend stay in registers: the scores never leave the
// SM, and every input byte is read from device memory once. q_i and c_i
// are re-read per row from L1 so that only compile-time indices touch the
// register arrays. No padding of N: the ragged last block masks itself.
//
// Limits: 1 <= S <= 32, 32 <= d <= 256 with d % 32 == 0 (checked here and
// by the Python wrapper). The C entry points return cudaGetLastError().

#include "dual_attention_common.cuh"

namespace {

using pmgt::keep_value;
using pmgt::kWarp;
using pmgt::load_row;
using pmgt::store_row;
using pmgt::warp_sum;

constexpr int kWarpsPerBlock = 4;

// One warp per sequence n; SMAX >= S bounds the register arrays, DPL =
// d / 32 is the lane slice. mask_kind: 0 = no keep masks, 1 = u8, 2 = f32.
template <typename T, int DPL, int SMAX>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    dual_attention_fwd_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ c,
                              const float* __restrict__ mask,
                              const void* __restrict__ m1,
                              const void* __restrict__ m2, int mask_kind,
                              T* __restrict__ out, int S, int N,
                              long long pos_stride, long long seq_stride,
                              long long mpos_stride, long long mseq_stride,
                              float beta, float one_minus_beta,
                              float inv_keep, float inv_sqrt_d) {
  const int lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (n >= N) return;  // n is warp-uniform: whole warps leave together

  const size_t base = static_cast<size_t>(n) * seq_stride + lane * DPL;
  auto row = [&](const T* p, int i) { return p + i * pos_stride + base; };

  float K[SMAX][DPL], V[SMAX][DPL], C[SMAX][DPL];
  float cnorm[SMAX], madd[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < S) {
      load_row<DPL>(row(k, j), K[j]);
      load_row<DPL>(row(v, j), V[j]);
      load_row<DPL>(row(c, j), C[j]);
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) ss += C[j][e] * C[j][e];
      cnorm[j] = sqrtf(warp_sum(ss));
      madd[j] = mask[static_cast<size_t>(n) * S + j];
    }
  }

  for (int i = 0; i < S; ++i) {
    float qi[DPL], ci[DPL];
    load_row<DPL>(row(q, i), qi);
    load_row<DPL>(row(c, i), ci);
    float ni = 0.f;
#pragma unroll
    for (int j = 0; j < SMAX; ++j)
      if (j == i) ni = cnorm[j];

    float s1[SMAX], s2[SMAX];
    float mx1 = -INFINITY, mx2 = -INFINITY;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        float pc = 0.f, pq = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          pc += ci[e] * C[j][e];
          pq += qi[e] * K[j][e];
        }
        pc = warp_sum(pc);
        pq = warp_sum(pq);
        const float cosv = pc / fmaxf(ni * cnorm[j], 1e-12f);
        // identity on the cosine scores only; 1/sqrt(d) before the mask
        s1[j] = 1.0f - cosv + (j == i ? 1.0f : 0.0f) + madd[j];
        s2[j] = pq * inv_sqrt_d + madd[j];
        mx1 = fmaxf(mx1, s1[j]);
        mx2 = fmaxf(mx2, s2[j]);
      }
    }
    float z1 = 0.f, z2 = 0.f;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        s1[j] = expf(s1[j] - mx1);
        s2[j] = expf(s2[j] - mx2);
        z1 += s1[j];
        z2 += s2[j];
      }
    }

    float acc[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
    const size_t mrow = static_cast<size_t>(i) * mpos_stride +
                       static_cast<size_t>(n) * mseq_stride;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < S) {
        float p1 = s1[j] / z1, p2 = s2[j] / z2;
        if (mask_kind != 0) {
          p1 = p1 * keep_value(m1, mask_kind, mrow + j) * inv_keep;
          p2 = p2 * keep_value(m2, mask_kind, mrow + j) * inv_keep;
        }
        const float w = beta * p1 + one_minus_beta * p2;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] += w * V[j][e];
      }
    }
    store_row<DPL>(out + i * pos_stride + base, acc);
  }
}

template <typename T, int DPL>
void launch_dpl(const void* q, const void* k, const void* v, const void* c,
                const float* mask, const void* m1, const void* m2,
                int mask_kind, void* out, int S, int N, long long pos_stride,
                long long seq_stride, long long mpos_stride,
                long long mseq_stride, float beta, float one_minus_beta,
                float inv_keep, float inv_sqrt_d, cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tc = static_cast<const T*>(c);
  T* to = static_cast<T*>(out);
  if (S <= 8) {
    dual_attention_fwd_kernel<T, DPL, 8><<<grid, block, 0, stream>>>(
        tq, tk, tv, tc, mask, m1, m2, mask_kind, to, S, N, pos_stride,
        seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta, inv_keep,
        inv_sqrt_d);
  } else {
    dual_attention_fwd_kernel<T, DPL, 32><<<grid, block, 0, stream>>>(
        tq, tk, tv, tc, mask, m1, m2, mask_kind, to, S, N, pos_stride,
        seq_stride, mpos_stride, mseq_stride, beta, one_minus_beta, inv_keep,
        inv_sqrt_d);
  }
}

template <typename T>
void launch(int dpl, const void* q, const void* k, const void* v,
            const void* c, const float* mask, const void* m1, const void* m2,
            int mask_kind, void* out, int S, int N, long long pos_stride,
            long long seq_stride, long long mpos_stride,
            long long mseq_stride, float beta, float one_minus_beta,
            float inv_keep, float inv_sqrt_d, cudaStream_t stream) {
#define PMGT_DPL_CASE(X)                                                    \
  case X:                                                                   \
    launch_dpl<T, X>(q, k, v, c, mask, m1, m2, mask_kind, out, S, N,        \
                     pos_stride, seq_stride, mpos_stride, mseq_stride, beta, \
                     one_minus_beta, inv_keep, inv_sqrt_d, stream);         \
    break;
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
      break;
  }
#undef PMGT_DPL_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask_kind: 0 = none, 1 = u8, 2 = f32.
// Strides are in elements (see the layout note above). Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success).
int pmgt_dual_attention_fwd(const void* q, const void* k, const void* v,
                            const void* c, const float* mask, const void* m1,
                            const void* m2, int mask_kind, void* out, int S,
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
  if (dtype == 0)
    launch<float>(d / kWarp, q, k, v, c, mask, m1, m2, mask_kind, out, S, N,
                  pos_stride, seq_stride, mpos_stride, mseq_stride, beta,
                  one_minus_beta, inv_keep, inv_sqrt_d, s);
  else
    launch<__nv_bfloat16>(d / kWarp, q, k, v, c, mask, m1, m2, mask_kind,
                          out, S, N, pos_stride, seq_stride, mpos_stride,
                          mseq_stride, beta, one_minus_beta, inv_keep,
                          inv_sqrt_d, s);
  return static_cast<int>(cudaGetLastError());
}

// The seq-major entry: q, k, v, c, out [S, N, d], keep masks [S, N, S].
int pmgt_dual_attention_fwd_sm(const void* q, const void* k, const void* v,
                               const void* c, const float* mask,
                               const void* m1, const void* m2, int mask_kind,
                               void* out, int S, int N, int d, int dtype,
                               float beta, float one_minus_beta,
                               float inv_keep, float inv_sqrt_d,
                               void* stream) {
  return pmgt_dual_attention_fwd(
      q, k, v, c, mask, m1, m2, mask_kind, out, S, N, d, dtype,
      static_cast<long long>(N) * d, d, static_cast<long long>(N) * S, S,
      beta, one_minus_beta, inv_keep, inv_sqrt_d, stream);
}

}  // extern "C"
