// Device helpers shared by the dual-attention kernels
// (dual_attention_fwd.cu, dual_attention_bwd.cu): warp reductions, the
// lane-slice row loads/stores in f32 or bf16, and the keep-mask read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pmgt {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---- lane-slice loads/stores: DPL contiguous elements per lane ---------

template <int DPL>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&r)[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 4; ++t) {
      const float4 x = reinterpret_cast<const float4*>(p)[t];
      r[4 * t] = x.x;
      r[4 * t + 1] = x.y;
      r[4 * t + 2] = x.z;
      r[4 * t + 3] = x.w;
    }
  } else if constexpr (DPL % 2 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 2; ++t) {
      const float2 x = reinterpret_cast<const float2*>(p)[t];
      r[2 * t] = x.x;
      r[2 * t + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < DPL; ++t) r[t] = p[t];
  }
}

template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&r)[DPL]) {
  if constexpr (DPL % 8 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 8; ++t) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[t];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        r[8 * t + 2 * e] = f.x;
        r[8 * t + 2 * e + 1] = f.y;
      }
    }
  } else if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 4; ++t) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[t];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        r[4 * t + 2 * e] = f.x;
        r[4 * t + 2 * e + 1] = f.y;
      }
    }
  } else if constexpr (DPL % 2 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 2; ++t) {
      const float2 f =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[t]);
      r[2 * t] = f.x;
      r[2 * t + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < DPL; ++t) r[t] = __bfloat162float(p[t]);
  }
}

template <int DPL>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&r)[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 4; ++t)
      reinterpret_cast<float4*>(p)[t] =
          make_float4(r[4 * t], r[4 * t + 1], r[4 * t + 2], r[4 * t + 3]);
  } else if constexpr (DPL % 2 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 2; ++t)
      reinterpret_cast<float2*>(p)[t] = make_float2(r[2 * t], r[2 * t + 1]);
  } else {
#pragma unroll
    for (int t = 0; t < DPL; ++t) p[t] = r[t];
  }
}

template <int DPL>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ p,
                                          const float (&r)[DPL]) {
  if constexpr (DPL % 8 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 8; ++t) {
      uint4 x;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(r[8 * t + 2 * e], r[8 * t + 2 * e + 1]);
      reinterpret_cast<uint4*>(p)[t] = x;
    }
  } else if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 4; ++t) {
      uint2 x;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        h[e] = __floats2bfloat162_rn(r[4 * t + 2 * e], r[4 * t + 2 * e + 1]);
      reinterpret_cast<uint2*>(p)[t] = x;
    }
  } else if constexpr (DPL % 2 == 0) {
#pragma unroll
    for (int t = 0; t < DPL / 2; ++t)
      reinterpret_cast<__nv_bfloat162*>(p)[t] =
          __floats2bfloat162_rn(r[2 * t], r[2 * t + 1]);
  } else {
#pragma unroll
    for (int t = 0; t < DPL; ++t) p[t] = __float2bfloat16(r[t]);
  }
}

// Keep-mask element: kind 1 = u8 (bool storage), 2 = f32.
__device__ __forceinline__ float keep_value(const void* m, int kind,
                                            size_t idx) {
  return kind == 1 ? static_cast<float>(static_cast<const uint8_t*>(m)[idx])
                   : static_cast<const float*>(m)[idx];
}

}  // namespace pmgt
