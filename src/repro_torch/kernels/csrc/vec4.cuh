// Four columns of a table row as float32 registers: the slice one lane of a
// warp reads and writes in embedding_bag.cu and embedding_bag_bwd.cu, with
// one 8-byte (bfloat16) or 16-byte (float32) access. The pointer must be
// aligned to the access: a row width d that is a multiple of 4 and a table
// on a 16-byte boundary keep every slice aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct Vec4 {
  float x, y, z, w;
};

__device__ __forceinline__ Vec4 load4(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Vec4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void store4(float* p, const Vec4& v) {
  *reinterpret_cast<float4*>(p) = make_float4(v.x, v.y, v.z, v.w);
}

// rounds each value to nearest, ties to even (as torch's .to(bfloat16))
__device__ __forceinline__ void store4(__nv_bfloat16* p, const Vec4& v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
