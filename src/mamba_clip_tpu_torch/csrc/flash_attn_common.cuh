// Shared by flash_attn_fwd.cu and flash_attn_bwd.cu: the tile geometry and
// the 16-byte load, store and FMA helpers of the flash-attention kernels.
//
// A row (a query row in the forward and the dq kernel, a key row in the
// dk/dv kernel) belongs to HD/32 neighbouring lanes, each holding 32 of its
// dims in registers as 8 float4 chunks; lane g of a row owns the chunks g,
// g + HD/32, ... of the head dim, so the lanes of a warp read neighbouring
// shared-memory banks and every row of the warp the same words (broadcast).
// A dot product over the head dim is each lane's partial sum joined by
// shuffles (reduce_row). The three kernels take the products in one order,
// so the backward recomputes the forward's scores bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;  // rows a block owns
constexpr int kDimsPerLane = 32;
constexpr float kMasked = -1e9f;  // the plain interior's score of a masked key

template <int HD>
struct Cfg {
  static constexpr int kLanesPerRow = HD / kDimsPerLane;  // 1, 2 or 4
  static constexpr int kThreads = kRows * kLanesPerRow;
  static constexpr int kKeys = HD <= 64 ? 64 : 32;        // rows a staged tile
  static constexpr int kChunks = kDimsPerLane / 4;        // float4 chunks a lane
  static constexpr int kRowChunks = HD / 4;               // float4 chunks a row
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float p, float4 v, float4 acc) {
  return make_float4(fmaf(p, v.x, acc.x), fmaf(p, v.y, acc.y), fmaf(p, v.z, acc.z),
                     fmaf(p, v.w, acc.w));
}

// The sum of `part` over the LANES neighbouring lanes of a row.
template <int LANES>
__device__ __forceinline__ float reduce_row(float part) {
#pragma unroll
  for (int w = LANES / 2; w > 0; w /= 2) part += __shfl_xor_sync(kFull, part, w);
  return part;
}

}  // namespace fa
