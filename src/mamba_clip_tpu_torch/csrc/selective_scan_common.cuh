// Shared by selective_scan_fwd.cu and selective_scan_bwd.cu: the split of
// the work, the staging of B and C, and the arithmetic both kernels take in
// one order.
//
// The split. A block owns 64 neighbouring channels (b, g, d0 .. d0 + 63) of
// one (batch, group) row, so every channel of the block reads the same B_t
// and C_t. kP neighbouring lanes own a channel: lane l of a warp holds channel
// l / kP of the warp and the kN / kP state entries q * (kN / kP) .. of it,
// q = l % kP, so a sum over n is each lane's own sum and log2 kP shuffles.
// Per 16-step chunk, B and C of the block's row are copied once into shared
// memory by cp.async (two buffers: the next chunk's copy is in flight while
// this one runs) and every lane reads its entries of them; per-channel
// values (dt = softplus(delta + bias), dt * u, dy ...) are computed once a
// channel-step, by lane q for the steps s = q, q + kP, ..., into shared
// memory that only its warp reads. The staging runs before the chunk's one
// __syncthreads, the copies and loads of the next chunk right after it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace ss {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kN = 16;             // state size
constexpr int kChunk = 16;         // steps a chunk: the spacing of hck, CHUNK in Python
constexpr int kBlockChannels = 64; // channels a block; dB/dC leave as ceil(DG/64) partials
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The split for kP lanes a channel.
template <int kP>
struct Split {
  static constexpr int kEntries = kN / kP;            // state entries a lane
  static constexpr int kWarpChannels = 32 / kP;
  static constexpr int kThreads = kBlockChannels * kP;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLaneSteps = kChunk / kP;      // steps a lane stages a chunk
  static_assert(kEntries % 4 == 0, "a lane reads its B/C entries 4 at a time");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x on the special-function unit: exp(dt * A) is ex2(dt * A * log2 e),
// with A scaled by log2 e once at load.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jax.nn.softplus: logaddexp(x, 0), computed without overflow, on the
// special-function units: log1p(e) for e = exp(-|x|) in (0, 1] is its series
// below 2^-10 (relative error below e^2 / 3) and log(1 + e) above, where
// __logf's absolute error (2^-21.4) is below 4e-4 of the result.
__device__ __forceinline__ float softplus(float x) {
  const float e = __expf(-fabsf(x));
  return fmaxf(x, 0.f) + (e < 0x1p-10f ? e * fmaf(-0.5f, e, 1.f) : __logf(1.f + e));
}

__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// E consecutive entries of a staged B or C row, as fp32.
template <int E>
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
    out[i + 2] = v.z;
    out[i + 3] = v.w;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[i] = lo.x;
    out[i + 1] = lo.y;
    out[i + 2] = hi.x;
    out[i + 3] = hi.y;
  }
}

// Start copying chunk [t0, t0 + 16) of the row's B and C, (L, 16) each and
// contiguous at B_row and C_row, into dst[0] and dst[1]; steps past L are
// filled with zeros. A chunk is 16 * 16 elements, whole 16-byte pieces, and
// a piece lies wholly inside or outside L.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_bc(T (*dst)[kChunk * kN], const T* B_row, const T* C_row,
                                         int t0, int L) {
  constexpr int kPieces = kChunk * kN * (int)sizeof(T) / 16;  // a matrix
  constexpr int kPer = 16 / (int)sizeof(T);                   // elements a piece
  const int valid = (min(L - t0, kChunk) * kN) / kPer;         // pieces inside L
#pragma unroll
  for (int i = threadIdx.x; i < 2 * kPieces; i += kThreads) {
    const int m = i / kPieces, p = i % kPieces;
    const T* src = (m == 0 ? B_row : C_row) + (int64_t)t0 * kN;
    cp_async16(&dst[m][p * kPer], src + (p < valid ? p * kPer : 0), p < valid ? 16 : 0);
  }
  cp_async_commit();
}

}  // namespace ss
