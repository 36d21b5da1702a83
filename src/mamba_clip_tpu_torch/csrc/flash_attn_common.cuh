// Shared by flash_attn_fwd.cu and flash_attn_bwd.cu: the tile geometry and
// the 16-byte load, store and FMA helpers of the flash-attention kernels.
//
// A row (a query row in the forward and the dq kernel, a key row in the
// dk/dv kernel) belongs to HD/32 neighbouring lanes, each holding 32 of its
// dims in registers as 8 float4 chunks; lane g of a row owns the chunks g,
// g + HD/32, ... of the head dim, so the lanes of a warp read neighbouring
// shared-memory banks and every row of the warp the same words (broadcast).
// A dot product over the head dim is each lane's partial sum joined by
// shuffles (reduce_row). What training runs, the forward with residuals and
// the two backward kernels, takes the products in one order, so the
// backward recomputes the forward's scores bit for bit, in fp32 and in
// bf16. The bf16 forward without residuals (serving) sums its scores on the
// tensor cores, in the hardware's order; nothing recomputes them.
//
// The tensor-core helpers below (cp.async, ldmatrix, mma.sync) serve that
// bf16 forward; nothing here that the backward uses changed with them.

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

// ---- tensor-core helpers (bf16 forward) ----------------------------------

// 16 bytes global -> shared without the registers; src_bytes 0 reads nothing
// and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i]; lane l holds row l/4, columns
// 2(l%4) and 2(l%4)+1 of each (with .trans, of each matrix transposed).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), d
// 16x8 fp32. With g = lane/4 and c = 2(lane%4): d[0], d[1] are row g,
// columns c, c+1; d[2], d[3] row g+8. a[0] holds row g, columns c, c+1;
// a[1] row g+8; a[2], a[3] the same at columns c+8, c+9. b0 holds rows c,
// c+1 of column g; b1 rows c+8, c+9.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one 32-bit word, lo in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace fa
