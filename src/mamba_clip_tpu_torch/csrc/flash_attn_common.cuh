// Shared by flash_attn_fwd.cu and flash_attn_bwd.cu: the tile geometry,
// the helpers of the fp32 CUDA-core bodies and the tensor-core helpers of the
// bf16 and fp16 bodies.
//
// The fp32 bodies (the forward and the two backward kernels): a row (a query
// row in the forward and the dq kernel, a key row in the dk/dv kernel)
// belongs to HD/32 neighbouring lanes, each holding 32 of its dims in
// registers as 8 float4 chunks; lane g of a row owns the chunks g,
// g + HD/32, ... of the head dim, so the lanes of a warp read neighbouring
// shared-memory banks and every row of the warp the same words (broadcast).
// A dot product over the head dim is each lane's partial sum joined by
// shuffles (reduce_row). The three take the products in one order, so the
// fp32 backward recomputes the fp32 forward's scores bit for bit.
//
// The tensor-core bodies run every product on the tensor cores (mma.sync
// m16n8k16, bf16 or fp16 in, fp32 accumulators) over tiles staged in shared
// memory by cp.async; a warp owns 16 rows, and the fragments are read by
// ldmatrix. Each is a template on its element type E (__nv_bfloat16 or
// __half): the two types share the instruction's shape, the fragment
// layouts and every address, and differ only in the mma's input type and
// in how floats round into a 32-bit word of two elements (Tc<E>). The
// helpers below stage rows, give each lane its ldmatrix address for the
// three ways an operand is read, and write a warp's accumulator tile out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// ---- tensor-core helpers (the bf16 and fp16 bodies) ----------------------

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

// d += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), both bf16 or
// both fp16, d 16x8 fp32. With g = lane/4 and c = 2(lane%4): d[0], d[1] are
// row g, columns c, c+1; d[2], d[3] row g+8. a[0] holds row g, columns c,
// c+1; a[1] row g+8; a[2], a[3] the same at columns c+8, c+9. b0 holds rows
// c, c+1 of column g; b1 rows c+8, c+9.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16_16816(float (&d)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (fp16) in one 32-bit word, lo in the low half
// (the lower column of an mma fragment). fp16 rounds a float beyond its
// range to inf, and NaN stays NaN.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two floats as two terms each: hi = E(x), lo = E(x - hi), so that hi + lo
// carries x to about 2^-16 of its size in bf16 (2^-22 in fp16, where x - hi
// is within fp16's range). Packed as pack_* packs.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// fp16's range is where it differs from bf16: an x beyond it (a cotangent
// that carries the fp16 loss scale) rounds to hi = inf, and x - hi would be
// -inf, so that hi + lo gave NaN where a single rounding gives inf. A
// non-finite hi therefore goes alone (lo = 0): inf stays inf and NaN NaN,
// as the plain backward's one rounding of ds passes them on.
__device__ __forceinline__ void split_f16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_f16(isfinite(hf.x) ? x0 - hf.x : 0.f, isfinite(hf.y) ? x1 - hf.y : 0.f);
}

// The element type E of a tensor-core body: its mma, its two-element
// rounding and its two-term split.
template <typename E>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    mma_bf16_16816(d, a, b0, b1);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ void split(float x0, float x1, unsigned& hi,
                                               unsigned& lo) {
    split_bf16(x0, x1, hi, lo);
  }
};

template <>
struct Tc<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    mma_f16_16816(d, a, b0, b1);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  static __device__ __forceinline__ void split(float x0, float x1, unsigned& hi,
                                               unsigned& lo) {
    split_f16(x0, x1, hi, lo);
  }
};

// A key's code in a staged tile: attend, masked (score -1e9), or past T
// (excluded: p = 0, no part of l, ds = 0).
constexpr uint8_t kKeyMasked = 0, kKeyAttend = 1, kKeyPast = 2;

__device__ __forceinline__ uint8_t key_code(const uint8_t* mask, int b, int key, int T_len) {
  if (key >= T_len) return kKeyPast;
  return mask == nullptr || mask[(int64_t)b * T_len + key] ? kKeyAttend : kKeyMasked;
}

// The tensor-core bodies' tiles: a row of HD 2-byte elements staged with one
// 16-byte pad, so the 8 rows an ldmatrix reads start on 8 different groups
// of 4 banks (a 128-byte row, HD 64, would put them all on the same banks).
template <int HD>
struct TcTile {
  static constexpr int kRowChunks = HD / 8;  // 16-byte chunks of a row
  static constexpr int kStride = HD + 8;     // elements a staged row
};

// Rows r0 .. r0 + rows - 1 of one head into dst by 16-byte cp.async, spread
// over THREADS threads; src points at the head's row 0 and rows are
// row_stride elements apart. Rows past T read nothing and are zero-filled,
// so no stale NaN reaches a product through 0 * NaN.
template <int HD, int THREADS, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int64_t row_stride, int r0,
                                           int rows, int T_len, int tid) {
  using L = TcTile<HD>;
  for (int idx = tid; idx < rows * L::kRowChunks; idx += THREADS) {
    const int r = idx / L::kRowChunks, c = idx % L::kRowChunks;
    const bool in = r0 + r < T_len;
    cp_async16(dst + r * L::kStride + 8 * c, src + (int64_t)(in ? r0 + r : 0) * row_stride + 8 * c,
               in ? 16 : 0);
  }
}

// Each lane's ldmatrix_x4 address in a staged tile (stride elements a row)
// whose rows 0..15 and columns 0..15 from `tile` are read:
// - a_addr: as an A fragment of the 16 rows (rows = M, columns = K);
// - b_addr: as the B fragments of two n8 tiles, the rows being the n index
//   (rows 0-7 give r[0], r[1], rows 8-15 r[2], r[3]; columns = K);
// - bt_addr: with ldmatrix.trans, as the B fragments of two n8 tiles whose
//   n index is the column (columns 0-7 give r[0], r[1], 8-15 r[2], r[3]; the
//   rows are K).
template <typename E>
__device__ __forceinline__ const E* a_addr(const E* tile, int stride,
                                                       int lane) {
  return tile + (lane % 16) * stride + 8 * (lane / 16);
}
template <typename E>
__device__ __forceinline__ const E* b_addr(const E* tile, int stride,
                                                       int lane) {
  return tile + (8 * (lane / 16) + lane % 8) * stride + 8 * ((lane / 8) % 2);
}
template <typename E>
__device__ __forceinline__ const E* bt_addr(const E* tile, int stride,
                                                        int lane) {
  return tile + (8 * ((lane / 8) % 2) + lane % 8) * stride + 8 * (lane / 16);
}

// A warp's 16 x HD fp32 accumulator tile (rows g and g + 8 scaled by
// scale[0] and scale[1]) rounded to E once into ws (16 staged rows of
// this warp, nothing else reads them), then written to rows wrow0.. of dst
// (the head's row 0, row_stride apart) with 16-byte stores, rows past T
// left out.
template <int HD, typename E>
__device__ __forceinline__ void store_warp_tile(E* ws, const float (&acc)[HD / 8][4],
                                                const float (&scale)[2], E* dst,
                                                int64_t row_stride, int wrow0, int T_len,
                                                int lane) {
  using L = TcTile<HD>;
  const int g = lane / 4, quad = lane % 4;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = 8 * d + 2 * quad;
    *reinterpret_cast<unsigned*>(ws + g * L::kStride + col) =
        Tc<E>::pack(acc[d][0] * scale[0], acc[d][1] * scale[0]);
    *reinterpret_cast<unsigned*>(ws + (g + 8) * L::kStride + col) =
        Tc<E>::pack(acc[d][2] * scale[1], acc[d][3] * scale[1]);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * L::kRowChunks; idx += 32) {
    const int r = idx / L::kRowChunks, c = idx % L::kRowChunks;
    if (wrow0 + r < T_len)
      *reinterpret_cast<uint4*>(dst + (int64_t)(wrow0 + r) * row_stride + 8 * c) =
          *reinterpret_cast<const uint4*>(ws + r * L::kStride + 8 * c);
  }
}

}  // namespace fa
