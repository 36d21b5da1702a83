// Shared by flash_attn_fwd.cu and flash_attn_bwd.cu: the tile geometry,
// the 3xTF32 helpers of the three fp32 bodies and the tensor-core helpers of
// the bf16 and fp16 bodies.
//
// The fp32 bodies (the forward, dk/dv and dq) take their products on the
// tensor cores as 3xTF32 (mma.sync m16n8k8 .tf32, fp32 accumulators): each
// fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded
// to nearest with ties away from zero (cvt.rna's rounding, tf32_rna), and a
// product is lo.hi + hi.lo + hi.hi, the small terms first, into one
// accumulator. hi + lo carries x to about 2^-22 of its size, so the products
// are fp32's to a few ulps; the lo.lo term (2^-22 of the product) is
// dropped. The other side's tiles (K and V in the forward and dq, Q and dO
// in dk/dv), and dq's own dO rows, are staged as fp32 with a 16-byte pad a
// row and split once a block, hi over the raw values and lo into a plane
// beside them (split_tile), so no warp splits what another has; the other
// fragments a body owns (q, or K and V) and P, dS are split in registers. The
// forward and dq take S = Q K^T in one order (the same products into each
// accumulator, k-step by k-step), so dq's scores are the forward's bit for
// bit; dk/dv takes S^T = K Q^T with the operands swapped, so its scores
// differ from the forward's by fp32 ulps. Every recomputed score is put
// against the forward's m and l.
//
// The tensor-core bodies run every product on the tensor cores (mma.sync
// m16n8k16, bf16 or fp16 in, fp32 accumulators) over tiles staged in shared
// memory by cp.async; a warp owns 16 rows, and the fragments are read by
// ldmatrix. Each is a template on its element type E (__nv_bfloat16 or
// __half): the two types share the instruction's shape, the fragment
// layouts and every address, and differ only in the mma's input type and
// in how floats round into a 32-bit word of two elements (Tc<E>). The
// helpers below stage rows, give each lane its ldmatrix address for the
// three ways an operand is read, and write a warp's accumulator tile out;
// the staging, the two non-transposed addresses and the write-out serve
// the 3xTF32 bodies' fp32 tiles too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace fa {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e9f;  // the plain interior's score of a masked key

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

// The staged tiles: a row of HD elements of E (2 bytes in the tensor-core
// bodies, fp32 in the 3xTF32 bodies) staged with one 16-byte pad, so the 8
// rows an ldmatrix reads start on 8 different groups of 4 banks (a 128-byte
// row, HD 64 in bf16, would put them all on the same banks), and the 32-bit
// reads of the 3xTF32 bodies' permuted B fragments (rows 2 quad and
// 2 quad + 1, column g) fall on 32 different banks.
template <int HD, typename E = __nv_bfloat16>
struct TcTile {
  static constexpr int kPerChunk = 16 / (int)sizeof(E);  // elements a 16-byte chunk
  static constexpr int kRowChunks = HD / kPerChunk;      // 16-byte chunks of a row
  static constexpr int kStride = HD + kPerChunk;         // elements a staged row
};

// Rows r0 .. r0 + rows - 1 of one head into dst by 16-byte cp.async, spread
// over THREADS threads; src points at the head's row 0 and rows are
// row_stride elements apart. Rows past T read nothing and are zero-filled,
// so no stale NaN reaches a product through 0 * NaN.
template <int HD, int THREADS, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int64_t row_stride, int r0,
                                           int rows, int T_len, int tid) {
  using L = TcTile<HD, E>;
  for (int idx = tid; idx < rows * L::kRowChunks; idx += THREADS) {
    const int r = idx / L::kRowChunks, c = L::kPerChunk * (idx % L::kRowChunks);
    const bool in = r0 + r < T_len;
    cp_async16(dst + r * L::kStride + c, src + (int64_t)(in ? r0 + r : 0) * row_stride + c,
               in ? 16 : 0);
  }
}

// Each lane's ldmatrix_x4 address in a staged tile (stride elements a row)
// whose rows 0..15 and the first 32 bytes of columns from `tile` are read
// (columns 0..15 of a 2-byte E, 0..7 of fp32):
// - a_addr: as an A fragment of the 16 rows (rows = M, columns = K);
// - b_addr: as the B fragments of two n8 tiles, the rows being the n index
//   (rows 0-7 give r[0], r[1], rows 8-15 r[2], r[3]; columns = K);
// - bt_addr: with ldmatrix.trans, as the B fragments of two n8 tiles whose
//   n index is the column (columns 0-7 give r[0], r[1], 8-15 r[2], r[3]; the
//   rows are K); 2-byte E only.
// ldmatrix moves b16 pairs, so on fp32 (an 8 x 4 tile a matrix) lane l gets
// row l/4, word l%4 of each: m16n8k8's tf32 A fragment (a_addr) and its B
// fragments (b_addr) as they are.
template <typename E>
__device__ __forceinline__ const E* a_addr(const E* tile, int stride,
                                                       int lane) {
  return tile + (lane % 16) * stride + TcTile<8, E>::kPerChunk * (lane / 16);
}
template <typename E>
__device__ __forceinline__ const E* b_addr(const E* tile, int stride,
                                                       int lane) {
  return tile + (8 * (lane / 16) + lane % 8) * stride + TcTile<8, E>::kPerChunk * ((lane / 8) % 2);
}
template <typename E>
__device__ __forceinline__ const E* bt_addr(const E* tile, int stride,
                                                        int lane) {
  return tile + (8 * ((lane / 8) % 2) + lane % 8) * stride + 8 * (lane / 16);
}

// A warp's 16 x HD fp32 accumulator tile (rows g and g + 8 scaled by
// scale[0] and scale[1]) rounded to E once (fp32: kept) into ws (16 staged
// rows of this warp, nothing else reads them), then written to rows wrow0..
// of dst (the head's row 0, row_stride apart) with 16-byte stores, rows past
// T left out.
template <int HD, typename E>
__device__ __forceinline__ void store_warp_tile(E* ws, const float (&acc)[HD / 8][4],
                                                const float (&scale)[2], E* dst,
                                                int64_t row_stride, int wrow0, int T_len,
                                                int lane) {
  using L = TcTile<HD, E>;
  const int g = lane / 4, quad = lane % 4;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = 8 * d + 2 * quad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = acc[d][2 * r] * scale[r], x1 = acc[d][2 * r + 1] * scale[r];
      E* w = ws + (g + 8 * r) * L::kStride + col;
      if constexpr (std::is_same<E, float>::value)
        *reinterpret_cast<float2*>(w) = make_float2(x0, x1);
      else
        *reinterpret_cast<unsigned*>(w) = Tc<E>::pack(x0, x1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * L::kRowChunks; idx += 32) {
    const int r = idx / L::kRowChunks, c = L::kPerChunk * (idx % L::kRowChunks);
    if (wrow0 + r < T_len)
      *reinterpret_cast<uint4*>(dst + (int64_t)(wrow0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(ws + r * L::kStride + c);
  }
}

// ---- 3xTF32 helpers (the three fp32 bodies) -------------------------------

// x rounded to tf32 (10 explicit mantissa bits, the low 13 bits zero),
// nearest with ties away from zero, as cvt.rna.tf32.f32 rounds: the bits
// (b + 0x1000) & ~0x1fff of a finite x (a value within half a tf32 ulp of
// FLT_MAX rounds to inf); inf and NaN are kept. Written out as integer ops:
// ptxas expands cvt.rna.tf32.f32 into the same add and mask with a test of
// its own on every call, lo's too, and in a one-off build of the forward
// that form cost it registers enough to lose a block an SM (PERF.md, Findings).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  const unsigned b = __float_as_uint(x);
  return isfinite(x) ? (b + 0x1000u) & 0xffffe000u : b;
}

// x as two tf32 terms, hi = tf32(x) and lo = tf32(x - hi); x - hi is exact
// in fp32, and hi + lo carries x to about 2^-22 of its size. x - hi is
// finite whenever x is, so lo is rounded without the test; for an inf or
// NaN x, hi carries it.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const unsigned (&x)[N], unsigned (&hi)[N],
                                           unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += a . b on the tensor cores: a 16x8 (row), b 8x8 (col), both tf32, d
// 16x8 fp32. With g = lane/4 and t = lane%4: a[0] holds row g, column t;
// a[1] row g+8, column t; a[2], a[3] the same at column t+4. b0 holds row t
// of column g, b1 row t+4. d as in mma_bf16_16816 (row g: columns 2t, 2t+1).
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, in the one order every product of the three bodies
// takes: a_lo b_hi, a_hi b_lo, then a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32_1688(d, al, bh0, bh1);
  mma_tf32_1688(d, ah, bl0, bl1);
  mma_tf32_1688(d, ah, bh0, bh1);
}

// Rows 0 .. rows - 1 of a staged fp32 tile split in place, 16 bytes a step
// over THREADS threads: hi over the raw values, lo into lo_tile (the same
// layout).
template <int HD, int THREADS>
__device__ __forceinline__ void split_tile(float* tile, float* lo_tile, int rows, int tid) {
  using L = TcTile<HD, float>;
  for (int idx = tid; idx < rows * L::kRowChunks; idx += THREADS) {
    const int off = (idx / L::kRowChunks) * L::kStride + 4 * (idx % L::kRowChunks);
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(tile + off) = hi;
    *reinterpret_cast<uint4*>(lo_tile + off) = lo;
  }
}

// An m16n8 accumulator (P or P^T, dS or dS^T) as the split A fragment of the next
// product, whose K index is the accumulator's 8 columns taken in the
// permuted order: A's column t is the accumulator's column 2t, t + 4 is
// 2t + 1. Each lane already holds exactly those, so no shuffle is needed;
// the B operand's rows are read in the same order (b_perm).
__device__ __forceinline__ void acc_to_a_split(const float (&c)[4], unsigned (&hi)[4],
                                               unsigned (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);  // row g, column t    <- column 2t
  split_tf32(c[2], hi[1], lo[1]);  // row g + 8, column t
  split_tf32(c[1], hi[2], lo[2]);  // row g, column t + 4 <- column 2t + 1
  split_tf32(c[3], hi[3], lo[3]);  // row g + 8, column t + 4
}

// The B fragment of a staged fp32 tile (a hi or a lo plane) whose rows are
// the K index in acc_to_a_split's order and whose columns are N: `p` is the
// tile at row 2t (t = lane % 4) of the 8 rows and column g of the n8 tile,
// b[0] that row and b[1] the next (plain 32-bit loads: ldmatrix.trans moves
// 16-bit elements only).
__device__ __forceinline__ void b_perm(const float* p, int stride, unsigned (&b)[2]) {
  b[0] = __float_as_uint(p[0]);
  b[1] = __float_as_uint(p[stride]);
}

}  // namespace fa
