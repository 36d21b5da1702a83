// Flash-attention forward (the attention interior of the CLIP towers) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel that mamba_clip_tpu/ops/flash_attn.py reaches
// through JAX's stock Pallas flash attention, _flash_attention_kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py), in its forward,
// non-causal form. Per (batch b, head h, query row t) over the T keys j:
//
//     s_j = (q_t . k_j) * sm_scale          masked keys: s_j = -1e9
//     o_t = sum_j softmax(s)_j v_j
//
// q, k, v are (B, T, H, HD) in float, bf16 or fp16, contiguous, as the
// fused qkv projection gives them; mask is an optional (B, T) byte per key
// (nonzero = attend); o is written once, in q's type, straight into
// (B, T, H*HD). A
// row whose keys are all masked gets the softmax of T equal scores, the
// mean of v over the T keys, as the plain interior gives it, and not NaN.
// For training the kernel also writes the softmax residuals of every row,
// its running max m and its sum l = sum_j exp(s_j - m), as two (B, H, T)
// fp32 arrays (the TPU kernel's save_residuals); the backward kernels of
// flash_attn_bwd.cu recompute p_j = exp(s_j - m) / l from them. They are
// kept apart: for a row with no valid key m = -1e9 and l = T, and
// m + log(l) would round back to -1e9 in fp32. Serving passes null pointers
// and writes nothing but o.
//
// Two bodies share that contract.
//
// The 3xTF32 body (flash_attn_fwd_kernel) runs fp32, with or without the
// residuals, and takes both products on the tensor cores as 3xTF32
// (flash_attn_common.cuh: mma.sync m16n8k8 .tf32, each operand split into
// hi and lo, lo.hi + hi.lo + hi.hi into fp32 accumulators). Plain TF32
// (one term) is off by up to 2^-11 of a product and misses the fp32 gate of
// 5e-4 (tests/test_torch_port_flash_tf32_rounding.py: 4.6e-4 to 7.5e-4 at
// small shapes); three terms carry fp32 to a few ulps. It has the
// tensor-core body's shape below, on fp32 tiles (F32Cfg): one block of 4
// warps per (tile of 64 query rows, head, batch), a warp owning 16 query
// rows whose q fragments it reads once from global memory and keeps raw in
// registers, split once a tile. K and V are staged by cp.async two buffers
// deep in tiles of 32 keys; when a tile lands the block splits it once, hi
// over the raw values and lo into a plane beside them, so that no warp
// splits what another has (splitting in every warp repeats each split 4
// times, and in one-off builds those instructions, not the tensor cores,
// held the first layout: PERF.md, Findings). S = Q . K^T reads K's hi and
// lo fragments by ldmatrix (on fp32 rows it gives the tf32 B fragment as
// it is); the online softmax
// runs on the accumulators as in the tensor-core body; each 8-key
// accumulator of p is split into an A fragment in place, its K index taken
// in the permuted order 2t, 2t + 1 that each lane already holds, and V's hi
// and lo rows are read in the same order by 32-bit loads (ldmatrix.trans
// moves 16-bit elements only), so P . V needs no shuffle. O / l is written
// from the accumulators, a quad 32 bytes of a row. Keys are walked in
// 16-key chunks, so T 197 computes 208 x 208. The fp32 dq body
// (flash_attn_bwd.cu) takes S = Q . K^T from the same splits in the same
// order, so its scores are this body's bit for bit.
//
// The tensor-core body (flash_attn_fwd_tc_kernel) runs bf16 and fp16, one
// instance each, with or without the residuals: training, image_embed,
// text_embed and the no-grad forward of evaluation and of stage 2 (bf16
// under amp, bf16 and pure_bf16; fp16 under fp16 and pure_fp16). After
// FlashAttention-2: one block of
// kWarps warps per (tile of 16 * kWarps query rows, head, batch); a warp
// owns 16 query rows. Its Q fragment is loaded once (ldmatrix) and stays in
// registers for the whole key loop. Per tile of kBlockN keys:
// - S = Q . K^T on the tensor cores (mma.sync m16n8k16, bf16 or fp16 in,
//   fp32 accumulators: 16 x kBlockN a warp), K's fragments by ldmatrix.x4;
// - the online softmax on the accumulators: the scale, -1e9 for a masked
//   key, the row max over the quad of lanes that shares a row (shuffles 1
//   and 2), O and l rescaled once a tile, p = exp(s - m) in fp32;
// - P is rounded to q's type in registers, two neighbouring m16n8 accumulators
//   making one m16k16 A fragment, and O += P . V on the tensor cores with
//   V's fragments by ldmatrix.x4.trans; O stays fp32 in registers.
// l sums the fp32 p. The plain interior rounds the normalised p instead;
// the 2e-2 gate of both types covers either. p lies in [0, 1] and o is a
// convex combination of the rows of v, so fp16's range adds nothing that
// bf16's does not meet: only an inf or NaN in q, k or v makes one in o.
// With the residuals the epilogue also writes each row's m and l (the
// quad's sum), the only difference between training's launch and serving's.
// Staging: K and V go to shared memory in q's type with 16-byte cp.async, two
// buffers deep: tile n+1 is in flight while tile n is consumed. A row of a
// staged tile is padded by 16 bytes (TcTile). A tile's mask bytes are read
// with its copy and stored after the current tile's math, as one code a
// key: attend, masked, or past T.
// The ragged tail: rows are handled in 16-row warp tiles, and a warp whose
// rows all lie past T does no math but takes part in every barrier. Keys
// are walked in 16-key chunks, the mma's depth, so T = 197 computes 208 x
// 208 (the 3xTF32 body too). Keys past T are excluded, not
// masked: their score is -inf, so p is exactly 0 and they never enter l
// (an all-masked row gets l = T, not 208), and their K/V rows in shared
// memory are zero-filled (cp.async with source size 0), so no stale NaN
// reaches O through 0 * NaN. The epilogue rounds O / l to q's type once and
// writes each warp's 16 rows through shared memory (its own rows of the Q
// buffer), so that the stores to o are 16 bytes a thread.
// Block sizes (kWarps, kBlockN, the blocks an SM holds) were chosen by
// measurement at the towers' shapes; PERF.md has the sweep. HD 128 halves
// the key tile, as its O accumulator alone is 64 registers a thread. The
// 3xTF32 body shares the ragged tail's handling: keys past T are -inf,
// their rows zero-filled; rows past T compute on zeros and write nothing.
//
// The TPU kernel's padding of T to 128 and its segment ids are not carried
// over: the ragged tail of T is handled here and the pad mask is one byte a
// key.
//
// What bounds it on an H100. Per launch the work is 4*B*H*T^2*HD FLOPs
// against 4*B*T*H*HD elements moved; at the towers' shapes (T 197 or 256,
// HD 64) that is about 100 FLOPs a byte, under the ~295 at which the bf16
// tensor cores would bound it, so the bytes bound it. In fp32, 3xTF32 takes
// three products a product at the TF32 rate (494.7 TFLOP/s), a third of
// which, 164.9, is 2.46x the fp32 FMA peak: the operations bound it at
// T 256 and tie with the bytes at T 197 (1.497 ms for 12 + 12 launches at
// batch 64, against 3.674 at the FMA rate). It runs at about 20% of that
// bound: per warp and 32-key tile it issues 192 HMMA among the splits of q
// and p, the block's share of the tile's split, the softmax and the address
// arithmetic, and 4 blocks an SM at 127 registers hide only part of each
// chain; wgmma,
// which reads B from shared memory and needs no split in any warp, is the
// next step. The tensor-core body halves the staged bytes and moves the
// products to the tensor cores; at 128 registers a thread an SM holds 4
// blocks, 16 warps, and each warp's tile is a dependent chain (S, the
// shuffles, exp, P . V) that 4 warps a scheduler only partly hide, so it
// runs at about 30% of the bytes bound (PERF.md). wgmma with TMA staging,
// which runs the products asynchronously, is the next step.

#include <type_traits>

#include "flash_attn_common.cuh"

namespace {

using namespace fa;

// The 3xTF32 body's block geometry: 4 warps of 16 query rows and key tiles
// of 32, chosen in one-off builds timed at the towers' shapes (PERF.md,
// Findings). A block stages its K and V tiles twice over (cp.async double
// buffer) and keeps the lo planes of the current tile beside them: 52,288 B
// of shared memory at HD 64, so an SM holds 4 blocks at 127 registers a
// thread.
template <int HD>
struct F32Cfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockM = 16 * kWarps;  // query rows a block
  static constexpr int kBlockN = 32;           // keys a tile
  static constexpr int kStride = TcTile<HD, float>::kStride;
  static constexpr int kTile = kBlockN * kStride;
  // two K and two V tiles (raw, then hi), the current tile's K and V lo
  // planes, two tiles' key codes
  static constexpr int kSmemBytes = 6 * kTile * 4 + 2 * kBlockN;
  static_assert(kBlockN % 16 == 0 && kBlockN <= kThreads, "a key tile is 16-key chunks");
};

template <int HD>
__global__ void __launch_bounds__(F32Cfg<HD>::kThreads)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int T_len, int H, float sm_scale) {
  using C = F32Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [2][kBlockN][kStride], raw then hi
  float* v_s = k_s + 2 * C::kTile;              // [2][kBlockN][kStride], raw then hi
  float* kl_s = v_s + 2 * C::kTile;             // [kBlockN][kStride]: K's lo plane
  float* vl_s = kl_s + C::kTile;                // [kBlockN][kStride]: V's lo plane
  uint8_t* code_s = reinterpret_cast<uint8_t*>(vl_s + C::kTile);  // [2][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;  // the fragment's row and column
  const int h = blockIdx.y, b = blockIdx.z;
  const int wrow0 = blockIdx.x * C::kBlockM + 16 * warp;  // this warp's first query row
  const bool active = wrow0 < T_len;        // the same in every lane of the warp
  // element (b, t, h, 0) of q, k, v and o: rows of H*HD elements
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int n_tiles = (T_len + C::kBlockN - 1) / C::kBlockN;

  auto stage = [&](float* dst, const float* src, int r0, int rows) {
    stage_rows<HD, C::kThreads>(dst, src + head0, row_stride, r0, rows, T_len, tid);
  };

  stage(k_s, k, 0, C::kBlockN);
  stage(v_s, v, 0, C::kBlockN);
  cp_async_commit();
  if (tid < C::kBlockN) code_s[tid] = key_code(mask, b, tid, T_len);

  // this warp's 16 rows of q as fp32 A fragments, read once from global
  // memory (a quad reads 32 bytes of a row); rows past T are zeros
  unsigned qf[HD / 8][4];
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = wrow0 + g + 8 * (i & 1);
      qf[kk][i] = t < T_len
          ? __float_as_uint(q[head0 + t * row_stride + 8 * kk + quad + 4 * (i >> 1)]) : 0u;
    }
  float acc[HD / 8][4];            // O, 16 x HD a warp, fp32
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};     // this lane's part of l; the quad's sum at the end
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    float* ks = k_s + buf * C::kTile;
    float* vs = v_s + buf * C::kTile;
    uint8_t next_code = kKeyPast;
    if (n + 1 < n_tiles) {  // tile n+1 into the other buffer, consumed at n-1
      const int n1 = (n + 1) * C::kBlockN;
      stage(k_s + (buf ^ 1) * C::kTile, k, n1, C::kBlockN);
      stage(v_s + (buf ^ 1) * C::kTile, v, n1, C::kBlockN);
      cp_async_commit();
      if (tid < C::kBlockN) next_code = key_code(mask, b, n1 + tid, T_len);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile n is there for every thread
    // split once a block: hi over the raw tile, lo into the planes
    split_tile<HD, C::kThreads>(ks, kl_s, C::kBlockN, tid);
    split_tile<HD, C::kThreads>(vs, vl_s, C::kBlockN, tid);
    __syncthreads();

    if (active) {
      const int nk = min(C::kBlockN, T_len - n * C::kBlockN);
      const int chunks = (nk + 15) / 16;  // 16-key chunks that hold a key before T
      const uint8_t* code = code_s + buf * C::kBlockN;

      // S = Q . K^T in 3xTF32: chunk c is the accumulators s[2c] and
      // s[2c + 1]; q split once a tile and 8 dims, K's hi and lo fragments
      // read by ldmatrix
      float s[C::kBlockN / 8][4];
#pragma unroll
      for (int t8 = 0; t8 < C::kBlockN / 8; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t8][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        unsigned qh[4], ql[4];
        split_tf32(qf[kk], qh, ql);
#pragma unroll
        for (int c = 0; c < C::kBlockN / 16; ++c) {
          if (c < chunks) {
            const int off = b_addr(ks + 16 * c * C::kStride, C::kStride, lane) - ks + 8 * kk;
            unsigned kh[4], kl[4];
            ldmatrix_x4(kh, ks + off);
            ldmatrix_x4(kl, kl_s + off);
            mma_3xtf32(s[2 * c], qh, ql, kh[0], kh[1], kl[0], kl[1]);
            mma_3xtf32(s[2 * c + 1], qh, ql, kh[2], kh[3], kl[2], kl[3]);
          }
        }
      }

      // scale and mask; the row max over the tile and the quad
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int t8 = 0; t8 < C::kBlockN / 8; ++t8) {
        if (t8 / 2 < chunks) {
          const int j = 8 * t8 + 2 * quad;  // columns j, j + 1 of rows g, g + 8
          const unsigned two = *reinterpret_cast<const uint16_t*>(code + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned cd = (two >> (8 * (e & 1))) & 0xffu;
            const float sc = cd == kKeyAttend ? s[t8][e] * sm_scale
                             : cd == kKeyMasked ? kMasked : -INFINITY;
            s[t8][e] = sc;
            m_new[e / 2] = fmaxf(m_new[e / 2], sc);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(kFull, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(kFull, m_new[r], 2));
        corr[r] = __expf(m_run[r] - m_new[r]);  // 0 at the first tile: m_run = -inf
        m_run[r] = m_new[r];
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }

      // p = exp(s - m) (exactly 0 past T), l += p, then O += P . V in
      // 3xTF32: each 8-key accumulator is split into an A fragment in place,
      // V's hi and lo rows read in the same permuted key order
#pragma unroll
      for (int t8 = 0; t8 < C::kBlockN / 8; ++t8) {
        if (t8 / 2 < chunks) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[t8][e] = __expf(s[t8][e] - m_run[e / 2]);
            l_run[e / 2] += s[t8][e];
          }
          unsigned ph[4], pl[4];
          acc_to_a_split(s[t8], ph, pl);
          const int r = (8 * t8 + 2 * quad) * C::kStride + g;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            unsigned vh[2], vl[2];
            b_perm(vs + r + 8 * d, C::kStride, vh);
            b_perm(vl_s + r + 8 * d, C::kStride, vl);
            mma_3xtf32(acc[d], ph, pl, vh[0], vh[1], vl[0], vl[1]);
          }
        }
      }
    }

    if (tid < C::kBlockN && n + 1 < n_tiles) code_s[(buf ^ 1) * C::kBlockN + tid] = next_code;
    __syncthreads();  // tile n consumed before iteration n+1 refills its buffer
  }

  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    inv[r] = 1.f / l_run[r];  // l >= 1: the row's max key adds exp(0)
  }
  if (m_out != nullptr && quad == 0) {  // training: the residuals of rows g, g + 8
    const int64_t stat0 = ((int64_t)b * H + h) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = wrow0 + g + 8 * r;
      if (t < T_len) {
        m_out[stat0 + t] = m_run[r];
        l_out[stat0 + t] = l_run[r];
      }
    }
  }
  // O / l straight from the accumulators: a quad writes 32 bytes of a row
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = wrow0 + g + 8 * r;
      if (t < T_len)
        *reinterpret_cast<float2*>(o + head0 + t * row_stride + 8 * d + 2 * quad) =
            make_float2(acc[d][2 * r] * inv[r], acc[d][2 * r + 1] * inv[r]);
    }
}

// The tensor-core body's block geometry (both types: an element is 2 bytes
// in each), chosen by measurement in bf16 at the towers' shapes (PERF.md
// has the sweep): 4 warps, key tiles of 64 (32 at HD 128), and at HD 32 and
// 64 at least 4 blocks an SM, which caps the registers.
// Without the cap ptxas took 136 registers at HD 64, so an SM held 3 blocks
// of 4 warps and not 4, and the launch at T 197 ran 14% slower.
template <int HD>
struct TcCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockM = 16 * kWarps;                         // query rows a block
  static constexpr int kBlockN = HD <= 64 ? 64 : 32;                 // keys a tile
  static constexpr int kMinBlocks = HD <= 64 ? 4 : 1;                // blocks an SM
  static constexpr int kStride = TcTile<HD>::kStride;
  static constexpr int kTile = kBlockN * kStride;
  // Q (later each warp's O), two K and two V tiles, two tiles' key codes
  static constexpr int kSmemBytes = (kBlockM + 4 * kBlockN) * kStride * 2 + 2 * kBlockN;
  static_assert(kBlockN % 16 == 0 && kBlockN <= kThreads, "a key tile is 16-key chunks");
};

template <typename E, int HD>
__global__ void __launch_bounds__(TcCfg<HD>::kThreads, TcCfg<HD>::kMinBlocks)
flash_attn_fwd_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const uint8_t* __restrict__ mask,
                         E* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out, int T_len, int H, float sm_scale) {
  using C = TcCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem);      // [kBlockM][kStride]
  E* k_s = q_s + C::kBlockM * C::kStride;   // [2][kBlockN][kStride]
  E* v_s = k_s + 2 * C::kTile;              // [2][kBlockN][kStride]
  uint8_t* code_s = reinterpret_cast<uint8_t*>(v_s + 2 * C::kTile);  // [2][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;  // the fragment's row and column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * C::kBlockM;
  const int wrow0 = row0 + 16 * warp;       // this warp's first query row
  const bool active = wrow0 < T_len;        // the same in every lane of the warp
  // element (b, t, h, 0) of q, k, v and o: rows of H*HD elements
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int n_tiles = (T_len + C::kBlockN - 1) / C::kBlockN;

  auto stage = [&](E* dst, const E* src, int r0, int rows) {
    stage_rows<HD, C::kThreads>(dst, src + head0, row_stride, r0, rows, T_len, tid);
  };

  stage(q_s, q, row0, C::kBlockM);
  stage(k_s, k, 0, C::kBlockN);
  stage(v_s, v, 0, C::kBlockN);
  cp_async_commit();
  if (tid < C::kBlockN) code_s[tid] = key_code(mask, b, tid, T_len);

  unsigned qf[HD / 16][4];          // this warp's 16 rows of q, A fragments
  float acc[HD / 8][4];             // O, 16 x HD a warp, fp32
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};      // this lane's part of l; the quad's sum at the end
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    uint8_t next_code = kKeyPast;
    if (n + 1 < n_tiles) {  // tile n+1 into the other buffer, consumed at n-1
      const int n1 = (n + 1) * C::kBlockN;
      stage(k_s + (buf ^ 1) * C::kTile, k, n1, C::kBlockN);
      stage(v_s + (buf ^ 1) * C::kTile, v, n1, C::kBlockN);
      cp_async_commit();
      if (tid < C::kBlockN) next_code = key_code(mask, b, n1 + tid, T_len);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile n (and at n = 0 the Q tile) is there for every thread

    if (active) {
      if (n == 0) {
        const E* qw = a_addr(q_s + 16 * warp * C::kStride, C::kStride, lane);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], qw + 16 * kk);
      }
      const int nk = min(C::kBlockN, T_len - n * C::kBlockN);
      const int chunks = (nk + 15) / 16;  // 16-key chunks that hold a key before T
      const E* ks = k_s + buf * C::kTile;
      const E* vs = v_s + buf * C::kTile;
      const uint8_t* code = code_s + buf * C::kBlockN;

      // S = Q . K^T: chunk c is the accumulators s[2c] and s[2c + 1]
      float s[C::kBlockN / 8][4];
#pragma unroll
      for (int c = 0; c < C::kBlockN / 16; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * c][e] = s[2 * c + 1][e] = 0.f;
        if (c < chunks) {
          const E* kr = b_addr(ks + 16 * c * C::kStride, C::kStride, lane);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            unsigned kb[4];
            ldmatrix_x4(kb, kr + 16 * kk);
            Tc<E>::mma(s[2 * c], qf[kk], kb[0], kb[1]);
            Tc<E>::mma(s[2 * c + 1], qf[kk], kb[2], kb[3]);
          }
        }
      }

      // scale and mask; the row max over the tile and the quad
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int t8 = 0; t8 < C::kBlockN / 8; ++t8) {
        if (t8 / 2 < chunks) {
          const int j = 8 * t8 + 2 * quad;  // columns j, j + 1 of rows g, g + 8
          const unsigned two = *reinterpret_cast<const uint16_t*>(code + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned cd = (two >> (8 * (e & 1))) & 0xffu;
            const float sc = cd == kKeyAttend ? s[t8][e] * sm_scale
                             : cd == kKeyMasked ? kMasked : -INFINITY;
            s[t8][e] = sc;
            m_new[e / 2] = fmaxf(m_new[e / 2], sc);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(kFull, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(kFull, m_new[r], 2));
        corr[r] = __expf(m_run[r] - m_new[r]);  // 0 at the first tile: m_run = -inf
        m_run[r] = m_new[r];
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }

      // p = exp(s - m) (exactly 0 past T), l += p, then O += P . V
#pragma unroll
      for (int c = 0; c < C::kBlockN / 16; ++c) {
        if (c < chunks) {
          unsigned pa[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* st = s[2 * c + half];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              st[e] = __expf(st[e] - m_run[e / 2]);
              l_run[e / 2] += st[e];
            }
            pa[2 * half] = Tc<E>::pack(st[0], st[1]);      // row g
            pa[2 * half + 1] = Tc<E>::pack(st[2], st[3]);  // row g + 8
          }
          const E* vr = bt_addr(vs + 16 * c * C::kStride, C::kStride, lane);
#pragma unroll
          for (int d2 = 0; d2 < HD / 16; ++d2) {
            unsigned vb[4];
            ldmatrix_x4_trans(vb, vr + 16 * d2);
            Tc<E>::mma(acc[2 * d2], pa, vb[0], vb[1]);
            Tc<E>::mma(acc[2 * d2 + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }

    if (tid < C::kBlockN && n + 1 < n_tiles) code_s[(buf ^ 1) * C::kBlockN + tid] = next_code;
    __syncthreads();  // tile n consumed before iteration n+1 refills its buffer
  }

  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    inv[r] = 1.f / l_run[r];  // l >= 1: the row's max key adds exp(0)
  }
  if (m_out != nullptr && quad == 0) {  // training: the residuals of rows g, g + 8
    const int64_t stat0 = ((int64_t)b * H + h) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = wrow0 + g + 8 * r;
      if (t < T_len) {
        m_out[stat0 + t] = m_run[r];
        l_out[stat0 + t] = l_run[r];
      }
    }
  }
  // O / l in q's type through this warp's rows of the Q buffer
  store_warp_tile<HD>(q_s + 16 * warp * C::kStride, acc, inv, o + head0, row_stride, wrow0,
                      T_len, lane);
}

template <typename E, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* mask, void* o,
                      float* m_out, float* l_out, int batch, int T_len, int H, float sm_scale,
                      cudaStream_t stream) {
  using C = TcCfg<HD>;
  if (C::kSmemBytes > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_fwd_tc_kernel<E, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((T_len + C::kBlockM - 1) / C::kBlockM), (unsigned)H,
                  (unsigned)batch);
  flash_attn_fwd_tc_kernel<E, HD><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const uint8_t*>(mask), static_cast<E*>(o), m_out, l_out, T_len, H, sm_scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* mask, void* o,
                      float* m_out, float* l_out, int batch, int T_len, int H, float sm_scale,
                      cudaStream_t stream) {
  // bf16 and fp16 on the tensor cores' bf16/fp16 body, fp32 in 3xTF32
  if constexpr (!std::is_same<T, float>::value) {
    return launch_tc<T, HD>(q, k, v, mask, o, m_out, l_out, batch, T_len, H, sm_scale, stream);
  } else {
    using C = F32Cfg<HD>;
    if (C::kSmemBytes > 48 * 1024) {  // above 48 KB only after opting in
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          C::kSmemBytes);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((unsigned)((T_len + C::kBlockM - 1) / C::kBlockM), (unsigned)H,
                    (unsigned)batch);
    flash_attn_fwd_kernel<HD><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
        static_cast<float*>(o), m_out, l_out, T_len, H, sm_scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* m_out, void* l_out, int batch, int T_len, int H, int HD,
                   float sm_scale, cudaStream_t stream) {
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  switch (HD) {
    case 32:
      return launch_hd<T, 32>(q, k, v, mask, o, m, l, batch, T_len, H, sm_scale, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, mask, o, m, l, batch, T_len, H, sm_scale, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, mask, o, m, l, batch, T_len, H, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// m_out and l_out: (B, H, T) fp32 each, or both null.
extern "C" int flash_attn_fwd_f32(const void* q, const void* k, const void* v, const void* mask,
                                  void* o, void* m_out, void* l_out, int batch, int T_len,
                                  int H, int HD, float sm_scale, void* stream) {
  return (int)launch<float>(q, k, v, mask, o, m_out, l_out, batch, T_len, H, HD, sm_scale,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, void* m_out, void* l_out,
                                   int batch, int T_len, int H, int HD, float sm_scale,
                                   void* stream) {
  return (int)launch<__nv_bfloat16>(q, k, v, mask, o, m_out, l_out, batch, T_len, H, HD,
                                    sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attn_fwd_f16(const void* q, const void* k, const void* v,
                                  const void* mask, void* o, void* m_out, void* l_out,
                                  int batch, int T_len, int H, int HD, float sm_scale,
                                  void* stream) {
  return (int)launch<__half>(q, k, v, mask, o, m_out, l_out, batch, T_len, H, HD, sm_scale,
                             static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block of the tensor-core body (either type) takes
// at head dim HD, or -1.
extern "C" int flash_attn_fwd_tc_smem_bytes(int HD) {
  switch (HD) {
    case 32: return TcCfg<32>::kSmemBytes;
    case 64: return TcCfg<64>::kSmemBytes;
    case 128: return TcCfg<128>::kSmemBytes;
    default: return -1;
  }
}

// Dynamic shared memory a block of the fp32 (3xTF32) body takes at head dim
// HD, or -1.
extern "C" int flash_attn_fwd_f32_smem_bytes(int HD) {
  switch (HD) {
    case 32: return F32Cfg<32>::kSmemBytes;
    case 64: return F32Cfg<64>::kSmemBytes;
    case 128: return F32Cfg<128>::kSmemBytes;
    default: return -1;
  }
}
