// Flash-attention backward (the gradient of the attention interior of the
// CLIP towers) for Hopper (sm_90a): the dk/dv kernel and the dq kernel.
//
// Replaces the two TPU kernels that the backward of JAX's stock Pallas flash
// attention runs (jax/experimental/pallas/ops/tpu/flash_attention.py),
// _flash_attention_dkv_kernel and _flash_attention_dq_kernel, reached from
// mamba_clip_tpu/ops/flash_attn.py, in their non-causal form. With the
// forward's residuals m and l of every query row t (flash_attn_fwd.cu) and
// di_t = sum_d o_t[d] * do_t[d], per (batch b, head h):
//
//     s_tj  = (q_t . k_j) * sm_scale        masked keys: s_tj = -1e9
//     p_tj  = exp(s_tj - m_t) / l_t         (the forward's probabilities)
//     dv_j  = sum_t p_tj * do_t
//     ds_tj = p_tj * (do_t . v_j - di_t) * sm_scale     masked keys: 0
//     dk_j  = sum_t ds_tj * q_t
//     dq_t  = sum_j ds_tj * k_j
//
// q, k, v and do are (B, T, H, HD) in float, bf16 or fp16, contiguous;
// mask is an optional (B, T) byte per key (nonzero = attend); m, l and di
// are (B, H, T) fp32; dq, dk, dv are written once, in q's type, as
// (B, T, H, HD). The mask
// covers keys only: a padded token as a query attends the valid keys and
// adds to their dk and dv. A masked key's score is the constant -1e9, so no
// gradient flows through it to q or k (ds = 0), as in the plain interior's
// masked_fill; a row with some valid key gives a masked key p = exp(-1e9 - m)
// = 0 exactly, so nothing reaches its dv either, while a row with no valid
// key has m = -1e9 and l = T, gives every key p = 1/T, and so adds do_t / T
// to every dv_j, as the plain backward does.
//
// Design. Two kernels, as on the TPU, so that neither needs atomics and two
// runs give the same bits: dk/dv, one block per (tile of 64 key rows, head,
// batch) walking the query tiles, and dq, one block per (tile of 64 query
// rows, head, batch) walking the key tiles. Each has two bodies.
//
// The tensor-core bodies run bf16 (training under amp, bf16 and pure_bf16)
// and fp16 (under fp16 and pure_fp16), a template instance each on the
// element type. A warp owns 16 rows and every product runs mma.sync
// m16n8k16 (bf16 or fp16 in, fp32 accumulators) on tiles that cp.async
// stages two buffers deep with a 16-byte pad a row, as in the forward's
// tensor-core body:
// - dk/dv (flash_attn_bwd_dkv_tc_kernel): the warp's 16 rows of K and V
//   are A fragments in registers, its dK and dV fp32 accumulators too (64
//   registers a thread at HD 64). Per tile of kBlockN query rows the block
//   stages Q, dO and each row's m, 1/l and di; per 16-query chunk a warp
//   takes the transposed products, so that nothing passes through shared
//   memory to be transposed: S^T = K Q^T (Q's B fragments by ldmatrix),
//   P^T = exp(S^T * scale - m_t) / l_t on the accumulators, dV += P^T dO
//   (P^T from the accumulators as an A fragment, dO by ldmatrix.trans),
//   dP^T = V dO^T (dO by ldmatrix), dS^T = P^T (dP^T - di_t) * scale and
//   dK += dS^T Q (Q by ldmatrix.trans).
// - dq (flash_attn_bwd_dq_tc_kernel), the forward's shape: the warp's 16
//   rows of Q and dO are A fragments in registers, m, 1/l and di of its rows
//   too; per staged K/V tile (with one code a key: attend, masked, past T),
//   per 16-key chunk: S = Q K^T, P = exp(S * scale - m) / l, dP = dO V^T,
//   dS = P (dP - di) * scale, dQ += dS K (K by ldmatrix.trans).
// Rounding: q, k, v and do are bf16 (fp16), so every product the tensor
// cores take of them is exact and sums in fp32. Two operands are rounded
// that the fp32 bodies keep: P, to q's type once for dV (p >= 0, as the
// forward's P . V), and dS for dK and dQ. dq and dk are small remainders of
// terms that cancel (sum_j ds_tj is 0 for every row), so one rounding of ds
// is of their size; ds goes in as two terms of q's type, hi = E(ds) and lo = E(ds - hi), two
// mma a product, which carries it to about 2^-16 (2^-22 in fp16). fp16's
// range is where the types part: under the fp16 policies do carries the
// dynamic loss scale (2^16 at the start), so do . v, ds and their
// roundings can leave fp16's range. Nothing is clamped: a score product or
// an accumulator that is inf or NaN stays so, ds that rounds beyond the
// range goes in as hi = inf alone (split_f16), and dq, dk and dv round to
// inf where their sums overflow, so that the train step's finiteness check
// sees them and the scale backs off. The scores are summed by the tensor
// cores: the dq kernel takes S = Q K^T as the forward does, the dk/dv
// kernel S^T = K Q^T with the operands swapped; m and l come from the
// forward, so a recomputed score is only ever put against them.
// The ragged tail of T: rows are handled in 16-row warp tiles, a warp whose
// rows all lie past T does no math but takes part in every barrier, and the
// staged rows past T are zero-filled. A query row past T is given m = +inf
// and 1/l = 0 (so p = 0 exactly), a key past T the code "past" (p = 0,
// ds = 0): T 197 computes 208 x 208, and the last query tile of dk/dv holds
// 5 rows. The epilogues round dQ, dK and dV once and write each warp's rows
// through shared memory with 16-byte stores.
//
// fp32 runs two other bodies, both in 3xTF32 on the tensor cores
// (flash_attn_common.cuh: mma.sync m16n8k8 .tf32, each operand split into hi
// and lo, lo.hi + hi.lo + hi.hi into fp32 accumulators), in the tensor-core
// bodies' shapes on fp32 tiles:
// - dk/dv (flash_attn_bwd_dkv_kernel, F32BwdCfg): a warp owns 16 key rows,
//   takes the four products transposed (S^T = K Q^T, dV += P^T dO,
//   dP^T = V dO^T, dK += dS^T Q) and holds dK and dV in fp32 accumulators
//   (64 registers at HD 64). Its K and V rows stay raw in shared memory and
//   are read by ldmatrix and split every 16-query chunk: split A fragments
//   in registers would take 128 registers more, and lo planes of their own
//   would cost the SM a block. Q and dO are staged by cp.async two buffers
//   deep in tiles of 16 rows and split once a block when a tile lands, hi
//   over the raw values and lo into a plane beside them, so that no warp
//   splits what another has; their B fragments for S^T and dP^T come by
//   ldmatrix, P^T and dS^T are split from the accumulators into A fragments
//   in place, their K index in the permuted order 2t, 2t + 1 that each lane
//   holds, and dO's and Q's hi and lo rows are read in that order by 32-bit
//   loads (ldmatrix.trans moves 16-bit elements only). S^T takes K Q^T with
//   the operands swapped against the forward's Q K^T, so a score differs
//   from the forward's by fp32 ulps, put against its m and l.
// - dq (flash_attn_bwd_dq_kernel, F32DqCfg), the fp32 forward's shape: a
//   warp owns 16 query rows, reads its rows of q once from global memory as
//   fp32 A fragments and keeps them raw in registers, split once a tile, as
//   the forward does, with m, 1/l and di of its rows and dQ's accumulators
//   (32 + 32 registers at HD 64). The block's dO rows are staged once and
//   split into hi and lo planes read by ldmatrix: kept raw in registers too
//   they would take 32 registers more, and an SM would hold fewer blocks;
//   staging q as well would cost the SM a block in shared memory (both were
//   timed: PERF.md, Findings). K and V are staged by cp.async two buffers
//   deep in tiles of 16 keys, with one code a key, and split once a block
//   when a tile lands. Per tile: S = Q K^T from the same splits, k-step by
//   k-step in the same order as the forward, so its scores are the
//   forward's bit for bit; dP = dO V^T; dS = P (dP - di) * scale on the
//   accumulators; dQ += dS K with each 8-key dS accumulator split into an A
//   fragment in place and K's hi and lo rows read in the permuted key order
//   by 32-bit loads, so nothing is shuffled or transposed through shared
//   memory. dQ leaves through the warp's own rows of dO with 16-byte stores.
// The rest is the tensor-core bodies': exact zeros for masked keys, do/T
// into every dv from a row with no valid key, rows and keys past T
// zero-filled and excluded, no atomics.
//
// What bounds them on an H100. dk/dv does 8*B*H*T^2*HD FLOPs and dq
// 6*B*H*T^2*HD (10 and 8 with the two-term dS) against about 6 and 5
// tensors of B*T*H*HD elements moved: at the towers' shapes (T 197, 256; HD
// 64) about 50-150 FLOPs a byte in bf16, under the ~295 at which the bf16
// tensor cores would bound them, so the bytes bound both. Each tile is read
// by ldmatrix two ways, and a warp's chunk is a dependent chain (two
// products, exp, two or three products) that the 4 warps of a block and
// the blocks an SM holds must hide; wgmma with TMA staging is the next step.
// In fp32 the operations bound both: 3xTF32 takes three products a product
// at the TF32 rate, a third of which is 2.46x the fp32 FMA peak (12 + 12
// launches at batch 64: dk/dv 2.986 ms, dq 2.239, against 7.349 and 5.512
// at the FMA rate). The 3xTF32 dk/dv body runs at about a quarter of that:
// per 16-query chunk a warp issues 192 HMMA among the splits of its K and V
// fragments, of P^T and dS^T and its share of the tiles', and 3 blocks an
// SM (shared memory) hide only part of each chain. The dq body issues 144
// HMMA a warp and 16-key tile among the splits of q and dS and its share of
// the tiles', and 3 blocks an SM (registers) hide only part of each chain
// (PERF.md, Findings).

#include <type_traits>

#include "flash_attn_common.cuh"

namespace {

using namespace fa;

// The 3xTF32 dk/dv body's geometry: 4 warps of 16 key rows, query tiles of
// 16, chosen in one-off builds timed at the towers' shapes (PERF.md,
// Findings). The block's K and V rows stay raw, the Q and dO tiles are staged
// twice over (cp.async double buffer) with the lo planes of the current
// tile beside them: 61,312 B of shared memory at HD 64, so an SM holds 3
// blocks.
template <int HD>
struct F32BwdCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockM = 16 * kWarps;     // the block's key rows
  static constexpr int kBlockN = 16;              // query rows a staged tile
  static constexpr int kStride = TcTile<HD, float>::kStride;
  static constexpr int kOwn = kBlockM * kStride;  // K or V of the block's rows
  static constexpr int kTile = kBlockN * kStride; // one staged tile
  // K and V (later dK and dV), two Q and two dO tiles (raw, then hi), the
  // current tile's Q and dO lo planes, two tiles' m, 1/l and di
  static constexpr int kSmemBytes = (2 * kOwn + 6 * kTile) * 4 + 2 * 3 * kBlockN * 4;
  static_assert(kBlockN % 16 == 0 && kBlockN <= kThreads, "a tile is 16-row chunks");
};

template <int HD>
__global__ void __launch_bounds__(F32BwdCfg<HD>::kThreads)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const uint8_t* __restrict__ mask,
                          const float* __restrict__ dout, const float* __restrict__ m,
                          const float* __restrict__ l, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, int T_len, int H,
                          float sm_scale) {
  using C = F32BwdCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [kBlockM][kStride], later dK
  float* v_s = k_s + C::kOwn;                   // [kBlockM][kStride], later dV
  float* q_s = v_s + C::kOwn;                   // [2][kBlockN][kStride], raw then hi
  float* do_s = q_s + 2 * C::kTile;             // [2][kBlockN][kStride], raw then hi
  float* ql_s = do_s + 2 * C::kTile;            // [kBlockN][kStride]: Q's lo plane
  float* dol_s = ql_s + C::kTile;               // [kBlockN][kStride]: dO's lo plane
  float* st_s = dol_s + C::kTile;               // [2][m, 1/l, di][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * C::kBlockM;  // the block's first key row
  const int wrow0 = row0 + 16 * warp;        // this warp's first key row
  const bool active = wrow0 < T_len;
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int64_t stat0 = ((int64_t)b * H + h) * T_len;
  const int n_tiles = (T_len + C::kBlockN - 1) / C::kBlockN;

  auto stage = [&](float* dst, const float* src, int r0, int rows) {
    stage_rows<HD, C::kThreads>(dst, src + head0, row_stride, r0, rows, T_len, tid);
  };
  // m, 1/l and di of query row t; a row past T gets p = 0 exactly
  auto row_stats = [&](int t, float (&st)[3]) {
    const bool in = t < T_len;
    st[0] = in ? m[stat0 + t] : INFINITY;
    st[1] = in ? 1.f / l[stat0 + t] : 0.f;  // l >= 1
    st[2] = in ? di[stat0 + t] : 0.f;
  };

  stage(k_s, k, row0, C::kBlockM);
  stage(v_s, v, row0, C::kBlockM);
  stage(q_s, q, 0, C::kBlockN);
  stage(do_s, dout, 0, C::kBlockN);
  cp_async_commit();
  if (tid < C::kBlockN) {
    float st[3];
    row_stats(tid, st);
#pragma unroll
    for (int i = 0; i < 3; ++i) st_s[i * C::kBlockN + tid] = st[i];
  }

  // this lane's key rows g and g + 8: does a query attend them?
  bool attend[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) attend[r] = key_code(mask, b, wrow0 + g + 8 * r, T_len) == kKeyAttend;

  // K and V stay raw in shared memory: their split A fragments in registers
  // would take 128 registers a thread at HD 64 on top of dK and dV's 64, and
  // lo planes of their own 34,816 B would cost the SM its third block. Each
  // chunk reads the warp's 16 rows by ldmatrix and splits them.
  const float* kw = a_addr(k_s + 16 * warp * C::kStride, C::kStride, lane);
  const float* vw = a_addr(v_s + 16 * warp * C::kStride, C::kStride, lane);
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    float* qs = q_s + buf * C::kTile;
    float* dos = do_s + buf * C::kTile;
    float next[3];
    if (n + 1 < n_tiles) {  // tile n+1 into the other buffer, consumed at n-1
      const int n1 = (n + 1) * C::kBlockN;
      stage(q_s + (buf ^ 1) * C::kTile, q, n1, C::kBlockN);
      stage(do_s + (buf ^ 1) * C::kTile, dout, n1, C::kBlockN);
      cp_async_commit();
      if (tid < C::kBlockN) row_stats(n1 + tid, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile n (and at n = 0 the K and V rows) is there for every thread
    // split once a block: hi over the raw tile, lo into the planes
    split_tile<HD, C::kThreads>(qs, ql_s, C::kBlockN, tid);
    split_tile<HD, C::kThreads>(dos, dol_s, C::kBlockN, tid);
    __syncthreads();

    if (active) {
      const int nq = min(C::kBlockN, T_len - n * C::kBlockN);
      const int chunks = (nq + 15) / 16;  // 16-query chunks that hold a row before T
      const float* st = st_s + buf * 3 * C::kBlockN;

      for (int c = 0; c < chunks; ++c) {
        // S^T = K Q^T and dP^T = V dO^T in 3xTF32: 16 keys x 16 queries,
        // two n8 tiles each; Q's and dO's hi and lo fragments by ldmatrix
        float s[2][4], dp[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
        const int boff = b_addr(qs + 16 * c * C::kStride, C::kStride, lane) - qs;
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          unsigned a[4], ah[4], al[4], bh[4], bl[4];
          ldmatrix_x4(a, kw + 8 * kk);
          split_tf32(a, ah, al);
          ldmatrix_x4(bh, qs + boff + 8 * kk);
          ldmatrix_x4(bl, ql_s + boff + 8 * kk);
          mma_3xtf32(s[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          ldmatrix_x4(a, vw + 8 * kk);
          split_tf32(a, ah, al);
          ldmatrix_x4(bh, dos + boff + 8 * kk);
          ldmatrix_x4(bl, dol_s + boff + 8 * kk);
          mma_3xtf32(dp[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(dp[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
        // P^T and dS^T on the accumulators, in place: element e of tile t
        // is key row g + 8 (e / 2), query column 16 c + 8 t + 2 quad + e % 2
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = 16 * c + 8 * t + 2 * quad;
          const float2 mt = *reinterpret_cast<const float2*>(st + col);
          const float2 ilt = *reinterpret_cast<const float2*>(st + C::kBlockN + col);
          const float2 dit = *reinterpret_cast<const float2*>(st + 2 * C::kBlockN + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool att = attend[e / 2];
            const float sc = att ? s[t][e] * sm_scale : kMasked;
            const float p = __expf(sc - (e & 1 ? mt.y : mt.x)) * (e & 1 ? ilt.y : ilt.x);
            dp[t][e] = att ? p * (dp[t][e] - (e & 1 ? dit.y : dit.x)) * sm_scale : 0.f;
            s[t][e] = p;
          }
        }
        // dV += P^T dO and dK += dS^T Q in 3xTF32 over the chunk's two 8-query
        // halves: P^T and dS^T split into A fragments in place, dO's and Q's
        // hi and lo rows read in the same permuted query order
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          unsigned ph[4], pl[4], dh[4], dl[4];
          acc_to_a_split(s[t], ph, pl);
          acc_to_a_split(dp[t], dh, dl);
          const int r = (16 * c + 8 * t + 2 * quad) * C::kStride + g;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            unsigned bh[2], bl[2];
            b_perm(dos + r + 8 * d, C::kStride, bh);
            b_perm(dol_s + r + 8 * d, C::kStride, bl);
            mma_3xtf32(dv_acc[d], ph, pl, bh[0], bh[1], bl[0], bl[1]);
            b_perm(qs + r + 8 * d, C::kStride, bh);
            b_perm(ql_s + r + 8 * d, C::kStride, bl);
            mma_3xtf32(dk_acc[d], dh, dl, bh[0], bh[1], bl[0], bl[1]);
          }
        }
      }
    }

    if (tid < C::kBlockN && n + 1 < n_tiles) {
      float* stn = st_s + (buf ^ 1) * 3 * C::kBlockN;
#pragma unroll
      for (int i = 0; i < 3; ++i) stn[i * C::kBlockN + tid] = next[i];
    }
    __syncthreads();  // tile n consumed before iteration n+1 refills its buffer
  }

  if (!active) return;
  // each warp rewrites only its own rows of K and V, which only it reads
  const float one[2] = {1.f, 1.f};
  store_warp_tile<HD>(k_s + 16 * warp * C::kStride, dk_acc, one, dk + head0, row_stride, wrow0,
                      T_len, lane);
  store_warp_tile<HD>(v_s + 16 * warp * C::kStride, dv_acc, one, dv + head0, row_stride, wrow0,
                      T_len, lane);
}

// The 3xTF32 dq body's geometry: 4 warps of 16 query rows and key tiles of
// 16, chosen in one-off builds timed at the towers' shapes (PERF.md,
// Findings). The block's dO rows are staged once and split into hi and lo
// planes; K and V tiles are staged twice over (cp.async double buffer) with
// the lo planes of the current tile beside them: 60,960 B of shared memory
// at HD 64. q stays raw in registers (32 registers a thread at HD 64, dQ's
// accumulators 32 more), so an SM holds 3 blocks at 160 registers.
template <int HD>
struct F32DqCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockM = 16 * kWarps;      // the block's query rows
  static constexpr int kBlockN = 16;               // keys a staged tile
  static constexpr int kStride = TcTile<HD, float>::kStride;
  static constexpr int kOwn = kBlockM * kStride;   // dO of the block's rows
  static constexpr int kTile = kBlockN * kStride;  // one staged tile
  // dO (raw, then hi; later dQ) and its lo plane, two K and two V tiles
  // (raw, then hi), the current tile's K and V lo planes, two tiles' key
  // codes
  static constexpr int kSmemBytes = (2 * kOwn + 6 * kTile) * 4 + 2 * kBlockN;
  static_assert(kBlockN % 16 == 0 && kBlockN <= kThreads, "a key tile is 16-key chunks");
};

template <int HD>
__global__ void __launch_bounds__(F32DqCfg<HD>::kThreads)
flash_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ mask,
                         const float* __restrict__ dout, const float* __restrict__ m,
                         const float* __restrict__ l, const float* __restrict__ di,
                         float* __restrict__ dq, int T_len, int H, float sm_scale) {
  using C = F32DqCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* do_s = reinterpret_cast<float*>(smem);  // [kBlockM][kStride], raw then hi, later dQ
  float* dol_s = do_s + C::kOwn;                 // [kBlockM][kStride]: dO's lo plane
  float* k_s = dol_s + C::kOwn;                  // [2][kBlockN][kStride], raw then hi
  float* v_s = k_s + 2 * C::kTile;               // [2][kBlockN][kStride], raw then hi
  float* kl_s = v_s + 2 * C::kTile;              // [kBlockN][kStride]: K's lo plane
  float* vl_s = kl_s + C::kTile;                 // [kBlockN][kStride]: V's lo plane
  uint8_t* code_s = reinterpret_cast<uint8_t*>(vl_s + C::kTile);  // [2][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;  // the fragment's row and column
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * C::kBlockM;  // the block's first query row
  const int wrow0 = row0 + 16 * warp;        // this warp's first query row
  const bool active = wrow0 < T_len;         // the same in every lane of the warp
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int64_t stat0 = ((int64_t)b * H + h) * T_len;
  const int n_tiles = (T_len + C::kBlockN - 1) / C::kBlockN;

  auto stage = [&](float* dst, const float* src, int r0, int rows) {
    stage_rows<HD, C::kThreads>(dst, src + head0, row_stride, r0, rows, T_len, tid);
  };

  stage(do_s, dout, row0, C::kBlockM);
  stage(k_s, k, 0, C::kBlockN);
  stage(v_s, v, 0, C::kBlockN);
  cp_async_commit();
  if (tid < C::kBlockN) code_s[tid] = key_code(mask, b, tid, T_len);

  // m, 1/l and di of this lane's query rows g and g + 8; a row past T gets
  // p = 0 exactly and writes nothing
  float m_t[2], il_t[2], di_t[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = wrow0 + g + 8 * r;
    const bool in = t < T_len;
    m_t[r] = in ? m[stat0 + t] : INFINITY;
    il_t[r] = in ? 1.f / l[stat0 + t] : 0.f;  // l >= 1
    di_t[r] = in ? di[stat0 + t] : 0.f;
  }

  // this warp's 16 rows of q as fp32 A fragments, read once from global
  // memory (a quad reads 16 bytes of a row) and kept raw, as the forward
  // keeps them; rows past T are zeros. Its rows of dO are read by ldmatrix
  // from the hi and lo planes.
  unsigned qf[HD / 8][4];
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = wrow0 + g + 8 * (i & 1);
      qf[kk][i] = t < T_len
          ? __float_as_uint(q[head0 + t * row_stride + 8 * kk + quad + 4 * (i >> 1)]) : 0u;
    }
  const float* dow = a_addr(do_s + 16 * warp * C::kStride, C::kStride, lane);
  float acc[HD / 8][4];  // dQ, 16 x HD a warp, fp32
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
    __syncthreads();  // tile n (and at n = 0 the dO rows) is there for every thread
    // split once a block: hi over the raw tiles, lo into the planes
    if (n == 0) split_tile<HD, C::kThreads>(do_s, dol_s, C::kBlockM, tid);
    split_tile<HD, C::kThreads>(ks, kl_s, C::kBlockN, tid);
    split_tile<HD, C::kThreads>(vs, vl_s, C::kBlockN, tid);
    __syncthreads();

    if (active) {
      const int nk = min(C::kBlockN, T_len - n * C::kBlockN);
      const int chunks = (nk + 15) / 16;  // 16-key chunks that hold a key before T
      const uint8_t* code = code_s + buf * C::kBlockN;

      // S = Q K^T in the forward's order (so its scores are the forward's
      // bit for bit) and dP = dO V^T, in 3xTF32: chunk c is the accumulators
      // [2c] and [2c + 1]; q split once a tile and 8 dims, dO's, K's and V's
      // hi and lo fragments read by ldmatrix
      float s[C::kBlockN / 8][4], dp[C::kBlockN / 8][4];
#pragma unroll
      for (int t8 = 0; t8 < C::kBlockN / 8; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t8][e] = dp[t8][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        unsigned ah[4], al[4];
        split_tf32(qf[kk], ah, al);
#pragma unroll
        for (int c = 0; c < C::kBlockN / 16; ++c) {
          if (c < chunks) {
            const int off = b_addr(ks + 16 * c * C::kStride, C::kStride, lane) - ks + 8 * kk;
            unsigned bh[4], bl[4];
            ldmatrix_x4(bh, ks + off);
            ldmatrix_x4(bl, kl_s + off);
            mma_3xtf32(s[2 * c], ah, al, bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(s[2 * c + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          }
        }
        ldmatrix_x4(ah, dow + 8 * kk);
        ldmatrix_x4(al, dow + C::kOwn + 8 * kk);
#pragma unroll
        for (int c = 0; c < C::kBlockN / 16; ++c) {
          if (c < chunks) {
            const int off = b_addr(vs + 16 * c * C::kStride, C::kStride, lane) - vs + 8 * kk;
            unsigned bh[4], bl[4];
            ldmatrix_x4(bh, vs + off);
            ldmatrix_x4(bl, vl_s + off);
            mma_3xtf32(dp[2 * c], ah, al, bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(dp[2 * c + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }

      // dS = P (dP - di) * scale on the accumulators (element e of tile t8
      // is query row g + 8 (e / 2), key column 8 t8 + 2 quad + e % 2), 0 for
      // a masked key or a key past T; then dQ += dS K in 3xTF32: each 8-key
      // dS accumulator split into an A fragment in place, K's hi and lo rows
      // read in the same permuted key order
#pragma unroll
      for (int t8 = 0; t8 < C::kBlockN / 8; ++t8) {
        if (t8 / 2 < chunks) {
          const int j = 8 * t8 + 2 * quad;
          const unsigned two = *reinterpret_cast<const uint16_t*>(code + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned cd = (two >> (8 * (e & 1))) & 0xffu;
            const int r = e / 2;
            const float p = __expf(s[t8][e] * sm_scale - m_t[r]) * il_t[r];
            s[t8][e] = cd == kKeyAttend ? p * (dp[t8][e] - di_t[r]) * sm_scale : 0.f;
          }
          unsigned dh[4], dl[4];
          acc_to_a_split(s[t8], dh, dl);
          const int rk = j * C::kStride + g;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            unsigned kh[2], kl[2];
            b_perm(ks + rk + 8 * d, C::kStride, kh);
            b_perm(kl_s + rk + 8 * d, C::kStride, kl);
            mma_3xtf32(acc[d], dh, dl, kh[0], kh[1], kl[0], kl[1]);
          }
        }
      }
    }

    if (tid < C::kBlockN && n + 1 < n_tiles) code_s[(buf ^ 1) * C::kBlockN + tid] = next_code;
    __syncthreads();  // tile n consumed before iteration n+1 refills its buffer
  }

  if (!active) return;
  // each warp rewrites only its own rows of dO, which only it reads
  const float one[2] = {1.f, 1.f};
  store_warp_tile<HD>(do_s + 16 * warp * C::kStride, acc, one, dq + head0, row_stride, wrow0,
                      T_len, lane);
}

// The tensor-core bodies' geometry: 4 warps of 16 rows own a block's 64
// rows; the other side is staged kBlockN rows a tile (64, 32 at HD 128).
template <int HD>
struct BwdCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockM = 16 * kWarps;        // the block's own rows
  static constexpr int kBlockN = HD <= 64 ? 64 : 32;  // rows a staged tile
  static constexpr int kStride = TcTile<HD>::kStride;
  static constexpr int kOwn = kBlockM * kStride;     // one tensor of the block's rows
  static constexpr int kTile = kBlockN * kStride;    // one staged tile
  // dk/dv: K and V (later dK and dV), two Q and two dO tiles, two tiles'
  // m, 1/l and di; dq: Q and dO (later dQ), two K and two V tiles, two
  // tiles' key codes
  static constexpr int kSmemDkv = (2 * kOwn + 4 * kTile) * 2 + 2 * 3 * kBlockN * 4;
  static constexpr int kSmemDq = (2 * kOwn + 4 * kTile) * 2 + 2 * kBlockN;
  static_assert(kBlockN % 16 == 0 && kBlockN <= kThreads, "a tile is 16-row chunks");
};

template <typename E, int HD>
__global__ void __launch_bounds__(BwdCfg<HD>::kThreads)
flash_attn_bwd_dkv_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                             const E* __restrict__ v, const uint8_t* __restrict__ mask,
                             const E* __restrict__ dout, const float* __restrict__ m,
                             const float* __restrict__ l, const float* __restrict__ di,
                             E* __restrict__ dk, E* __restrict__ dv, int T_len, int H,
                             float sm_scale) {
  using C = BwdCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_s = reinterpret_cast<E*>(smem);  // [kBlockM][kStride], later dK
  E* v_s = k_s + C::kOwn;               // [kBlockM][kStride], later dV
  E* q_s = v_s + C::kOwn;               // [2][kBlockN][kStride]
  E* do_s = q_s + 2 * C::kTile;         // [2][kBlockN][kStride]
  float* st_s = reinterpret_cast<float*>(do_s + 2 * C::kTile);  // [2][m, 1/l, di][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * C::kBlockM;  // the block's first key row
  const int wrow0 = row0 + 16 * warp;        // this warp's first key row
  const bool active = wrow0 < T_len;
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int64_t stat0 = ((int64_t)b * H + h) * T_len;
  const int n_tiles = (T_len + C::kBlockN - 1) / C::kBlockN;

  auto stage = [&](E* dst, const E* src, int r0, int rows) {
    stage_rows<HD, C::kThreads>(dst, src + head0, row_stride, r0, rows, T_len, tid);
  };
  // m, 1/l and di of query row t; a row past T gets p = 0 exactly
  auto row_stats = [&](int t, float (&st)[3]) {
    const bool in = t < T_len;
    st[0] = in ? m[stat0 + t] : INFINITY;
    st[1] = in ? 1.f / l[stat0 + t] : 0.f;  // l >= 1
    st[2] = in ? di[stat0 + t] : 0.f;
  };

  stage(k_s, k, row0, C::kBlockM);
  stage(v_s, v, row0, C::kBlockM);
  stage(q_s, q, 0, C::kBlockN);
  stage(do_s, dout, 0, C::kBlockN);
  cp_async_commit();
  if (tid < C::kBlockN) {
    float st[3];
    row_stats(tid, st);
#pragma unroll
    for (int i = 0; i < 3; ++i) st_s[i * C::kBlockN + tid] = st[i];
  }

  // this lane's key rows g and g + 8: does a query attend them?
  bool attend[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) attend[r] = key_code(mask, b, wrow0 + g + 8 * r, T_len) == kKeyAttend;

  unsigned kf[HD / 16][4], vf[HD / 16][4];  // this warp's 16 rows of K and V
  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    float next[3];
    if (n + 1 < n_tiles) {  // tile n+1 into the other buffer, consumed at n-1
      const int n1 = (n + 1) * C::kBlockN;
      stage(q_s + (buf ^ 1) * C::kTile, q, n1, C::kBlockN);
      stage(do_s + (buf ^ 1) * C::kTile, dout, n1, C::kBlockN);
      cp_async_commit();
      if (tid < C::kBlockN) row_stats(n1 + tid, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile n (and at n = 0 the K and V rows) is there for every thread

    if (active) {
      if (n == 0) {
        const E* kw = a_addr(k_s + 16 * warp * C::kStride, C::kStride, lane);
        const E* vw = a_addr(v_s + 16 * warp * C::kStride, C::kStride, lane);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          ldmatrix_x4(kf[kk], kw + 16 * kk);
          ldmatrix_x4(vf[kk], vw + 16 * kk);
        }
      }
      const int nq = min(C::kBlockN, T_len - n * C::kBlockN);
      const int chunks = (nq + 15) / 16;  // 16-query chunks that hold a row before T
      const E* qs = q_s + buf * C::kTile;
      const E* dos = do_s + buf * C::kTile;
      const float* st = st_s + buf * 3 * C::kBlockN;

      for (int c = 0; c < chunks; ++c) {
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries, two n8 tiles each
        float s[2][4], dp[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
        const E* qr = b_addr(qs + 16 * c * C::kStride, C::kStride, lane);
        const E* dr = b_addr(dos + 16 * c * C::kStride, C::kStride, lane);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          unsigned qb[4], db[4];
          ldmatrix_x4(qb, qr + 16 * kk);
          Tc<E>::mma(s[0], kf[kk], qb[0], qb[1]);
          Tc<E>::mma(s[1], kf[kk], qb[2], qb[3]);
          ldmatrix_x4(db, dr + 16 * kk);
          Tc<E>::mma(dp[0], vf[kk], db[0], db[1]);
          Tc<E>::mma(dp[1], vf[kk], db[2], db[3]);
        }
        // P^T and dS^T on the accumulators: element e of tile t is key row
        // g + 8 (e / 2), query column 16 c + 8 t + 2 quad + e % 2
        unsigned pa[4], dsh[4], dsl[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = 16 * c + 8 * t + 2 * quad;
          const float2 mt = *reinterpret_cast<const float2*>(st + col);
          const float2 ilt = *reinterpret_cast<const float2*>(st + C::kBlockN + col);
          const float2 dit = *reinterpret_cast<const float2*>(st + 2 * C::kBlockN + col);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool att = attend[e / 2];
            const float sc = att ? s[t][e] * sm_scale : kMasked;
            p[e] = __expf(sc - (e & 1 ? mt.y : mt.x)) * (e & 1 ? ilt.y : ilt.x);
            ds[e] = att ? p[e] * (dp[t][e] - (e & 1 ? dit.y : dit.x)) * sm_scale : 0.f;
          }
          pa[2 * t] = Tc<E>::pack(p[0], p[1]);      // key row g
          pa[2 * t + 1] = Tc<E>::pack(p[2], p[3]);  // key row g + 8
          Tc<E>::split(ds[0], ds[1], dsh[2 * t], dsl[2 * t]);
          Tc<E>::split(ds[2], ds[3], dsh[2 * t + 1], dsl[2 * t + 1]);
        }
        // dV += P^T dO and dK += dS^T Q, dO and Q by ldmatrix.trans
        const E* dtr = bt_addr(dos + 16 * c * C::kStride, C::kStride, lane);
        const E* qtr = bt_addr(qs + 16 * c * C::kStride, C::kStride, lane);
#pragma unroll
        for (int d2 = 0; d2 < HD / 16; ++d2) {
          unsigned db[4], qb[4];
          ldmatrix_x4_trans(db, dtr + 16 * d2);
          Tc<E>::mma(dv_acc[2 * d2], pa, db[0], db[1]);
          Tc<E>::mma(dv_acc[2 * d2 + 1], pa, db[2], db[3]);
          ldmatrix_x4_trans(qb, qtr + 16 * d2);
          Tc<E>::mma(dk_acc[2 * d2], dsh, qb[0], qb[1]);
          Tc<E>::mma(dk_acc[2 * d2 + 1], dsh, qb[2], qb[3]);
          Tc<E>::mma(dk_acc[2 * d2], dsl, qb[0], qb[1]);
          Tc<E>::mma(dk_acc[2 * d2 + 1], dsl, qb[2], qb[3]);
        }
      }
    }

    if (tid < C::kBlockN && n + 1 < n_tiles) {
      float* stn = st_s + (buf ^ 1) * 3 * C::kBlockN;
#pragma unroll
      for (int i = 0; i < 3; ++i) stn[i * C::kBlockN + tid] = next[i];
    }
    __syncthreads();  // tile n consumed before iteration n+1 refills its buffer
  }

  if (!active) return;
  // each warp rewrites only its own rows of K and V, read at n = 0
  const float one[2] = {1.f, 1.f};
  store_warp_tile<HD>(k_s + 16 * warp * C::kStride, dk_acc, one, dk + head0, row_stride, wrow0,
                      T_len, lane);
  store_warp_tile<HD>(v_s + 16 * warp * C::kStride, dv_acc, one, dv + head0, row_stride, wrow0,
                      T_len, lane);
}

template <typename E, int HD>
__global__ void __launch_bounds__(BwdCfg<HD>::kThreads)
flash_attn_bwd_dq_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                            const E* __restrict__ v, const uint8_t* __restrict__ mask,
                            const E* __restrict__ dout, const float* __restrict__ m,
                            const float* __restrict__ l, const float* __restrict__ di,
                            E* __restrict__ dq, int T_len, int H, float sm_scale) {
  using C = BwdCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem);  // [kBlockM][kStride], later dQ
  E* do_s = q_s + C::kOwn;              // [kBlockM][kStride]
  E* k_s = do_s + C::kOwn;              // [2][kBlockN][kStride]
  E* v_s = k_s + 2 * C::kTile;          // [2][kBlockN][kStride]
  uint8_t* code_s = reinterpret_cast<uint8_t*>(v_s + 2 * C::kTile);  // [2][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * C::kBlockM;  // the block's first query row
  const int wrow0 = row0 + 16 * warp;        // this warp's first query row
  const bool active = wrow0 < T_len;
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int64_t stat0 = ((int64_t)b * H + h) * T_len;
  const int n_tiles = (T_len + C::kBlockN - 1) / C::kBlockN;

  auto stage = [&](E* dst, const E* src, int r0, int rows) {
    stage_rows<HD, C::kThreads>(dst, src + head0, row_stride, r0, rows, T_len, tid);
  };

  stage(q_s, q, row0, C::kBlockM);
  stage(do_s, dout, row0, C::kBlockM);
  stage(k_s, k, 0, C::kBlockN);
  stage(v_s, v, 0, C::kBlockN);
  cp_async_commit();
  if (tid < C::kBlockN) code_s[tid] = key_code(mask, b, tid, T_len);

  // m, 1/l and di of this lane's query rows g and g + 8; a row past T gets
  // p = 0 exactly and writes nothing
  float m_t[2], il_t[2], di_t[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = wrow0 + g + 8 * r;
    const bool in = t < T_len;
    m_t[r] = in ? m[stat0 + t] : INFINITY;
    il_t[r] = in ? 1.f / l[stat0 + t] : 0.f;  // l >= 1
    di_t[r] = in ? di[stat0 + t] : 0.f;
  }

  unsigned qf[HD / 16][4], dof[HD / 16][4];  // this warp's 16 rows of Q and dO
  float acc[HD / 8][4];                      // dQ, fp32
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
    __syncthreads();  // tile n (and at n = 0 the Q and dO rows) is there for every thread

    if (active) {
      if (n == 0) {
        const E* qw = a_addr(q_s + 16 * warp * C::kStride, C::kStride, lane);
        const E* dw = a_addr(do_s + 16 * warp * C::kStride, C::kStride, lane);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          ldmatrix_x4(qf[kk], qw + 16 * kk);
          ldmatrix_x4(dof[kk], dw + 16 * kk);
        }
      }
      const int nk = min(C::kBlockN, T_len - n * C::kBlockN);
      const int chunks = (nk + 15) / 16;  // 16-key chunks that hold a key before T
      const E* ks = k_s + buf * C::kTile;
      const E* vs = v_s + buf * C::kTile;
      const uint8_t* code = code_s + buf * C::kBlockN;

      for (int c = 0; c < chunks; ++c) {
        // S = Q K^T (as the forward takes it) and dP = dO V^T: 16 x 16 each
        float s[2][4], dp[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
        const E* kr = b_addr(ks + 16 * c * C::kStride, C::kStride, lane);
        const E* vr = b_addr(vs + 16 * c * C::kStride, C::kStride, lane);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          unsigned kb[4], vb[4];
          ldmatrix_x4(kb, kr + 16 * kk);
          Tc<E>::mma(s[0], qf[kk], kb[0], kb[1]);
          Tc<E>::mma(s[1], qf[kk], kb[2], kb[3]);
          ldmatrix_x4(vb, vr + 16 * kk);
          Tc<E>::mma(dp[0], dof[kk], vb[0], vb[1]);
          Tc<E>::mma(dp[1], dof[kk], vb[2], vb[3]);
        }
        // dS on the accumulators: element e of tile t is query row
        // g + 8 (e / 2), key column 16 c + 8 t + 2 quad + e % 2
        unsigned dsh[4], dsl[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * c + 8 * t + 2 * quad;
          const unsigned two = *reinterpret_cast<const uint16_t*>(code + j);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned cd = (two >> (8 * (e & 1))) & 0xffu;
            const int r = e / 2;
            const float p = __expf(s[t][e] * sm_scale - m_t[r]) * il_t[r];
            ds[e] = cd == kKeyAttend ? p * (dp[t][e] - di_t[r]) * sm_scale : 0.f;
          }
          Tc<E>::split(ds[0], ds[1], dsh[2 * t], dsl[2 * t]);          // row g
          Tc<E>::split(ds[2], ds[3], dsh[2 * t + 1], dsl[2 * t + 1]);  // row g + 8
        }
        // dQ += dS K, K by ldmatrix.trans
        const E* ktr = bt_addr(ks + 16 * c * C::kStride, C::kStride, lane);
#pragma unroll
        for (int d2 = 0; d2 < HD / 16; ++d2) {
          unsigned kb[4];
          ldmatrix_x4_trans(kb, ktr + 16 * d2);
          Tc<E>::mma(acc[2 * d2], dsh, kb[0], kb[1]);
          Tc<E>::mma(acc[2 * d2 + 1], dsh, kb[2], kb[3]);
          Tc<E>::mma(acc[2 * d2], dsl, kb[0], kb[1]);
          Tc<E>::mma(acc[2 * d2 + 1], dsl, kb[2], kb[3]);
        }
      }
    }

    if (tid < C::kBlockN && n + 1 < n_tiles) code_s[(buf ^ 1) * C::kBlockN + tid] = next_code;
    __syncthreads();  // tile n consumed before iteration n+1 refills its buffer
  }

  if (!active) return;
  // each warp rewrites only its own rows of Q, read at n = 0
  const float one[2] = {1.f, 1.f};
  store_warp_tile<HD>(q_s + 16 * warp * C::kStride, acc, one, dq + head0, row_stride, wrow0,
                      T_len, lane);
}

// The arguments both kernels share, as the C entry points take them.
struct Args {
  const void *q, *k, *v, *mask, *dout, *m, *l, *di;
  int batch, T_len, H;
  float sm_scale;
  cudaStream_t stream;
};

// Above 48 KB of dynamic shared memory only after opting in.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// bf16 and fp16 on the tensor-core body, fp32 on the 3xTF32 body
template <typename T, int HD>
cudaError_t launch_dkv_hd(const Args& a, void* dk, void* dv) {
  if constexpr (!std::is_same<T, float>::value) {
    using C = BwdCfg<HD>;
    const cudaError_t err = allow_smem(flash_attn_bwd_dkv_tc_kernel<T, HD>, C::kSmemDkv);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.T_len + C::kBlockM - 1) / C::kBlockM), (unsigned)a.H,
                    (unsigned)a.batch);
    flash_attn_bwd_dkv_tc_kernel<T, HD><<<grid, C::kThreads, C::kSmemDkv, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.m), static_cast<const float*>(a.l),
        static_cast<const float*>(a.di), static_cast<T*>(dk), static_cast<T*>(dv), a.T_len,
        a.H, a.sm_scale);
  } else {
    using C = F32BwdCfg<HD>;
    const cudaError_t err = allow_smem(flash_attn_bwd_dkv_kernel<HD>, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.T_len + C::kBlockM - 1) / C::kBlockM), (unsigned)a.H,
                    (unsigned)a.batch);
    flash_attn_bwd_dkv_kernel<HD><<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.m), static_cast<const float*>(a.l),
        static_cast<const float*>(a.di), static_cast<T*>(dk), static_cast<T*>(dv), a.T_len,
        a.H, a.sm_scale);
  }
  return cudaGetLastError();
}

// bf16 and fp16 on the tensor-core body, fp32 on the 3xTF32 body
template <typename T, int HD>
cudaError_t launch_dq_hd(const Args& a, void* dq) {
  if constexpr (!std::is_same<T, float>::value) {
    using C = BwdCfg<HD>;
    const cudaError_t err = allow_smem(flash_attn_bwd_dq_tc_kernel<T, HD>, C::kSmemDq);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.T_len + C::kBlockM - 1) / C::kBlockM), (unsigned)a.H,
                    (unsigned)a.batch);
    flash_attn_bwd_dq_tc_kernel<T, HD><<<grid, C::kThreads, C::kSmemDq, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.m), static_cast<const float*>(a.l),
        static_cast<const float*>(a.di), static_cast<T*>(dq), a.T_len, a.H, a.sm_scale);
  } else {
    using C = F32DqCfg<HD>;
    const cudaError_t err = allow_smem(flash_attn_bwd_dq_kernel<HD>, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.T_len + C::kBlockM - 1) / C::kBlockM), (unsigned)a.H,
                    (unsigned)a.batch);
    flash_attn_bwd_dq_kernel<HD><<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.m), static_cast<const float*>(a.l),
        static_cast<const float*>(a.di), static_cast<T*>(dq), a.T_len, a.H, a.sm_scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Args& a, int HD, void* dk, void* dv) {
  switch (HD) {
    case 32:
      return launch_dkv_hd<T, 32>(a, dk, dv);
    case 64:
      return launch_dkv_hd<T, 64>(a, dk, dv);
    case 128:
      return launch_dkv_hd<T, 128>(a, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dq(const Args& a, int HD, void* dq) {
  switch (HD) {
    case 32:
      return launch_dq_hd<T, 32>(a, dq);
    case 64:
      return launch_dq_hd<T, 64>(a, dq);
    case 128:
      return launch_dq_hd<T, 128>(a, dq);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C entry points: the pointers q, k, v, mask (or null), do, m, l, di and
// the outputs, the ints batch, T, heads and head dim, the scale, the stream.

extern "C" int flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* m,
                                      const void* l, const void* di, void* dk, void* dv,
                                      int batch, int T_len, int H, int HD, float sm_scale,
                                      void* stream) {
  const Args a{q, k, v, mask, dout, m, l, di, batch, T_len, H, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dkv<float>(a, HD, dk, dv);
}

extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* m,
                                       const void* l, const void* di, void* dk, void* dv,
                                       int batch, int T_len, int H, int HD, float sm_scale,
                                       void* stream) {
  const Args a{q, k, v, mask, dout, m, l, di, batch, T_len, H, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dkv<__nv_bfloat16>(a, HD, dk, dv);
}

extern "C" int flash_attn_bwd_dq_f32(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, const void* m,
                                     const void* l, const void* di, void* dq, int batch,
                                     int T_len, int H, int HD, float sm_scale, void* stream) {
  const Args a{q, k, v, mask, dout, m, l, di, batch, T_len, H, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dq<float>(a, HD, dq);
}

extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* m,
                                      const void* l, const void* di, void* dq, int batch,
                                      int T_len, int H, int HD, float sm_scale, void* stream) {
  const Args a{q, k, v, mask, dout, m, l, di, batch, T_len, H, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dq<__nv_bfloat16>(a, HD, dq);
}

extern "C" int flash_attn_bwd_dkv_f16(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* m,
                                      const void* l, const void* di, void* dk, void* dv,
                                      int batch, int T_len, int H, int HD, float sm_scale,
                                      void* stream) {
  const Args a{q, k, v, mask, dout, m, l, di, batch, T_len, H, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dkv<__half>(a, HD, dk, dv);
}

extern "C" int flash_attn_bwd_dq_f16(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, const void* m,
                                     const void* l, const void* di, void* dq, int batch,
                                     int T_len, int H, int HD, float sm_scale, void* stream) {
  const Args a{q, k, v, mask, dout, m, l, di, batch, T_len, H, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)launch_dq<__half>(a, HD, dq);
}

// Dynamic shared memory a block of a tensor-core body (either type) takes at
// head dim HD (kind 0: dk/dv, 1: dq), or -1.
extern "C" int flash_attn_bwd_tc_smem_bytes(int kind, int HD) {
  switch (HD) {
    case 32: return kind == 0 ? BwdCfg<32>::kSmemDkv : BwdCfg<32>::kSmemDq;
    case 64: return kind == 0 ? BwdCfg<64>::kSmemDkv : BwdCfg<64>::kSmemDq;
    case 128: return kind == 0 ? BwdCfg<128>::kSmemDkv : BwdCfg<128>::kSmemDq;
    default: return -1;
  }
}

// Dynamic shared memory a block of the fp32 (3xTF32) dk/dv body takes at
// head dim HD, or -1.
extern "C" int flash_attn_bwd_dkv_f32_smem_bytes(int HD) {
  switch (HD) {
    case 32: return F32BwdCfg<32>::kSmemBytes;
    case 64: return F32BwdCfg<64>::kSmemBytes;
    case 128: return F32BwdCfg<128>::kSmemBytes;
    default: return -1;
  }
}

// Dynamic shared memory a block of the fp32 (3xTF32) dq body takes at head
// dim HD, or -1.
extern "C" int flash_attn_bwd_dq_f32_smem_bytes(int HD) {
  switch (HD) {
    case 32: return F32DqCfg<32>::kSmemBytes;
    case 64: return F32DqCfg<64>::kSmemBytes;
    case 128: return F32DqCfg<128>::kSmemBytes;
    default: return -1;
  }
}
