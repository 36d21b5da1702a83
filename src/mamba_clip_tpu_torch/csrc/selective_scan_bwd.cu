// Selective-scan (Mamba S6 recurrence) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/mamba_clip_tpu/ops/selective_scan.py:243
// (_bwd_kernel: chunks walked in reverse, a Kogge-Stone suffix scan in
// VMEM). Per channel (b, g, d) with state size N = 16, given dy = dL/dy and
// the chunk-entry states hck that selective_scan_fwd.cu wrote, it walks the
// 16-step chunks from last to first and:
//
//   1. recomputes h_t inside the chunk from the chunk's entry state;
//   2. runs g_t = C_t dy_t + a_{t+1} g_{t+1} (a_t = exp(dt_t A)), carrying
//      a_t g_t from one chunk into the one before;
//   3. emits ddelta_t = (sum_n g h_{t-1} a A + ddu_t u_t) * sigmoid(delta_t +
//      bias) [the sigmoid only with softplus], du_t = ddu_t dt_t + D dy_t with
//      ddu_t = sum_n g B_t, and dB_t[n] = sum_d g dt_t u_t and
//      dC_t[n] = sum_d dy_t h_t over the block's channels;
//   4. accumulates dA[n] += g h_{t-1} a dt_t, dD += dy_t u_t, dbias += ddelta_t.
//
// Inputs are those of the forward (u, delta, B, C in float or bf16; A, D, bias
// fp32) plus dy (batch, G, L, DG) fp32 and hck (batch, G, ceil(L/16), DG, 16)
// fp32. Outputs, all fp32: ddelta and du (batch, G, L, DG); dB and dC as
// partial sums (ceil(DG/64), batch, G, L, 16), one per block of 64 channels;
// dA (batch, G*DG, 16), dD and dbias (batch, G*DG), still to be summed over
// the batch. The wrapper adds the partials up with torch.sum: no atomics, so
// two runs give the same bits.
//
// What bounds it on an H100: bytes, at the data sheet's rates (u, delta, dy
// and hck in, ddelta, du, dB and dC out), with 19 exps a channel-step close
// behind; the kernel itself takes 32 ex2 a channel-step (a_t once in the
// recompute and once in the reverse walk) and the instructions around them.
//
// The design (the split is in selective_scan_common.cuh): kP = 4 lanes a
// channel, 4 state entries a lane, 64 channels a block of 256 threads. The
// forward pass over a chunk keeps h_t for its 16 steps in 64 registers; the
// reverse pass takes a_t again (one ex2) rather than keep it, so a thread
// fits in 128 registers and an SM holds two blocks. sum_n g B and
// sum_n g h a A take 2 shuffles each. dB_t and dC_t are summed over the
// warp's 8 channels in registers by a transpose-reduce (4 shuffles an array
// a step, lane l < 16 ending with the sum for n = 4 (l % 4) + 2 bit2(l) +
// bit3(l)), then over the block's 8 warps in shared memory after the
// chunk's one barrier, while the next chunk runs: the per-warp sums are
// double-buffered, as are B and C, which cp.async stages once a block, and
// the lanes' entry states from hck. Right after the barrier the copies of
// the next chunk (B, C, its entry state) and the loads of its u, delta and
// dy are started, so that they land under this chunk's steps.

#include "selective_scan_common.cuh"

namespace {

using namespace ss;

constexpr int kP = 4;  // lanes a channel: 16 h_t of 4 entries fit the registers
using S = Split<kP>;
static_assert(kP == 4, "transpose_reduce sums 4 entries a lane over 8 channels a warp");

// Shared memory a block, besides the statically sized B/C buffers.
struct Smem {
  float dbc[2][2][S::kWarps][kChunk][kN];  // [buffer][dB, dC][warp][step][n]
  float h_in[2][S::kWarps][S::kWarpChannels][kN];  // [buffer]: the chunk's entry state
  float dt[S::kWarps][kChunk][S::kWarpChannels];
  float dtu[S::kWarps][kChunk][S::kWarpChannels];
  float dy[S::kWarps][kChunk][S::kWarpChannels];
  float u[S::kWarps][kChunk][S::kWarpChannels];
  float sig[S::kWarps][kChunk][S::kWarpChannels];
  float ddu[S::kWarps][kChunk][S::kWarpChannels];
  float dah[S::kWarps][kChunk][S::kWarpChannels];
};

// v[j]: this lane's value for n = 4q + j. Returns the sum over the warp's 8
// channels (lane bits 2-4) for n = 4q + 2 bit2 + bit3; lanes l and l ^ 16
// return the same.
__device__ __forceinline__ float transpose_reduce(const float (&v)[4], int lane) {
  const bool b2 = lane & 4, b3 = lane & 8;
  const float w0 = (b2 ? v[2] : v[0]) + __shfl_xor_sync(kFull, b2 ? v[0] : v[2], 4);
  const float w1 = (b2 ? v[3] : v[1]) + __shfl_xor_sync(kFull, b2 ? v[1] : v[3], 4);
  const float x = (b3 ? w1 : w0) + __shfl_xor_sync(kFull, b3 ? w0 : w1, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

__device__ __forceinline__ float channel_sum(float p) {
#pragma unroll
  for (int o = 1; o < kP; o <<= 1) p += __shfl_xor_sync(kFull, p, o);
  return p;
}

template <typename T>
__global__ void __launch_bounds__(S::kThreads, 2)
selective_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const float* __restrict__ bias, const float* __restrict__ dy,
                          const float* __restrict__ hck, float* __restrict__ ddelta,
                          float* __restrict__ du, float* __restrict__ dB_part,
                          float* __restrict__ dC_part, float* __restrict__ dA_part,
                          float* __restrict__ dD_part, float* __restrict__ dbias_part,
                          int G, int L, int DG, int use_softplus) {
  __shared__ __align__(16) T s_bc[2][2][kChunk * kN];  // [buffer][B, C][step * 16 + n]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = lane / kP, q = lane % kP;
  const int64_t bg = blockIdx.x;  // b * G + g
  const int64_t n_bg = gridDim.x;
  const int tile = blockIdx.y;
  const int d_raw = tile * kBlockChannels + warp * S::kWarpChannels + cw;
  // A channel past DG computes on channel DG-1 with dt = dy = 0: it adds
  // nothing to dB and dC and writes nothing.
  const bool valid = d_raw < DG;
  const int d = valid ? d_raw : DG - 1;
  const int gd = (int)(bg % G) * DG + d;
  const int n_chunks = (L + kChunk - 1) / kChunk;

  float A2[S::kEntries];
#pragma unroll
  for (int j = 0; j < S::kEntries; ++j) A2[j] = A[(int64_t)gd * kN + q * S::kEntries + j] * kLog2e;
  const float d_skip = D[gd], dbias = bias[gd];
  const int64_t row = bg * (int64_t)L;
  const T* u_c = u + row * DG + d;
  const T* dl_c = delta + row * DG + d;
  const float* dy_c = dy + row * DG + d;
  const T* B_row = Bm + row * kN;
  const T* C_row = Cm + row * kN;
  const float* hck_c = hck + (bg * n_chunks * DG + d) * kN + q * S::kEntries;
  float* ddelta_c = ddelta + row * DG + d;
  float* du_c = du + row * DG + d;

  // u, delta and dy of the steps q, q + kP, ... this lane stages
  T ru[S::kLaneSteps], rd[S::kLaneSteps];
  float rdy[S::kLaneSteps];
  auto load_raw = [&](int t0) {
#pragma unroll
    for (int k = 0; k < S::kLaneSteps; ++k) {
      const int t = t0 + q + kP * k;
      const bool in = valid && t < L;
      ru[k] = in ? u_c[(int64_t)t * DG] : T(0.f);
      rd[k] = in ? dl_c[(int64_t)t * DG] : T(0.f);
      rdy[k] = in ? dy_c[(int64_t)t * DG] : 0.f;
    }
  };
  // dB and dC of chunk t0's steps: thread (s, n) adds the 8 warps' sums
  auto write_dbc = [&](int buf, int t0) {
    const int s = threadIdx.x / kN, n = threadIdx.x % kN;
    float sb = 0.f, sc = 0.f;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) {
      sb += sm.dbc[buf][0][w][s][n];
      sc += sm.dbc[buf][1][w][s][n];
    }
    if (t0 + s < L) {
      const int64_t o = (((int64_t)tile * n_bg + bg) * L + t0 + s) * kN + n;
      dB_part[o] = sb;
      dC_part[o] = sc;
    }
  };
  static_assert(S::kThreads == kChunk * kN, "one thread a (step, n) of dB and dC");

  float g_next[S::kEntries], dA_acc[S::kEntries];  // a_{t+1} g_{t+1}, carried backwards
#pragma unroll
  for (int j = 0; j < S::kEntries; ++j) g_next[j] = dA_acc[j] = 0.f;
  float dD_acc = 0.f, dbias_acc = 0.f;  // over the steps this lane stages

  // the entry state of chunk c, copied with the chunk's B and C
  auto stage_h = [&](int buf, int c) {
    cp_async16(&sm.h_in[buf][warp][cw][q * S::kEntries], hck_c + (int64_t)c * DG * kN, 16);
  };
  static_assert(S::kEntries == 4, "a lane's entries of hck are one 16-byte copy");
  stage_h(0, n_chunks - 1);
  stage_bc<T, S::kThreads>(s_bc[0], B_row, C_row, (n_chunks - 1) * kChunk, L);
  load_raw((n_chunks - 1) * kChunk);
  for (int i = 0; i < n_chunks; ++i) {
    const int c = n_chunks - 1 - i, t0 = c * kChunk, buf = i & 1;
    // this chunk's per-channel values, once a channel-step; past L (and DG)
    // dt = dy = 0, so h and g pass through unchanged
#pragma unroll
    for (int k = 0; k < S::kLaneSteps; ++k) {
      const int s = q + kP * k;
      const bool in = valid && t0 + s < L;
      const float x = to_f32(rd[k]) + dbias, uv = to_f32(ru[k]);
      const float dt = in ? (use_softplus ? softplus(x) : x) : 0.f;
      sm.dt[warp][s][cw] = dt;
      sm.dtu[warp][s][cw] = dt * uv;
      sm.dy[warp][s][cw] = rdy[k];
      sm.u[warp][s][cw] = uv;
      sm.sig[warp][s][cw] = in && use_softplus ? sigmoid(x) : 1.f;
      dD_acc = fmaf(rdy[k], uv, dD_acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // this chunk's B/C in; the last chunk's dB/dC sums complete
    if (i > 0) write_dbc(buf ^ 1, t0 + kChunk);
    if (c > 0) {
      stage_h(buf ^ 1, c - 1);
      stage_bc<T, S::kThreads>(s_bc[buf ^ 1], B_row, C_row, t0 - kChunk, L);
      load_raw(t0 - kChunk);
    }

    // forward over the chunk: h_t in registers
    float h_in[S::kEntries], hs[kChunk][S::kEntries];
    load_row<S::kEntries>(&sm.h_in[buf][warp][cw][q * S::kEntries], h_in);
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float dt = sm.dt[warp][s][cw], dtu = sm.dtu[warp][s][cw];
      float bv[S::kEntries];
      load_row<S::kEntries>(&s_bc[buf][0][s * kN + q * S::kEntries], bv);
#pragma unroll
      for (int j = 0; j < S::kEntries; ++j)
        hs[s][j] = fmaf(ex2(dt * A2[j]), s > 0 ? hs[s - 1][j] : h_in[j], dtu * bv[j]);
    }

    // reverse over the chunk
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      const float dt = sm.dt[warp][s][cw], dtu = sm.dtu[warp][s][cw];
      const float dys = sm.dy[warp][s][cw];
      float bv[S::kEntries], cv[S::kEntries], vb[S::kEntries], vc[S::kEntries];
      load_row<S::kEntries>(&s_bc[buf][0][s * kN + q * S::kEntries], bv);
      load_row<S::kEntries>(&s_bc[buf][1][s * kN + q * S::kEntries], cv);
      float ddu = 0.f, dah = 0.f;
#pragma unroll
      for (int j = 0; j < S::kEntries; ++j) {
        const float a = ex2(dt * A2[j]);
        const float g = fmaf(cv[j], dys, g_next[j]);
        g_next[j] = a * g;
        vb[j] = g * dtu;
        vc[j] = dys * hs[s][j];
        ddu = fmaf(g, bv[j], ddu);
        const float da = g * (s > 0 ? hs[s - 1][j] : h_in[j]) * a;
        dah = fmaf(da, A2[j], dah);
        dA_acc[j] = fmaf(da, dt, dA_acc[j]);
      }
      ddu = channel_sum(ddu);
      dah = channel_sum(dah);
      if (q == s % kP) {  // the lane that staged step s finishes it below
        sm.ddu[warp][s][cw] = ddu;
        sm.dah[warp][s][cw] = dah * kLn2;  // sum_n da A, with A = A2 ln 2
      }
      const float sb = transpose_reduce(vb, lane), sc = transpose_reduce(vc, lane);
      if (lane < 16) {
        const int n = 4 * q + 2 * ((lane >> 2) & 1) + ((lane >> 3) & 1);
        sm.dbc[buf][0][warp][s][n] = sb;
        sm.dbc[buf][1][warp][s][n] = sc;
      }
    }

    // ddelta and du of the steps this lane staged (and wrote ddu, dah of)
#pragma unroll
    for (int k = 0; k < S::kLaneSteps; ++k) {
      const int s = q + kP * k, t = t0 + s;
      const float ddu = sm.ddu[warp][s][cw];
      const float ddt = fmaf(ddu, sm.u[warp][s][cw], sm.dah[warp][s][cw]) * sm.sig[warp][s][cw];
      if (valid && t < L) {
        ddelta_c[(int64_t)t * DG] = ddt;
        du_c[(int64_t)t * DG] = fmaf(ddu, sm.dt[warp][s][cw], sm.dy[warp][s][cw] * d_skip);
        dbias_acc += ddt;
      }
    }
    __syncwarp();  // the warp's staged values are read before the next chunk's are written
  }
  __syncthreads();
  write_dbc((n_chunks - 1) & 1, 0);

  dD_acc = channel_sum(dD_acc);
  dbias_acc = channel_sum(dbias_acc);
  if (valid) {
    const int64_t ch = bg * DG + d;
#pragma unroll
    for (int j = 0; j < S::kEntries; ++j) dA_part[ch * kN + q * S::kEntries + j] = dA_acc[j];
    if (q == 0) {
      dD_part[ch] = dD_acc;
      dbias_part[ch] = dbias_acc;
    }
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* bias, const void* dy,
                   const void* hck, void* ddelta, void* du, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* dbias_part, int batch, int G, int L,
                   int DG, int use_softplus, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((int64_t)batch * G),
                  (unsigned)((DG + kBlockChannels - 1) / kBlockChannels));
  selective_scan_bwd_kernel<T><<<grid, S::kThreads, sizeof(Smem), stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(bias), static_cast<const float*>(dy),
      static_cast<const float*>(hck), static_cast<float*>(ddelta),
      static_cast<float*>(du), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(dbias_part), G, L, DG,
      use_softplus);
  return cudaGetLastError();
}

}  // namespace

#define SELECTIVE_SCAN_BWD(SUFFIX, T)                                                     \
  extern "C" int selective_scan_bwd_##SUFFIX(                                             \
      const void* u, const void* delta, const void* A, const void* Bm, const void* Cm,    \
      const void* D, const void* bias, const void* dy, const void* hck, void* ddelta,     \
      void* du, void* dB_part, void* dC_part, void* dA_part, void* dD_part,               \
      void* dbias_part, int batch, int G, int L, int DG, int use_softplus, void* stream) { \
    return (int)launch<T>(u, delta, A, Bm, Cm, D, bias, dy, hck, ddelta, du, dB_part,    \
                          dC_part, dA_part, dD_part, dbias_part, batch, G, L, DG,         \
                          use_softplus, static_cast<cudaStream_t>(stream));               \
  }

SELECTIVE_SCAN_BWD(f32, float)
SELECTIVE_SCAN_BWD(bf16, __nv_bfloat16)

// The dynamic shared memory a block takes, besides ptxas' static B/C buffers.
extern "C" int selective_scan_bwd_smem_bytes() { return (int)sizeof(Smem); }
