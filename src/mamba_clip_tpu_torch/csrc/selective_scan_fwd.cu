// Selective-scan (Mamba S6 recurrence) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/mamba_clip_tpu/ops/selective_scan.py:194
// (_fwd_kernel: a chunked Kogge-Stone scan in VMEM). Per channel (b, g, d)
// with state size N = 16, over the sequence t = 0 .. L-1:
//
//     dt_t = softplus(delta_t + bias)        [or delta_t + bias]
//     h_t  = exp(dt_t * A[n]) * h_{t-1} + dt_t * u_t * B_t[n]
//     y_t  = sum_n C_t[n] * h_t[n] + D * u_t
//
// Inputs are time-major: u, delta (batch, G, L, DG); B, C (batch, G, L, 16)
// in float or bf16; A (G*DG, 16), D and bias (G*DG,) in fp32. The state and
// y are fp32. When the caller passes an hck buffer (training), the kernel
// also writes the chunk-entry state h_{16c-1} (zero for c = 0) of every
// 16-step chunk c into hck (batch, G, ceil(L/16), DG, 16) fp32, from which
// selective_scan_bwd.cu recomputes h; serving passes null and writes none.
//
// What bounds it on an H100: per channel-step 16 exps (the special-function
// units: 16 a clock on each SM) against 2 values of u/delta read and 4 bytes
// of y written (B/C are shared by the DG channels of a group), so the exps,
// and the instructions issued around them, bound it, not memory.
//
// The design (the split is in selective_scan_common.cuh): kP = 4 lanes a
// channel, 4 state entries a lane, 64 channels a block. Per step a lane
// reads dt and dt*u (computed once a channel-step into its warp's shared
// memory), its 4 entries of B_t and C_t (staged once a block by cp.async),
// takes 4 ex2 and 4 FMAs on h, and keeps its part of C.h. After the 16
// steps a transpose-reduce over the channel's 4 lanes (12 shuffles a chunk,
// no butterfly a step) leaves lane q with y of the steps it staged, which it
// writes with D*u. The
// sequential chunk axis of the TPU grid is the loop over t inside the
// thread; the ragged tail of L and of DG is masked, nothing is padded. One
// barrier a chunk: before it the chunk's B/C copy has landed; after it the
// next chunk's copy and u/delta loads are started, and run under the steps.

#include "selective_scan_common.cuh"

namespace {

using namespace ss;

constexpr int kP = 4;  // lanes a channel (timed against 1 and 2 on the four stage shapes)
using S = Split<kP>;

// v[s]: this lane's part of step s's sum over n, for the chunk's 16 steps.
// Leaves in v[k] the whole sum of step q + P k, the steps lane q staged: at
// each level o = 1, 2, .. < P a lane keeps the half of its steps whose bit
// of o matches its own, adding its partner's part, and sends the other half
// (16 - 16 / P shuffles a chunk, not log2 P a step).
template <int P, int O = 1>
__device__ __forceinline__ void steps_sum(float (&v)[kChunk], int q) {
  if constexpr (O < P) {
    const bool hi = q & O;
#pragma unroll
    for (int i = 0; i < kChunk / (2 * O); ++i) {
      const float keep = hi ? v[2 * i + 1] : v[2 * i];
      const float send = hi ? v[2 * i] : v[2 * i + 1];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    steps_sum<P, 2 * O>(v, q);
  }
}

template <typename T>
__global__ void __launch_bounds__(S::kThreads)
selective_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const float* __restrict__ bias, float* __restrict__ y,
                          float* __restrict__ hck, int G, int L, int DG, int use_softplus) {
  __shared__ __align__(16) T s_bc[2][2][kChunk * kN];  // [buffer][B, C][step * 16 + n]
  __shared__ float s_dt[S::kWarps][kChunk][S::kWarpChannels];
  __shared__ float s_dtu[S::kWarps][kChunk][S::kWarpChannels];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = lane / kP, q = lane % kP;
  const int64_t bg = blockIdx.x;  // b * G + g
  const int d_raw = blockIdx.y * kBlockChannels + warp * S::kWarpChannels + cw;
  // A channel past DG computes on channel DG-1 with dt = 0 and writes nothing.
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
  const T* B_row = Bm + row * kN;
  const T* C_row = Cm + row * kN;
  float* y_c = y + row * DG + d;
  float* hck_c = hck == nullptr ? nullptr
                                : hck + (bg * n_chunks * DG + d) * kN + q * S::kEntries;

  // u and delta of the steps this lane stages, loaded a chunk ahead
  T ru[S::kLaneSteps], rd[S::kLaneSteps];
  auto load_raw = [&](int t0) {
#pragma unroll
    for (int k = 0; k < S::kLaneSteps; ++k) {
      const int t = t0 + q + kP * k;
      const bool in = valid && t < L;
      ru[k] = in ? u_c[(int64_t)t * DG] : T(0.f);
      rd[k] = in ? dl_c[(int64_t)t * DG] : T(0.f);
    }
  };

  stage_bc<T, S::kThreads>(s_bc[0], B_row, C_row, 0, L);
  load_raw(0);
  float h[S::kEntries];
#pragma unroll
  for (int j = 0; j < S::kEntries; ++j) h[j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, buf = c & 1;
    // dt and dt*u of this chunk's steps q, q + kP, ...; past L (and DG) dt = 0
    // leaves h unchanged
    float uk[S::kLaneSteps];
#pragma unroll
    for (int k = 0; k < S::kLaneSteps; ++k) {
      const int s = q + kP * k;
      const bool in = valid && t0 + s < L;
      const float x = to_f32(rd[k]) + dbias;
      const float dt = in ? (use_softplus ? softplus(x) : x) : 0.f;
      uk[k] = to_f32(ru[k]);
      s_dt[warp][s][cw] = dt;
      s_dtu[warp][s][cw] = dt * uk[k];
    }
    cp_async_wait<0>();
    __syncthreads();  // this chunk's B/C in; every warp is done with the other buffer
    if (c + 1 < n_chunks) {
      stage_bc<T, S::kThreads>(s_bc[buf ^ 1], B_row, C_row, t0 + kChunk, L);
      load_raw(t0 + kChunk);
    }
    if (hck_c != nullptr && valid) {
      float* o = hck_c + (int64_t)c * DG * kN;
#pragma unroll
      for (int j = 0; j < S::kEntries; j += 4)
        *reinterpret_cast<float4*>(o + j) = make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
    }

    float yk[kChunk];  // this lane's part of C_t.h_t, then (below) y of its steps
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float dt = s_dt[warp][s][cw], dtu = s_dtu[warp][s][cw];
      float bv[S::kEntries], cv[S::kEntries];
      load_row<S::kEntries>(&s_bc[buf][0][s * kN + q * S::kEntries], bv);
      load_row<S::kEntries>(&s_bc[buf][1][s * kN + q * S::kEntries], cv);
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < S::kEntries; ++j) {
        h[j] = fmaf(ex2(dt * A2[j]), h[j], dtu * bv[j]);
        p = fmaf(cv[j], h[j], p);
      }
      yk[s] = p;
    }
    steps_sum<kP>(yk, q);
#pragma unroll
    for (int k = 0; k < S::kLaneSteps; ++k) {
      const int t = t0 + q + kP * k;
      if (valid && t < L) y_c[(int64_t)t * DG] = fmaf(d_skip, uk[k], yk[k]);
    }
    __syncwarp();  // the warp's dt and dt*u are read before the next chunk's are written
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* bias, void* y, void* hck,
                   int batch, int G, int L, int DG, int use_softplus,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((int64_t)batch * G),
                  (unsigned)((DG + kBlockChannels - 1) / kBlockChannels));
  selective_scan_fwd_kernel<T><<<grid, S::kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(bias), static_cast<float*>(y), static_cast<float*>(hck),
      G, L, DG, use_softplus);
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_fwd_f32(const void* u, const void* delta, const void* A,
                                      const void* Bm, const void* Cm, const void* D,
                                      const void* bias, void* y, void* hck, int batch, int G,
                                      int L, int DG, int use_softplus, void* stream) {
  return (int)launch<float>(u, delta, A, Bm, Cm, D, bias, y, hck, batch, G, L, DG,
                            use_softplus, static_cast<cudaStream_t>(stream));
}

extern "C" int selective_scan_fwd_bf16(const void* u, const void* delta, const void* A,
                                       const void* Bm, const void* Cm, const void* D,
                                       const void* bias, void* y, void* hck, int batch, int G,
                                       int L, int DG, int use_softplus, void* stream) {
  return (int)launch<__nv_bfloat16>(u, delta, A, Bm, Cm, D, bias, y, hck, batch, G, L, DG,
                                    use_softplus, static_cast<cudaStream_t>(stream));
}
