// Selective-scan (Mamba S6 recurrence) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mamba_clip_tpu/ops/selective_scan.py::_fwd_kernel
// (a chunked Kogge-Stone scan in VMEM). Per channel (b, g, d) with state
// size N = 16, over the sequence t = 0 .. L-1:
//
//     dt_t = softplus(delta_t + bias)        [or delta_t + bias]
//     h_t  = exp(dt_t * A[n]) * h_{t-1} + dt_t * u_t * B_t[n]
//     y_t  = sum_n C_t[n] * h_t[n] + D * u_t
//
// Inputs are time-major: u, delta (batch, G, L, DG); B, C (batch, G, L, 16)
// in float or bf16; A (G*DG, 16), D and bias (G*DG,) in fp32. The state and
// y are fp32. Only the forward: serving has no backward, so the chunk-entry
// states the TPU kernel writes for its backward are not produced.
//
// Design. A half-warp owns one channel; lane n keeps h[n] in a register, so
// the recurrence is one FMA per step on the critical path. Blocks run in no
// order, so the sequential chunk axis of the TPU grid becomes the loop over
// t inside the thread, and nothing is padded: the ragged tail of L and of the
// channel count are masked. Steps are taken 16 at a time. Lane j loads and
// transforms step t0+j's delta and u (one softplus per step, not sixteen),
// and every lane loads its B/C entries for the 16 steps up front, so the
// loads of a chunk are in flight together; dt and dt*u then reach all lanes
// by shuffle, and C.h is summed over the 16 lanes by a butterfly.
//
// What bounds it on an H100: per channel-step the kernel issues 16 exp (the
// special-function units, 16 a clock on each SM), 6 shuffles a lane and a
// few FMAs, against 2 input values of delta/u (plus B/C shared by the DG
// channels of a group) and 4 bytes of y. The exp and the shuffles bound it,
// not memory. Making it fast -- staging B/C of a chunk in shared memory once
// per block, a chunked parallel scan over t to cut the serial dependence,
// fewer shuffles per step -- is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                  // state size: one lane per entry
constexpr int kThreads = 256;           // 16 channels a block
constexpr int kChannelsPerBlock = kThreads / kN;
constexpr int kChunk = 16;              // steps staged per pass (one per lane)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// jax.nn.softplus: logaddexp(x, 0), computed without overflow.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const float* __restrict__ bias, float* __restrict__ y,
                          int64_t n_channels, int G, int L, int DG, int use_softplus) {
  const int lane = threadIdx.x & (kN - 1);
  const int64_t ch = (int64_t)blockIdx.x * kChannelsPerBlock + threadIdx.x / kN;
  const bool valid = ch < n_channels;
  // An out-of-range half-warp reads channel 0 and writes nothing, so that
  // every lane of the warp takes part in the shuffles.
  const int64_t c = valid ? ch : 0;
  const int d = (int)(c % DG);
  const int64_t bg = c / DG;            // b * G + g
  const int gd = (int)(bg % G) * DG + d;

  const float a_n = A[(int64_t)gd * kN + lane];
  const float d_skip = D[gd];
  const float dbias = bias[gd];
  const int64_t row = bg * (int64_t)L;
  const T* u_c = u + row * DG + d;
  const T* dl_c = delta + row * DG + d;
  const T* B_c = Bm + row * kN + lane;
  const T* C_c = Cm + row * kN + lane;
  float* y_c = y + row * DG + d;

  float h = 0.f;
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int tj = t0 + lane;           // the step this lane stages
    float u_j = 0.f, dt_j = 0.f;        // past L: dt = 0 leaves h unchanged
    if (tj < L) {
      u_j = to_f32(u_c[(int64_t)tj * DG]);
      const float x = to_f32(dl_c[(int64_t)tj * DG]) + dbias;
      dt_j = use_softplus ? softplus(x) : x;
    }
    const float du_j = dt_j * u_j;

    float bv[kChunk], cv[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const bool in = t0 + s < L;
      bv[s] = in ? to_f32(B_c[(int64_t)(t0 + s) * kN]) : 0.f;
      cv[s] = in ? to_f32(C_c[(int64_t)(t0 + s) * kN]) : 0.f;
    }

    float y_j = 0.f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float dt = __shfl_sync(kFull, dt_j, s, kN);
      const float du = __shfl_sync(kFull, du_j, s, kN);
      h = fmaf(__expf(dt * a_n), h, du * bv[s]);
      float p = cv[s] * h;
      p += __shfl_xor_sync(kFull, p, 8, kN);
      p += __shfl_xor_sync(kFull, p, 4, kN);
      p += __shfl_xor_sync(kFull, p, 2, kN);
      p += __shfl_xor_sync(kFull, p, 1, kN);
      if (lane == s) y_j = p;
    }
    if (valid && tj < L) y_c[(int64_t)tj * DG] = fmaf(d_skip, u_j, y_j);
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* bias, void* y,
                   int batch, int G, int L, int DG, int use_softplus,
                   cudaStream_t stream) {
  const int64_t n_channels = (int64_t)batch * G * DG;
  const int64_t blocks = (n_channels + kChannelsPerBlock - 1) / kChannelsPerBlock;
  selective_scan_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(bias), static_cast<float*>(y),
      n_channels, G, L, DG, use_softplus);
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_fwd_f32(const void* u, const void* delta, const void* A,
                                      const void* Bm, const void* Cm, const void* D,
                                      const void* bias, void* y, int batch, int G, int L,
                                      int DG, int use_softplus, void* stream) {
  return (int)launch<float>(u, delta, A, Bm, Cm, D, bias, y, batch, G, L, DG,
                            use_softplus, static_cast<cudaStream_t>(stream));
}

extern "C" int selective_scan_fwd_bf16(const void* u, const void* delta, const void* A,
                                       const void* Bm, const void* Cm, const void* D,
                                       const void* bias, void* y, int batch, int G, int L,
                                       int DG, int use_softplus, void* stream) {
  return (int)launch<__nv_bfloat16>(u, delta, A, Bm, Cm, D, bias, y, batch, G, L, DG,
                                    use_softplus, static_cast<cudaStream_t>(stream));
}
