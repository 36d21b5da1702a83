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
// q, k, v are (B, T, H, HD) in float or bf16, contiguous, as the fused qkv
// projection gives them; mask is an optional (B, T) byte per key (nonzero =
// attend); o is written once, in q's type, straight into (B, T, H*HD). A
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
// Design. One block per (tile of 64 query rows, head, batch). A query row
// belongs to HD/32 neighbouring lanes, each holding 32 of its dims of q and
// of the fp32 accumulator in registers; lane g of a row owns the 16-byte
// chunks g, g + HD/32, ... of the head dim, so the lanes of a warp read
// neighbouring banks and every row of the warp the same words (broadcast).
// K and V are staged in shared memory as fp32, one tile of keys at a time
// (64 keys, 32 at HD 128); each row keeps its running max, sum and
// accumulator in fp32 (the online softmax), rescaled once per tile. The
// scores are fp32 products of the inputs summed in fp32, the partial sums of
// a row's lanes joined by shuffles. The TPU kernel's padding of T to 128
// and its segment ids are not carried over: the ragged tail of T is masked
// here, keys past T are never read, and the pad mask is one byte a key.
//
// What bounds it on an H100. Per launch the work is 4*B*H*T^2*HD FLOPs
// against 4*B*T*H*HD elements moved; at the towers' shapes (T 197 or 256,
// HD 64) that is about 100 FLOPs a byte, so with the tensor cores the
// bytes would bound it. This first kernel computes on the CUDA cores
// (fp32 FMA), two FMAs per shared-memory word read, so the FMA pipes and
// shared-memory bandwidth bound it, far above the bytes bound. mma.sync or
// wgmma on bf16 tiles, TMA staging and a pipelined ring of K/V tiles are
// later work.

#include "flash_attn_common.cuh"

namespace {

using namespace fa;

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                      int T_len, int H, float sm_scale) {
  using C = Cfg<HD>;
  __shared__ float4 k_tile[C::kKeys][C::kRowChunks];
  __shared__ float4 v_tile[C::kKeys][C::kRowChunks];
  __shared__ uint8_t m_tile[C::kKeys];

  const int tid = threadIdx.x;
  const int lane_in_row = tid % C::kLanesPerRow;
  const int t = blockIdx.x * kRows + tid / C::kLanesPerRow;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool valid = t < T_len;
  // element (b, j, h, 0) of q, k, v and o: rows of H*HD elements
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;

  // A row past T computes on zeros and writes nothing, so that every lane of
  // its warp takes part in the shuffles and the barriers.
  float4 qv[C::kChunks], acc[C::kChunks];
#pragma unroll
  for (int i = 0; i < C::kChunks; ++i) {
    const int c = lane_in_row + C::kLanesPerRow * i;
    qv[i] = valid ? load4(q + head0 + t * row_stride + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int n0 = 0; n0 < T_len; n0 += C::kKeys) {
    const int nk = min(C::kKeys, T_len - n0);  // the same in every thread
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < nk * C::kRowChunks; idx += C::kThreads) {
      const int j = idx / C::kRowChunks, c = idx % C::kRowChunks;
      const int64_t off = head0 + (int64_t)(n0 + j) * row_stride + 4 * c;
      k_tile[j][c] = load4(k + off);
      v_tile[j][c] = load4(v + off);
    }
    for (int j = tid; j < nk; j += C::kThreads)
      m_tile[j] = mask == nullptr ? 1 : mask[(int64_t)b * T_len + n0 + j];
    __syncthreads();

    float s[C::kKeys];
    float m_new = m_run;
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      if (j < nk) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < C::kChunks; ++i)
          part = dot4(qv[i], k_tile[j][lane_in_row + C::kLanesPerRow * i], part);
        part = reduce_row<C::kLanesPerRow>(part);
        s[j] = m_tile[j] ? part * sm_scale : kMasked;
        m_new = fmaxf(m_new, s[j]);
      }
    }
    // m_run is -inf before the first tile: the correction is then 0
    const float corr = __expf(m_run - m_new);
    l_run *= corr;
#pragma unroll
    for (int i = 0; i < C::kChunks; ++i)
      acc[i] = make_float4(acc[i].x * corr, acc[i].y * corr, acc[i].z * corr, acc[i].w * corr);
#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      if (j < nk) {
        const float p = __expf(s[j] - m_new);
        l_run += p;
#pragma unroll
        for (int i = 0; i < C::kChunks; ++i)
          acc[i] = axpy4(p, v_tile[j][lane_in_row + C::kLanesPerRow * i], acc[i]);
      }
    }
    m_run = m_new;
  }

  if (valid) {
    const float inv = 1.f / l_run;  // l_run >= 1: the row's max key adds exp(0)
#pragma unroll
    for (int i = 0; i < C::kChunks; ++i) {
      const int c = lane_in_row + C::kLanesPerRow * i;
      store4(o + head0 + t * row_stride + 4 * c,
             make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv));
    }
    if (m_out != nullptr && lane_in_row == 0) {
      const int64_t r = ((int64_t)b * H + h) * T_len + t;
      m_out[r] = m_run;
      l_out[r] = l_run;
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* mask, void* o,
                      float* m_out, float* l_out, int batch, int T_len, int H, float sm_scale,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)((T_len + kRows - 1) / kRows), (unsigned)H, (unsigned)batch);
  flash_attn_fwd_kernel<T, HD><<<grid, Cfg<HD>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(o), m_out, l_out, T_len, H,
      sm_scale);
  return cudaGetLastError();
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
