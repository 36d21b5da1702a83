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
// q, k, v and do are (B, T, H, HD) in float or bf16, contiguous; mask is an
// optional (B, T) byte per key (nonzero = attend); m, l and di are (B, H, T)
// fp32; dq, dk, dv are written once, in q's type, as (B, T, H, HD). The mask
// covers keys only: a padded token as a query attends the valid keys and
// adds to their dk and dv. A masked key's score is the constant -1e9, so no
// gradient flows through it to q or k (ds = 0), as in the plain interior's
// masked_fill; a row with some valid key gives a masked key p = exp(-1e9 - m)
// = 0 exactly, so nothing reaches its dv either, while a row with no valid
// key has m = -1e9 and l = T, gives every key p = 1/T, and so adds do_t / T
// to every dv_j, as the plain backward does.
//
// Design. Two kernels, as on the TPU, so that neither needs atomics and two
// runs give the same bits.
// - dk/dv: one block per (tile of 64 key rows, head, batch). A key row
//   belongs to HD/32 neighbouring lanes, each holding 32 dims of k_j, v_j and
//   of the fp32 accumulators of dk_j and dv_j in registers. The block walks
//   the query rows in tiles (64, 32 at HD 128) staged in shared memory as
//   fp32 (q, do, and m, 1/l, di of each row); per query row a lane takes its
//   part of q.k and do.v, joins them with its row's other lanes by shuffles,
//   recomputes p and ds and adds p*do_t and ds*q_t to its accumulators.
// - dq: one block per (tile of 64 query rows, head, batch), the mirror image
//   and the forward's own shape: q_t, do_t and the accumulator of dq_t in
//   registers, K and V tiles (and the mask bytes) staged in shared memory.
// The ragged tail of T is masked in both directions: rows past T are never
// staged or walked, and a block's own rows past T compute on zeros and write
// nothing. All arithmetic is fp32; dq, dk and dv are rounded once.
//
// What bounds them on an H100. dk/dv does 8*B*H*T^2*HD FLOPs and dq
// 6*B*H*T^2*HD against about 6 and 5 tensors of B*T*H*HD elements moved, so
// with the tensor cores the bytes would bound both. These first kernels
// compute on the CUDA cores (fp32 FMA), two FMAs per shared-memory word
// read, so the FMA pipes and shared-memory bandwidth bound them. mma.sync
// or wgmma on bf16 tiles and pipelined staging are later work.

#include "flash_attn_common.cuh"

namespace {

using namespace fa;

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ mask,
                          const T* __restrict__ dout, const float* __restrict__ m,
                          const float* __restrict__ l, const float* __restrict__ di,
                          T* __restrict__ dk, T* __restrict__ dv, int T_len, int H,
                          float sm_scale) {
  using C = Cfg<HD>;
  constexpr int kQ = C::kKeys;  // query rows a staged tile
  __shared__ float4 q_tile[kQ][C::kRowChunks];
  __shared__ float4 do_tile[kQ][C::kRowChunks];
  __shared__ float m_tile[kQ], il_tile[kQ], di_tile[kQ];

  const int tid = threadIdx.x;
  const int lane_in_row = tid % C::kLanesPerRow;
  const int j = blockIdx.x * kRows + tid / C::kLanesPerRow;  // this thread's key row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool valid = j < T_len;
  // element (b, t, h, 0) of q, k, v, do, dk and dv: rows of H*HD elements
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int64_t stat0 = ((int64_t)b * H + h) * T_len;  // row 0 of m, l and di
  const bool attend = valid && (mask == nullptr || mask[(int64_t)b * T_len + j] != 0);

  // A key row past T computes on zeros and writes nothing, so that every
  // lane of its warp takes part in the shuffles and the barriers.
  float4 kv[C::kChunks], vv[C::kChunks], dk_acc[C::kChunks], dv_acc[C::kChunks];
#pragma unroll
  for (int i = 0; i < C::kChunks; ++i) {
    const int c = lane_in_row + C::kLanesPerRow * i;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    kv[i] = valid ? load4(k + head0 + j * row_stride + 4 * c) : zero;
    vv[i] = valid ? load4(v + head0 + j * row_stride + 4 * c) : zero;
    dk_acc[i] = zero;
    dv_acc[i] = zero;
  }

  for (int t0 = 0; t0 < T_len; t0 += kQ) {
    const int nq = min(kQ, T_len - t0);  // the same in every thread
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < nq * C::kRowChunks; idx += C::kThreads) {
      const int r = idx / C::kRowChunks, c = idx % C::kRowChunks;
      const int64_t off = head0 + (int64_t)(t0 + r) * row_stride + 4 * c;
      q_tile[r][c] = load4(q + off);
      do_tile[r][c] = load4(dout + off);
    }
    for (int r = tid; r < nq; r += C::kThreads) {
      m_tile[r] = m[stat0 + t0 + r];
      il_tile[r] = 1.f / l[stat0 + t0 + r];  // l >= 1
      di_tile[r] = di[stat0 + t0 + r];
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < nq; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < C::kChunks; ++i) {
        const int c = lane_in_row + C::kLanesPerRow * i;
        s = dot4(q_tile[r][c], kv[i], s);
        dp = dot4(do_tile[r][c], vv[i], dp);
      }
      s = reduce_row<C::kLanesPerRow>(s);
      dp = reduce_row<C::kLanesPerRow>(dp);
      s = attend ? s * sm_scale : kMasked;
      const float p = __expf(s - m_tile[r]) * il_tile[r];
      const float ds = attend ? p * (dp - di_tile[r]) * sm_scale : 0.f;
#pragma unroll
      for (int i = 0; i < C::kChunks; ++i) {
        const int c = lane_in_row + C::kLanesPerRow * i;
        dv_acc[i] = axpy4(p, do_tile[r][c], dv_acc[i]);
        dk_acc[i] = axpy4(ds, q_tile[r][c], dk_acc[i]);
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int i = 0; i < C::kChunks; ++i) {
      const int c = lane_in_row + C::kLanesPerRow * i;
      store4(dk + head0 + j * row_stride + 4 * c, dk_acc[i]);
      store4(dv + head0 + j * row_stride + 4 * c, dv_acc[i]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout, const float* __restrict__ m,
                         const float* __restrict__ l, const float* __restrict__ di,
                         T* __restrict__ dq, int T_len, int H, float sm_scale) {
  using C = Cfg<HD>;
  __shared__ float4 k_tile[C::kKeys][C::kRowChunks];
  __shared__ float4 v_tile[C::kKeys][C::kRowChunks];
  __shared__ uint8_t mask_tile[C::kKeys];

  const int tid = threadIdx.x;
  const int lane_in_row = tid % C::kLanesPerRow;
  const int t = blockIdx.x * kRows + tid / C::kLanesPerRow;  // this thread's query row
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool valid = t < T_len;
  const int64_t row_stride = (int64_t)H * HD;
  const int64_t head0 = (int64_t)b * T_len * row_stride + (int64_t)h * HD;
  const int64_t stat = ((int64_t)b * H + h) * T_len + t;

  // A query row past T computes on zeros (p = 0) and writes nothing.
  float4 qv[C::kChunks], dov[C::kChunks], acc[C::kChunks];
#pragma unroll
  for (int i = 0; i < C::kChunks; ++i) {
    const int c = lane_in_row + C::kLanesPerRow * i;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    qv[i] = valid ? load4(q + head0 + t * row_stride + 4 * c) : zero;
    dov[i] = valid ? load4(dout + head0 + t * row_stride + 4 * c) : zero;
    acc[i] = zero;
  }
  const float m_t = valid ? m[stat] : 0.f;
  const float il_t = valid ? 1.f / l[stat] : 0.f;  // l >= 1
  const float di_t = valid ? di[stat] : 0.f;

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
      mask_tile[j] = mask == nullptr ? 1 : mask[(int64_t)b * T_len + n0 + j];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < C::kChunks; ++i) {
        const int c = lane_in_row + C::kLanesPerRow * i;
        s = dot4(qv[i], k_tile[j][c], s);
        dp = dot4(dov[i], v_tile[j][c], dp);
      }
      s = reduce_row<C::kLanesPerRow>(s);
      dp = reduce_row<C::kLanesPerRow>(dp);
      const bool attend = mask_tile[j] != 0;
      s = attend ? s * sm_scale : kMasked;
      const float p = __expf(s - m_t) * il_t;
      const float ds = attend ? p * (dp - di_t) * sm_scale : 0.f;
#pragma unroll
      for (int i = 0; i < C::kChunks; ++i)
        acc[i] = axpy4(ds, k_tile[j][lane_in_row + C::kLanesPerRow * i], acc[i]);
    }
  }

  if (valid) {
#pragma unroll
    for (int i = 0; i < C::kChunks; ++i)
      store4(dq + head0 + t * row_stride + 4 * (lane_in_row + C::kLanesPerRow * i), acc[i]);
  }
}

// The arguments both kernels share, as the C entry points take them.
struct Args {
  const void *q, *k, *v, *mask, *dout, *m, *l, *di;
  int batch, T_len, H;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_dkv_hd(const Args& a, void* dk, void* dv) {
  const dim3 grid((unsigned)((a.T_len + kRows - 1) / kRows), (unsigned)a.H, (unsigned)a.batch);
  flash_attn_bwd_dkv_kernel<T, HD><<<grid, Cfg<HD>::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<const float*>(a.di), static_cast<T*>(dk), static_cast<T*>(dv), a.T_len, a.H,
      a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq_hd(const Args& a, void* dq) {
  const dim3 grid((unsigned)((a.T_len + kRows - 1) / kRows), (unsigned)a.H, (unsigned)a.batch);
  flash_attn_bwd_dq_kernel<T, HD><<<grid, Cfg<HD>::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<const float*>(a.di), static_cast<T*>(dq), a.T_len, a.H, a.sm_scale);
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
