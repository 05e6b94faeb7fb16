// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: singa_tpu/ops/pallas_kernels.py `_flash_fwd` (pallas_call at
// :494, kernel body `_attn_fwd_kernel` at :402). Same function: per
// (batch, head), o = softmax(q k^T * scale, causal/pad mask) v and the row
// logsumexp lse = m + log(l), with masked scores set to the finite -1e30.
//
// Design: the TPU kernel keeps a head's whole K and V resident in VMEM and
// builds a (TQ, S) score block. A Hopper block has at most 227 KB of shared
// memory (K alone is 256 KB at S=1024, D=64 in f32), so this kernel is the
// online-softmax form instead: one thread block per (64-row query tile,
// batch*head), a loop over 64-row K/V tiles staged in shared memory that
// stops at the causal diagonal, and a running row max m and sum l in f32
// that rescale the f32 output accumulator held in registers. The score tile
// never leaves shared memory.
//
// Bound on this card: 4*S*S*D*B*H (halved when causal) operations against
// reading q, k, v and writing o once, i.e. about S/2 operations per byte in
// f32 -- far above the H100's ~20 f32 FLOP/byte, so the kernel is bound by
// operations. This version does them with plain f32 FMAs (67 TFLOP/s peak
// outside the tensor cores); wgmma, TMA and pipelining are later work.
//
// Inputs are contiguous [B*H, S, D] in f32 or bf16; D in {16, 32, 64, 128}
// is a template parameter. Accumulation is f32 in both cases. The kernel
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key/value rows per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 threads, each owning a 4-row slab
constexpr int SLD = BK + 1;   // padded row stride of the score tile
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout, in floats. Q and K rows are padded to D+1 so that
// the 16 threads of a half-warp reading 16 different K rows at the same
// column hit 16 different banks.
template <int D>
struct Smem {
  static constexpr int LD = D + 1;
  static constexpr int Q = BQ * LD;
  static constexpr int K = BK * LD;
  static constexpr int V = BK * D;
  static constexpr int S = BQ * SLD;
  static constexpr int TOTAL = Q + K + V + S + 3 * BQ;  // + m, l, corr
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int S, float scale,
                          int causal) {
  using L = Smem<D>;
  constexpr int LD = L::LD;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + L::Q;
  float* v_s = k_s + L::K;
  float* s_s = v_s + L::V;
  float* m_s = s_s + L::S;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Causal tiles near the end of the sequence do the most work: hand them
  // out first so the short ones fill the tail of the grid.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base;
  k += base;
  v += base;
  o += base;
  lse += (size_t)blockIdx.y * S;

  // q is scaled once on load, as the TPU kernel does.
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    q_s[r * LD + c] =
        (q0 + r < S) ? to_f32(q[(size_t)(q0 + r) * D + c]) * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int n_kv = (S + BK - 1) / BK;
  // BQ == BK: query tile qt needs K/V tiles 0..qt under the causal mask.
  const int n_tiles = causal ? qt + 1 : n_kv;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of k_s, v_s, s_s are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const size_t g = (size_t)(k0 + r) * D + c;
      k_s[r * LD + c] = in ? to_f32(k[g]) : 0.f;
      v_s[r * D + c] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // Scores: this thread's 4 rows x columns tx, tx+16, tx+32, tx+48.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int ki = k0 + c;
        const bool keep = ki < S && qi < S && (!causal || ki <= qi);
        s_s[r * SLD + c] = keep ? sc[i][j] : MASKED;
      }
    }
    __syncthreads();

    // Online softmax: each warp owns 8 rows, each lane two columns.
    for (int rr = 0; rr < BQ / (THREADS / 32); ++rr) {
      const int r = warp * (BQ / (THREADS / 32)) + rr;
      const float x0 = s_s[r * SLD + lane];
      const float x1 = s_s[r * SLD + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      s_s[r * SLD + lane] = p0;
      s_s[r * SLD + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * corr + P V for this thread's 4 rows x CPT columns.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty * 4 + i) * SLD + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = v_s[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // the last tile's l_s, m_s are visible to all

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi < S) {
      const float inv = 1.f / l_s[r];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        o[(size_t)qi * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
  if (tid < BQ && q0 + tid < S) lse[q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int s, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::BYTES;
  // Above 48 KB a block's dynamic shared memory must be opted into, once
  // per kernel instantiation (thread-safe static initialisation).
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((s + BQ - 1) / BQ, bh);
  flash_attn_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int s, int d, float scale,
                       int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, bh, s, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, s, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, s, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, s, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int singa_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int s, int d, int dtype,
                         int causal, float scale, void* stream) {
  if (bh < 1 || bh > 65535 || s < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(q, k, v, o, l, bh, s, d, scale, causal, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, l, bh, s, d, scale, causal,
                                       st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* singa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
