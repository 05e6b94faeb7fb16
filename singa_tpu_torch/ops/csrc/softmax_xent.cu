// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: singa_tpu/ops/pallas_kernels.py `_softmax_xent_fwd` (pallas_call
// at :171, kernel body `_xent_fwd_kernel` at :117) and `_softmax_xent_bwd`
// (pallas_call at :193, kernel body `_xent_bwd_kernel` at :132). Same
// functions: per row, loss = logsumexp(x) - x[label] in f32, and
// dx = (softmax(x) - onehot(label)) * g with the softmax recomputed; a label
// < 0 or >= C gives zero loss and a zero gradient row.
//
// Design: the TPU kernels tile rows by a VMEM budget and hold a (rows, C)
// block at once. Here one thread block owns one row and streams it: a single
// online pass keeps a running max m and sum s = sum(exp(x - m)) per thread
// in f32 (the sum is rescaled when the max grows), then the threads' (m, s)
// pairs are merged through shared memory. The backward makes that pass
// again and a second pass that writes dx, so no softmax is ever stored.
// Rows are read with 16-byte vector loads (8 bf16 or 4 f32 values) when the
// row stride and base allow it, else one value at a time. bf16 logits are
// upcast in registers: the JAX op casts them to f32 first, which is exact,
// so the result is the same without a f32 copy of the logits.
//
// Bound on this card: a few operations per logit against 2 or 4 bytes read
// (and as many written by the backward), far below the H100's balance, so
// both kernels are bound by bytes: at (8192, 32000) bf16 the forward reads
// 524 MB (0.157 ms at 3.35 TB/s), the backward reads and writes 1.05 GB.
// The design reads each logit once in the forward and twice in the backward
// (the second read mostly hits L2 for a 64 KB row).
//
// The kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 32;

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

// One 16-byte vector of T (aligned, so that it loads as one 16-byte access).
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// Merge two partial (max, sum) pairs; an empty pair has m = -inf, s = 0.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mm = fmaxf(m, m2);
  const float a = (m == -INFINITY) ? 0.f : s * expf(m - mm);
  const float b = (m2 == -INFINITY) ? 0.f : s2 * expf(m2 - mm);
  m = mm;
  s = a + b;
}

// Fold values v[0..n) into the running (m, s).
template <int N>
__device__ __forceinline__ void fold(float& m, float& s, const float* v) {
  float vm = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) vm = fmaxf(vm, v[i]);
  const float mm = fmaxf(m, vm);
  float acc = (m == -INFINITY) ? 0.f : s * expf(m - mm);
#pragma unroll
  for (int i = 0; i < N; ++i) acc += expf(v[i] - mm);
  m = mm;
  s = acc;
}

// Each thread's running (m, s) over row x[0..C), then merged across the
// block; every thread returns the row's (m, s).
template <typename T, bool VEC>
__device__ void row_max_sum(const T* __restrict__ x, int C, float* red_m,
                            float* red_s, float& m_out, float& s_out) {
  float m = -INFINITY, s = 0.f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const int nv = C / N;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const Vec<T> t = xv[i];
      float f[N];
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = to_f32(t.v[j]);
      fold<N>(m, s, f);
    }
  } else {
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      const float f = to_f32(x[i]);
      fold<1>(m, s, &f);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < nwarps ? red_m[lane] : -INFINITY;
    s = lane < nwarps ? red_s[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      red_m[0] = m;
      red_s[0] = s;
    }
  }
  __syncthreads();
  m_out = red_m[0];
  s_out = red_s[0];
}

template <typename T, bool VEC>
__global__ void xent_fwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                float* __restrict__ loss, int C) {
  __shared__ float red_m[MAX_WARPS], red_s[MAX_WARPS];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)C;
  const int lab = labels[row];
  const bool valid = lab >= 0 && lab < C;
  if (!valid) {  // uniform over the block: no barrier is skipped by some
    if (threadIdx.x == 0) loss[row] = 0.f;
    return;
  }
  float m, s;
  row_max_sum<T, VEC>(xr, C, red_m, red_s, m, s);
  if (threadIdx.x == 0) loss[row] = logf(s) + m - to_f32(xr[lab]);
}

template <typename T, bool VEC>
__global__ void xent_bwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                const float* __restrict__ g,
                                T* __restrict__ dx, int C) {
  __shared__ float red_m[MAX_WARPS], red_s[MAX_WARPS];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)C;
  T* dr = dx + row * (size_t)C;
  const int lab = labels[row];
  const bool valid = lab >= 0 && lab < C;
  float m = 0.f, inv = 0.f, gr = 0.f;
  if (valid) {  // uniform over the block
    float s;
    row_max_sum<T, VEC>(xr, C, red_m, red_s, m, s);
    inv = 1.f / s;
    gr = g[row];
  }
  // An invalid row writes zeros (gr = 0 and the onehot term is never hit).
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    Vec<T>* dv = reinterpret_cast<Vec<T>*>(dr);
    const int nv = C / N;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      Vec<T> out;
      if (valid) {
        const Vec<T> t = xv[i];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float p = expf(to_f32(t.v[j]) - m) * inv;
          const float oh = (i * N + j == lab) ? 1.f : 0.f;
          out.v[j] = from_f32<T>((p - oh) * gr);
        }
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) out.v[j] = from_f32<T>(0.f);
      }
      dv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      float d = 0.f;
      if (valid) {
        const float p = expf(to_f32(xr[i]) - m) * inv;
        d = (p - (i == lab ? 1.f : 0.f)) * gr;
      }
      dr[i] = from_f32<T>(d);
    }
  }
}

// Threads per row: enough to cover the row with vector loads, 32 to 256.
int threads_for(int C, int per_load) {
  const int loads = (C + per_load - 1) / per_load;
  int t = 32;
  while (t < 256 && t < loads) t *= 2;
  return t;
}

template <typename T>
bool vectorizable(const void* p, const void* q, int C) {
  constexpr int N = Vec<T>::N;
  return C % N == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0);
}

template <typename T>
cudaError_t fwd(const void* x, const int* labels, float* loss, int rows,
                int C, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (vectorizable<T>(x, nullptr, C)) {
    xent_fwd_kernel<T, true><<<rows, threads_for(C, Vec<T>::N), 0, st>>>(
        xt, labels, loss, C);
  } else {
    xent_fwd_kernel<T, false><<<rows, threads_for(C, 1), 0, st>>>(
        xt, labels, loss, C);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const int* labels, const float* g, void* dx,
                int rows, int C, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* dt = static_cast<T*>(dx);
  if (vectorizable<T>(x, dx, C)) {
    xent_bwd_kernel<T, true><<<rows, threads_for(C, Vec<T>::N), 0, st>>>(
        xt, labels, g, dt, C);
  } else {
    xent_bwd_kernel<T, false><<<rows, threads_for(C, 1), 0, st>>>(
        xt, labels, g, dt, C);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous (rows, C) logits, dtype 0 = float32, 1 = bfloat16; labels:
// (rows,) int32; loss: (rows,) float32. Returns a cudaError_t (0 = success).
int singa_softmax_xent_fwd(const void* x, const void* labels, void* loss,
                           int rows, int C, int dtype, void* stream) {
  if (rows < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* out = static_cast<float*>(loss);
  switch (dtype) {
    case 0:
      return fwd<float>(x, lab, out, rows, C, st);
    case 1:
      return fwd<__nv_bfloat16>(x, lab, out, rows, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// g: (rows,) float32 upstream gradient per row; dx: (rows, C) in x's dtype.
int singa_softmax_xent_bwd(const void* x, const void* labels, const void* g,
                           void* dx, int rows, int C, int dtype,
                           void* stream) {
  if (rows < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* gr = static_cast<const float*>(g);
  switch (dtype) {
    case 0:
      return bwd<float>(x, lab, gr, dx, rows, C, st);
    case 1:
      return bwd<__nv_bfloat16>(x, lab, gr, dx, rows, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* singa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
