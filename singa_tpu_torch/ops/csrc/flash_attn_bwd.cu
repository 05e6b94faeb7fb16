// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, plain C interface for ctypes.
//
// Replaces: singa_tpu/ops/pallas_kernels.py `_flash_bwd` (:511-556), whose
// two pallas_calls are the dq kernel (call at :525, body `_attn_dq_kernel`
// at :417) and the dk/dv kernel (call at :539, body `_attn_dkv_kernel` at
// :433). Same functions, per (batch, head), with P = exp(s - lse) recomputed
// from the forward's row logsumexp and delta = rowsum(dO * O):
//   dq = (P * (dP - delta)) k * scale,   dP = dO v^T
//   dv = P^T dO,   dk = (P * (dP - delta))^T q * scale
// The JAX package computes delta outside its kernels; here the dq kernel
// computes it for its query rows and writes it out for the dk/dv kernel,
// which runs after it on the same stream.
//
// Design: the Pallas kernels keep a head's whole K and V (dq), or Q and dO
// (dk/dv), resident in VMEM; at S=1024, D=64 in f32 that is 256 KB per
// operand, above the 227 KB a Hopper block may use. So both are tiled like
// the forward kernel (flash_attn_fwd.cu): one 256-thread block per (64 rows,
// batch*head), a loop over 64-row tiles of the other operand staged in
// shared memory, and the output rows accumulated in f32 registers.
//   dq kernel:   block = 64 query rows; loop over K/V tiles 0 .. the causal
//                diagonal; dq in registers. Heaviest (last) tiles first.
//   dk/dv kernel: block = 64 key rows; loop over Q/dO tiles from the causal
//                diagonal to the end; dk and dv in registers.
// The split keeps every output written by exactly one block: no atomics,
// and the result does not depend on scheduling. Scores are formed exactly
// as the forward kernel forms them (q scaled on load, the same f32 FMA
// order over d, masked scores excluded), so P = exp(s - lse) uses the same
// s the forward normalised.
//
// Bound on this card: per (query, key) pair the mask keeps, the dq kernel
// does 3 products of 2*D operations (s, dP, dq) and the dk/dv kernel 4 (s,
// dP, dv, dk), against reading each operand once: far above the card's
// balance, so both are bound by operations. This version does them with
// plain f32 FMAs (67 TFLOP/s peak outside the tensor cores, 989 TFLOP/s in
// bf16 on them); wgmma, TMA and pipelining are later work.
//
// Inputs are contiguous [B*H, S, D] in f32 or bf16, lse and delta [B*H, S]
// f32; D in {16, 32, 64, 128} is a template parameter. Accumulation is f32.
// The kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each owning a 4-row slab
constexpr int WARPS = THREADS / 32;
constexpr int SLD = BK + 1;   // padded row stride of the score tiles
static_assert(BQ == BK, "the causal tile ranges assume square tiles");

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

// Stage rows [r0, r0 + 64) of a [S, D] operand into shared memory with row
// stride D+1 (rows past S are zeros), optionally scaled.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int S, float mul) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] =
        (r0 + r < S) ? to_f32(src[(size_t)(r0 + r) * D + c]) * mul : 0.f;
  }
}

// ---------------------------------------------------------------- dq kernel
// Shared memory, in floats: q (scaled), dO, k, v with row stride D+1 (the
// 16 threads of a half-warp read 16 rows at one column: 16 banks), the dS
// tile, and lse and delta of the block's query rows.
template <int D>
struct DqSmem {
  static constexpr int LD = D + 1;
  static constexpr int TILE = 64 * LD;
  static constexpr int TOTAL = 4 * TILE + BQ * SLD + 2 * BQ;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq,
                         int S, float scale, int causal) {
  using L = DqSmem<D>;
  constexpr int LD = L::LD;
  constexpr int CPT = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + L::TILE;
  float* k_s = do_s + L::TILE;
  float* v_s = k_s + L::TILE;
  float* ds_s = v_s + L::TILE;
  float* lse_s = ds_s + BQ * SLD;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  dq += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  stage<T, D>(q_s, q, q0, S, scale);
  stage<T, D>(do_s, dout, q0, S, 1.f);
  __syncthreads();
  // delta = rowsum(dO * O) in f32: one warp per row.
  for (int rr = 0; rr < BQ / WARPS; ++rr) {
    const int r = warp * (BQ / WARPS) + rr;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < S)
      for (int c = lane; c < D; c += 32)
        acc += do_s[r * LD + c] * to_f32(o[(size_t)qi * D + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      dl_s[r] = acc;
      lse_s[r] = qi < S ? lse[qi] : 0.f;
      if (qi < S) delta[qi] = acc;
    }
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int n_kv = (S + BK - 1) / BK;
  const int n_tiles = causal ? qt + 1 : n_kv;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of k_s, v_s, ds_s are done
    stage<T, D>(k_s, k, k0, S, 1.f);
    stage<T, D>(v_s, v, k0, S, 1.f);
    __syncthreads();

    // s = q k^T and dP = dO v^T for this thread's 4 rows x columns tx,
    // tx+16, tx+32, tx+48 of the tile.
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], a2[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(ty * 4 + i) * LD + d];
        a2[i] = do_s[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = k_s[(tx + 16 * j) * LD + d];
        b2[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
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
        const float p = keep ? expf(sc[i][j] - lse_s[r]) : 0.f;
        ds_s[r * SLD + c] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

    // dq += dS k for this thread's 4 rows x CPT columns.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[(ty * 4 + i) * SLD + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kv = k_s[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < S) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        dq[(size_t)qi * D + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// ------------------------------------------------------------ dk/dv kernel
// Shared memory, in floats: k, v (the block's key rows), q (scaled) and dO
// (the current query tile) with row stride D+1, the P and dS tiles with
// rows = keys, and lse and delta of the query tile.
template <int D>
struct DkvSmem {
  static constexpr int LD = D + 1;
  static constexpr int TILE = 64 * LD;
  static constexpr int TOTAL = 4 * TILE + 2 * BK * SLD + 2 * BQ;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          float scale, int causal) {
  using L = DkvSmem<D>;
  constexpr int LD = L::LD;
  constexpr int CPT = D / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + L::TILE;
  float* q_s = v_s + L::TILE;
  float* do_s = q_s + L::TILE;
  float* p_s = do_s + L::TILE;
  float* ds_s = p_s + BK * SLD;
  float* lse_s = ds_s + BK * SLD;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query / column group
  const int ty = tid / 16;  // key rows ty*4 .. ty*4+3
  // Under the causal mask the first key tiles see the most query tiles:
  // blockIdx.x order already hands them out first.
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base;
  k += base;
  v += base;
  dout += base;
  dk += base;
  dv += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  stage<T, D>(k_s, k, k0, S, 1.f);
  stage<T, D>(v_s, v, k0, S, 1.f);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (S + BQ - 1) / BQ;
  for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads of q_s, do_s, p_s are done
    stage<T, D>(q_s, q, q0, S, scale);
    stage<T, D>(do_s, dout, q0, S, 1.f);
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      lse_s[tid] = in ? lse[q0 + tid] : 0.f;
      dl_s[tid] = in ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dP^T = v dO^T for this thread's 4 key rows x query
    // columns tx, tx+16, tx+32, tx+48. fmaf is symmetric in its first two
    // arguments, so s is bit-identical to the forward's q k^T.
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], a2[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = k_s[(ty * 4 + i) * LD + d];
        a2[i] = v_s[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = q_s[(tx + 16 * j) * LD + d];
        b2[j] = do_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(b[j], a[i], sc[i][j]);
          dp[i][j] = fmaf(b2[j], a2[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int ki = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qi = q0 + c;
        const bool keep = ki < S && qi < S && (!causal || ki <= qi);
        const float p = keep ? expf(sc[i][j] - lse_s[c]) : 0.f;
        p_s[r * SLD + c] = p;
        ds_s[r * SLD + c] = p * (dp[i][j] - dl_s[c]);
      }
    }
    __syncthreads();

    // dv += P^T dO and dk += dS^T (q * scale) for 4 key rows x CPT columns.
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = p_s[(ty * 4 + i) * SLD + qq];
        dd[i] = ds_s[(ty * 4 + i) * SLD + qq];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float dov = do_s[qq * LD + tx + 16 * j];
        const float qv = q_s[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pp[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dd[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki < S) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const size_t g = (size_t)ki * D + tx + 16 * j;
        dk[g] = from_f32<T>(dk_acc[i][j]);  // q_s already carries scale
        dv[g] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be opted into, once per
// kernel instantiation (thread-safe static initialisation).
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int bh, int s, float scale,
                      int causal, cudaStream_t st) {
  constexpr size_t bytes = DqSmem<D>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((s + BQ - 1) / BQ, bh);
  flash_attn_dq_kernel<T, D><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), s, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int s,
                       float scale, int causal, cudaStream_t st) {
  constexpr size_t bytes = DkvSmem<D>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((s + BK - 1) / BK, bh);
  flash_attn_dkv_kernel<T, D><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), s, scale, causal);
  return cudaGetLastError();
}

#define SINGA_DISPATCH_D(FN, T, ...)          \
  switch (d) {                                \
    case 16:                                  \
      return FN<T, 16>(__VA_ARGS__);          \
    case 32:                                  \
      return FN<T, 32>(__VA_ARGS__);          \
    case 64:                                  \
      return FN<T, 64>(__VA_ARGS__);          \
    case 128:                                 \
      return FN<T, 128>(__VA_ARGS__);         \
    default:                                  \
      return cudaErrorInvalidValue;           \
  }

template <typename T>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 int bh, int s, int d, float scale, int causal,
                 cudaStream_t st) {
  SINGA_DISPATCH_D(launch_dq, T, q, k, v, o, dout, lse, delta, dq, bh, s,
                   scale, causal, st)
}

template <typename T>
cudaError_t dkv_d(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int s, int d, float scale,
                  int causal, cudaStream_t st) {
  SINGA_DISPATCH_D(launch_dkv, T, q, k, v, dout, lse, delta, dk, dv, bh, s,
                   scale, causal, st)
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq: [bh, s, d];
// lse: [bh, s] f32 from the forward; delta: [bh, s] f32, written here.
// Returns a cudaError_t (0 on success).
int singa_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int bh, int s, int d,
                            int dtype, int causal, float scale,
                            void* stream) {
  if (bh < 1 || bh > 65535 || s < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (dtype) {
    case 0:
      return dq_d<float>(q, k, v, o, dout, l, dl, dq, bh, s, d, scale,
                         causal, st);
    case 1:
      return dq_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, bh, s, d,
                                 scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// delta: [bh, s] f32 as the dq kernel wrote it; dk, dv: [bh, s, d].
int singa_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int s, int d, int dtype, int causal,
                             float scale, void* stream) {
  if (bh < 1 || bh > 65535 || s < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return dkv_d<float>(q, k, v, dout, l, dl, dk, dv, bh, s, d, scale,
                          causal, st);
    case 1:
      return dkv_d<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, bh, s, d,
                                  scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* singa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
