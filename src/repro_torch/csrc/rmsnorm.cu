// Fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::fused_residual_rmsnorm
// (Pallas body _rmsnorm_kernel): h = x + r; y = h * rsqrt(mean(h^2) + eps)
// * scale, statistics in fp32, y and h stored in x's type.
//
// Bound on the H100: bytes. Per row it reads x, r and scale and writes y and
// h, about two flops per byte, far below the ~295 flops per byte where the
// card stops being memory bound.
//
// Design: one CTA per row, so the row's sum of squares never leaves the SM.
// Each thread loads 16-byte vectors (8 bf16 or 4 fp32), neighbouring threads
// on neighbouring addresses, and keeps h in registers (at most 8 vectors a
// thread), so x and r are read once and y and h written once in a single
// pass. The sum of squares is reduced by warp shuffles and then across warps
// through shared memory. A null residual gives plain RMSNorm and writes no h.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxVecPerThread = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int N = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  constexpr int N = 16 / sizeof(T);
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kHasResidual>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                               const T* __restrict__ scale, T* __restrict__ y,
                               T* __restrict__ h_out, int d, float eps) {
  constexpr int N = 16 / sizeof(T);
  const int nvec = d / N;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  float h[kMaxVecPerThread][N];
  float sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      load_vec(x + base + v * N, h[i]);
      if (kHasResidual) {
        float rr[N];
        load_vec(r + base + v * N, rr);
#pragma unroll
        for (int j = 0; j < N; ++j) h[i][j] += rr[j];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) sumsq += h[i][j] * h[i][j];
    }
  }

  __shared__ float warp_sums[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sumsq = warp_sum(sumsq);
  if (lane == 0) warp_sums[warp] = sumsq;
  __syncthreads();
  if (warp == 0) {
    float s = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) total = s;
  }
  __syncthreads();
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < kMaxVecPerThread; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      float sc[N], out[N];
      load_vec(scale + v * N, sc);
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = h[i][j] * inv * sc[j];
      store_vec(y + base + v * N, out);
      if (kHasResidual) store_vec(h_out + base + v * N, h[i]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* r, const void* scale, void* y, void* h,
            int rows, int d, float eps, int threads, cudaStream_t stream) {
  if (r != nullptr) {
    rmsnorm_kernel<T, true><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(scale), static_cast<T*>(y), static_cast<T*>(h), d, eps);
  } else {
    rmsnorm_kernel<T, false><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(scale),
        static_cast<T*>(y), nullptr, d, eps);
  }
}

}  // namespace

// x, r, y, h: (rows, d) contiguous; scale: (d,). r and h may be null.
// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* r, const void* scale, void* y,
                              void* h, int rows, int d, float eps, int dtype,
                              void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  const int nvec = d / vec;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (rows <= 0 || d % vec != 0 || nvec > threads * kMaxVecPerThread) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__nv_bfloat16>(x, r, scale, y, h, rows, d, eps, threads, s);
  } else if (dtype == 0) {
    launch<float>(x, r, scale, y, h, rows, d, eps, threads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
