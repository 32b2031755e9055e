// Causal / sliding-window GQA flash attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas body _flash_kernel): online softmax over KV tiles with an fp32
// accumulator; q head h reads KV head h / (Hq / Hkv); masked scores are
// -1e30 as on the TPU.
//
// Bound on the H100: at the serve path's prefill (q (8,32,256,64), kv
// (8,4,256,64), bf16) the function moves ~19 MB (~5.6 us at 3.35 TB/s) and
// does ~2.2 GFLOP causal (~2.2 us on the tensor cores), so the bound is
// bytes. This first version computes on the CUDA cores in fp32 and is
// limited by their FMA rate and by shared-memory traffic, not by either
// bound; a wgmma/TMA redesign is later work.
//
// Design: the TPU's sequential KV grid axis becomes a loop inside the CTA.
// Grid = (ceil(Sq/64), Hq, B); 128 threads own a 64-row q tile. K and V
// tiles of 64 rows are staged through shared memory as fp32 (padded rows,
// no bank conflicts). Each thread computes a 4x8 block of the 64x64 score
// tile and a 4x(D/8) block of the output; the 8 threads sharing a row sit
// in one warp, so row max and row sum use three shuffles. The ragged last
// q and KV tiles are masked (loads outside the sequence read zeros), so no
// length needs to be a block multiple. Causal CTAs stop at their diagonal;
// windowed CTAs start at their window. Inputs are read through strides, so
// the model's (B,S,H,d) projections pass without a transpose copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][DP], pre-scaled
  float* Ks = Qs + kBQ * DP;        // [kBK][DP]
  float* Vs = Ks + kBK * DP;        // [kBK][DP]
  float* Ps = Vs + kBK * DP;        // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // score columns tx + 8j, output columns tx + 8j

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    Qs[r * DP + c] = qi < sq ? to_float(qb[qi * qs.s + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  int kv_end = skv;
  if (causal) kv_end = min(skv, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < skv;
      Ks[r * DP + c] = in ? to_float(kb[kj * ks.s + c]) : 0.f;
      Vs[r * DP + c] = in ? to_float(vb[kj * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        bool ok = kj < skv;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && (qi - kj) < window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = __expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a thread's P rows were written by its own warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[kk * DP + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < sq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j) ob[qi * os.s + tx + 8 * j] = from_float<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
           int hkv, int sq, int skv, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, sq, skv, qs, ks, vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, Strides qs, Strides ks, Strides vs,
               Strides os, float scale, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, qs, ks, vs, os, scale, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, qs, ks, vs, os, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, qs, ks, vs, os, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, qs, ks, vs, os, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B,Hq,Sq,D) and k, v: (B,Hkv,Skv,D) read through (batch, head, seq)
// strides in elements, unit stride on D. dtype: 0 float32, 1 bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
    int sq, int skv, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, sq, skv, qs, ks, vs, os,
                                     scale, causal, window, s);
  }
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, o, b, hq, hkv, sq, skv, qs, ks, vs, os, scale,
                             causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
