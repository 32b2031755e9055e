// Split-KV flash-decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py::decode_attention
// (Pallas body _decode_kernel): one query token per (batch, q head) against
// a KV cache, positions <= pos valid, GQA head h -> KV head h / (Hq / Hkv).
//
// Bound on the H100: bytes. A step reads each valid cache row of K and V
// once, about one flop per byte read, so it can go no faster than the cache
// bytes up to pos over 3.35 TB/s.
//
// Design: on the TPU the KV axis is a sequential grid axis with the running
// (max, sum, acc) in scratch. Here the batch gives only B*Hkv = 32 (b, KV
// head) pairs at the serve batch, too few for 132 SMs, so the cache length
// is split: pass 1 runs one CTA per (64-key slice, KV head, batch) and
// serves all Hq/Hkv q heads of that KV head from one shared-memory copy of
// the slice, so each cache row is read from device memory once, not once per
// q head. It writes a partial (max, sum, acc) per (b, q head, slice).
// Pass 2 merges the slices. pos is read on the device from an int32 tensor
// (the TPU's scalar prefetch), so the host never waits on it; slices wholly
// past pos exit at once and write an empty partial. The cache is read
// through strides, so the model's (B,S,Hkv,d) layout passes as it is, and
// any S works (the last slice is masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 64;     // keys per pass-1 CTA (SPLIT in kernel.py)
constexpr int kMaxGroup = 16;  // q heads per KV head (MAX_GROUP in kernel.py)
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
size_t split_smem_bytes(int group) {
  return sizeof(float) * (group * D + kSplit * (D + 1) + kSplit * D + group * kSplit);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int hq, int hkv, int s, int nsplit,
                    long long qsb, long long qsh, Strides ks, Strides vs, float scale) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int valid_end = min(s, *pos_ptr + 1);
  const int s0 = split * kSplit;
  const int n = min(kSplit, valid_end - s0);
  // partial index of (b, q head hk*group + g, split)
  const long long part0 = (static_cast<long long>(b) * hq + hk * group) * nsplit + split;

  if (n <= 0) {  // the whole slice lies past pos
    for (int idx = tid; idx < group * D; idx += kThreads) {
      part_acc[(part0 + (idx / D) * nsplit) * D + idx % D] = 0.f;
    }
    if (tid < group) {
      part_m[part0 + tid * nsplit] = kNegInf;
      part_l[part0 + tid * nsplit] = 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* Qs = smem;                    // [group][D], pre-scaled
  float* Ks = Qs + group * D;          // [kSplit][D + 1]
  float* Vs = Ks + kSplit * (D + 1);   // [kSplit][D]
  float* Sc = Vs + kSplit * D;         // [group][kSplit]

  for (int idx = tid; idx < group * D; idx += kThreads) {
    const int g = idx / D, c = idx % D;
    Qs[idx] = to_float(q[b * qsb + (hk * group + g) * qsh + c]) * scale;
  }
  const T* kb = k + b * ks.b + hk * ks.h + s0 * ks.s;
  const T* vb = v + b * vs.b + hk * vs.h + s0 * vs.s;
  for (int idx = tid; idx < n * D; idx += kThreads) {
    const int j = idx / D, c = idx % D;
    Ks[j * (D + 1) + c] = to_float(kb[j * ks.s + c]);
    Vs[j * D + c] = to_float(vb[j * vs.s + c]);
  }
  __syncthreads();

  for (int idx = tid; idx < group * kSplit; idx += kThreads) {
    const int g = idx / kSplit, j = idx % kSplit;
    float dot = kNegInf;
    if (j < n) {
      dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(Qs[g * D + c], Ks[j * (D + 1) + c], dot);
    }
    Sc[idx] = dot;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int g = warp; g < group; g += kThreads / 32) {
    float* row = Sc + g * kSplit;
    float mx = fmaxf(row[lane], row[lane + 32]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float p0 = __expf(row[lane] - mx), p1 = __expf(row[lane + 32] - mx);
    row[lane] = p0;
    row[lane + 32] = p1;
    float sum = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part_m[part0 + g * nsplit] = mx;
      part_l[part0 + g * nsplit] = sum;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < group * D; idx += kThreads) {
    const int g = idx / D, c = idx % D;
    const float* p = Sc + g * kSplit;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(p[j], Vs[j * D + c], acc);
    part_acc[(part0 + g * nsplit) * D + c] = acc;
  }
}

template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    T* __restrict__ out, int hq, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const long long base = (static_cast<long long>(b) * hq + h) * nsplit;
  float m = kNegInf;
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, part_m[base + i]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float w = __expf(part_m[base + i] - m);
    l = fmaf(part_l[base + i], w, l);
    acc = fmaf(part_acc[(base + i) * D + c], w, acc);
  }
  out[(static_cast<long long>(b) * hq + h) * D + c] = from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pos, void* o,
           void* part_m, void* part_l, void* part_acc, int b, int hq, int hkv, int s,
           int nsplit, long long qsb, long long qsh, Strides ks, Strides vs, float scale,
           cudaStream_t stream) {
  const size_t smem = split_smem_bytes<D>(hq / hkv);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T, D><<<dim3(nsplit, hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), hq, hkv, s, nsplit,
      qsb, qsh, ks, vs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T, D><<<dim3(hq, b), D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(o), hq, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const void* pos,
               void* o, void* pm, void* pl, void* pa, int b, int hq, int hkv, int s,
               int nsplit, long long qsb, long long qsh, Strides ks, Strides vs,
               float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, pos, o, pm, pl, pa, b, hq, hkv, s, nsplit, qsb, qsh, ks, vs, scale, st);
    case 32: return launch<T, 32>(q, k, v, pos, o, pm, pl, pa, b, hq, hkv, s, nsplit, qsb, qsh, ks, vs, scale, st);
    case 64: return launch<T, 64>(q, k, v, pos, o, pm, pl, pa, b, hq, hkv, s, nsplit, qsb, qsh, ks, vs, scale, st);
    case 128: return launch<T, 128>(q, k, v, pos, o, pm, pl, pa, b, hq, hkv, s, nsplit, qsb, qsh, ks, vs, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B,Hq,1,D) through (batch, head) strides; caches (B,Hkv,S,D) through
// (batch, head, seq) strides, unit stride on D; pos: one int32 on the
// device; o: contiguous (B,Hq,1,D). part_m, part_l: (B,Hq,nsplit) fp32 and
// part_acc: (B,Hq,nsplit,D) fp32 scratch, nsplit = ceil(S / 64).
// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* part_m, void* part_l, void* part_acc, int b, int hq, int hkv, int s, int d,
    int nsplit, long long qsb, long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup || s <= 0 ||
      nsplit != (s + kSplit - 1) / kSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, pos, o, part_m, part_l, part_acc, b, hq,
                                     hkv, s, nsplit, qsb, qsh, ks, vs, scale, st);
  }
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, pos, o, part_m, part_l, part_acc, b, hq, hkv, s,
                             nsplit, qsb, qsh, ks, vs, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
