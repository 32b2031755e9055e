// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_pallas (Pallas body
// _ssd_kernel). For each (batch, head), over the sequence in chunks of Q
// steps, with cum the running sum of dt * A inside the chunk:
//   y_i    = sum_{j <= i} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j
//            + e^{cum_i} C_i . state
//   state <- e^{cum_last} state + sum_j B_j (dt_j e^{cum_last - cum_j}) x_j^T
// y is written in x's type; the final (N, P) state in fp32.
//
// Bound on the H100: bytes. At the serve shape (B=8, S=256, H=32, P=64,
// N=128) the function moves ~26.5 MB of operands once; the recurrence it
// computes needs 5NP operations per step per (b, h), ~2.7 GFLOP, about
// 100 flops per byte, under the ~295 where the card stops being memory
// bound at its bf16 rate.
//
// Design: the TPU grid (B, H, S/Q) runs its chunk axis in order with the
// state in VMEM scratch. Here one CTA owns one (b, h) and walks the whole
// sequence itself, with the (N, P) fp32 state in shared memory, so the
// state never leaves the SM until the end. A TPU chunk of 256 steps would
// need a 256 KB fp32 score tile, more than a CTA may hold, so the CTA walks
// sub-chunks of kQ = 32 steps; the result does not depend on the chunking.
// Per sub-chunk: stage x, B^T and C^T (padded rows, no bank conflicts) as
// fp32; warp 0 scans dt * A; the masked decay matrix M is formed only
// where i >= j, so e^{cum_i - cum_j} never overflows; y = M x + e^{cum}
// C state; then the state update. A 16 x 16 thread grid gives each thread a
// register tile of every product. Steps at or past S are staged as dt = 0
// and x = B = C = 0: they leave the state unchanged and write no y. B and C
// are read through strides, so a group broadcast over heads (head stride 0)
// is read once per group row, never materialised. The arithmetic is fp32
// FMA on the CUDA cores; tensor cores (wgmma) are a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 32;         // steps per sub-chunk (one warp scans it)
constexpr int kGrid = 16;      // threads per side of the 16 x 16 thread grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kLd = kQ + 1;    // padded row stride of the B^T, C^T and M tiles

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, s, h;
};

template <int N, int P>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * N * kLd + kQ * P + N * P + kQ * kLd + 3 * kQ);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state,
           int s_len, int heads, Strides xs, Strides dts, Strides bs, Strides cs,
           Strides ys) {
  constexpr int RQ = kQ / kGrid, RN = N / kGrid, RP = P / kGrid;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ti = tid / kGrid, tj = tid % kGrid;

  extern __shared__ float smem[];
  float* Bt = smem;              // [N][kLd]  B^T of the sub-chunk
  float* Ct = Bt + N * kLd;      // [N][kLd]  C^T
  float* Xs = Ct + N * kLd;      // [kQ][P]
  float* St = Xs + kQ * P;       // [N][P]    the carried state
  float* Ms = St + N * P;        // [kQ][kLd] masked decay-weighted scores
  float* cum = Ms + kQ * kLd;    // [kQ]      inclusive sum of dt * A
  float* dtv = cum + kQ;         // [kQ]
  float* w = dtv + kQ;           // [kQ]      dt_j e^{cum_last - cum_j}

  // each thread owns the state entries (ti + 16 r, tj + 16 c)
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < RP; ++c) St[(ti + kGrid * r) * P + tj + kGrid * c] = 0.f;

  const float a = A[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const T* bb = Bm + b * bs.b + h * bs.h;
  const T* cb = Cm + b * cs.b + h * cs.h;
  T* yb = y + b * ys.b + h * ys.h;

  for (int t0 = 0; t0 < s_len; t0 += kQ) {
    const int nv = min(kQ, s_len - t0);
    __syncthreads();  // the previous sub-chunk is done with the tiles

    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int j = idx / P, c = idx % P;
      Xs[idx] = j < nv ? to_float(xb[(t0 + j) * xs.s + c]) : 0.f;
    }
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int j = idx / N, c = idx % N;
      const bool ok = j < nv;
      Bt[c * kLd + j] = ok ? to_float(bb[(t0 + j) * bs.s + c]) : 0.f;
      Ct[c * kLd + j] = ok ? to_float(cb[(t0 + j) * cs.s + c]) : 0.f;
    }
    if (tid < 32) {  // warp 0: inclusive scan of dt * A over the kQ = 32 steps
      const float d = tid < nv ? dtb[(t0 + tid) * dts.s] : 0.f;
      float c = d * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, c, o);
        if (tid >= o) c += v;
      }
      const float last = __shfl_sync(0xffffffffu, c, 31);
      cum[tid] = c;
      dtv[tid] = d;
      w[tid] = d * expf(last - c);
    }
    __syncthreads();

    {  // M[i][j] = (C_i . B_j) e^{cum_i - cum_j} dt_j for j <= i, else 0
      float g[RQ][RQ] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RQ], bv[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          cv[r] = Ct[n * kLd + ti + kGrid * r];
          bv[r] = Bt[n * kLd + tj + kGrid * r];
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < RQ; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = ti + kGrid * r;
#pragma unroll
        for (int c = 0; c < RQ; ++c) {
          const int j = tj + kGrid * c;
          Ms[i * kLd + j] = j <= i ? g[r][c] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
        }
      }
    }
    __syncthreads();

    {  // y = M x + e^{cum} (C state), for the rows before S
      float intra[RQ][RP] = {}, inter[RQ][RP] = {};
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        float mv[RQ], xv[RP];
#pragma unroll
        for (int r = 0; r < RQ; ++r) mv[r] = Ms[(ti + kGrid * r) * kLd + j];
#pragma unroll
        for (int c = 0; c < RP; ++c) xv[c] = Xs[j * P + tj + kGrid * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) intra[r][c] = fmaf(mv[r], xv[c], intra[r][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RQ], sv[RP];
#pragma unroll
        for (int r = 0; r < RQ; ++r) cv[r] = Ct[n * kLd + ti + kGrid * r];
#pragma unroll
        for (int c = 0; c < RP; ++c) sv[c] = St[n * P + tj + kGrid * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) inter[r][c] = fmaf(cv[r], sv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = ti + kGrid * r;
        if (i < nv) {
          const float e = expf(cum[i]);
          T* row = yb + (t0 + i) * ys.s;
#pragma unroll
          for (int c = 0; c < RP; ++c) {
            row[tj + kGrid * c] = from_float<T>(fmaf(e, inter[r][c], intra[r][c]));
          }
        }
      }
    }
    __syncthreads();  // every thread has read the state before it changes

    {  // state <- e^{cum_last} state + (B w)^T x, each thread its own entries
      const float decay = expf(cum[kQ - 1]);
      float acc[RN][RP];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < RP; ++c) acc[r][c] = St[(ti + kGrid * r) * P + tj + kGrid * c] * decay;
#pragma unroll 2
      for (int j = 0; j < kQ; ++j) {
        const float wj = w[j];
        float bv[RN], xv[RP];
#pragma unroll
        for (int r = 0; r < RN; ++r) bv[r] = Bt[(ti + kGrid * r) * kLd + j] * wj;
#pragma unroll
        for (int c = 0; c < RP; ++c) xv[c] = Xs[j * P + tj + kGrid * c];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < RP; ++c) St[(ti + kGrid * r) * P + tj + kGrid * c] = acc[r][c];
    }
  }

  float* out = state + (static_cast<long long>(b) * heads + h) * N * P;
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < RP; ++c) {
      const int idx = (ti + kGrid * r) * P + tj + kGrid * c;
      out[idx] = St[idx];
    }
}

template <typename T, int N, int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state, int b, int s, int h, Strides xs, Strides dts, Strides bs,
           Strides cs, Strides ys, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N, P>();
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, N, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T, N, P><<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), s, h, xs, dts, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

// The (N, P) pairs of the ported configs: mamba2-370m's (128, 64) and its
// reduced config's (16, 16).
template <typename T>
int dispatch(int n, int p, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, int b, int s, int h, Strides xs,
             Strides dts, Strides bs, Strides cs, Strides ys, cudaStream_t st) {
  if (n == 128 && p == 64)
    return launch<T, 128, 64>(x, dt, A, Bm, Cm, y, state, b, s, h, xs, dts, bs, cs, ys, st);
  if (n == 16 && p == 16)
    return launch<T, 16, 16>(x, dt, A, Bm, Cm, y, state, b, s, h, xs, dts, bs, cs, ys, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (B,S,H,P) and y: (B,S,H,P) through (batch, seq, head) strides, unit
// stride on P; dt: (B,S,H) fp32 through strides; A: (H,) fp32; B, C:
// (B,S,H,N) through strides (a head stride of 0 broadcasts one group), unit
// stride on N; state: contiguous (B,H,N,P) fp32. (N, P) is (128, 64) or
// (16, 16). dtype (x, B, C, y): 0 float32, 1 bfloat16. Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, void* y, void* state, int b, int s, int h, int n,
                          int p, long long xsb, long long xss, long long xsh, long long dsb,
                          long long dss, long long dsh, long long bsb, long long bss,
                          long long bsh, long long csb, long long css, long long csh,
                          long long ysb, long long yss, long long ysh, int dtype,
                          void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xss, xsh}, dts{dsb, dss, dsh}, bs{bsb, bss, bsh}, cs{csb, css, csh},
      ys{ysb, yss, ysh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(n, p, x, dt, A, Bm, Cm, y, state, b, s, h, xs, dts, bs, cs,
                                   ys, st);
  }
  if (dtype == 0) {
    return dispatch<float>(n, p, x, dt, A, Bm, Cm, y, state, b, s, h, xs, dts, bs, cs, ys, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
