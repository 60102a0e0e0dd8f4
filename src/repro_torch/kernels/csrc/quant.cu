// Fake-quantization onto a symmetric fixed-point grid, for Hopper (sm_90a).
// Plain C entry points, bound from Python with ctypes (kernels/quant.py); each
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
//   out[i] = clip(round(x[i] / s), -lim, lim) * s      (in x's type)
//
// with the per-tensor scale s read from device memory (a 0-d fp32 tensor that
// the wrapper computes, so no host round trip), the division correctly
// rounded (__fdiv_rn: never a multiply by 1/s, which differs from the fp32
// quotient in the last bit), rintf for round-half-to-even, the clamp, then
// q * s as its own rounding and __float2bfloat16_rn for a bf16 output: the
// operations of the plain version (torch.round, torch.clamp, the product and
// .to(x.dtype)) in their order, so both agree bit for bit.
//
// Replaces, in the JAX package's src/repro/kernels/quant.py:
//   quantize_f32, quantize_bf16  <- quantize_pallas / _quant_kernel
//
// Bound on an H100: one read and one write of the tensor, bytes over the
// memory rate (about 0.1 ms for 90M bf16 elements).  The design is the
// plainest that reaches it: each thread moves 16 bytes a step (4 fp32 or 8
// bf16 elements) in a grid-stride loop, and a scalar loop takes the tail and
// any input the wrapper found not 16-byte aligned.  The TPU kernel's
// (256, 512) blocks, padding and crop are not carried over: a flat index
// needs none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;    // 16 blocks of 256 threads per SM

__device__ __forceinline__ float fake_quant(float x, float s, float lim) {
  float q = rintf(__fdiv_rn(x, s));
  q = q < -lim ? -lim : (q > lim ? lim : q);   // a NaN passes, as torch.clamp
  return __fmul_rn(q, s);
}

// storage types: fp32 as float, bf16 as its 16 bits
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);       // exact
}
template <typename S> __device__ __forceinline__ S from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ uint16_t from_float<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename S>
union Pack {
  uint4 u;
  S e[sizeof(uint4) / sizeof(S)];
};

// n elements; the first nvec * VEC of them as 16-byte packs (nvec is 0 when
// a pointer is not 16-byte aligned), the rest one at a time
template <typename S>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const S* __restrict__ x, const float* __restrict__ scale,
                S* __restrict__ out, long long n, long long nvec, float lim) {
  constexpr int VEC = sizeof(uint4) / sizeof(S);
  const float s = *scale;
  const long long step = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < nvec; i += step) {
    Pack<S> p;
    p.u = xv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      p.e[j] = from_float<S>(fake_quant(to_float(p.e[j]), s, lim));
    ov[i] = p.u;
  }
  for (long long i = nvec * VEC + tid; i < n; i += step)
    out[i] = from_float<S>(fake_quant(to_float(x[i]), s, lim));
}

template <typename S>
int launch(const void* x, const void* scale, void* out, long long n,
           int aligned, float lim, void* stream) {
  constexpr int VEC = sizeof(uint4) / sizeof(S);
  if (n <= 0) return 0;
  const long long nvec = aligned ? n / VEC : 0;
  const long long work = nvec > n - nvec * VEC ? nvec : n - nvec * VEC;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantize_kernel<S><<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const S*)x, (const float*)scale, (S*)out, n, nvec, lim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: n contiguous fp32 values; scale: one fp32 value on the device;
// aligned: both x and out are 16-byte aligned
int quantize_f32(const void* x, const void* scale, void* out, long long n,
                 int aligned, float lim, void* stream) {
  return launch<float>(x, scale, out, n, aligned, lim, stream);
}

// the same for bf16 x and out
int quantize_bf16(const void* x, const void* scale, void* out, long long n,
                  int aligned, float lim, void* stream) {
  return launch<uint16_t>(x, scale, out, n, aligned, lim, stream);
}

}  // extern "C"
