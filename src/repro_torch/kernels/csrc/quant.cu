// Fake-quantization onto a symmetric fixed-point grid, for Hopper (sm_90a).
// Plain C entry points, bound from Python with ctypes (kernels/quant.py); each
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
//   s = max(max|x|, 1e-12) / lim
//   out[i] = clip(round(x[i] / s), -lim, lim) * s      (in x's type)
//
// Two kernels.  absmax_kernel reads x once (16-byte loads, four in flight a
// thread), takes the max of |x| as the bits of a non-negative float (the
// sign bit cleared: for such floats the unsigned order is the float order,
// and a NaN's bits lie above inf's, so a NaN wins as torch's amax lets it),
// reduces a block by warp shuffles and writes the block's max to its own
// slot of `partial`.  quantize_kernel reduces those slots again (every
// block: at most kRedBlocks words, from L2), forms the scale as qscale does
// (amax < 1e-12 ? 1e-12 : amax, so that a NaN passes, as torch.clamp_min;
// then __fdiv_rn by lim), and runs the elementwise pass.  The slots are
// written whole on every call, so nothing is zeroed and no state is kept
// between calls: no memset, no counter, no atomics, and two streams may
// quantize at once.
//
// The pass: the division correctly rounded (__fdiv_rn: never a multiply by
// 1/s, which differs from the fp32 quotient in the last bit), rintf for
// round-half-to-even, the clamp, then q * s as its own rounding and
// __float2bfloat16_rn for a bf16 output: the operations of the plain version
// (torch.round, torch.clamp, the product and .to(x.dtype)) in their order, so
// both agree bit for bit.  quantize_scaled_* run the pass alone on a scale
// given on the device.
//
// Replaces, in the JAX package's src/repro/kernels/quant.py:
//   quantize_f32, quantize_bf16  <- quantize_pallas / _quant_kernel, with
//                                   the amax reduction it leaves to XLA
//
// Bound on an H100: the amax must read all of x before any output can be
// written, so x is read twice, the second time from L2 where x fits in its
// 50 MB; the bound counts one read and one write of x, and the second read
// where x exceeds L2 (bytes over the memory rate: about 0.1 ms for 90M bf16
// elements, 0.16 with the second read).  Each thread moves 16 bytes a step
// (4 fp32 or 8 bf16 elements) in a grid-stride loop, and a scalar loop takes
// the tail and any input the wrapper found not 16-byte aligned.  The TPU
// kernel's (256, 512) blocks, padding and crop are not carried over: a flat
// index needs none.

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

constexpr int kRedBlocks = 132 * 4;    // absmax blocks at most (its slots)
constexpr int kUnroll = 4;              // 16-byte loads in flight a thread

// |v| as the bits of a non-negative float
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// the max of the block's `v` (unsigned), in every thread
__device__ __forceinline__ unsigned block_max(unsigned v) {
  __shared__ unsigned warp_max[kThreads / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
  v = __reduce_max_sync(0xffffffffu, v);   // warp 0's lanes hold all of them
  if (threadIdx.x == 0) warp_max[0] = v;
  __syncthreads();
  return warp_max[0];
}

template <typename S>
union Pack {
  uint4 u;
  S e[sizeof(uint4) / sizeof(S)];
};

// n elements; the first nvec * VEC of them as 16-byte packs (nvec is 0 when
// x is not 16-byte aligned), the rest one at a time.  partial[blockIdx.x] =
// the block's max |x| as float bits
template <typename S>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const S* __restrict__ x, unsigned* __restrict__ partial,
              long long n, long long nvec) {
  constexpr int VEC = sizeof(uint4) / sizeof(S);
  const long long step = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  unsigned m = 0;
  for (long long i = tid; i < nvec; i += kUnroll * step) {
    Pack<S> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      p[u].u = i + u * step < nvec ? __ldg(xv + i + u * step)
                                   : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = max(m, abs_bits(to_float(p[u].e[j])));
  }
  for (long long i = nvec * VEC + tid; i < n; i += step)
    m = max(m, abs_bits(to_float(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// The pass.  The scale comes from `scale` (one fp32 value on the device)
// or, where `partial` is given, from its nparts block maxima; block 0 then
// also writes it to scale_out where that is given.
template <typename S>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const S* __restrict__ x, const float* __restrict__ scale,
                const unsigned* __restrict__ partial, int nparts,
                float* __restrict__ scale_out, S* __restrict__ out,
                long long n, long long nvec, float lim) {
  constexpr int VEC = sizeof(uint4) / sizeof(S);
  float s;
  if (partial) {
    unsigned m = 0;
    for (int i = threadIdx.x; i < nparts; i += kThreads) m = max(m, partial[i]);
    const float amax = __uint_as_float(block_max(m));
    // qscale's clamp_min(amax, 1e-12) (a NaN fails the test and passes),
    // then its correctly rounded quotient
    s = __fdiv_rn(amax < (float)1e-12 ? (float)1e-12 : amax, lim);
    if (scale_out && blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  } else {
    s = *scale;
  }
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

// grid-stride blocks for `work` items, at most `most`
inline int grid_for(long long work, long long per_block, int most) {
  long long blocks = (work + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : blocks;
  return (int)(blocks > most ? most : blocks);
}

// the larger of the vector and the scalar work items
inline long long work_items(long long n, long long nvec, int vec) {
  return nvec > n - nvec * vec ? nvec : n - nvec * vec;
}

template <typename S>
int absmax(const void* x, void* partial, long long n, int aligned,
           int* nparts, cudaStream_t st) {
  constexpr int VEC = sizeof(uint4) / sizeof(S);
  const long long nvec = aligned ? n / VEC : 0;
  const int blocks = grid_for(work_items(n, nvec, VEC),
                              (long long)kThreads * kUnroll, kRedBlocks);
  absmax_kernel<S><<<blocks, kThreads, 0, st>>>(
      (const S*)x, (unsigned*)partial, n, nvec);
  *nparts = blocks;
  return (int)cudaGetLastError();
}

template <typename S>
int pass(const void* x, const void* scale, const void* partial, int nparts,
         void* scale_out, void* out, long long n, int aligned, float lim,
         cudaStream_t st) {
  constexpr int VEC = sizeof(uint4) / sizeof(S);
  const long long nvec = aligned ? n / VEC : 0;
  const int blocks = grid_for(work_items(n, nvec, VEC), kThreads, kMaxBlocks);
  quantize_kernel<S><<<blocks, kThreads, 0, st>>>(
      (const S*)x, (const float*)scale, (const unsigned*)partial, nparts,
      (float*)scale_out, (S*)out, n, nvec, lim);
  return (int)cudaGetLastError();
}

template <typename S>
int quantize(const void* x, void* partial, void* scale_out, void* out,
             long long n, int aligned, float lim, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int nparts = 0;
  const int err = absmax<S>(x, partial, n, aligned, &nparts, st);
  if (err) return err;
  return pass<S>(x, nullptr, partial, nparts, scale_out, out, n, aligned, lim,
                 st);
}

}  // namespace

extern "C" {

// slots the partial scratch of quantize_* and absmax_* must hold (uint32)
int quantize_partials() { return kRedBlocks; }

// x, out: n contiguous fp32 values; partial: quantize_partials() uint32 of
// scratch; scale_out: one fp32 on the device for the scale, or null;
// aligned: x and out are both 16-byte aligned
int quantize_f32(const void* x, void* partial, void* scale_out, void* out,
                 long long n, int aligned, float lim, void* stream) {
  return quantize<float>(x, partial, scale_out, out, n, aligned, lim, stream);
}

// the same for bf16 x and out
int quantize_bf16(const void* x, void* partial, void* scale_out, void* out,
                  long long n, int aligned, float lim, void* stream) {
  return quantize<uint16_t>(x, partial, scale_out, out, n, aligned, lim,
                            stream);
}

// the reduction alone: partial[0 .. *nparts) = block maxima of |x| as fp32
int absmax_f32(const void* x, void* partial, long long n, int aligned,
               int* nparts, void* stream) {
  *nparts = 0;
  if (n <= 0) return 0;
  return absmax<float>(x, partial, n, aligned, nparts, (cudaStream_t)stream);
}

int absmax_bf16(const void* x, void* partial, long long n, int aligned,
                int* nparts, void* stream) {
  *nparts = 0;
  if (n <= 0) return 0;
  return absmax<uint16_t>(x, partial, n, aligned, nparts,
                          (cudaStream_t)stream);
}

// the pass alone on a scale given on the device (one fp32 value)
int quantize_scaled_f32(const void* x, const void* scale, void* out,
                        long long n, int aligned, float lim, void* stream) {
  if (n <= 0) return 0;
  return pass<float>(x, scale, nullptr, 0, nullptr, out, n, aligned, lim,
                     (cudaStream_t)stream);
}

int quantize_scaled_bf16(const void* x, const void* scale, void* out,
                         long long n, int aligned, float lim, void* stream) {
  if (n <= 0) return 0;
  return pass<uint16_t>(x, scale, nullptr, 0, nullptr, out, n, aligned, lim,
                        (cudaStream_t)stream);
}

}  // extern "C"
