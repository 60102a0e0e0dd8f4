// Implicit-GEMM NHWC convolution and the PSG weight-gradient sign, for Hopper
// (sm_90a).  Plain C entry points, bound from Python with ctypes
// (kernels/conv.py); every entry launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().
//
// Layouts: activations NHWC, pre-padded (B, Hp, Wp, C); weights patch-major
// (k*k*C, dout) with row = c*k*k + ki*k + kj (JAX package, kernels/conv.py).
//
// Replaces, in the JAX package's src/repro/kernels/conv.py:
//   conv_fwd            <- conv_fwd_pallas / _conv_fwd_kernel
//   conv_grad_x         <- conv_grad_x_pallas / _conv_grad_x_kernel
//   conv_grad_w_pred    <- conv_grad_w_predictor_pallas / _conv_pred_kernel
//   conv_grad_w_sign    <- conv_grad_w_pallas / _conv_grad_w_kernel
//
// Bounds on an H100 at the CIFAR ResNet shapes: the fp32 forward and input
// gradient are bound by their operations at the fp32 rate; the integer
// weight-gradient passes, counted at the int8 rate, by their bytes.  These
// first versions run on the CUDA cores (no tensor cores, no TMA) and sit far
// above both bounds.  No im2col tensor is ever written: the k x k gather
// happens in the index arithmetic, as in the TPU kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// forward: one thread per output element, fp32 accumulation over the taps
// and input channels.  Neighbouring threads differ in the output channel, so
// the weight reads and the output writes are coalesced and the input reads
// are broadcasts.
// ---------------------------------------------------------------------------
__global__ void conv_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                float* __restrict__ y, int B, int Hp, int Wp,
                                int C, int dout, int k, int s, int Ho, int Wo) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)B * Ho * Wo * dout;
  if (idx >= total) return;
  int o = (int)(idx % dout);
  long long r = idx / dout;
  int ow = (int)(r % Wo);
  r /= Wo;
  int oh = (int)(r % Ho);
  int b = (int)(r / Ho);
  const int kk = k * k;
  float acc = 0.f;
  for (int ki = 0; ki < k; ++ki) {
    for (int kj = 0; kj < k; ++kj) {
      const float* xr = x + (((size_t)b * Hp + oh * s + ki) * Wp + ow * s + kj) * C;
      const float* wr = w + (size_t)(ki * k + kj) * dout + o;
      for (int c = 0; c < C; ++c) acc += xr[c] * wr[(size_t)c * kk * dout];
    }
  }
  y[idx] = acc;
}

// ---------------------------------------------------------------------------
// input gradient: the gather form of the transposed conv.  One thread per
// dx element sums the taps with (p - ki) = 0 (mod s) and (q - kj) = 0 (mod
// s); that covers the stride phases of the TPU kernel with no scatter and no
// atomics, so the result is deterministic.  The weight comes tap-major and
// transposed, wt[(t*dout + o)*C + c], so that neighbouring threads (which
// differ in c) read neighbouring words; the gy reads are broadcasts.
// ---------------------------------------------------------------------------
__global__ void conv_grad_x_kernel(const float* __restrict__ g,
                                   const float* __restrict__ wt,
                                   float* __restrict__ dx, int B, int Ho,
                                   int Wo, int dout, int C, int k, int s,
                                   int Hp, int Wp) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)B * Hp * Wp * C;
  if (idx >= total) return;
  int c = (int)(idx % C);
  long long r = idx / C;
  int q = (int)(r % Wp);
  r /= Wp;
  int p = (int)(r % Hp);
  int b = (int)(r / Hp);
  float acc = 0.f;
  for (int ki = 0; ki < k; ++ki) {
    int dp = p - ki;
    if (dp < 0 || dp % s) continue;
    int oh = dp / s;
    if (oh >= Ho) continue;
    for (int kj = 0; kj < k; ++kj) {
      int dq = q - kj;
      if (dq < 0 || dq % s) continue;
      int ow = dq / s;
      if (ow >= Wo) continue;
      const float* gr = g + (((size_t)b * Ho + oh) * Wo + ow) * dout;
      const float* wr = wt + (size_t)(ki * k + kj) * dout * C + c;
      for (int o = 0; o < dout; ++o) acc += gr[o] * wr[(size_t)o * C];
    }
  }
  dx[idx] = acc;
}

// ---------------------------------------------------------------------------
// weight-gradient code product, exact in integers:
//   out[c*k*k + t, o] += sum_n x[window_t(n), c] * g[n, o]
// over the B*Ho*Wo output positions n.  Block (t, tile, split): one filter
// tap, one TC x TO output tile, one contiguous range of positions.  Each
// strip of TP positions is staged in shared memory; a thread owns one
// channel and four output columns.  Partial sums of a strip fit int32
// (TP * 127 * 32767 < 2^31); ACC is int32 for the predictor (4-bit x 10-bit
// codes; the wrapper checks the whole sum fits) and int64 for the full
// 8-bit x 16-bit product.  The splits meet in integer atomics, which are
// exact and order-free: the result is the same on every run.
// ---------------------------------------------------------------------------
constexpr int TC = 32, TO = 32, TP = 64;

__device__ __forceinline__ void atomic_add_acc(int32_t* p, long long v) {
  atomicAdd(p, (int32_t)v);
}
__device__ __forceinline__ void atomic_add_acc(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}

template <typename ACC>
__global__ void wgrad_accum_kernel(const int8_t* __restrict__ x,
                                   const int16_t* __restrict__ g,
                                   ACC* __restrict__ out, int B, int Hp,
                                   int Wp, int C, int Ho, int Wo, int dout,
                                   int k, int s, int n_per_split) {
  __shared__ int xs[TP][TC];
  __shared__ int gs[TP][TO + 1];
  const int t = blockIdx.x, kk = k * k, ki = t / k, kj = t % k;
  const int tiles_o = (dout + TO - 1) / TO;
  const int c0 = (blockIdx.y / tiles_o) * TC, o0 = (blockIdx.y % tiles_o) * TO;
  const int N = B * Ho * Wo;
  const int n_begin = blockIdx.z * n_per_split;
  const int n_end = min(N, n_begin + n_per_split);
  const int tid = threadIdx.x;
  const int tc = tid / (TO / 4), to = (tid % (TO / 4)) * 4;
  long long acc[4] = {0, 0, 0, 0};
  for (int n0 = n_begin; n0 < n_end; n0 += TP) {
    for (int i = tid; i < TP * TC; i += kThreads) {
      int pp = i / TC, cc = i % TC, n = n0 + pp, c = c0 + cc;
      int v = 0;
      if (n < n_end && c < C) {
        int ow = n % Wo, r = n / Wo, oh = r % Ho, b = r / Ho;
        v = x[(((size_t)b * Hp + oh * s + ki) * Wp + ow * s + kj) * C + c];
      }
      xs[pp][cc] = v;
    }
    for (int i = tid; i < TP * TO; i += kThreads) {
      int pp = i / TO, oo = i % TO, n = n0 + pp, o = o0 + oo;
      gs[pp][oo] = (n < n_end && o < dout) ? (int)g[(size_t)n * dout + o] : 0;
    }
    __syncthreads();
    int part[4] = {0, 0, 0, 0};
#pragma unroll 8
    for (int pp = 0; pp < TP; ++pp) {
      int xv = xs[pp][tc];
#pragma unroll
      for (int j = 0; j < 4; ++j) part[j] += xv * gs[pp][to + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += part[j];
    __syncthreads();
  }
  const int c = c0 + tc;
  if (c >= C) return;
  for (int j = 0; j < 4; ++j) {
    int o = o0 + to + j;
    if (o < dout) atomic_add_acc(&out[((size_t)c * kk + t) * dout + o], acc[j]);
  }
}

// Eq. (2) select: sign(g_msb) where |g_msb| >= tau, else sign(g_full); one
// fallback flag per (tap, bn-wide dout block).  Columns the TPU kernel
// padded up to a whole block hold g_msb = 0 and count as fallback whenever
// tau > 0; the flag of the last block reproduces that.
__global__ void psg_select_kernel(const int32_t* __restrict__ pred,
                                  const long long* __restrict__ full,
                                  const float* __restrict__ tau,
                                  int8_t* __restrict__ sign,
                                  int32_t* __restrict__ stats, int rows,
                                  int dout, int kk, int bn, int nj) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * dout) return;
  const int o = (int)(idx % dout), row = (int)(idx / dout), t = row % kk;
  const float tv = *tau;
  const int32_t pm = pred[idx];
  const bool conf = fabsf((float)pm) >= tv;
  const long long v = conf ? (long long)pm : full[idx];
  sign[idx] = (int8_t)((v > 0) - (v < 0));
  if (!conf) atomicOr(&stats[t * nj + o / bn], 1);
  if (row < kk && o == 0 && dout % bn != 0 && !(0.f >= tv))
    atomicOr(&stats[row * nj + nj - 1], 1);
}

int n_per_split(int N, int blocks_xy) {
  // about eight blocks per SM of the 132, in whole strips
  int target = 132 * 8;
  int splits = (target + blocks_xy - 1) / blocks_xy;
  int per = (N + splits - 1) / splits;
  per = ((per + TP - 1) / TP) * TP;
  return per < TP ? TP : per;
}

template <typename ACC>
int launch_accum(const int8_t* x, const int16_t* g, ACC* out, int B, int Hp,
                 int Wp, int C, int Ho, int Wo, int dout, int k, int s,
                 cudaStream_t st) {
  const int tiles = ((C + TC - 1) / TC) * ((dout + TO - 1) / TO);
  const int N = B * Ho * Wo;
  const int per = n_per_split(N, k * k * tiles);
  dim3 grid(k * k, tiles, (N + per - 1) / per);
  wgrad_accum_kernel<ACC><<<grid, kThreads, 0, st>>>(x, g, out, B, Hp, Wp, C,
                                                     Ho, Wo, dout, k, s, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv_fwd(const void* x, const void* w, void* y, int B, int Hp, int Wp,
             int C, int dout, int k, int s, int Ho, int Wo, void* stream) {
  long long total = (long long)B * Ho * Wo * dout;
  conv_fwd_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, B, Hp, Wp, C, dout, k, s,
      Ho, Wo);
  return (int)cudaGetLastError();
}

int conv_grad_x(const void* g, const void* wt, void* dx, int B, int Ho, int Wo,
                int dout, int C, int k, int s, int Hp, int Wp, void* stream) {
  long long total = (long long)B * Hp * Wp * C;
  conv_grad_x_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)wt, (float*)dx, B, Ho, Wo, dout, C, k, s,
      Hp, Wp);
  return (int)cudaGetLastError();
}

int conv_grad_w_pred(const void* xm, const void* gm, void* out, int B, int Hp,
                     int Wp, int C, int Ho, int Wo, int dout, int k, int s,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(out, 0, (size_t)k * k * C * dout * 4, st);
  if (err) return err;
  return launch_accum<int32_t>((const int8_t*)xm, (const int16_t*)gm,
                               (int32_t*)out, B, Hp, Wp, C, Ho, Wo, dout, k, s,
                               st);
}

int conv_grad_w_sign(const void* pred, const void* xq, const void* gq,
                     const void* tau, void* full, void* sign, void* stats,
                     int B, int Hp, int Wp, int C, int Ho, int Wo, int dout,
                     int k, int s, int bn, int nj, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = k * k * C;
  int err = (int)cudaMemsetAsync(full, 0, (size_t)rows * dout * 8, st);
  if (!err) err = (int)cudaMemsetAsync(stats, 0, (size_t)k * k * nj * 4, st);
  if (err) return err;
  err = launch_accum<long long>((const int8_t*)xq, (const int16_t*)gq,
                                (long long*)full, B, Hp, Wp, C, Ho, Wo, dout, k,
                                s, st);
  if (err) return err;
  psg_select_kernel<<<blocks_for((long long)rows * dout), kThreads, 0, st>>>(
      (const int32_t*)pred, (const long long*)full, (const float*)tau,
      (int8_t*)sign, (int32_t*)stats, rows, dout, k * k, bn, nj);
  return (int)cudaGetLastError();
}

}  // extern "C"
