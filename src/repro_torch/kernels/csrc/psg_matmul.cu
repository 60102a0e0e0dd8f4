// The PSG weight-gradient sign of a dense matmul, for Hopper (sm_90a).  Plain
// C entry points, bound from Python with ctypes (kernels/psg_matmul.py);
// every entry launches on the caller's stream, allocates nothing and returns
// the first CUDA error it meets.
//
// For y = x @ w with x (N, din) and gy (N, dout), the weight gradient is
// x^T gy over the N tokens.  Both passes take integer codes (kernels/ops.py):
//   psg_pred  pass 1, the predictor product of 4-bit x and 10-bit gy codes,
//             exact in int32;
//   psg_sign  pass 2, the full product of 8-bit x and 16-bit gy codes,
//             exact in int64, then the Eq. (2) select against pass 1's
//             product at threshold tau (read from device memory), and one
//             fallback flag per 128 x 128 tile of the TPU kernel's grid.
//
// Replaces, in the JAX package's src/repro/kernels/psg_matmul.py:
//   psg_pred  <- predictor_matmul_pallas / _pred_kernel
//   psg_sign  <- psg_grad_w_pallas / _psg_kernel
//
// Bound on an H100: 2 * N * din * dout integer operations per pass, which at
// the int8 tensor-core rate is below the bytes of the codes only for small
// N; at N = 8192 and qwen2.5-3b widths the operations bound (about 0.1-0.3
// ms a call).  This first version runs on the CUDA cores: a shared-memory
// tiled integer GEMM, 128 x 128 output tile per block, 32 tokens per stage,
// an 8 x 8 register tile per thread.  The token axis is split across blocks
// that meet in integer atomics, which are exact and order-free, so the
// result is the same on every run.  Pass 2 keeps its partial sums in int32
// over at most 512 tokens (512 * 127 * 32767 < 2^31) and flushes them into
// an int64 product.  Later work: int8 mma.sync (or wgmma) for the 4- and
// 8-bit operand with the 10- and 16-bit codes split into bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, kThreads = 256;
constexpr int kFullChunk = 512;     // tokens per int32 partial of pass 2

__device__ __forceinline__ void atomic_add_out(int32_t* p, int v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add_out(long long* p, int v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            (unsigned long long)(long long)v);
}

// out[i, j] += sum_{n in this block's range} x[n, i] * g[n, j]
template <typename OUT>
__global__ void __launch_bounds__(kThreads)
code_product_kernel(const int8_t* __restrict__ x, const int16_t* __restrict__ g,
                    OUT* __restrict__ out, int N, int din, int dout,
                    int n_per_block) {
  __shared__ __align__(16) int xs[BK][BM];
  __shared__ __align__(16) int gs[BK][BN];
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int n_begin = blockIdx.z * n_per_block;
  const int n_end = min(N, n_begin + n_per_block);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0;

  for (int n0 = n_begin; n0 < n_end; n0 += BK) {
    for (int e = tid; e < BK * BM; e += kThreads) {
      const int kk = e / BM, m = e % BM, n = n0 + kk, i = i0 + m;
      xs[kk][m] = (n < n_end && i < din) ? (int)x[(size_t)n * din + i] : 0;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, m = e % BN, n = n0 + kk, j = j0 + m;
      gs[kk][m] = (n < n_end && j < dout) ? (int)g[(size_t)n * dout + j] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const int4 a0 = *reinterpret_cast<const int4*>(&xs[kk][ty * 4]);
      const int4 a1 = *reinterpret_cast<const int4*>(&xs[kk][64 + ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&gs[kk][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&gs[kk][64 + tx * 4]);
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] += av[a] * bv[b];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= din) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + (b < 4 ? tx * 4 + b : 64 + tx * 4 + b - 4);
      if (j < dout && acc[a][b] != 0)
        atomic_add_out(&out[(size_t)i * dout + j], acc[a][b]);
    }
  }
}

// Eq. (2) select and the fallback flags, one block per tile of the TPU
// kernel's grid (bm = min(128, din) rows by bn = min(128, dout) columns,
// padded up to whole tiles).  A padded element holds g_msb = 0, which is
// confident only when tau <= 0, exactly as in the TPU kernel.
__global__ void __launch_bounds__(kThreads)
select_kernel(const int32_t* __restrict__ pred,
              const long long* __restrict__ full,
              const float* __restrict__ tau, int8_t* __restrict__ sign,
              int32_t* __restrict__ stats, int din, int dout, int bm,
              int bn) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  const float tv = *tau;
  int notconf = 0;
  for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
    const int i = ti * bm + e / bn, j = tj * bn + e % bn;
    if (i < din && j < dout) {
      const size_t idx = (size_t)i * dout + j;
      const int32_t pm = pred[idx];
      const bool conf = fabsf((float)pm) >= tv;
      const long long v = conf ? (long long)pm : full[idx];
      sign[idx] = (int8_t)((v > 0) - (v < 0));
      notconf |= !conf;
    } else {
      notconf |= !(0.f >= tv);
    }
  }
  const int any = __syncthreads_or(notconf);
  if (threadIdx.x == 0) stats[ti * gridDim.x + tj] = any;
}

int tokens_per_block(int N, int tiles, int cap) {
  // about two blocks per SM of the 132, in whole stages of BK tokens
  const int target = 132 * 2;
  const int splits = (target + tiles - 1) / tiles;
  int per = (N + splits - 1) / splits;
  per = ((per + BK - 1) / BK) * BK;
  if (per > cap) per = cap;
  return per < BK ? BK : per;
}

template <typename OUT>
int launch_product(const int8_t* x, const int16_t* g, OUT* out, int N, int din,
                   int dout, int cap, cudaStream_t st) {
  const int ti = (din + BM - 1) / BM, tj = (dout + BN - 1) / BN;
  const int per = tokens_per_block(N, ti * tj, cap);
  dim3 grid(tj, ti, (N + per - 1) / per);
  code_product_kernel<OUT><<<grid, kThreads, 0, st>>>(x, g, out, N, din, dout,
                                                      per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int psg_pred(const void* xm, const void* gm, void* out, int N, int din,
             int dout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(out, 0, (size_t)din * dout * 4, st);
  if (err) return err;
  return launch_product<int32_t>((const int8_t*)xm, (const int16_t*)gm,
                                 (int32_t*)out, N, din, dout, 1 << 30, st);
}

int psg_sign(const void* pred, const void* xq, const void* gq,
             const void* tau, void* full, void* sign, void* stats, int N,
             int din, int dout, int bm, int bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(full, 0, (size_t)din * dout * 8, st);
  if (err) return err;
  err = launch_product<long long>((const int8_t*)xq, (const int16_t*)gq,
                                  (long long*)full, N, din, dout, kFullChunk,
                                  st);
  if (err) return err;
  dim3 grid((dout + bn - 1) / bn, (din + bm - 1) / bm);
  select_kernel<<<grid, kThreads, 0, st>>>(
      (const int32_t*)pred, (const long long*)full, (const float*)tau,
      (int8_t*)sign, (int32_t*)stats, din, dout, bm, bn);
  return (int)cudaGetLastError();
}

}  // extern "C"
