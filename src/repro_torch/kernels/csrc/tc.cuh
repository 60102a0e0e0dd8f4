// Hopper building blocks shared by the tensor-core kernels (sm_90a): cp.async
// into shared memory, ldmatrix, the int8 MMAs, int64 atomics, the int64 ->
// fp32 rounding pass of the exact PSG predictor sums, and the pre-pass that
// writes integer codes K-major as byte planes.  Included by conv.cu,
// psg_matmul.cu and flash_attn.cu; kernels/build.py hashes it with every
// source.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (the
// source address must still be a valid one)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (cp.async.ca: 4-byte copies), zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each); lane i
// gives the row address of row i % 8 of matrix i / 8, and register m of a
// lane holds row lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1 of
// matrix m (with .trans: column lane / 4, rows 2 (lane % 4) and + 1)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 32 s8, row) * b (32 x 8, col), int32, wrapping
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void atomic_add_ll(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}

// dst = fp32 of the exact int64 sums, each rounded once to nearest even
__global__ void ll_to_f32_kernel(const long long* __restrict__ src,
                                 float* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __ll2float_rn(src[i]);
}

inline int ll_to_f32(const long long* src, float* dst, long long n,
                     cudaStream_t st) {
  if (n == 0) return 0;
  ll_to_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(src, dst, n);
  return (int)cudaGetLastError();
}

// The K-major pre-pass.  Codes (N, C) token-major, one such matrix per
// blockIdx.z -> byte planes (C, Np) K-major, zero for tokens N..Np (Np a
// multiple of kKTile).  int8 codes give one plane (their bytes); int16 codes
// give lo = g & 0xFF and hi = g >> 8, so that g = 256 hi + lo.  With kPerm16
// slot s of every aligned 16-token block holds token perm16(s): the order in
// which an m16n8k16 accumulator's columns sit in the A fragment of an int8
// m16n8k32 MMA (flash_attn.cu), so that a B operand built here meets an A
// operand packed straight from score accumulators.
constexpr int kKTile = 64;             // tokens and columns of a pre-pass tile

// slot 4 t + m of a 16-block holds column 2 t + m (m < 2) or 8 + 2 t + m - 2:
// the columns thread t of a quad holds in two adjacent n8 accumulator tiles
__device__ __forceinline__ int perm16(int s) {
  const int t = s / 4, m = s % 4;
  return m < 2 ? 2 * t + m : 8 + 2 * t + m - 2;
}

template <typename CODE, bool kPerm16>
__global__ void __launch_bounds__(256)
kmajor_kernel(const CODE* __restrict__ src, int N, int C, int Np,
              uint8_t* __restrict__ lo, uint8_t* __restrict__ hi) {
  __shared__ int tile[kKTile][kKTile + 1];     // [column][token]
  const int n0 = blockIdx.x * kKTile, c0 = blockIdx.y * kKTile;
  src += (size_t)blockIdx.z * N * C;
  const size_t plane = (size_t)blockIdx.z * C * Np;
  for (int e = threadIdx.x; e < kKTile * kKTile; e += 256) {
    const int n = e / kKTile, c = e % kKTile;  // consecutive threads, columns
    tile[c][n] = (n0 + n < N && c0 + c < C)
                     ? (int)src[(size_t)(n0 + n) * C + c0 + c] : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kKTile * kKTile / 4; e += 256) {
    const int c = e / (kKTile / 4), n = (e % (kKTile / 4)) * 4;  // 4 slots
    if (c0 + c >= C) continue;
    unsigned wl = 0, wh = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = n + b;
      const int v = tile[c][kPerm16 ? (s & ~15) + perm16(s & 15) : s];
      wl |= (unsigned)(v & 0xff) << (8 * b);
      wh |= (unsigned)((v >> 8) & 0xff) << (8 * b);   // arithmetic shift
    }
    const size_t off = plane + (size_t)(c0 + c) * Np + n0 + n;
    *reinterpret_cast<unsigned*>(lo + off) = wl;
    if (hi) *reinterpret_cast<unsigned*>(hi + off) = wh;
  }
}

// launch the pre-pass over `batch` matrices (N, C) -> planes (C, Np)
template <typename CODE, bool kPerm16>
int kmajor(const CODE* src, int batch, int N, int C, int Np, uint8_t* lo,
           uint8_t* hi, cudaStream_t st) {
  if (Np % kKTile) return (int)cudaErrorInvalidValue;
  if (Np == 0 || C == 0 || batch == 0) return 0;
  dim3 grid(Np / kKTile, (C + kKTile - 1) / kKTile, batch);
  kmajor_kernel<CODE, kPerm16><<<grid, 256, 0, st>>>(src, N, C, Np, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace
