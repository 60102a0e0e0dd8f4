// Hopper building blocks shared by the tensor-core kernels (sm_90a): cp.async
// into shared memory, ldmatrix, the int8 MMAs, int64 atomics and the int64
// -> fp32 rounding pass of the exact PSG predictor sums.  Included by
// conv.cu, psg_matmul.cu and flash_attn.cu; kernels/build.py hashes it with
// every source.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace
