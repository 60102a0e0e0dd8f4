// Flash attention with the PSG dk/dv backward, for Hopper (sm_90a).  Plain C
// entry points, bound from Python with ctypes (kernels/flash_attn.py); every
// entry launches on the caller's stream, allocates nothing and returns the
// first CUDA error it meets.
//
// Layouts (the JAX package's): q, dO, o, dq (B, S, nh, hd); k, v (B, T, nkv,
// hd), query head h reading kv head h / (nh / nkv); lse, delta (B, nh, S)
// fp32.  q, k, v and dO are fp32 or bf16, every tensor 16-byte aligned (the
// wrapper checks); every sum is fp32 or integer.  No (S, T) tensor reaches
// device memory: each kernel recomputes its score tiles.
//
//   flash_fwd      kernel 7: causal (or full) online-softmax forward, o in the
//                  input dtype and the row logsumexp lse.  bf16 operands run
//                  on the bf16 tensor cores (flash_fwd_mma_kernel), fp32
//                  operands on the CUDA cores (flash_fwd_kernel); the dtype
//                  picks the kernel, in launch_fwd.
//                  Replaces flash_attention / _flash_kernel.
//   flash_bwd_dq   kernel 8: P = exp(s - lse), dS = (P (dP - delta)) scale,
//                  dq = dS k in fp32.  bf16 operands run on the bf16 tensor
//                  cores (flash_bwd_dq_mma_kernel), fp32 operands on the CUDA
//                  cores (flash_bwd_dq_kernel); the dtype picks, in
//                  launch_dq.
//                  Replaces flash_bwd_dq_pallas / _flash_bwd_dq_kernel.
//   flash_bwd_dkv  kernel 9, the PSG kernel: P and dS quantized in-tile onto
//                  their grids, rintf(__fdiv_rn(x, s)) clamped, and the four
//                  code products dv_msb/full = codes(P)^T codes(dO), dk_msb/
//                  full = codes(dS)^T codes(q), summed over the query heads of
//                  each kv head.  The codes of q and dO come in as int8/int16.
//                  bf16 operands run on the bf16 and int8 tensor cores
//                  (flash_bwd_dkv_mma_kernel), fp32 operands on the CUDA
//                  cores (flash_bwd_dkv_kernel); the dtype picks, in
//                  launch_dkv.
//                  Replaces flash_bwd_dkv_pallas / _flash_bwd_dkv_kernel.
// (all in the JAX package's src/repro/kernels/flash_attn.py)
//
// The order of operations is JAX's: s * scale, then exp(s - lse) with invalid
// entries exactly 0, then (p * (dp - delta)) * scale, lse = m + log(max(l,
// 1e-30)), masked scores at -1e30.  The __fmul_rn/__fsub_rn intrinsics keep
// the compiler from contracting those steps into fused multiply-adds, expf
// and logf are the accurate ones, and the file must be built without
// --use_fast_math: the code grids need IEEE division and rintf.
//
// Bound on an H100 (PERF.md's rates: 67 TFLOP/s fp32, 989 TFLOP/s bf16 tensor
// cores, 1,979 TOP/s int8, 3.35 TB/s).  Per causal call there are pairs =
// B nh S (S + 1) / 2 scores, and each product over them costs 2 hd pairs
// operations; the bytes (q, k, v, dO, o, lse once) are far below the
// operations at LM sequence lengths, so the operations bound all three:
//   kernel 7: q k^T and P v, 4 hd pairs operations; in bf16, q k^T and the
//             two P v products of the split P below, 6 hd pairs at the bf16
//             tensor-core rate;
//   kernel 8: q k^T, dO v^T and dS k, 6 hd pairs; in bf16, q k^T, dO v^T
//             and the three dS k products of the split dS, 10 hd pairs at
//             the bf16 tensor-core rate;
//   kernel 9: q k^T and dO v^T (bf16 rate), and the four code products
//             (integer multiply-adds, 8 hd pairs operations, at the int8
//             rate; its byte planes run twice that).
//
// Kernel 7 in bf16 (flash_fwd_mma_kernel): 128 query rows a block, 8 warps of
// 16 rows, at most 128 registers a thread so that two blocks share an SM
// (faster than one block at 185 registers, though a few spill),
// 64-key stages through a two-stage cp.async ring of K and V in
// shared memory (rows padded by 16 bytes, so the eight rows one ldmatrix reads
// fall in eight bank groups).  q k^T is mma.sync.m16n8k16 bf16 with fp32
// sums, fed by ldmatrix: products of bf16 values are exact in fp32, so only
// the order of the sum differs from the fp32 reference.  The online softmax
// stays in registers in JAX's order.  The reference multiplies P in fp32 by
// v; a bf16 P would keep 8 bits of it.  The kernel splits P = p_hi + p_lo +
// r, p_hi = bf16(p), p_lo = bf16(p - p_hi), |r| <= 2^-16 p, reuses the score
// accumulators as the A fragments of both (no trip through shared memory),
// and runs two bf16 MMAs against v (ldmatrix.trans).  Error bound: before the
// final rounding, o differs from the fp32 P v / l by at most 2^-16 sum_j p_j
// |v_j| / l <= 2^-16 max|v| (1.5e-5 max|v|), plus the fp32 sum-order
// difference.  That is below one bf16 ulp of o (at least 2^-8 |o|) wherever
// |o| >= 2^-8 sum_j p_j |v_j| / l, and below the contract's 1e-6 max|o|
// slack wherever sum_j p_j |v_j| / l <= 0.065 max|o|; the r_j have random
// signs, so the typical error is far smaller (tests/test_torch_cuda.py and
// tests/test_torch_tensor_core_math.py hold the contract: one bf16 ulp plus
// 1e-6 max|o|, lse within 1e-5).  A warp skips the kv tiles that lie wholly
// after its rows, which would add p = 0.  Blocks go longest rows first.
//
// Kernel 8 in bf16 (flash_bwd_dq_mma_kernel): 64 query rows a block, 4 warps
// of 16 rows, two blocks an SM, 64-key stages through kernel 7's two-stage
// cp.async ring of K and V, longest rows first.  S = Q K^T and dP = dO V^T
// run as bf16 MMAs with one fresh fp32 sum a k16 step, added round-to-
// nearest, as kernel 9's scores do; P and dS follow in registers in JAX's
// order.  dq = dS K needs more than kernel 7's split: every row of dS sums
// to about zero (delta = rowsum(dO o)), so where the keys share a common
// component dq cancels, and a relative error of 2^-16 in dS (two bf16
// parts) exceeds 1e-5 max|dq| (flash_attn.dq_cancel_inputs).  dS is split in
// three bf16 parts, hi = bf16(dS), mid = bf16(dS - hi), lo = bf16(dS - hi -
// mid), about 24 bits, fp32's own precision; the parts are packed straight
// from the score accumulators as A fragments (no trip through shared
// memory) against K as the B operand (ldmatrix.trans from the tile that fed
// S), three MMAs per fragment.  The twelve MMAs of a key tile sum into a
// fresh accumulator that is added into dq round-to-nearest, so the tensor
// cores' truncating sums never run over more than one tile.  Bound: the
// bf16 rate over its 10 hd pairs operations.
//
// Kernel 9 in bf16 (flash_bwd_dkv_mma_kernel): one block of 16 warps per
// (batch x kv head, 64-row kv tile), kv tiles with the most work first; it
// loops over the g query heads of its kv head and their 64-row query tiles
// from the diagonal on, and so writes each group-summed product once, with
// no atomics.  Per query tile:
//   * Scores.  Warp (rg, c) computes S^T = K Q^T and dP^T = V dO^T for kv
//     rows 16 rg.. and query rows 16 c.. as m16n8k16 bf16 MMAs (ldmatrix
//     from K, V, Q, dO rows in shared memory, one fresh fp32 sum per k16
//     step, steps added round-to-nearest), then P and dS in JAX's order and
//     their codes.  The contraction of the code products runs along the
//     query rows, which the score accumulators hold two columns a thread of
//     each n8 tile: those four bytes are exactly one 32-bit A register of an
//     m16n8k32 int8 MMA whose k-slots 4t..4t+3 stand for query columns 2t,
//     2t + 1, 8 + 2t, 9 + 2t (perm16 in tc.cuh).  So the codes go from the
//     accumulators straight into A fragments, six of them (Pm, Pf, and the
//     lo/hi byte planes of the 10- and 16-bit dS codes), with no transpose,
//     through a small fragment buffer in shared memory for the warps of the
//     other hd columns.
//   * Exact codes.  The MMA scores differ from the sequential fp32 scores
//     of the CUDA-core kernel (fma over d in order; the plain version's GEMM
//     sums these sizes the same way), by at most kScoreErr |a| |b| (row
//     norms from the wrapper).  A pair whose code quotient lies within that
//     bound (carried to first order through exp and the grids) of a rounding
//     boundary is queued; the queue recomputes its scores sequentially and
//     rewrites its code bytes, with IEEE divisions.  Every other quotient is
//     the product with the grid's reciprocal, within 1.5 * 2^-23 of the
//     IEEE quotient, which the margin covers.  So every code equals the
//     CUDA-core kernel's, rintf(__fdiv_rn(x, s)) of the sequential scores
//     (0.015-0.05% of the pairs are queued at the qwen2.5-3b geometry).
//   * Code products.  Warp (rg, c) sums, for kv rows 16 rg.. and the n8
//     tiles c, c + 4, .. of hd, the four products over the tile's query rows
//     on m16n8k32 int8 MMAs: B fragments by ldmatrix from K-major byte
//     planes of the q and dO codes, which a pre-pass (kmajor_kernel with
//     perm16) writes into scratch the wrapper allocates; the 16-bit operand
//     goes as two byte planes (dO on the B side, dS on the A side: s8 x u8,
//     u8 x s8, s8 x s8), the low plane's product into the product's int32
//     sum, the high one's into a fresh sum added as 256 hi.  int32 wraps, so
//     the sum is exact modulo 2^32 and exact while the true sum fits: the
//     full products flush into int64 every 2^31 / (lim_x lim_g) rows (8
//     tiles at 8 x 16 bits), the predictor ones every 2^31 / (lim_x_msb
//     lim_g_msb) rows (9380 tiles at 4 x 10 bits, once at LM sizes), into
//     int64 outputs the block owns.
//   * Pipeline.  K and V stay for the block; the Q/dO tile and the code
//     planes are single-buffered and each refilled one phase ahead, so one
//     load overlaps the other phase.
//
// The rest run on the CUDA cores in fp32 and int32: a 64 x 64 score tile per
// step for kernel 7 in fp32 and kernel 8 (a 4 x 4 register tile per thread,
// q and k read into fp32 shared memory with 16-byte loads and transposed so
// that every read is a float4 across a row), a 64-query x 32-kv tile for
// kernel 9 in fp32.  Kernels 7 and 8 take one block per (batch x head, query
// tile), longest rows first, and loop over the kv tiles up to the diagonal;
// kernel 9 in fp32 loops like its bf16 kernel over 32-row kv tiles, keeps the
// codes of query rows 2p and 2p + 1 side by side in shared memory and sums
// two rows with one __dp2a (two 16 x 8-bit products and an add), with the
// same int32 flush rule.  Later work: wgmma and TMA for kernels 7-9, and
// warp specialization for kernel 9, whose elementwise phase and MMA phase
// now alternate between barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads (tx, ty)
constexpr float kNegInf = -1e30f;
constexpr int BQ = 64, BK = 64;        // kernels 7 and 8: query and kv rows
constexpr int QP = BQ + 4, KP = BK + 4;  // padded pitch of transposed tiles
constexpr int BQ9 = 64, BK9 = 32;      // kernel 9: query and kv rows
constexpr int KP9 = BK9 + 4;

struct Geo {
  int B, S, T, nh, nkv, g, causal;
  float scale;                          // float32(1 / sqrt(hd))
};


// Column of element jj of a thread's HD / 16 output columns: groups of four
// at tx * 4 + 64 * group when they come in whole groups of four (HD 64, 128:
// a quarter warp reads 128 contiguous bytes), else tx * CPT + jj (HD 16, 32,
// 96; at HD 96 the groups of 64 would reach column 125).
template <int HD>
constexpr bool kGroups4 = (HD / 16) % 4 == 0;

template <int HD>
__device__ __forceinline__ int col(int tx, int jj) {
  constexpr int CPT = HD / 16;
  if constexpr (kGroups4<HD>) return (jj / 4) * 64 + tx * 4 + jj % 4;
  else return tx * CPT + jj;
}

template <int HD>
__device__ __forceinline__ void lds_cols(const float* row, int tx,
                                         float (&v)[HD / 16]) {
  constexpr int CPT = HD / 16;
  if constexpr (kGroups4<HD>) {
#pragma unroll
    for (int a = 0; a < CPT / 4; ++a) {
      const float4 w = *reinterpret_cast<const float4*>(row + a * 64 + tx * 4);
      v[4 * a] = w.x; v[4 * a + 1] = w.y; v[4 * a + 2] = w.z; v[4 * a + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < CPT; ++a) v[a] = row[tx * CPT + a];
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of global memory (16-byte aligned) as fp32 values
__device__ __forceinline__ void ldg16(const float* p, float (&x)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}
__device__ __forceinline__ void ldg16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the high half of its fp32
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// rows [row0, row0 + rows) of head `head` of a (B, L, n, HD) tensor into
// shared memory as fp32, zero past L, in 16-byte loads: transposed
// (dst[d * pitch + r], consecutive threads on consecutive rows so that the
// stores do not collide) or in rows (dst[r * pitch + d])
template <typename T, int HD, bool kTransposed>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src, int b,
                                          int row0, int rows, int L, int n,
                                          int head) {
  constexpr int V = 16 / sizeof(T), NC = HD / V;   // vectors per row
  for (int e = threadIdx.x; e < rows * NC; e += kThreads) {
    const int r = kTransposed ? e % rows : e / NC;
    const int c = kTransposed ? e / rows : e % NC;
    const int row = row0 + r;
    float x[V];
    if (row < L) {
      ldg16(src + (((size_t)b * L + row) * n + head) * HD + c * V, x);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.f;
    }
    if constexpr (kTransposed) {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[(c * V + i) * pitch + r] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(dst + r * pitch + c * V + i) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  }
}

// integer codes of query rows (2p, 2p + 1) interleaved, as dp2a takes them:
// int8 codes into one uint16 per (pair, column), byte 0 from row 2p; int16
// codes into one uint32 per (pair, column), low half from row 2p; zero past L
template <typename C, int HD>
__device__ __forceinline__ void load_code_pairs(void* dst,
                                                const C* __restrict__ src,
                                                int b, int row0, int pairs,
                                                int L, int n, int head) {
  constexpr int V = 16 / sizeof(C), NC = HD / V;   // vectors per row
  for (int e = threadIdx.x; e < pairs * NC; e += kThreads) {
    const int p = e / NC, c = e % NC, r0 = row0 + 2 * p;
    uint4 w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      w[k] = r0 + k < L
          ? __ldg(reinterpret_cast<const uint4*>(
                src + (((size_t)b * L + r0 + k) * n + head) * HD + c * V))
          : make_uint4(0u, 0u, 0u, 0u);
    const unsigned a[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
    const unsigned z[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
    // int8: (row0, row1) bytes of columns 2i, 2i + 1 of word i; int16: halves
    constexpr unsigned kLo = sizeof(C) == 1 ? 0x5140u : 0x5410u;
    constexpr unsigned kHi = sizeof(C) == 1 ? 0x7362u : 0x7632u;
    unsigned o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __byte_perm(a[i], z[i], kLo);
      o[2 * i + 1] = __byte_perm(a[i], z[i], kHi);
    }
    // 2 V columns of 2 sizeof(C) bytes: 32 bytes at column c * V of pair p
    uint4* out = reinterpret_cast<uint4*>(
        static_cast<char*>(dst) + ((size_t)p * HD + c * V) * 2 * sizeof(C));
    out[0] = make_uint4(o[0], o[1], o[2], o[3]);
    out[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// a thread's HD / 16 columns (col<HD>) of a row of 32-bit code pairs
template <int HD>
__device__ __forceinline__ void lds_words(const unsigned* row, int tx,
                                          unsigned (&v)[HD / 16]) {
  constexpr int CPT = HD / 16;
  if constexpr (kGroups4<HD>) {
#pragma unroll
    for (int g = 0; g < CPT / 4; ++g) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + g * 64 + tx * 4);
      v[4 * g] = w.x; v[4 * g + 1] = w.y; v[4 * g + 2] = w.z; v[4 * g + 3] = w.w;
    }
  } else if constexpr (CPT % 2 == 0) {   // CPT words at tx * CPT, 8-aligned
#pragma unroll
    for (int a = 0; a < CPT / 2; ++a) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + tx * CPT + 2 * a);
      v[2 * a] = w.x; v[2 * a + 1] = w.y;
    }
  } else {
    v[0] = row[tx];
  }
}

// the same columns of a row of 16-bit code pairs, two columns to a word
// (even column in the low half)
template <int HD>
__device__ __forceinline__ void lds_halves(const uint16_t* row, int tx,
                                           unsigned (&v)[(HD / 16 + 1) / 2]) {
  constexpr int CPT = HD / 16;
  if constexpr (kGroups4<HD>) {
#pragma unroll
    for (int g = 0; g < CPT / 4; ++g) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + g * 64 + tx * 4);
      v[2 * g] = w.x; v[2 * g + 1] = w.y;
    }
  } else if constexpr (CPT % 2 == 0) {   // CPT halves at tx * CPT, 4-aligned
#pragma unroll
    for (int a = 0; a < CPT / 2; ++a)
      v[a] = *reinterpret_cast<const unsigned*>(row + tx * CPT + 2 * a);
  } else {
    v[0] = row[tx];
  }
}

__device__ __forceinline__ bool visible(const Geo& G, int qi, int kj) {
  return kj < G.T && qi < G.S && (!G.causal || kj <= qi);
}

// the JAX package's codes_tile: clip(round(x / s), -lim, lim)
__device__ __forceinline__ int clamp_code(float xs, float lim) {  // xs = x / s
  return (int)fminf(fmaxf(rintf(xs), -lim), lim);
}
__device__ __forceinline__ int code(float x, float s, float lim) {
  return clamp_code(__fdiv_rn(x, s), lim);
}

// s[i][j] = sum_d A[d][ty*4 + i] * B[d][tx*NJ + j], A pitch AP, B pitch BP
template <int HD, int NJ, int AP, int BP>
__device__ __forceinline__ void score_tile(const float* A, const float* Bm,
                                           int tx, int ty, float (&s)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * AP + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[NJ];
    if constexpr (NJ == 4) {
      const float4 w = *reinterpret_cast<const float4*>(Bm + d * BP + tx * 4);
      bv[0] = w.x; bv[1] = w.y; bv[2] = w.z; bv[3] = w.w;
    } else {
      const float2 w = *reinterpret_cast<const float2*>(Bm + d * BP + tx * 2);
      bv[0] = w.x; bv[1] = w.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// kernel 7, fp32 operands: forward on the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Geo G) {
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // [HD][QP]
  float* Kt = Qt + HD * QP;       // [HD][KP]
  float* Vs = Kt + HD * KP;       // [BK][HD]
  float* Pt = Vs + BK * HD;       // [BK][QP]
  const int iq = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int b = blockIdx.y / G.nh, h = blockIdx.y % G.nh, kvh = h / G.g;
  const int q0 = iq * BQ, tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD, true>(Qt, QP, q, b, q0, BQ, G.S, G.nh, h);
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  }
  const int t_end = G.causal ? min(G.T, q0 + BQ) : G.T;
  for (int k0 = 0; k0 < t_end; k0 += BK) {
    __syncthreads();   // the last step's readers of Kt, Vs and Pt are done
    load_tile<T, HD, true>(Kt, KP, k, b, k0, BK, G.T, G.nkv, kvh);
    load_tile<T, HD, false>(Vs, HD, v, b, k0, BK, G.T, G.nkv, kvh);
    __syncthreads();
    float s[4][4];
    score_tile<HD, 4, QP, KP>(Qt, Kt, tx, ty, s);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool ok = kj < G.T && (!G.causal || kj <= qi);
        s[i][j] = ok ? __fmul_rn(s[i][j], G.scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        rs += s[i][j];
      }
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum16(rs));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Pt[(tx * 4 + j) * QP + ty * 4 + i] = s[i][j];
    }
    __syncthreads();
    float pv[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) pv[i][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + c * QP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
      float vv[CPT];
      lds_cols<HD>(Vs + c * HD, tx, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) pv[i][jj] = fmaf(pr[i], vv[jj], pv[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj)
        acc[i][jj] = __fadd_rn(__fmul_rn(acc[i][jj], alpha[i]), pv[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= G.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * G.S + qi) * G.nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) orow[col<HD>(tx, jj)] = acc[i][jj] / lc;
    if (tx == 0) lse[((size_t)b * G.nh + h) * G.S + qi] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// kernel 7, bf16 operands: on the bf16 tensor cores
// ---------------------------------------------------------------------------

constexpr int FQ = 128, FK = 64;       // query rows a block, kv rows a stage
constexpr int kFwdThreads = 256;       // 8 warps, 16 query rows each

template <int HD>
struct FwdShape {
  static constexpr int P = HD + 8;     // bf16 row pitch: 16 bytes of pad
  static constexpr int kQ = FQ * P, kKV = FK * P;            // elements
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * (kQ + 4 * kKV);
};

// rows [row0, row0 + ROWS) of head `head` of a (B, L, n, HD) bf16 tensor into
// shared memory at pitch HD + 8 with cp.async, zero past L; NTH threads
template <int HD, int ROWS, int NTH = kFwdThreads>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* __restrict__ src,
                                        int b, int row0, int L, int n,
                                        int head) {
  constexpr int CH = HD / 8, P = HD + 8;           // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * CH; e += NTH) {
    const int r = e / CH, c = e % CH, row = row0 + r;
    const bool ok = row < L;
    cp_async16(dst + r * P + c * 8,
               src + (((size_t)b * L + (ok ? row : 0)) * n + head) * HD + c * 8,
               ok);
  }
}

// d += a (16 x 16 bf16, row) * b (16 x 8, col), fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// p = p_hi + p_lo + r with p_hi = bf16(p), p_lo = bf16(p - p_hi) (the
// subtraction is exact in fp32), |r| <= 2^-16 |p|; two columns a register,
// the lower column in the low half
__device__ __forceinline__ void split_p(float a, float b, unsigned& hi,
                                        unsigned& lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
  hi = pack_bf16(ah, bh);
  lo = pack_bf16(__float2bfloat16_rn(__fsub_rn(a, __bfloat162float(ah))),
                 __float2bfloat16_rn(__fsub_rn(b, __bfloat162float(bh))));
}

// Warp w owns query rows q0 + 16 w .. + 15; a thread holds rows g = lane / 4
// and g + 8 of them, and columns 2 (lane % 4) and + 1 of every 8-column tile
// of the score tile s (FK / 8 tiles) and of the output accumulator (HD / 8).
template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 2)   // two blocks an SM
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     Geo G) {
  using Sh = FwdShape<HD>;
  constexpr int P = Sh::P, NS = FK / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [FQ][P]
  __nv_bfloat16* Ks = Qs + Sh::kQ;               // [2][FK][P], a ring
  __nv_bfloat16* Vs = Ks + 2 * Sh::kKV;          // [2][FK][P]
  const int iq = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int b = blockIdx.y / G.nh, h = blockIdx.y % G.nh, kvh = h / G.g;
  const int q0 = iq * FQ, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = q0 + warp * 16;                 // the warp's first row
  const int rows[2] = {w0 + lane / 4, w0 + lane / 4 + 8};
  const int t_end = G.causal ? min(G.T, q0 + FQ) : G.T;
  const int n_tiles = (t_end + FK - 1) / FK;

  cp_rows<HD, FQ>(Qs, q, b, q0, G.S, G.nh, h);
  cp_rows<HD, FK>(Ks, k, b, 0, G.T, G.nkv, kvh);
  cp_rows<HD, FK>(Vs, v, b, 0, G.T, G.nkv, kvh);
  cp_async_commit();

  float acc[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * FK;
    if (it + 1 < n_tiles) {            // prefetch the next kv tile
      const int nxt = (it + 1) & 1;
      cp_rows<HD, FK>(Ks + nxt * Sh::kKV, k, b, k0 + FK, G.T, G.nkv, kvh);
      cp_rows<HD, FK>(Vs + nxt * Sh::kKV, v, b, k0 + FK, G.T, G.nkv, kvh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose rows all lie before the tile's first key would only add
    // masked entries (p = 0, alpha = 1): skipping it changes no bit
    if (w0 < G.S && (!G.causal || k0 <= w0 + 15)) {
      const __nv_bfloat16* Kt = Ks + (it & 1) * Sh::kKV;
      const __nv_bfloat16* Vt = Vs + (it & 1) * Sh::kKV;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {          // s = q k^T
        unsigned a[4];
        ldsm_x4(a, Qs + (warp * 16 + lane % 16) * P + kc * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NS; np += 2) {
          unsigned bb[4];
          ldsm_x4(bb, Kt + (np * 8 + lane % 8 + (lane / 16) * 8) * P +
                          kc * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[np], a, bb[0], bb[1]);
          mma_bf16(s[np + 1], a, bb[2], bb[3]);
        }
      }
      // JAX's order: s * scale, masked at -1e30, m_new, p, alpha, l
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const bool ok = kj < G.T && (!G.causal || kj <= rows[e / 2]);
          s[n][e] = ok ? __fmul_rn(s[n][e], G.scale) : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {    // the four threads of a row: a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(__fsub_rn(m[r], m_new));
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(__fsub_rn(s[n][e], m[e / 2]));
          rs[e / 2] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), rs[r]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], alpha[e / 2]);
      // acc += p_hi v + p_lo v: the score accumulators of key tiles 2 kc and
      // 2 kc + 1 are the A fragment of key chunk kc
#pragma unroll
      for (int kc = 0; kc < FK / 16; ++kc) {
        unsigned ph[4], pl[4];
        split_p(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
        split_p(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
        split_p(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
        split_p(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NO; np += 2) {
          unsigned bb[4];
          ldsm_x4_t(bb, Vt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P +
                            np * 8 + (lane / 16) * 8);
          mma_bf16(acc[np], ph, bb[0], bb[1]);
          mma_bf16(acc[np], pl, bb[0], bb[1]);
          mma_bf16(acc[np + 1], ph, bb[2], bb[3]);
          mma_bf16(acc[np + 1], pl, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= G.S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (((size_t)b * G.S + rows[r]) * G.nh + h) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<unsigned*>(orow + n * 8 + (lane % 4) * 2) =
          pack_bf16(__float2bfloat16_rn(acc[n][2 * r] / lc),
                    __float2bfloat16_rn(acc[n][2 * r + 1] / lc));
    if (lane % 4 == 0)
      lse[((size_t)b * G.nh + h) * G.S + rows[r]] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// kernel 8, fp32 operands: dq on the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Geo G) {
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // [HD][QP]
  float* dOt = Qt + HD * QP;      // [HD][QP]
  float* Kt = dOt + HD * QP;      // [HD][KP]
  float* Vt = Kt + HD * KP;       // [HD][KP]
  float* Ks = Vt + HD * KP;       // [BK][HD]
  float* dSt = Ks + BK * HD;      // [BK][QP]
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / G.nh, h = blockIdx.y % G.nh, kvh = h / G.g;
  const int q0 = iq * BQ, tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD, true>(Qt, QP, q, b, q0, BQ, G.S, G.nh, h);
  load_tile<T, HD, true>(dOt, QP, dout, b, q0, BQ, G.S, G.nh, h);
  float lse_r[4], dlt_r[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const size_t r = ((size_t)b * G.nh + h) * G.S + qi;
    lse_r[i] = qi < G.S ? lse[r] : 0.f;
    dlt_r[i] = qi < G.S ? delta[r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  }
  const int t_end = G.causal ? min(G.T, q0 + BQ) : G.T;
  for (int k0 = 0; k0 < t_end; k0 += BK) {
    __syncthreads();
    load_tile<T, HD, true>(Kt, KP, k, b, k0, BK, G.T, G.nkv, kvh);
    load_tile<T, HD, true>(Vt, KP, v, b, k0, BK, G.T, G.nkv, kvh);
    load_tile<T, HD, false>(Ks, HD, k, b, k0, BK, G.T, G.nkv, kvh);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tile<HD, 4, QP, KP>(Qt, Kt, tx, ty, s);
    score_tile<HD, 4, QP, KP>(dOt, Vt, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const float p = visible(G, qi, kj)
            ? expf(__fsub_rn(__fmul_rn(s[i][j], G.scale), lse_r[i])) : 0.f;
        dSt[(tx * 4 + j) * QP + ty * 4 + i] =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dlt_r[i])), G.scale);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(dSt + c * QP + ty * 4);
      const float ds[4] = {w.x, w.y, w.z, w.w};
      float kv[CPT];
      lds_cols<HD>(Ks + c * HD, tx, kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = fmaf(ds[i], kv[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= G.S) continue;
    float* row = dq + (((size_t)b * G.S + qi) * G.nh + h) * HD;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) row[col<HD>(tx, jj)] = acc[i][jj];
  }
}

// ---------------------------------------------------------------------------
// kernel 8, bf16 operands: on the bf16 tensor cores
// ---------------------------------------------------------------------------

constexpr int DQ8 = 64;                // query rows a block
constexpr int kDqThreads = 128;        // 4 warps, 16 query rows each

template <int HD>
struct DqShape {
  static constexpr int P = HD + 8;     // bf16 row pitch: 16 bytes of pad
  static constexpr int kQ = DQ8 * P, kKV = FK * P;           // elements
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * (2 * kQ + 4 * kKV);
};

// x = hi + mid + lo + r, each part the bf16 rounding of what the parts
// before it left (every subtraction exact in fp32), |r| <= 2^-24 |x| or so;
// two columns a register, the lower column in the low half
__device__ __forceinline__ void split3(float a, float b, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
  const float ra = __fsub_rn(a, __bfloat162float(ah));
  const float rb = __fsub_rn(b, __bfloat162float(bh));
  const __nv_bfloat16 am = __float2bfloat16_rn(ra), bm = __float2bfloat16_rn(rb);
  hi = pack_bf16(ah, bh);
  mid = pack_bf16(am, bm);
  lo = pack_bf16(__float2bfloat16_rn(__fsub_rn(ra, __bfloat162float(am))),
                 __float2bfloat16_rn(__fsub_rn(rb, __bfloat162float(bm))));
}

// Warp w owns query rows q0 + 16 w .. + 15; a thread holds rows gid = lane /
// 4 and gid + 8 of them, and columns 2 (lane % 4) and + 1 of every 8-column
// tile of the score tiles S, dP (FK / 8 tiles) and of dq (HD / 8 tiles).
// Per 64-key tile: S = Q K^T and dP = dO V^T on bf16 MMAs, one fresh fp32
// sum a k16 step added round-to-nearest (as kernel 9 does), P and dS in
// registers in JAX's order, then dq += dS K with dS split into three bf16
// parts packed straight from the score accumulators as A fragments, K the B
// operand by ldmatrix.trans from the tile that fed S; the tile's twelve
// MMAs a column tile sum into a fresh accumulator, added into dq
// round-to-nearest.
template <int HD>
__global__ void __launch_bounds__(kDqThreads, 2)   // two blocks an SM
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Geo G) {
  using Sh = DqShape<HD>;
  constexpr int P = Sh::P, NS = FK / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [DQ8][P]
  __nv_bfloat16* dOs = Qs + Sh::kQ;              // [DQ8][P]
  __nv_bfloat16* Ks = dOs + Sh::kQ;              // [2][FK][P], a ring
  __nv_bfloat16* Vs = Ks + 2 * Sh::kKV;          // [2][FK][P]
  const int iq = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int b = blockIdx.y / G.nh, h = blockIdx.y % G.nh, kvh = h / G.g;
  const int q0 = iq * DQ8, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = q0 + warp * 16;                 // the warp's first row
  const int rows[2] = {w0 + lane / 4, w0 + lane / 4 + 8};
  const int t_end = G.causal ? min(G.T, q0 + DQ8) : G.T;
  const int n_tiles = (t_end + FK - 1) / FK;

  cp_rows<HD, DQ8, kDqThreads>(Qs, q, b, q0, G.S, G.nh, h);
  cp_rows<HD, DQ8, kDqThreads>(dOs, dout, b, q0, G.S, G.nh, h);
  cp_rows<HD, FK, kDqThreads>(Ks, k, b, 0, G.T, G.nkv, kvh);
  cp_rows<HD, FK, kDqThreads>(Vs, v, b, 0, G.T, G.nkv, kvh);
  cp_async_commit();
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t idx = ((size_t)b * G.nh + h) * G.S + rows[r];
    lse_r[r] = rows[r] < G.S ? lse[idx] : 0.f;
    dlt_r[r] = rows[r] < G.S ? delta[idx] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * FK;
    if (it + 1 < n_tiles) {            // prefetch the next kv tile
      const int nxt = (it + 1) & 1;
      cp_rows<HD, FK, kDqThreads>(Ks + nxt * Sh::kKV, k, b, k0 + FK, G.T,
                                  G.nkv, kvh);
      cp_rows<HD, FK, kDqThreads>(Vs + nxt * Sh::kKV, v, b, k0 + FK, G.T,
                                  G.nkv, kvh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose rows all lie before the tile's first key would only add
    // dS = 0: skipping it changes no bit
    if (w0 < G.S && (!G.causal || k0 <= w0 + 15)) {
      const __nv_bfloat16* Kt = Ks + (it & 1) * Sh::kKV;
      const __nv_bfloat16* Vt = Vs + (it & 1) * Sh::kKV;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {          // S = Q K^T, dP = dO V^T
        const int ra = (warp * 16 + lane % 16) * P + kc * 16 + (lane / 16) * 8;
        unsigned aq[4], ad[4];
        ldsm_x4(aq, Qs + ra);
        ldsm_x4(ad, dOs + ra);
#pragma unroll
        for (int np = 0; np < NS; np += 2) {
          const int rb = (np * 8 + lane % 8 + (lane / 16) * 8) * P + kc * 16 +
                         ((lane / 8) % 2) * 8;
          unsigned bk[4], bv[4];
          ldsm_x4(bk, Kt + rb);
          ldsm_x4(bv, Vt + rb);
          float ts[2][4] = {}, td[2][4] = {};    // one fresh sum a k16 step
          mma_bf16(ts[0], aq, bk[0], bk[1]);
          mma_bf16(ts[1], aq, bk[2], bk[3]);
          mma_bf16(td[0], ad, bv[0], bv[1]);
          mma_bf16(td[1], ad, bv[2], bv[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[np + j][e] = __fadd_rn(s[np + j][e], ts[j][e]);
              dp[np + j][e] = __fadd_rn(dp[np + j][e], td[j][e]);
            }
        }
      }
      // P = exp(s scale - lse), 0 where masked; dS = (P (dP - delta)) scale,
      // in place of s
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const float p =
              visible(G, rows[e / 2], kj)
                  ? expf(__fsub_rn(__fmul_rn(s[n][e], G.scale), lse_r[e / 2]))
                  : 0.f;
          s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], dlt_r[e / 2])),
                              G.scale);
        }
      // dq += dS K: the accumulators of key tiles 2 kc and 2 kc + 1 are the
      // A fragment of key chunk kc, in three bf16 parts
      unsigned ah[FK / 16][4], am[FK / 16][4], al[FK / 16][4];
#pragma unroll
      for (int kc = 0; kc < FK / 16; ++kc) {
        split3(s[2 * kc][0], s[2 * kc][1], ah[kc][0], am[kc][0], al[kc][0]);
        split3(s[2 * kc][2], s[2 * kc][3], ah[kc][1], am[kc][1], al[kc][1]);
        split3(s[2 * kc + 1][0], s[2 * kc + 1][1], ah[kc][2], am[kc][2],
               al[kc][2]);
        split3(s[2 * kc + 1][2], s[2 * kc + 1][3], ah[kc][3], am[kc][3],
               al[kc][3]);
      }
#pragma unroll
      for (int np = 0; np < NO; np += 2) {
        float t[2][4] = {};                  // one fresh sum a key tile
#pragma unroll
        for (int kc = 0; kc < FK / 16; ++kc) {
          unsigned bb[4];
          ldsm_x4_t(bb, Kt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P +
                            np * 8 + (lane / 16) * 8);
          mma_bf16(t[0], al[kc], bb[0], bb[1]);
          mma_bf16(t[0], am[kc], bb[0], bb[1]);
          mma_bf16(t[0], ah[kc], bb[0], bb[1]);
          mma_bf16(t[1], al[kc], bb[2], bb[3]);
          mma_bf16(t[1], am[kc], bb[2], bb[3]);
          mma_bf16(t[1], ah[kc], bb[2], bb[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[np + j][e] = __fadd_rn(acc[np + j][e], t[j][e]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= G.S) continue;
    float* row = dq + (((size_t)b * G.S + rows[r]) * G.nh + h) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + (lane % 4) * 2) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// kernel 9: dk/dv code products (PSG)
// ---------------------------------------------------------------------------

struct Grid9 {
  float s_pm, s_pf;                 // P's grids: float32(1 / lim)
  float lim_x, lim_xm, lim_g, lim_gm;
  int flush_full, flush_msb;        // query tiles per int32 partial
};

// add a thread's int32 partial products of dv and dk into the block's int64
// output rows (kv rows ty * 2 + a) and clear them
template <int HD>
__device__ __forceinline__ void flush_sums(long long* __restrict__ dv64,
                                           long long* __restrict__ dk64,
                                           int (&vs)[2][HD / 16],
                                           int (&ks)[2][HD / 16],
                                           const Geo& G, int b, int kvh,
                                           int kv0, int tx, int ty) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int kj = kv0 + ty * 2 + a;
    if (kj < G.T) {
      const size_t base = (((size_t)b * G.T + kj) * G.nkv + kvh) * HD;
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        dv64[base + col<HD>(tx, jj)] += vs[a][jj];
        dk64[base + col<HD>(tx, jj)] += ks[a][jj];
      }
    }
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) vs[a][jj] = ks[a][jj] = 0;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ scales,
                     const int8_t* __restrict__ qm,
                     const int8_t* __restrict__ qf,
                     const int16_t* __restrict__ dom,
                     const int16_t* __restrict__ dof,
                     long long* __restrict__ dvm, long long* __restrict__ dvf,
                     long long* __restrict__ dkm, long long* __restrict__ dkf,
                     Geo G, Grid9 Z) {
  constexpr int CPT = HD / 16, NP = BQ9 / 2;   // NP query-row pairs a step
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                         // [HD][KP9]
  float* Vt = Kt + HD * KP9;                // [HD][KP9]
  float* Qt = Vt + HD * KP9;                // [HD][QP]
  float* dOt = Qt + HD * QP;                // [HD][QP]
  float* lse_s = dOt + HD * QP;             // [BQ9]
  float* dlt_s = lse_s + BQ9;               // [BQ9]
  // codes of query rows (2p, 2p + 1) side by side (load_code_pairs)
  unsigned* Pdm = reinterpret_cast<unsigned*>(dlt_s + BQ9);  // dS [NP][BK9]
  unsigned* Pdf = Pdm + NP * BK9;
  unsigned* dom_p = Pdf + NP * BK9;                          // dO [NP][HD]
  unsigned* dof_p = dom_p + NP * HD;
  uint16_t* Ppm = reinterpret_cast<uint16_t*>(dof_p + NP * HD);  // P [NP][BK9]
  uint16_t* Ppf = Ppm + NP * BK9;
  uint16_t* qm_p = Ppf + NP * BK9;                           // q [NP][HD]
  uint16_t* qf_p = qm_p + NP * HD;

  const int kv0 = blockIdx.x * BK9;
  const int b = blockIdx.y / G.nkv, kvh = blockIdx.y % G.nkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float s_ds = scales[4], s_dsm = scales[5];

  load_tile<T, HD, true>(Kt, KP9, k, b, kv0, BK9, G.T, G.nkv, kvh);
  load_tile<T, HD, true>(Vt, KP9, v, b, kv0, BK9, G.T, G.nkv, kvh);
  // kv rows ty * 2 + a, columns col(tx, jj)
  int vm[2][CPT], vf[2][CPT], km[2][CPT], kf[2][CPT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) vm[a][jj] = vf[a][jj] = km[a][jj] = kf[a][jj] = 0;

  const int n_q = (G.S + BQ9 - 1) / BQ9;
  const int iq_first = G.causal ? kv0 / BQ9 : 0;
  int tiles_full = 0, tiles_msb = 0;
  for (int hh = 0; hh < G.g; ++hh) {
    const int h = kvh * G.g + hh;
    // the predictor sums flush between runs of at most flush_msb query
    // tiles, outside the tile loop (one run at LM sizes)
    for (int c0 = iq_first; c0 < n_q; c0 += Z.flush_msb) {
      const int c1 = min(n_q, c0 + Z.flush_msb);
      if (tiles_msb + (c1 - c0) > Z.flush_msb) {
        flush_sums<HD>(dvm, dkm, vm, km, G, b, kvh, kv0, tx, ty);
        tiles_msb = 0;
      }
      tiles_msb += c1 - c0;
      for (int iq = c0; iq < c1; ++iq) {
        const int q0 = iq * BQ9;
        __syncthreads();   // the last step's readers of every tile are done
        load_tile<T, HD, true>(Qt, QP, q, b, q0, BQ9, G.S, G.nh, h);
        load_tile<T, HD, true>(dOt, QP, dout, b, q0, BQ9, G.S, G.nh, h);
        load_code_pairs<int8_t, HD>(qm_p, qm, b, q0, NP, G.S, G.nh, h);
        load_code_pairs<int8_t, HD>(qf_p, qf, b, q0, NP, G.S, G.nh, h);
        load_code_pairs<int16_t, HD>(dom_p, dom, b, q0, NP, G.S, G.nh, h);
        load_code_pairs<int16_t, HD>(dof_p, dof, b, q0, NP, G.S, G.nh, h);
        for (int r = threadIdx.x; r < BQ9; r += kThreads) {
          const int qi = q0 + r;
          const size_t idx = ((size_t)b * G.nh + h) * G.S + qi;
          lse_s[r] = qi < G.S ? lse[idx] : 0.f;
          dlt_s[r] = qi < G.S ? delta[idx] : 0.f;
        }
        __syncthreads();
        // score tile: query rows ty * 4 + i, kv columns tx * 2 + j
        float s[4][2], dp[4][2];
        score_tile<HD, 2, QP, KP9>(Qt, Kt, tx, ty, s);
        score_tile<HD, 2, QP, KP9>(dOt, Vt, tx, ty, dp);
        int cpm[4][2], cpf[4][2], cdm[4][2], cdf[4][2];
  #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i, qi = q0 + r;
  #pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = visible(G, qi, kv0 + tx * 2 + j)
                ? expf(__fsub_rn(__fmul_rn(s[i][j], G.scale), lse_s[r])) : 0.f;
            const float ds =
                __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dlt_s[r])), G.scale);
            cpm[i][j] = code(p, Z.s_pm, Z.lim_xm);
            cpf[i][j] = code(p, Z.s_pf, Z.lim_x);
            cdm[i][j] = code(ds, s_dsm, Z.lim_gm);
            cdf[i][j] = code(ds, s_ds, Z.lim_g);
          }
        }
        // rows ty * 4 + (2m, 2m + 1) form pair ty * 2 + m
  #pragma unroll
        for (int m = 0; m < 2; ++m)
  #pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = (ty * 2 + m) * BK9 + tx * 2 + j;
            Ppm[e] = (uint16_t)((cpm[2 * m][j] & 0xff) | ((cpm[2 * m + 1][j] & 0xff) << 8));
            Ppf[e] = (uint16_t)((cpf[2 * m][j] & 0xff) | ((cpf[2 * m + 1][j] & 0xff) << 8));
            Pdm[e] = (unsigned)(cdm[2 * m][j] & 0xffff) | ((unsigned)cdm[2 * m + 1][j] << 16);
            Pdf[e] = (unsigned)(cdf[2 * m][j] & 0xffff) | ((unsigned)cdf[2 * m + 1][j] << 16);
          }
        __syncthreads();
        // each __dp2a sums the products of two query rows: the low variant
        // takes bytes 0-1 of its second operand, the high one bytes 2-3
  #pragma unroll 2
        for (int pr = 0; pr < NP; ++pr) {
          // P codes of kv rows ty * 2 (low half) and ty * 2 + 1 (high half)
          const int pmw = *reinterpret_cast<const int*>(Ppm + pr * BK9 + ty * 2);
          const int pfw = *reinterpret_cast<const int*>(Ppf + pr * BK9 + ty * 2);
          const uint2 dm = *reinterpret_cast<const uint2*>(Pdm + pr * BK9 + ty * 2);
          const uint2 df = *reinterpret_cast<const uint2*>(Pdf + pr * BK9 + ty * 2);
          const int dmv[2] = {(int)dm.x, (int)dm.y}, dfv[2] = {(int)df.x, (int)df.y};
          unsigned om[CPT], of[CPT], qmw[(CPT + 1) / 2], qfw[(CPT + 1) / 2];
          lds_words<HD>(dom_p + pr * HD, tx, om);
          lds_words<HD>(dof_p + pr * HD, tx, of);
          lds_halves<HD>(qm_p + pr * HD, tx, qmw);
          lds_halves<HD>(qf_p + pr * HD, tx, qfw);
  #pragma unroll
          for (int jj = 0; jj < CPT; ++jj) {
            vm[0][jj] = __dp2a_lo((int)om[jj], pmw, vm[0][jj]);
            vm[1][jj] = __dp2a_hi((int)om[jj], pmw, vm[1][jj]);
            vf[0][jj] = __dp2a_lo((int)of[jj], pfw, vf[0][jj]);
            vf[1][jj] = __dp2a_hi((int)of[jj], pfw, vf[1][jj]);
            const int qmj = (int)qmw[jj / 2], qfj = (int)qfw[jj / 2];
  #pragma unroll
            for (int a = 0; a < 2; ++a) {
              if (jj % 2 == 0) {
                km[a][jj] = __dp2a_lo(dmv[a], qmj, km[a][jj]);
                kf[a][jj] = __dp2a_lo(dfv[a], qfj, kf[a][jj]);
              } else {
                km[a][jj] = __dp2a_hi(dmv[a], qmj, km[a][jj]);
                kf[a][jj] = __dp2a_hi(dfv[a], qfj, kf[a][jj]);
              }
            }
          }
        }
        if (++tiles_full == Z.flush_full) {
          flush_sums<HD>(dvf, dkf, vf, kf, G, b, kvh, kv0, tx, ty);
          tiles_full = 0;
        }
      }
    }
  }
  flush_sums<HD>(dvm, dkm, vm, km, G, b, kvh, kv0, tx, ty);
  flush_sums<HD>(dvf, dkf, vf, kf, G, b, kvh, kv0, tx, ty);
}

// ---------------------------------------------------------------------------
// kernel 9, bf16 operands: on the bf16 and int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int DQ = 64, DK = 64;        // query rows a tile, kv rows a block
constexpr int kDkvThreads = 512;       // 16 warps: 4 kv row groups x 4 slots
constexpr int kPlanes = 6;             // K-major code planes of q and dO:
                                       // qm, qf, dOm lo, hi, dOf lo, hi
constexpr int kSets = 6;               // A operands: codes of Pm, Pf, and
                                       // the lo, hi planes of dSm and dSf
constexpr int kCodePitch = DQ + 16;    // bytes a plane row: 8 rows that one
                                       // ldmatrix reads, 8 bank groups

template <int HD>
struct DkvShape {
  static constexpr int P = HD + 8;     // bf16 row pitch: 16 bytes of pad
  static constexpr int kTile = DK * P;                   // elements (DQ == DK)
  static constexpr size_t kBf16 = sizeof(__nv_bfloat16) * 4 * kTile;
  // lse, delta and the q and dO row norms of a tile; the k and v row norms
  static constexpr size_t kRowVals = sizeof(float) * (4 * DQ + 2 * DK);
  static constexpr size_t kCodes = (size_t)kPlanes * HD * kCodePitch;
  static constexpr size_t kFrag = (size_t)kSets * 2 * 4 * 32 * 16;
  // pairs whose scores are recomputed: (kv row << 8 | query row), a count
  static constexpr size_t kQueue = sizeof(uint16_t) * DQ * DK + 16;
  static constexpr size_t kSmem = kBf16 + kRowVals + kCodes + kFrag + kQueue;
  static constexpr int NT = HD >= 32 ? HD / 32 : 1;      // n8 tiles a warp
};

// The scores are the sequential ones: s = fma(q_d, k_d, s) for d = 0..HD-1
// in fp32, the order of the CUDA-core kernel above (and, at these sizes,
// of the fp32 GEMM of the plain version).  The bf16 MMAs find them up to a
// bound, relative to sum_d |a_d b_d| <= |a| |b|: each k16 MMA sums its 16
// exact products from zero, and if it aligns them to the largest exponent
// and truncates to 24 bits its error is below 17 * 2^-23 of the group's
// largest product; the steps add in fp32 round-to-nearest (HD / 16 adds of
// at most 2^-24 each); the sequential sum is within HD * 2^-24 of the exact
// one.  2^-16.6 in all at hd 128; 2^-16 covers every HD <= 128.
constexpr float kScoreErr = 0x1p-16f;

// x lies within d of a rounding boundary of rintf (a half-integer)
__device__ __forceinline__ bool near_tie(float x, float d) {
  return 0.5f - fabsf(__fsub_rn(x, rintf(x))) <= d;
}

// the sequential fp32 sum of a_d b_d over one pair of bf16 rows
template <int HD>
__device__ __forceinline__ float seq_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; d += 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + d));
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

// The four grids of P and dS (Pm, Pf, dSm, dSf): scale and its reciprocal
struct Grids4 {
  float s[4], inv[4];
};

// P and dS of one (kv row, query row) pair in JAX's order, and their
// quotients x / s on the four grids (rintf and the clamp make the codes):
// IEEE divisions with kExact, else products with the reciprocals, within
// 1.5 * 2^-23 |x| of them; returns p
template <bool kExact>
__device__ __forceinline__ float dkv_quotients(float s, float dp, bool vis,
                                               float lse, float dlt,
                                               const Geo& G, const Grids4& R,
                                               float (&x)[4]) {
  const float p = vis ? expf(__fsub_rn(__fmul_rn(s, G.scale), lse)) : 0.f;
  const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dlt)), G.scale);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = i < 2 ? p : ds;
    x[i] = kExact ? __fdiv_rn(v, R.s[i]) : __fmul_rn(v, R.inv[i]);
  }
  return p;
}

// the six code bytes of a pair (Pm, Pf, dSm lo, hi, dSf lo, hi)
__device__ __forceinline__ void dkv_code_bytes(const float (&x)[4],
                                               const Grid9& Z,
                                               int (&v)[6]) {
  const int cm = clamp_code(x[2], Z.lim_gm), cf = clamp_code(x[3], Z.lim_g);
  v[0] = clamp_code(x[0], Z.lim_xm);
  v[1] = clamp_code(x[1], Z.lim_x);
  v[2] = cm & 0xff;
  v[3] = (cm >> 8) & 0xff;
  v[4] = cf & 0xff;
  v[5] = (cf >> 8) & 0xff;
}

// acc += a * b with b split in byte planes: lo (u8) into acc directly, hi
// (s8) into a fresh sum folded in as 256 hi, all in wrapping int32
__device__ __forceinline__ void fold_hi(int (&acc)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  int t[4] = {0, 0, 0, 0};
  mma_s8s8(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = (int)((unsigned)acc[e] + ((unsigned)t[e] << 8));
}

// Block: DK kv rows of one (batch, kv head), looping over the g query heads
// and their DQ-row query tiles from the diagonal on.  Warp w = (kv row
// group rg = w % 4, slot c = w / 4).  Per query tile:
//   scores: warp (rg, c) computes S^T = K Q^T and dP^T = V dO^T for kv rows
//     16 rg.. and query rows 16 c.. on bf16 MMAs (fp32 sums), then P and dS
//     in JAX's order and their six code sets, packed straight from the
//     accumulators as int8 A fragments (a thread holds query columns 2t,
//     2t + 1 of two n8 tiles: k-slots 4t..4t + 3 under perm16) into `frag`;
//   products: warp (rg, c) sums, for kv rows 16 rg.. and the n8 tiles c, c +
//     4, .. of hd, the four code products over the tile's query rows on int8
//     MMAs, B fragments by ldmatrix from the K-major code planes of q and dO
//     (kmajor_kernel with perm16, so their k-slots match).
// The Q/dO tiles and the code planes are single-buffered and each refilled
// one phase ahead, so a load overlaps the other phase.
template <int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ scales,
                         const float* __restrict__ norms,
                         const uint8_t* __restrict__ planes, int Sp,
                         long long* __restrict__ dvm,
                         long long* __restrict__ dvf,
                         long long* __restrict__ dkm,
                         long long* __restrict__ dkf, Geo G, Grid9 Z) {
  using Sh = DkvShape<HD>;
  constexpr int P = Sh::P, NT = Sh::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [DK][P]
  __nv_bfloat16* Vs = Ks + Sh::kTile;
  __nv_bfloat16* Qs = Vs + Sh::kTile;                               // [DQ][P]
  __nv_bfloat16* dOs = Qs + Sh::kTile;
  // [DQ] each: lse, delta, |q|, |dO| of the tile's rows; [DK] each: |k|, |v|
  float* lse_s = reinterpret_cast<float*>(dOs + Sh::kTile);
  float* dlt_s = lse_s + DQ;
  float* qn_s = dlt_s + DQ;
  float* don_s = qn_s + DQ;
  float* kn_s = don_s + DQ;
  float* vn_s = kn_s + DK;
  uint8_t* cs = reinterpret_cast<uint8_t*>(vn_s + DK);   // [plane][HD][pitch]
  uint4* frag = reinterpret_cast<uint4*>(cs + Sh::kCodes);  // [set][kc][rg][lane]
  unsigned* frag_w = reinterpret_cast<unsigned*>(frag);
  uint16_t* queue = reinterpret_cast<uint16_t*>(cs + Sh::kCodes + Sh::kFrag);
  int* n_queued = reinterpret_cast<int*>(queue + DQ * DK);

  // longest work first: the kv tile index major, (batch, kv head) minor
  const int kvb = blockIdx.x / (G.B * G.nkv), bkv = blockIdx.x % (G.B * G.nkv);
  const int b = bkv / G.nkv, kvh = bkv % G.nkv, kv0 = kvb * DK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, slot = warp / 4, t = lane % 4, gid = lane / 4;
  Grids4 R{{Z.s_pm, Z.s_pf, scales[5], scales[4]}, {}};
#pragma unroll
  for (int i = 0; i < 4; ++i) R.inv[i] = 1.f / R.s[i];
  const size_t plane_stride = (size_t)G.B * G.nh * HD * Sp;
  // row norms: |q|, |dO| (B, nh, S) each, then |k|, |v| (B, nkv, T) each
  const size_t n_rows_q = (size_t)G.B * G.nh * G.S;
  const float* kvn = norms + 2 * n_rows_q;
  const int n_q = Sp / DQ;
  const int iq_first = G.causal ? kv0 / DQ : 0;
  const int per_head = max(0, n_q - iq_first);
  const int n_it = G.g * per_head;

  auto head_of = [&](int it) { return kvh * G.g + it / per_head; };
  auto q0_of = [&](int it) { return (iq_first + it % per_head) * DQ; };
  auto load_q = [&](int it) {          // Q and dO rows, lse, delta, norms
    const int h = head_of(it), q0 = q0_of(it);
    cp_rows<HD, DQ, kDkvThreads>(Qs, q, b, q0, G.S, G.nh, h);
    cp_rows<HD, DQ, kDkvThreads>(dOs, dout, b, q0, G.S, G.nh, h);
    for (int r = threadIdx.x; r < 4 * DQ; r += kDkvThreads) {
      const int w = r / DQ, rr = r % DQ, qi = q0 + rr;
      const bool ok = qi < G.S;
      const size_t idx = ((size_t)b * G.nh + h) * G.S + (ok ? qi : 0);
      const float* src = w == 0 ? lse + idx : w == 1 ? delta + idx
                                            : norms + (w - 2) * n_rows_q + idx;
      cp_async4(lse_s + r, src, ok);
    }
  };
  auto load_codes = [&](int it) {      // the tile's six K-major planes
    const int h = head_of(it), q0 = q0_of(it);
    constexpr int CH = DQ / 16;        // 16-byte chunks a plane row
    for (int e = threadIdx.x; e < kPlanes * HD * CH; e += kDkvThreads) {
      const int ch = e % CH, row = e / CH, pl = row / HD, d = row % HD;
      cp_async16(cs + row * kCodePitch + ch * 16,
                 planes + pl * plane_stride +
                     ((size_t)(b * G.nh + h) * HD + d) * Sp + q0 + ch * 16,
                 true);
    }
  };

  // acc[p][jj]: product p (dv_msb, dv_full, dk_msb, dk_full) of kv rows
  // 16 rg + gid (+ 8) and columns 8 (slot + 4 jj) + 2t (+ 1)
  int acc[4][NT][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][jj][e] = 0;
  // int32 partials of one product into its int64 output, then cleared
  auto flush = [&](int (&a)[NT][4], long long* __restrict__ out) {
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      const int nt = slot + 4 * jj;
      if (nt >= HD / 8) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kv0 + 16 * rg + gid + 8 * (e / 2);
        if (kj < G.T)
          out[(((size_t)b * G.T + kj) * G.nkv + kvh) * HD + nt * 8 + 2 * t +
              e % 2] += a[jj][e];
        a[jj][e] = 0;
      }
    }
  };

  cp_rows<HD, DK, kDkvThreads>(Ks, k, b, kv0, G.T, G.nkv, kvh);
  cp_rows<HD, DK, kDkvThreads>(Vs, v, b, kv0, G.T, G.nkv, kvh);
  for (int r = threadIdx.x; r < 2 * DK; r += kDkvThreads) {
    const int kj = kv0 + r % DK;
    const bool ok = kj < G.T;
    cp_async4(kn_s + r,
              kvn + (size_t)(r / DK) * G.B * G.nkv * G.T +
                  ((size_t)b * G.nkv + kvh) * G.T + (ok ? kj : 0), ok);
  }
  cp_async_commit();
  if (n_it > 0) load_q(0);
  cp_async_commit();
  if (n_it > 0) load_codes(0);
  cp_async_commit();
  if (threadIdx.x == 0) *n_queued = 0;
  int tiles_full = 0, tiles_msb = 0;
  for (int it = 0; it < n_it; ++it) {
    const int q0 = q0_of(it);
    cp_async_wait<1>();                // K, V and this tile's Q, dO, rows
    __syncthreads();
    {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {        // S^T = K Q^T, dP^T = V dO^T
        const int ra = (16 * rg + lane % 16) * P + kc * 16 + (lane / 16) * 8;
        const int rb = (16 * slot + lane % 8 + (lane / 16) * 8) * P + kc * 16 +
                       ((lane / 8) % 2) * 8;
        unsigned a[4], bb[4];
        float ts[2][4], td[2][4];          // one fresh MMA sum a k16 step
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ts[j][e] = td[j][e] = 0.f;
        ldsm_x4(a, Ks + ra);
        ldsm_x4(bb, Qs + rb);
        mma_bf16(ts[0], a, bb[0], bb[1]);
        mma_bf16(ts[1], a, bb[2], bb[3]);
        ldsm_x4(a, Vs + ra);
        ldsm_x4(bb, dOs + rb);
        mma_bf16(td[0], a, bb[0], bb[1]);
        mma_bf16(td[1], a, bb[2], bb[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = __fadd_rn(s[j][e], ts[j][e]);
            dp[j][e] = __fadd_rn(dp[j][e], td[j][e]);
          }
      }
      // P and dS in JAX's order, their codes packed as A fragments: element
      // (kv row gid + 8 r, query column 8 j + 2t + i) is byte 2 j + i of the
      // register of row r.  A pair whose code quotient lies within the MMA
      // scores' error bound of a rounding boundary goes to the queue, which
      // recomputes its scores sequentially and rewrites its bytes.
      unsigned pk[kSets][2];
#pragma unroll
      for (int x = 0; x < kSets; ++x) pk[x][0] = pk[x][1] = 0u;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = 16 * rg + gid + 8 * (e / 2);
          const int qc = 16 * slot + 8 * j + 2 * t + e % 2;
          const bool vis = visible(G, q0 + qc, kv0 + kr);
          float xq[4];
          const float p = dkv_quotients<false>(s[j][e], dp[j][e], vis,
                                               lse_s[qc], dlt_s[qc], G, R, xq);
          if (vis) {
            // first order: x moves by x scale E_s through p, a dS quotient
            // also by p scale E_dp / s through dP; 2^-19 x for the product
            // in place of the division and the fp32 rounding of the steps
            // between
            const float es = kScoreErr * qn_s[qc] * kn_s[kr];
            const float ed = kScoreErr * don_s[qc] * vn_s[kr];
            const float rel = G.scale * es + 0x1p-19f;
            const float pd = 1.01f * p * G.scale * ed;
            if (near_tie(xq[0], rel * fabsf(xq[0])) ||
                near_tie(xq[1], rel * fabsf(xq[1])) ||
                near_tie(xq[2], rel * fabsf(xq[2]) + pd * R.inv[2]) ||
                near_tie(xq[3], rel * fabsf(xq[3]) + pd * R.inv[3]))
              queue[atomicAdd(n_queued, 1)] = (uint16_t)(kr << 8 | qc);
          }
          int vals[kSets];
          dkv_code_bytes(xq, Z, vals);
          const int shift = 8 * (2 * j + e % 2);
#pragma unroll
          for (int x = 0; x < kSets; ++x)
            pk[x][e / 2] |= (unsigned)vals[x] << shift;
        }
      // this warp's query rows are k-slots 16 (slot % 2).. of k-chunk slot / 2
#pragma unroll
      for (int x = 0; x < kSets; ++x)
        reinterpret_cast<uint2*>(frag + ((x * 2 + slot / 2) * 4 + rg) * 32 +
                                 lane)[slot % 2] = make_uint2(pk[x][0], pk[x][1]);
    }
    __syncthreads();                   // frag and the queue written
    // the queued pairs: sequential scores, their code bytes rewritten
    for (int i = threadIdx.x; i < *n_queued; i += kDkvThreads) {
      const int kr = queue[i] >> 8, qc = queue[i] & 0xff;
      const float sv = seq_dot<HD>(Qs + qc * P, Ks + kr * P);
      const float dv = seq_dot<HD>(dOs + qc * P, Vs + kr * P);
      float xq[4];
      dkv_quotients<true>(sv, dv, true, lse_s[qc], dlt_s[qc], G, R, xq);
      int vals[kSets];
      dkv_code_bytes(xq, Z, vals);
      // where the producer thread put the pair (see the packing above): a
      // byte store, so pairs that share a word do not race
      const int r16 = kr % 16, c16 = qc % 16, sl = qc / 16;
      const int ln = (r16 % 8) * 4 + (c16 % 8) / 2;
      const int byte = 2 * (c16 / 8) + c16 % 2;
#pragma unroll
      for (int x = 0; x < kSets; ++x)
        reinterpret_cast<uint8_t*>(
            frag_w + (((x * 2 + sl / 2) * 4 + kr / 16) * 32 + ln) * 4 +
            2 * (sl % 2) + r16 / 8)[byte] = (uint8_t)vals[x];
    }
    cp_async_wait<0>();                // this tile's code planes
    __syncthreads();                   // Q, dO, rows and the queue free
    if (threadIdx.x == 0) *n_queued = 0;
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();
#pragma unroll
    for (int kc = 0; kc < DQ / 32; ++kc) {
      unsigned A[kSets][4];
#pragma unroll
      for (int x = 0; x < kSets; ++x) {
        const uint4 w = frag[((x * 2 + kc) * 4 + rg) * 32 + lane];
        A[x][0] = w.x; A[x][1] = w.y; A[x][2] = w.z; A[x][3] = w.w;
      }
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        const int nt = slot + 4 * jj;
        if (nt >= HD / 8) continue;
        // lanes 0-15 read plane pl, lanes 16-31 plane pl + 1
        const uint8_t* base = cs + (lane / 16) * HD * kCodePitch +
                              (nt * 8 + lane % 8) * kCodePitch + kc * 32 +
                              ((lane / 8) % 2) * 16;
        unsigned bq[4], bo[4];
        ldsm_x4(bq, base);                                   // qm, qf
        mma_u8s8(acc[2][jj], A[2], bq[0], bq[1]);           // dk_msb
        fold_hi(acc[2][jj], A[3], bq[0], bq[1]);
        mma_u8s8(acc[3][jj], A[4], bq[2], bq[3]);           // dk_full
        fold_hi(acc[3][jj], A[5], bq[2], bq[3]);
        ldsm_x4(bo, base + 2 * HD * kCodePitch);             // dOm lo, hi
        mma_s8u8(acc[0][jj], A[0], bo[0], bo[1]);           // dv_msb
        fold_hi(acc[0][jj], A[0], bo[2], bo[3]);
        ldsm_x4(bo, base + 4 * HD * kCodePitch);             // dOf lo, hi
        mma_s8u8(acc[1][jj], A[1], bo[0], bo[1]);           // dv_full
        fold_hi(acc[1][jj], A[1], bo[2], bo[3]);
      }
    }
    __syncthreads();                   // the planes and frag are free
    if (it + 1 < n_it) load_codes(it + 1);
    cp_async_commit();
    if (++tiles_full == Z.flush_full) {
      flush(acc[1], dvf);
      flush(acc[3], dkf);
      tiles_full = 0;
    }
    if (++tiles_msb == Z.flush_msb) {
      flush(acc[0], dvm);
      flush(acc[2], dkm);
      tiles_msb = 0;
    }
  }
  cp_async_wait<0>();
  flush(acc[0], dvm);
  flush(acc[1], dvf);
  flush(acc[2], dkm);
  flush(acc[3], dkf);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

Geo make_geo(int B, int S, int T, int nh, int nkv, int hd, int causal) {
  return Geo{B, S, T, nh, nkv, nh / nkv, causal,
             (float)(1.0 / sqrt((double)hd))};
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// by dtype: bf16 on the tensor cores, fp32 on the CUDA cores
template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, Geo G, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = FwdShape<HD>::kSmem;
    int err = prepare(flash_fwd_mma_kernel<HD>, smem);
    if (err) return err;
    dim3 grid((G.S + FQ - 1) / FQ, G.B * G.nh);
    lint::note(flash_fwd_mma_kernel<HD>, "flash_fwd_mma_kernel", HD,
               kFwdThreads, smem);
    flash_fwd_mma_kernel<HD><<<grid, kFwdThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, G);
  } else {
    const size_t smem =
        sizeof(float) * (HD * QP + HD * KP + BK * HD + BK * QP);
    int err = prepare(flash_fwd_kernel<T, HD>, smem);
    if (err) return err;
    dim3 grid((G.S + BQ - 1) / BQ, G.B * G.nh);
    lint::note(flash_fwd_kernel<T, HD>, "flash_fwd_kernel", HD, kThreads,
               smem);
    flash_fwd_kernel<T, HD><<<grid, kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, G);
  }
  return (int)cudaGetLastError();
}

// by dtype: bf16 on the tensor cores, fp32 on the CUDA cores
template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, Geo G,
              cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = DqShape<HD>::kSmem;
    int err = prepare(flash_bwd_dq_mma_kernel<HD>, smem);
    if (err) return err;
    dim3 grid((G.S + DQ8 - 1) / DQ8, G.B * G.nh);
    lint::note(flash_bwd_dq_mma_kernel<HD>, "flash_bwd_dq_mma_kernel", HD,
               kDqThreads, smem);
    flash_bwd_dq_mma_kernel<HD><<<grid, kDqThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (float*)dq, G);
  } else {
    const size_t smem =
        sizeof(float) * (2 * HD * QP + 2 * HD * KP + BK * HD + BK * QP);
    int err = prepare(flash_bwd_dq_kernel<T, HD>, smem);
    if (err) return err;
    dim3 grid((G.S + BQ - 1) / BQ, G.B * G.nh);
    lint::note(flash_bwd_dq_kernel<T, HD>, "flash_bwd_dq_kernel", HD,
               kThreads, smem);
    flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (float*)dq, G);
  }
  return (int)cudaGetLastError();
}

// by dtype: bf16 on the bf16 and int8 tensor cores (the codes of q and dO
// first written K-major into `planes`), fp32 on the CUDA cores
template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* scales,
               const void* qm, const void* qf, const void* dom,
               const void* dof, const void* norms, void* planes, void* dvm,
               void* dvf, void* dkm, void* dkf, Geo G, Grid9 Z,
               cudaStream_t st) {
  const size_t n_out = (size_t)G.B * G.T * G.nkv * HD;
  int err;
  for (void* out : {dvm, dvf, dkm, dkf}) {
    err = (int)cudaMemsetAsync(out, 0, n_out * sizeof(long long), st);
    if (err) return err;
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!planes || !norms) return (int)cudaErrorInvalidValue;
    const int Sp = (G.S + DQ - 1) / DQ * DQ, C = G.nh * HD;
    const size_t ps = (size_t)G.B * C * Sp;
    uint8_t* pl = (uint8_t*)planes;
    if ((err = kmajor<int8_t, true>((const int8_t*)qm, G.B, G.S, C, Sp, pl,
                                    nullptr, st)) ||
        (err = kmajor<int8_t, true>((const int8_t*)qf, G.B, G.S, C, Sp,
                                    pl + ps, nullptr, st)) ||
        (err = kmajor<int16_t, true>((const int16_t*)dom, G.B, G.S, C, Sp,
                                     pl + 2 * ps, pl + 3 * ps, st)) ||
        (err = kmajor<int16_t, true>((const int16_t*)dof, G.B, G.S, C, Sp,
                                     pl + 4 * ps, pl + 5 * ps, st)))
      return err;
    const size_t smem = DkvShape<HD>::kSmem;
    if ((err = prepare(flash_bwd_dkv_mma_kernel<HD>, smem))) return err;
    const int blocks = (G.T + DK - 1) / DK * G.B * G.nkv;
    lint::note(flash_bwd_dkv_mma_kernel<HD>, "flash_bwd_dkv_mma_kernel", HD,
               kDkvThreads, smem);
    flash_bwd_dkv_mma_kernel<HD><<<blocks, kDkvThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (const float*)scales,
        (const float*)norms, pl, Sp,
        (long long*)dvm, (long long*)dvf, (long long*)dkm, (long long*)dkf, G,
        Z);
  } else {
    const size_t smem = sizeof(float) * (2 * HD * KP9 + 2 * HD * QP + 2 * BQ9)
                        + (2 * sizeof(unsigned) + 2 * sizeof(uint16_t)) *
                              (BQ9 / 2) * (BK9 + HD);
    if ((err = prepare(flash_bwd_dkv_kernel<T, HD>, smem))) return err;
    dim3 grid((G.T + BK9 - 1) / BK9, G.B * G.nkv);
    lint::note(flash_bwd_dkv_kernel<T, HD>, "flash_bwd_dkv_kernel", HD,
               kThreads, smem);
    flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (const float*)scales,
        (const int8_t*)qm, (const int8_t*)qf, (const int16_t*)dom,
        (const int16_t*)dof, (long long*)dvm, (long long*)dvf, (long long*)dkm,
        (long long*)dkf, G, Z);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// one instantiation per (dtype, head dim); other head dims are refused
#define FLASH_DISPATCH(LAUNCH, bf16, hd, ...)                                \
  switch (hd) {                                                              \
    case 16:                                                                 \
      return bf16 ? LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__)                   \
                  : LAUNCH<float, 16>(__VA_ARGS__);                          \
    case 32:                                                                 \
      return bf16 ? LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__)                   \
                  : LAUNCH<float, 32>(__VA_ARGS__);                          \
    case 64:                                                                 \
      return bf16 ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)                   \
                  : LAUNCH<float, 64>(__VA_ARGS__);                          \
    case 96:                                                                 \
      return bf16 ? LAUNCH<__nv_bfloat16, 96>(__VA_ARGS__)                   \
                  : LAUNCH<float, 96>(__VA_ARGS__);                          \
    case 128:                                                                \
      return bf16 ? LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)                  \
                  : LAUNCH<float, 128>(__VA_ARGS__);                         \
    default:                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
  }

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int S, int T, int nh, int nkv, int hd,
              int causal, int bf16, void* stream) {
  if (B * S * nh == 0) return 0;
  const Geo G = make_geo(B, S, T, nh, nkv, hd, causal);
  FLASH_DISPATCH(launch_fwd, bf16, hd, q, k, v, o, lse, G,
                 (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int S, int T, int nh, int nkv, int hd,
                 int causal, int bf16, void* stream) {
  if (B * S * nh == 0) return 0;
  const Geo G = make_geo(B, S, T, nh, nkv, hd, causal);
  FLASH_DISPATCH(launch_dq, bf16, hd, q, k, v, dout, lse, delta, dq, G,
                 (cudaStream_t)stream)
}

// For bf16 operands: norms, the fp32 row norms |q|, |dO| (B, nh, S) and
// |k|, |v| (B, nkv, T), one after the other; planes, scratch of 6 x B x nh x
// hd x Sp bytes (Sp = S rounded up to 64).  Unused (may be null) for fp32.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* scales, const void* qm, const void* qf,
                  const void* dom, const void* dof, const void* norms,
                  void* planes, void* dvm,
                  void* dvf, void* dkm, void* dkf, int B, int S, int T,
                  int nh, int nkv,
                  int hd, int causal, int bf16, float s_pm, float s_pf,
                  int lim_x, int lim_xm, int lim_g, int lim_gm,
                  void* stream) {
  if (B * T * nkv == 0) return 0;
  const Geo G = make_geo(B, S, T, nh, nkv, hd, causal);
  if (lim_x < 1 || lim_g < 1 || lim_xm < 1 || lim_gm < 1)
    return (int)cudaErrorInvalidValue;
  // query tiles (64 rows in both kernels) whose full products, and whose
  // predictor products, fit an int32 sum (8 and 9380 tiles at 8 x 16 and 4
  // x 10 bits)
  static_assert(BQ9 == DQ, "one flush rule for both kernels");
  const long long flush_full = 2147483647LL / ((long long)lim_x * lim_g) / BQ9;
  const long long flush_msb = 2147483647LL / ((long long)lim_xm * lim_gm) / BQ9;
  if (flush_full < 1 || flush_msb < 1) return (int)cudaErrorInvalidValue;
  const Grid9 Z{s_pm, s_pf, (float)lim_x, (float)lim_xm, (float)lim_g,
                (float)lim_gm, (int)flush_full, (int)flush_msb};
  FLASH_DISPATCH(launch_dkv, bf16, hd, q, k, v, dout, lse, delta, scales, qm,
                 qf, dom, dof, norms, planes, dvm, dvf, dkm, dkf, G, Z,
                 (cudaStream_t)stream)
}

}  // extern "C"

LINT_EXPORTS(flash)
