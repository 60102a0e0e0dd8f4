// The PSG weight-gradient sign of a dense matmul, for Hopper (sm_90a).  Plain
// C entry points, bound from Python with ctypes (kernels/psg_matmul.py);
// every entry launches on the caller's stream, allocates nothing and returns
// the first CUDA error it meets.
//
// For y = x @ w with x (N, din) and gy (N, dout), the weight gradient is
// x^T gy over the N tokens.  Both passes take integer codes (kernels/ops.py):
//   psg_pred  pass 1, the predictor product of 4-bit x and 10-bit gy codes,
//             exact in integers on the int8 tensor cores, written as fp32;
//   psg_sign  pass 2, the full product of 8-bit x and 16-bit gy codes,
//             exact in int64, then the Eq. (2) select against pass 1's fp32
//             product at threshold tau (read from device memory), and one
//             fallback flag per 128 x 128 tile of the TPU kernel's grid.
//
// Replaces, in the JAX package's src/repro/kernels/psg_matmul.py:
//   psg_pred  <- predictor_matmul_pallas / _pred_kernel
//   psg_sign  <- psg_grad_w_pallas / _psg_kernel
//
// Bound on an H100: 2 * N * din * dout integer operations per pass, which at
// the int8 tensor-core rate (1,979 TOP/s) is below the bytes of the codes
// only for small N; at N = 8192 and qwen2.5-3b widths the operations bound
// (about 0.1-0.3 ms a call).
//
// psg_pred runs on the int8 tensor cores (mma.sync.m16n8k32, int32 sums):
//   * Exact integer arithmetic.  Each int16 g code is split into two byte
//     planes, lo = g & 0xFF (u8) and hi = g >> 8 (s8), so g = 256 hi + lo for
//     every int16 code.  Two MMAs per fragment, s8 x s8 on (x, hi) and s8 x
//     u8 on (x, lo), sum in int32 over at most kMaxSplitTokens tokens, where
//     neither plane can overflow (65536 * 127 * 255 < 2^31); the epilogue
//     forms 256 sum(x hi) + sum(x lo) in int64.  Splits of the token axis
//     meet in int64 atomics (exact and order-free) and the output is fp32:
//     the exact integer sum rounded once (__ll2float_rn), at any N, as the
//     JAX package's fp32 pass 1 returns it.  The two planes cost twice the
//     operations of one int8 product, so 2x the bound is this design's own
//     floor.
//   * Layout.  The int8 MMAs want both operands K-major, K being the token
//     axis, but the codes arrive token-major and ldmatrix has no 8-bit
//     transpose.  A pre-pass kernel (kmajor_kernel) writes x^T (din, Np) and
//     the two planes of g^T (dout, Np), zero-padded to Np, a multiple of the
//     128-token stage; the wrapper allocates them and its time counts in the
//     kernel's (about 15% of it at the qwen2.5-3b widths).
//   * Pipeline.  A three-stage cp.async ring of 128-token stages; shared-memory
//     rows are padded to 144 bytes, so the eight 16-byte rows that one
//     ldmatrix reads fall in eight different bank groups.  The kernel is
//     bound by the instructions it issues more than by the tensor cores: each
//     thread always copies the same 16-byte column of the same rows, so its
//     source addresses are computed once and only the stage's token offset is
//     added in the loop.
//   * Tiles.  128 x 128 output tiles (8 warps, 64 x 32 each: 4 x 4 MMA tiles
//     per plane) when dout >= 128, else 128 x 32 (4 warps, 32 x 32), for the
//     ResNet im2col widths (dout 16-64).  Where the output has fewer tiles
//     than the card has SMs, the token axis is split across blocks, which meet
//     in int64 atomics in scratch that the wrapper allocates, and a last
//     pass rounds the sums to fp32.
// psg_sign stays on the CUDA cores: a shared-memory tiled integer GEMM, 128 x
// 128 output tile per block, 32 tokens per stage, an 8 x 8 register tile per
// thread, the token axis split across blocks that meet in int64 atomics.  It
// keeps its partial sums in int32 over at most 512 tokens (512 * 127 * 32767
// < 2^31) and flushes them into an int64 product.  Later work: pass 2 on the
// int8 tensor cores too, with the 16-bit codes split into the same two byte
// planes; for both, wgmma fed by TMA in 128-byte swizzled layouts (a first
// wgmma version of pass 1, on unswizzled core matrices fed by the same
// cp.async ring, was slower than this one), and the transpose fused into the
// loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int kSMs = 132;              // H100 SXM

// ---------------------------------------------------------------------------
// pass 1: the predictor product on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int KT = 128;                // tokens (bytes of a K-major row) per stage
constexpr int KPITCH = KT + 16;        // padded shared-memory row pitch, bytes
constexpr int kStages = 3;
constexpr int kMinStagesPerBlock = 4;  // at least 512 tokens per split
// tokens per int32 partial: 65536 * 127 * 255 < 2^31 for either byte plane
constexpr int kMaxSplitTokens = 65536;
constexpr int kMaxStagesPerBlock = kMaxSplitTokens / KT;
constexpr int TT = 64;                 // tokens and columns of a pre-pass tile

// Pre-pass: codes (N, C) token-major -> byte planes (C, Np) K-major, zero for
// tokens N..Np.  int8 codes give one plane (their bytes); int16 codes give
// lo = g & 0xFF and hi = g >> 8, so that g = 256 hi + lo.
template <typename CODE>
__global__ void __launch_bounds__(256)
kmajor_kernel(const CODE* __restrict__ src, int N, int C, int Np,
              uint8_t* __restrict__ lo, uint8_t* __restrict__ hi) {
  __shared__ int tile[TT][TT + 1];     // [column][token]
  const int n0 = blockIdx.x * TT, c0 = blockIdx.y * TT;
  for (int e = threadIdx.x; e < TT * TT; e += 256) {
    const int n = e / TT, c = e % TT;  // consecutive threads, consecutive columns
    tile[c][n] = (n0 + n < N && c0 + c < C)
                     ? (int)src[(size_t)(n0 + n) * C + c0 + c] : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TT * TT / 4; e += 256) {
    const int c = e / (TT / 4), n = (e % (TT / 4)) * 4;  // four tokens a thread
    if (c0 + c >= C) continue;
    unsigned wl = 0, wh = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int v = tile[c][n + b];
      wl |= (unsigned)(v & 0xff) << (8 * b);
      wh |= (unsigned)((v >> 8) & 0xff) << (8 * b);   // arithmetic shift
    }
    const size_t off = (size_t)(c0 + c) * Np + n0 + n;
    *reinterpret_cast<unsigned*>(lo + off) = wl;
    if (hi) *reinterpret_cast<unsigned*>(hi + off) = wh;
  }
}

// WM x WN warps, each MT x NT MMA tiles (16 x 8) of both planes
template <int WM, int WN, int MT, int NT>
struct PredShape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int kRows = BM + 2 * BN;      // x^T, lo and hi rows a stage
  static constexpr int kStage = kRows * KPITCH;  // bytes
  static constexpr int kSmem = kStages * kStage;
};

// out[i, j] (+)= sum over this block's tokens of x[n, i] g[n, j]
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
pred_mma_kernel(const int8_t* __restrict__ xt, const uint8_t* __restrict__ glo,
                const uint8_t* __restrict__ ghi, float* __restrict__ out,
                long long* __restrict__ acc64, int din, int dout, int Np,
                int stages_per_block) {
  using Sh = PredShape<WM, WN, MT, NT>;
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int i0 = blockIdx.y * Sh::BM, j0 = blockIdx.x * Sh::BN;
  const int kt0 = blockIdx.z * stages_per_block;
  const int nk = max(0, min(Np / KT, kt0 + stages_per_block) - kt0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;

  // stage rows: [0, BM) x^T, [BM, BM + BN) lo, [BM + BN, BM + 2 BN) hi.
  // A thread always copies 16-byte column `ch` of rows r0 + RSTEP i, so its
  // source addresses are fixed but for the stage's token offset.
  constexpr int CPR = KT / 16, RSTEP = Sh::kThreads / CPR;
  constexpr int NA = Sh::BM / RSTEP, NB = Sh::BN / RSTEP;
  static_assert(Sh::BM % RSTEP == 0 && Sh::BN % RSTEP == 0, "whole rows");
  const int ch = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  const size_t step = (size_t)RSTEP * Np;
  const uint8_t* src_x = reinterpret_cast<const uint8_t*>(xt) +
                         (size_t)(i0 + r0) * Np + ch * 16;
  const size_t off_g = (size_t)(j0 + r0) * Np + ch * 16;
  unsigned ok_a = 0, ok_b = 0;       // bit i: row r0 + RSTEP i is real
#pragma unroll
  for (int i = 0; i < NA; ++i) ok_a |= (unsigned)(i0 + r0 + RSTEP * i < din) << i;
#pragma unroll
  for (int i = 0; i < NB; ++i) ok_b |= (unsigned)(j0 + r0 + RSTEP * i < dout) << i;
  auto load = [&](int stage, int kt) {
    unsigned char* dst = smem + stage * Sh::kStage + r0 * KPITCH + ch * 16;
    const size_t k0 = (size_t)(kt0 + kt) * KT;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool ok = (ok_a >> i) & 1;
      cp_async16(dst + i * RSTEP * KPITCH,
                 ok ? src_x + i * step + k0 : glo, ok);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const bool ok = (ok_b >> i) & 1;
      const size_t o = off_g + i * step + k0;
      cp_async16(dst + (Sh::BM + i * RSTEP) * KPITCH, ok ? glo + o : glo, ok);
      cp_async16(dst + (Sh::BM + Sh::BN + i * RSTEP) * KPITCH,
                 ok ? ghi + o : ghi, ok);
    }
  };

  int hi[MT][NT][4], lo[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[a][b][c] = lo[a][b][c] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();      // stage t has landed
    __syncthreads();                   // and every warp is done with t - 1
    if (t + kStages - 1 < nk) load((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();
    const unsigned char* sa = smem + (t % kStages) * Sh::kStage;
    const unsigned char* slo = sa + Sh::BM * KPITCH;
    const unsigned char* shi = slo + Sh::BN * KPITCH;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 32) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], sa + (wm * MT * 16 + mt * 16 + lane % 16) * KPITCH +
                           kk + (lane / 16) * 16);
#pragma unroll
      for (int np = 0; np < NT; np += 2) {
        const int row = wn * NT * 8 + np * 8 + lane % 8 + (lane / 16) * 8;
        const int kb = kk + ((lane / 8) % 2) * 16;
        unsigned bl[4], bh[4];
        ldsm_x4(bl, slo + row * KPITCH + kb);
        ldsm_x4(bh, shi + row * KPITCH + kb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8u8(lo[mt][np], a[mt], bl[0], bl[1]);
          mma_s8u8(lo[mt][np + 1], a[mt], bl[2], bl[3]);
          mma_s8s8(hi[mt][np], a[mt], bh[0], bh[1]);
          mma_s8s8(hi[mt][np + 1], a[mt], bh[2], bh[3]);
        }
      }
    }
  }

  // epilogue: 256 hi + lo in int64, stored as fp32 or added into acc64
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm * MT * 16 + mt * 16 + lane / 4 + (c / 2) * 8;
        const int j = j0 + wn * NT * 8 + nt * 8 + (lane % 4) * 2 + c % 2;
        if (i >= din || j >= dout) continue;
        const long long v = 256LL * hi[mt][nt][c] + lo[mt][nt][c];
        const size_t idx = (size_t)i * dout + j;
        if (!acc64) out[idx] = __ll2float_rn(v);
        else if (v) atomic_add_ll(acc64 + idx, v);
      }
}

// token splits of the predictor kernel: about two blocks per SM where the
// output has fewer tiles than the card has SMs, and never more than
// kMaxStagesPerBlock stages a split (the int32 partials' bound)
int pred_splits(int tiles, int kts) {
  int splits = 1;
  if (tiles < kSMs) {
    splits = (2 * kSMs + tiles - 1) / tiles;
    const int most = kts / kMinStagesPerBlock;
    splits = splits < most ? splits : most;
  }
  const int least = (kts + kMaxStagesPerBlock - 1) / kMaxStagesPerBlock;
  splits = splits > least ? splits : least;
  splits = splits > 1 ? splits : 1;
  const int per = (kts + splits - 1) / splits;
  return (kts + per - 1) / per;
}

template <int WM, int WN, int MT, int NT>
int pred_tiles(int din, int dout) {
  using Sh = PredShape<WM, WN, MT, NT>;
  return ((din + Sh::BM - 1) / Sh::BM) * ((dout + Sh::BN - 1) / Sh::BN);
}

int pred_splits_for(int din, int dout, int Np) {
  const int tiles = dout >= 128 ? pred_tiles<2, 4, 4, 4>(din, dout)
                                : pred_tiles<4, 1, 2, 4>(din, dout);
  return pred_splits(tiles, Np / KT);
}

template <int WM, int WN, int MT, int NT>
int launch_pred(const int8_t* xt, const uint8_t* glo, const uint8_t* ghi,
                float* out, long long* acc64, int din, int dout, int Np,
                cudaStream_t st) {
  using Sh = PredShape<WM, WN, MT, NT>;
  const int ti = (din + Sh::BM - 1) / Sh::BM, tj = (dout + Sh::BN - 1) / Sh::BN;
  const int kts = Np / KT;
  const int splits = pred_splits(ti * tj, kts);
  const int per = (kts + splits - 1) / splits;
  int err;
  if (splits > 1) {
    if (!acc64) return (int)cudaErrorInvalidValue;
    err = (int)cudaMemsetAsync(acc64, 0, (size_t)din * dout * 8, st);
    if (err) return err;
  }
  err = (int)cudaFuncSetAttribute(pred_mma_kernel<WM, WN, MT, NT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Sh::kSmem);
  if (err) return err;
  pred_mma_kernel<WM, WN, MT, NT>
      <<<dim3(tj, ti, splits), Sh::kThreads, Sh::kSmem, st>>>(
          xt, glo, ghi, out, splits > 1 ? acc64 : nullptr, din, dout, Np,
          per);
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  return ll_to_f32(acc64, out, (long long)din * dout, st);
}

// ---------------------------------------------------------------------------
// pass 2: the full product on the CUDA cores, and the select
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, kThreads = 256;
constexpr int kFullChunk = 512;     // tokens per int32 partial of pass 2

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
        atomic_add_ll(&out[(size_t)i * dout + j], acc[a][b]);
    }
  }
}

// Eq. (2) select and the fallback flags, one block per tile of the TPU
// kernel's grid (bm = min(128, din) rows by bn = min(128, dout) columns,
// padded up to whole tiles).  A padded element holds g_msb = 0, which is
// confident only when tau <= 0, exactly as in the TPU kernel.
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ pred,
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
      const float pm = pred[idx];
      const bool conf = fabsf(pm) >= tv;
      const long long v = full[idx];
      sign[idx] = conf ? (int8_t)((pm > 0.f) - (pm < 0.f))
                       : (int8_t)((v > 0) - (v < 0));
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

// token splits psg_pred makes at this geometry; above 1 it needs the int64
// scratch acc64 (din x dout)
int psg_pred_splits(int Np, int din, int dout) {
  return pred_splits_for(din, dout, Np);
}

int psg_pred(const void* xm, const void* gm, void* xt, void* gt, void* out,
             void* acc64, int N, int Np, int din, int dout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Np % KT || Np < N || N < 0) return (int)cudaErrorInvalidValue;
  if (din == 0 || dout == 0) return 0;
  if (N == 0) return (int)cudaMemsetAsync(out, 0, (size_t)din * dout * 4, st);
  uint8_t* lo = (uint8_t*)gt;
  uint8_t* hi = lo + (size_t)dout * Np;
  kmajor_kernel<int8_t><<<dim3(Np / TT, (din + TT - 1) / TT), 256, 0, st>>>(
      (const int8_t*)xm, N, din, Np, (uint8_t*)xt, nullptr);
  kmajor_kernel<int16_t><<<dim3(Np / TT, (dout + TT - 1) / TT), 256, 0, st>>>(
      (const int16_t*)gm, N, dout, Np, lo, hi);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (dout >= 128)
    return launch_pred<2, 4, 4, 4>((const int8_t*)xt, lo, hi, (float*)out,
                                   (long long*)acc64, din, dout, Np, st);
  return launch_pred<4, 1, 2, 4>((const int8_t*)xt, lo, hi, (float*)out,
                                 (long long*)acc64, din, dout, Np, st);
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
      (const float*)pred, (const long long*)full, (const float*)tau,
      (int8_t*)sign, (int32_t*)stats, din, dout, bm, bn);
  return (int)cudaGetLastError();
}

}  // extern "C"
