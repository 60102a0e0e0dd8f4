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
//             exact in integers on the int8 tensor cores, then the Eq. (2)
//             select against pass 1's fp32 product at threshold tau (read
//             from device memory), and one fallback flag per 128 x 128 tile
//             of the TPU kernel's grid.
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
// Both passes run one MMA kernel body (code_mma) on the int8 tensor cores
// (mma.sync.m16n8k32, int32 sums); a template parameter picks the epilogue:
//   * Exact integer arithmetic.  Each int16 g code is split into two byte
//     planes, lo = g & 0xFF (u8) and hi = g >> 8 (s8), so g = 256 hi + lo for
//     every int16 code.  Two MMAs per fragment, s8 x s8 on (x, hi) and s8 x
//     u8 on (x, lo), sum in int32 over at most kMaxSplitTokens tokens, where
//     neither plane can overflow for any int8 x code (65536 * 128 * 255 <
//     2^31: the 4-bit codes of pass 1 and the 8-bit ones of pass 2 alike);
//     the epilogue forms 256 sum(x hi) + sum(x lo) in int64.  The two planes
//     cost twice the operations of one int8 product, so 2x the bound is this
//     design's own floor.
//   * Layout.  The int8 MMAs want both operands K-major, K being the token
//     axis, but the codes arrive token-major and ldmatrix has no 8-bit
//     transpose.  A pre-pass kernel (kmajor_kernel, csrc/tc.cuh) writes x^T
//     (din, Np) and the two planes of g^T (dout, Np), zero-padded to Np, a
//     multiple of the 128-token stage; the wrapper allocates them and its
//     time counts in the kernel's (about 15% of it at the qwen2.5-3b widths).
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
//     than the card has SMs, or N passes 65536 tokens, the token axis is
//     split across blocks, which meet in int64 atomics in scratch that the
//     wrapper allocates, and a last pass finishes: pass 1 rounds the sums to
//     fp32 (ll_to_f32), pass 2 runs the select (select_kernel).
//   * Epilogues.  Pass 1 rounds each exact int64 sum once to fp32
//     (__ll2float_rn), at any N, as the JAX package's fp32 pass 1 returns
//     it.  Pass 2, where the token axis is not split, selects in the
//     epilogue: it reads pred and tau, writes the sign, and ORs the tile's
//     "any element not confident" into the fallback flag of the TPU tile
//     that holds the block (every CUDA block lies in exactly one: blocks are
//     128 rows and the TPU tile is min(128, din); 128 or 32 columns and the
//     TPU tile is 128 when dout >= 128, else all of dout).  That path needs
//     no int64 product in device memory and no memset of one; only the
//     flags are zeroed first.
// Later work: wgmma fed by TMA in 128-byte swizzled layouts (a first wgmma
// version of pass 1, on unswizzled core matrices fed by the same cp.async
// ring, was slower than this one), and the transpose fused into the loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int kSMs = 132;              // H100 SXM

constexpr int KT = 128;                // tokens (bytes of a K-major row) per stage
constexpr int KPITCH = KT + 16;        // padded shared-memory row pitch, bytes
constexpr int kStages = 3;
constexpr int kMinStagesPerBlock = 4;  // at least 512 tokens per split
// tokens per int32 partial: 65536 * 128 * 255 < 2^31 for either byte plane
constexpr int kMaxSplitTokens = 65536;
constexpr int kMaxStagesPerBlock = kMaxSplitTokens / KT;
constexpr int kSelectThreads = 256;

// WM x WN warps, each MT x NT MMA tiles (16 x 8) of both planes
template <int WM, int WN, int MT, int NT>
struct MmaShape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int kRows = BM + 2 * BN;      // x^T, lo and hi rows a stage
  static constexpr int kStage = kRows * KPITCH;  // bytes
  static constexpr int kSmem = kStages * kStage;
};

// Pass 2's epilogue: the Eq. (2) select against pass 1's pred at tau, and the
// fallback flag of the TPU tile (bm x bn of an ni x nj grid, padded up to
// whole tiles) that holds the block.  A padded element holds g_msb = 0, which
// is confident only when tau <= 0, exactly as in the TPU kernel.
struct SelectArgs {
  const float* pred;
  const float* tau;
  int8_t* sign;
  int32_t* stats;
  int bm, bn, nj;
};

// out[i, j] (+)= sum over this block's tokens of x[n, i] g[n, j]: the MMA
// body of both passes.  With acc64 the int64 sums go there by atomics (the
// token axis is split); else kSelect picks the epilogue: pass 1 stores fp32,
// pass 2 selects.
template <int WM, int WN, int MT, int NT, bool kSelect>
__device__ __forceinline__ void code_mma(
    const int8_t* __restrict__ xt, const uint8_t* __restrict__ glo,
    const uint8_t* __restrict__ ghi, float* __restrict__ out,
    long long* __restrict__ acc64, const SelectArgs& sel, int din, int dout,
    int Np, int stages_per_block) {
  using Sh = MmaShape<WM, WN, MT, NT>;
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

  // epilogue: 256 hi + lo in int64, added into acc64, stored as fp32, or
  // selected against pred
  const bool fused = kSelect && !acc64;
  const float tv = fused ? *sel.tau : 0.f;
  // the TPU tile grid, padded up to whole tiles
  const int rows_pad = fused ? (din + sel.bm - 1) / sel.bm * sel.bm : 0;
  const int cols_pad = fused ? (dout + sel.bn - 1) / sel.bn * sel.bn : 0;
  int notconf = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm * MT * 16 + mt * 16 + lane / 4 + (c / 2) * 8;
        const int j = j0 + wn * NT * 8 + nt * 8 + (lane % 4) * 2 + c % 2;
        if (i >= din || j >= dout) {
          // a padded element of the TPU tile grid (not one past it)
          if (fused && i < rows_pad && j < cols_pad) notconf |= !(0.f >= tv);
          continue;
        }
        const long long v = 256LL * hi[mt][nt][c] + lo[mt][nt][c];
        const size_t idx = (size_t)i * dout + j;
        if (acc64) {
          if (v) atomic_add_ll(acc64 + idx, v);
        } else if (!kSelect) {
          out[idx] = __ll2float_rn(v);
        } else {
          const float pm = sel.pred[idx];
          const bool conf = fabsf(pm) >= tv;
          sel.sign[idx] = conf ? (int8_t)((pm > 0.f) - (pm < 0.f))
                               : (int8_t)((v > 0) - (v < 0));
          notconf |= !conf;
        }
      }
  if (fused) {
    const int any = __syncthreads_or(notconf);
    if (threadIdx.x == 0 && any)
      atomicOr(sel.stats + (i0 / sel.bm) * sel.nj + j0 / sel.bn, 1);
  }
}

// pass 1 (predictor) and pass 2 (sign): one body, two kernels, so that each
// shows by its name in the SASS
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
pred_mma_kernel(const int8_t* __restrict__ xt, const uint8_t* __restrict__ glo,
                const uint8_t* __restrict__ ghi, float* __restrict__ out,
                long long* __restrict__ acc64, int din, int dout, int Np,
                int stages_per_block) {
  code_mma<WM, WN, MT, NT, false>(xt, glo, ghi, out, acc64, SelectArgs{},
                                  din, dout, Np, stages_per_block);
}

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
sign_mma_kernel(const int8_t* __restrict__ xt, const uint8_t* __restrict__ glo,
                const uint8_t* __restrict__ ghi, long long* __restrict__ acc64,
                SelectArgs sel, int din, int dout, int Np,
                int stages_per_block) {
  code_mma<WM, WN, MT, NT, true>(xt, glo, ghi, nullptr, acc64, sel, din,
                                 dout, Np, stages_per_block);
}

// token splits of the MMA kernels: about two blocks per SM where the output
// has fewer tiles than the card has SMs, and never more than
// kMaxStagesPerBlock stages a split (the int32 partials' bound)
int mma_splits(int tiles, int kts) {
  if (kts <= 0) return 1;
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

// the MMA tiling at this width: 128 x 128 tiles, or 128 x 32 below 128
// output columns
constexpr bool wide(int dout) { return dout >= 128; }

template <int WM, int WN, int MT, int NT>
int mma_tiles(int din, int dout) {
  using Sh = MmaShape<WM, WN, MT, NT>;
  return ((din + Sh::BM - 1) / Sh::BM) * ((dout + Sh::BN - 1) / Sh::BN);
}

int splits_for(int din, int dout, int Np) {
  const int tiles = wide(dout) ? mma_tiles<2, 4, 4, 4>(din, dout)
                               : mma_tiles<4, 1, 2, 4>(din, dout);
  return mma_splits(tiles, Np / KT);
}

// Launch pass 1 (kSelect false) or pass 2 (true) on the K-major planes.
// With acc64 (din x dout int64) the sums go there, zeroed first; it is
// required where the token axis is split, and `force_acc` asks for it at any
// split count (the int64 product alone).
template <int WM, int WN, int MT, int NT, bool kSelect>
int launch_mma(const int8_t* xt, const uint8_t* glo, const uint8_t* ghi,
               float* out, long long* acc64, bool force_acc,
               const SelectArgs& sel, int din, int dout, int Np,
               bool* used_acc, cudaStream_t st) {
  using Sh = MmaShape<WM, WN, MT, NT>;
  const int ti = (din + Sh::BM - 1) / Sh::BM, tj = (dout + Sh::BN - 1) / Sh::BN;
  const int kts = Np / KT;
  const int splits = mma_splits(ti * tj, kts);
  const int per = (kts + splits - 1) / splits;
  const bool use_acc = splits > 1 || force_acc;
  *used_acc = use_acc;
  int err;
  if (use_acc) {
    if (!acc64) return (int)cudaErrorInvalidValue;
    err = (int)cudaMemsetAsync(acc64, 0, (size_t)din * dout * 8, st);
    if (err) return err;
  }
  long long* acc = use_acc ? acc64 : nullptr;
  if constexpr (kSelect) {
    err = (int)cudaFuncSetAttribute(sign_mma_kernel<WM, WN, MT, NT>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Sh::kSmem);
    if (err) return err;
    sign_mma_kernel<WM, WN, MT, NT>
        <<<dim3(tj, ti, splits), Sh::kThreads, Sh::kSmem, st>>>(
            xt, glo, ghi, acc, sel, din, dout, Np, per);
  } else {
    err = (int)cudaFuncSetAttribute(pred_mma_kernel<WM, WN, MT, NT>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    Sh::kSmem);
    if (err) return err;
    pred_mma_kernel<WM, WN, MT, NT>
        <<<dim3(tj, ti, splits), Sh::kThreads, Sh::kSmem, st>>>(
            xt, glo, ghi, out, acc, din, dout, Np, per);
  }
  return (int)cudaGetLastError();
}

template <bool kSelect>
int launch_by_width(const int8_t* xt, const uint8_t* glo, const uint8_t* ghi,
                    float* out, long long* acc64, bool force_acc,
                    const SelectArgs& sel, int din, int dout, int Np,
                    bool* used_acc, cudaStream_t st) {
  if (wide(dout))
    return launch_mma<2, 4, 4, 4, kSelect>(xt, glo, ghi, out, acc64, force_acc,
                                           sel, din, dout, Np, used_acc, st);
  return launch_mma<4, 1, 2, 4, kSelect>(xt, glo, ghi, out, acc64, force_acc,
                                         sel, din, dout, Np, used_acc, st);
}

// x codes (int8) and g codes (int16) token-major -> x^T and the two planes
// of g^T, K-major, in xt (din x Np) and gt (2 x dout x Np)
template <typename XCODE>
int prepass(const void* xm, const void* gm, void* xt, void* gt, int N,
            int Np, int din, int dout, cudaStream_t st) {
  uint8_t* lo = (uint8_t*)gt;
  uint8_t* hi = lo + (size_t)dout * Np;
  int err = kmajor<int8_t, false>((const int8_t*)xm, 1, N, din, Np,
                                  (uint8_t*)xt, nullptr, st);
  if (err) return err;
  return kmajor<int16_t, false>((const int16_t*)gm, 1, N, dout, Np, lo, hi,
                                st);
}

// Eq. (2) select and the fallback flags after a split product, one block
// per tile of the TPU kernel's grid (bm = min(128, din) rows by bn = min(128,
// dout) columns, padded up to whole tiles); the same rule as the fused
// epilogue of code_mma
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const float* __restrict__ pred,
              const long long* __restrict__ full,
              const float* __restrict__ tau, int8_t* __restrict__ sign,
              int32_t* __restrict__ stats, int din, int dout, int bm,
              int bn) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  const float tv = *tau;
  int notconf = 0;
  for (int e = threadIdx.x; e < bm * bn; e += kSelectThreads) {
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

}  // namespace

extern "C" {

// token splits the MMA kernels make at this geometry (both passes tile
// alike); above 1 they need the int64 scratch acc64 (din x dout)
int psg_splits(int Np, int din, int dout) {
  return splits_for(din, dout, Np);
}

int psg_pred(const void* xm, const void* gm, void* xt, void* gt, void* out,
             void* acc64, int N, int Np, int din, int dout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Np % KT || Np < N || N < 0) return (int)cudaErrorInvalidValue;
  if (din == 0 || dout == 0) return 0;
  if (N == 0) return (int)cudaMemsetAsync(out, 0, (size_t)din * dout * 4, st);
  int err = prepass<int8_t>(xm, gm, xt, gt, N, Np, din, dout, st);
  if (err) return err;
  const uint8_t* lo = (const uint8_t*)gt;
  bool used_acc = false;
  err = launch_by_width<false>((const int8_t*)xt, lo, lo + (size_t)dout * Np,
                               (float*)out, (long long*)acc64, false,
                               SelectArgs{}, din, dout, Np, &used_acc, st);
  if (err || !used_acc) return err;
  return ll_to_f32((const long long*)acc64, (float*)out, (long long)din * dout,
                   st);
}

// pass 2: sign (din x dout) int8 and stats (ni x nj) int32, the TPU tiles
// being bm x bn; `full` (din x dout int64) is scratch where the tokens split
int psg_sign(const void* pred, const void* xq, const void* gq,
             const void* tau, void* xt, void* gt, void* full, void* sign,
             void* stats, int N, int Np, int din, int dout, int bm, int bn,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Np % KT || Np < N || N < 0 || bm < 1 || bn < 1)
    return (int)cudaErrorInvalidValue;
  if (din == 0 || dout == 0) return 0;
  const int ni = (din + bm - 1) / bm, nj = (dout + bn - 1) / bn;
  int err = prepass<int8_t>(xq, gq, xt, gt, N, Np, din, dout, st);
  if (err) return err;
  err = (int)cudaMemsetAsync(stats, 0, (size_t)ni * nj * 4, st);
  if (err) return err;
  const uint8_t* lo = (const uint8_t*)gt;
  const SelectArgs sel{(const float*)pred, (const float*)tau, (int8_t*)sign,
                       (int32_t*)stats, bm, bn, nj};
  bool used_acc = false;
  err = launch_by_width<true>((const int8_t*)xt, lo, lo + (size_t)dout * Np,
                              nullptr, (long long*)full, false, sel, din, dout,
                              Np, &used_acc, st);
  if (err || !used_acc) return err;
  select_kernel<<<dim3(nj, ni), kSelectThreads, 0, st>>>(
      (const float*)pred, (const long long*)full, (const float*)tau,
      (int8_t*)sign, (int32_t*)stats, din, dout, bm, bn);
  return (int)cudaGetLastError();
}

// pass 2's exact int64 product alone, full (din x dout), through the same
// pre-pass and MMA kernel: for the tests, on no training path
int psg_full_product(const void* xq, const void* gq, void* xt, void* gt,
                     void* full, int N, int Np, int din, int dout,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Np % KT || Np < N || N < 0 || !full) return (int)cudaErrorInvalidValue;
  if (din == 0 || dout == 0) return 0;
  int err = prepass<int8_t>(xq, gq, xt, gt, N, Np, din, dout, st);
  if (err) return err;
  const uint8_t* lo = (const uint8_t*)gt;
  bool used_acc = false;
  return launch_by_width<true>((const int8_t*)xt, lo, lo + (size_t)dout * Np,
                               nullptr, (long long*)full, true, SelectArgs{},
                               din, dout, Np, &used_acc, st);
}

}  // extern "C"
