// Implicit-GEMM NHWC convolution and the PSG weight-gradient sign, for Hopper
// (sm_90a).  Plain C entry points, bound from Python with ctypes
// (kernels/conv.py); every entry launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().
//
// Layouts: activations NHWC, pre-padded (B, Hp, Wp, C); weights patch-major
// (k*k*C, dout) with row = c*k*k + ki*k + kj (JAX package, kernels/conv.py).
//
// Replaces, in the JAX package's src/repro/kernels/conv.py:
//   conv_fwd_codes      <- conv_fwd_pallas / _conv_fwd_kernel (8-bit codes)
//   conv_fwd            <- the same, on fp32 operands (wider codes)
//   conv_grad_x_codes   <- conv_grad_x_pallas / _conv_grad_x_kernel (8-bit w)
//   conv_grad_x         <- the same, on fp32 operands (wider weight codes)
//   conv_grad_w_pred    <- conv_grad_w_predictor_pallas / _conv_pred_kernel
//   conv_grad_w_sign    <- conv_grad_w_pallas / _conv_grad_w_kernel
//
// Bounds on an H100 at the CIFAR ResNet shapes.  The forward on 8-bit codes
// is bound by its bytes (int8 codes in, fp32 y out) far above its operations
// at the int8 rate; on fp32 operands by its operations at the fp32 rate.
// The input gradient on codes (int16 g codes and int8 weight codes in, fp32
// dx out) is bound by its bytes, its two byte-plane products at the int8
// rate far below them; on fp32 operands by its operations at the fp32 rate.
// The integer weight-gradient passes, counted at the int8 rate, are bound by
// their bytes.
// No im2col tensor is ever written: the k x k gather happens in shared
// memory or in the index arithmetic, as in the TPU kernels.
//
// The forward on 8-bit codes (conv_fwd_mma_kernel), the input gradient on
// 8-bit weight codes (conv_dx_mma_kernel) and both PSG weight-gradient
// passes (conv_pred_mma_kernel, conv_sign_mma_kernel) run int8
// mma.sync.m16n8k32 with int32 sums on the tensor cores; only the forward
// and the input gradient on 16-bit weight codes run on the CUDA cores.
//
// conv_fwd_mma_kernel: y = (sum_t window_t(cx) cw_t) (sx sw), exact in int32
// (at most 127^2 k^2 C, below 2^24 at ResNet widths, so also exact as fp32)
// and scaled once at the end.  M is the output positions, N dout, K = k^2 C
// in (tap, channel) order, so that a 16-byte group of K is 16 channels of
// one pixel: A (the codes, NHWC) is K-major per tap as it lies in memory.
// A block owns 16 positions per warp (a tile of whole output rows of one
// image, or of whole images) times a dout tile of 16-64.  It stages the
// input rows of its tile plus the k - 1 halo rows, full width and all
// channels, once with cp.async, and the tap-major weight tile w^T (dout x
// k^2 C, prepared by the wrapper), and runs every tap from shared memory:
// ldmatrix reads the A fragment of 16 positions straight from the staged
// pixels, a table gives each 16-byte K group its offset (tap, channel)
// within the window.  Channel counts that are not a multiple of 16 (the
// stem's 3) gather their A bytes one by one through a per-byte table, with K
// zero-padded to 32.  The epilogue multiplies the fp32 of the sum by sx sw,
// read on the device, and stores fp32 NHWC.
//
// conv_dx_mma_kernel: dx = (sum over the taps that reach a position of
// g_window gc w_t^T) (sg sw), the transposed conv as a gather (no scatter,
// no atomics).  dx splits into s x s stride phases (pi, pj); a phase's
// positions (pi + s u, pj + s v) form a lattice on which each of its taps
// (ki = pi + s a, kj = pj + s b) reads g at (u - a, v - b): a stride-1
// implicit GEMM with M the lattice positions, N the dx channels and K the
// phase's taps x dout, and a block owns one phase (blockIdx.z).  The block
// stages its lattice rows of g plus amax = (k - 1) / s halo rows and
// columns once (cp.async, zero outside the output extent, int16 codes as
// they lie in memory) and runs every tap from shared memory, a table giving
// each 16-channel K group its offset, as the forward does.  The 16-bit codes
// go to the int8 MMAs as byte planes, g = 256 hi + lo (lo u8, hi s8):
// ldmatrix reads 16 channels of 16 positions as 16-bit pairs and
// __byte_perm packs the low bytes and the high bytes of channels 2t, 2t + 1,
// 8 + 2t and 9 + 2t into one A register each (perm16 order; the weight
// pre-pass writes w^T of each phase in the same channel order).  Each plane
// sums in int32, exact (K 255 127 < 2^31), and the epilogue rounds the
// int64 256 hi + lo once to fp32 (__ll2float_rn) and multiplies by sg sw:
// at a 3 x 3 conv with dout 64 and every code at its limit the sum reaches
// 576 x 32767 x 127 = 2.4e9, past int32, so the planes never fold into one
// int32 sum.
//
// conv_pred_mma_kernel: out[c k^2 + t, o] = sum_n x_msb[window_t(n), c]
// g_msb[n, o], the exact integer sum rounded once to fp32.  K is the
// position axis.  The int8 MMAs want K contiguous, so a pre-pass
// (grid_kmajor_kernel) writes channel-major copies on a padded grid: x
// codes (C, B Hq Wq) per stride phase, and the two byte planes of the 10-bit
// g codes (lo = g & 0xFF u8, hi = g >> 8 s8, g = 256 hi + lo) scattered onto
// the same grid with zeros where no output lies.  On that grid tap (ki, kj)
// is phase (ki % s, kj % s) shifted by (ki / s) Wq + kj / s positions, so a
// block stages one chunk of positions of g and of x (with its halo) once and
// computes all k^2 taps from it: warp w takes tap w % k^2 (1x1 convs split
// the chunk's K among four warps; kernels up to 3 x 3).  A tap's shift is not
// 4-byte aligned, so its A fragments come from two 32-bit shared loads and a
// funnel shift; the g fragments come by ldmatrix and serve every tap.  Each plane sums in
// int32 over at most 65536 positions a split (65536 * 127 * 255 < 2^31);
// the epilogue forms 256 sum(x hi) + sum(x lo) in int64, splits of the
// position axis meet in int64 atomics (exact and order-free), and a last
// pass rounds them to fp32 (__ll2float_rn).  The padded grid costs 1.13x
// to 1.56x the positions of the valid outputs at the ResNet stages.
//
// conv_sign_mma_kernel: PSG pass 2, the same body (conv_code_mma) on the
// 8-bit x codes and the byte planes of the 16-bit g codes (each plane's
// int32 sum stays exact over 65536 positions a split: 65536 * 127 * 255 and
// 65536 * 128 * 128 < 2^31); the splits meet in int64 atomics, and
// conv_select_kernel then runs the Eq. (2) select and the fallback flags
// over the whole output at once.  At the ResNet-74 batch-128 sites the
// position axis always splits (12,800 to 147,968 grid positions against
// about two blocks per SM), so no block holds a finished sum to select in
// its own epilogue.  A select in the epilogue of the last block of each
// output tile to arrive (an arrival count after a __threadfence) was
// slower on an H100: one block selected a whole 32 x 32 x 9 tile, and
// every block waited on its fence.  The x pre-pass zeroes the sums and
// the g pre-pass the flags, so a call is four launches and no memset.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;          // H100 SXM

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// shared-memory row pitch for rows of `bytes` bytes: a multiple of 16 that is
// 16 more than a multiple of 128, so that the eight rows one ldmatrix (or one
// 32-bit load per lane of four consecutive words) reads fall in different
// bank groups
inline int smem_pitch(int bytes) {
  int p = (bytes + 15) / 16 * 16;
  while (p % 128 != 16) p += 16;
  return p;
}

// ---------------------------------------------------------------------------
// forward on fp32 operands (codes wider than 8 bits): one thread per output
// element, fp32 accumulation over the taps and input channels.  Neighbouring
// threads differ in the output channel, so the weight reads and the output
// writes are coalesced and the input reads are broadcasts.
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
// forward on 8-bit codes: int8 implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

struct FwdPlan {
  int B, Hp, Wp, C, dout, k, s, Ho, Wo;
  int Kp;           // k^2 C rounded up to 32
  int R, NI, tpi;   // output rows and images a tile, tiles an image group
  int rin;          // input rows staged per image: (R - 1) s + k
  int xbytes;       // staged input bytes: NI rin Wp C, rounded up to 16
  int wpitch;       // shared row pitch of the weight tile
  int vec;          // C % 16 == 0: ldmatrix A; else byte gathers
  int copy16;       // the image slabs can be copied in 16-byte pieces
};

// y tile (16 positions a warp) x (8 NT dout); K in 32-byte steps
template <int NT>
__global__ void __launch_bounds__(256)
conv_fwd_mma_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ wt,    // (dout tiles * 8NT, Kp)
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    float* __restrict__ y, FwdPlan P) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                              // staged input
  unsigned char* zero = xs + P.xbytes;                   // 16 zero bytes
  unsigned char* ws = zero + 16;                         // BN x wpitch
  int* koff = reinterpret_cast<int*>(ws + BN * P.wpitch);  // K offsets
  const int nthreads = blockDim.x;
  const int tile = blockIdx.x, j0 = blockIdx.y * BN;
  const int b0 = (tile / P.tpi) * P.NI, oh0 = (tile % P.tpi) * P.R;
  const int WpC = P.Wp * P.C, slab = P.rin * WpC;

  // stage the input slabs, the weight tile and the K offset table
  for (int img = 0; img < P.NI; ++img) {
    const int b = b0 + img;
    if (b >= P.B) break;
    const int rows = min(P.rin, P.Hp - oh0 * P.s);
    const size_t src0 = ((size_t)b * P.Hp + oh0 * P.s) * WpC;
    const int n = rows * WpC;
    unsigned char* dst = xs + img * slab;
    if (P.copy16) {
      for (int e = threadIdx.x * 16; e < n; e += nthreads * 16)
        cp_async16(dst + e, x + src0 + e, true);
    } else {
      for (int e = threadIdx.x; e < n; e += nthreads)
        dst[e] = (unsigned char)x[src0 + e];
    }
  }
  const int kg = P.Kp / 16;
  for (int e = threadIdx.x; e < BN * kg; e += nthreads) {
    const int r = e / kg, g = e % kg;
    cp_async16(ws + r * P.wpitch + g * 16, wt + (size_t)(j0 + r) * P.Kp + g * 16,
               true);
  }
  cp_async_commit();
  const int K = P.k * P.k * P.C;
  const int nk = P.vec ? kg : P.Kp;      // 16-byte groups, or single bytes
  for (int e = threadIdx.x; e < nk; e += nthreads) {
    const int kk = P.vec ? e * 16 : e;
    int off = -1;
    if (kk < K) {
      const int t = kk / P.C, c = kk % P.C;
      off = ((t / P.k) * P.Wp + t % P.k) * P.C + c;
    }
    koff[e] = off;
  }
  if (threadIdx.x < 4) reinterpret_cast<unsigned*>(zero)[threadIdx.x] = 0u;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RW = P.R * P.Wo;
  // shared offset of the window's top-left pixel of position m of the tile,
  // and whether that position is an output
  auto pix = [&](int m, bool& ok) {
    const int img = m / RW, r = (m / P.Wo) % P.R, ow = m % P.Wo;
    ok = img < P.NI && b0 + img < P.B && oh0 + r < P.Ho;
    return ok ? img * slab + (r * P.s * P.Wp + ow * P.s) * P.C : 0;
  };
  const int m0 = warp * 16;
  int acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0;

  if (P.vec) {
    bool ok;
    const int pa = pix(m0 + lane % 16, ok);
    for (int ks = 0; ks < P.Kp / 32; ++ks) {
      const int off = koff[2 * ks + lane / 16];
      unsigned a[4];
      ldsm_x4(a, off < 0 ? zero : xs + pa + off);
#pragma unroll
      for (int np = 0; np < NT; np += 2) {
        const int row = np * 8 + lane % 8 + (lane / 16) * 8;
        unsigned bf[4];
        ldsm_x4(bf, ws + row * P.wpitch + ks * 32 + ((lane / 8) % 2) * 16);
        mma_s8s8(acc[np], a, bf[0], bf[1]);
        mma_s8s8(acc[np + 1], a, bf[2], bf[3]);
      }
    }
  } else {
    bool ok0, ok1;
    const int p0 = pix(m0 + lane / 4, ok0), p1 = pix(m0 + lane / 4 + 8, ok1);
    for (int ks = 0; ks < P.Kp / 32; ++ks) {
      unsigned a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int base = (r & 1) ? p1 : p0;
        const int kk = ks * 32 + (r >> 1) * 16 + (lane % 4) * 4;
        unsigned v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = koff[kk + e];
          const unsigned byte = off < 0 ? 0u : (unsigned)xs[base + off];
          v |= byte << (8 * e);
        }
        a[r] = v;
      }
#pragma unroll
      for (int np = 0; np < NT; np += 2) {
        const int row = np * 8 + lane % 8 + (lane / 16) * 8;
        unsigned bf[4];
        ldsm_x4(bf, ws + row * P.wpitch + ks * 32 + ((lane / 8) % 2) * 16);
        mma_s8s8(acc[np], a, bf[0], bf[1]);
        mma_s8s8(acc[np + 1], a, bf[2], bf[3]);
      }
    }
  }

  // epilogue: fp32 of the exact sum times sx sw, NHWC
  const float scale = __fmul_rn(*sx, *sw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + lane / 4 + h * 8;
    bool ok;
    pix(m, ok);
    if (!ok) continue;
    const int img = m / RW, r = (m / P.Wo) % P.R, ow = m % P.Wo;
    float* yr = y + ((((size_t)(b0 + img) * P.Ho + oh0 + r) * P.Wo + ow) *
                     P.dout);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int o = j0 + n * 8 + (lane % 4) * 2;
      const float v0 = __fmul_rn((float)acc[n][2 * h], scale);
      const float v1 = __fmul_rn((float)acc[n][2 * h + 1], scale);
      if (o + 1 < P.dout && P.dout % 2 == 0) {
        *reinterpret_cast<float2*>(yr + o) = make_float2(v0, v1);
      } else {
        if (o < P.dout) yr[o] = v0;
        if (o + 1 < P.dout) yr[o + 1] = v1;
      }
    }
  }
}

// wt[o][t C + c] = wc[(c k^2 + t) dout + o]: the tap-major w^T of the
// patch-major weight codes, zero in the rows and columns of padding
__global__ void wt_tapmajor_kernel(const int8_t* __restrict__ wc,
                                   int8_t* __restrict__ wt, int C, int kk,
                                   int dout, int rows, int Kp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * Kp) return;
  const int o = (int)(i / Kp), q = (int)(i % Kp);
  int8_t v = 0;
  if (o < dout && q < kk * C)
    v = wc[((size_t)(q % C) * kk + q / C) * dout + o];
  wt[i] = v;
}

// tile plan of the forward on codes: warps (2, 4 or 8; 16 positions each),
// rows and images a tile, shared bytes; false when no plan fits
bool plan_fwd(FwdPlan& P, int bn, int& warps, size_t& smem) {
  if (P.Wo > 128) return false;
  const int tiles_n = (P.dout + bn - 1) / bn;
  auto tile = [&](int w) {          // the tile of w warps; the tile count
    const int bmp = 16 * w;
    if (P.Ho * P.Wo <= bmp) {
      P.R = P.Ho, P.NI = bmp / (P.Ho * P.Wo), P.tpi = 1;
    } else {
      P.R = bmp / P.Wo, P.NI = 1, P.tpi = (P.Ho + P.R - 1) / P.R;
    }
    return (long long)(P.B + P.NI - 1) / P.NI * P.tpi * tiles_n;
  };
  // the most warps that still give about two blocks per SM
  for (warps = 8; warps > 2 && 16 * (warps / 2) >= P.Wo; warps /= 2)
    if (tile(warps) >= 2 * kSMs) break;
  tile(warps);
  P.rin = (P.R - 1) * P.s + P.k;
  const long long xb = (long long)P.NI * P.rin * P.Wp * P.C;
  P.xbytes = (int)((xb + 15) / 16 * 16);
  P.wpitch = smem_pitch(P.Kp);
  smem = (size_t)P.xbytes + 16 + (size_t)bn * P.wpitch +
         sizeof(int) * (size_t)(P.vec ? P.Kp / 16 : P.Kp);
  return xb < (1LL << 30) && smem <= 227 * 1024;
}

template <int NT>
int launch_fwd_mma(const int8_t* x, const int8_t* wt, const float* sx,
                   const float* sw, float* y, FwdPlan P, cudaStream_t st) {
  int warps;
  size_t smem;
  if (!plan_fwd(P, 8 * NT, warps, smem)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(conv_fwd_mma_kernel<NT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  const int tiles = (P.B + P.NI - 1) / P.NI * P.tpi;
  dim3 grid(tiles, (P.dout + 8 * NT - 1) / (8 * NT));
  lint::note(conv_fwd_mma_kernel<NT>, "conv_fwd_mma_kernel", NT, warps * 32,
             smem);
  conv_fwd_mma_kernel<NT><<<grid, warps * 32, smem, st>>>(x, wt, sx, sw, y, P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// input gradient on fp32 operands (weight codes wider than 8 bits): the
// gather form of the transposed conv.  One thread per
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
// input gradient on the codes: int8 implicit GEMM on the tensor cores, one
// stride phase a block
// ---------------------------------------------------------------------------

struct DxPlan {
  int B, Ho, Wo, dout, C, k, s, hp, wp;
  int nu, nv;       // the phase lattice: ceil(hp / s) x ceil(wp / s)
  int amax;         // (k - 1) / s: halo rows and columns of the staged g
  int Wg;           // staged g columns: nv + amax
  int pitch;        // staged bytes a g pixel: 32 ceil(dout / 16) + 16
  int dout16;       // dout rounded up to 16: K entries a tap
  int Kp;           // row pitch of the phase weights, >= every phase's K
  int R, NI, tpi;   // lattice rows and images a tile, tiles an image group
  int rin;          // staged g rows an image: R + amax
  int slab;         // staged bytes an image: rin Wg pitch
  int gbytes;       // NI slab
  int wpitch;       // shared row pitch of the weight tile
  int copy16;       // dout % 8 == 0 and gc 16-byte aligned: cp.async rows
};

// taps of phase (pi, pj): ki = pi + s a, kj = pj + s b, a < na, b < nb
__host__ __device__ __forceinline__ int phase_taps(int k, int s, int p) {
  return p < k ? (k - p + s - 1) / s : 0;
}
// K bytes of a phase: its taps x dout16, rounded up to the 32-byte MMA depth
__host__ __device__ __forceinline__ int phase_k(const DxPlan& P, int z) {
  const int n = phase_taps(P.k, P.s, z / P.s) * phase_taps(P.k, P.s, z % P.s);
  return (n * P.dout16 + 31) / 32 * 32;
}

// wt[z][n][kk], phase z = pi s + pj: K entry kk = ta dout16 + oo is tap ta =
// a nb + b of the phase (ki = pi + s a, kj = pj + s b) and output channel o
// = 16 (oo / 16) + perm16(oo % 16), the order in which the A fragments
// (packed by __byte_perm from ldmatrix of the int16 g rows) hold the
// channels; zero past the phase's taps, past dout and past C
__global__ void wt_dx_kernel(const int8_t* __restrict__ wc,
                             int8_t* __restrict__ wt, DxPlan P, int rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)rows * P.Kp;
  if (i >= (long long)P.s * P.s * per) return;
  const int z = (int)(i / per), n = (int)(i % per / P.Kp);
  const int kk = (int)(i % P.Kp);
  const int pi = z / P.s, pj = z % P.s;
  const int na = phase_taps(P.k, P.s, pi), nb = phase_taps(P.k, P.s, pj);
  const int ta = kk / P.dout16, oo = kk % P.dout16;
  const int o = (oo & ~15) + perm16(oo & 15);
  int8_t v = 0;
  if (n < P.C && ta < na * nb && o < P.dout) {
    const int ki = pi + P.s * (ta / nb), kj = pj + P.s * (ta % nb);
    v = wc[((size_t)n * P.k * P.k + ki * P.k + kj) * P.dout + o];
  }
  wt[i] = v;
}

// dx tile (16 lattice positions a warp of one stride phase) x (8 NT dx
// channels); K = the phase's taps x dout in 32-byte steps.  A is the int16
// g codes, staged once per block (lattice rows plus the amax halo rows and
// columns, zero outside the output extent) and read by ldmatrix as 16-bit
// pairs; __byte_perm splits each register pair into the u8 low and s8 high
// byte planes of four channels (2t, 2t + 1, 8 + 2t, 9 + 2t: perm16), so
// that each plane is one int8 A fragment.  Two MMAs a step (lo u8 x w s8,
// hi s8 x w s8), int32 sums exact per plane; the epilogue forms 256 hi + lo
// in int64, rounds it once to fp32 and multiplies by sg sw.
template <int NT>
__global__ void __launch_bounds__(256)
conv_dx_mma_kernel(const int16_t* __restrict__ g,
                   const int8_t* __restrict__ wt,   // (s^2, rows, Kp)
                   const float* __restrict__ sg, const float* __restrict__ sw,
                   float* __restrict__ dx, DxPlan P, int rows) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* gs = smem;                              // staged g
  unsigned char* zero = gs + P.gbytes;                   // 32 zero bytes
  unsigned char* ws = zero + 32;                         // BN x wpitch
  int* koff = reinterpret_cast<int*>(ws + BN * P.wpitch);  // K offsets
  const int nthreads = blockDim.x;
  const int tile = blockIdx.x, j0 = blockIdx.y * BN, z = blockIdx.z;
  const int pi = z / P.s, pj = z % P.s;
  const int nb = phase_taps(P.k, P.s, pj);
  const int ntaps = phase_taps(P.k, P.s, pi) * nb;
  const int Kz = phase_k(P, z);
  const int b0 = (tile / P.tpi) * P.NI, u0 = (tile % P.tpi) * P.R;
  const int rowb = P.Wg * P.pitch;

  // stage g: lattice rows u0 - amax .. u0 + R - 1, columns -amax .. nv - 1
  const int chunks = P.pitch / 16 - 1;      // 16-byte pieces of a pixel read
  const int dchunks = P.dout / 8;           // of them, holding g codes
  for (int img = 0; img < P.NI; ++img) {
    const int b = b0 + img;
    if (b >= P.B) break;
    unsigned char* dst = gs + img * P.slab;
    if (P.copy16) {
      const int n = P.rin * P.Wg * chunks;
      for (int e = threadIdx.x; e < n; e += nthreads) {
        const int ch = e % chunks, px = e / chunks;
        const int oh = u0 - P.amax + px / P.Wg, ow = px % P.Wg - P.amax;
        const bool ok = ch < dchunks && oh >= 0 && oh < P.Ho && ow >= 0 &&
                        ow < P.Wo;
        const int16_t* src =
            ok ? g + (((size_t)b * P.Ho + oh) * P.Wo + ow) * P.dout + ch * 8 : g;
        cp_async16(dst + px * P.pitch + ch * 16, src, ok);
      }
    } else {
      const int n = P.rin * P.Wg * P.dout16;
      for (int e = threadIdx.x; e < n; e += nthreads) {
        const int o = e % P.dout16, px = e / P.dout16;
        const int oh = u0 - P.amax + px / P.Wg, ow = px % P.Wg - P.amax;
        const bool ok = o < P.dout && oh >= 0 && oh < P.Ho && ow >= 0 &&
                        ow < P.Wo;
        reinterpret_cast<int16_t*>(dst + px * P.pitch)[o] =
            ok ? g[(((size_t)b * P.Ho + oh) * P.Wo + ow) * P.dout + o] : 0;
      }
    }
  }
  const int kg = Kz / 16;
  for (int e = threadIdx.x; e < BN * kg; e += nthreads) {
    const int r = e / kg, c = e % kg;
    cp_async16(ws + r * P.wpitch + c * 16,
               wt + ((size_t)z * rows + j0 + r) * P.Kp + c * 16, true);
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < kg; e += nthreads) {
    const int ta = e * 16 / P.dout16, cc = e * 16 % P.dout16;
    int off = -1;
    if (ta < ntaps) {
      const int a = ta / nb, bb = ta % nb;
      off = ((P.amax - a) * P.Wg + P.amax - bb) * P.pitch + cc * 2;
    }
    koff[e] = off;
  }
  if (threadIdx.x < 8) reinterpret_cast<unsigned*>(zero)[threadIdx.x] = 0u;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RW = P.R * P.nv;
  // the lattice position m of the tile: its staged offset (at tap a = b =
  // amax) and whether it is a dx position
  auto pos = [&](int m, int& b, int& p, int& q) {
    const int img = m / RW, r = (m / P.nv) % P.R, v = m % P.nv;
    b = b0 + img, p = pi + P.s * (u0 + r), q = pj + P.s * v;
    const bool ok = img < P.NI && b < P.B && u0 + r < P.nu && p < P.hp &&
                    q < P.wp;
    return ok ? img * P.slab + r * rowb + v * P.pitch : -1;
  };
  const int m0 = warp * 16;
  int lo[NT][4], hi[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) lo[n][c] = hi[n][c] = 0;

  int b_, p_, q_;
  const int pa = max(0, pos(m0 + lane % 16, b_, p_, q_));
  const int half = (lane / 16) * 16;       // lanes 16-31: channels 8-15
  for (int ks = 0; ks < Kz / 32; ++ks) {
    unsigned r[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = koff[2 * ks + h];
      ldsm_x4(r[h], (off < 0 ? zero : gs + pa + off) + half);
    }
    unsigned al[4], ah[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      al[2 * h] = __byte_perm(r[h][0], r[h][2], 0x6420);
      al[2 * h + 1] = __byte_perm(r[h][1], r[h][3], 0x6420);
      ah[2 * h] = __byte_perm(r[h][0], r[h][2], 0x7531);
      ah[2 * h + 1] = __byte_perm(r[h][1], r[h][3], 0x7531);
    }
#pragma unroll
    for (int np = 0; np < NT; np += 2) {
      const int row = np * 8 + lane % 8 + (lane / 16) * 8;
      unsigned bf[4];
      ldsm_x4(bf, ws + row * P.wpitch + ks * 32 + ((lane / 8) % 2) * 16);
      mma_u8s8(lo[np], al, bf[0], bf[1]);
      mma_s8s8(hi[np], ah, bf[0], bf[1]);
      mma_u8s8(lo[np + 1], al, bf[2], bf[3]);
      mma_s8s8(hi[np + 1], ah, bf[2], bf[3]);
    }
  }

  // epilogue: fp32 of the exact 256 hi + lo, times sg sw, NHWC
  const float scale = __fmul_rn(*sg, *sw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int b, p, q;
    if (pos(m0 + lane / 4 + h * 8, b, p, q) < 0) continue;
    float* row = dx + (((size_t)b * P.hp + p) * P.wp + q) * P.C;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = j0 + n * 8 + (lane % 4) * 2;
      const float v0 = __fmul_rn(
          __ll2float_rn(256LL * hi[n][2 * h] + lo[n][2 * h]), scale);
      const float v1 = __fmul_rn(
          __ll2float_rn(256LL * hi[n][2 * h + 1] + lo[n][2 * h + 1]), scale);
      if (c + 1 < P.C && P.C % 2 == 0) {
        *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
      } else {
        if (c < P.C) row[c] = v0;
        if (c + 1 < P.C) row[c + 1] = v1;
      }
    }
  }
}

// tile plan of the input gradient on codes: warps (2, 4 or 8; 16 lattice
// positions each), lattice rows and images a tile, shared bytes; false when
// no plan fits
bool plan_dx(DxPlan& P, int bn, int& warps, size_t& smem) {
  if (P.nv > 128) return false;
  const long long tiles_n = (long long)(P.C + bn - 1) / bn * P.s * P.s;
  auto tile = [&](int w) {          // the tile of w warps; the block count
    const int bmp = 16 * w;
    if (P.nu * P.nv <= bmp) {
      P.R = P.nu, P.NI = bmp / (P.nu * P.nv), P.tpi = 1;
    } else {
      P.R = bmp / P.nv, P.NI = 1, P.tpi = (P.nu + P.R - 1) / P.R;
    }
    return (long long)(P.B + P.NI - 1) / P.NI * P.tpi * tiles_n;
  };
  // the most warps that still give about two blocks per SM
  for (warps = 8; warps > 2 && 16 * (warps / 2) >= P.nv; warps /= 2)
    if (tile(warps) >= 2 * kSMs) break;
  tile(warps);
  P.rin = P.R + P.amax;
  P.slab = P.rin * P.Wg * P.pitch;
  const long long gb = (long long)P.NI * P.slab;
  P.gbytes = (int)gb;
  P.wpitch = smem_pitch(P.Kp);
  smem = (size_t)P.gbytes + 32 + (size_t)bn * P.wpitch +
         sizeof(int) * (size_t)(P.Kp / 16);
  return gb < (1LL << 30) && smem <= 227 * 1024;
}

template <int NT>
int launch_dx_mma(const int16_t* g, const int8_t* wt, const float* sg,
                  const float* sw, float* dx, DxPlan P, int rows,
                  cudaStream_t st) {
  int warps;
  size_t smem;
  if (!plan_dx(P, 8 * NT, warps, smem)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(conv_dx_mma_kernel<NT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  const int tiles = (P.B + P.NI - 1) / P.NI * P.tpi;
  dim3 grid(tiles, (P.C + 8 * NT - 1) / (8 * NT), P.s * P.s);
  lint::note(conv_dx_mma_kernel<NT>, "conv_dx_mma_kernel", NT, warps * 32,
             smem);
  conv_dx_mma_kernel<NT><<<grid, warps * 32, smem, st>>>(g, wt, sg, sw, dx, P,
                                                          rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// PSG pass 1, the predictor product, on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int PT = 128;            // positions (bytes of a K-major row) a stage
constexpr int kPredStages = 3;
constexpr int kMaxSplitStages = 65536 / PT;   // int32 partials' bound
constexpr int kMinSplitStages = 2;
constexpr int GT = 256;            // positions of a pre-pass block
constexpr int kSelectThreads = 256;
constexpr int kSelectUnroll = 8;   // elements a thread of the select per round

// Pre-pass: codes (B, Hs, Ws, C) position-major -> byte planes (C, Np)
// K-major on the padded grid of B x Hq x Wq positions, one plane set per
// stride phase (pi, pj) = (z / s, z % s), z = blockIdx.z, at offset z C Np:
// grid position (b, u, v) takes the code at (b, u s + pi, v s + pj) where
// that lies inside Hs x Ws, else 0, and every position from B Hq Wq to Np
// is 0.  int8 codes give one plane (their bytes); int16 codes lo = g & 0xFF
// and hi = g >> 8.  A block takes GT consecutive positions, one thread each,
// which reads its position's channels (16-byte loads where the row allows),
// and then writes 16 channels x GT positions per round through shared
// memory, 16 positions of one channel a thread.  The grid also zeroes the
// nzero words at `zero` (the passes' int64 sums, kernel 4's flags), so that
// they need no memset of their own.
template <typename CODE>
__global__ void __launch_bounds__(GT)
grid_kmajor_kernel(const CODE* __restrict__ src, int C, int Np, int B,
                   int Hq, int Wq, int Hs, int Ws, int s, int vec,
                   uint8_t* __restrict__ lo, uint8_t* __restrict__ hi,
                   unsigned* __restrict__ zero, int nzero) {
  __shared__ CODE tile[16][GT + 16];   // [channel][position]
  const int n0 = blockIdx.x * GT, t = threadIdx.x;
  for (int i = (blockIdx.z * gridDim.x + blockIdx.x) * GT + t; i < nzero;
       i += gridDim.z * gridDim.x * GT)
    zero[i] = 0;
  const int pi = blockIdx.z / s, pj = blockIdx.z % s;
  lo += (size_t)blockIdx.z * C * Np;
  const int per_img = Hq * Wq, P = n0 + t;
  const CODE* row = nullptr;            // this position's channels, or none
  if (P < B * per_img) {
    const int b = P / per_img, r = P % per_img;
    const int h = (r / Wq) * s + pi, w = (r % Wq) * s + pj;
    if (h < Hs && w < Ws) row = src + (((size_t)b * Hs + h) * Ws + w) * C;
  }
  constexpr int PER16 = 16 / sizeof(CODE);      // codes in 16 bytes
  for (int c0 = 0; c0 < C; c0 += 16) {
    const int nc = min(16, C - c0);
    if (vec && nc == 16) {
#pragma unroll
      for (int q = 0; q < 16 / PER16; ++q) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row) v = *reinterpret_cast<const uint4*>(row + c0 + q * PER16);
        const CODE* e = reinterpret_cast<const CODE*>(&v);
#pragma unroll
        for (int j = 0; j < PER16; ++j) tile[q * PER16 + j][t] = e[j];
      }
    } else {
      for (int j = 0; j < nc; ++j) tile[j][t] = row ? row[c0 + j] : (CODE)0;
    }
    __syncthreads();
    // thread -> channel c0 + t / (GT / 16), positions 16 (t % (GT / 16)) ..
    const int c = t / (GT / 16), n = (t % (GT / 16)) * 16;
    if (c < nc) {
      unsigned wl[4], wh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wl[q] = wh[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int v = (int)tile[c][n + 4 * q + b];
          wl[q] |= (unsigned)(v & 0xff) << (8 * b);
          wh[q] |= (unsigned)((v >> 8) & 0xff) << (8 * b);   // arithmetic shift
        }
      }
      const size_t off = (size_t)(c0 + c) * Np + n0 + n;
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(wl[0], wl[1], wl[2], wl[3]);
      if (hi)
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(wh[0], wh[1], wh[2], wh[3]);
    }
    __syncthreads();
  }
}

struct PredPlan {
  int C, dout, k, s;
  int Np, NpX;      // padded positions of the g planes and of the x copies
  int Wq;           // padded-grid row length
  int xw, xpitch;   // staged x bytes a row (chunk plus halo) and its pitch
  int ksplit;       // warps sharing one tap (1x1 convs: 4)
  int stages_per_split;
};

// MT m16 tiles of channels, NP pairs of n8 tiles of dout, per block
template <int MT, int NP>
struct PredTile {
  static constexpr int MB = 16 * MT, NB = 16 * NP;
  static constexpr int GPITCH = PT + 16;                 // 144: 16 mod 128
  __host__ __device__ static int stage_bytes(const PredPlan& P) {
    return 2 * NB * GPITCH + P.s * P.s * MB * P.xpitch;
  }
};

// The MMA body of both weight-gradient passes: out64[c k^2 + t, o] += sum
// over this block's positions of the tap-t shifted x codes times the g
// planes (256 hi + lo)
template <int MT, int NP>
__device__ __forceinline__ void conv_code_mma(
    const int8_t* __restrict__ xt,     // (s^2, C, NpX)
    const uint8_t* __restrict__ glo,   // (dout, Np)
    const uint8_t* __restrict__ ghi, long long* __restrict__ out64,
    const PredPlan& P) {
  using T = PredTile<MT, NP>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int i0 = blockIdx.y * T::MB, j0 = blockIdx.x * T::NB;
  const int kt0 = blockIdx.z * P.stages_per_split;
  const int nk = max(0, min(P.Np / PT, kt0 + P.stages_per_split) - kt0);
  const int nthreads = blockDim.x, kk2 = P.k * P.k, ph2 = P.s * P.s;
  const int stage = T::stage_bytes(P);
  const int xg = P.xw / 16;                 // 16-byte pieces of an x row

  // stage layout: [0, NB) lo rows, [NB, 2 NB) hi rows (pitch GPITCH), then
  // s^2 MB x rows (pitch xpitch), phase-major
  auto load = [&](int buf, int kt) {
    unsigned char* base = smem + buf * stage;
    const size_t p0 = (size_t)(kt0 + kt) * PT;
    for (int e = threadIdx.x; e < 2 * T::NB * (PT / 16); e += nthreads) {
      const int r = e / (PT / 16), ch = e % (PT / 16);
      const int j = j0 + r % T::NB;
      const bool ok = j < P.dout;
      const uint8_t* plane = r < T::NB ? glo : ghi;
      cp_async16(base + r * T::GPITCH + ch * 16,
                 ok ? plane + (size_t)j * P.Np + p0 + ch * 16 : glo, ok);
    }
    unsigned char* xb = base + 2 * T::NB * T::GPITCH;
    for (int e = threadIdx.x; e < ph2 * T::MB * xg; e += nthreads) {
      const int r = e / xg, ch = e % xg;
      const int ph = r / T::MB, c = i0 + r % T::MB;
      const bool ok = c < P.C;
      cp_async16(xb + r * P.xpitch + ch * 16,
                 ok ? reinterpret_cast<const uint8_t*>(xt) +
                          ((size_t)ph * P.C + c) * P.NpX + p0 + ch * 16
                    : glo, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = warp % kk2, ksub = warp / kk2;
  const int ki = t / P.k, kj = t % P.k;
  const int ph = (ki % P.s) * P.s + kj % P.s;
  const int shift = (ki / P.s) * P.Wq + kj / P.s;
  const int sw = shift >> 2, sb = (shift & 3) * 8;     // words, bits

  int hi[MT][2 * NP][4], lo[MT][2 * NP][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 2 * NP; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[a][b][c] = lo[a][b][c] = 0;

#pragma unroll
  for (int st = 0; st < kPredStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kPredStages - 2>();
    __syncthreads();
    if (it + kPredStages - 1 < nk)
      load((it + kPredStages - 1) % kPredStages, it + kPredStages - 1);
    cp_async_commit();
    const unsigned char* slo = smem + (it % kPredStages) * stage;
    const unsigned char* shi = slo + T::NB * T::GPITCH;
    const unsigned* sx = reinterpret_cast<const unsigned*>(
        shi + T::NB * T::GPITCH + ph * T::MB * P.xpitch);
    const int xpw = P.xpitch / 4;
    for (int kk = ksub * 32; kk < PT; kk += 32 * P.ksplit) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = mt * 16 + lane / 4 + (r & 1) * 8;
          const unsigned* w = sx + row * xpw + sw + (kk + (r >> 1) * 16) / 4 +
                              lane % 4;
          a[mt][r] = __funnelshift_r(w[0], w[1], sb);
        }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const int row = np * 16 + lane % 8 + (lane / 16) * 8;
        const int kb = kk + ((lane / 8) % 2) * 16;
        unsigned bl[4], bh[4];
        ldsm_x4(bl, slo + row * T::GPITCH + kb);
        ldsm_x4(bh, shi + row * T::GPITCH + kb);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8u8(lo[mt][2 * np], a[mt], bl[0], bl[1]);
          mma_s8u8(lo[mt][2 * np + 1], a[mt], bl[2], bl[3]);
          mma_s8s8(hi[mt][2 * np], a[mt], bh[0], bh[1]);
          mma_s8s8(hi[mt][2 * np + 1], a[mt], bh[2], bh[3]);
        }
      }
    }
  }

  // epilogue: 256 hi + lo in int64, added into the patch-major sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ch = i0 + mt * 16 + lane / 4 + (c / 2) * 8;
        const int o = j0 + nt * 8 + (lane % 4) * 2 + c % 2;
        if (ch >= P.C || o >= P.dout) continue;
        const long long v = 256LL * hi[mt][nt][c] + lo[mt][nt][c];
        if (v) atomic_add_ll(out64 + ((size_t)ch * kk2 + t) * P.dout + o, v);
      }
}

// kernel 3 (pass 1) and kernel 4 (pass 2): one body, two kernels, so that
// each shows by its name in the SASS
template <int MT, int NP>
__global__ void __launch_bounds__(288)
conv_pred_mma_kernel(const int8_t* __restrict__ xt,
                     const uint8_t* __restrict__ glo,
                     const uint8_t* __restrict__ ghi,
                     long long* __restrict__ out64, PredPlan P) {
  conv_code_mma<MT, NP>(xt, glo, ghi, out64, P);
}

template <int MT, int NP>
__global__ void __launch_bounds__(288)
conv_sign_mma_kernel(const int8_t* __restrict__ xt,
                     const uint8_t* __restrict__ glo,
                     const uint8_t* __restrict__ ghi,
                     long long* __restrict__ full, PredPlan P) {
  conv_code_mma<MT, NP>(xt, glo, ghi, full, P);
}

template <int MT, int NP, bool kSign>
int launch_code_mma(const int8_t* xt, const uint8_t* glo, const uint8_t* ghi,
                    long long* out64, PredPlan P, cudaStream_t st) {
  using T = PredTile<MT, NP>;
  const int ti = (P.C + T::MB - 1) / T::MB, tj = (P.dout + T::NB - 1) / T::NB;
  const int kts = P.Np / PT, tiles = ti * tj;
  int splits = (2 * kSMs + tiles - 1) / tiles;  // about two blocks per SM
  const int most = kts / kMinSplitStages > 1 ? kts / kMinSplitStages : 1;
  splits = splits < most ? splits : most;
  const int least = (kts + kMaxSplitStages - 1) / kMaxSplitStages;
  splits = splits > least ? splits : least;
  P.stages_per_split = (kts + splits - 1) / splits;
  splits = (kts + P.stages_per_split - 1) / P.stages_per_split;
  const size_t smem = (size_t)kPredStages * T::stage_bytes(P);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = kSign ? conv_sign_mma_kernel<MT, NP>
                      : conv_pred_mma_kernel<MT, NP>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int threads = 32 * P.k * P.k * P.ksplit;
  lint::note(kernel, kSign ? "conv_sign_mma_kernel" : "conv_pred_mma_kernel",
             10 * MT + NP, threads, smem);
  kernel<<<dim3(tj, ti, splits), threads, smem, st>>>(xt, glo, ghi, out64, P);
  return (int)cudaGetLastError();
}

// the MMA tile by width: 32 channels above 16, 32 dout columns above 16
template <bool kSign>
int launch_by_width(const int8_t* xt, const uint8_t* glo, const uint8_t* ghi,
                    long long* out64, const PredPlan& P, cudaStream_t st) {
  const bool m2 = P.C > 16, n2 = P.dout > 16;
  if (m2 && n2) return launch_code_mma<2, 2, kSign>(xt, glo, ghi, out64, P, st);
  if (m2) return launch_code_mma<2, 1, kSign>(xt, glo, ghi, out64, P, st);
  if (n2) return launch_code_mma<1, 2, kSign>(xt, glo, ghi, out64, P, st);
  return launch_code_mma<1, 1, kSign>(xt, glo, ghi, out64, P, st);
}

// Eq. (2) select after the product: sign(pred) where |pred| >= tau, else
// sign(full), and one fallback flag per (tap, bn-wide dout block), zeroed
// before.  Block (j, y) takes the columns of flag block j in rows [y R, y R
// + R) (row = c k^2 + tap), kSelectUnroll elements a thread per round with
// every load issued before any store, ORs per tap "any element not
// confident" in shared memory and sets each such flag with one atomicOr.
// Columns the TPU kernel padded up to a whole block hold g_msb = 0 and
// count as fallback whenever tau > 0: the blocks of the last column set
// every tap's flag there.
__global__ void __launch_bounds__(kSelectThreads)
conv_select_kernel(const float* __restrict__ pred,
                   const long long* __restrict__ full,
                   const float* __restrict__ tau, int8_t* __restrict__ sign,
                   int32_t* __restrict__ stats, int rows, int dout, int kk,
                   int bn, int R) {
  __shared__ unsigned taps;    // bit t: tap t holds an element not confident
  if (threadIdx.x == 0) taps = 0;
  __syncthreads();
  const float tv = *tau;
  const int j = blockIdx.x, nj = gridDim.x, c0 = j * bn;
  const int bw = min(bn, dout - c0), r0 = blockIdx.y * R;
  const int n = min(R, rows - r0) * bw;
  unsigned mask = 0;
  for (int e0 = threadIdx.x; e0 < n; e0 += kSelectUnroll * kSelectThreads) {
    float pm[kSelectUnroll];
    long long v[kSelectUnroll];
#pragma unroll
    for (int u = 0; u < kSelectUnroll; ++u) {
      const int e = e0 + u * kSelectThreads;
      if (e < n) {
        const size_t idx = (size_t)(r0 + e / bw) * dout + c0 + e % bw;
        pm[u] = pred[idx];
        v[u] = full[idx];
      }
    }
#pragma unroll
    for (int u = 0; u < kSelectUnroll; ++u) {
      const int e = e0 + u * kSelectThreads;
      if (e >= n) break;
      const int row = r0 + e / bw;
      const bool conf = fabsf(pm[u]) >= tv;
      sign[(size_t)row * dout + c0 + e % bw] =
          conf ? (int8_t)((pm[u] > 0.f) - (pm[u] < 0.f))
               : (int8_t)((v[u] > 0) - (v[u] < 0));
      if (!conf) mask |= 1u << (row % kk);
    }
  }
  if (j == nj - 1 && dout % bn && !(0.f >= tv)) mask = (1u << kk) - 1;
  if (mask) atomicOr(&taps, mask);
  __syncthreads();
  if (threadIdx.x < kk && (taps >> threadIdx.x & 1))
    atomicOr(stats + threadIdx.x * nj + j, 1);
}

// The plan and the scratch layout of both passes: the int64 sums (8 k^2 C
// dout bytes, rounded up to 128), then the x copies (s^2, C, NpX) and the g
// planes (2, dout, Np); kernels/conv.py computes the same sizes
// (_wgrad_scratch)
struct WgradScratch {
  long long* acc;
  int8_t* xt;
  uint8_t *lo, *hi;
  int acc_words;      // the sums, in 4-byte words
};

int wgrad_plan(int B, int C, int dout, int k, int s, int Hq, int Wq, int Np,
               int NpX, void* scratch, PredPlan& P, WgradScratch& S) {
  if (k > 3 || s < 1 || Np % GT || NpX % GT || (long long)B * Hq * Wq > Np)
    return (int)cudaErrorInvalidValue;
  const int halo = ((k - 1) / s) * Wq + (k - 1) / s;
  P = PredPlan{};
  P.C = C, P.dout = dout, P.k = k, P.s = s, P.Np = Np, P.NpX = NpX, P.Wq = Wq;
  P.xw = (PT + halo + 4 + 15) / 16 * 16;   // + 4: the funnel shift's next word
  P.xpitch = smem_pitch(P.xw);
  P.ksplit = k * k >= 4 ? 1 : 4 / (k * k);
  if (Np + P.xw - PT > NpX) return (int)cudaErrorInvalidValue;
  const size_t acc_b = ((size_t)k * k * C * dout * 8 + 127) / 128 * 128;
  S.acc = (long long*)scratch;
  S.xt = (int8_t*)scratch + acc_b;
  S.lo = (uint8_t*)S.xt + (size_t)s * s * C * NpX;
  S.hi = S.lo + (size_t)dout * Np;
  S.acc_words = (int)(acc_b / 4);
  return 0;
}

// both pre-passes: x codes per stride phase, the g codes' byte planes; the
// first also zeroes the int64 sums, the second zs words at sp
int wgrad_prepass(const void* x, const void* g, int B, int Hp, int Wp, int C,
                  int Ho, int Wo, int dout, int s, int Hq, int Wq,
                  const PredPlan& P, const WgradScratch& S, unsigned* sp,
                  int zs, cudaStream_t st) {
  // 16-byte loads of a position's channels where every row is 16-byte aligned
  const int vx = C % 16 == 0 && (uintptr_t)x % 16 == 0;
  const int vg = dout % 8 == 0 && (uintptr_t)g % 16 == 0;
  lint::note(grid_kmajor_kernel<int8_t>, "grid_kmajor_kernel", 1, GT, 0);
  grid_kmajor_kernel<int8_t><<<dim3(P.NpX / GT, 1, s * s), GT, 0, st>>>(
      (const int8_t*)x, C, P.NpX, B, Hq, Wq, Hp, Wp, s, vx, (uint8_t*)S.xt,
      nullptr, (unsigned*)S.acc, S.acc_words);
  lint::note(grid_kmajor_kernel<int16_t>, "grid_kmajor_kernel", 2, GT, 0);
  grid_kmajor_kernel<int16_t><<<dim3(P.Np / GT, 1, 1), GT, 0, st>>>(
      (const int16_t*)g, dout, P.Np, B, Hq, Wq, Ho, Wo, 1, vg, S.lo, S.hi, sp,
      zs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv_fwd(const void* x, const void* w, void* y, int B, int Hp, int Wp,
             int C, int dout, int k, int s, int Ho, int Wo, void* stream) {
  long long total = (long long)B * Ho * Wo * dout;
  if (total == 0) return 0;
  lint::note(conv_fwd_kernel, "conv_fwd_kernel", 0, kThreads, 0);
  conv_fwd_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, B, Hp, Wp, C, dout, k, s,
      Ho, Wo);
  return (int)cudaGetLastError();
}

// xc (B, Hp, Wp, C) int8 codes, wc (k^2 C, dout) int8 patch-major codes,
// sx, sw fp32 scalars on the device; wt scratch of ceil(dout / bn) bn x Kp
// bytes for the tap-major w^T, with Kp = k^2 C rounded up to 32 and the dout
// tile bn = 16 for dout <= 16, 32 for dout <= 32, else 64
int conv_fwd_codes(const void* xc, const void* wc, void* wt, const void* sx,
                   const void* sw, void* y, int B, int Hp, int Wp, int C,
                   int dout, int k, int s, int Ho, int Wo, int Kp, int bn,
                   int aligned, void* stream) {
  if ((long long)B * Ho * Wo * dout == 0) return 0;
  if (Kp % 32 || Kp < k * k * C || bn != (dout <= 16 ? 16 : dout <= 32 ? 32 : 64))
    return (int)cudaErrorInvalidValue;
  FwdPlan P{};
  P.B = B, P.Hp = Hp, P.Wp = Wp, P.C = C, P.dout = dout, P.k = k, P.s = s;
  P.Ho = Ho, P.Wo = Wo, P.Kp = Kp, P.vec = C % 16 == 0;
  P.copy16 = aligned && (Wp * C) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (dout + bn - 1) / bn * bn;
  lint::note(wt_tapmajor_kernel, "wt_tapmajor_kernel", 0, kThreads, 0);
  wt_tapmajor_kernel<<<blocks_for((long long)rows * Kp), kThreads, 0, st>>>(
      (const int8_t*)wc, (int8_t*)wt, C, k * k, dout, rows, Kp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int8_t* xp = (const int8_t*)xc;
  const int8_t* wp = (const int8_t*)wt;
  const float *fx = (const float*)sx, *fw = (const float*)sw;
  if (bn == 16) return launch_fwd_mma<2>(xp, wp, fx, fw, (float*)y, P, st);
  if (bn == 32) return launch_fwd_mma<4>(xp, wp, fx, fw, (float*)y, P, st);
  return launch_fwd_mma<8>(xp, wp, fx, fw, (float*)y, P, st);
}

int conv_grad_x(const void* g, const void* wt, void* dx, int B, int Ho, int Wo,
                int dout, int C, int k, int s, int Hp, int Wp, void* stream) {
  long long total = (long long)B * Hp * Wp * C;
  if (total == 0) return 0;
  lint::note(conv_grad_x_kernel, "conv_grad_x_kernel", 0, kThreads, 0);
  conv_grad_x_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)wt, (float*)dx, B, Ho, Wo, dout, C, k, s,
      Hp, Wp);
  return (int)cudaGetLastError();
}

// gc (B, Ho, Wo, dout) int16 codes, wc (k^2 C, dout) int8 patch-major codes,
// sg, sw fp32 scalars on the device; wt scratch of s^2 rows Kp bytes for the
// phase weights, rows = C rounded up to the dx channel tile bn (16 for C <=
// 16, 32 for C <= 32, else 64), Kp = ceil(k / s)^2 taps x dout rounded up to
// 16, rounded up to 32 (the K bytes of phase (0, 0), the largest)
int conv_grad_x_codes(const void* gc, const void* wc, void* wt,
                      const void* sg, const void* sw, void* dx, int B,
                      int Ho, int Wo, int dout, int C, int k, int s, int hp,
                      int wp, int Kp, int rows, int aligned, void* stream) {
  if ((long long)B * hp * wp * C == 0) return 0;
  const int bn = C <= 16 ? 16 : C <= 32 ? 32 : 64;
  DxPlan P{};
  P.B = B, P.Ho = Ho, P.Wo = Wo, P.dout = dout, P.C = C, P.k = k, P.s = s;
  P.hp = hp, P.wp = wp;
  P.nu = (hp + s - 1) / s, P.nv = (wp + s - 1) / s;
  P.amax = (k - 1) / s, P.Wg = P.nv + P.amax;
  P.dout16 = (dout + 15) / 16 * 16, P.pitch = 2 * P.dout16 + 16;
  P.Kp = Kp;
  P.copy16 = aligned && dout % 8 == 0;
  // int32 sums of each byte plane stay exact: Kp 255 127 < 2^31
  if (s < 1 || Kp != phase_k(P, 0) || Kp > 65536 ||
      rows != (C + bn - 1) / bn * bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)s * s * rows * Kp;
  if (n > 0) {
    lint::note(wt_dx_kernel, "wt_dx_kernel", 0, kThreads, 0);
    wt_dx_kernel<<<blocks_for(n), kThreads, 0, st>>>((const int8_t*)wc,
                                                    (int8_t*)wt, P, rows);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int16_t* gp = (const int16_t*)gc;
  const int8_t* wp8 = (const int8_t*)wt;
  const float *fg = (const float*)sg, *fw = (const float*)sw;
  if (bn == 16) return launch_dx_mma<2>(gp, wp8, fg, fw, (float*)dx, P, rows, st);
  if (bn == 32) return launch_dx_mma<4>(gp, wp8, fg, fw, (float*)dx, P, rows, st);
  return launch_dx_mma<8>(gp, wp8, fg, fw, (float*)dx, P, rows, st);
}

// xm (B, Hp, Wp, C) int8, gm (B, Ho, Wo, dout) int16 codes; out (k^2 C,
// dout) fp32; scratch as WgradScratch lays it out, with Np and NpX as
// kernels/conv.py computes them
int conv_grad_w_pred(const void* xm, const void* gm, void* scratch, void* out,
                     int B, int Hp, int Wp, int C, int Ho, int Wo, int dout,
                     int k, int s, int Hq, int Wq, int Np, int NpX,
                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n_out = (size_t)k * k * C * dout;
  if (n_out == 0) return 0;
  PredPlan P;
  WgradScratch S;
  int err = wgrad_plan(B, C, dout, k, s, Hq, Wq, Np, NpX, scratch, P, S);
  if (!err)
    err = wgrad_prepass(xm, gm, B, Hp, Wp, C, Ho, Wo, dout, s, Hq, Wq, P, S,
                        nullptr, 0, st);
  if (!err) err = launch_by_width<false>(S.xt, S.lo, S.hi, S.acc, P, st);
  if (err) return err;
  return ll_to_f32(S.acc, (float*)out, (long long)n_out, st);
}

// pred (k^2 C, dout) fp32, xq (B, Hp, Wp, C) int8 and gq (B, Ho, Wo, dout)
// int16 codes, tau one fp32 value on the device; sign (k^2 C, dout) int8,
// stats (k^2, nj) int32 flags of bn-wide dout blocks; scratch as for
// conv_grad_w_pred.  Four launches: the two pre-passes (which zero the sums
// and the flags), the MMA kernel and the select.
int conv_grad_w_sign(const void* pred, const void* xq, const void* gq,
                     const void* tau, void* scratch, void* sign, void* stats,
                     int B, int Hp, int Wp, int C, int Ho, int Wo, int dout,
                     int k, int s, int Hq, int Wq, int Np, int NpX, int bn,
                     int nj, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = k * k * C;
  if ((long long)rows * dout == 0) return 0;
  if (bn < 1 || nj != (dout + bn - 1) / bn) return (int)cudaErrorInvalidValue;
  PredPlan P;
  WgradScratch S;
  int err = wgrad_plan(B, C, dout, k, s, Hq, Wq, Np, NpX, scratch, P, S);
  if (!err)
    err = wgrad_prepass(xq, gq, B, Hp, Wp, C, Ho, Wo, dout, s, Hq, Wq, P, S,
                        (unsigned*)stats, k * k * nj, st);
  if (!err) err = launch_by_width<true>(S.xt, S.lo, S.hi, S.acc, P, st);
  if (err) return err;
  // rows a select block: about kSelectUnroll elements a thread
  const int bw = bn < dout ? bn : dout;
  const int R = (kSelectUnroll * kSelectThreads + bw - 1) / bw;
  lint::note(conv_select_kernel, "conv_select_kernel", 0, kSelectThreads, 0);
  conv_select_kernel<<<dim3(nj, (rows + R - 1) / R), kSelectThreads, 0, st>>>(
      (const float*)pred, S.acc, (const float*)tau, (int8_t*)sign,
      (int32_t*)stats, rows, dout, k * k, bn, R);
  return (int)cudaGetLastError();
}

// the int64 sums (k^2 C, dout) alone, left at the head of scratch: the two
// pre-passes and the MMA kernel of pass 1 (sign_pass 0) or pass 2 (1), for
// a caller that sums them across ranks before the rounding or the select
int conv_grad_w_sums(const void* x, const void* g, void* scratch,
                     int sign_pass, int B, int Hp, int Wp, int C, int Ho,
                     int Wo, int dout, int k, int s, int Hq, int Wq, int Np,
                     int NpX, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)k * k * C * dout == 0) return 0;
  PredPlan P;
  WgradScratch S;
  int err = wgrad_plan(B, C, dout, k, s, Hq, Wq, Np, NpX, scratch, P, S);
  if (!err)
    err = wgrad_prepass(x, g, B, Hp, Wp, C, Ho, Wo, dout, s, Hq, Wq, P, S,
                        nullptr, 0, st);
  if (err) return err;
  return sign_pass ? launch_by_width<true>(S.xt, S.lo, S.hi, S.acc, P, st)
                   : launch_by_width<false>(S.xt, S.lo, S.hi, S.acc, P, st);
}

// conv_grad_w_sign's select on int64 sums given (rows = k^2 C): zeroes the
// flags, then one launch of the select kernel
int conv_grad_w_select(const void* pred, const void* acc, const void* tau,
                       void* sign, void* stats, int rows, int dout, int kk,
                       int bn, int nj, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)rows * dout == 0) return 0;
  if (bn < 1 || nj != (dout + bn - 1) / bn) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(stats, 0, (size_t)kk * nj * 4, st);
  if (err) return err;
  const int bw = bn < dout ? bn : dout;
  const int R = (kSelectUnroll * kSelectThreads + bw - 1) / bw;
  lint::note(conv_select_kernel, "conv_select_kernel", 0, kSelectThreads, 0);
  conv_select_kernel<<<dim3(nj, (rows + R - 1) / R), kSelectThreads, 0, st>>>(
      (const float*)pred, (const long long*)acc, (const float*)tau,
      (int8_t*)sign, (int32_t*)stats, rows, dout, kk, bn, R);
  return (int)cudaGetLastError();
}

}  // extern "C"

LINT_EXPORTS(conv)
