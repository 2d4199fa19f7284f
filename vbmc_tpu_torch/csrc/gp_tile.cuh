// GP predictive machinery shared by the acquisition kernels of this
// directory (prospective_acq.cu, viqr_acq.cu), CUDA C++ for sm_90a.
//
// One block of 256 threads (8 warps) owns MT candidates C of one GP
// hyperparameter sample s. For SE-ard with a zero, const or negquad mean it
// computes
//
//   ks_s   = sf2_s * exp(-1/2 |(X - C) / ell_s|^2) * nmask        (N x MT)
//   fmu_s  = m_s(C) + ks_s^T alpha_s
//   fs2_s  = max(sf2_s - colsum(ks_s o (Binv_s^T ks_s)), 0)
//
// (the quadratic form of Binv_s^T is that of Binv_s, whether or not Binv_s
// is exactly symmetric), and offers the same product, G^T ks_s for any
// row-major (N x W) matrix G, to viqr_acq.cu for G = invKzk_s.
//
// How it is laid out for this card:
//
// * The ks tile is computed ONCE per (sample, candidate, training point)
//   into dynamic shared memory (N rows of MT + 4 values) and read from
//   there as the right operand of every product and of the fold. MT is the
//   largest of 64, 32, 16 whose tile fits the 227 KB a block may use:
//   float64 gives 64 up to N = 256, 32 up to N = 512, 16 up to N = 1024
//   (the plans below). Every block streams all of G from L2, so the
//   narrower tiles pay 2 and 4 times that traffic; nothing is recomputed
//   at any N.
// * The left operand streams through a ring of 2 or 3 chunks of 16 or 32
//   rows of G by 128 columns, copied with cp.async (16 bytes a thread;
//   narrower copies when a row of G is not 16-byte aligned), so the copy
//   of the next chunk overlaps the products on this one, with one barrier
//   per chunk. G is read along its rows, so no transposing store is
//   needed: the chunk lies in shared memory as G does in device memory,
//   and the MMA's A fragment (element (m, k) = G[k][m]) is gathered from it
//   without bank conflicts (row stride 132 = 4 mod 16).
// * float64 products run on the FP64 tensor cores: warp-level
//   mma.sync.m16n8k16.f64 (DMMA), operands held in registers across a
//   16-deep step; it rounds as an IEEE float64 FMA chain. A warp owns a
//   (16 MI) x (8 NI) piece of the 128 x MT product. The float32
//   instantiation keeps plain IEEE float32 FMAs (no TF32) on a micro-tile
//   with the same ownership of accumulator elements, so everything around
//   the product is one code for both types.
//
// One compile-time switch, for measurements only (chip_profile.py
// --kernel-phases): VBMC_PROFILE adds the cycle marks below.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace vbmc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 128;       // rows of one product tile (columns of G)
constexpr int kAS = kRT + 4;   // row stride of a staged chunk
constexpr int kNStep = 32;     // N is a multiple of this (the deepest chunk)
constexpr int kMaxD = 32;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr double kLog2Pi = 1.8378770664093453;

// Straight-line float64 exp, expm1 and sqrt for the VIQR epilogue. The library versions branch to slow paths for arguments that
// loop never has, and a branch ends the block within which the compiler
// interleaves a thread's independent chains (the columns of its fragment);
// with 8 or 16 warps on an SM, that interleaving is what hides the FP64
// latency. Range reduction x = n ln2 + r, |r| <= ln2 / 2, then the Taylor
// polynomial of (exp(r) - 1) / r to r^12 (truncation below 4e-18); arguments
// are clamped to [-700, 700] (exp(-700) is 1e-304), NaN passes through. The
// epilogue only ever passes arguments <= 0, so the upper clamp is never met
// and the lower one turns an exact 0 into 1e-304 times a term of order 1.
// The ks tile keeps the library's exp, whose fast path is shorter than
// nb_exp and is that loop's only branch.
struct ExpParts {
  double r, q;  // exp(x) = 2^n (1 + r q)
  int n;
};
__device__ __forceinline__ ExpParts exp_parts(double x) {
  constexpr double kMagic = 6755399441055744.0;  // 1.5 * 2^52
  double xc = x < -700.0 ? -700.0 : x;  // a NaN stays a NaN
  xc = xc > 700.0 ? 700.0 : xc;
  const double t = fma(xc, 1.4426950408889634, kMagic);
  const double nf = t - kMagic;
  ExpParts e;
  e.n = __double2loint(t);
  e.r = fma(nf, -1.90821492927058770002e-10,
            fma(nf, -6.93147180369123816490e-01, xc));
  constexpr double c[13] = {
      1.6059043836821613e-10,
      2.08767569878681e-09,
      2.505210838544172e-08,
      2.755731922398589e-07,
      2.7557319223985893e-06,
      2.48015873015873e-05,
      0.0001984126984126984,
      0.001388888888888889,
      0.008333333333333333,
      0.041666666666666664,
      0.16666666666666666,
      0.5,
      1.0};
  double q = c[0];
#pragma unroll
  for (int k = 1; k < 13; ++k) q = fma(q, e.r, c[k]);
  e.q = q;
  return e;
}
// 2^n for |n| <= 1010 (for a NaN argument n is arbitrary; the NaN in r
// carries through the products that follow).
__device__ __forceinline__ double exp2_int(int n) {
  return __hiloint2double((1023 + n) << 20, 0);
}
__device__ __forceinline__ double nb_exp(double x) {
  const ExpParts e = exp_parts(x);
  return fma(e.q, e.r, 1.0) * exp2_int(e.n);
}
__device__ __forceinline__ double nb_expm1(double x) {
  const ExpParts e = exp_parts(x);
  const double s = exp2_int(e.n);
  return fma(s, e.r * e.q, s - 1.0);
}
// sqrt(a) for a normal positive a (or NaN): the hardware's reciprocal
// square root estimate, two Newton steps, one correction of a * y.
__device__ __forceinline__ double nb_sqrt(double a) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(a));
  const double h = 0.5 * a;
  y = y * fma(-h * y, y, 1.5);
  y = y * fma(-h * y, y, 1.5);
  const double r = a * y;
  return fma(fma(-r, r, a), 0.5 * y, r);
}

// fexp, flog: the library's, for set-up code, the ks tile and pass 2. hexp,
// hexpm1, hsqrt: the VIQR epilogue's; float32 keeps the library's there too.
__device__ __forceinline__ double fexp(double x) { return exp(x); }
__device__ __forceinline__ float fexp(float x) { return expf(x); }
__device__ __forceinline__ double hexp(double x) { return nb_exp(x); }
__device__ __forceinline__ double hexpm1(double x) { return nb_expm1(x); }
__device__ __forceinline__ double hsqrt(double x) { return nb_sqrt(x); }
__device__ __forceinline__ float hexp(float x) { return expf(x); }
__device__ __forceinline__ float hexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ float hsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double flog(double x) { return log(x); }
__device__ __forceinline__ float flog(float x) { return logf(x); }

template <typename T> struct Lim;
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double big() { return DBL_MAX; }
};
template <> struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float big() { return FLT_MAX; }
};

// Cycle profile of pass 1, compiled in with -DVBMC_PROFILE only: thread 0
// of every block adds the clock64() ticks between its marks to g_prof[i];
// <name>_profile(out, reset) of each library reads the eight sums. The
// phases: 0 set-up (1/ell, alpha, candidates), 1 the ks tile, 2 the steps
// of Binv^T ks (waits, barriers, copies started, MMAs), 3 its fold, 4 the
// per-candidate reduction, 5 the steps of invKzk^T ks, 6 the VIQR
// epilogue, 7 the final merge.
#ifdef VBMC_PROFILE
__device__ unsigned long long g_prof[8];
struct Prof {
  long long t0;
  static __device__ __forceinline__ long long now() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
    return t;
  }
  __device__ Prof() : t0(now()) {}
  __device__ __forceinline__ void tick(int i) {
    if (threadIdx.x == 0) {
      const long long t = now();
      atomicAdd(&g_prof[i], (unsigned long long)(t - t0));
      t0 = t;
    }
  }
};
#else
struct Prof {
  __device__ __forceinline__ void tick(int) {}
};
#endif

// A plan of pass 1. How the 8 warps share the 128 x MT product: WR x WC
// warps, each owning (16 MI) rows by (8 NI) columns. How G is staged: a
// ring of ST chunks of KC rows. And how many blocks should share an SM
// (MINB: 2 caps the registers at 128 a thread).
template <int MI_, int NI_, int WR_, int WC_, int KC_, int ST_, int MINB_>
struct Tile {
  static constexpr int MI = MI_, NI = NI_, WR = WR_, WC = WC_;
  static constexpr int KC = KC_, ST = ST_, MINB = MINB_;
  static constexpr int MT = WC * NI * 8;  // candidates per block
  static constexpr int KS = MT + 4;       // ks row stride (= 4 mod 16)
  static_assert(WR * WC == kWarps && WR * MI * 16 == kRT, "tile shape");
  static_assert(kThreads % MT == 0 && MT <= kThreads, "tile width");
  static_assert(KC % 16 == 0 && kNStep % KC == 0 && ST >= 2, "staging");
};
// The plans, in the order the launcher tries them (the first whose shared
// memory fits is taken):
//   Pair64  64 candidates, two blocks an SM: while one block is in its
//           exp-heavy phases (the ks tile, the VIQR epilogue: FP64 pipes)
//           the other can be in its products (tensor cores). Fits up to
//           N = 128 in float64, where it beat one block an SM on the H100.
//   Wide64  64 candidates, one block an SM, 32-deep chunks (half the
//           barriers of 16-deep ones, which it beat). N <= 256.
//   Mid32   32 candidates: N <= 512 in float64.
//   Slim16  16 candidates: N <= 1024.
using Pair64 = Tile<2, 4, 4, 2, 16, 2, 2>;
using Wide64 = Tile<2, 4, 4, 2, 32, 2, 1>;
using Mid32 = Tile<2, 2, 4, 2, 32, 2, 1>;
using Slim16 = Tile<1, 2, 8, 1, 16, 3, 1>;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The block's dynamic shared memory, carved in units of T. Every section
// starts at a multiple of 4 values (16 bytes in float32).
template <typename T, typename TL> struct Smem {
  T* ks;    // [N][KS]        the ks tile
  T* ring;  // [ST][KC][kAS]   staged chunks of G
  T* cand;  // [MT][cs]       candidates scaled by 1/ell
  T* iell;  // [kMaxD]        1/ell_s
  T* al;    // [N]            alpha_s, zero on masked rows
  T* red;   // [2][WR][MT]    cross-warp reduction buffer
  T* col;   // [2][MT]        per-candidate values
  int cs;   // candidate row stride (odd: no bank conflicts)

  __host__ __device__ static size_t elems(int N, int D) {
    return (size_t)round4(N * TL::KS) + TL::ST * TL::KC * kAS +
           round4(TL::MT * (D | 1)) + kMaxD + round4(N) +
           2 * TL::WR * TL::MT + 2 * TL::MT;
  }
  __device__ Smem(unsigned char* raw, int N, int D) {
    T* p = reinterpret_cast<T*>(raw);
    cs = D | 1;
    ks = p;    p += round4(N * TL::KS);
    ring = p;  p += TL::ST * TL::KC * kAS;
    cand = p;  p += round4(TL::MT * cs);
    iell = p;  p += kMaxD;
    al = p;    p += round4(N);
    red = p;   p += 2 * TL::WR * TL::MT;
    col = p;
  }
};

// ---------------------------------------------------------------------
// Asynchronous copies (cp.async): 16 bytes, or one value where a row of G
// is not 16-byte aligned. `ok` false writes zeros and reads nothing.
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_one(double* dst, const double* src,
                                             bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_one(float* dst, const float* src,
                                             bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// True when rows of a row-major (., W) matrix at G can be copied 16 bytes
// at a time from any column that is a multiple of 16 / sizeof(T).
template <typename T> __device__ __forceinline__ bool rows_aligned(const T* G,
                                                                   int W) {
  return (reinterpret_cast<uintptr_t>(G) % 16 == 0) &&
         (((size_t)W * sizeof(T)) % 16 == 0);
}

// dst[r][c] <- G[k0 + r][col0 + c] for r < KC, c < kRT (zero past column
// W); rows k0 .. k0 + KC - 1 exist. Starts the copies of the calling
// thread; the caller commits.
template <int KC, typename T>
__device__ __forceinline__ void stage_chunk(T* __restrict__ dst,
                                            const T* __restrict__ G, int W,
                                            int k0, int col0, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // values per copy
    constexpr int kPpr = kRT / kPer;      // copies per row
    for (int p = threadIdx.x; p < KC * kPpr; p += kThreads) {
      const int r = p / kPpr, c = (p % kPpr) * kPer;
      const bool ok = col0 + c < W;
      cp_async_16(dst + r * kAS + c,
                  ok ? G + (size_t)(k0 + r) * W + col0 + c : G, ok);
    }
  } else {
    for (int e = threadIdx.x; e < KC * kRT; e += kThreads) {
      const int r = e / kRT, c = e % kRT;
      const bool ok = col0 + c < W;
      cp_async_one(dst + r * kAS + c,
                   ok ? G + (size_t)(k0 + r) * W + col0 + c : G, ok);
    }
  }
}

// ---------------------------------------------------------------------
// The warp's product on one staged chunk:
//   acc[mi][ni][v0 + 2 v1] += sum_k As[k][16 mi + g + 8 v1] *
//                                   Bs[k][8 ni + 2 t + v0],   k < KC,
// with g = lane / 4, t = lane % 4: the accumulator ownership of
// mma.m16n8k*. As and Bs point at the warp's first row and column.
// ---------------------------------------------------------------------

// float32 (and any type without a tensor-core form): IEEE FMAs on the
// (2 MI) x (2 NI) micro-tile of the thread.
template <typename T, typename TL> struct WarpProduct {
  static __device__ __forceinline__ void run(T (&acc)[TL::MI][TL::NI][4],
                                             const T* __restrict__ As,
                                             const T* __restrict__ Bs, int g,
                                             int t) {
#pragma unroll 4
    for (int k = 0; k < TL::KC; ++k) {
      T a[TL::MI][2], b[TL::NI][2];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int v1 = 0; v1 < 2; ++v1)
          a[mi][v1] = As[k * kAS + 16 * mi + g + 8 * v1];
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0)
          b[ni][v0] = Bs[k * TL::KS + 8 * ni + 2 * t + v0];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[mi][ni][v] += a[mi][v >> 1] * b[ni][v & 1];
    }
  }
};

// One 16 x 8 x 16 float64 product on the tensor cores. a[2 j + v0] is
// A(g + 8 v0, t + 4 j), b[j] is B(t + 4 j, g), c[v0 + 2 v1] is
// C(g + 8 v1, 2 t + v0): the PTX fragment layout of mma.m16n8k16.f64
// (DMMA.16x8x16 in the SASS; sm_90 only).
__device__ __forceinline__ void dmma_16x8x16(double (&c)[4],
                                             const double (&a)[8],
                                             const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// float64: a chunk is KC / 16 m16n8k16 steps. The fragments of a step are
// gathered from shared memory once and reused across its MI x NI products.
// (Gathering one 8-deep m16n8k8 step ahead of the products, with two
// register sets, was tried on the H100: no faster in the one-block plans,
// slower in the 128-register plan, where it spills.)
template <typename TL> struct WarpProduct<double, TL> {
  static __device__ __forceinline__ void run(
      double (&acc)[TL::MI][TL::NI][4], const double* __restrict__ As,
      const double* __restrict__ Bs, int g, int t) {
#pragma unroll
    for (int k0 = 0; k0 < TL::KC; k0 += 16) {
      double a[TL::MI][8], b[TL::NI][4];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v0 = 0; v0 < 2; ++v0)
            a[mi][2 * j + v0] =
                As[(k0 + t + 4 * j) * kAS + 16 * mi + g + 8 * v0];
#pragma unroll
      for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[ni][j] = Bs[(k0 + t + 4 * j) * TL::KS + 8 * ni + g];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni)
          dmma_16x8x16(acc[mi][ni], a[mi], b[ni]);
    }
  }
};

// Where the calling thread sits in the block's product tile.
template <typename TL> struct Lane {
  int g, t;    // lane / 4, lane % 4
  int wr;      // the warp's row index (0 .. WR-1)
  int row0;    // first row of the warp within a 128-row tile
  int col0;    // first column of the warp within the MT candidates
  __device__ Lane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    g = lane / 4;
    t = lane % 4;
    wr = warp / TL::WC;
    row0 = wr * TL::MI * 16;
    col0 = (warp % TL::WC) * TL::NI * 8;
  }
  // Row (within the tile) and column (within MT) of acc[mi][ni][v].
  __device__ __forceinline__ int row(int mi, int v) const {
    return row0 + 16 * mi + g + 8 * (v >> 1);
  }
  __device__ __forceinline__ int col(int ni, int v) const {
    return col0 + 8 * ni + 2 * t + (v & 1);
  }
};

// Starts the copies of the first ST - 1 chunks of G^T ks (the block
// may go on with other work before product_tiles). Opens with a barrier,
// so that no thread still reads the ring.
template <typename T, typename TL>
__device__ __forceinline__ void product_prefetch(const Smem<T, TL>& sm,
                                                 const T* __restrict__ G,
                                                 int W, int N, bool vec) {
  __syncthreads();
  const int nk = N / TL::KC;
  const int total = nk * ((W + kRT - 1) / kRT);
#pragma unroll
  for (int s = 0; s < TL::ST - 1; ++s) {
    if (s < total)
      stage_chunk<TL::KC>(sm.ring + s * TL::KC * kAS, G, W, (s % nk) * TL::KC,
                          (s / nk) * kRT, vec);
    cp_async_commit();
  }
}

// For each 128-column tile r0 of G (N x W, row-major): acc = G[:, r0 ..]^T
// ks (128 x MT, this thread's elements), then epi(r0, acc). Rows of the
// product at or past W are not computed (their acc stays zero). The steps
// are charged to profile phase `phase`, the epilogues to `phase` + 1. Needs
// product_prefetch(G) first and the ks tile complete in every thread's
// program order (the first barrier inside publishes it).
template <typename T, typename TL, typename Epi>
__device__ __forceinline__ void product_tiles(const Smem<T, TL>& sm,
                                              const Lane<TL>& ln,
                                              const T* __restrict__ G, int W,
                                              int N, bool vec, Prof& prof,
                                              int phase, Epi&& epi) {
  const int nk = N / TL::KC;
  const int total = nk * ((W + kRT - 1) / kRT);
  T acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = T(0);

  int tile = 0, kt = 0;
  for (int step = 0; step < total; ++step) {
    cp_async_wait<TL::ST - 2>();  // this thread's part of chunk `step`
    __syncthreads();               // everyone's; and chunk step-1 is read
    const int nxt = step + TL::ST - 1;
    if (nxt < total)
      stage_chunk<TL::KC>(sm.ring + (nxt % TL::ST) * TL::KC * kAS, G, W,
                          (nxt % nk) * TL::KC, (nxt / nk) * kRT, vec);
    cp_async_commit();

    const int r0 = tile * kRT;
    if (r0 + ln.row0 < W)  // warp-uniform
      WarpProduct<T, TL>::run(acc,
                              sm.ring + (step % TL::ST) * TL::KC * kAS + ln.row0,
                              sm.ks + (size_t)kt * TL::KC * TL::KS + ln.col0,
                              ln.g, ln.t);
    if (++kt == nk) {
      prof.tick(phase);
      epi(r0, acc);
      prof.tick(phase + 1);
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mi][ni][v] = T(0);
      kt = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
}

// Sums v over the 8 lanes that share lane % 4 (the rows of a fragment).
template <typename T> __device__ __forceinline__ T sum_over_g(T v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Predictive mean and variance of sample s at the block's candidates
// m0 .. m0 + MT - 1. Leaves 1/ell_s, the scaled candidates and the ks tile
// in shared memory. Thread t < MT returns the values of candidate m0 + t in
// fmu, fs2 (garbage past M). N is a multiple of kNStep.
template <typename T, typename TL>
__device__ void predict_tile(const Smem<T, TL>& sm, const Lane<TL>& ln,
                             const T* __restrict__ Xs,
                             const T* __restrict__ X,
                             const T* __restrict__ nmask,
                             const T* __restrict__ hyp_s,
                             const T* __restrict__ alpha_s,
                             const T* __restrict__ Binv_s, int m0, int M,
                             int N, int D, int meanfun, int mean_off,
                             Prof& prof, T& fmu, T& fs2) {
  constexpr int MT = TL::MT;
  const int tid = threadIdx.x;
  const bool vec = rows_aligned(Binv_s, N);
  const T sf2 = fexp(T(2) * hyp_s[D]);

  if (tid < D) sm.iell[tid] = fexp(-hyp_s[tid]);
  for (int i = tid; i < N; i += kThreads)
    sm.al[i] = nmask[i] != T(0) ? alpha_s[i] : T(0);
  product_prefetch(sm, Binv_s, N, N, vec);  // barrier: iell is visible
  for (int e = tid; e < MT * D; e += kThreads) {
    const int mm = e / D, d = e % D;
    const int m = m0 + mm;
    sm.cand[mm * sm.cs + d] =
        (m < M ? Xs[(size_t)m * D + d] : T(0)) * sm.iell[d];
  }
  __syncthreads();

  prof.tick(0);

  // The ks tile, once: thread tid owns column tid % MT of every
  // (kThreads / MT)-th row, and works on kKB rows at a time so that their
  // loads, distance sums and exps are independent chains.
  {
    constexpr int kRpp = kThreads / MT;  // rows per pass of the block
    constexpr int kKB = 4;
    const T* __restrict__ cd = sm.cand + (tid % MT) * sm.cs;
    const T* __restrict__ ie = sm.iell;
    T* __restrict__ ks = sm.ks + tid % MT;
    for (int k0 = tid / MT; k0 < N; k0 += kRpp * kKB) {
      bool on[kKB], any = false;
      const T* __restrict__ xk[kKB];
      T d2[kKB];
#pragma unroll
      for (int j = 0; j < kKB; ++j) {
        const int k = k0 + j * kRpp;
        on[j] = k < N && nmask[k] != T(0);
        any = any || on[j];
        xk[j] = X + (size_t)(on[j] ? k : 0) * D;
        d2[j] = T(0);
      }
      if (any)
        for (int d = 0; d < D; ++d) {
          const T e = ie[d], c = cd[d];
#pragma unroll
          for (int j = 0; j < kKB; ++j) {
            const T diff = xk[j][d] * e - c;
            d2[j] += diff * diff;
          }
        }
#pragma unroll
      for (int j = 0; j < kKB; ++j) {
        const int k = k0 + j * kRpp;
        const T v = sf2 * fexp(T(-0.5) * d2[j]);  // for masked rows too:
        // a select below, not a branch, so the kKB chains interleave
        if (k < N) ks[(size_t)k * TL::KS] = on[j] ? v : T(0);
      }
    }
  }
  prof.tick(1);

  // P = Binv_s^T ks, 128 rows at a time, folded into the per-candidate
  // sums as each tile completes.
  T qf[TL::NI][2], fm[TL::NI][2];
#pragma unroll
  for (int ni = 0; ni < TL::NI; ++ni)
    qf[ni][0] = qf[ni][1] = fm[ni][0] = fm[ni][1] = T(0);
  product_tiles(sm, ln, Binv_s, N, N, vec, prof, 2,
                [&](int r0, T (&acc)[TL::MI][TL::NI][4]) {
#pragma unroll
                  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
                    for (int v1 = 0; v1 < 2; ++v1) {
                      const int i = r0 + ln.row(mi, 2 * v1);
                      if (i >= N) continue;
                      const T a_i = sm.al[i];
#pragma unroll
                      for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
                        for (int v0 = 0; v0 < 2; ++v0) {
                          const T kv =
                              sm.ks[(size_t)i * TL::KS + ln.col(ni, v0)];
                          qf[ni][v0] += kv * acc[mi][ni][v0 + 2 * v1];
                          fm[ni][v0] += kv * a_i;
                        }
                    }
                });

  // Combine: the 8 row lanes of each warp, then the WR warp rows.
#pragma unroll
  for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
    for (int v0 = 0; v0 < 2; ++v0) {
      const T q = sum_over_g(qf[ni][v0]);
      const T f = sum_over_g(fm[ni][v0]);
      if (ln.g == 0) {
        sm.red[ln.wr * MT + ln.col(ni, v0)] = q;
        sm.red[(TL::WR + ln.wr) * MT + ln.col(ni, v0)] = f;
      }
    }
  __syncthreads();
  T q = T(0), f = T(0);
  if (tid < MT)
    for (int w = 0; w < TL::WR; ++w) {
      q += sm.red[w * MT + tid];
      f += sm.red[(TL::WR + w) * MT + tid];
    }

  const int m = m0 + tid;
  T mean = T(0);
  if (tid < MT && m < M) {
    if (meanfun == 1) {
      mean = hyp_s[mean_off];
    } else if (meanfun == 4) {
      T z2 = T(0);
      for (int d = 0; d < D; ++d) {
        const T z = (Xs[(size_t)m * D + d] - hyp_s[mean_off + 1 + d]) *
                    fexp(-hyp_s[mean_off + 1 + D + d]);
        z2 += z * z;
      }
      mean = hyp_s[mean_off] - T(0.5) * z2;
    }
  }
  const T v = sf2 - q;
  fmu = mean + f;
  fs2 = v < T(0) ? T(0) : v;
  prof.tick(4);
}

// Masked mean and total variance (mean variance + between-sample variance,
// two-pass) of candidate m over the S samples of an (S, M) workspace.
template <typename T>
__device__ void sample_summary(const T* __restrict__ fmu,
                               const T* __restrict__ fs2,
                               const T* __restrict__ smask, int S, int M,
                               int m, T& ns, T& fbar, T& vtot) {
  T sf = T(0), sv = T(0);
  ns = T(0);
  for (int s = 0; s < S; ++s) {
    if (smask[s] == T(0)) continue;
    ns += T(1);
    sf += fmu[(size_t)s * M + m];
    sv += fs2[(size_t)s * M + m];
  }
  const T nsc = ns > T(1) ? ns : T(1);
  fbar = sf / nsc;
  T ss = T(0);
  for (int s = 0; s < S; ++s) {
    if (smask[s] == T(0)) continue;
    const T dv = fmu[(size_t)s * M + m] - fbar;
    ss += dv * dv;
  }
  const T nsm1 = ns - T(1) > T(1) ? ns - T(1) : T(1);
  vtot = sv / nsc + (ns > T(1) ? ss / nsm1 : T(0));
}

// Launch plumbing shared by the two sources: the dynamic shared memory of a
// tile shape, or 0 when it does not fit a block.
template <typename T, typename TL> size_t smem_bytes(int N, int D) {
  // An SM has kMaxSmem + 1 KB to share, and every block costs it 1 KB more
  // than it asks for.
  constexpr size_t kRoom = (kMaxSmem + 1024) / TL::MINB - 1024;
  const size_t b = Smem<T, TL>::elems(N, D) * sizeof(T);
  return b <= kRoom ? b : 0;
}

// Calls f(plan, its shared-memory bytes) for the first plan, in the order
// above, whose shared memory fits N and D, and returns what f returns; -1
// when N is too large for any plan.
template <typename T, typename F> int with_plan(int N, int D, F&& f) {
  if (size_t b = smem_bytes<T, Pair64>(N, D)) return f(Pair64{}, b);
  if (size_t b = smem_bytes<T, Wide64>(N, D)) return f(Wide64{}, b);
  if (size_t b = smem_bytes<T, Mid32>(N, D)) return f(Mid32{}, b);
  if (size_t b = smem_bytes<T, Slim16>(N, D)) return f(Slim16{}, b);
  return -1;
}

// Candidates per block of the plan taken at N and D (0: none fits). Pass 1
// evaluates whole tiles, so this is what the exp count of a launch rounds M
// up to.
inline int tile_width(int N, int D, bool f64) {
  auto width = [](auto tl, size_t) { return decltype(tl)::MT; };
  const int w =
      f64 ? with_plan<double>(N, D, width) : with_plan<float>(N, D, width);
  return w < 0 ? 0 : w;
}

#ifdef VBMC_PROFILE
// Copies the eight phase sums to out (host memory) and, with `reset`,
// zeroes them. Synchronises the device.
inline int profile_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

}  // namespace vbmc
