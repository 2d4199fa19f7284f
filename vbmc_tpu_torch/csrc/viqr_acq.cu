// VIQR / IMIQR acquisition sweep for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel vbmc_tpu/pallas_kernels.py:fused_viqr_acq
// (_viqr_kernel + _sample_predict). For M candidates C, S GP hyperparameter
// samples and an importance-sampling set of Na points Xa (log weights lnw,
// predictive variances fs2a, invKzk_s = Binv_s k(X, Xa)) it computes what
// vbmc_tpu/active_is.py:evaluate_is_acquisition computes (before the
// hard-bound rejection, which stays in PyTorch):
//
//   fmu_s, fs2_s   the predictive mean and variance at C (gp_tile.cuh)
//   cov_s(m, a)    = k_s(C_m, Xa_a) - sum_n ks_s(n, m) invKzk_s(n, a)
//   s2_s(m, a)     = max(fs2a_s(a) - cov^2 / (fs2_s(m) + sn2c(m)), 1e-12)
//   lnI_s(m)       = logsumexp_a [lnw_s(a) + log(2 sinh(u sqrt(s2_s)))]
//   acq(m)         = logsumexp_s lnI_s(m) - log(ns)   [masked samples at
//                    the lowest finite value] (+ tol/vtot - 1 with
//                    `regularize` and vtot < tol_var), u = norminv(0.75).
//
// Where the Pallas kernel and evaluate_is_acquisition differ, this follows
// evaluate_is_acquisition (ROADMAP Queue 3 j-n): no floor on the
// denominator, a two-pass between-sample variance, ns = max(sum mask, 1),
// -inf weights kept as -inf (padded Na slots and masked samples cannot
// turn the result into NaN), and no floor inside the final log.
//
// What bounds it on this card. Operations: two products against ks_s, the
// predictive quadratic form ks^T Binv ks (2 S M N^2 flops) and the cross
// term invKzk^T ks (2 S M N Na): 7.2 GFLOP at N=128, S=8, M=8192, Na=298;
// 37.2 at N=256, S=16; 1774 at N=1024, S=80, against 67 TFLOP/s of the
// H100's FP64 tensor cores: 0.107, 0.555 and 26.5 ms; the bytes (Binv and
// invKzk) take at most 0.3 ms at 3.35 TB/s. Beside the products stand, on
// the FP64 FMA pipes at half the tensor rate, S M N evaluations of ks and
// S M Na of k(C, Xa), each a float64 exp (a software sequence of some 20
// operations), and S M Na epilogues with a sqrt, an expm1 and one more
// exp (over 100 FP64 operations per element in all): at the main
// path's shape (N=128) these are as much work for their pipes as the
// products are for the tensor cores. The Pallas kernel kept the whole
// (N, Mt) ks tile, Binv_s and the (N, Na) invKzk_s block in VMEM and
// carried five accumulators across a sequential sample grid axis; a block
// here has 227 KB and blocks run in no order.
//
// What the design does about it (gp_tile.cuh has the machinery). Pass 1
// runs on a grid (ceil(M / MT), S): a block owns MT candidates of one
// sample (the plans of gp_tile.cuh: MT = 64, 32 or 16, the widest whose ks
// tile fits shared memory at this N, and two blocks an SM where two fit).
// It forms the ks tile once, computes fmu and fs2 from Binv_s^T ks, then
// walks Na in tiles of 128: invKzk_s streams through the same cp.async
// ring, read along its rows as it lies in device
// memory (no transposing store), the product invKzk_s^T ks runs on the
// FP64 tensor cores (mma.sync.m16n8k16.f64; float32: IEEE FMAs, no TF32)
// against the SAME ks tile, and each finished tile is folded, in the
// registers that hold it, through k(C, Xa), the variance reduction and
// log(2 sinh x) into an online log-sum-exp per candidate, with the
// candidate's own running maximum, as evaluate_is_acquisition's
// logsumexp(lnw + x + log1p(-exp(-2 x))) does: every exp takes an argument
// <= 0, so it holds for any predictive variance and any weights, in float32
// too. An element costs the exp of k(C, Xa), a sqrt, an expm1 and one exp
// (the update's two cases share it), with selects and no branch, and a
// thread's columns are independent chains.
// No (S, M, Na) temporary exists. The per-(sample, candidate) fmu,
// fs2 and lnI go to (S, M) workspaces; pass 2, one thread per candidate,
// reduces over samples. Ragged M and Na edges, -inf weights and masked
// training rows are handled in the kernel; N must be a multiple of 32.

#include "gp_tile.cuh"

namespace {

using namespace vbmc;

constexpr double kUIqr = 0.6744897501960817;  // norminv(0.75)

// exp(mx - m), or 0 for an empty running sum (mx = -inf).
template <typename T> __device__ __forceinline__ T lse_scale(T mx, T m) {
  return mx == -INFINITY ? T(0) : fexp(mx - m);
}

// Pass 1: per-sample fmu, fs2 and log-integral of an MT-candidate tile.
template <typename T, typename TL>
__global__ void __launch_bounds__(kThreads, TL::MINB)
viqr_sample_kernel(const T* __restrict__ Xs, const T* __restrict__ X,
                   const T* __restrict__ nmask, const T* __restrict__ hyp,
                   const T* __restrict__ smask, const T* __restrict__ alpha,
                   const T* __restrict__ Binv, const T* __restrict__ Xa,
                   const T* __restrict__ lnw, const T* __restrict__ fs2a,
                   const T* __restrict__ invKzk, const T* __restrict__ sn2c,
                   T* __restrict__ fmu_out, T* __restrict__ fs2_out,
                   T* __restrict__ lnint_out, int M, int N, int D, int Na,
                   int nhyp, int meanfun, int mean_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int MT = TL::MT;
  const int s = blockIdx.y;
  if (smask[s] == T(0)) return;  // masked sample: pass 2 skips it
  const int m0 = blockIdx.x * MT;
  const int tid = threadIdx.x;
  const Smem<T, TL> sm(smem_raw, N, D);
  const Lane<TL> ln;
  Prof prof;

  const T* hyp_s = hyp + (size_t)s * nhyp;
  const T* invK_s = invKzk + (size_t)s * N * Na;
  const T* lnw_s = lnw + (size_t)s * Na;
  const T* fs2a_s = fs2a + (size_t)s * Na;
  const T sf2 = fexp(T(2) * hyp_s[D]);
  const bool vec = rows_aligned(invK_s, Na);

  T fmu, fs2;
  predict_tile(sm, ln, Xs, X, nmask, hyp_s, alpha + (size_t)s * N,
               Binv + (size_t)s * N * N, m0, M, N, D, meanfun, mean_off, prof,
               fmu, fs2);
  T* rden = sm.col;  // 1 / (fs2 + sn2c) per candidate
  if (tid < MT) {
    const int m = m0 + tid;
    rden[tid] = m < M ? T(1) / (fs2 + sn2c[m]) : T(1);
    if (m < M) {
      fmu_out[(size_t)s * M + m] = fmu;
      fs2_out[(size_t)s * M + m] = fs2;
    }
  }
  product_prefetch(sm, invK_s, Na, N, vec);  // barrier: rden is visible

  // Per thread, for each of its 2 NI columns: an online log-sum-exp over the
  // rows a it has folded of lnw_a + log(2 sinh x_a), x_a = u sqrt(s2_a), as
  // sum = sum_a exp(lnw_a + x_a - mx) h_a with the column's own running
  // maximum mx of lnw_a + x_a and h_a = 1 - exp(-2 x_a) = -expm1(-2 x_a)
  // (2 sinh x = exp(x) h). Every exp has an argument <= 0, so no value of
  // the variances or the weights can overflow, and the largest term is
  // h_a <= 1 at the row that holds the maximum: what underflows is
  // negligible beside it. One exp serves both cases of the update, since
  // either the old sum or the new term keeps the factor 1; the cases are
  // selects, not branches, and a thread's columns are independent chains.
  T mx[TL::NI][2], sum[TL::NI][2];
#pragma unroll
  for (int ni = 0; ni < TL::NI; ++ni) {
    mx[ni][0] = mx[ni][1] = -INFINITY;
    sum[ni][0] = sum[ni][1] = T(0);
  }

  // Q = invKzk_s^T ks, 128 integration points at a time; acc holds
  // Q(a, m) for this thread's rows a and columns m.
  product_tiles(
      sm, ln, invK_s, Na, N, vec, prof, 5,
      [&](int a0, T (&acc)[TL::MI][TL::NI][4]) {
#pragma unroll
        for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
          for (int v1 = 0; v1 < 2; ++v1) {
            const int a = a0 + ln.row(mi, 2 * v1);
            if (a >= Na) continue;
            const T lw = lnw_s[a];
            if (lw == -INFINITY) continue;  // padded or zero-weight point
            const T f2a = fs2a_s[a];
            // |(Xa_a - C_m) / ell|^2 for the thread's 2 NI columns.
            T d2[TL::NI][2];
#pragma unroll
            for (int ni = 0; ni < TL::NI; ++ni) d2[ni][0] = d2[ni][1] = T(0);
            for (int d = 0; d < D; ++d) {
              const T xa = Xa[(size_t)a * D + d] * sm.iell[d];
#pragma unroll
              for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
                for (int v0 = 0; v0 < 2; ++v0) {
                  const T diff = xa - sm.cand[ln.col(ni, v0) * sm.cs + d];
                  d2[ni][v0] += diff * diff;
                }
            }
            // Columns past M hold zero candidates and rden = 1: finite
            // values that are never stored.
#pragma unroll
            for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
              for (int v0 = 0; v0 < 2; ++v0) {
                const T cov =
                    sf2 * hexp(T(-0.5) * d2[ni][v0]) - acc[mi][ni][v0 + 2 * v1];
                const T v = f2a - cov * cov * rden[ln.col(ni, v0)];
                const T s2p = v < T(1e-12) ? T(1e-12) : v;  // NaN passes
                const T x = T(kUIqr) * hsqrt(s2p);
                const T h = -hexpm1(T(-2) * x);
                const T t = lw + x;
                const T dm = t - mx[ni][v0];  // +inf for an empty sum
                const bool up = dm > T(0);
                const T e = hexp(up ? -dm : dm);
                sum[ni][v0] = fma(up ? sum[ni][v0] : h, e,
                                  up ? h : sum[ni][v0]);
                mx[ni][v0] = up ? t : mx[ni][v0];
              }
          }
      });

  // Combine the 8 row lanes of each warp, then the WR warp rows.
#pragma unroll
  for (int off = 4; off < 32; off *= 2)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        const T mx1 = mx[ni][v0];
        const T mx2 = __shfl_xor_sync(0xffffffffu, mx1, off);
        const T m = mx2 > mx1 ? mx2 : mx1;
        sum[ni][v0] = sum[ni][v0] * lse_scale(mx1, m) +
                      __shfl_xor_sync(0xffffffffu, sum[ni][v0], off) *
                          lse_scale(mx2, m);
        mx[ni][v0] = m;
      }
  if (ln.g == 0) {
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        sm.red[ln.wr * MT + ln.col(ni, v0)] = mx[ni][v0];
        sm.red[(TL::WR + ln.wr) * MT + ln.col(ni, v0)] = sum[ni][v0];
      }
  }
  __syncthreads();
  if (tid < MT && m0 + tid < M) {
    T cm = -INFINITY;
    for (int w = 0; w < TL::WR; ++w) {
      const T v = sm.red[w * MT + tid];
      cm = v > cm ? v : cm;
    }
    T tot = T(0);
    for (int w = 0; w < TL::WR; ++w)
      tot += sm.red[(TL::WR + w) * MT + tid] *
             lse_scale(sm.red[w * MT + tid], cm);
    lnint_out[(size_t)s * M + m0 + tid] =
        cm == -INFINITY ? T(-INFINITY) : cm + flog(tot);
  }
  prof.tick(7);
}

// Pass 2: one thread per candidate.
template <typename T>
__global__ void viqr_reduce_kernel(const T* __restrict__ fmu,
                                   const T* __restrict__ fs2,
                                   const T* __restrict__ lnint,
                                   const T* __restrict__ smask,
                                   T* __restrict__ out, int S, int M,
                                   T tol_var, int regularize) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  T ns, fbar, vtot;
  sample_summary(fmu, fs2, smask, S, M, m, ns, fbar, vtot);

  // Masked log-mean-exp over samples; masked samples enter at the lowest
  // finite value, as in the reference.
  const T lowest = -Lim<T>::big();
  T mx = -INFINITY;
  for (int s = 0; s < S; ++s) {
    const T v = smask[s] == T(0) ? lowest : lnint[(size_t)s * M + m];
    mx = v > mx ? v : mx;
  }
  const T shift = (mx == -INFINITY || mx == INFINITY) ? T(0) : mx;
  T tot = T(0);
  for (int s = 0; s < S; ++s) {
    const T v = smask[s] == T(0) ? lowest : lnint[(size_t)s * M + m];
    tot += fexp(v - shift);
  }
  T a = flog(tot) + shift - flog(ns > T(1) ? ns : T(1));
  if (regularize && vtot < tol_var) {
    const T ratio = tol_var / (vtot > Lim<T>::tiny() ? vtot : Lim<T>::tiny());
    a = a + ratio - T(1);
  }
  out[m] = a;
}

template <typename T, typename TL>
cudaError_t launch_sample(size_t smem, cudaStream_t st, const T* Xs,
                          const T* X, const T* nmask, const T* hyp,
                          const T* smask, const T* alpha, const T* Binv,
                          const T* Xa, const T* lnw, const T* fs2a,
                          const T* invKzk, const T* sn2c, T* fmu_ws,
                          T* fs2_ws, T* lnint_ws, int M, int N, int D, int S,
                          int Na, int nhyp, int meanfun, int mean_off) {
  auto kernel = viqr_sample_kernel<T, TL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + TL::MT - 1) / TL::MT, S);
  kernel<<<grid, kThreads, smem, st>>>(
      Xs, X, nmask, hyp, smask, alpha, Binv, Xa, lnw, fs2a, invKzk, sn2c,
      fmu_ws, fs2_ws, lnint_ws, M, N, D, Na, nhyp, meanfun, mean_off);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* Xs, const T* X, const T* nmask, const T* hyp,
           const T* smask, const T* alpha, const T* Binv, const T* Xa,
           const T* lnw, const T* fs2a, const T* invKzk, const T* sn2c,
           T* fmu_ws, T* fs2_ws, T* lnint_ws, T* out, int M, int N, int D,
           int S, int Na, int nhyp, int meanfun, int mean_off,
           double tol_var, int regularize, void* stream) {
  if (D < 1 || D > kMaxD || M < 1 || N < kNStep || N % kNStep != 0 || S < 1 ||
      Na < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The first plan (gp_tile.cuh) whose shared memory fits.
  const int err = with_plan<T>(N, D, [&](auto tl, size_t bytes) {
    return (int)launch_sample<T, decltype(tl)>(
        bytes, st, Xs, X, nmask, hyp, smask, alpha, Binv, Xa, lnw, fs2a,
        invKzk, sn2c, fmu_ws, fs2_ws, lnint_ws, M, N, D, S, Na, nhyp, meanfun,
        mean_off);
  });
  if (err < 0) return (int)cudaErrorInvalidValue;  // N too large for any plan
  if (err != 0) return err;
  viqr_reduce_kernel<T><<<(M + 255) / 256, 256, 0, st>>>(
      fmu_ws, fs2_ws, lnint_ws, smask, out, S, M, T(tol_var), regularize);
  return (int)cudaGetLastError();
}

}  // namespace

#define VBMC_VIQR_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* Xs, const void* X, const void* nmask,       \
                      const void* hyp, const void* smask, const void* alpha,  \
                      const void* Binv, const void* Xa, const void* lnw,      \
                      const void* fs2a, const void* invKzk, const void* sn2c, \
                      void* fmu_ws, void* fs2_ws, void* lnint_ws, void* out,  \
                      int M, int N, int D, int S, int Na, int nhyp,           \
                      int meanfun, int mean_off, double tol_var,              \
                      int regularize, void* stream) {                         \
    return launch<T>(                                                         \
        (const T*)Xs, (const T*)X, (const T*)nmask, (const T*)hyp,            \
        (const T*)smask, (const T*)alpha, (const T*)Binv, (const T*)Xa,       \
        (const T*)lnw, (const T*)fs2a, (const T*)invKzk, (const T*)sn2c,      \
        (T*)fmu_ws, (T*)fs2_ws, (T*)lnint_ws, (T*)out, M, N, D, S, Na, nhyp,  \
        meanfun, mean_off, tol_var, regularize, stream);                      \
  }

VBMC_VIQR_ENTRY(viqr_acq_f64, double)
VBMC_VIQR_ENTRY(viqr_acq_f32, float)

extern "C" int viqr_acq_tile(int N, int D, int f64) {
  return vbmc::tile_width(N, D, f64 != 0);
}

#ifdef VBMC_PROFILE
extern "C" int viqr_acq_profile(unsigned long long* out, int reset) {
  return vbmc::profile_read(out, reset);
}
#endif
