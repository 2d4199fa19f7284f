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
// What bounds it on this card. The work is two products against ks_s: the
// predictive quadratic form ks^T Binv ks (S M N^2 multiply-adds) and the
// cross term ks^T invKzk (S M N Na), plus S M Na evaluations of k(C, Xa)
// and of exp, sqrt, exp, log1p in the epilogue (39 M of each at N=128,
// S=16, M=8192, Na=298; 195 M at S=80). It runs in float64 on the main
// path, on the FP64 FMA pipes; float64 exp and log1p are software
// sequences of some 20 FMAs each, a few percent of the products' work at
// N >= 128. The Pallas kernel kept the whole (N, Mt) ks tile, Binv_s and
// the (N, Na) invKzk_s block in VMEM and carried five accumulators across
// a sequential sample grid axis; at N=1024 a 64-candidate float64 ks tile
// alone is 512 KB, and Hopper blocks run in no order with 227 KB of shared
// memory.
//
// What the design does about it. Pass 1 runs on a grid (ceil(M/64), S):
// each block owns 64 candidates of one sample. It computes fmu and fs2
// with the machinery of gp_tile.cuh, then walks Na in tiles of 64: for
// each tile it forms invKzk_s^T ks_s (64 x 64) in registers, streaming
// invKzk_s through shared memory in 16 x 64 tiles and recomputing the ks
// slabs from X, and folds the epilogue straight into an online
// log-sum-exp per candidate. No (S, M, Na) temporary exists. The
// per-(sample, candidate) fmu, fs2 and lnI go to (S, M) workspaces; pass
// 2, one thread per candidate, reduces over samples. Ragged M, N and Na
// edges are masked in the kernel. Making it fast (wgmma, TMA) is later
// work.

#include "gp_tile.cuh"

namespace {

using namespace vbmc;

constexpr double kUIqr = 0.6744897501960817;  // norminv(0.75)

// Online log-sum-exp: fold term t into (mx, sum). -inf terms add nothing;
// NaN propagates.
template <typename T>
__device__ __forceinline__ void lse_add(T& mx, T& sum, T t) {
  if (t == -INFINITY) return;
  if (t > mx) {
    sum = sum * fexp(mx - t) + T(1);
    mx = t;
  } else {
    sum += fexp(t - mx);
  }
}

// Pass 1: per-sample fmu, fs2 and log-integral of a 64-candidate tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
viqr_sample_kernel(const T* __restrict__ Xs, const T* __restrict__ X,
                   const T* __restrict__ nmask, const T* __restrict__ hyp,
                   const T* __restrict__ smask, const T* __restrict__ alpha,
                   const T* __restrict__ Binv, const T* __restrict__ Xa,
                   const T* __restrict__ lnw, const T* __restrict__ fs2a,
                   const T* __restrict__ invKzk, const T* __restrict__ sn2c,
                   T* __restrict__ fmu_out, T* __restrict__ fs2_out,
                   T* __restrict__ lnint_out, int M, int N, int D, int Na,
                   int nhyp, int meanfun, int mean_off) {
  const int s = blockIdx.y;
  if (smask[s] == T(0)) return;  // masked sample: pass 2 skips it
  const int m0 = blockIdx.x * kMT;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  __shared__ TileSmem<T> sm;
  __shared__ T denom[kMT];
  __shared__ T colmax[kMT];

  const T* hyp_s = hyp + (size_t)s * nhyp;
  const T* invK_s = invKzk + (size_t)s * N * Na;
  const T* lnw_s = lnw + (size_t)s * Na;
  const T* fs2a_s = fs2a + (size_t)s * Na;
  const T sf2 = fexp(T(2) * hyp_s[D]);

  load_candidates(sm, hyp_s, Xs, m0, M, D);
  T fmu, fs2;
  predict_tile(sm, Xs, X, nmask, hyp_s, alpha + (size_t)s * N,
               Binv + (size_t)s * N * N, m0, M, N, D, meanfun, mean_off, fmu,
               fs2);
  if (tid < kMT) {
    const int m = m0 + tid;
    denom[tid] = m < M ? fs2 + sn2c[m] : T(1);
    if (m < M) {
      fmu_out[(size_t)s * M + m] = fmu;
      fs2_out[(size_t)s * M + m] = fs2;
    }
  }
  __syncthreads();

  T mx[4], sum[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mx[c] = -INFINITY;
    sum[c] = T(0);
  }

  for (int a0 = 0; a0 < Na; a0 += kTI) {
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

    for (int n0 = 0; n0 < N; n0 += kTJ) {
      // rows[a][k] = invKzk_s[n0 + k][a0 + a]: coalesced along a.
      for (int e = tid; e < kTI * kTJ; e += kThreads) {
        const int r = e % kTI, k = e / kTI;
        const int a = a0 + r, n = n0 + k;
        sm.rows[r][k] = (a < Na && n < N) ? invK_s[(size_t)n * Na + a] : T(0);
      }
      load_ks_slab(sm, X, nmask, n0, N, D, sf2);
      __syncthreads();
      fma_slab(sm, acc, tx, ty);
      __syncthreads();
    }

    // Epilogue: acc[r][c] = (ks^T invKzk)(m, a) for a = a0 + ty + 16 r,
    // m = m0 + tx + 16 c.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = a0 + ty + 16 * r;
      if (a >= Na) continue;
      const T lw = lnw_s[a];
      if (lw == -INFINITY) continue;  // padded or zero-weight point
      const T f2a = fs2a_s[a];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        if (m0 + col >= M) continue;
        T d2 = T(0);
        for (int d = 0; d < D; ++d) {
          const T diff =
              Xa[(size_t)a * D + d] * sm.inv_ell[d] - sm.cand[col * kCS + d];
          d2 += diff * diff;
        }
        const T cov = sf2 * fexp(T(-0.5) * d2) - acc[r][c];
        const T v = f2a - cov * cov / denom[col];
        const T s2p = v < T(1e-12) ? T(1e-12) : v;  // NaN passes through
        const T x = T(kUIqr) * sqrt(s2p);  // CUDA overloads sqrt for float
        lse_add(mx[c], sum[c], lw + x + flog1p(-fexp(T(-2) * x)));
      }
    }
  }

  // Combine the 16 thread rows of each candidate column: the column max
  // first, then the sums rescaled to it.
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) sm.ksJ[ty][tx + 16 * c] = mx[c];
  __syncthreads();
  if (tid < kMT) {
    T cm = -INFINITY;
    for (int t = 0; t < 16; ++t) cm = sm.ksJ[t][tid] > cm ? sm.ksJ[t][tid] : cm;
    colmax[tid] = cm;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const T cm = colmax[tx + 16 * c];
    sm.ksJ[ty][tx + 16 * c] =
        mx[c] == -INFINITY ? T(0) : sum[c] * fexp(mx[c] - cm);
  }
  __syncthreads();
  if (tid < kMT && m0 + tid < M) {
    T tot = T(0);
    for (int t = 0; t < 16; ++t) tot += sm.ksJ[t][tid];
    const T cm = colmax[tid];
    lnint_out[(size_t)s * M + m0 + tid] =
        cm == -INFINITY ? T(-INFINITY) : cm + flog(tot);
  }
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

template <typename T>
int launch(const T* Xs, const T* X, const T* nmask, const T* hyp,
           const T* smask, const T* alpha, const T* Binv, const T* Xa,
           const T* lnw, const T* fs2a, const T* invKzk, const T* sn2c,
           T* fmu_ws, T* fs2_ws, T* lnint_ws, T* out, int M, int N, int D,
           int S, int Na, int nhyp, int meanfun, int mean_off,
           double tol_var, int regularize, void* stream) {
  if (D < 1 || D > kMaxD || M < 1 || N < 1 || S < 1 || Na < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid1((M + kMT - 1) / kMT, S);
  viqr_sample_kernel<T><<<grid1, kThreads, 0, st>>>(
      Xs, X, nmask, hyp, smask, alpha, Binv, Xa, lnw, fs2a, invKzk, sn2c,
      fmu_ws, fs2_ws, lnint_ws, M, N, D, Na, nhyp, meanfun, mean_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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
