// Prospective-acquisition sweep for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel vbmc_tpu/pallas_kernels.py:fused_prospective_acq
// (_acq_kernel + _sample_predict). For M candidates C, S GP hyperparameter
// samples and a K-component variational mixture it computes what
// vbmc_tpu/acquisitions.py:evaluate_acquisition computes for "prospective"
// (before the hard-bound rejection, which stays in PyTorch):
//
//   ks_s   = sf2_s * exp(-1/2 |(X - C) / ell_s|^2) * nmask        (N x M)
//   fmu_s  = m_s(C) + ks_s^T alpha_s
//   fs2_s  = max(sf2_s - colsum(ks_s o (Binv_s ks_s)), 0)
//   fbar, vtot = masked two-pass mean / (mean var + between-sample var)
//   logq   = max(log sum_k w_k N(C; mu_k, sigma_k^2 diag(lam^2)), -708)
//   acq    = max(-vtot exp(fbar - ymax + logq) [* exp(1 - tol/vtot)], -max)
//
// where the bracket applies only with `regularize` and vtot < tol_var.
//
// What bounds it on this card. The work is the quadratic form
// ks^T Binv ks: S * M * N^2 multiply-adds (17.7 GFLOP at N=256, S=16,
// M=8192; 1.4 TFLOP at N=1024, S=80, where Binv alone is 671 MB in
// float64). It runs in float64 on the main path, where Hopper has no fast
// tensor-core route from plain CUDA C++, so the FP64 FMA pipes bound it.
// The Pallas kernel kept a whole (N, Mt) ks tile and all of Binv_s in VMEM
// and carried sums across a sequential sample grid axis; neither fits or
// holds here (227 KB of shared memory, blocks in no order).
//
// What the design does about it. Pass 1 runs on a grid (ceil(M/64), S):
// each block owns 64 candidates of one sample and computes their
// predictive mean and variance with the shared tile machinery of
// gp_tile.cuh (Binv_s streamed through shared memory in 64 x 16 tiles,
// Binv_s ks formed 64 rows at a time in registers and folded straight into
// the per-candidate sums, ks slabs recomputed from X), so no N x M product
// is ever stored. Results go to an (S, M) workspace. Pass 2, one thread
// per candidate, reduces over samples (two-pass, masked), evaluates the
// mixture density with an online log-sum-exp and the acquisition. Ragged
// M and N edges are masked in the kernel. Making it fast (wgmma, TMA,
// symmetric Binv) is later work.

#include "gp_tile.cuh"

namespace {

using namespace vbmc;

// Pass 1: per-sample predictive mean and variance of a 64-candidate tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
predict_kernel(const T* __restrict__ Xs, const T* __restrict__ X,
               const T* __restrict__ nmask, const T* __restrict__ hyp,
               const T* __restrict__ smask, const T* __restrict__ alpha,
               const T* __restrict__ Binv, T* __restrict__ fmu_out,
               T* __restrict__ fs2_out, int M, int N, int D, int nhyp,
               int meanfun, int mean_off) {
  const int s = blockIdx.y;
  if (smask[s] == T(0)) return;  // masked sample: pass 2 skips it
  const int m0 = blockIdx.x * kMT;
  __shared__ TileSmem<T> sm;
  const T* hyp_s = hyp + (size_t)s * nhyp;
  load_candidates(sm, hyp_s, Xs, m0, M, D);
  T fmu, fs2;
  predict_tile(sm, Xs, X, nmask, hyp_s, alpha + (size_t)s * N,
               Binv + (size_t)s * N * N, m0, M, N, D, meanfun, mean_off, fmu,
               fs2);
  const int m = m0 + threadIdx.x;
  if (threadIdx.x < kMT && m < M) {
    fmu_out[(size_t)s * M + m] = fmu;
    fs2_out[(size_t)s * M + m] = fs2;
  }
}

// Pass 2: one thread per candidate.
template <typename T>
__global__ void acq_kernel(const T* __restrict__ Xs, const T* __restrict__ fmu,
                           const T* __restrict__ fs2, const T* __restrict__ smask,
                           const T* __restrict__ vmu, const T* __restrict__ vsigma,
                           const T* __restrict__ vlam, const T* __restrict__ vlogw,
                           T* __restrict__ out, int S, int M, int D, int K,
                           T ymax, T tol_var, int regularize) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  T ns, fbar, vtot;
  sample_summary(fmu, fs2, smask, S, M, m, ns, fbar, vtot);

  T sumloglam = T(0);
  for (int d = 0; d < D; ++d) sumloglam += flog(vlam[d]);
  T mx = -INFINITY, acc = T(0);
  for (int k = 0; k < K; ++k) {
    const T lw = vlogw[k];
    if (lw == -INFINITY) continue;
    const T sk = vsigma[k];
    T z2 = T(0);
    for (int d = 0; d < D; ++d) {
      const T z = (Xs[(size_t)m * D + d] - vmu[k * D + d]) / (sk * vlam[d]);
      z2 += z * z;
    }
    const T comp = lw - T(0.5 * kLog2Pi) * T(D) - T(D) * flog(sk) - sumloglam -
                   T(0.5) * z2;
    if (comp > mx) {
      acc = acc * fexp(mx - comp) + T(1);
      mx = comp;
    } else {
      acc += fexp(comp - mx);
    }
  }
  T logq = (mx == -INFINITY) ? T(-INFINITY) : mx + flog(acc);
  logq = logq < T(-708) ? T(-708) : logq;
  T a = -vtot * fexp(fbar - ymax + logq);
  if (regularize && vtot < tol_var) {
    const T ratio = tol_var / (vtot > Lim<T>::tiny() ? vtot : Lim<T>::tiny());
    a = a * fexp(-(ratio - T(1)));
  }
  out[m] = a < -Lim<T>::big() ? -Lim<T>::big() : a;
}

template <typename T>
int launch(const T* Xs, const T* X, const T* nmask, const T* hyp,
           const T* smask, const T* alpha, const T* Binv, const T* vmu,
           const T* vsigma, const T* vlam, const T* vlogw, T* fmu_ws,
           T* fs2_ws, T* out, int M, int N, int D, int S, int K, int nhyp,
           int meanfun, int mean_off, double ymax, double tol_var,
           int regularize, void* stream) {
  if (D < 1 || D > kMaxD || M < 1 || N < 1 || S < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid1((M + kMT - 1) / kMT, S);
  predict_kernel<T><<<grid1, kThreads, 0, st>>>(
      Xs, X, nmask, hyp, smask, alpha, Binv, fmu_ws, fs2_ws, M, N, D, nhyp,
      meanfun, mean_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  acq_kernel<T><<<(M + 255) / 256, 256, 0, st>>>(
      Xs, fmu_ws, fs2_ws, smask, vmu, vsigma, vlam, vlogw, out, S, M, D, K,
      T(ymax), T(tol_var), regularize);
  return (int)cudaGetLastError();
}

}  // namespace

#define VBMC_ACQ_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* Xs, const void* X, const void* nmask,       \
                      const void* hyp, const void* smask, const void* alpha,  \
                      const void* Binv, const void* vmu, const void* vsigma,  \
                      const void* vlam, const void* vlogw, void* fmu_ws,      \
                      void* fs2_ws, void* out, int M, int N, int D, int S,    \
                      int K, int nhyp, int meanfun, int mean_off,             \
                      double ymax, double tol_var, int regularize,            \
                      void* stream) {                                         \
    return launch<T>(                                                         \
        (const T*)Xs, (const T*)X, (const T*)nmask, (const T*)hyp,            \
        (const T*)smask, (const T*)alpha, (const T*)Binv, (const T*)vmu,      \
        (const T*)vsigma, (const T*)vlam, (const T*)vlogw, (T*)fmu_ws,        \
        (T*)fs2_ws, (T*)out, M, N, D, S, K, nhyp, meanfun, mean_off, ymax,    \
        tol_var, regularize, stream);                                         \
  }

VBMC_ACQ_ENTRY(prospective_acq_f64, double)
VBMC_ACQ_ENTRY(prospective_acq_f32, float)
