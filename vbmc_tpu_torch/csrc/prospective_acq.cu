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
// What bounds it on this card. Operations: the quadratic form ks^T Binv ks
// is 2 S M N^2 flops (4.3 GFLOP at N=128, S=16, M=8192; 17.2 at N=256;
// 1374 at N=1024, S=80), against 67 TFLOP/s of the H100's FP64 tensor
// cores: 0.064, 0.256 and 20.5 ms. The bytes (Binv: 2 MB, 8.4 MB and
// 671 MB in float64) take 0.001, 0.003 and 0.2 ms at 3.35 TB/s. Beside the
// product stand S M N evaluations of ks (2 D + 1 flops and a float64 exp, a
// software sequence of some 20 FP64 operations, on the FMA pipes at half
// the tensor rate): at N=128 that is two thirds of the product's time at
// peak, at N=1024 a twelfth. The Pallas kernel kept a whole (N, Mt) ks
// tile and all of Binv_s in VMEM and carried sums across a sequential
// sample grid axis; a block here has 227 KB and blocks run in no order.
//
// What the design does about it (gp_tile.cuh has the machinery). Pass 1
// runs on a grid (ceil(M / MT), S): a block owns MT candidates of one
// sample, forms their ks tile once in shared memory, streams Binv_s
// through a cp.async ring of two or three chunks, multiplies on the FP64
// tensor cores (mma.sync.m16n8k16.f64; float32: IEEE FMAs, no TF32) and
// folds each finished 128-row tile of Binv_s^T ks straight into the
// per-candidate sums, so no N x M product is ever stored. The launcher
// picks the plan from N: MT = 64 with two blocks an SM up to N = 128 in
// float64 (one block's exps overlap the other's products), MT = 64 with
// one block up to N = 256, MT = 32 up to N = 512, MT = 16 up to N = 1024;
// exp is evaluated S M N times at every N. What is left on the table at
// the narrow tiles is L2 traffic (every block streams all of Binv_s: 2 and
// 4 times the bytes of MT = 64; at N = 1024 that, not the tensor cores,
// bounds the kernel), which a cluster sharing one multicast copy of each
// chunk would remove. Pass 2, one thread per candidate, reduces the (S, M)
// workspaces over samples (two-pass, masked) and evaluates the mixture
// density with an online log-sum-exp and the acquisition. Ragged M edges
// and masked training rows are handled in the kernel; N must be a multiple
// of 32 (every bucket of the port is one).

#include "gp_tile.cuh"

namespace {

using namespace vbmc;

// Pass 1: per-sample predictive mean and variance of an MT-candidate tile.
template <typename T, typename TL>
__global__ void __launch_bounds__(kThreads, TL::MINB)
predict_kernel(const T* __restrict__ Xs, const T* __restrict__ X,
               const T* __restrict__ nmask, const T* __restrict__ hyp,
               const T* __restrict__ smask, const T* __restrict__ alpha,
               const T* __restrict__ Binv, T* __restrict__ fmu_out,
               T* __restrict__ fs2_out, int M, int N, int D, int nhyp,
               int meanfun, int mean_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.y;
  if (smask[s] == T(0)) return;  // masked sample: pass 2 skips it
  const int m0 = blockIdx.x * TL::MT;
  const Smem<T, TL> sm(smem_raw, N, D);
  const Lane<TL> ln;
  Prof prof;
  T fmu, fs2;
  predict_tile(sm, ln, Xs, X, nmask, hyp + (size_t)s * nhyp,
               alpha + (size_t)s * N, Binv + (size_t)s * N * N, m0, M, N, D,
               meanfun, mean_off, prof, fmu, fs2);
  const int m = m0 + threadIdx.x;
  if (threadIdx.x < TL::MT && m < M) {
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

template <typename T, typename TL>
cudaError_t launch_predict(size_t smem, cudaStream_t st, const T* Xs,
                           const T* X, const T* nmask, const T* hyp,
                           const T* smask, const T* alpha, const T* Binv,
                           T* fmu_ws, T* fs2_ws, int M, int N, int D, int S,
                           int nhyp, int meanfun, int mean_off) {
  auto kernel = predict_kernel<T, TL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + TL::MT - 1) / TL::MT, S);
  kernel<<<grid, kThreads, smem, st>>>(Xs, X, nmask, hyp, smask, alpha, Binv,
                                       fmu_ws, fs2_ws, M, N, D, nhyp, meanfun,
                                       mean_off);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* Xs, const T* X, const T* nmask, const T* hyp,
           const T* smask, const T* alpha, const T* Binv, const T* vmu,
           const T* vsigma, const T* vlam, const T* vlogw, T* fmu_ws,
           T* fs2_ws, T* out, int M, int N, int D, int S, int K, int nhyp,
           int meanfun, int mean_off, double ymax, double tol_var,
           int regularize, void* stream) {
  if (D < 1 || D > kMaxD || M < 1 || N < kNStep || N % kNStep != 0 || S < 1 ||
      K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The first plan (gp_tile.cuh) whose shared memory fits.
  const int err = with_plan<T>(N, D, [&](auto tl, size_t bytes) {
    return (int)launch_predict<T, decltype(tl)>(
        bytes, st, Xs, X, nmask, hyp, smask, alpha, Binv, fmu_ws, fs2_ws, M,
        N, D, S, nhyp, meanfun, mean_off);
  });
  if (err < 0) return (int)cudaErrorInvalidValue;  // N too large for any plan
  if (err != 0) return err;
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

extern "C" int prospective_acq_tile(int N, int D, int f64) {
  return vbmc::tile_width(N, D, f64 != 0);
}

#ifdef VBMC_PROFILE
extern "C" int prospective_acq_profile(unsigned long long* out, int reset) {
  return vbmc::profile_read(out, reset);
}
#endif
