// GP predictive machinery shared by the acquisition kernels of this
// directory (prospective_acq.cu, viqr_acq.cu), CUDA C++ for sm_90a.
//
// One block of kThreads threads owns kMT candidates C of one GP
// hyperparameter sample s. It computes, for SE-ard with a zero, const or
// negquad mean,
//
//   ks_s   = sf2_s * exp(-1/2 |(X - C) / ell_s|^2) * nmask        (N x kMT)
//   fmu_s  = m_s(C) + ks_s^T alpha_s
//   fs2_s  = max(sf2_s - colsum(ks_s o (Binv_s ks_s)), 0)
//
// without storing ks_s: Binv_s streams through shared memory in kTI x kTJ
// tiles, Binv_s ks_s is formed for kTI rows at a time in registers (a 4 x 4
// micro-tile per thread) and folded straight into the per-candidate sums,
// and the ks slabs are recomputed from X (D <= kMaxD) instead of stored.
// The same slab loader and micro-tile product serve any (rows x N) by
// (N x kMT) product against ks_s (viqr_acq.cu uses them for ks^T invKzk).
// See prospective_acq.cu for what bounds this on the card.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>

namespace vbmc {

constexpr int kMT = 64;        // candidates per block
constexpr int kTI = 64;        // rows per row tile
constexpr int kTJ = 16;        // reduction depth per inner step
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 32;
constexpr int kCS = kMaxD + 1;  // candidate row stride (bank-conflict pad)
constexpr double kLog2Pi = 1.8378770664093453;

__device__ __forceinline__ double fexp(double x) { return exp(x); }
__device__ __forceinline__ float fexp(float x) { return expf(x); }
__device__ __forceinline__ double flog(double x) { return log(x); }
__device__ __forceinline__ float flog(float x) { return logf(x); }
__device__ __forceinline__ double flog1p(double x) { return log1p(x); }
__device__ __forceinline__ float flog1p(float x) { return log1pf(x); }

template <typename T> struct Lim;
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double big() { return DBL_MAX; }
};
template <> struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float big() { return FLT_MAX; }
};

// Shared memory of one block. `rows` holds a kTI x kTJ tile of the left
// factor (Binv_s, or a transposed invKzk_s tile); `ksJ` a kTJ x kMT slab of
// ks_s, and serves as the reduction buffer at the end of a tile.
template <typename T> struct TileSmem {
  T inv_ell[kMaxD];
  T cand[kMT * kCS];  // candidates scaled by 1/ell
  T rows[kTI][kTJ + 1];
  T ksJ[kTJ][kMT];
};

// Loads 1/ell_s and the block's candidates (scaled by 1/ell_s; rows past M
// are zero). Ends with a barrier.
template <typename T>
__device__ void load_candidates(TileSmem<T>& sm, const T* __restrict__ hyp_s,
                                const T* __restrict__ Xs, int m0, int M,
                                int D) {
  const int tid = threadIdx.x;
  if (tid < D) sm.inv_ell[tid] = fexp(-hyp_s[tid]);
  __syncthreads();
  for (int e = tid; e < kMT * D; e += kThreads) {
    const int mm = e / D, d = e % D;
    const int m = m0 + mm;
    sm.cand[mm * kCS + d] = (m < M ? Xs[(size_t)m * D + d] : T(0)) *
                            sm.inv_ell[d];
  }
  __syncthreads();
}

// k(x_j, c) for a training row j and the block's candidate column c.
template <typename T>
__device__ __forceinline__ T ks_entry(const TileSmem<T>& sm,
                                      const T* __restrict__ X, int j, int c,
                                      int D, T sf2) {
  T d2 = T(0);
  for (int d = 0; d < D; ++d) {
    const T diff = X[(size_t)j * D + d] * sm.inv_ell[d] - sm.cand[c * kCS + d];
    d2 += diff * diff;
  }
  return sf2 * fexp(T(-0.5) * d2);
}

// ksJ <- ks_s rows j0 .. j0+kTJ-1 (zero past N and on masked rows). No
// barrier: the caller syncs before reading.
template <typename T>
__device__ void load_ks_slab(TileSmem<T>& sm, const T* __restrict__ X,
                             const T* __restrict__ nmask, int j0, int N,
                             int D, T sf2) {
  for (int e = threadIdx.x; e < kTJ * kMT; e += kThreads) {
    const int r = e / kMT, c = e % kMT;
    const int j = j0 + r;
    sm.ksJ[r][c] =
        (j < N && nmask[j] != T(0)) ? ks_entry(sm, X, j, c, D, sf2) : T(0);
  }
}

// acc[r][c] += sum_k rows[ty + 16 r][k] * ksJ[k][tx + 16 c].
template <typename T>
__device__ __forceinline__ void fma_slab(const TileSmem<T>& sm, T acc[4][4],
                                         int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kTJ; ++k) {
    T a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = sm.rows[ty + 16 * r][k];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = sm.ksJ[k][tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
  }
}

// Sums part[c] of the 16 thread rows (ty) for each of the kMT candidate
// columns: returns the total of column threadIdx.x to threads < kMT. Uses
// ksJ as the buffer, with barriers before and after.
template <typename T>
__device__ T column_sum(TileSmem<T>& sm, const T part[4], int tx, int ty) {
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) sm.ksJ[ty][tx + 16 * c] = part[c];
  __syncthreads();
  T tot = T(0);
  if (threadIdx.x < kMT)
    for (int t = 0; t < 16; ++t) tot += sm.ksJ[t][threadIdx.x];
  __syncthreads();
  return tot;
}

// Predictive mean and variance of sample s at the block's candidates
// m0 .. m0+kMT-1, after load_candidates. Thread t < kMT returns those of
// candidate m0 + t in fmu, fs2 (garbage past M).
template <typename T>
__device__ void predict_tile(TileSmem<T>& sm, const T* __restrict__ Xs,
                             const T* __restrict__ X,
                             const T* __restrict__ nmask,
                             const T* __restrict__ hyp_s,
                             const T* __restrict__ alpha_s,
                             const T* __restrict__ Binv_s, int m0, int M,
                             int N, int D, int meanfun, int mean_off, T& fmu,
                             T& fs2) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T sf2 = fexp(T(2) * hyp_s[D]);
  T qf_part[4] = {0, 0, 0, 0};
  T fmu_part[4] = {0, 0, 0, 0};

  for (int i0 = 0; i0 < N; i0 += kTI) {
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

    for (int j0 = 0; j0 < N; j0 += kTJ) {
      for (int e = tid; e < kTI * kTJ; e += kThreads) {
        const int r = e / kTJ, c = e % kTJ;
        const int i = i0 + r, j = j0 + c;
        sm.rows[r][c] = (i < N && j < N) ? Binv_s[(size_t)i * N + j] : T(0);
      }
      load_ks_slab(sm, X, nmask, j0, N, D, sf2);
      __syncthreads();
      fma_slab(sm, acc, tx, ty);
      __syncthreads();
    }

    // Fold the finished rows into the per-candidate sums.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= N || nmask[i] == T(0)) continue;
      const T a_i = alpha_s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T kv = ks_entry(sm, X, i, tx + 16 * c, D, sf2);
        qf_part[c] += kv * acc[r][c];
        fmu_part[c] += kv * a_i;
      }
    }
  }

  const T qf = column_sum(sm, qf_part, tx, ty);
  const T f = column_sum(sm, fmu_part, tx, ty);
  const int m = m0 + tid;
  T mean = T(0);
  if (tid < kMT && m < M) {
    if (meanfun == 1) {
      mean = hyp_s[mean_off];
    } else if (meanfun == 4) {
      T q = T(0);
      for (int d = 0; d < D; ++d) {
        const T z = (Xs[(size_t)m * D + d] - hyp_s[mean_off + 1 + d]) *
                    fexp(-hyp_s[mean_off + 1 + D + d]);
        q += z * z;
      }
      mean = hyp_s[mean_off] - T(0.5) * q;
    }
  }
  const T v = sf2 - qf;
  fmu = mean + f;
  fs2 = v < T(0) ? T(0) : v;
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

}  // namespace vbmc
