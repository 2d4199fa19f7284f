// Eigendecomposition of one symmetric D x D matrix, D <= 128, for NVIDIA
// Hopper (sm_90a), CUDA C++: A = V diag(w) V^T, the columns of V the
// eigenvectors, in no particular order and with no particular signs.
//
// Replaces no TPU kernel. The JAX package's CMA-ES calls jnp.linalg.eigh
// inside its lax.scan (vbmc_tpu/samplers/cmaes.py), one compiled program
// with the eigensolver on the device. The port runs a CMA-ES generation as
// a CUDA graph (vbmc_tpu_torch/samplers/cmaes.py), and torch.linalg.eigh
// cannot be captured: it reads its convergence flag back on the host. This
// kernel is the D x D step of that generation, launched on PyTorch's current
// stream with nothing read back.
//
// What bounds it on this card. The work is tiny (a Jacobi sweep is about
// 6 D^3 flops: 6,000 at D = 10) and serial in its rounds, so it is bound by
// latency: the barriers between rounds, and one CTA's shared-memory
// traffic. A generation at D = 10 replays some two hundred kernels in a
// graph; this one has to stay a small part of that.
//
// What the design does about it. One CTA holds A (padded to an even n) in
// shared memory and, where both fit in 227 KB, V too (otherwise V is the
// output in device memory: float64 from D = 113, where the same code runs
// through generic pointers). Cyclic parallel Jacobi: a sweep is n - 1
// rounds of the round-robin pairing, each round n / 2 disjoint pairs (p, q)
// whose rotations commute. A round is two barrier-separated steps: (1) one
// thread a pair computes c, s and t = s / c that zero A[p][q], from the A
// of the round's start, and writes them with (p, q) to shared memory; (2)
// one thread a 2 x 2 block (pair i, pair j), i <= j, applies R_i^T A_ij R_j
// and writes the block and its transpose (so A stays exactly symmetric),
// the diagonal blocks by the closed form (a_pp - t a_pq, a_qq + t a_pq, 0),
// and beside them one thread a (row, pair) of V applies V R. The block has
// as many threads as step (2) has tasks, rounded up to whole warps (96 at
// D = 10, one warp at D <= 4), up to 256: the barriers, which bound a round,
// wait for no idle warp. The loop stops when the off-diagonal norm is below
// the type's epsilon times ||A||_F, or after kMaxSweeps sweeps. The matrix
// is read from its lower triangle, as torch.linalg.eigh reads it. A padded
// index (odd D) has a zero row and column and is never rotated.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSweeps = 30;
constexpr int kMaxSmem = 232448;   // 227 KB, a block's ceiling on sm_90

template <typename T> struct Eps;
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };
template <> struct Eps<float> { static constexpr float value = FLT_EPSILON; };

__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double hypot_(double x, double y) {
  return hypot(x, y);
}
__device__ __forceinline__ float hypot_(float x, float y) {
  return hypotf(x, y);
}
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }

// The pair k of round r of the round-robin over n (even) indices, p < q:
// index n - 1 meets r, and r + k meets r - k (mod n - 1).
__device__ __forceinline__ void pair_of(int r, int k, int n, int& p, int& q) {
  const int m = n - 1;
  int a = r, b = m;
  if (k > 0) {
    a = (r + k) % m;
    b = (r - k + m) % m;
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// Sum over the block, the same value returned to every thread.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < int(blockDim.x / 32); ++w) s += red[w];
  __syncthreads();   // red is written again by the next call
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
sym_eig_kernel(const T* __restrict__ a_in, T* __restrict__ w_out,
               T* __restrict__ v_out, int d, int v_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = d + (d & 1);
  const int half = n / 2;
  const int nt = blockDim.x;
  T* A = reinterpret_cast<T*>(smem_raw);    // n x n
  T* rot = A + n * n;                        // (c, s, t) a pair
  T* red = rot + 3 * half;                   // a partial sum a warp
  T* V = v_in_smem ? red + kMaxWarps : v_out;  // d x d, row-major
  int* pq = reinterpret_cast<int*>(red + kMaxWarps + (v_in_smem ? d * d : 0));
  const int tid = threadIdx.x;

  for (int i = tid; i < n * n; i += nt) {
    const int r = i / n, c = i % n;
    T v = 0;
    if (r < d && c < d) v = r >= c ? a_in[r * d + c] : a_in[c * d + r];
    A[i] = v;
  }
  for (int i = tid; i < d * d; i += nt) V[i] = i / d == i % d ? T(1) : T(0);
  __syncthreads();

  T part = 0;
  for (int i = tid; i < n * n; i += nt) part += A[i] * A[i];
  const T eps = Eps<T>::value;
  const T thr2 = eps * eps * block_sum(part, red);

  for (int sweep = 0;; ++sweep) {
    part = 0;
    for (int i = tid; i < n * n; i += nt)
      if (i / n != i % n) part += A[i] * A[i];
    const T off2 = block_sum(part, red);
    if (!(off2 > thr2) || sweep == kMaxSweeps) break;
    for (int r = 0; r < n - 1; ++r) {
      for (int k = tid; k < half; k += nt) {
        int p, q;
        pair_of(r, k, n, p, q);
        const T apq = A[p * n + q];
        T c = 1, s = 0, t = 0;
        if (apq != T(0)) {
          // t = sign(theta) / (|theta| + sqrt(theta^2 + 1)) with theta =
          // dq / e, written with one division
          const T dq = A[q * n + q] - A[p * n + p], e = T(2) * apq;
          t = (dq >= T(0) ? e : -e) / (abs_(dq) + hypot_(dq, e));
          c = rsqrt_(t * t + T(1));
          s = t * c;
        }
        rot[3 * k] = c;
        rot[3 * k + 1] = s;
        rot[3 * k + 2] = t;
        pq[2 * k] = p;
        pq[2 * k + 1] = q;
      }
      __syncthreads();
      const int n_blocks = half * half;
      for (int b = tid; b < n_blocks + d * half; b += nt) {
        if (b < n_blocks) {
          const int i = b / half, j = b % half;
          if (i > j) continue;
          const int pi = pq[2 * i], qi = pq[2 * i + 1];
          if (i == j) {
            const T t = rot[3 * i + 2];
            if (t != T(0)) {
              const T apq = A[pi * n + qi];
              A[pi * n + pi] -= t * apq;
              A[qi * n + qi] += t * apq;
              A[pi * n + qi] = 0;
              A[qi * n + pi] = 0;
            }
            continue;
          }
          const int pj = pq[2 * j], qj = pq[2 * j + 1];
          const T ci = rot[3 * i], si = rot[3 * i + 1];
          const T cj = rot[3 * j], sj = rot[3 * j + 1];
          const T x00 = A[pi * n + pj], x01 = A[pi * n + qj];
          const T x10 = A[qi * n + pj], x11 = A[qi * n + qj];
          // rows of R_i^T X, then columns of (R_i^T X) R_j
          const T y00 = ci * x00 - si * x10, y01 = ci * x01 - si * x11;
          const T y10 = si * x00 + ci * x10, y11 = si * x01 + ci * x11;
          const T z00 = cj * y00 - sj * y01, z01 = sj * y00 + cj * y01;
          const T z10 = cj * y10 - sj * y11, z11 = sj * y10 + cj * y11;
          A[pi * n + pj] = z00;
          A[pj * n + pi] = z00;
          A[pi * n + qj] = z01;
          A[qj * n + pi] = z01;
          A[qi * n + pj] = z10;
          A[pj * n + qi] = z10;
          A[qi * n + qj] = z11;
          A[qj * n + qi] = z11;
        } else {
          const int row = (b - n_blocks) / half, k = (b - n_blocks) % half;
          const int p = pq[2 * k], q = pq[2 * k + 1];
          const T s = rot[3 * k + 1];
          if (q >= d || s == T(0)) continue;
          const T c = rot[3 * k];
          const T vp = V[row * d + p], vq = V[row * d + q];
          V[row * d + p] = c * vp - s * vq;
          V[row * d + q] = s * vp + c * vq;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < d; i += nt) w_out[i] = A[i * n + i];
  if (v_in_smem)
    for (int i = tid; i < d * d; i += nt) v_out[i] = V[i];
}

template <typename T>
int launch(const T* a, T* w, T* v, int d, cudaStream_t stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sym_eig_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int n = d + (d & 1), half = n / 2;
  const size_t pairs = size_t(n) * sizeof(int);
  const size_t base =
      (size_t(n) * n + 3 * half + kMaxWarps) * sizeof(T) + pairs;
  const size_t with_v = base + size_t(d) * d * sizeof(T);
  const int v_in_smem = with_v <= size_t(kMaxSmem);
  const int tasks = half * half + d * half;
  const int threads =
      tasks >= kMaxThreads ? kMaxThreads : (tasks + 31) / 32 * 32;
  sym_eig_kernel<T><<<1, threads, v_in_smem ? with_v : base, stream>>>(
      a, w, v, d, v_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: the D x D input (row-major; its lower triangle is read); w: the D
// eigenvalues; v: the D x D eigenvectors, as columns. Returns the CUDA
// error of the launch (0 on success).
extern "C" int sym_eig_f64(const void* a, void* w, void* v, int d,
                           void* stream) {
  return launch<double>(static_cast<const double*>(a), static_cast<double*>(w),
                        static_cast<double*>(v), d,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int sym_eig_f32(const void* a, void* w, void* v, int d,
                           void* stream) {
  return launch<float>(static_cast<const float*>(a), static_cast<float*>(w),
                       static_cast<float*>(v), d,
                       static_cast<cudaStream_t>(stream));
}
