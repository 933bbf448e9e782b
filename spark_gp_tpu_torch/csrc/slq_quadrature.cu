// Gauss quadrature of stochastic Lanczos quadrature (SLQ), per probe.
//
// Replaces no Pallas kernel: it stands for XLA's `eigh` in the JAX package's
// spark_gp_tpu/ops/iterative.py::slq_logdet_from_coeffs, whose PyTorch
// counterpart (`torch.linalg.eigh`, cuSOLVER's syevj) cannot run inside a
// captured CUDA graph: the device optimizer's step on the CG lanes holds the
// log-determinant's quadrature, so the step needs a form that captures.
//
// For each of `batch` symmetric tridiagonal matrices T (the Lanczos matrices
// the PCG coefficients of ops/iterative.py define, one per expert and probe,
// any size t >= 1), with diagonal `diag[b, 0..t)` and off-diagonal
// `off[b, 0..t-1)`, it writes
//
//     out[b] = sum_j (e1^T v_j)^2 * log(max(lambda_j, 1e-12))
//
// over T's eigenpairs (lambda_j, v_j): the Golub-Welsch quadrature of log at
// e1, e1^T log(T) e1.  Everything is computed in double.
//
// What bounds it on an H100: neither bytes nor operations (at the
// protein-matfree shape, 9 experts x 8 probes at t = 64, it reads 36 KB), but
// the length of each matrix's chain of dependent double operations.  The
// first design (csrc/dev/slq_quadrature_first.cu) ran one thread a matrix
// through implicit-shift QL: 72 threads on two SMs, ~4,400 dependent plane
// rotations a matrix, each a hypot and two divisions over a workspace in
// device memory.  This design takes one block of kThreads threads a matrix
// and cuts the chain to one pass down T:
//
// 1. T goes to shared memory in double (24 bytes a row with the QL route's
//    column below; above kSharedRows rows, the same code runs over a
//    workspace of slq_quadrature_workspace_doubles(batch, t) doubles that
//    the caller allocates).  No step of the chain touches device memory.
// 2. Deflation: the first negligible off-diagonal, |e_m| <= DBL_EPSILON
//    (|d_m| + |d_{m+1}|), splits T, and the rows below it carry no weight at
//    e1; only the leading unreduced block T' of t' rows enters the sum.  A
//    converged PCG column's frozen steps split T this way.
// 3. No eigenvalue and no weight is formed.  For an SPD T' (all eigenvalues
//    above the clamp, 1e-12), with g(s) = e1^T (T' + sI)^-1 e1 and
//    log(lambda) = int_0^inf (1/(1+s) - 1/(lambda+s)) ds,
//
//        e1^T log(T') e1 = int_0^inf (1/(1+s) - g(s)) ds
//                        = int phi(u) du,  phi = s (1/(1+s) - g(s)),  s = e^u,
//
//    and the trapezoid rule in u converges geometrically: phi is analytic
//    in the strip |Im u| < pi (its poles sit at s = -lambda_j and s = -1),
//    so a step of kStep = 0.5 leaves an error of about exp(-2 pi^2 / 0.5)
//    ~ 1e-17.  The nodes run from s = 1e-17 * 1e-12 (below it |phi| <=
//    s (1 + g(0)) < 1e-17, since g(0) < 1 / 1e-12) to e^40 max(1, the
//    Gershgorin bound) (above it |phi| ~ |d_0 - 1| / s < 1e-17): ~215-260
//    nodes, one a thread.  Each node is one bottom-up pass of the pivots
//    of T' + sI, q_k = d_k + s - e_k^2 / q_{k+1}, and g(s) = 1 / q_0; the
//    last pivot is carried as r = q_0 - 1 - s, so phi = s r / ((1+s) q_0)
//    loses nothing at large s.  A block sum gives the value.
//    Why this and not eigenvalues by bisection with weights 1 / s_1'(lambda)
//    (s_1 the top pivot of lambda I - T'): a Lanczos run past convergence
//    repeats Ritz values to the last bit (ghosts), and there the weight
//    formula, like any weight taken one eigenvalue at a time, is O(1) wrong
//    (csrc/dev/slq_weight_routes.py: off by up to 1.1).  The integral never
//    separates eigenvalues: each pass is a Cholesky-like factorization of
//    an SPD matrix, backward stable, so clustered or repeated Ritz values
//    cost nothing (the emulation's float64 cases agree with eigh to ~1e-13).
// 4. A T' with an eigenvalue at or below the clamp (T' - 1e-12 I has a
//    pivot <= 0: a PCG step with alpha <= 0, a near-singular operator, or a
//    tridiagonal that no PCG run gives) has no such integral; its thread 0
//    runs the first design's QL on the block's copy of T' (only the
//    eigenvectors' first row rotated), which clamps each eigenvalue.  A
//    matrix whose QL does not converge in kMaxSweeps iterations of one
//    eigenvalue, a non-finite one included, gives NaN.
//
// The critical path is then two passes of t' dependent pivot steps (the
// last thread's SPD check runs after its node), against the first design's
// thousands of rotations.  `steps` (nullable) receives each matrix's count of
// the work done: pivot steps on the integral route (t' for the check and t'
// a node), QL rotations on the QL route.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// rows a block keeps in shared memory: 24 KB of working columns and 2 KB of
// reduction slots, under the 48 KB a block has without opting in
constexpr int kSharedRows = 1024;
constexpr double kClamp = 1e-12;
// the trapezoid step in u = log s, the integrand's bound at the first node
// and the nodes' reach past log max(1, the Gershgorin bound)
constexpr double kStep = 0.5;
constexpr double kTailLo = 1e-17;
constexpr double kPadHi = 40.0;
constexpr int kMaxSweeps = 30;

struct Sum {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct Min {
  __device__ double operator()(double a, double b) const { return fmin(a, b); }
};
struct Max {
  __device__ double operator()(double a, double b) const { return fmax(a, b); }
};

// `op` over the block's values of v, returned to every thread
template <class Op>
__device__ double block_reduce(double v, double* red, Op op) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] = op(red[tid], red[tid + half]);
    __syncthreads();
  }
  const double r = red[0];
  __syncthreads();
  return r;
}

// The first design's implicit-shift QL (Numerical Recipes' tqli) on rows
// [0, n) of d and e, rotating w, the eigenvectors' first row; the
// quadrature, or NaN if an eigenvalue does not converge.
__device__ double ql_quadrature(double* d, double* e, double* w, int n, int* rotations) {
  for (int j = 0; j < n; ++j) w[j] = j == 0 ? 1.0 : 0.0;
  bool converged = true;
  int turns = 0;
  for (int l = 0; l < n && converged; ++l) {
    int sweeps = 0, m;
    do {
      for (m = l; m < n - 1; ++m) {
        const double dd = fabs(d[m]) + fabs(d[m + 1]);
        if (fabs(e[m]) <= DBL_EPSILON * dd) break;
      }
      if (m != l) {
        if (sweeps++ == kMaxSweeps) {
          converged = false;
          break;
        }
        double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
        double r = hypot(g, 1.0);
        g = d[m] - d[l] + e[l] / (g + copysign(r, g));
        double s = 1.0, c = 1.0, p = 0.0;
        int i;
        for (i = m - 1; i >= l; --i) {
          const double f = s * e[i], h = c * e[i];
          r = hypot(f, g);
          e[i + 1] = r;
          if (r == 0.0) {  // underflow: deflate and sweep again
            d[i + 1] -= p;
            e[m] = 0.0;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0 * c * h;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - h;
          const double wf = w[i + 1];
          w[i + 1] = s * w[i] + c * wf;
          w[i] = c * w[i] - s * wf;
          ++turns;
        }
        if (r == 0.0 && i >= l) continue;
        d[l] -= p;
        e[l] = g;
        e[m] = 0.0;
      }
    } while (m != l);
  }
  *rotations = turns;
  if (!converged) return NAN;
  double acc = 0.0;
  for (int j = 0; j < n; ++j) acc += w[j] * w[j] * log(fmax(d[j], kClamp));
  return acc;
}

template <typename T, bool kInShared>
__global__ void __launch_bounds__(kThreads)
    slq_quadrature_kernel(const T* __restrict__ diag, const T* __restrict__ off,
                          T* __restrict__ out, int* __restrict__ steps,
                          double* __restrict__ work, int t) {
  extern __shared__ double smem[];
  __shared__ int spd;
  const int b = blockIdx.x, tid = threadIdx.x;
  double* red = smem;
  double* d = kInShared ? smem + kThreads : work + 3 * static_cast<size_t>(b) * t;
  double* e = d + t;
  double* w = e + t;
  const T* db = diag + static_cast<size_t>(b) * t;
  const T* ob = off + static_cast<size_t>(b) * (t - 1);
  for (int j = tid; j < t; j += kThreads) {
    d[j] = static_cast<double>(db[j]);
    e[j] = j + 1 < t ? static_cast<double>(ob[j]) : 0.0;
  }
  __syncthreads();

  // the leading unreduced block: rows [0, n)
  int first = t;
  for (int j = tid; j < t - 1; j += kThreads) {
    if (fabs(e[j]) <= DBL_EPSILON * (fabs(d[j]) + fabs(d[j + 1]))) {
      first = j + 1;
      break;
    }
  }
  const int n = static_cast<int>(block_reduce(static_cast<double>(first), red, Min{}));
  double bound = 1.0;
  for (int j = tid; j < n; j += kThreads)
    bound = fmax(bound, d[j] + (j > 0 ? fabs(e[j - 1]) : 0.0) + (j + 1 < n ? fabs(e[j]) : 0.0));
  bound = block_reduce(bound, red, Max{});

  // the trapezoid rule's nodes, one a thread
  const double u_lo = log(kTailLo * kClamp), u_hi = log(fmin(bound, DBL_MAX)) + kPadHi;
  const int nodes = static_cast<int>(ceil((u_hi - u_lo) / kStep)) + 1;
  double acc = 0.0;
  for (int i = tid; i < nodes; i += kThreads) {
    const double s = exp(u_lo + kStep * i);
    double r = d[0] - 1.0;
    if (n > 1) {
      double q = d[n - 1] + s;
      for (int k = n - 2; k >= 1; --k) q = d[k] + s - e[k] * e[k] / q;
      r -= e[0] * e[0] / q;
    }
    acc += s * r / ((1.0 + s) * (r + 1.0 + s));
  }
  // is T' - 1e-12 I positive definite: its pivots all positive
  if (tid == kThreads - 1) {
    double q = d[n - 1] - kClamp;
    for (int k = n - 2; k >= 0 && q > 0.0; --k) q = d[k] - kClamp - e[k] * e[k] / q;
    spd = q > 0.0;
  }
  __syncthreads();
  if (spd) {
    acc = kStep * block_reduce(acc, red, Sum{});
    if (tid == 0) {
      out[b] = static_cast<T>(acc);
      if (steps != nullptr) steps[b] = (nodes + 1) * n;
    }
  } else if (tid == 0) {
    int rotations;
    out[b] = static_cast<T>(ql_quadrature(d, e, w, n, &rotations));
    if (steps != nullptr) steps[b] = rotations;
  }
}

template <typename T>
int launch(const T* diag, const T* off, T* out, int* steps, double* work, int batch, int t,
           void* stream) {
  if (batch <= 0) return 0;
  const bool in_shared = t <= kSharedRows;
  if (t < 1 || (!in_shared && work == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (kThreads + (in_shared ? 3 * static_cast<size_t>(t) : 0)) * sizeof(double);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_shared)
    slq_quadrature_kernel<T, true><<<batch, kThreads, bytes, st>>>(diag, off, out, steps, work, t);
  else
    slq_quadrature_kernel<T, false><<<batch, kThreads, bytes, st>>>(diag, off, out, steps, work,
                                                                    t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The doubles of workspace a launch on `batch` matrices of t rows needs: none
// up to kSharedRows rows, which a block keeps in shared memory.
extern "C" long long slq_quadrature_workspace_doubles(int batch, int t) {
  return t <= kSharedRows ? 0LL : 3LL * batch * t;
}

// diag [batch, t], off [batch, t - 1], out [batch]; steps [batch] or NULL
// (each matrix's work: pivot steps, or QL rotations); work:
// slq_quadrature_workspace_doubles(batch, t) doubles (NULL if none).
extern "C" int slq_quadrature_f32(const float* diag, const float* off, float* out, int* steps,
                                  double* work, int batch, int t, void* stream) {
  return launch(diag, off, out, steps, work, batch, t, stream);
}

extern "C" int slq_quadrature_f64(const double* diag, const double* off, double* out,
                                  int* steps, double* work, int batch, int t, void* stream) {
  return launch(diag, off, out, steps, work, batch, t, stream);
}
