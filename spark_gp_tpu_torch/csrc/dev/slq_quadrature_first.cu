// The first design of csrc/slq_quadrature.cu, kept as it was so that
// chip_smoke.py builds and times it beside the current kernel, and reads
// its QL rotation counts, which the quadrature's bound counts.  Same C
// entry points.
//
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
// over T's eigenpairs (lambda_j, v_j): the Golub-Welsch nodes and weights of
// the quadrature of log at e1.  One thread per matrix runs the implicit-shift
// QL iteration (Numerical Recipes' tqli) in double, rotating only the first
// row of the eigenvector matrix (started at e1^T I): O(t) per rotation,
// O(t^2) per matrix, no t x t matrix anywhere.  A matrix whose QL does not
// converge in kMaxSweeps iterations of one eigenvalue gives NaN.  The three
// working columns (the diagonal, the off-diagonal and the first row) live in
// a caller's double workspace of slq_quadrature_workspace_doubles(batch, t),
// laid out [3][t][batch] so a warp's threads touch consecutive words.
//
// What bounds it on an H100: neither bytes nor operations.  At the
// protein-matfree shape (9 experts x 8 probes, t = 64) it reads 36 KB and does
// about 25 double operations a rotation, O(t) rotations a QL sweep and a few
// sweeps an eigenvalue: well under a microsecond at the card's rates.  72
// matrices occupy two warps of one SM, so the time is one thread's serial
// chain (t eigenvalues, each a few sweeps of a dependent rotation loop, the
// working columns in the workspace); simple and right first.  `rotations`
// (nullable) receives each matrix's rotation count, which the bound of a
// timing run counts.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxSweeps = 30;

// One matrix's working column in the [3][t][batch] workspace.
struct Column {
  double* base;
  int stride;
  __device__ double& operator[](int j) const { return base[static_cast<size_t>(j) * stride]; }
};

template <typename T>
__global__ void slq_quadrature_kernel(const T* __restrict__ diag, const T* __restrict__ off,
                                      T* __restrict__ out, int* __restrict__ rotations,
                                      double* __restrict__ work, int batch, int t) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t plane = static_cast<size_t>(t) * batch;
  const Column d{work + b, batch}, e{work + plane + b, batch}, w{work + 2 * plane + b, batch};
  const T* db = diag + static_cast<size_t>(b) * t;
  const T* ob = off + static_cast<size_t>(b) * (t - 1);
  for (int j = 0; j < t; ++j) {
    d[j] = static_cast<double>(db[j]);
    e[j] = j + 1 < t ? static_cast<double>(ob[j]) : 0.0;
    w[j] = j == 0 ? 1.0 : 0.0;
  }
  bool converged = true;
  int turns = 0;
  for (int l = 0; l < t && converged; ++l) {
    int sweeps = 0, m;
    do {
      // the first negligible off-diagonal at or after l splits T there
      for (m = l; m < t - 1; ++m) {
        const double dd = fabs(d[m]) + fabs(d[m + 1]);
        if (fabs(e[m]) <= DBL_EPSILON * dd) break;
      }
      if (m != l) {
        if (sweeps++ == kMaxSweeps) {
          converged = false;
          break;
        }
        // Wilkinson-like shift from the leading 2 x 2 block, then one
        // implicit QL sweep of plane rotations from m - 1 down to l
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
          // the rotation on the first row of the eigenvector matrix
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
  double acc = 0.0;
  for (int j = 0; j < t; ++j) acc += w[j] * w[j] * log(fmax(d[j], 1e-12));
  out[b] = converged ? static_cast<T>(acc) : static_cast<T>(NAN);
  if (rotations != nullptr) rotations[b] = turns;
}

template <typename T>
int launch(const T* diag, const T* off, T* out, int* rotations, double* work, int batch, int t,
           void* stream) {
  if (batch <= 0) return 0;
  if (t < 1 || work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  slq_quadrature_kernel<T><<<blocks, kThreads, 0, st>>>(diag, off, out, rotations, work, batch,
                                                        t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The doubles of workspace a launch on `batch` matrices of t rows needs.
extern "C" long long slq_quadrature_workspace_doubles(int batch, int t) {
  return 3LL * batch * t;
}

// diag [batch, t], off [batch, t - 1], out [batch]; rotations [batch] or NULL;
// work: slq_quadrature_workspace_doubles(batch, t) doubles.
extern "C" int slq_quadrature_f32(const float* diag, const float* off, float* out, int* rotations,
                                  double* work, int batch, int t, void* stream) {
  return launch(diag, off, out, rotations, work, batch, t, stream);
}

extern "C" int slq_quadrature_f64(const double* diag, const double* off, double* out,
                                  int* rotations, double* work, int batch, int t, void* stream) {
  return launch(diag, off, out, rotations, work, batch, t, stream);
}
