// The first design of csrc/spd_inv_logdet.cu, kept as it was so that
// chip_smoke.py and csrc/dev/variants.py build and time it beside the
// current kernel.  Same C entry points.
//
// Batched SPD inverse + log-determinant, one thread block per matrix.
//
// Replaces the TPU kernel spark_gp_tpu/ops/pallas_linalg.py::_factor_batched
// (body _make_kernel + _mini_chol_inv): for every [n, n] SPD matrix of a
// [B, n, n] float32 batch it returns K^-1 and log|K| in one pass, so the BCM
// likelihood's backward is two batched matmuls and never a triangular solve.
//
// What bounds it on an H100: the work is B * n^3 flops over 2 * B * n^2 * 4
// bytes, i.e. n / 8 flops per byte (12.5 at the expert size n = 100), which
// by the card's peaks (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s) is
// memory-bound.  This first version is bound by neither: the Cholesky is a
// column recurrence with two barriers per column, so a block spends most of
// its time waiting at barriers and the rest in shared-memory traffic.  What
// the design does about it: each matrix is read from device memory once and
// K^-1 written once; for n <= 128 every intermediate (L, then W = L^-1) stays
// in shared memory, with an odd row stride so the column-strided accesses of
// the substitution and the W^T W product hit distinct banks; B blocks of
// 256 threads keep several matrices in flight per SM.  A blocked,
// tensor-core (wgmma) design is the later step.
//
// Numerics: IEEE float32 FMAs throughout (no TF32).  A non-positive pivot is
// not clamped: sqrtf / logf give NaN for that matrix alone, and every other
// matrix of the batch is computed by its own block, untouched.
//
// Algorithm, on a working copy A of the lower triangle:
//   1. right-looking Cholesky, column by column: scale column j by
//      1/sqrt(A[j][j]), rank-1 update of the trailing lower triangle;
//      log|K| = sum_j log(A[j][j]) (the pivots are L_jj^2);
//      the diagonal of L is kept in a separate array dL;
//   2. W = L^-1 by forward substitution, thread c owning column c of W,
//      stored transposed in the upper triangle: A[c][i] = W[i][c], i >= c
//      (the strictly-lower L is only read, never overwritten);
//   3. K^-1[a][b] = sum_{i >= max(a,b)} W[i][a] W[i][b]
//               = sum_{i >= max(a,b)} A[a][i] A[b][i], written coalesced and
//      exactly symmetric (the same products in the same order for (a,b) and
//      (b,a)).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaxN = 128;  // above this the working copy lives in a workspace

__global__ void __launch_bounds__(kThreads)
spd_inv_logdet_kernel(const float* __restrict__ k, float* __restrict__ kinv,
                      float* __restrict__ logdet, float* __restrict__ workspace,
                      int n, int use_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* kb = k + b * nn;

  // working copy: odd row stride in shared memory, plain n in the workspace
  const int ld = use_smem ? (n | 1) : n;
  float* dL = smem;  // n floats: diagonal of L
  float* A = use_smem ? smem + n : workspace + b * nn;

  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int r = idx / n, c = idx - r * n;
    if (c <= r) A[r * ld + c] = kb[idx];
  }
  __syncthreads();

  // 1. Cholesky
  double ld_acc = 0.0;
  for (int j = 0; j < n; ++j) {
    const float piv = A[j * ld + j];
    const float d = sqrtf(piv);
    if (tid == 0) {
      dL[j] = d;
      ld_acc += static_cast<double>(logf(piv));
    }
    for (int i = j + 1 + tid; i < n; i += kThreads) A[i * ld + j] /= d;
    __syncthreads();
    const int m = n - j - 1;
    for (int idx = tid; idx < m * m; idx += kThreads) {
      const int r = idx / m, c = idx - r * m;
      if (c <= r) {
        const int i = j + 1 + r, kk = j + 1 + c;
        A[i * ld + kk] = fmaf(-A[i * ld + j], A[kk * ld + j], A[i * ld + kk]);
      }
    }
    __syncthreads();
  }
  if (tid == 0) logdet[b] = static_cast<float>(ld_acc);

  // 2. W = L^-1, column c of W into row c of the upper triangle
  for (int c = tid; c < n; c += kThreads) {
    float* wc = A + c * ld;  // wc[i] = W[i][c]
    wc[c] = 1.0f / dL[c];
    for (int i = c + 1; i < n; ++i) {
      const float* li = A + i * ld;
      float acc = 0.0f;
      for (int q = c; q < i; ++q) acc = fmaf(li[q], wc[q], acc);
      wc[i] = -acc / dL[i];
    }
  }
  __syncthreads();

  // 3. K^-1 = W^T W
  float* out = kinv + b * nn;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int a = idx / n, c = idx - a * n;
    const float* wa = A + a * ld;
    const float* wb = A + c * ld;
    float acc = 0.0f;
    for (int i = (a > c ? a : c); i < n; ++i) acc = fmaf(wa[i], wb[i], acc);
    out[idx] = acc;
  }
}

}  // namespace

// The largest n whose working copy lives in shared memory.  Above it the
// caller passes a [batch, n, n] float workspace; the entry refuses NULL.
extern "C" int spd_inv_logdet_smem_max_n() { return kSmemMaxN; }

// Floats of the workspace the entry needs: [batch, n, n] above kSmemMaxN.
extern "C" long long spd_inv_logdet_workspace_floats(int batch, int n) {
  return n <= kSmemMaxN ? 0 : static_cast<long long>(batch) * n * n;
}

extern "C" int spd_inv_logdet_f32(const float* k, float* kinv, float* logdet,
                                  float* workspace, int batch, int n,
                                  void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int use_smem = n <= kSmemMaxN ? 1 : 0;
  if (!use_smem && workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(n) + (use_smem ? static_cast<size_t>(n) * (n | 1) : 0));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spd_inv_logdet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spd_inv_logdet_kernel<<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      k, kinv, logdet, workspace, n, use_smem);
  return static_cast<int>(cudaGetLastError());
}
