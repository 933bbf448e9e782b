// Batched SPD inverse + log-determinant, one thread block per matrix.
//
// Replaces the TPU kernel spark_gp_tpu/ops/pallas_linalg.py::_factor_batched
// (body _make_kernel + _mini_chol_inv): for every [n, n] SPD matrix of a
// [B, n, n] float32 batch it returns K^-1 and log|K| in one pass, so the BCM
// likelihood's backward is two batched matmuls and never a triangular solve.
//
// What bounds it on an H100: B * n^3 flops over 2 * B * n^2 * 4 bytes, n / 8
// flops per byte (12.5 at the expert size n = 100), so by the card's peaks
// (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s) the bytes bound it:
// 8.7 us at (366, 100), 0.3 us at (14, 97).  Neither is in reach: one
// matrix is a chain of dependent steps inside one block, and the airfoil
// fold's B = 14 blocks occupy 14 of the 132 SMs, so there the time is one
// block's critical path plus the launch (~1.3 us).  The design therefore
// shortens that path (few barriers, the serial diagonal factor overlapped
// with the parallel work, several independent FMAs per shared load) and
// keeps (366, 100) in one wave (45 KB of shared memory and <= 80 registers
// a thread at n = 100: 3 blocks an SM).
//
// Device times on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, CUDA
// graph replay): this kernel 0.037 ms at (14, 97) and 0.057 ms at
// (366, 100); the first design (csrc/dev/spd_inv_logdet_first.cu) 0.263 and
// 0.423 ms.  That design ran a column-by-column Cholesky with two barriers
// per column (65-70% of its time), W = L^-1 with one thread per column and
// all n^2 dot products of W^T W.  This one is blocked like the TPU kernel,
// with panels of kNB columns (n padded to a multiple of kNB with an
// identity block: log 1 = 0, its rows never written out):
//
//   per panel j, two barriers (28 in all at n = 100, first design ~200):
//   1. (done by the step 3 before) one warp factors the diagonal block in
//      registers, lane i holding row i and every lane the pivots; columns
//      travel by shuffles.  Then lane c solves for column c of L_jj^-1
//      (the TPU kernel's _mini_chol_inv product of elementary factors,
//      column-wise) and stores it over the block, zeros above the
//      diagonal.  log|K| sums the log-pivots in double.
//   2. all threads: the panel L_p = C L_jj^-T, four outputs a thread from
//      float4 rows of C, stored transposed into the upper triangle
//      (U[q][r] = L[r][q]); and, for the rows of earlier panels,
//      M[j, k] = -L_jj^-1 L[j, k] in place of L[j, k] in that upper store.
//   3. all threads, 4 x 4 register micro-tiles over the lower triangle
//      only: the trailing update A22 -= L_p L_p^T (two float4 shared loads
//      feed 16 FMAs), and beside it block row j of W = L^-1,
//      W[j, c] = sum_{c <= k < j} M[j, k] W[k, c] (W[c, c] = L_cc^-1) into
//      the lower triangle, whose old contents no later step reads.  The
//      trailing work shrinks as the W work grows, so the two balance.
//      Warp 0 meanwhile updates the next diagonal block alone and factors
//      it (step 1 of panel j + 1), so the serial factor overlaps the
//      parallel work instead of stalling seven warps.
//   then K^-1 = W^T W over the lower 4 x 4 output tiles only, each element
//   written to (a, b) and (b, a): half the FMAs of the full product and an
//   exactly symmetric result; float4 row stores when n % 4 == 0.
// Panels of 8 beat 16 by 7-8% and 32 by 2x (csrc/dev/k1_variants.json).
// What is left at (14, 97) is the panel loop's latency, ~1.8 us a panel
// with little work a thread between barriers; at (366, 100) the issue rate
// of three blocks an SM.
//
// Every operand stream of steps 2-3 and of W^T W is a float4 from one row
// of shared memory that all threads of a warp read at the same row; the row
// stride ld = np + 4 (a multiple of 4, odd in float4s) keeps the per-thread
// row loads of step 2 free of bank conflicts too.
//
// For 128 < n <= 512 the first design's column kernel runs on a [B, n, n]
// workspace (a shape gate by n, not a fallback; no main path runs it).
//
// Numerics: IEEE float32 FMAs throughout (no TF32); 1 / sqrt(pivot) in the
// diagonal factor is rsqrtf plus one Newton step (factor_diagonal).  A
// non-positive pivot is not clamped: rsqrtf / logf give NaN (or inf) for
// that matrix alone; every other matrix of the batch is computed by its own
// block, untouched.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaxN = 128;  // above this the working copy lives in a workspace
constexpr int kNB = 8;          // panel width
constexpr int kMinBlocks = 3;   // blocks an SM at n <= 128
constexpr unsigned kFull = 0xffffffffu;

static_assert(kNB % 8 == 0 && kNB <= 32, "kNB: a multiple of 8, at most a warp");

__host__ __device__ constexpr int padded(int n) { return (n + kNB - 1) / kNB * kNB; }
// np is a multiple of 8, so ld is 4 mod 8: float4-aligned, odd in float4s
__host__ __device__ constexpr int row_stride(int np) { return np + 4; }

struct Tile {
  float v[4][4];
};

// acc[x][y] = fma(sign * a[x], b[y], acc[x][y])
template <bool kSubtract>
__device__ __forceinline__ void outer4(Tile& acc, const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      acc.v[x][y] = fmaf(kSubtract ? -av[x] : av[x], bv[y], acc.v[x][y]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// (R, C), R >= C, of the t-th tile of a lower triangle in row order
__device__ __forceinline__ void tri_index(int t, int& r, int& c) {
  r = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  c = t - r * (r + 1) / 2;
}

// Step 1, one warp: factor the diagonal block D (lower triangle, row stride
// ld) and overwrite it with L_jj^-1, zeros above the diagonal.  Returns the
// block's sum of log-pivots (every lane the same).
//
// Lane i holds row i of the block; step p broadcasts column p of L by one
// shuffle per row.  Every lane also keeps the whole diagonal of the Schur
// complement, updated from the same broadcasts with the same FMAs as the
// owner lane's row, so the next pivot is in every lane's registers: one
// shuffle, one FMA and one square-root step per column on the critical
// path.  1 / sqrt(pivot) is rsqrtf refined by one Newton step (within
// ~1 ulp of the IEEE quotient, with no division on the path); a pivot
// <= 0 still gives NaN (or inf) and nothing is clamped.
__device__ __forceinline__ double factor_diagonal(float* D, int ld, int lane) {
  const int i = lane < kNB ? lane : kNB - 1;  // lanes past the block mirror the last row
  float a[kNB], dg[kNB];
#pragma unroll
  for (int m = 0; m < kNB; ++m) {
    a[m] = m <= i ? D[i * ld + m] : 0.0f;
    dg[m] = D[m * ld + m];
  }
  float own_rinv = 0.0f;  // 1 / L[i][i]
#pragma unroll
  for (int p = 0; p < kNB; ++p) {
    const float piv = dg[p];
    float r = rsqrtf(piv);
    r *= fmaf(-0.5f * piv * r, r, 1.5f);
    const float l = i > p ? a[p] * r : (i == p ? piv * r : 0.0f);  // L[i][p]
    if (i == p) own_rinv = r;
    a[p] = l;
#pragma unroll
    for (int m = p + 1; m < kNB; ++m) {
      const float lm = __shfl_sync(kFull, l, m);  // L[m][p] from lane m
      a[m] = fmaf(-l, lm, a[m]);
      dg[m] = fmaf(-lm, lm, dg[m]);
    }
  }
  double lsum = 0.0;
#pragma unroll
  for (int p = 0; p < kNB; ++p) lsum += static_cast<double>(logf(dg[p]));
  // row i of L below the diagonal, 1 / L[i][i] on it
  __syncwarp();  // every lane has read the block before any row is stored
  if (lane < kNB) {
#pragma unroll
    for (int m = 0; m < kNB; ++m)
      if (m <= i) D[i * ld + m] = m == i ? own_rinv : a[m];
  }
  __syncwarp();
  // column c = lane of L^-1: x[r] = (delta_rc - sum_{q<r} L[r][q] x[q]) / L[r][r]
  float x[kNB];
#pragma unroll
  for (int r = 0; r < kNB; ++r) {
    float acc = r == i ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < r; ++q) acc = fmaf(-D[r * ld + q], x[q], acc);
    x[r] = acc * D[r * ld + r];
  }
  __syncwarp();  // every lane has read L before any column is stored
  if (lane < kNB) {
#pragma unroll
    for (int r = 0; r < kNB; ++r) D[r * ld + lane] = x[r];
  }
  return lsum;
}

// Step 2, panel: U[s + k][r] = sum_{m <= k} C[r][m] Dinv[k][m], k = k0..k0+3
// (the zeros of Dinv above its diagonal add nothing)
__device__ __forceinline__ void panel_item(float* A, int ld, int s, int r, int k0) {
  const float* c = A + r * ld + s;
  const float* dinv = A + s * ld + s;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int m4 = 0; m4 <= k0; m4 += 4) {
    const float4 cv = ld4(c + m4);
    const float cm[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        acc[kk] = fmaf(cm[mm], dinv[(k0 + kk) * ld + m4 + mm], acc[kk]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) A[(s + k0 + kk) * ld + r] = acc[kk];
}

// Step 2, earlier rows q < s: U[q][s + r] = M^T = -sum_{r' <= r} U[q][s + r'] Dinv[r][r']
__device__ __forceinline__ void m_item(float* A, int ld, int s, int q) {
  float* u = A + q * ld + s;
  const float* dinv = A + s * ld + s;
  float v[kNB];
#pragma unroll
  for (int m4 = 0; m4 < kNB; m4 += 4) {
    const float4 t = ld4(u + m4);
    v[m4] = t.x; v[m4 + 1] = t.y; v[m4 + 2] = t.z; v[m4 + 3] = t.w;
  }
  float out[kNB];
#pragma unroll
  for (int r = 0; r < kNB; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int rr = 0; rr <= r; ++rr) acc = fmaf(v[rr], dinv[r * ld + rr], acc);
    out[r] = -acc;
  }
#pragma unroll
  for (int m4 = 0; m4 < kNB; m4 += 4) st4(u + m4, out[m4], out[m4 + 1], out[m4 + 2], out[m4 + 3]);
}

// Step 3, W: W[r][c] = sum_{q in [cb, s)} M[r][q] W[q][c] for the tile at
// rows r0.., columns c0..; M[r][q] = A[q][r], W[q][c] = A[q][c]
__device__ __forceinline__ void w_tile(float* A, int ld, int s, int r0, int c0) {
  Tile acc = {};
  for (int q = c0 / kNB * kNB; q < s; ++q)
    outer4<false>(acc, ld4(A + q * ld + r0), ld4(A + q * ld + c0));
#pragma unroll
  for (int x = 0; x < 4; ++x)
    st4(A + (r0 + x) * ld + c0, acc.v[x][0], acc.v[x][1], acc.v[x][2], acc.v[x][3]);
}

// Step 3, trailing: A[r][c] -= sum_k L_p[r][k] L_p[c][k], L_p[r][k] = A[s + k][r]
__device__ __forceinline__ void trailing_tile(float* A, int ld, int s, int r0, int c0) {
  Tile acc;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float4 t = ld4(A + (r0 + x) * ld + c0);
    acc.v[x][0] = t.x; acc.v[x][1] = t.y; acc.v[x][2] = t.z; acc.v[x][3] = t.w;
  }
#pragma unroll
  for (int k = 0; k < kNB; ++k)
    outer4<true>(acc, ld4(A + (s + k) * ld + r0), ld4(A + (s + k) * ld + c0));
#pragma unroll
  for (int x = 0; x < 4; ++x)
    st4(A + (r0 + x) * ld + c0, acc.v[x][0], acc.v[x][1], acc.v[x][2], acc.v[x][3]);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
spd_inv_logdet_blocked_kernel(const float* __restrict__ k, float* __restrict__ kinv,
                              float* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) float A[];
  const int np = padded(n), ld = row_stride(np);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* kb = k + blockIdx.x * nn;

  // the lower triangle of K (coalesced, eight loads in flight a thread),
  // then the identity pad
#pragma unroll 8
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int r = idx / n, c = idx - r * n;
    if (c <= r) A[r * ld + c] = kb[idx];
  }
  for (int r = n + warp; r < np; r += kThreads / 32)
    for (int c = lane; c <= r; c += 32) A[r * ld + c] = c == r ? 1.0f : 0.0f;
  __syncthreads();

  // 1. the first diagonal block -> L_00^-1; each later one is factored by
  // warp 0 in step 3 of the panel before it
  double ld_acc = 0.0;
  if (warp == 0) ld_acc += factor_diagonal(A, ld, lane);
  __syncthreads();
  for (int s = 0; s < np; s += kNB) {
    const int e = s + kNB;
    // 2. panel below (rows e..np, four columns an item) and M above (rows 0..s)
    const int rows = np - e, n_panel = rows * (kNB / 4);
    for (int t = tid; t < n_panel + s; t += kThreads) {
      if (t < n_panel) panel_item(A, ld, s, e + t % rows, 4 * (t / rows));
      else m_item(A, ld, s, t - n_panel);
    }
    __syncthreads();
    // 3. warp 0: the trailing update of the next diagonal block (the first
    // kDiagTiles tiles of the trailing triangle), then its factor; the
    // other warps: block row j of W (column blocks 0..j-1) and the rest of
    // the trailing lower triangle
    constexpr int kTilesPerBlock = (kNB / 4) * (kNB / 4);
    constexpr int kDiagTiles = (kNB / 4) * (kNB / 4 + 1) / 2;
    if (warp == 0) {
      if (e < np) {
        for (int t = lane; t < kDiagTiles; t += 32) {
          int tr, tc;
          tri_index(t, tr, tc);
          trailing_tile(A, ld, s, e + 4 * tr, e + 4 * tc);
        }
        __syncwarp();
        ld_acc += factor_diagonal(A + e * ld + e, ld, lane);
      }
    } else {
      const int n_w = (s / kNB) * kTilesPerBlock;
      const int t4 = rows / 4, n_tr = t4 * (t4 + 1) / 2;
      for (int t = tid - 32; t < n_w + n_tr - (rows ? kDiagTiles : 0); t += kThreads - 32) {
        if (t < n_w) {
          const int cb = t / kTilesPerBlock, rem = t % kTilesPerBlock;
          w_tile(A, ld, s, s + 4 * (rem / (kNB / 4)), cb * kNB + 4 * (rem % (kNB / 4)));
        } else {
          int tr, tc;
          tri_index(t - n_w + kDiagTiles, tr, tc);
          trailing_tile(A, ld, s, e + 4 * tr, e + 4 * tc);
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) logdet[blockIdx.x] = static_cast<float>(ld_acc);

  // K^-1 = W^T W over the lower output tiles; W[i][a] = 0 above a's block
  // start except the stored zeros of the diagonal block
  float* out = kinv + blockIdx.x * nn;
  const int t4 = (n + 3) / 4;
  const bool rows4 = n % 4 == 0;
  for (int t = tid; t < t4 * (t4 + 1) / 2; t += kThreads) {
    int tr, tc;
    tri_index(t, tr, tc);
    const int a0 = 4 * tr, b0 = 4 * tc;
    Tile acc = {};
    for (int i = a0 / kNB * kNB; i < n; ++i)
      outer4<false>(acc, ld4(A + i * ld + a0), ld4(A + i * ld + b0));
    if (rows4) {
      // row a0 + x, columns b0..b0+3 (the diagonal tile symmetrized)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float v[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) v[y] = (tr != tc || x >= y) ? acc.v[x][y] : acc.v[y][x];
        st4(out + static_cast<size_t>(a0 + x) * n + b0, v[0], v[1], v[2], v[3]);
        if (tr != tc)
          st4(out + static_cast<size_t>(b0 + x) * n + a0, acc.v[0][x], acc.v[1][x],
              acc.v[2][x], acc.v[3][x]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int a = a0 + x, b = b0 + y;
          if (a < n && (tr != tc || x >= y)) {
            out[static_cast<size_t>(a) * n + b] = acc.v[x][y];
            out[static_cast<size_t>(b) * n + a] = acc.v[x][y];
          }
        }
    }
  }
}

// 128 < n <= 512: the first design's kernel as it was (use_smem = 0: the
// working copy in a [B, n, n] workspace, the diagonal of L in shared
// memory): a column-by-column Cholesky, W = L^-1 one thread a column,
// every element of W^T W.
__global__ void __launch_bounds__(kThreads)
spd_inv_logdet_columns_kernel(const float* __restrict__ k, float* __restrict__ kinv,
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

extern "C" int spd_inv_logdet_f32(const float* k, float* kinv, float* logdet,
                                  float* workspace, int batch, int n,
                                  void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kSmemMaxN) {
    const int np = padded(n);
    const size_t smem = sizeof(float) * static_cast<size_t>(np) * row_stride(np);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(spd_inv_logdet_blocked_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    spd_inv_logdet_blocked_kernel<<<batch, kThreads, smem, st>>>(k, kinv, logdet, n);
  } else {
    if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    spd_inv_logdet_columns_kernel<<<batch, kThreads, sizeof(float) * n, st>>>(
        k, kinv, logdet, workspace, n, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
