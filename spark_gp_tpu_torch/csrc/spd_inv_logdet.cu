// Batched SPD inverse + log-determinant.
//
// Replaces the TPU kernel spark_gp_tpu/ops/pallas_linalg.py::_factor_batched
// (body _make_kernel + _mini_chol_inv): for every [n, n] SPD matrix of a
// [B, n, n] float32 batch it returns K^-1 and log|K| in one pass, so the BCM
// likelihood's backward is two batched matmuls and never a triangular solve.
// Two designs, chosen by n (a shape gate, fixed here; no fallback):
//
// n <= 128: one thread block per matrix, the matrix in shared memory.
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
// a thread at n = 100: 3 blocks an SM).  It is blocked like the TPU kernel,
// with panels of kNB columns (n padded to a multiple of kNB with an
// identity block: log 1 = 0, its rows never written out):
//
//   per panel j, two barriers (28 in all at n = 100):
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
// Every operand stream of steps 2-3 and of W^T W is a float4 from one row
// of shared memory that all threads of a warp read at the same row; the row
// stride ld = np + 4 (a multiple of 4, odd in float4s) keeps the per-thread
// row loads of step 2 free of bank conflicts too.  Panels of 8 beat 16 by
// 7-8% and 32 by 2x.
//
// 128 < n <= 512: many blocks a matrix, on a workspace (the tiled path
// below).  It replaces the first design's column kernel, one block a matrix
// on a [B, n, n] workspace (csrc/dev/spd_inv_logdet_first.cu): 132 SMs and
// one, or three, at work; two barriers per column; W = L^-1 one thread a
// column; every element of W^T W.  Its Cholesky was 45-59% of its time,
// W 13-20%, W^T W 24-40%.  The bound here is B n^3 flops at the f32 peak
// (2.0 us at (1, 512), 89 us at (91, 403)), far below what a chain of nt
// dependent panels can reach at B = 1: there the time is the panels'
// latency.  The design: the TPU kernel's blocked right-looking Cholesky
// fused with blocked inversion, each step a launch of one block per
// kT x kT tile of every matrix, so B = 1 fills tens of SMs; W = L^-1
// right-looking too (Z accumulators), so every block but one does a
// single tile product and the update launch lasts as long as the
// look-ahead factor of the next diagonal tile (the n <= 128 panel loop on
// a 32 x 32 tile, in the same launch); then K^-1 = W^T W over lower tiles.
// 31 launches at n = 451, 33 at 512.  Tiles of 32 beat 64 by 4-20% (twice the
// panels, a quarter the factor's work), a 32-row stage beats 16 by 1-3%;
// the whole tile factored by one warp (factor_diagonal at width 32) is
// 5-7% faster at B <= 3 and 14% slower at (91, 403) (255 registers).
// What bounds it now (csrc/dev/k1_variants.json): at (3, 451) the 15
// diagonal factors, ~6.4 us each, are half the time, the 31 launches 0.03
// ms, W^T W 0.01 ms; at (91, 403) W^T W takes 0.16 of 0.54 ms (its 1.4 G
// FMAs at a quarter of the f32 peak, output row a a chain of nt - a tile
// products), the factors 0.04, the launches 0.07.
//
// Every time and ratio in this note was taken on an "NVIDIA H100 80GB
// HBM3, 700.00 W" (nvidia-smi) by chip_smoke.py or csrc/dev/variants.py.
// Device times (CUDA graph replay), against the first design and
// `cholesky` + `cholesky_inverse` in the same run: (14, 97) 0.0365 ms (first 0.263);
// (366, 100) 0.0564 (0.423); (2, 256) 0.0995 (5.575; library 2.598);
// (1, 512) 0.191 (51.86; 0.636); (3, 451) 0.192 (29.99; 5.140); (91, 403)
// 0.535 (21.55; 11.44).
//
// Numerics: IEEE float32 FMAs throughout (no TF32); 1 / sqrt(pivot) in the
// diagonal factor is rsqrtf plus one Newton step (factor_diagonal); log|K|
// summed in double, in a fixed order (no atomics).  A non-positive pivot
// is not clamped: rsqrtf / logf give NaN (or inf) for that matrix alone;
// every other matrix of the batch is computed by its own blocks, untouched.

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

// Step 1, one warp: factor the kW x kW diagonal block D (lower triangle, row
// stride ld) and overwrite it with L_jj^-1, zeros above the diagonal.  Returns the
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
template <int kW>
__device__ __forceinline__ double factor_diagonal(float* D, int ld, int lane) {
  const int i = lane < kW ? lane : kW - 1;  // lanes past the block mirror the last row
  float a[kW], dg[kW];
#pragma unroll
  for (int m = 0; m < kW; ++m) {
    a[m] = m <= i ? D[i * ld + m] : 0.0f;
    dg[m] = D[m * ld + m];
  }
  float own_rinv = 0.0f;  // 1 / L[i][i]
#pragma unroll
  for (int p = 0; p < kW; ++p) {
    const float piv = dg[p];
    float r = rsqrtf(piv);
    r *= fmaf(-0.5f * piv * r, r, 1.5f);
    const float l = i > p ? a[p] * r : (i == p ? piv * r : 0.0f);  // L[i][p]
    if (i == p) own_rinv = r;
    a[p] = l;
#pragma unroll
    for (int m = p + 1; m < kW; ++m) {
      const float lm = __shfl_sync(kFull, l, m);  // L[m][p] from lane m
      a[m] = fmaf(-l, lm, a[m]);
      dg[m] = fmaf(-lm, lm, dg[m]);
    }
  }
  double lsum = 0.0;
#pragma unroll
  for (int p = 0; p < kW; ++p) lsum += static_cast<double>(logf(dg[p]));
  // row i of L below the diagonal, 1 / L[i][i] on it
  __syncwarp();  // every lane has read the block before any row is stored
  if (lane < kW) {
#pragma unroll
    for (int m = 0; m < kW; ++m)
      if (m <= i) D[i * ld + m] = m == i ? own_rinv : a[m];
  }
  __syncwarp();
  // column c = lane of L^-1: x[r] = (delta_rc - sum_{q<r} L[r][q] x[q]) / L[r][r]
  float x[kW];
#pragma unroll
  for (int r = 0; r < kW; ++r) {
    float acc = r == i ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < r; ++q) acc = fmaf(-D[r * ld + q], x[q], acc);
    x[r] = acc * D[r * ld + r];
  }
  __syncwarp();  // every lane has read L before any column is stored
  if (lane < kW) {
#pragma unroll
    for (int r = 0; r < kW; ++r) D[r * ld + lane] = x[r];
  }
  return lsum;
}

// Step 2, panel: U[s + k][r] = sum_{m <= k} C[r][m] Dinv[k][m], k = k0..k0+3
// (the zeros of Dinv above its diagonal add nothing)
template <int kW>
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
template <int kW>
__device__ __forceinline__ void m_item(float* A, int ld, int s, int q) {
  float* u = A + q * ld + s;
  const float* dinv = A + s * ld + s;
  float v[kW];
#pragma unroll
  for (int m4 = 0; m4 < kW; m4 += 4) {
    const float4 t = ld4(u + m4);
    v[m4] = t.x; v[m4 + 1] = t.y; v[m4 + 2] = t.z; v[m4 + 3] = t.w;
  }
  float out[kW];
#pragma unroll
  for (int r = 0; r < kW; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int rr = 0; rr <= r; ++rr) acc = fmaf(v[rr], dinv[r * ld + rr], acc);
    out[r] = -acc;
  }
#pragma unroll
  for (int m4 = 0; m4 < kW; m4 += 4) st4(u + m4, out[m4], out[m4 + 1], out[m4 + 2], out[m4 + 3]);
}

// Step 3, W: W[r][c] = sum_{q in [cb, s)} M[r][q] W[q][c] for the tile at
// rows r0.., columns c0..; M[r][q] = A[q][r], W[q][c] = A[q][c]
template <int kW>
__device__ __forceinline__ void w_tile(float* A, int ld, int s, int r0, int c0) {
  Tile acc = {};
  for (int q = c0 / kW * kW; q < s; ++q)
    outer4<false>(acc, ld4(A + q * ld + r0), ld4(A + q * ld + c0));
#pragma unroll
  for (int x = 0; x < 4; ++x)
    st4(A + (r0 + x) * ld + c0, acc.v[x][0], acc.v[x][1], acc.v[x][2], acc.v[x][3]);
}

// Step 3, trailing: A[r][c] -= sum_k L_p[r][k] L_p[c][k], L_p[r][k] = A[s + k][r]
template <int kW>
__device__ __forceinline__ void trailing_tile(float* A, int ld, int s, int r0, int c0) {
  Tile acc;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float4 t = ld4(A + (r0 + x) * ld + c0);
    acc.v[x][0] = t.x; acc.v[x][1] = t.y; acc.v[x][2] = t.z; acc.v[x][3] = t.w;
  }
#pragma unroll
  for (int k = 0; k < kW; ++k)
    outer4<true>(acc, ld4(A + (s + k) * ld + r0), ld4(A + (s + k) * ld + c0));
#pragma unroll
  for (int x = 0; x < 4; ++x)
    st4(A + (r0 + x) * ld + c0, acc.v[x][0], acc.v[x][1], acc.v[x][2], acc.v[x][3]);
}

// Steps 1-3 over the whole of an np x np SPD matrix in shared memory (row
// stride ld, its lower triangle in A, np a multiple of kW), in panels of kW
// (kNB for the blocked kernel), by the block's kNT threads: on return the lower triangle holds W = L^-1 (each diagonal
// block L_jj^-1 with zeros above its diagonal), the strict upper triangle
// outside the diagonal blocks M^T.  Returns the sum of log-pivots in warp 0
// (every lane), 0 in the other warps.
template <int kNT, int kW>
__device__ __forceinline__ double factor_invert(float* A, int ld, int np) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 1. the first diagonal block -> L_00^-1; each later one is factored by
  // warp 0 in step 3 of the panel before it
  double ld_acc = 0.0;
  if (warp == 0) ld_acc += factor_diagonal<kW>(A, ld, lane);
  __syncthreads();
  for (int s = 0; s < np; s += kW) {
    const int e = s + kW;
    // 2. panel below (rows e..np, four columns an item) and M above (rows 0..s)
    const int rows = np - e, n_panel = rows * (kW / 4);
    for (int t = tid; t < n_panel + s; t += kNT) {
      if (t < n_panel) panel_item<kW>(A, ld, s, e + t % rows, 4 * (t / rows));
      else m_item<kW>(A, ld, s, t - n_panel);
    }
    __syncthreads();
    // 3. warp 0: the trailing update of the next diagonal block (the first
    // kDiagTiles tiles of the trailing triangle), then its factor; the
    // other warps: block row j of W (column blocks 0..j-1) and the rest of
    // the trailing lower triangle
    constexpr int kTilesPerBlock = (kW / 4) * (kW / 4);
    constexpr int kDiagTiles = (kW / 4) * (kW / 4 + 1) / 2;
    if (warp == 0) {
      if (e < np) {
        for (int t = lane; t < kDiagTiles; t += 32) {
          int tr, tc;
          tri_index(t, tr, tc);
          trailing_tile<kW>(A, ld, s, e + 4 * tr, e + 4 * tc);
        }
        __syncwarp();
        ld_acc += factor_diagonal<kW>(A + e * ld + e, ld, lane);
      }
    } else {
      const int n_w = (s / kW) * kTilesPerBlock;
      const int t4 = rows / 4, n_tr = t4 * (t4 + 1) / 2;
      for (int t = tid - 32; t < n_w + n_tr - (rows ? kDiagTiles : 0); t += kNT - 32) {
        if (t < n_w) {
          const int cb = t / kTilesPerBlock, rem = t % kTilesPerBlock;
          w_tile<kW>(A, ld, s, s + 4 * (rem / (kW / 4)), cb * kW + 4 * (rem % (kW / 4)));
        } else {
          int tr, tc;
          tri_index(t - n_w + kDiagTiles, tr, tc);
          trailing_tile<kW>(A, ld, s, e + 4 * tr, e + 4 * tc);
        }
      }
    }
    __syncthreads();
  }
  return ld_acc;
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

  // 1-3. the panel loop -> W = L^-1 in the lower triangle
  const double ld_acc = factor_invert<kThreads, kNB>(A, ld, np);
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

// ---- 128 < n <= 512: tiles of a [B, np, np] workspace, many blocks a matrix ----
//
// np = n padded to kT with an identity block, nt = np / kT tiles a side.
// Tile (I, J) of a matrix's workspace is rows I kT.., columns J kT...  The
// upper tiles (J >= I) hold the Schur complement transposed (U(l, i) =
// A[i, l]^T, the diagonal tiles whole), then L^T of each panel in place;
// the lower tiles (i, c) hold Z[i, c] = sum_{c <= k < i} L[i, k] W[k, c],
// then W[i, c] = -L_ii^-1 Z[i, c] in place; the diagonal tiles L_jj^-1
// with zeros above.  Every product is acc[r][c] +-= sum_q X[q][r] Y[q][c]
// over rows of two tiles (a 4 x 4 register tile a thread, operands staged
// kKC rows at a time):
//   load      U(l, i) from K's lower triangle; the block of tile (0, 0)
//             factors it (factor_tile)
//   panel j   L[t, j]^T = L_jj^-1 U(j, t) in place for t > j; W[j, c] =
//             -L_jj^-1 Z[j, c] in place for c < j
//   update j  U(l, i) -= L[l, j] L[i, j]^T for j < l <= i, the block of
//             U(j + 1, j + 1) then factoring it (the look-ahead); Z[i, c]
//             += L[i, j] W[j, c] for i > j >= c: one tile product a block
//   inverse   K^-1[a, b] = sum_{i >= a} W[i, a]^T W[i, b], a >= b, stored
//             to (a, b) and (b, a); log|K| from the tiles' partial sums
constexpr int kT = 32;                            // tile (panel) width
constexpr int kTThreads = (kT / 4) * (kT / 4);    // a 4 x 4 register tile each
constexpr int kKC = 32;                           // contraction rows a stage
constexpr int kTileNB = kNB;                      // panel width of a tile's factor
constexpr int kTileLd = row_stride(kT);           // a tile being factored
constexpr int kStageFloats = kKC * kT;            // one operand, one stage
constexpr int kWsSmemFloats =
    4 * kStageFloats > kT * kTileLd ? 4 * kStageFloats : kT * kTileLd;

static_assert(kT % kTileNB == 0 && kT % kKC == 0 && kTThreads % 32 == 0 && kTThreads >= 64,
              "kT: a multiple of kTileNB and kKC, at least 32");
static_assert(kTileNB % 8 == 0 && kTileNB <= 32, "kTileNB: a multiple of 8, at most a warp");

__host__ __device__ constexpr int ws_padded(int n) { return (n + kT - 1) / kT * kT; }

// the workspace floats: [B, np, np] tiles, [B, nt, kT, kT] L_jj^-T, [B, nt]
// double log-pivot sums
__host__ __device__ constexpr size_t ws_floats(int batch, int n) {
  return static_cast<size_t>(batch) *
         (static_cast<size_t>(ws_padded(n)) * ws_padded(n) +
          static_cast<size_t>(ws_padded(n) / kT) * (kT * kT + 2));
}

struct Workspace {
  const float* k;
  float* kinv;
  float* logdet;
  float* a;         // [B, np, np]
  float* dinvt;     // [B, nt, kT, kT]: L_jj^-T, zeros below its diagonal
  double* partial;  // [B, nt]: each diagonal tile's sum of log-pivots
  int batch, n, np, nt;

  // matrix b's tile (i, j), and its L_jj^-T
  __device__ float* tile(int b, int i, int j) const {
    return a + (static_cast<size_t>(b) * np + i * kT) * np + j * kT;
  }
  __device__ float* dinvt_of(int b, int j) const {
    return dinvt + (static_cast<size_t>(b) * nt + j) * kT * kT;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's 4 x 4 tile of a kT x kT tile: rows 4 ty.., columns 4 tx..
__device__ __forceinline__ int tile_x() { return threadIdx.x % (kT / 4); }
__device__ __forceinline__ int tile_y() { return threadIdx.x / (kT / 4); }

// rows q0..q0+kKC of X and Y into one stage (X first)
__device__ __forceinline__ void stage_rows(float* buf, const float* x, int ldx, const float* y,
                                           int ldy) {
  for (int v = threadIdx.x; v < kStageFloats / 4; v += kTThreads) {
    const int q = v / (kT / 4), c = 4 * (v % (kT / 4));
    cp_async16(buf + q * kT + c, x + q * ldx + c);
    cp_async16(buf + kStageFloats + q * kT + c, y + q * ldy + c);
  }
}

// acc[x][y] +-= sum_{k < tiles} sum_q X_k[q][4 ty + x] Y_k[q][4 tx + y] with
// X_k = x0 + k xstep (row stride ldx), Y_k likewise: two float4 shared loads
// feed 16 FMAs; the next stage is copied while this one is used, one
// barrier a stage.
template <bool kSubtract>
__device__ __forceinline__ void tile_product(Tile& acc, const float* x0, int ldx, size_t xstep,
                                             const float* y0, int ldy, size_t ystep, int tiles,
                                             float* stage) {
  constexpr int kChunks = kT / kKC;
  const int tx = tile_x(), ty = tile_y(), steps = tiles * kChunks;
  stage_rows(stage, x0, ldx, y0, ldy);
  cp_async_wait_all();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const float* cur = stage + (step & 1) * 2 * kStageFloats;
    const int next = step + 1;
    if (next < steps) {
      const int k = next / kChunks, q0 = next % kChunks * kKC;
      stage_rows(stage + (next & 1) * 2 * kStageFloats, x0 + k * xstep + q0 * ldx, ldx,
                 y0 + k * ystep + q0 * ldy, ldy);
    }
#pragma unroll
    for (int q = 0; q < kKC; ++q)
      outer4<kSubtract>(acc, ld4(cur + q * kT + 4 * ty), ld4(cur + kStageFloats + q * kT + 4 * tx));
    cp_async_wait_all();
    __syncthreads();
  }
}

__device__ __forceinline__ void load_tile(Tile& acc, const float* src, int ld) {
  const int tx = tile_x(), ty = tile_y();
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float4 t = ld4(src + (4 * ty + x) * ld + 4 * tx);
    acc.v[x][0] = t.x; acc.v[x][1] = t.y; acc.v[x][2] = t.z; acc.v[x][3] = t.w;
  }
}

__device__ __forceinline__ void store_tile(float* dst, int ld, const Tile& acc) {
  const int tx = tile_x(), ty = tile_y();
#pragma unroll
  for (int x = 0; x < 4; ++x)
    st4(dst + (4 * ty + x) * ld + 4 * tx, acc.v[x][0], acc.v[x][1], acc.v[x][2], acc.v[x][3]);
}

// Block blockIdx.x of a launch: tile t of matrix b, the batch fastest, so
// tile 0 of every matrix (a launch's longest block) starts first.
__device__ __forceinline__ void block_tile(const Workspace& w, int& b, int& t) {
  t = blockIdx.x / w.batch;
  b = blockIdx.x - t * w.batch;
}

// Diagonal tile j of matrix b, its final Schur complement in sm (row
// stride kTileLd): factored and inverted by the panel loop above; L_jj^-1
// (zeros above the diagonal) over tile (j, j), its transpose to dinvt, its
// log-pivots to partial[j].
__device__ void factor_tile(const Workspace& w, float* sm, int b, int j) {
  const double lsum = factor_invert<kTThreads, kTileNB>(sm, kTileLd, kT);
  float* d = w.tile(b, j, j);
  float* dt = w.dinvt_of(b, j);
  for (int e = threadIdx.x; e < kT * kT; e += kTThreads) {
    const int r = e / kT, c = e % kT;
    d[r * w.np + c] = c <= r ? sm[r * kTileLd + c] : 0.0f;
    dt[e] = r <= c ? sm[c * kTileLd + r] : 0.0f;
  }
  if (threadIdx.x == 0) w.partial[b * w.nt + j] = lsum;
}

// nt (nt + 1) / 2 blocks a matrix: upper tile (l, i) from K's lower
// triangle (identity beyond n); block 0 builds tile (0, 0) in shared
// memory and factors it
__global__ void __launch_bounds__(kTThreads, 2) spd_inv_logdet_ws_load_kernel(Workspace w) {
  extern __shared__ __align__(16) float sm[];
  const int n = w.n, tid = threadIdx.x;
  int b, t, i, l;
  block_tile(w, b, t);
  tri_index(t, i, l);
  const float* kb = w.k + static_cast<size_t>(b) * n * n;
  const int r0 = i * kT, c0 = l * kT;
  if (i == l) {
    // the diagonal tile whole: K[max][min]
    for (int e = tid; e < kT * kT; e += kTThreads) {
      const int r = e / kT, c = e % kT, gr = r0 + (r > c ? r : c), gc = r0 + (r > c ? c : r);
      const float v = gr < n ? kb[gr * n + gc] : (r == c ? 1.0f : 0.0f);
      if (t == 0) sm[r * kTileLd + c] = v;
      else w.tile(b, i, i)[r * w.np + c] = v;
    }
    if (t == 0) {
      __syncthreads();
      factor_tile(w, sm, b, 0);
    }
    return;
  }
  // rows of K's tile (i, l) into shared memory, then written transposed
  constexpr int ld = kT + 1;
  for (int e = tid; e < kT * kT; e += kTThreads) {
    const int r = e / kT, c = e % kT;
    sm[r * ld + c] = r0 + r < n ? kb[(r0 + r) * n + c0 + c] : 0.0f;
  }
  __syncthreads();
  float* u = w.tile(b, l, i);
  for (int e = tid; e < kT * kT; e += kTThreads) {
    const int c = e / kT, r = e % kT;
    u[c * w.np + r] = sm[r * ld + c];
  }
}

// nt - 1 blocks a matrix, panel j: block t < j: W[j, t] = -L_jj^-1 Z[j, t]
// in place; block t >= j, for tile row t + 1 > j: L^T = L_jj^-1 U(j, t + 1)
// in place
__global__ void __launch_bounds__(kTThreads, 2) spd_inv_logdet_ws_panel_kernel(Workspace w, int j) {
  extern __shared__ __align__(16) float stage[];
  int b, t;
  block_tile(w, b, t);
  float* out = t < j ? w.tile(b, j, t) : w.tile(b, j, t + 1);
  Tile acc = {};
  if (t < j) tile_product<true>(acc, w.dinvt_of(b, j), kT, 0, out, w.np, 0, 1, stage);
  else tile_product<false>(acc, w.dinvt_of(b, j), kT, 0, out, w.np, 0, 1, stage);
  store_tile(out, w.np, acc);
}

// m (m + 1) / 2 + m (j + 1) blocks a matrix, m = nt - 1 - j > 0, update j:
// block 0 the trailing tile U(j + 1, j + 1), then its factor; blocks 1 ..
// the other trailing tiles U(l, i); the rest Z[i, c] += L[i, j] W[j, c]
// (W[j, j] = L_jj^-1 starts it)
__global__ void __launch_bounds__(kTThreads, 2) spd_inv_logdet_ws_update_kernel(Workspace w, int j) {
  extern __shared__ __align__(16) float stage[];
  const int m = w.nt - 1 - j, n_tr = m * (m + 1) / 2;
  int b, t;
  block_tile(w, b, t);
  Tile acc;
  if (t >= n_tr) {
    const int i = j + 1 + (t - n_tr) / (j + 1), c = (t - n_tr) % (j + 1);
    float* z = w.tile(b, i, c);
    if (c < j) load_tile(acc, z, w.np);
    else acc = Tile{};
    tile_product<false>(acc, w.tile(b, j, i), w.np, 0, w.tile(b, j, c), w.np, 0, 1, stage);
    store_tile(z, w.np, acc);
    return;
  }
  int ti, tl;
  tri_index(t, ti, tl);
  const int l = j + 1 + tl, i = j + 1 + ti;
  load_tile(acc, w.tile(b, l, i), w.np);
  tile_product<true>(acc, w.tile(b, j, l), w.np, 0, w.tile(b, j, i), w.np, 0, 1, stage);
  if (t > 0) {
    store_tile(w.tile(b, l, i), w.np, acc);
    return;
  }
  store_tile(stage, kTileLd, acc);  // the staging buffers are free again
  __syncthreads();
  factor_tile(w, stage, b, j + 1);
}

// nt (nt + 1) / 2 blocks a matrix: K^-1 tile (a, c), a >= c, into (a, c)
// and (c, a) (a diagonal tile from its lower half, so exactly symmetric);
// block 0 also sums the log-pivots in tile order
__global__ void __launch_bounds__(kTThreads, 2) spd_inv_logdet_ws_inverse_kernel(Workspace w) {
  extern __shared__ __align__(16) float stage[];
  const int n = w.n;
  const size_t down = static_cast<size_t>(kT) * w.np;
  int b, t, a, c;
  block_tile(w, b, t);
  tri_index(t, a, c);
  Tile acc = {};
  tile_product<false>(acc, w.tile(b, a, a), w.np, down, w.tile(b, a, c), w.np, down, w.nt - a,
                      stage);
  float* out = w.kinv + static_cast<size_t>(b) * n * n;
  const int r0 = a * kT + 4 * tile_y(), c0 = c * kT + 4 * tile_x();
  if (a != c && n % 4 == 0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (r0 + x < n && c0 < n)
        st4(out + static_cast<size_t>(r0 + x) * n + c0, acc.v[x][0], acc.v[x][1], acc.v[x][2],
            acc.v[x][3]);
      if (c0 + x < n && r0 < n)
        st4(out + static_cast<size_t>(c0 + x) * n + r0, acc.v[0][x], acc.v[1][x], acc.v[2][x],
            acc.v[3][x]);
    }
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int r = r0 + x, col = c0 + y;
        if (r < n && col < n && (a != c || r >= col)) {
          out[static_cast<size_t>(r) * n + col] = acc.v[x][y];
          out[static_cast<size_t>(col) * n + r] = acc.v[x][y];
        }
      }
  }
  if (t == 0 && threadIdx.x == 0) {
    double sum = 0.0;
    for (int j = 0; j < w.nt; ++j) sum += w.partial[b * w.nt + j];
    w.logdet[b] = static_cast<float>(sum);
  }
}

}  // namespace

// The largest n whose working copy lives in shared memory.
extern "C" int spd_inv_logdet_smem_max_n() { return kSmemMaxN; }

// Floats of the workspace the entry needs for a [batch, n, n] stack (0 for
// n <= kSmemMaxN); the caller allocates it and the entry refuses NULL.
extern "C" long long spd_inv_logdet_workspace_floats(int batch, int n) {
  return n <= kSmemMaxN ? 0 : static_cast<long long>(ws_floats(batch, n));
}

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
    return static_cast<int>(cudaGetLastError());
  }
  if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int np = ws_padded(n), nt = np / kT;
  const size_t tiles = static_cast<size_t>(batch) * np * np;
  Workspace w{k, kinv, logdet, workspace, workspace + tiles,
              reinterpret_cast<double*>(workspace + tiles + static_cast<size_t>(batch) * nt * kT * kT),
              batch, n, np, nt};
  const size_t smem = sizeof(float) * kWsSmemFloats;
  const int tri = nt * (nt + 1) / 2;
  spd_inv_logdet_ws_load_kernel<<<batch * tri, kTThreads, smem, st>>>(w);
  for (int j = 0; j < nt; ++j) {
    const int m = nt - 1 - j;
    spd_inv_logdet_ws_panel_kernel<<<batch * (nt - 1), kTThreads, smem, st>>>(w, j);
    if (m > 0)
      spd_inv_logdet_ws_update_kernel<<<batch * (m * (m + 1) / 2 + m * (j + 1)), kTThreads, smem,
                                        st>>>(w, j);
  }
  spd_inv_logdet_ws_inverse_kernel<<<batch * tri, kTThreads, smem, st>>>(w);
  return static_cast<int>(cudaGetLastError());
}
