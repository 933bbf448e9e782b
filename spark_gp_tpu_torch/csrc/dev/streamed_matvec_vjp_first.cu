// The first design of K2-VJP (and the forward kernel it shipped beside),
// kept so that chip_smoke.py and variants.py can build it and time its VJP
// entry in turns with csrc/streamed_matvec.cu.  A copy of that source
// before the VJP's redesign; one change: the VJP entry takes the scratch
// argument `sqn` of the redesigned entry (and ignores it), so the wrapper
// ops/streamed_matvec.py runs either library.
//
// Streamed gram-matrix product K(theta) @ V and its theta-VJP, never
// materializing K.
//
// Replaces the TPU kernel spark_gp_tpu/ops/pallas_matvec.py::
// _fused_matvec_pallas (body :188-208): for every expert e of an [E, s, p]
// row stack it computes out[e] = K_e(theta) @ V[e] with V [E, s, n], where
// K is an elementwise map of a raw tile -- the squared distance
// |xi|^2 + |xj|^2 - 2<xi, xj> (clamped at 0, the diagonal pinned to 0) or
// the inner product <xi, xj> -- so the [s, s] gram never exists.  The
// second entry is the theta-cotangent of sum(W * (K V)):
//     g_m = sum_e sum_ij <W_ei, V_ej> dk(raw_eij)/dtheta_m,   m < 2,
// which the JAX package leaves to XLA's autodiff of a checkpointed scan.
// Each VJP block writes its partial sums; one reduction over blocks (in the
// wrapper) closes them, so the result does not depend on block order.
//
// What bounds it on an H100: per (i, j) pair the work is p FMAs of the
// inner product, the family's map (one exp for most families) and n FMAs
// of the accumulation; the bytes are only x and V (E s (p + n) floats), so
// the function is bound by operations: E s^2 (2p + 2n + ~10) flops over
// 67 TFLOP/s of f32.  The first forward kernel gave each thread one row and
// read x_j and V_j from shared memory per pair (7 LDS.128 for ~35 FP32
// instructions), ran n = 9 in a 16-wide accumulator, and restaged its own
// rows and the column norms on every column tile.  This one is bound by
// instruction issue: FP32 math plus the address arithmetic of staging, with
// latency that more resident warps hide.
//
// The forward kernel (register tiling).  A block owns 64 rows and 256
// threads as 16 row groups x 16 column groups; each thread owns a 4 x 4
// micro-tile of the pair tile: 4 rows (their squared norms in registers
// for the whole column loop) and 4 columns of each 64-column tile.  Per
// feature it reads one float4 of its rows and one of its columns from
// shared memory and does 16 FMAs; per right-hand side one float4 of V
// feeds 16 FMAs of the accumulator -- a shared load per 16 FMAs instead
// of one per FMA.  The accumulator is exactly as wide as the launch needs
// (templates 1, 4, 8, 9 and 16: y plus 8 probes is 9), so no FMA is spent
// on padding at the path's widths.  Squared norms are computed once per
// call by a small prologue kernel into a scratch vector the wrapper
// passes.  Column tiles (features, V, norms) are double-buffered in shared
// memory and filled by cp.async while the previous tile is computed, with
// one barrier per tile; each thread copies one column of the tile (and one
// row of the block), so its copies share one base address.  The block's
// own rows are staged once when p <= 16 (with the feature chunks of a
// larger p, once per chunk and tile).  exp runs as ex2 on the
// special-function unit.  Three blocks fit on an SM (<= 80 registers),
// two for the 16-wide accumulator, which would spill at 80.
// The 16 partial accumulators of a row meet by warp shuffles (xor
// butterfly, a fixed order) at the end.  FP32 FMAs throughout (no TF32:
// the distance cancels).  The VJP kernel keeps the first design: four
// threads per row, the column tile read from shared memory per pair.
//
// Any s (ragged tiles are zero-filled), any p (features are chunked by
// 16) and any n (right-hand sides are chunked by 16 over gridDim.z).
//
// Families (ids shared with ops/streamed_matvec.py):
//   0 rbf       k = exp(-r / (2 s^2))                          r = sqdist
//   1 matern12  k = exp(-a)                a = sqrt(1 max(r, 1e-24)) / s
//   2 matern32  k = (1 + a) exp(-a)        a = sqrt(3 max(r, 1e-24)) / s
//   3 matern52  k = (1 + a + a^2/3) exp(-a), a = sqrt(5 max(r, 1e-24)) / s
//   4 rq        k = exp(-alpha log(1 + r / (2 alpha s^2)))
//   5 dot       k = s0^2 + r                                   r = inner
//   6 poly      k = (r + c)^degree                             r = inner

#include <cuda_runtime.h>

namespace {

constexpr int kPChunk = 16;                  // features staged at a time
constexpr int kNChunk = 16;                  // right-hand sides per block
constexpr float kR2Floor = 1e-24f;           // Matern sqrt guard
constexpr float kLog2e = 1.4426950408889634f;

// VJP kernel tiling
constexpr int kRows = 64;                    // rows per block
constexpr int kLanes = 4;                    // threads per row
constexpr int kThreads = kRows * kLanes;     // 256
constexpr int kCols = 64;                    // columns per tile
constexpr int kColsPerLane = kCols / kLanes; // 16
constexpr int kStride = 20;                  // shared row stride (floats)

// forward kernel tiling
constexpr int kTM = 4;                               // rows per thread
constexpr int kTN = 4;                               // columns per thread and tile
constexpr int kRowGroups = 16;
constexpr int kColGroups = 16;                       // threads sharing a row
constexpr int kFwdThreads = kRowGroups * kColGroups; // 256
constexpr int kFwdRows = kRowGroups * kTM;           // 64
constexpr int kFwdCols = kColGroups * kTN;           // 64
// blocks an SM must hold: 3 (24 warps, <= 80 registers) up to the 9-wide
// accumulator; the 16-wide one spills at 80, so it takes 2 (<= 128)
constexpr int fwd_min_blocks(int nb) { return nb <= 9 ? 3 : 2; }
static_assert(kTM == 4 && kTN == 4, "the micro-tile is read as float4");
static_assert(kFwdCols % kFwdRows == 0, "a row tile lies inside one column tile");
static_assert(kColGroups <= 32 && 32 % kColGroups == 0, "a row's threads share a warp");

enum Family { kRbf = 0, kM12 = 1, kM32 = 2, kM52 = 3, kRq = 4, kDot = 5, kPoly = 6 };

template <int F>
struct IsSqdist {
  static constexpr bool value = F <= kRq;
};

// per-launch constants of a family, from the device parameter vector;
// `e2` scales the forward map's exponent for exp2f
struct Consts {
  float a, b, c, e2;
};

template <int F>
__device__ __forceinline__ Consts make_consts(const float* __restrict__ params) {
  Consts k{0.f, 0.f, 0.f, 0.f};
  const float p0 = params[0];
  if (F == kRbf) {
    k.a = -0.5f / (p0 * p0);        // exponent factor
    k.b = 1.0f / (p0 * p0 * p0);    // 1 / s^3
    k.e2 = k.a * kLog2e;
  } else if (F == kM12 || F == kM32 || F == kM52) {
    const float nu2 = F == kM12 ? 1.f : (F == kM32 ? 3.f : 5.f);
    k.a = sqrtf(nu2) / p0;          // a = sqrt(r) * k.a
    k.b = 1.0f / p0;
    k.e2 = -kLog2e;
  } else if (F == kRq) {
    const float alpha = params[1];
    k.a = 1.0f / (2.f * alpha * p0 * p0);  // t = r * k.a
    k.b = 1.0f / (p0 * p0 * p0);
    k.c = alpha;
    k.e2 = -alpha * kLog2e;
  } else if (F == kDot) {
    k.a = p0 * p0;
    k.b = 2.f * p0;
  } else {
    k.a = p0;
  }
  return k;
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// k(raw); exp(t) as 2^(t log2 e), the factor folded into k.e2
template <int F>
__device__ __forceinline__ float tile_map(float r, const Consts& k, int degree) {
  if (F == kRbf) return ex2(r * k.e2);
  if (F == kM12 || F == kM32 || F == kM52) {
    const float a = sqrtf(fmaxf(r, kR2Floor)) * k.a;
    const float e = ex2(a * k.e2);
    if (F == kM12) return e;
    if (F == kM32) return (1.f + a) * e;
    return (1.f + a + a * a * (1.f / 3.f)) * e;
  }
  if (F == kRq) return ex2(k.e2 * log1pf(r * k.a));
  if (F == kDot) return k.a + r;
  const float b = r + k.a;
  float out = b;
  for (int d = 1; d < degree; ++d) out *= b;
  return out;
}

// dk/dtheta_m for m < 2, written by hand for each family
template <int F>
__device__ __forceinline__ void tile_deriv(float r, const Consts& k, int degree,
                                           float& d0, float& d1) {
  d1 = 0.f;
  if (F == kRbf) {
    d0 = expf(r * k.a) * r * k.b;                  // k r / s^3
  } else if (F == kM12 || F == kM32 || F == kM52) {
    const float a = sqrtf(fmaxf(r, kR2Floor)) * k.a;
    const float e = expf(-a);
    if (F == kM12) d0 = e * a * k.b;               // a e^-a / s
    else if (F == kM32) d0 = a * a * e * k.b;      // a^2 e^-a / s
    else d0 = a * a * (1.f / 3.f) * (1.f + a) * e * k.b;
  } else if (F == kRq) {
    const float t = r * k.a;
    const float lg = log1pf(t);
    const float kv = expf(-k.c * lg);
    const float b = 1.f + t;
    d0 = kv * r * k.b / b;                         // k r / (b s^3)
    d1 = kv * (t / b - lg);                        // k (t / b - log b)
  } else if (F == kDot) {
    d0 = k.b;                                      // 2 s0
  } else {
    const float b = r + k.a;
    float pw = 1.f;
    for (int d = 1; d < degree; ++d) pw *= b;
    d0 = static_cast<float>(degree) * pw;          // degree b^(degree-1)
  }
}

// ---------------------------------------------------------------------------
// Forward: K @ V, register-tiled.

// squared norm of every row of the [rows, p] stack
__global__ void streamed_matvec_sqnorms_kernel(const float* __restrict__ x,
                                               float* __restrict__ sqn, int rows, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const float* xr = x + static_cast<size_t>(i) * p;
  float acc = 0.f;
  for (int d = 0; d < p; ++d) acc = fmaf(xr[d], xr[d], acc);
  sqn[i] = acc;
}

// One stage of the column pipeline: a feature chunk of the column tile and
// of the block's rows, feature-major; and, on a tile's last chunk, the
// tile's right-hand sides (rhs-major) and squared norms.
template <int NB>
struct __align__(16) FwdStage {
  float xj[kPChunk][kFwdCols];
  float xi[kPChunk][kFwdRows];
  float v[NB][kFwdCols];
  float nj[kFwdCols];
};

// Each thread stages one column of the tile and one row of the block,
// every kColStep-th (kRowStep-th) feature or right-hand side of it, so its
// copies share one base address a step.
constexpr int kColStep = kFwdThreads / kFwdCols;
constexpr int kRowStep = kFwdThreads / kFwdRows;
static_assert(kColStep * kFwdCols == kFwdThreads && kPChunk % kColStep == 0, "column staging");
static_assert(kRowStep * kFwdRows == kFwdThreads && kPChunk % kRowStep == 0, "row staging");

// What one pipeline step stages: column tile j0, features d0 .. d0 + pc,
// the block's rows too when `rows`, V and the norms when `last`.
struct FwdStep {
  int j0, d0, pc;
  bool rows, last;
};

__device__ __forceinline__ unsigned smem_addr(const float* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue one step's copies into a stage; zero beyond s, p and nb.
template <int NB>
__device__ __forceinline__ void fwd_stage(FwdStage<NB>& sh, const FwdStep& st,
                                          const float* __restrict__ xe,
                                          const float* __restrict__ ve,
                                          const float* __restrict__ sqe, int s, int p, int n,
                                          int n0, int nb, int row0, int tid) {
  constexpr int kWord = sizeof(float);
  const int c = tid % kFwdCols, f = tid / kFwdCols, gj = st.j0 + c;
  const bool col_ok = gj < s;
  const float* xsrc = xe + static_cast<size_t>(gj) * p + st.d0 + f;
  const unsigned xdst = smem_addr(&sh.xj[f][c]);
#pragma unroll
  for (int k = 0; k < kPChunk / kColStep; ++k) {
    const bool ok = col_ok && f + k * kColStep < st.pc;
    cp_async4(xdst + k * kColStep * kFwdCols * kWord, ok ? xsrc + k * kColStep : xe, ok);
  }
  if (st.rows) {
    const int r = tid % kFwdRows, fr = tid / kFwdRows;
    const bool row_ok = row0 + r < s;
    const float* rsrc = xe + static_cast<size_t>(row0 + r) * p + st.d0 + fr;
    const unsigned rdst = smem_addr(&sh.xi[fr][r]);
#pragma unroll
    for (int k = 0; k < kPChunk / kRowStep; ++k) {
      const bool ok = row_ok && fr + k * kRowStep < st.pc;
      cp_async4(rdst + k * kRowStep * kFwdRows * kWord, ok ? rsrc + k * kRowStep : xe, ok);
    }
  }
  if (st.last) {
    const float* vsrc = ve + static_cast<size_t>(gj) * n + n0 + f;
    const unsigned vdst = smem_addr(&sh.v[0][c]) + f * kFwdCols * kWord;
#pragma unroll
    for (int k = 0; k < (NB + kColStep - 1) / kColStep; ++k) {
      const int q = f + k * kColStep;
      const bool ok = col_ok && q < nb;
      if (q < NB)
        cp_async4(vdst + k * kColStep * kFwdCols * kWord, ok ? vsrc + k * kColStep : ve, ok);
    }
    if (f == 0) cp_async4(smem_addr(&sh.nj[c]), col_ok ? sqe + gj : sqe, col_ok);
  }
}

// One feature's contribution to the micro-tile's inner products.
__device__ __forceinline__ void fwd_dot_step(const float (*xi)[kFwdRows],
                                             const float (*xj)[kFwdCols], int d, int ty,
                                             int tx, float (&dot)[kTM][kTN]) {
  const float4 a = *reinterpret_cast<const float4*>(&xi[d][ty * kTM]);
  const float4 b = *reinterpret_cast<const float4*>(&xj[d][tx * kTN]);
  const float av[kTM] = {a.x, a.y, a.z, a.w};
  const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < kTN; ++c) dot[m][c] = fmaf(av[m], bv[c], dot[m][c]);
}

// The micro-tile's inner products over one staged chunk of pc features:
// whole groups of four, then the remainder.
__device__ __forceinline__ void fwd_dots(const float (*xi)[kFwdRows],
                                         const float (*xj)[kFwdCols], int pc, int ty, int tx,
                                         float (&dot)[kTM][kTN]) {
#pragma unroll
  for (int d4 = 0; d4 < kPChunk; d4 += 4) {
    if (d4 + 4 <= pc) {
#pragma unroll
      for (int d = d4; d < d4 + 4; ++d) fwd_dot_step(xi, xj, d, ty, tx, dot);
    } else if (d4 < pc) {
#pragma unroll
      for (int d = d4; d < d4 + 3; ++d)
        if (d < pc) fwd_dot_step(xi, xj, d, ty, tx, dot);
    }
  }
}

// Map the micro-tile's raw values and accumulate them against the staged
// right-hand sides.  kPin: the tile holds the block's diagonal, and `pin`
// says this thread's micro-tile does (then its pairs m == c are i == j).
template <int F, int NB, bool kPin>
__device__ __forceinline__ void fwd_accumulate(const float (&dot)[kTM][kTN],
                                               const float (&ni)[kTM],
                                               const FwdStage<NB>& sh, const Consts& k,
                                               int degree, bool pin, int tx,
                                               float (&acc)[kTM][NB]) {
  const float4 n4 = *reinterpret_cast<const float4*>(&sh.nj[tx * kTN]);
  const float nj[kTN] = {n4.x, n4.y, n4.z, n4.w};
  float kv[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      float r = dot[m][c];
      if (IsSqdist<F>::value) {
        r = fmaxf(ni[m] + nj[c] - 2.f * r, 0.f);
        if (kPin && m == c && pin) r = 0.f;
      }
      kv[m][c] = tile_map<F>(r, k, degree);
    }
  }
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const float4 b = *reinterpret_cast<const float4*>(&sh.v[q][tx * kTN]);
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      float a = acc[m][q];
      a = fmaf(kv[m][0], b.x, a);
      a = fmaf(kv[m][1], b.y, a);
      a = fmaf(kv[m][2], b.z, a);
      a = fmaf(kv[m][3], b.w, a);
      acc[m][q] = a;
    }
  }
}

template <int F, int NB>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks(NB))
streamed_matvec_kernel(const float* __restrict__ x, const float* __restrict__ sqn,
                       const float* __restrict__ v, const float* __restrict__ params,
                       float* __restrict__ out, int s, int p, int n, int degree) {
  __shared__ FwdStage<NB> stage[2];

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups, ty = tid / kColGroups;
  const int row0 = blockIdx.x * kFwdRows;
  const int e = blockIdx.y;
  const int n0 = blockIdx.z * kNChunk;
  const int nb = min(NB, n - n0);
  const float* xe = x + static_cast<size_t>(e) * s * p;
  const float* ve = v + static_cast<size_t>(e) * s * n;
  const float* sqe = sqn + static_cast<size_t>(e) * s;
  const Consts k = make_consts<F>(params);

  float ni[kTM];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int row = row0 + ty * kTM + m;
    ni[m] = row < s ? sqe[row] : 0.f;
  }
  float acc[kTM][NB];
  float dot[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
#pragma unroll
    for (int q = 0; q < NB; ++q) acc[m][q] = 0.f;
#pragma unroll
    for (int c = 0; c < kTN; ++c) dot[m][c] = 0.f;
  }

  // steps: (column tile, feature chunk), chunk-minor; the rows are staged
  // once (into stage 0) when there is one chunk, else with every step
  const int nchunk = (p + kPChunk - 1) / kPChunk;
  const int nsteps = ((s + kFwdCols - 1) / kFwdCols) * nchunk;
  const bool one_chunk = nchunk == 1;
  FwdStep cur{0, 0, min(kPChunk, p), true, one_chunk};
  fwd_stage<NB>(stage[0], cur, xe, ve, sqe, s, p, n, n0, nb, row0, tid);
  cp_async_wait_all();
  __syncthreads();

  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    FwdStep next = cur;
    next.d0 += kPChunk;
    if (next.d0 >= p) {
      next.d0 = 0;
      next.j0 += kFwdCols;
    }
    next.pc = min(kPChunk, p - next.d0);
    next.rows = !one_chunk;
    next.last = next.d0 + kPChunk >= p;
    const bool more = step + 1 < nsteps;
    if (more) fwd_stage<NB>(stage[buf ^ 1], next, xe, ve, sqe, s, p, n, n0, nb, row0, tid);

    const FwdStage<NB>& sh = stage[buf];
    const FwdStage<NB>& rows_sh = stage[one_chunk ? 0 : buf];
    fwd_dots(rows_sh.xi, sh.xj, cur.pc, ty, tx, dot);
    if (cur.last) {
      const int off = row0 - cur.j0;  // the diagonal sits at column off + row
      if (IsSqdist<F>::value && off >= 0 && off < kFwdCols)
        fwd_accumulate<F, NB, true>(dot, ni, sh, k, degree, tx == ty + off / kTN, tx, acc);
      else
        fwd_accumulate<F, NB, false>(dot, ni, sh, k, degree, false, tx, acc);
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int c = 0; c < kTN; ++c) dot[m][c] = 0.f;
    }

    cp_async_wait_all();
    __syncthreads();
    cur = next;
  }

  // the 16 threads of a row group are neighbours in one warp: an xor
  // butterfly leaves every one of them the same total
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1)
        acc[m][q] += __shfl_xor_sync(0xffffffffu, acc[m][q], off);
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int row = row0 + ty * kTM + m;
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if ((m * NB + q) % kColGroups == tx && q < nb && row < s)
        out[(static_cast<size_t>(e) * s + row) * n + n0 + q] = acc[m][q];
  }
}

// ---------------------------------------------------------------------------
// VJP: the theta-cotangent, four threads per row.

// Stage one feature chunk of the block's rows and of a column tile; thread
// tid < kCols adds its column's squared norm over the chunk to `nj`.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ xe, int s, int p,
                                            int row0, int j0, int d0, int pc,
                                            float* xi_s, float* xj_s, int tid,
                                            float& nj) {
  __syncthreads();
  for (int idx = tid; idx < kRows * kPChunk; idx += kThreads) {
    const int r = idx / kPChunk, d = idx - r * kPChunk;
    const int gi = row0 + r, gj = j0 + r;
    xi_s[r * kStride + d] = (gi < s && d < pc) ? xe[static_cast<size_t>(gi) * p + d0 + d] : 0.f;
    xj_s[r * kStride + d] = (gj < s && d < pc) ? xe[static_cast<size_t>(gj) * p + d0 + d] : 0.f;
  }
  __syncthreads();
  if (tid < kCols) {
    for (int d = 0; d < pc; ++d) {
      const float xv = xj_s[tid * kStride + d];
      nj = fmaf(xv, xv, nj);
    }
  }
}

// Inner products of the thread's row with its 16 columns over one staged
// chunk; the row's squared norm too when `with_norm`.
__device__ __forceinline__ void chunk_dots(const float* xi_s, const float* xj_s, int rl,
                                           int q, int pc, bool with_norm,
                                           float (&dot)[kColsPerLane], float& ni) {
  for (int d4 = 0; d4 < pc; d4 += 4) {
    const float4 a = *reinterpret_cast<const float4*>(&xi_s[rl * kStride + d4]);
    if (with_norm) ni += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const float4 b =
          *reinterpret_cast<const float4*>(&xj_s[(q + kLanes * c) * kStride + d4]);
      dot[c] = fmaf(a.x, b.x, dot[c]);
      dot[c] = fmaf(a.y, b.y, dot[c]);
      dot[c] = fmaf(a.z, b.z, dot[c]);
      dot[c] = fmaf(a.w, b.w, dot[c]);
    }
  }
}

// The raw tile value of (row, column gj) from the inner product.
template <int F>
__device__ __forceinline__ float raw_value(float dot, float ni, float nj, int row, int gj) {
  if (!IsSqdist<F>::value) return dot;
  const float r = fmaxf(ni + nj - 2.f * dot, 0.f);
  return row == gj ? 0.f : r;
}

// Stage the column tile's right-hand sides [kCols, NB] and squared norms.
template <int NB>
__device__ __forceinline__ void stage_rhs(const float* __restrict__ ve, int s, int n,
                                          int j0, int n0, int nb, float* vj_s,
                                          float* nj_s, float nj, int tid) {
  if (tid < kCols) nj_s[tid] = nj;
  for (int idx = tid; idx < kCols * NB; idx += kThreads) {
    const int c = idx / NB, q = idx - c * NB;
    const int gj = j0 + c;
    vj_s[c * kStride + q] =
        (gj < s && q < nb) ? ve[static_cast<size_t>(gj) * n + n0 + q] : 0.f;
  }
  __syncthreads();
}

template <int F, int NB>
__global__ void __launch_bounds__(kThreads)
streamed_matvec_vjp_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ v, const float* __restrict__ params,
                           float* __restrict__ partial, int s, int p, int n, int degree) {
  __shared__ __align__(16) float xi_s[kRows * kStride];
  __shared__ __align__(16) float xj_s[kCols * kStride];
  __shared__ __align__(16) float vj_s[kCols * kStride];
  __shared__ float nj_s[kCols];
  __shared__ float red_s[2 * kThreads / 32];

  const int tid = threadIdx.x;
  const int rl = tid / kLanes, q = tid - rl * kLanes;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + rl;
  const int e = blockIdx.y;
  const int n0 = blockIdx.z * kNChunk;
  const int nb = min(NB, n - n0);
  const float* xe = x + static_cast<size_t>(e) * s * p;
  const float* ve = v + static_cast<size_t>(e) * s * n;
  const Consts k = make_consts<F>(params);

  // the row's cotangent W_i, zero beyond s and beyond n
  float wi[NB];
#pragma unroll
  for (int t = 0; t < NB; ++t)
    wi[t] = (row < s && t < nb) ? w[(static_cast<size_t>(e) * s + row) * n + n0 + t] : 0.f;

  float g0 = 0.f, g1 = 0.f, ni = 0.f;
  for (int j0 = 0; j0 < s; j0 += kCols) {
    float dot[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) dot[c] = 0.f;
    float nj = 0.f;
    for (int d0 = 0; d0 < p; d0 += kPChunk) {
      const int pc = min(kPChunk, p - d0);
      stage_chunk(xe, s, p, row0, j0, d0, pc, xi_s, xj_s, tid, nj);
      chunk_dots(xi_s, xj_s, rl, q, pc, j0 == 0, dot, ni);
    }
    stage_rhs<NB>(ve, s, n, j0, n0, nb, vj_s, nj_s, nj, tid);
    if (row < s) {
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int cl = q + kLanes * c;
        const int gj = j0 + cl;
        if (gj < s) {
          const float* vr = &vj_s[cl * kStride];
          float wv = 0.f;
#pragma unroll
          for (int t = 0; t < NB; ++t) wv = fmaf(wi[t], vr[t], wv);
          float d0v, d1v;
          tile_deriv<F>(raw_value<F>(dot[c], ni, nj_s[cl], row, gj), k, degree, d0v, d1v);
          g0 = fmaf(wv, d0v, g0);
          g1 = fmaf(wv, d1v, g1);
        }
      }
    }
  }

  // block reduction: warps by shuffles, then the warp sums in shared memory
  for (int off = 16; off > 0; off >>= 1) {
    g0 += __shfl_xor_sync(0xffffffffu, g0, off);
    g1 += __shfl_xor_sync(0xffffffffu, g1, off);
  }
  const int warp = tid / 32;
  if ((tid & 31) == 0) {
    red_s[2 * warp] = g0;
    red_s[2 * warp + 1] = g1;
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = 0.f, t1 = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) {
      t0 += red_s[2 * i];
      t1 += red_s[2 * i + 1];
    }
    const size_t b = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
                     blockIdx.x;
    partial[2 * b] = t0;
    partial[2 * b + 1] = t1;
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct Args {
  const float* x;
  const float* w;     // VJP only
  const float* v;
  const float* params;
  const float* sqn;   // forward only
  float* out;
  int batch, s, p, n, degree;
  cudaStream_t stream;
};

dim3 grid_for(const Args& a, int rows) {
  return dim3((a.s + rows - 1) / rows, a.batch, (a.n + kNChunk - 1) / kNChunk);
}

template <int F>
struct Forward {
  template <int NB>
  static cudaError_t launch(const Args& a) {
    streamed_matvec_kernel<F, NB><<<grid_for(a, kFwdRows), kFwdThreads, 0, a.stream>>>(
        a.x, a.sqn, a.v, a.params, a.out, a.s, a.p, a.n, a.degree);
    return cudaGetLastError();
  }
  // the accumulator exactly as wide as the path's widths (1, 8, 9)
  static cudaError_t run(const Args& a) {
    if (a.n <= 1) return launch<1>(a);
    if (a.n <= 4) return launch<4>(a);
    if (a.n <= 8) return launch<8>(a);
    if (a.n == 9) return launch<9>(a);
    return launch<16>(a);
  }
};

template <int F>
struct Vjp {
  template <int NB>
  static cudaError_t launch(const Args& a) {
    streamed_matvec_vjp_kernel<F, NB><<<grid_for(a, kRows), kThreads, 0, a.stream>>>(
        a.x, a.w, a.v, a.params, a.out, a.s, a.p, a.n, a.degree);
    return cudaGetLastError();
  }
  static cudaError_t run(const Args& a) {
    if (a.n <= 1) return launch<1>(a);
    if (a.n <= 4) return launch<4>(a);
    if (a.n <= 8) return launch<8>(a);
    return launch<16>(a);
  }
};

template <template <int> class Op>
cudaError_t by_family(int family, const Args& a) {
  switch (family) {
    case kRbf: return Op<kRbf>::run(a);
    case kM12: return Op<kM12>::run(a);
    case kM32: return Op<kM32>::run(a);
    case kM52: return Op<kM52>::run(a);
    case kRq: return Op<kRq>::run(a);
    case kDot: return Op<kDot>::run(a);
    case kPoly: return Op<kPoly>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int batch, int p, int family, int degree) {
  return p > 0 && degree >= 1 && batch <= 65535 && family >= kRbf && family <= kPoly;
}

}  // namespace

// Rows per forward block (the row tile); the wrapper checks it against its own.
extern "C" int streamed_matvec_row_tile() { return kFwdRows; }

// Number of [2]-float partial sums the VJP entry writes (one per block).
extern "C" long long streamed_matvec_vjp_blocks(int batch, int s, int n) {
  return static_cast<long long>((s + kRows - 1) / kRows) * batch * ((n + kNChunk - 1) / kNChunk);
}

// out [batch, s, n] = K(params) @ v, x [batch, s, p], v [batch, s, n];
// params: device pointer to the family's 1 or 2 float parameters;
// sqn: [batch, s] scratch for the rows' squared norms.
extern "C" int streamed_matvec_f32(const float* x, const float* v, const float* params,
                                   float* sqn, float* out, int batch, int s, int p, int n,
                                   int family, int degree, void* stream) {
  if (batch <= 0 || s <= 0 || n <= 0) return 0;
  if (!valid(batch, p, family, degree)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, nullptr, v, params, sqn, out, batch, s, p, n, degree,
               static_cast<cudaStream_t>(stream)};
  const int rows = batch * s;
  streamed_matvec_sqnorms_kernel<<<(rows + 255) / 256, 256, 0, a.stream>>>(x, sqn, rows, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(by_family<Forward>(family, a));
}

// partial [streamed_matvec_vjp_blocks(batch, s, n), 2]: per-block sums of
// <W_i, V_j> dk_ij/dtheta_m; their sum over blocks is the theta-cotangent
// of sum(W * (K V)).
extern "C" int streamed_matvec_vjp_f32(const float* x, const float* w, const float* v,
                                       const float* params, float* /*sqn*/, float* partial,
                                       int batch, int s, int p, int n, int family, int degree,
                                       void* stream) {
  if (batch <= 0 || s <= 0 || n <= 0) return 0;
  if (!valid(batch, p, family, degree)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, v, params, nullptr, partial, batch, s, p, n, degree,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(by_family<Vjp>(family, a));
}
