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
// Each block writes its partial sums; one reduction over blocks (in the
// wrapper) closes them, so the result does not depend on block order.
//
// What bounds it on an H100: per (i, j) pair the work is p FMAs of the
// inner product, the family's map (one exp for most families) and n FMAs
// of the accumulation; the bytes are only x and V (E s (p + n) floats),
// so it is bound by operations: E s^2 (2p + 2n + ~10) flops over 67 TFLOP/s
// of f32, and E s^2 exp over the special-function units.  What the design
// does about it: a block owns 64 rows; four threads share a row, each
// taking every fourth column of a 64-column tile, so 256 threads work per
// block and E * s / 64 blocks fill the card at s in the thousands.  Column
// tiles of x (16 features at a time) and V (up to 16 right-hand sides) are
// staged in shared memory with a row stride of 20 floats, so the float4
// reads of four neighbouring columns hit distinct banks; each thread keeps
// its 16 inner products and its accumulator in registers, and the four
// partial accumulators of a row meet by warp shuffles at the end.  FP32
// FMAs throughout (no TF32).  A wgmma/TMA design is the later step.
//
// Any s (ragged tiles are bounds-checked), any p (features are chunked by
// 16) and any n (right-hand sides are chunked by 16 over gridDim.z; the
// accumulator width is a template parameter, 1, 4, 8 or 16, the smallest
// that holds n).
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

constexpr int kRows = 64;                    // rows per block
constexpr int kLanes = 4;                    // threads per row
constexpr int kThreads = kRows * kLanes;     // 256
constexpr int kCols = 64;                    // columns per tile
constexpr int kColsPerLane = kCols / kLanes; // 16
constexpr int kPChunk = 16;                  // features staged at a time
constexpr int kNChunk = 16;                  // right-hand sides per block
constexpr int kStride = 20;                  // shared row stride (floats)
constexpr float kR2Floor = 1e-24f;           // Matern sqrt guard

enum Family { kRbf = 0, kM12 = 1, kM32 = 2, kM52 = 3, kRq = 4, kDot = 5, kPoly = 6 };

template <int F>
struct IsSqdist {
  static constexpr bool value = F <= kRq;
};

// per-launch constants of a family, from the device parameter vector
struct Consts {
  float a, b, c;
};

template <int F>
__device__ __forceinline__ Consts make_consts(const float* __restrict__ params) {
  Consts k{0.f, 0.f, 0.f};
  const float p0 = params[0];
  if (F == kRbf) {
    k.a = -0.5f / (p0 * p0);        // exponent factor
    k.b = 1.0f / (p0 * p0 * p0);    // 1 / s^3
  } else if (F == kM12 || F == kM32 || F == kM52) {
    const float nu2 = F == kM12 ? 1.f : (F == kM32 ? 3.f : 5.f);
    k.a = sqrtf(nu2) / p0;          // a = sqrt(r) * k.a
    k.b = 1.0f / p0;
  } else if (F == kRq) {
    const float alpha = params[1];
    k.a = 1.0f / (2.f * alpha * p0 * p0);  // t = r * k.a
    k.b = 1.0f / (p0 * p0 * p0);
    k.c = alpha;
  } else if (F == kDot) {
    k.a = p0 * p0;
    k.b = 2.f * p0;
  } else {
    k.a = p0;
  }
  return k;
}

// k(raw)
template <int F>
__device__ __forceinline__ float tile_map(float r, const Consts& k, int degree) {
  if (F == kRbf) return expf(r * k.a);
  if (F == kM12 || F == kM32 || F == kM52) {
    const float a = sqrtf(fmaxf(r, kR2Floor)) * k.a;
    const float e = expf(-a);
    if (F == kM12) return e;
    if (F == kM32) return (1.f + a) * e;
    return (1.f + a + a * a * (1.f / 3.f)) * e;
  }
  if (F == kRq) return expf(-k.c * log1pf(r * k.a));
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
streamed_matvec_kernel(const float* __restrict__ x, const float* __restrict__ v,
                       const float* __restrict__ params, float* __restrict__ out,
                       int s, int p, int n, int degree) {
  __shared__ __align__(16) float xi_s[kRows * kStride];
  __shared__ __align__(16) float xj_s[kCols * kStride];
  __shared__ __align__(16) float vj_s[kCols * kStride];
  __shared__ float nj_s[kCols];

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

  float acc[NB];
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = 0.f;
  float ni = 0.f;

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
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int cl = q + kLanes * c;
      const int gj = j0 + cl;
      if (gj < s) {
        const float kv = tile_map<F>(raw_value<F>(dot[c], ni, nj_s[cl], row, gj), k, degree);
        const float* vr = &vj_s[cl * kStride];
#pragma unroll
        for (int t = 0; t < NB; ++t) acc[t] = fmaf(kv, vr[t], acc[t]);
      }
    }
  }

  // the four lanes of a row are neighbours in one warp
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 1);
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 2);
  }
  if (row < s && q == 0) {
    float* o = out + (static_cast<size_t>(e) * s + row) * n + n0;
    for (int t = 0; t < nb; ++t) o[t] = acc[t];
  }
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

template <int F, int NB>
cudaError_t launch(const float* x, const float* w, const float* v, const float* params,
                   float* out, int batch, int s, int p, int n, int degree, bool vjp,
                   cudaStream_t stream) {
  const dim3 grid((s + kRows - 1) / kRows, batch, (n + kNChunk - 1) / kNChunk);
  if (vjp)
    streamed_matvec_vjp_kernel<F, NB><<<grid, kThreads, 0, stream>>>(x, w, v, params, out, s,
                                                                    p, n, degree);
  else
    streamed_matvec_kernel<F, NB><<<grid, kThreads, 0, stream>>>(x, v, params, out, s, p, n,
                                                                degree);
  return cudaGetLastError();
}

template <int F>
cudaError_t dispatch_width(const float* x, const float* w, const float* v,
                           const float* params, float* out, int batch, int s, int p, int n,
                           int degree, bool vjp, cudaStream_t stream) {
  if (n <= 1) return launch<F, 1>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream);
  if (n <= 4) return launch<F, 4>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream);
  if (n <= 8) return launch<F, 8>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream);
  return launch<F, 16>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream);
}

int run(const float* x, const float* w, const float* v, const float* params, float* out,
        int batch, int s, int p, int n, int family, int degree, bool vjp, void* stream_ptr) {
  if (batch <= 0 || s <= 0 || n <= 0) return 0;
  if (p <= 0 || degree < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (family) {
    case kRbf: err = dispatch_width<kRbf>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    case kM12: err = dispatch_width<kM12>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    case kM32: err = dispatch_width<kM32>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    case kM52: err = dispatch_width<kM52>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    case kRq: err = dispatch_width<kRq>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    case kDot: err = dispatch_width<kDot>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    case kPoly: err = dispatch_width<kPoly>(x, w, v, params, out, batch, s, p, n, degree, vjp, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// Rows per block (the row tile); the wrapper checks it against its own.
extern "C" int streamed_matvec_row_tile() { return kRows; }

// Number of [2]-float partial sums the VJP entry writes (one per block).
extern "C" long long streamed_matvec_vjp_blocks(int batch, int s, int n) {
  return static_cast<long long>((s + kRows - 1) / kRows) * batch * ((n + kNChunk - 1) / kNChunk);
}

// out [batch, s, n] = K(params) @ v, x [batch, s, p], v [batch, s, n];
// params: device pointer to the family's 1 or 2 float parameters.
extern "C" int streamed_matvec_f32(const float* x, const float* v, const float* params,
                                   float* out, int batch, int s, int p, int n, int family,
                                   int degree, void* stream) {
  return run(x, nullptr, v, params, out, batch, s, p, n, family, degree, false, stream);
}

// partial [streamed_matvec_vjp_blocks(batch, s, n), 2]: per-block sums of
// <W_i, V_j> dk_ij/dtheta_m; their sum over blocks is the theta-cotangent
// of sum(W * (K V)).
extern "C" int streamed_matvec_vjp_f32(const float* x, const float* w, const float* v,
                                       const float* params, float* partial, int batch, int s,
                                       int p, int n, int family, int degree, void* stream) {
  return run(x, w, v, params, partial, batch, s, p, n, family, degree, true, stream);
}
