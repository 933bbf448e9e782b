// Pairwise squared distances (or inner products) on the TF32 tensor cores:
// the gram stage of the mixed and fast precision lanes.
//
// Replaces no Pallas kernel: it stands for XLA's contractions in the JAX
// package's spark_gp_tpu/ops/distance.py, `_inner` at DEFAULT / HIGH (the
// fast lane) and `_inner_compensated` (the mixed lane's split-bf16 sum).  On
// the card the lane must be an argument of the work, not process state: the
// only precision switch PyTorch has (allow_tf32) is process-wide, and
// torch.matmul on reduced-precision operands rounds its output, which would
// lose the compensated sum.
//
// For `batch` pairs of row-major float32 blocks x1 [n1, p] and x2 [n2, p]
// (batch strides n1 * p and n2 * p), it writes the row-major float32 block
//
//     out[i, j] = max(|x1_i|^2 + |x2_j|^2 - 2 <x1_i, x2_j>, 0)      (distances)
//     out[i, j] = <x1_i, x2_j>                                      (kInner)
//
// with out[i, i] = 0 exactly under kSelf (a self-gram: x1 == x2).  The row
// norms are IEEE float32 sums of squares, as the JAX package's; only the
// inner products run on the tensor cores, in one of two modes:
//
// * kTf32 (1 pass): <hi1, hi2>, with hi = cvt.rna.tf32.f32(x), a TF32
//   operand (10 mantissa bits) rounded to nearest;
// * k3xTf32 (3 passes): <hi1, hi2> + (<hi1, lo2> + <lo1, hi2>), with
//   lo = cvt.rna.tf32.f32(x - hi).  Only <lo1, lo2>, O(2^-22) of the product,
//   is dropped, as `_inner_compensated` drops its lo1 lo2 term.
//
// Every product of two TF32 values is exact in float32; accumulation is
// float32 (the main term and the correction in separate accumulators, added
// at the end as the JAX package brackets them).
//
// Design (a simple correct kernel; wgmma and TMA are for later): one block of
// 4 warps a 64 x 64 output tile, grid (tiles of n2, tiles of n1, batch; a
// batch above gridDim.z loops).  The p axis goes through shared memory in
// chunks of 32 columns, zero-padded to a multiple of 8; each warp owns a
// 32 x 32 quarter of the tile as 2 x 4 `mma.sync.m16n8k8` tiles.  The split
// into hi and lo happens in registers as each fragment is loaded, so a lane
// adds no memory.  The row norms are summed from the same shared chunks, and
// the norms, the clamp and the diagonal are fused into the store.  No host
// read and no allocation: a launch can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // output tile: kTile x kTile
constexpr int kChunk = 32;     // columns of p staged at once
constexpr int kLd = kChunk + 4;  // padded row stride of the staged chunks

enum Flags { kSelf = 1, kInner = 2 };
enum Mode { kTf32 = 0, k3xTf32 = 1 };

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = x rounded to TF32, lo = (x - hi) rounded to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), fp32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
lane_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 float* __restrict__ out, int batch, int n1, int n2, int p, int mode,
                 int flags) {
  __shared__ float as[kTile * kLd];
  __shared__ float bs[kTile * kLd];
  __shared__ float norm1[kTile];
  __shared__ float norm2[kTile];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int group = lane / 4;  // the mma fragments' row group
  const int quad = lane % 4;   // and the thread within it
  const int wm = (warp / 2) * 32;  // this warp's quarter of the tile
  const int wn = (warp % 2) * 32;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const bool three = mode == k3xTf32;
  const bool inner = (flags & kInner) != 0;
  const bool self = (flags & kSelf) != 0;

  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const float* a_blk = x1 + static_cast<size_t>(b) * n1 * p;
    const float* b_blk = x2 + static_cast<size_t>(b) * n2 * p;
    float main_acc[2][4][4];
    float corr_acc[2][4][4];
    for (int mi = 0; mi < 2; ++mi)
      for (int ni = 0; ni < 4; ++ni)
        for (int r = 0; r < 4; ++r) main_acc[mi][ni][r] = corr_acc[mi][ni][r] = 0.0f;
    float norm = 0.0f;  // thread t < 64: row t of x1's tile; else row t - 64 of x2's

    for (int k0 = 0; k0 < p; k0 += kChunk) {
      for (int idx = tid; idx < kTile * kChunk; idx += kThreads) {
        const int r = idx / kChunk;
        const int c = idx % kChunk;
        const int k = k0 + c;
        const int i = row0 + r;
        const int j = col0 + r;
        as[r * kLd + c] = (i < n1 && k < p) ? a_blk[static_cast<size_t>(i) * p + k] : 0.0f;
        bs[r * kLd + c] = (j < n2 && k < p) ? b_blk[static_cast<size_t>(j) * p + k] : 0.0f;
      }
      __syncthreads();
      if (!inner) {
        const float* row = tid < kTile ? as + tid * kLd : bs + (tid - kTile) * kLd;
        for (int c = 0; c < kChunk; ++c) norm += row[c] * row[c];
      }
      const int steps = (p - k0 < kChunk ? p - k0 + 7 : kChunk) / 8;
      for (int s = 0; s < steps; ++s) {
        const int kk = 8 * s;
        uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
        for (int mi = 0; mi < 2; ++mi) {
          const float* base = as + (wm + 16 * mi + group) * kLd + kk + quad;
          const float v[4] = {base[0], base[8 * kLd], base[4], base[8 * kLd + 4]};
          for (int r = 0; r < 4; ++r) split(v[r], a_hi[mi][r], a_lo[mi][r]);
        }
        for (int ni = 0; ni < 4; ++ni) {
          const float* base = bs + (wn + 8 * ni + group) * kLd + kk + quad;
          split(base[0], b_hi[ni][0], b_lo[ni][0]);
          split(base[4], b_hi[ni][1], b_lo[ni][1]);
        }
        for (int mi = 0; mi < 2; ++mi)
          for (int ni = 0; ni < 4; ++ni) {
            mma(main_acc[mi][ni], a_hi[mi], b_hi[ni]);
            if (three) {
              mma(corr_acc[mi][ni], a_hi[mi], b_lo[ni]);
              mma(corr_acc[mi][ni], a_lo[mi], b_hi[ni]);
            }
          }
      }
      __syncthreads();
    }
    if (!inner) {
      if (tid < kTile) norm1[tid] = norm;
      else norm2[tid - kTile] = norm;
    }
    __syncthreads();

    float* o_blk = out + static_cast<size_t>(b) * n1 * n2;
    for (int mi = 0; mi < 2; ++mi)
      for (int ni = 0; ni < 4; ++ni)
        for (int r = 0; r < 4; ++r) {
          const int li = wm + 16 * mi + group + (r >= 2 ? 8 : 0);
          const int lj = wn + 8 * ni + 2 * quad + (r & 1);
          const int i = row0 + li;
          const int j = col0 + lj;
          if (i >= n1 || j >= n2) continue;
          const float dot = main_acc[mi][ni][r] + corr_acc[mi][ni][r];
          float v;
          if (inner) {
            v = dot;
          } else {
            v = fmaxf(norm1[li] + norm2[lj] - 2.0f * dot, 0.0f);
            if (self && i == j) v = 0.0f;
          }
          o_blk[static_cast<size_t>(i) * n2 + j] = v;
        }
    __syncthreads();  // the norms of this batch entry are read before the next's
  }
}

}  // namespace

// x1 [batch, n1, p], x2 [batch, n2, p], out [batch, n1, n2], all contiguous
// float32.  mode: 0 one TF32 pass, 1 3xTF32; flags: 1 a self-gram (zero
// diagonal), 2 inner products in place of distances.
extern "C" int lane_gram_f32(const float* x1, const float* x2, float* out, int batch, int n1,
                             int n2, int p, int mode, int flags, void* stream) {
  if (batch <= 0 || n1 <= 0 || n2 <= 0) return 0;
  if (p < 0 || (mode != kTf32 && mode != k3xTf32) || (flags & ~(kSelf | kInner)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile,
                  batch < 65535 ? batch : 65535);
  lane_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, out, batch, n1, n2, p, mode, flags);
  return static_cast<int>(cudaGetLastError());
}
