// CPU emulation of the CUDA subset used by the kernels: each block runs as
// blockDim.x std::threads with a real barrier; warp shuffles through a
// shared slot array and per-warp barriers; dynamic shared memory is one
// buffer, the launch's bytes of it used (blocks run one after another).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct uint3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
// one SM: a kernel that sizes its grid by the card gets few blocks, each of
// which does much of the work (blocks run one after another here anyway)
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 1;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }

inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* g_block_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bar;
inline float g_shfl[1024];
// emulate.py turns `extern __shared__ T name[];` into a pointer to this;
// each block starts with the launch's bytes of it all NaN, so a read of a
// word never written shows.  A static array (a block's most, 227 KB), so it
// lies near g_shared_base below and cp.async can address it.
inline constexpr size_t kEmuSharedBytes = 232448;
alignas(16) inline float4 g_dynamic_shared[kEmuSharedBytes / sizeof(float4)];
inline void* emu_dynamic_shared() { return g_dynamic_shared; }

inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x;
  g_shfl[t] = v;
  g_warp_bar[t / 32]->arrive_and_wait();
  const float r = g_shfl[t ^ off];
  g_warp_bar[t / 32]->arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int t = threadIdx.x;
  g_shfl[t] = v;
  g_warp_bar[t / 32]->arrive_and_wait();
  const float r = g_shfl[t / 32 * 32 + (src & 31)];
  g_warp_bar[t / 32]->arrive_and_wait();
  return r;
}
inline int min(int a, int b) { return a < b ? a : b; }
// the card's rsqrtf is an approximation (relative error up to ~2^-22.9);
// here off by 2^-22, so code that refines it is checked for doing so
inline float rsqrtf(float x) {
  return static_cast<float>((1.0 + 0x1p-22) / std::sqrt(static_cast<double>(x)));
}

// Shared addresses are 32 bits on the card; here they are offsets from one
// variable of the library, which every __shared__ (a static) lies near.
inline char g_shared_base;
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(reinterpret_cast<intptr_t>(p) -
                             reinterpret_cast<intptr_t>(&g_shared_base));
}
inline void* emu_shared(unsigned addr) {
  return reinterpret_cast<void*>(reinterpret_cast<intptr_t>(&g_shared_base) +
                                 static_cast<int32_t>(addr));
}

// Inline PTX: emulate.py turns `asm("op.a.b %0, ...")` into emu_op_a_b(...).
inline void emu_ex2_approx_ftz_f32(float& y, float x) { y = exp2f(x); }
// cp.async: `bytes` copied, the first `src_bytes` of them read from src, the
// rest zero-filled; done at once, so waiting is a no-op
inline void emu_cp_async_ca_shared_global(unsigned dst, const void* src, int bytes,
                                          int src_bytes) {
  std::memset(emu_shared(dst), 0, bytes);
  std::memcpy(emu_shared(dst), src, src_bytes);
}
inline void emu_cp_async_cg_shared_global(unsigned dst, const void* src, int bytes) {
  std::memcpy(emu_shared(dst), src, bytes);
}
inline void emu_cp_async_wait_all() {}

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
// cvt.rna.tf32.f32: round to TF32 (10 mantissa bits), nearest, ties away
// from zero: the low 13 bits of the magnitude rounded off
inline void emu_cvt_rna_tf32_f32(uint32_t& r, float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  r = (u + 0x1000u) & ~0x1FFFu;
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: the warp's 32 threads
// post their fragments, then each computes its four accumulators (PTX ISA
// fragment layouts: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8,
// q + 4); b0 (k = q, n = g), b1 (k = q + 4, n = g); c_r (g + 8 (r >= 2),
// 2 q + (r & 1)), with g = lane / 4, q = lane % 4), float32 sums in k order
inline uint32_t g_mma_a[1024][4];
inline uint32_t g_mma_b[1024][2];
inline void emu_mma_sync_aligned_m16n8k8_row_col_f32_tf32_tf32_f32(
    float& d0, float& d1, float& d2, float& d3, uint32_t a0, uint32_t a1, uint32_t a2,
    uint32_t a3, uint32_t b0, uint32_t b1, float c0, float c1, float c2, float c3) {
  const unsigned t = threadIdx.x, base = t / 32 * 32, lane = t % 32;
  g_mma_a[t][0] = a0; g_mma_a[t][1] = a1; g_mma_a[t][2] = a2; g_mma_a[t][3] = a3;
  g_mma_b[t][0] = b0; g_mma_b[t][1] = b1;
  __syncwarp();
  const unsigned g = lane / 4, q = lane % 4;
  const float c[4] = {c0, c1, c2, c3};
  float d[4];
  for (unsigned r = 0; r < 4; ++r) {
    const unsigned row = g + (r >= 2 ? 8 : 0), col = 2 * q + (r & 1);
    float acc = c[r];
    for (unsigned k = 0; k < 8; ++k) {
      const float a = __uint_as_float(
          g_mma_a[base + (row % 8) * 4 + k % 4][(row >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0)]);
      const float b = __uint_as_float(g_mma_b[base + col * 4 + k % 4][k >= 4 ? 1 : 0]);
      acc += a * b;
    }
    d[r] = acc;
  }
  __syncwarp();
  d0 = d[0]; d1 = d[1]; d2 = d[2]; d3 = d[3];
}

template <class F>
void emu_launch(F f, dim3 g, dim3 b, size_t shared_bytes = 0, cudaStream_t = nullptr) {
  gridDim = g;
  blockDim = b;
  const float nan = std::nanf("");
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        blockIdx.x = x; blockIdx.y = y; blockIdx.z = z;
        if (shared_bytes > kEmuSharedBytes) std::abort();
        std::fill_n(g_dynamic_shared, (shared_bytes + sizeof(float4) - 1) / sizeof(float4),
                    float4{nan, nan, nan, nan});
        std::barrier<> bar(b.x);
        g_block_bar = &bar;
        g_warp_bar.clear();
        for (unsigned w = 0; w < (b.x + 31) / 32; ++w)
          g_warp_bar.emplace_back(new std::barrier<>(b.x - 32 * w < 32 ? b.x - 32 * w : 32));
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < b.x; ++t)
          ts.emplace_back([&, t] { threadIdx.x = t; f(); });
        for (auto& th : ts) th.join();
      }
}
