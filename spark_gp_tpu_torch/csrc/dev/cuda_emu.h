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
