// A CUDA grid on the CPU, for checking the logic of the kernels in csrc/
// with g++ -std=c++20 -pthread where there is no card and no nvcc.
//
// One std::thread per CUDA thread, a block's threads along x only; the
// blocks of a launch (a grid in x and y) run one after another.
// __syncthreads is a std::barrier of the block, a named barrier
// (bar_sync) one of its own count, and every warp intrinsic an exchange
// through the warp's 32 slots between two waits on the warp's barrier, so
// a warp's lanes run in lockstep at each intrinsic, as on the card. A
// thread that returns drops out of its block's and its warp's barriers.
// __shared__ arrays become statics (one block runs at a time); dynamic
// shared memory is a zeroed buffer per block. The sources stay as nvcc
// reads them: a text pass (tests/test_torch_chain_emul.py) includes this
// header in place of <cuda_runtime.h>, turns `extern __shared__ T x[];`
// into a pointer to dynamic_smem() and each `k<<<g, b, smem, s>>>(...)`
// into launch(k, g, b, smem, s, ...). The launch checks what the card
// checks: at most 1024 threads a block, and dynamic shared memory over
// 48 KB only up to the limit set with cudaFuncSetAttribute (at most
// 227 KB); a refused launch runs nothing and sets cudaGetLastError().
#pragma once

#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define MM2T_CUDA_EMUL 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) longlong2 {
  long long x, y;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// f32 arithmetic rounds after every op when built with -ffp-contract=off
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
// cvt.rzi.s32.f32: toward zero, saturating, NaN -> 0
inline int __float2int_rz(float x) {
  if (std::isnan(x)) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return (int)x;
}
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int x;
  std::memcpy(&x, &f, sizeof x);
  return x;
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline unsigned long long __brevll(unsigned long long x) {
  unsigned long long r = 0;
  for (int i = 0; i < 64; ++i, x >>= 1) r = r << 1 | (x & 1);
  return r;
}
// shared memory is one block's statics, written by its std::threads at once
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}

namespace mm2t_emul {

constexpr int kMaxDynamicSmem = 232448;  // a block's 227 KB
constexpr int kDefaultDynamicSmem = 48 * 1024;

struct Block {
  explicit Block(unsigned threads, size_t smem)
      : all(threads), smem_buf((smem + 15) / 16 + 1) {
    const unsigned warps = (threads + 31) / 32;
    for (unsigned w = 0; w < warps; ++w)
      warp.emplace_back(std::make_unique<std::barrier<>>(
          std::min(32u, threads - 32 * w)));
    slots.resize(warps);
  }
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<std::array<long long, 32>> slots;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
  std::mutex named_mu;
  std::vector<int4> smem_buf;  // 16-byte aligned, zeroed
};

inline thread_local Block* cur = nullptr;
inline cudaError_t last_error = cudaSuccess;
inline std::map<const void*, int> dyn_limit;

inline void* dynamic_smem() { return cur->smem_buf.data(); }

// every lane's v, after the whole warp has given its own
template <class T>
std::array<T, 32> warp_values(T v) {
  Block& b = *cur;
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  b.slots[w][lane] = (long long)v;
  b.warp[w]->arrive_and_wait();
  std::array<T, 32> out{};
  for (int l = 0; l < 32; ++l) out[l] = (T)b.slots[w][l];
  b.warp[w]->arrive_and_wait();  // the slots may be reused from here
  return out;
}

inline void bar_sync(int id, int count) {
  Block& b = *cur;
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> g(b.named_mu);
    auto& p = b.named[id];
    if (!p) p = std::make_unique<std::barrier<>>(count);
    bar = p.get();
  }
  bar->arrive_and_wait();
}

template <class... P, class... Args>
void launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
            cudaStream_t, Args... args) {
  const auto it = dyn_limit.find((const void*)kernel);
  const size_t limit = it == dyn_limit.end() ? kDefaultDynamicSmem : it->second;
  if (block.x * block.y * block.z > 1024 || block.y != 1 || block.z != 1 ||
      grid.y > 65535 || grid.z != 1) {
    last_error = cudaErrorInvalidConfiguration;
    return;
  }
  if (smem > limit) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block blk(block.x, smem);
      std::vector<std::thread> threads;
      threads.reserve(block.x);
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t, bx, by] {
          cur = &blk;
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          blockDim = block;
          gridDim = grid;
          kernel(static_cast<P>(args)...);
          blk.warp[t / 32]->arrive_and_drop();
          blk.all.arrive_and_drop();
        });
      for (auto& th : threads) th.join();
    }
}

}  // namespace mm2t_emul

inline void __syncthreads() { mm2t_emul::cur->all.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  mm2t_emul::cur->warp[threadIdx.x / 32]->arrive_and_wait();
}
// the sources pass the full mask to every warp intrinsic
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  return mm2t_emul::warp_values(v)[(threadIdx.x % 32) ^ o];
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return mm2t_emul::warp_values(v)[src];
}
// lanes below `delta` keep their own value, as on the card
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  const auto all = mm2t_emul::warp_values(v);
  return lane >= delta ? all[lane - delta] : v;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const auto all = mm2t_emul::warp_values(pred != 0);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)all[l] << l;
  return m;
}
inline int __any_sync(unsigned, int pred) {
  const auto all = mm2t_emul::warp_values(pred != 0);
  return std::any_of(all.begin(), all.end(), [](bool b) { return b; });
}
template <class T>
inline T __reduce_max_sync(unsigned, T v) {
  const auto all = mm2t_emul::warp_values(v);
  return *std::max_element(all.begin(), all.end());
}

template <class F>
inline cudaError_t cudaFuncSetAttribute(F* kernel, cudaFuncAttribute, int bytes) {
  if (bytes < 0 || bytes > mm2t_emul::kMaxDynamicSmem) return cudaErrorInvalidValue;
  mm2t_emul::dyn_limit[(const void*)kernel] = bytes;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = mm2t_emul::last_error;
  mm2t_emul::last_error = cudaSuccess;
  return e;
}
