// The CUDA runtime as the CPU emulation of tests/_cuda_emulation.py sees it:
// a block's threads run as std::threads, one block after another;
// __syncthreads() and __syncwarp() are barriers of the block and of its
// warps, shuffles go through per-warp slots between two warp barriers, and
// a thread that returns leaves its barriers. Launches, copies and memory
// are synchronous and on the host.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <class S>
inline cudaError_t cudaMemcpyToSymbol(S& sym, const void* src, size_t n) {
    std::memcpy(&sym, src, n);
    return cudaSuccess;
}
template <class S>
inline cudaError_t cudaMemcpyFromSymbol(void* dst, const S& sym, size_t n) {
    std::memcpy(dst, &sym, n);
    return cudaSuccess;
}

inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline long long clock64() { return 0; }
inline std::mutex emu_atomic_mutex;
template <class T> inline T atomicAdd(T* p, T v) {
    std::lock_guard<std::mutex> g(emu_atomic_mutex);
    const T old = *p;
    *p = old + v;
    return old;
}

struct EmuBlock {
    std::unique_ptr<std::barrier<>> block;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::vector<uint32_t> slots;
};
inline EmuBlock* emu_block = nullptr;
inline int emu_tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
inline void __syncthreads() { emu_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warps[emu_tid() / 32]->arrive_and_wait(); }

template <class T> inline T emu_shfl(T v, int src, bool keep_outside) {
    const int tid = emu_tid(), lane = tid % 32;
    uint32_t* s = &emu_block->slots[tid / 32 * 32];
    std::memcpy(&s[lane], &v, 4);
    __syncwarp();
    T out = v;
    if (!(keep_outside && (src < 0 || src > 31))) std::memcpy(&out, &s[src & 31], 4);
    __syncwarp();
    return out;
}
template <class T> inline T __shfl_down_sync(unsigned, T v, int delta) {
    return emu_shfl(v, emu_tid() % 32 + delta, true);
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int mask) {
    return emu_shfl(v, (emu_tid() % 32) ^ mask, true);
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return emu_shfl(v, src, false); }

inline std::vector<float> emu_dynamic_shared;

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t shared, void*, const A&... args) {
    gridDim = grid;
    blockDim = block;
    const int n = block.x * block.y * block.z;
    for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
        emu_dynamic_shared.assign(shared / sizeof(float) + 4, 0.f);
        EmuBlock eb;
        eb.block = std::make_unique<std::barrier<>>(n);
        for (int w = 0; w < (n + 31) / 32; ++w)
            eb.warps.push_back(std::make_unique<std::barrier<>>(std::min(32, n - 32 * w)));
        eb.slots.assign((n + 31) / 32 * 32, 0);
        emu_block = &eb;
        std::vector<std::thread> threads;
        for (int i = 0; i < n; ++i) {
            threads.emplace_back([&, i, bx, by, bz]() {
                threadIdx = dim3(i % block.x, i / block.x % block.y, i / (block.x * block.y));
                blockIdx = dim3(bx, by, bz);
                kernel(args...);
                eb.warps[i / 32]->arrive_and_drop();
                eb.block->arrive_and_drop();
            });
        }
        for (auto& t : threads) t.join();
    }
}
