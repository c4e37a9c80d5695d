// Device helpers shared by the graph kernels (sm_90a): asynchronous global
// -> shared copies, float4 / scalar loads and stores, and programmatic
// dependent launch.
//
// A weight matrix is one contiguous block, so one thread hands it to the
// copy engine with a single `cp.async.bulk` that completes on an `mbarrier`
// in shared memory; the threads go on with other loads and wait on the
// barrier only where they first read the weights. A block whose address or
// size is not a multiple of 16 bytes (a bulk copy refuses it) goes by
// `cp.async` 4-byte chunks from every thread instead, in the same kernel.
// Index and mask rows go by `cp.async`, 16-byte chunks where aligned. Both
// forms leave the loading threads' registers free while the copy is in
// flight.
//
// Programmatic dependent launch: `pdl_launch_dependents` lets the next
// kernel on the stream (launched with the programmatic stream serialisation
// attribute) start its blocks early; `pdl_wait` in that kernel returns once
// every kernel before it has finished and its writes are visible. Both are
// no-ops for a kernel launched without the attribute.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace graph_common {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats (or int32s) from src to dst by cp.async, 16-byte chunks when
// both ends are 16-byte aligned and n is a multiple of 4, else 4-byte ones;
// threads tid, tid + nthreads, ... each issue their share. Completes at
// cp_async_wait_all() in the issuing thread (then a barrier for the rest).
__device__ __forceinline__ void copy_async(void* dst, const void* src, int n,
                                           int tid, int nthreads) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                   (n & 3) == 0;
  if (vec) {
    for (int i = tid; i < n / 4; i += nthreads)
      cp_async16(static_cast<float4*>(dst) + i,
                 static_cast<const float4*>(src) + i);
  } else {
    for (int i = tid; i < n; i += nthreads)
      cp_async4(static_cast<float*>(dst) + i,
                static_cast<const float*>(src) + i);
  }
}

// A one-shot bulk copy of a contiguous block into shared memory, tracked by
// an mbarrier. `start` (every thread, once) initialises the barrier and, if
// the block is 16-byte aligned, has thread 0 issue the bulk copy; otherwise
// every thread issues cp.async 4-byte chunks. `wait` (every thread) returns
// once the block has landed. A __syncthreads() must separate the two.
struct BulkLoad {
  uint64_t* bar;
  bool bulk;

  __device__ __forceinline__ void start(void* dst, const void* src,
                                        int n_floats, int tid,
                                        int nthreads) {
    const uint32_t bytes = static_cast<uint32_t>(n_floats) * 4u;
    bulk = ((reinterpret_cast<uintptr_t>(src) |
             reinterpret_cast<uintptr_t>(dst) | bytes) & 15) == 0;
    if (bulk) {
      if (tid == 0) {
        const uint32_t b = smem_addr(bar);
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b),
                     "r"(1)
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                b),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
            "l"(src), "r"(bytes), "r"(b)
            : "memory");
      }
    } else {
      for (int i = tid; i < n_floats; i += nthreads)
        cp_async4(static_cast<float*>(dst) + i,
                  static_cast<const float*>(src) + i);
    }
  }

  // The barrier's first phase (parity 0) completes when the bytes land.
  // After the block's __syncthreads() the init is visible to every thread.
  __device__ __forceinline__ void wait() const {
    if (bulk) {
      const uint32_t b = smem_addr(bar);
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(b)
            : "memory");
      }
    } else {
      cp_async_wait_all();
    }
  }
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// N consecutive floats of a 16-byte aligned shared-memory row as float4s
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&v)[N]) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A kernel comes in two register budgets. Held to 64 registers a thread
// (__launch_bounds__(128, 8), eight blocks an SM) ptxas issues a batch of
// independent loads a few at a time; with __launch_bounds__(128, 1) it may
// take what the batch needs (up to ~128 here) and keeps them in flight, at
// the price of fewer blocks an SM. The wide build pays where the whole grid
// fits on the card at once with it (latency-bound calls: the training
// shapes, small destination sets); past that the narrow build's extra
// blocks an SM win.
// The occupancy query costs host time, so each (kernel, block, shared
// memory, device) answer is kept (per host thread; a handful of entries).
inline int resident_blocks(const void* kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int threads;
    size_t smem;
    int device;
    int blocks;
  };
  thread_local Entry cache[64];
  thread_local int n = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  for (int i = 0; i < n && i < 64; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == kernel && e.threads == threads && e.smem == smem &&
        e.device == dev)
      return e.blocks;
  }
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  cache[n % 64] = Entry{kernel, threads, smem, dev, per_sm * sms};
  ++n;
  return per_sm * sms;
}

template <class Kernel>
inline Kernel pick_wide(Kernel narrow, Kernel wide, int blocks, int threads,
                        size_t smem) {
  return blocks <= resident_blocks(reinterpret_cast<const void*>(wide),
                                   threads, smem)
             ? wide
             : narrow;
}

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace graph_common
