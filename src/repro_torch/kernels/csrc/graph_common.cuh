// Helpers shared by the graph kernels (sm_90a): asynchronous global ->
// shared copies, float4 / scalar loads and stores, the fanout gather and the
// row-tile @ W product of the GCN and GCNII kernels (the product also the
// CSR kernel's), programmatic dependent launch, and on the host the block
// sizing and the choice between a kernel's two register budgets.
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

// A block's fanout rows in shared memory: idx and mask (nrows x f1) as they
// come from global memory, and each entry resolved once into src (its
// clamped source row) and mv (its weight), nrows x f1p with f1p a whole
// number of batches.
struct Fanout {
  int* idx;
  float* mask;
  int* src;
  float* mv;
  int f1;
  int f1p;

  // 2 * (f1 + f1p) words a row, carved from p
  __device__ __forceinline__ Fanout(float* p, int rows, int f1_, int batch)
      : f1(f1_), f1p((f1_ + batch - 1) / batch * batch) {
    idx = reinterpret_cast<int*>(p);
    mask = p + rows * f1;
    src = reinterpret_cast<int*>(mask + rows * f1);
    mv = mask + rows * f1 + rows * f1p;
  }

  // The idx and mask rows of destination rows row0 .. row0 + nrows by
  // cp.async; complete at cp_async_wait_all() and a barrier.
  __device__ __forceinline__ void load(const int* idx_g, const float* mask_g,
                                       size_t row0, int nrows, int tid,
                                       int nthreads) const {
    copy_async(idx, idx_g + row0 * f1, nrows * f1, tid, nthreads);
    copy_async(mask, mask_g + row0 * f1, nrows * f1, tid, nthreads);
  }

  // Each entry's source row, resolved once: a masked entry (and the padding
  // up to whole batches) reads the row's first entry's source row, whose h
  // is in flight anyway, with weight 0. Ends on a barrier.
  __device__ __forceinline__ void resolve(int nrows, int n_src, int tid,
                                          int nthreads) const {
    for (int i = tid; i < nrows * f1p; i += nthreads) {
      const int r = i / f1p;
      const int f = i - r * f1p;
      const float w = f < f1 ? mask[r * f1 + f] : 0.f;
      src[i] = min(max(idx[r * f1 + (w != 0.f ? f : 0)], 0), n_src - 1);
      mv[i] = w;
    }
    __syncthreads();
  }

  // max(sum_f mask[r, f], 1)
  __device__ __forceinline__ float denom(int r) const {
    const float* mr = mv + r * f1p;
    float msum = 0.f;
    for (int f = 0; f < f1; ++f) msum += mr[f];
    return fmaxf(msum, 1.f);
  }

  // s = sum over f ascending of mask[r, f] * h[idx[r, f], c0 .. c0 + VEC):
  // the h loads of a batch of BATCH entries all go out before its first
  // add, with no branch or select between them (a masked entry adds
  // fmaf(0, h, s) = s exactly for finite h).
  template <int VEC, int BATCH>
  __device__ __forceinline__ void gather(const float* __restrict__ hm,
                                         int r, int d, int c0,
                                         float (&s)[VEC]) const {
    const int* sr = src + r * f1p;
    const float* mr = mv + r * f1p;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = 0.f;
    for (int fb = 0; fb < f1; fb += BATCH) {
      float w[BATCH];
      float v[BATCH][VEC];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        w[u] = mr[fb + u];
        load_vec<VEC>(hm + static_cast<size_t>(sr[fb + u]) * d + c0, v[u]);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = fmaf(w[u], v[u][i], s[i]);
      }
    }
  }
};

// matmul_rows' epilogue when the product is the output
struct NoEpilogue {
  template <int VEC>
  __device__ __forceinline__ void operator()(int, int, float (&)[VEC]) const {
  }
};

// out[r, :] = epi(x[r, :] @ W) for the nrows rows of a shared tile x (row
// stride xp, a multiple of 4, 16-byte aligned) and W (d x d_out) in shared
// memory, rows of out d_out apart in global memory; epi(r, c0, acc) may
// rewrite row r's accumulators of columns c0 .. c0 + VEC before the store.
// A thread owns rows (2p, 2p + 1) x columns c0 .. c0 + VEC: eight
// independent accumulators (VEC = 4), each summed over k from 0 upward in
// one fmaf chain, with kStage k-steps' operands read from shared memory
// before their FMAs.
template <int VEC, class Epilogue = NoEpilogue>
__device__ __forceinline__ void matmul_rows(const float* x, int xp,
                                            const float* w_s, float* out,
                                            int nrows, int d, int d_out,
                                            int tid, int nthreads,
                                            const Epilogue& epi = {}) {
  constexpr int kStage = 8;
  const int nco = d_out / VEC;
  const int npairs = (nrows + 1) / 2;
  for (int it = tid; it < npairs * nco; it += nthreads) {
    const int ra = 2 * (it / nco);
    const int rb = min(ra + 1, nrows - 1);
    const int c0 = (it % nco) * VEC;
    const float* xa_r = x + ra * xp;
    const float* xb_r = x + rb * xp;
    float acc_a[VEC], acc_b[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc_a[i] = acc_b[i] = 0.f;
    int k0 = 0;
    for (; k0 + kStage <= d; k0 += kStage) {
      float wv[kStage][VEC], xa[kStage], xb[kStage];
      load_run<kStage>(xa_r + k0, xa);
      load_run<kStage>(xb_r + k0, xb);
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        load_vec<VEC>(w_s + (k0 + u) * d_out + c0, wv[u]);
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc_a[i] = fmaf(xa[u], wv[u][i], acc_a[i]);
          acc_b[i] = fmaf(xb[u], wv[u][i], acc_b[i]);
        }
      }
    }
    for (int k = k0; k < d; ++k) {
      float wv[VEC];
      load_vec<VEC>(w_s + k * d_out + c0, wv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc_a[i] = fmaf(xa_r[k], wv[i], acc_a[i]);
        acc_b[i] = fmaf(xb_r[k], wv[i], acc_b[i]);
      }
    }
    epi(ra, c0, acc_a);
    store_vec<VEC>(out + static_cast<size_t>(ra) * d_out + c0, acc_a);
    if (ra + 1 < nrows) {
      epi(ra + 1, c0, acc_b);
      store_vec<VEC>(out + static_cast<size_t>(ra + 1) * d_out + c0, acc_b);
    }
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

constexpr size_t kSmemLimit = 232448;  // 227 KB a block may opt into
constexpr int kFillBlocks = 132;       // an SM each, where the rows allow

// Threads a block where a lane group of gw lanes owns a destination row
// (at most 128): halved, down to a warp, while a grid over total_rows rows
// would leave SMs idle; then, down to one row, while the block's shared
// memory (fixed + rows * row bytes) passes what a block may opt into.
inline int row_block_threads(int total_rows, int gw, size_t fixed,
                             size_t row) {
  int threads = 128;
  while (threads > 32 && total_rows / (threads / gw) < kFillBlocks)
    threads /= 2;
  while (threads > gw && fixed + threads / gw * row > kSmemLimit)
    threads /= 2;
  return threads;
}

// Launches on `s` the wide build where the whole grid fits on the card at
// once with it, else the narrow one (pick_wide), with `smem` bytes of
// dynamic shared memory (both builds opted into it past 48 KB). Returns the
// launch's cudaGetLastError() (0 on success).
template <class Kernel, class... Args>
inline int launch_pick(Kernel narrow, Kernel wide, dim3 grid, int threads,
                       size_t smem, cudaStream_t s, Args... args) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const Kernel both[2] = {narrow, wide};
    for (const Kernel k : both) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  const Kernel kernel =
      pick_wide(narrow, wide, static_cast<int>(grid.x * grid.y), threads,
                smem);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace graph_common
