// Fused GCNII client sub-layer for Hopper (sm_90a), all clients in one launch.
//
// Replaces the TPU kernel `_gcnii_kernel` / `gcnii_layer_pallas` in
// src/repro/kernels/graph_agg.py. For every client m and destination row r:
//
//   mean = sum_f mask[r,f] * h[idx[r,f]] / max(sum_f mask[r,f], 1)
//   z    = (1 - alpha) * mean + alpha * h0[idx[r,0]]      (h0 read unmasked)
//   out  = relu((1 - beta) * z + beta * (z @ W) + b)
//
// When `z_out` is not null the kernel also writes z, which the backward
// needs (dW = beta z^T g'), so the backward never re-runs the forward.
//
// What bounds it on this card: at the training shapes (M = 3, n_src <= 512,
// n_dst <= 512, F+1 = 4, d = 64) a launch moves under 1 MB and does ~13
// MFLOP (~0.3 us at 3.35 TB/s, ~0.2 us at 67 TFLOP/s fp32): it costs its
// latency, the chains W -> product and idx -> h rows -> z -> product, so
// tensor cores would buy nothing and cost the error budget. At the serving
// shapes (n_src = n_dst = 2708, F+1 = 33) the unique bytes are ~8.4 MB
// (~2.5 us), the gather re-reads ~69 MB of h rows through L2 and z @ W is
// 67 MFLOP; the loads in flight set the time.
//
// Design. The TPU kernel turns the gather into a one-hot (128 x n_src)
// scatter-matrix matmul and stages all of h and h0 in VMEM; at n_src = 2708
// h alone is 693 KB per client, three times the 227 KB of shared memory a
// block may use. Here the gather is direct: h and h0 stay in global memory
// and are read through L2. A block owns `rows` destination rows of one
// client (blockIdx.y = m); blocks shrink to a warp while the grid would
// leave SMs idle, so the small layers (n_dst 64 and 16) still spread.
//  - W off the critical path: thread 0 hands the client's W (d x d, one
//    contiguous block; 16 KB at d = 64, 64 KB at d = 128) to the copy engine
//    with one cp.async.bulk on an mbarrier (cp.async 4-byte chunks when it is
//    not 16-byte aligned), and the block waits on it only just before the
//    product; the gather runs under the copy.
//  - The gather (graph_common.cuh Fanout, shared with the GCN kernel): the
//    block's idx and mask rows (one contiguous run) and the client's bias
//    come in by cp.async once, and each entry's source row is resolved
//    once into a shared table padded to whole batches. A lane group per
//    row (VEC = 4 columns a lane, float4 loads) then issues the h loads of
//    a batch of up to 16 fanout entries, and h0[self], before the first
//    add, with no branch or select between them (a branch per entry, from
//    a masked skip or a select on a loaded index, split the batch into one
//    dependent load at a time). A masked entry reads the row's self row, in
//    flight anyway, with weight 0. z goes to a shared tile.
//  - The product (graph_common.cuh matmul_rows, with the identity map, bias
//    and relu as its epilogue): each thread owns two rows x VEC columns,
//    eight independent accumulators, each summed over k from 0 upward in
//    one fmaf chain, with z and W read from shared memory kStage k-steps
//    ahead.
//  - Two register budgets (graph_common.cuh, pick_wide): the wide build
//    keeps a whole batch of loads in flight and is taken where the grid
//    fits on the card at once with it (training, small n_dst); the narrow
//    one, eight blocks an SM, past that (the serving layers of 2708 rows).
//    Rows a block shrink further where a long fanout would outgrow a
//    block's shared memory.
// Indices are clamped to [0, n_src) so a bad index cannot fault (the JAX
// gather clamps as well).
//
// Precision: fp32 FMA throughout, no TF32. The masked sum runs over f
// ascending from 0 and the product over k ascending, as in the PR 11/12
// kernel; a masked entry's term is fmaf(0, h, s) = s exactly for finite h,
// as the skip gave (s starts at +0 and is never -0).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>

#include "graph_common.cuh"

namespace {

using namespace graph_common;

constexpr int kMaxThreads = 128;

// matmul_rows' epilogue: the identity map, bias and relu,
// relu((1 - beta) z + beta (z @ W) + b), z and b in shared memory
struct IdentityMap {
  const float* z;
  int zp;
  const float* b;
  float beta;

  template <int VEC>
  __device__ __forceinline__ void operator()(int r, int c0,
                                             float (&acc)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = fmaxf((1.f - beta) * z[r * zp + c0 + i] + beta * acc[i] +
                         b[c0 + i],
                     0.f);
  }
};

// A lane group of `gw` lanes gathers a row, lane lg the column groups lg,
// lg + gw, ... (VEC columns each).
template <int VEC, int BATCH>
__device__ __forceinline__ void
gcnii_rows(const float* __restrict__ h, const float* __restrict__ h0,
           const int* __restrict__ idx,
           const float* __restrict__ mask,
           const float* __restrict__ w, const float* __restrict__ b,
           float* __restrict__ out, float* __restrict__ z_out,
           int n_src, int n_dst, int f1, int d, float alpha,
           float beta, int gw, int rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t w_bar;
  const int zp = (d + 3) / 4 * 4 + 4;  // padded z row: float4 reads,
                                       // no bank conflict
  float* w_s = smem;                         // (d, d) weights of client m
  float* b_s = smem + (d * d + 3) / 4 * 4;  // (d,) bias of client m
  float* z_s = b_s + (d + 3) / 4 * 4;       // (rows, zp), 16-byte aligned
  const Fanout fan(z_s + rows * zp, rows, f1, BATCH);

  const int m = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nrows = min(rows, n_dst - r0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t row0 = static_cast<size_t>(m) * n_dst + r0;

  // the index rows and the bias first: the gather waits on them, the
  // product on W
  fan.load(idx, mask, row0, nrows, tid, nthreads);
  copy_async(b_s, b + static_cast<size_t>(m) * d, d, tid, nthreads);
  BulkLoad w_load{&w_bar, false};
  w_load.start(w_s, w + static_cast<size_t>(m) * d * d, d * d, tid,
               nthreads);
  cp_async_wait_all();
  __syncthreads();
  fan.resolve(nrows, n_src, tid, nthreads);

  // gather: masked mean over the fanout plus the initial residual
  const float* hm = h + static_cast<size_t>(m) * n_src * d;
  const float* h0m = h0 + static_cast<size_t>(m) * n_src * d;
  const int ncg = d / VEC;
  const int sw = __ffs(gw) - 1;  // gw is a power of two
  if (const int rr = tid >> sw; rr < nrows) {
    const int self = min(max(fan.idx[rr * f1], 0), n_src - 1);
    const float denom = fan.denom(rr);
    for (int cg = tid & (gw - 1); cg < ncg; cg += gw) {
      const int c0 = cg * VEC;
      float r0v[VEC];
      load_vec<VEC>(h0m + static_cast<size_t>(self) * d + c0, r0v);
      float s[VEC];
      fan.gather<VEC, BATCH>(hm, rr, d, c0, s);
      float z[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        z[i] = (1.f - alpha) * (s[i] / denom) + alpha * r0v[i];
      store_vec<VEC>(z_s + rr * zp + c0, z);
      if (z_out != nullptr) store_vec<VEC>(z_out + (row0 + rr) * d + c0, z);
    }
  }
  w_load.wait();
  __syncthreads();

  // identity map + matmul + bias + relu from shared memory
  matmul_rows<VEC>(z_s, zp, w_s, out + row0 * d, nrows, d, d, tid, nthreads,
                   IdentityMap{z_s, zp, b_s, beta});
}

template <int VEC, int BATCH>
__global__ void __launch_bounds__(kMaxThreads, 8)
gcnii_layer_kernel(const float* __restrict__ h, const float* __restrict__ h0,
                   const int* __restrict__ idx,
                   const float* __restrict__ mask,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float* __restrict__ out, float* __restrict__ z_out,
                   int n_src, int n_dst, int f1, int d, float alpha,
                   float beta, int gw, int rows) {
  gcnii_rows<VEC, BATCH>(h, h0, idx, mask, w, b, out, z_out, n_src, n_dst,
                         f1, d, alpha, beta, gw, rows);
}

// the same with the register budget of one block an SM (pick_wide)
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kMaxThreads, 1)
gcnii_layer_kernel_wide(const float* __restrict__ h,
                        const float* __restrict__ h0,
                        const int* __restrict__ idx,
                        const float* __restrict__ mask,
                        const float* __restrict__ w,
                        const float* __restrict__ b,
                        float* __restrict__ out, float* __restrict__ z_out,
                        int n_src, int n_dst, int f1, int d, float alpha,
                        float beta, int gw, int rows) {
  gcnii_rows<VEC, BATCH>(h, h0, idx, mask, w, b, out, z_out, n_src, n_dst,
                         f1, d, alpha, beta, gw, rows);
}

template <int VEC>
int launch(const float* h, const float* h0, const int* idx, const float* mask,
           const float* w, const float* b, float* out, float* z_out, int m,
           int n_src, int n_dst, int f1, int d, float alpha, float beta,
           cudaStream_t s) {
  const int gw = min(32, pow2_ceil(d / VEC));
  // h loads in flight a lane: one batch of 4 a row at the training fanout,
  // batches of 16 past it (three at the serving fanout of 33)
  const int batch = f1 <= 4 ? 4 : 16;
  const size_t f1p = (f1 + batch - 1) / batch * batch;
  const size_t smem_wb = ((static_cast<size_t>(d) * d + 3) / 4 * 4 +
                          (d + 3) / 4 * 4) * sizeof(float);
  const size_t smem_row = ((d + 3) / 4 * 4 + 4 + 2 * (f1 + f1p)) *
                          sizeof(float);
  const int threads = row_block_threads(m * n_dst, gw, smem_wb, smem_row);
  const int rows = threads / gw;
  const dim3 grid((n_dst + rows - 1) / rows, m);
  if (batch == 4)
    return launch_pick(gcnii_layer_kernel<VEC, 4>,
                       gcnii_layer_kernel_wide<VEC, 4>, grid, threads,
                       smem_wb + rows * smem_row, s, h, h0, idx, mask, w, b,
                       out, z_out, n_src, n_dst, f1, d, alpha, beta, gw,
                       rows);
  return launch_pick(gcnii_layer_kernel<VEC, 16>,
                     gcnii_layer_kernel_wide<VEC, 16>, grid, threads,
                     smem_wb + rows * smem_row, s, h, h0, idx, mask, w, b,
                     out, z_out, n_src, n_dst, f1, d, alpha, beta, gw, rows);
}

}  // namespace

// h, h0: (m, n_src, d) f32; idx: (m, n_dst, f1) i32; mask: (m, n_dst, f1)
// f32; w: (m, d, d) f32; b: (m, d) f32; out: (m, n_dst, d) f32; z_out:
// null or (m, n_dst, d) f32, all contiguous on CUDA device `device`.
// Launches on `stream` and returns the launch's cudaGetLastError() (0 on
// success); never synchronises. The library links its own CUDA runtime, so
// the device is set here rather than inherited from the caller's runtime.
extern "C" int gcnii_layer_launch(const float* h, const float* h0,
                                  const int* idx, const float* mask,
                                  const float* w, const float* b, float* out,
                                  float* z_out, int m, int n_src, int n_dst,
                                  int f1, int d,
                                  float alpha, float beta, int device,
                                  void* stream) {
  if (m <= 0 || n_dst <= 0 || d <= 0 || n_src <= 0 || f1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 columns need d % 4 == 0 and 16-byte aligned rows (a view with an
  // odd storage offset takes the scalar instantiation)
  const bool vec4 = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(h0) |
        reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(z_out)) & 15) == 0;
  if (vec4)
    return launch<4>(h, h0, idx, mask, w, b, out, z_out, m, n_src, n_dst, f1,
                     d, alpha, beta, s);
  return launch<1>(h, h0, idx, mask, w, b, out, z_out, m, n_src, n_dst, f1, d,
                   alpha, beta, s);
}
