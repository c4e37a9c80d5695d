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
// What bounds it on this card: at the serving shapes (M = 3, n_src = n_dst =
// 2708, d = 64, F+1 = 33) the unique device-memory bytes are ~8.4 MB
// (h, h0, idx, mask, out: ~2.5 us at 3.35 TB/s), the gather re-reads ~69 MB
// of h rows through L2, and z @ W is 67 MFLOP. One launch is bound by the
// latency of the dependent index -> row loads and by L2 bandwidth, not by
// device memory or arithmetic.
//
// Design. The TPU kernel turns the gather into a one-hot (128 x n_src)
// scatter-matrix matmul and stages all of h and h0 in VMEM; at n_src = 2708
// h alone is 693 KB per client, three times the 227 KB of shared memory a
// block may use. Here the gather is direct: h and h0 stay in global memory
// and are read through L2, one coalesced 4-byte-per-lane row segment per
// fanout entry (lanes run across d, so any d works). A block owns ROWS
// destination rows of one client (blockIdx.y = m); each warp gathers its
// rows into a z tile in shared memory, the client's W is staged in shared
// memory once per block, and the (ROWS x d)(d x d) product and epilogue run
// from shared memory. Fanout entries with mask 0 are skipped: their term is
// 0 * h, so for finite h the result is the same. Indices are clamped to
// [0, n_src) so a bad index cannot fault (the JAX gather clamps as well).
// fp32 FMA throughout, no TF32. Tensor cores for z @ W and asynchronous
// copies of the index tiles are left for a later change.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // destination rows per block
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
gcnii_layer_kernel(const float* __restrict__ h, const float* __restrict__ h0,
                   const int* __restrict__ idx,
                   const float* __restrict__ mask,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float* __restrict__ out, float* __restrict__ z_out,
                   int n_src, int n_dst, int f1, int d, float alpha,
                   float beta) {
  extern __shared__ float smem[];
  float* w_s = smem;          // (d, d) weights of client m
  float* z_s = smem + d * d;  // (kRows, d) z rows of this block

  const int m = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* hm = h + static_cast<size_t>(m) * n_src * d;
  const float* h0m = h0 + static_cast<size_t>(m) * n_src * d;
  const int* idxm = idx + static_cast<size_t>(m) * n_dst * f1;
  const float* maskm = mask + static_cast<size_t>(m) * n_dst * f1;
  const float* wm = w + static_cast<size_t>(m) * d * d;
  const float* bm = b + static_cast<size_t>(m) * d;
  float* outm = out + static_cast<size_t>(m) * n_dst * d;
  float* zm = z_out == nullptr ? nullptr
                               : z_out + static_cast<size_t>(m) * n_dst * d;

  for (int i = threadIdx.x; i < d * d; i += kThreads) w_s[i] = wm[i];

  // gather: masked mean over the fanout plus the initial residual
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int lr = warp * kRowsPerWarp + rr;
    const int r = row0 + lr;
    float* zr = z_s + lr * d;
    if (r >= n_dst) {  // ragged last tile: never stored
      for (int c = lane; c < d; c += 32) zr[c] = 0.f;
      continue;
    }
    const int* ir = idxm + static_cast<size_t>(r) * f1;
    const float* mr = maskm + static_cast<size_t>(r) * f1;
    float msum = 0.f;
    for (int f = 0; f < f1; ++f) msum += mr[f];
    const float denom = fmaxf(msum, 1.f);
    const int self = min(max(ir[0], 0), n_src - 1);
    for (int c = lane; c < d; c += 32) {
      float s = 0.f;
#pragma unroll 4
      for (int f = 0; f < f1; ++f) {
        const float mv = mr[f];
        if (mv != 0.f) {
          const int src = min(max(ir[f], 0), n_src - 1);
          s += mv * hm[static_cast<size_t>(src) * d + c];
        }
      }
      const float z = (1.f - alpha) * (s / denom)
                      + alpha * h0m[static_cast<size_t>(self) * d + c];
      zr[c] = z;
      if (zm != nullptr) zm[static_cast<size_t>(r) * d + c] = z;
    }
  }
  __syncthreads();

  // identity map + matmul + bias + relu from shared memory
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int lr = warp * kRowsPerWarp + rr;
    const int r = row0 + lr;
    if (r >= n_dst) continue;
    const float* zr = z_s + lr * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(zr[k], w_s[k * d + c], acc);
      const float v = (1.f - beta) * zr[c] + beta * acc + bm[c];
      outm[static_cast<size_t>(r) * d + c] = fmaxf(v, 0.f);
    }
  }
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
  const size_t smem = (static_cast<size_t>(d) * d
                       + static_cast<size_t>(kRows) * d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gcnii_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_dst + kRows - 1) / kRows, m);
  gcnii_layer_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      h, h0, idx, mask, w, b, out, z_out, n_src, n_dst, f1, d, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
