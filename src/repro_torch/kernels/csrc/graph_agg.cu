// GCN client sub-layer core for Hopper (sm_90a), all clients in one launch.
//
// Replaces the TPU kernel `_graph_agg_kernel` / `graph_agg_pallas` in
// src/repro/kernels/graph_agg.py. For every client m and destination row r:
//
//   mean = sum_f mask[r,f] * h[idx[r,f]] / max(sum_f mask[r,f], 1)
//   out  = mean @ W
//
// Bias and relu stay outside, as in the reference (core/glasu.py applies
// them after the call). When `mean_out` is not null the kernel also writes
// the masked mean, which the backward needs (dW = mean^T g), so the
// backward never re-runs the forward.
//
// What bounds it on this card: at the training shapes (M = 3, n_src <= 512,
// n_dst <= 512, F+1 = 4, d = d_out = 64) one launch moves under 1 MB
// (~0.3 us at 3.35 TB/s) and does ~13 MFLOP (~0.2 us at 67 TFLOP/s fp32):
// a launch costs its latency, set by the dependent idx -> h row loads of a
// warp's rows. At the eval shape (n_src = n_dst = 2708, F+1 = 33) the
// gather re-reads ~69 MB of h rows through L2, unique bytes are ~6 MB.
//
// Design, as in gcnii_layer.cu. The TPU kernel builds a one-hot
// (128 x n_src) scatter matrix and stages all of h in VMEM; here the gather
// is direct from global memory through L2 (lanes across d, one coalesced
// row segment per fanout entry), so any n_src works. A block owns kRows
// destination rows of one client (blockIdx.y = m). The client's W (d x
// d_out; 48 KB at d = 192 after a concat aggregation, d_out = 64) is staged
// in shared memory once per block, each warp gathers its rows' means into a
// shared tile, and the (kRows x d)(d x d_out) product runs from shared
// memory in fp32 FMA (no TF32). Fanout entries with mask 0 are skipped
// (their term is 0 * h); indices are clamped to [0, n_src) so a bad index
// cannot fault (the JAX gather clamps as well). Tensor cores and async
// copies are left for a later change.
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
constexpr size_t kMaxSmem = 232448;           // 227 KB a block may opt into

__global__ void __launch_bounds__(kThreads)
graph_agg_kernel(const float* __restrict__ h, const int* __restrict__ idx,
                 const float* __restrict__ mask,
                 const float* __restrict__ w, float* __restrict__ out,
                 float* __restrict__ mean_out, int n_src, int n_dst, int f1,
                 int d, int d_out) {
  extern __shared__ float smem[];
  float* w_s = smem;              // (d, d_out) weights of client m
  float* a_s = smem + d * d_out;  // (kRows, d) masked means of this block

  const int m = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* hm = h + static_cast<size_t>(m) * n_src * d;
  const int* idxm = idx + static_cast<size_t>(m) * n_dst * f1;
  const float* maskm = mask + static_cast<size_t>(m) * n_dst * f1;
  const float* wm = w + static_cast<size_t>(m) * d * d_out;
  float* outm = out + static_cast<size_t>(m) * n_dst * d_out;
  float* meanm = mean_out == nullptr
                     ? nullptr
                     : mean_out + static_cast<size_t>(m) * n_dst * d;

  for (int i = threadIdx.x; i < d * d_out; i += kThreads) w_s[i] = wm[i];

  // gather: masked mean over the fanout
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int lr = warp * kRowsPerWarp + rr;
    const int r = row0 + lr;
    float* ar = a_s + lr * d;
    if (r >= n_dst) {  // ragged last tile: never stored
      for (int c = lane; c < d; c += 32) ar[c] = 0.f;
      continue;
    }
    const int* ir = idxm + static_cast<size_t>(r) * f1;
    const float* mr = maskm + static_cast<size_t>(r) * f1;
    float msum = 0.f;
    for (int f = 0; f < f1; ++f) msum += mr[f];
    const float denom = fmaxf(msum, 1.f);
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
      const float a = s / denom;
      ar[c] = a;
      if (meanm != nullptr) meanm[static_cast<size_t>(r) * d + c] = a;
    }
  }
  __syncthreads();

  // (kRows x d) @ (d x d_out) from shared memory
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int lr = warp * kRowsPerWarp + rr;
    const int r = row0 + lr;
    if (r >= n_dst) continue;
    const float* ar = a_s + lr * d;
    for (int c = lane; c < d_out; c += 32) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(ar[k], w_s[k * d_out + c], acc);
      outm[static_cast<size_t>(r) * d_out + c] = acc;
    }
  }
}

}  // namespace

// h: (m, n_src, d) f32; idx: (m, n_dst, f1) i32; mask: (m, n_dst, f1) f32;
// w: (m, d, d_out) f32; out: (m, n_dst, d_out) f32; mean_out: null or
// (m, n_dst, d) f32, all contiguous on CUDA device `device`. Launches on
// `stream` and returns the launch's cudaGetLastError() (0 on success);
// never synchronises. The library links its own CUDA runtime, so the
// device is set here rather than inherited from the caller's runtime.
extern "C" int graph_agg_launch(const float* h, const int* idx,
                                const float* mask, const float* w, float* out,
                                float* mean_out, int m, int n_src, int n_dst,
                                int f1, int d, int d_out, int device,
                                void* stream) {
  if (m <= 0 || n_dst <= 0 || d <= 0 || d_out <= 0 || n_src <= 0 ||
      f1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = (static_cast<size_t>(d) * d_out
                       + static_cast<size_t>(kRows) * d) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_dst + kRows - 1) / kRows, m);
  graph_agg_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      h, idx, mask, w, out, mean_out, n_src, n_dst, f1, d, d_out);
  return static_cast<int>(cudaGetLastError());
}
