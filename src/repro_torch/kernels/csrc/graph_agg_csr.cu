// CSR segment-mean + weight matmul for Hopper (sm_90a), all clients in one
// launch.
//
// Replaces the TPU kernel `_csr_agg_kernel` / `graph_agg_csr_pallas` in
// src/repro/kernels/graph_agg.py. Input is the reference's edge-slab
// layout: tile i (destination rows [128 i, 128 i + 128)) owns slots
// [i * slab, (i + 1) * slab) of idx / seg / ew, seg is the row within the
// tile, and a slot whose seg is outside [0, 128) (CSR_PAD_ROW = 128) belongs
// to no row. For every client m and destination row r:
//
//   s[r]     = sum_{e : seg_e = r} ew_e * h[idx_e]
//   denom[r] = max(sum_{e : seg_e = r} ew_e, 1)      (weights summing below 1
//                                                    are not renormalised)
//   out[r]   = (s[r] / denom[r]) @ W
//
// A row with no edges gives exactly 0. When `mean_out` is not null the
// kernel also writes s / denom, which the backward needs (dW = mean^T g).
//
// What bounds it on this card: bytes. At the serving shape (M = 2,
// n_src = 67600, n_dst = 1040, F+1 = 33, d = d_out = 32) one launch reads
// the three slabs (12 B a slot, 0.9 MB), the h rows its live edges name
// (128 B each) and W, and does 2 flops a live edge and column plus the
// (n_dst x d)(d x d_out) product: a few microseconds at 3.35 TB/s
// (chip_smoke.py computes the bound from each run's inputs). With one block
// per (tile, client) there are only 18 blocks at that shape, so in practice
// the launch waits on each warp's h-row gathers, not on bandwidth.
//
// Design. The TPU kernel builds a one-hot (128 x slab) matrix from seg and
// contracts it with the gathered rows on the MXU; here each block (one
// 128-row tile of one client, blockIdx = (tile, m)) sorts its slab by row
// and sums each row directly:
//   1. count each row's live edges (seg in [0, 128), ew != 0; a weight-0
//      slot, as ell_to_slabs makes of a masked fanout entry, adds 0 to both
//      sums) with integer shared-memory atomics, exact in any order;
//   2. exclusive scan of the 128 counts;
//   3. stable placement, kThreads slots at a time in slab order: within a
//      warp __match_any_sync ranks the lanes of one row, across warps a
//      per-row scan over the warps' counts, so each row's edges land
//      contiguous and in slab order. The sorted (idx, ew) copy goes to a
//      scratch buffer in device memory (8 B a slot, allocated by the
//      wrapper), so the slab length has no limit: a hub tile larger than
//      shared memory only takes longer;
//   4. one warp per row sums the row's edges in slab order: 32 (idx, ew)
//      pairs are read at once, one per lane, and broadcast with shuffles, so
//      the h-row loads of a batch do not wait on each other; lanes run
//      across d, each h row read as coalesced 128-B segments straight
//      from global memory through L2 (h is 8.7 MB a client at the serving
//      shape, far beyond shared memory);
//   5. the (128 x d)(d x d_out) product from shared memory, with the
//      client's W staged there once per block (as graph_agg.cu stages it),
//      in fp32 FMA (no TF32).
// There are no floating-point atomics: every sum is taken in slab order, so
// the result is the same on every run. Source ids are clamped to
// [0, n_src) so a bad index cannot fault. Tensor cores, TMA and more blocks
// per tile are left for a later change.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                    // DST_BLOCK of the layout
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;           // 227 KB a block may opt into
// static shared memory of the kernel: count, start, cursor, wcount
constexpr size_t kStaticSmem = (3 + kWarps) * kTile * sizeof(int);

__device__ __forceinline__ bool live(int r, float e) {
  return r >= 0 && r < kTile && e != 0.f;
}

__global__ void __launch_bounds__(kThreads)
graph_agg_csr_kernel(const float* __restrict__ h, const int* __restrict__ idx,
                     const int* __restrict__ seg,
                     const float* __restrict__ ew,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ mean_out, int* sidx, float* sew,
                     int n_src, int n_dst, int n_tiles, int slab, int d,
                     int d_out) {
  extern __shared__ float smem[];
  float* w_s = smem;              // (d, d_out) weights of client m
  float* a_s = smem + d * d_out;  // (kTile, d) means of this tile
  __shared__ int count[kTile];    // live edges of each row
  __shared__ int start[kTile];    // first sorted slot of each row
  __shared__ int cursor[kTile];   // next free sorted slot while placing
  __shared__ int wcount[kWarps][kTile];

  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t base = (static_cast<size_t>(m) * n_tiles + tile) * slab;
  const int* idx_t = idx + base;
  const int* seg_t = seg + base;
  const float* ew_t = ew + base;
  int* sidx_t = sidx + base;
  float* sew_t = sew + base;
  const float* hm = h + static_cast<size_t>(m) * n_src * d;
  const float* wm = w + static_cast<size_t>(m) * d * d_out;
  float* outm = out + static_cast<size_t>(m) * n_dst * d_out;
  float* meanm = mean_out == nullptr
                     ? nullptr
                     : mean_out + static_cast<size_t>(m) * n_dst * d;

  for (int i = tid; i < d * d_out; i += kThreads) w_s[i] = wm[i];
  if (tid < kTile) count[tid] = 0;
  __syncthreads();

  // 1. live edges of each row
  for (int s = tid; s < slab; s += kThreads) {
    const int r = seg_t[s];
    if (live(r, ew_t[s])) atomicAdd(&count[r], 1);
  }
  __syncthreads();

  // 2. exclusive scan of the counts: warp 0, four rows a lane
  if (warp == 0) {
    int c[kTile / 32];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      c[k] = count[lane * (kTile / 32) + k];
      sum += c[k];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += v;
    }
    int run = inc - sum;
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      start[lane * (kTile / 32) + k] = run;
      cursor[lane * (kTile / 32) + k] = run;
      run += c[k];
    }
  }
  __syncthreads();

  // 3. stable placement by row, kThreads slots at a time in slab order
  for (int s0 = 0; s0 < slab; s0 += kThreads) {
    const int s = s0 + tid;
    int r = -1;
    if (s < slab) {
      const int rr = seg_t[s];
      if (live(rr, ew_t[s])) r = rr;
    }
    for (int i = lane; i < kTile; i += 32) wcount[warp][i] = 0;
    __syncwarp();
    const unsigned peers = __match_any_sync(kFull, r);
    const unsigned lower = peers & ((1u << lane) - 1u);
    if (r >= 0 && lower == 0) wcount[warp][r] = __popc(peers);
    __syncthreads();
    if (tid < kTile) {            // warp w's first slot of row tid
      int cur = cursor[tid];
      for (int wv = 0; wv < kWarps; ++wv) {
        const int c = wcount[wv][tid];
        wcount[wv][tid] = cur;
        cur += c;
      }
      cursor[tid] = cur;
    }
    __syncthreads();
    if (r >= 0) {
      const int pos = wcount[warp][r] + __popc(lower);
      sidx_t[pos] = min(max(idx_t[s], 0), n_src - 1);
      sew_t[pos] = ew_t[s];
    }
    __syncthreads();              // wcount is reused by the next chunk
  }

  // 4. one warp per row: weighted sums in slab order, lanes across d
  for (int lr = warp; lr < kTile; lr += kWarps) {
    const int r = tile * kTile + lr;
    if (r >= n_dst) continue;     // ragged last tile: never stored
    const int lo = start[lr];
    const int n = count[lr];
    float* ar = a_s + lr * d;
    float wsum = 0.f;
    for (int b = 0; b < n; b += 32) {
      const float mine = b + lane < n ? sew_t[lo + b + lane] : 0.f;
      const int nb = min(32, n - b);
      for (int t = 0; t < nb; ++t) wsum += __shfl_sync(kFull, mine, t);
    }
    const float denom = fmaxf(wsum, 1.f);
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.f;
      for (int b = 0; b < n; b += 32) {
        const bool has = b + lane < n;
        const int my_j = has ? sidx_t[lo + b + lane] : 0;
        const float my_w = has ? sew_t[lo + b + lane] : 0.f;
        const int nb = min(32, n - b);
#pragma unroll 8
        for (int t = 0; t < nb; ++t) {
          const int j = __shfl_sync(kFull, my_j, t);
          const float wv = __shfl_sync(kFull, my_w, t);
          if (c < d) acc += wv * hm[static_cast<size_t>(j) * d + c];
        }
      }
      if (c < d) {
        const float a = acc / denom;
        ar[c] = a;
        if (meanm != nullptr) meanm[static_cast<size_t>(r) * d + c] = a;
      }
    }
  }
  __syncthreads();

  // 5. (kTile x d) @ (d x d_out) from shared memory
  for (int lr = warp; lr < kTile; lr += kWarps) {
    const int r = tile * kTile + lr;
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

// h: (m, n_src, d) f32; idx/seg: (m, n_tiles * slab) i32; ew: (m, n_tiles *
// slab) f32; w: (m, d, d_out) f32; out: (m, n_dst, d_out) f32; mean_out:
// null or (m, n_dst, d) f32; sidx/sew: (m, n_tiles * slab) i32/f32 scratch
// the kernel overwrites; all contiguous on CUDA device `device`. Launches on
// `stream` and returns the launch's cudaGetLastError() (0 on success);
// never synchronises. The library links its own CUDA runtime, so the
// device is set here rather than inherited from the caller's runtime.
extern "C" int graph_agg_csr_launch(const float* h, const int* idx,
                                    const int* seg, const float* ew,
                                    const float* w, float* out,
                                    float* mean_out, int* sidx, float* sew,
                                    int m, int n_src, int n_dst, int n_tiles,
                                    int slab, int d, int d_out, int device,
                                    void* stream) {
  if (m <= 0 || n_dst <= 0 || n_tiles <= 0 || slab < 0 || d <= 0 ||
      d_out <= 0 || n_src <= 0 ||
      static_cast<long long>(n_tiles) * kTile < n_dst) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = (static_cast<size_t>(d) * d_out
                       + static_cast<size_t>(kTile) * d) * sizeof(float);
  if (smem + kStaticSmem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_agg_csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_tiles, m);
  graph_agg_csr_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      h, idx, seg, ew, w, out, mean_out, sidx, sew, n_src, n_dst, n_tiles,
      slab, d, d_out);
  return static_cast<int>(cudaGetLastError());
}
