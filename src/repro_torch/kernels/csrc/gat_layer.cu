// Fused multi-head GAT client sub-layer for Hopper (sm_90a), all clients in
// one call of two launches.
//
// Replaces the TPU kernel `_gat_kernel` / `gat_layer_pallas` in
// src/repro/kernels/graph_agg.py. For every client m, destination row r and
// head k (column block k*dh .. (k+1)*dh of the output):
//
//   wh      = h @ W                                  (n_src, H*dh)
//   x[f]    = a_src[k] . wh[idx[r,0], k] + a_dst[k] . wh[idx[r,f], k]
//   e[f]    = mask[r,f] > 0 ? leaky_relu(x[f], 0.2) : -1e9
//   att[f]  = softmax_f(e)[f] * mask[r,f]
//   out     = elu(sum_f att[f] * wh[idx[r,f], k] + b[k])
//
// The self score enters unmasked, as the reference reads wh[idx[:, 0]]. A
// row whose mask is all 0 gets a uniform softmax over -1e9 logits, att = 0
// after the mask, and elu(b): never 0/0.
//
// When `p_out` / `x_out` are not null the kernel also writes the softmax
// before the mask and the pre-activation logits x, (n_dst, F+1, H) each;
// with the projection wh (always written: it is the attention pass's input)
// that is what the backward needs, so it never re-runs the forward.
//
// What bounds it on this card: at the training shapes (M = 3, n_src <= 512,
// n_dst <= 512, F+1 = 4, d = 64, H = 2, dh = 32) one call moves ~0.9 MB and
// does ~13 MFLOP (~0.3 us and ~0.2 us at 3.35 TB/s and 67 TFLOP/s fp32): it
// costs its two launches' latency. At the eval shape (n_src = n_dst = 2708,
// F+1 = 33) the unique bytes are ~4.5 MB and the attention pass re-reads
// ~69 MB of wh rows through L2; the dependent idx -> score -> wh loads of a
// row set its time.
//
// Design. The TPU kernel re-projects all n_src rows for every (dst tile,
// head) program and gathers through one-hot (128 x n_src) matmuls per
// fanout column; here the projection runs once per source row and the
// gather is direct.
//  (a) gat_project_kernel: a block owns kProjRows source rows of one client
//      (blockIdx.y = m); the client's W (d x H*dh, 16 KB at 64 x 64) and the
//      rows of h are staged in shared memory, wh is computed in fp32 FMA and
//      written out, and the per-head scores wh.a_src and wh.a_dst are fused
//      into the epilogue, so the attention pass reads two floats a
//      (source, head) instead of dh.
//  (b) gat_attend_kernel: one warp per destination row of one client, all
//      heads. Lanes run over the fanout for the logits and the softmax
//      (warp shuffles for max and sum; a per-warp shared buffer holds the
//      F+1 logits, so any fanout works), then over the H*dh output columns
//      for the attention-weighted sum, one coalesced row segment of wh per
//      fanout entry; entries with att = 0 are skipped (their term is 0 * wh).
// Any H and dh work (lanes stride over columns). Indices are clamped to
// [0, n_src), as in the other kernels. fp32 throughout, no TF32; expf and
// expm1f are the accurate versions (no fast math). Tensor cores,
// asynchronous copies and fusing (a) into (b) are left for a later change.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kProjRows = 16;                 // source rows per block in (a)
constexpr int kProjThreads = 256;
constexpr int kAttWarps = 8;                  // destination rows per block in (b)
constexpr int kAttThreads = kAttWarps * 32;
constexpr size_t kMaxSmem = 232448;           // 227 KB a block may opt into
constexpr float kNegInf = -1e9f;              // the reference's mask fill

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (a) wh = h @ W and scores[n] = (wh.a_src per head, wh.a_dst per head)
__global__ void __launch_bounds__(kProjThreads)
gat_project_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ a_src,
                   const float* __restrict__ a_dst, float* __restrict__ wh,
                   float* __restrict__ scores, int n_src, int d, int n_heads,
                   int dh) {
  extern __shared__ float smem[];
  const int hd = n_heads * dh;
  float* w_s = smem;                    // (d, hd) weights of client m
  float* h_s = w_s + d * hd;            // (kProjRows, d) rows of h
  float* o_s = h_s + kProjRows * d;     // (kProjRows, hd) rows of wh

  const int m = blockIdx.y;
  const int row0 = blockIdx.x * kProjRows;
  const int rows = min(kProjRows, n_src - row0);
  const float* hm = h + (static_cast<size_t>(m) * n_src + row0) * d;
  const float* wm = w + static_cast<size_t>(m) * d * hd;
  float* whm = wh + (static_cast<size_t>(m) * n_src + row0) * hd;
  float* sm = scores + (static_cast<size_t>(m) * n_src + row0) * 2 * n_heads;

  for (int i = threadIdx.x; i < d * hd; i += kProjThreads) w_s[i] = wm[i];
  for (int i = threadIdx.x; i < rows * d; i += kProjThreads) h_s[i] = hm[i];
  __syncthreads();

  // consecutive threads take consecutive columns: w_s reads are
  // conflict-free, h_s reads a broadcast
  for (int i = threadIdx.x; i < rows * hd; i += kProjThreads) {
    const int r = i / hd;
    const int c = i - r * hd;
    const float* hr = h_s + r * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(hr[k], w_s[k * hd + c], acc);
    o_s[i] = acc;
    whm[i] = acc;
  }
  __syncthreads();

  // scores of row r: [a_src . wh_k for k < H, a_dst . wh_k for k < H]
  const float* asm_ = a_src + static_cast<size_t>(m) * hd;
  const float* adm = a_dst + static_cast<size_t>(m) * hd;
  for (int i = threadIdx.x; i < rows * 2 * n_heads; i += kProjThreads) {
    const int r = i / (2 * n_heads);
    const int which = (i - r * 2 * n_heads) / n_heads;
    const int k = i - r * 2 * n_heads - which * n_heads;
    const float* a = (which == 0 ? asm_ : adm) + k * dh;
    const float* o = o_s + r * hd + k * dh;
    float acc = 0.f;
    for (int j = 0; j < dh; ++j) acc = fmaf(o[j], a[j], acc);
    sm[i] = acc;
  }
}

// (b) masked softmax attention over the fanout, mix, bias, elu
__global__ void __launch_bounds__(kAttThreads)
gat_attend_kernel(const int* __restrict__ idx, const float* __restrict__ mask,
                  const float* __restrict__ wh,
                  const float* __restrict__ scores,
                  const float* __restrict__ b, float* __restrict__ out,
                  float* __restrict__ p_out, float* __restrict__ x_out,
                  int n_src, int n_dst, int f1, int n_heads, int dh) {
  extern __shared__ float smem[];
  const int hd = n_heads * dh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // per warp: f1 clamped source ids, then (f1, H) logits / attention
  int* src_s = reinterpret_cast<int*>(smem) + warp * f1;
  float* att_s = smem + kAttWarps * f1 + warp * f1 * n_heads;

  const int m = blockIdx.y;
  const int r = blockIdx.x * kAttWarps + warp;
  if (r >= n_dst) return;  // ragged last tile; no block barrier follows

  const size_t row = static_cast<size_t>(m) * n_dst + r;
  const int* ir = idx + row * f1;
  const float* mr = mask + row * f1;
  const float* sm = scores + static_cast<size_t>(m) * n_src * 2 * n_heads;
  const float* whm = wh + static_cast<size_t>(m) * n_src * hd;

  for (int f = lane; f < f1; f += 32) src_s[f] = min(max(ir[f], 0), n_src - 1);
  __syncwarp();
  const float* s_self = sm + static_cast<size_t>(src_s[0]) * 2 * n_heads;

  // each lane owns fanout entries f = lane, lane + 32, ... in every pass
  for (int k = 0; k < n_heads; ++k) {
    const float ss = s_self[k];
    float mx = -INFINITY;
    for (int f = lane; f < f1; f += 32) {
      const float xv =
          ss + sm[static_cast<size_t>(src_s[f]) * 2 * n_heads + n_heads + k];
      float e = xv >= 0.f ? xv : 0.2f * xv;
      if (!(mr[f] > 0.f)) e = kNegInf;
      att_s[f * n_heads + k] = e;
      if (x_out != nullptr) x_out[(row * f1 + f) * n_heads + k] = xv;
      mx = fmaxf(mx, e);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int f = lane; f < f1; f += 32) {
      const float pv = expf(att_s[f * n_heads + k] - mx);
      att_s[f * n_heads + k] = pv;
      sum += pv;
    }
    sum = warp_sum(sum);
    for (int f = lane; f < f1; f += 32) {
      const float pv = att_s[f * n_heads + k] / sum;
      if (p_out != nullptr) p_out[(row * f1 + f) * n_heads + k] = pv;
      att_s[f * n_heads + k] = pv * mr[f];
    }
  }
  __syncwarp();

  const float* bm = b + static_cast<size_t>(m) * hd;
  float* outr = out + row * hd;
  for (int c = lane; c < hd; c += 32) {
    const int k = c / dh;
    float acc = 0.f;
    for (int f = 0; f < f1; ++f) {
      const float a = att_s[f * n_heads + k];
      if (a != 0.f)
        acc = fmaf(a, whm[static_cast<size_t>(src_s[f]) * hd + c], acc);
    }
    const float y = acc + bm[c];
    outr[c] = y > 0.f ? y : expm1f(y);
  }
}

cudaError_t opt_in(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// h: (m, n_src, d) f32; idx: (m, n_dst, f1) i32; mask: (m, n_dst, f1) f32;
// w: (m, d, n_heads, dh) f32; a_src/a_dst: (m, n_heads, dh) f32;
// b: (m, n_heads * dh) f32; out: (m, n_dst, n_heads * dh) f32;
// wh: (m, n_src, n_heads * dh) f32 and scores: (m, n_src, 2, n_heads) f32
// scratch the caller allocates (wh is also the backward's input);
// p_out/x_out: null or (m, n_dst, f1, n_heads) f32. All contiguous on CUDA
// device `device`. Launches (a) then (b) on `stream` and returns the first
// launch error (0 on success); never synchronises. The library links its
// own CUDA runtime, so the device is set here rather than inherited.
extern "C" int gat_layer_launch(const float* h, const int* idx,
                                const float* mask, const float* w,
                                const float* a_src, const float* a_dst,
                                const float* b, float* out, float* wh,
                                float* scores, float* p_out, float* x_out,
                                int m, int n_src, int n_dst, int f1, int d,
                                int n_heads, int dh, int device,
                                void* stream) {
  if (m <= 0 || n_src <= 0 || n_dst <= 0 || f1 <= 0 || d <= 0 ||
      n_heads <= 0 || dh <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t hd = static_cast<size_t>(n_heads) * dh;
  const size_t smem_a =
      (static_cast<size_t>(d) * hd + static_cast<size_t>(kProjRows) * d +
       kProjRows * hd) * sizeof(float);
  const size_t smem_b =
      static_cast<size_t>(kAttWarps) * f1 * (1 + n_heads) * sizeof(float);
  if (smem_a > kMaxSmem || smem_b > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in(reinterpret_cast<const void*>(gat_project_kernel), smem_a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = opt_in(reinterpret_cast<const void*>(gat_attend_kernel), smem_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  const dim3 grid_a((n_src + kProjRows - 1) / kProjRows, m);
  gat_project_kernel<<<grid_a, kProjThreads, smem_a, s>>>(
      h, w, a_src, a_dst, wh, scores, n_src, d, n_heads, dh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 grid_b((n_dst + kAttWarps - 1) / kAttWarps, m);
  gat_attend_kernel<<<grid_b, kAttThreads, smem_b, s>>>(
      idx, mask, wh, scores, b, out, p_out, x_out, n_src, n_dst, f1, n_heads,
      dh);
  return static_cast<int>(cudaGetLastError());
}
