// Backward of the fused GCNII client sub-layer for Hopper (sm_90a), all
// clients in two launches.
//
// Replaces no TPU kernel: the reference differentiates the forward
// (`gcnii_layer_pallas` in src/repro/kernels/graph_agg.py) with jax.vjp in
// XLA, outside any Pallas kernel. The port's plain version of the same VJP,
// `ops.gcnii_layer_backward`, runs on the CPU and stays the oracle; on the
// card it cost ~47 small ops a sub-layer and two accumulating index_put_
// calls, each of which sorts. For every client m, with g the output's
// cotangent and z, out the forward's saved intermediate and output:
//
//   gp  = g * (out > 0)                                    (through the relu)
//   db  = sum_r gp[r]
//   dW  = beta * z^T gp
//   dz  = (1 - beta) * gp + beta * gp W^T
//   dh [idx[r,f]] += (1 - alpha) * mask[r,f] / max(sum_f mask[r,f], 1) * dz[r]
//   dh0[idx[r,0]] += alpha * dz[r]            (unmasked, as the forward reads h0)
//
// What bounds it on this card: at the training shapes (M = 3, n_dst <= 512,
// F+1 = 4, d = 64) a call moves ~1.5 MB and does ~13 MFLOP (~0.5 us at 3.35
// TB/s): latency. What made the plain VJP slow on the card was the scatter:
// the sampler points every masked fanout slot (and a padding row's self
// column) at row 0, so row 0 of a client receives most of the n_dst·(F+1)
// entries, and the sorted index_put_ adds a run of equal indices one after
// another inside one warp.
//
// Design, two launches chained by programmatic dependent launch (PDL), with
// no float atomics and no sort, so a call is bitwise repeatable:
//  - (1) gcnii_grad_dz_kernel, one block per `rows` destination rows of a
//    client (blockIdx.y = m): stages W^T, gp and z of its rows in shared
//    memory, writes dz (graph_common.cuh matmul_rows, the identity map as
//    its epilogue), the rows' scatter coefficients, and its rows' partial
//    sums of db and dW (rows ascending). It lets (2) launch at once.
//  - (2) gcnii_grad_scatter_kernel, the transposed gather. A block owns
//    `tile` source rows of a client; each of its warps sweeps one
//    contiguous share of the client's n_dst·(F+1) entries, 32 at a time,
//    ascending, with __ballot_sync on "idx falls in the tile", and adds each
//    hit's coef·dz[r] (and alpha·dz[r] at column 0) into its own
//    accumulator rows in shared memory, up to kBatch dz rows in flight a
//    warp. The warps' accumulators are then summed in warp order. Row 0's
//    hundreds of duplicates are shared by the block's warps. Masked slots
//    (coef 0) add exactly zero for finite dz and are skipped. Further blocks
//    of the same grid add the partial sums of (1) into dW and db, tile
//    ascending. Every sum has one fixed order whatever the timing.
// Indices are clamped to [0, n_src) as the forward clamps them.
//
// Cost: each of a client's n_src/tile scatter blocks reads all n_dst·(F+1)
// indices, so the index reads grow as the sampler's size_cap squared. At
// cap 8192 (M = 3, d = 64) it still takes 1/24 of the plain VJP's device
// time on an H100 (tools/gcnii_grad_scaling.py); a larger cap would want a
// first pass that buckets the entries by source tile (counts and offsets,
// no float atomics).
//
// Precision: fp32 FMA throughout, no TF32.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry points at the bottom.

#include <cuda_runtime.h>

#include <algorithm>

#include "graph_common.cuh"

namespace {

using namespace graph_common;

constexpr int kDzThreads = 256;
constexpr int kDzRows = 32;          // destination rows a block of (1), at most
constexpr int kMaxWarps = 16;        // warps a scatter block
constexpr int kTileRows = 8;         // source rows a scatter block, at most
constexpr int kBatch = 8;            // dz rows in flight a warp
constexpr size_t kScatterSmem = 64 * 1024;  // three blocks an SM
constexpr unsigned kFull = 0xffffffffu;

// matmul_rows' epilogue: dz = (1 - beta) gp + beta (gp @ W^T), gp in shared
// memory
struct DzMap {
  const float* gp;
  int gpp;
  float beta;

  template <int VEC>
  __device__ __forceinline__ void operator()(int r, int c0,
                                             float (&acc)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = (1.f - beta) * gp[r * gpp + c0 + i] + beta * acc[i];
  }
};

// (1): gp, dz, the scatter coefficients and the partial sums of dW and db of
// `rows` destination rows of client m. A null output is not needed.
template <int VEC>
__global__ void __launch_bounds__(kDzThreads)
gcnii_grad_dz_kernel(const float* __restrict__ g,
                     const float* __restrict__ out,
                     const float* __restrict__ z,
                     const float* __restrict__ w,
                     const float* __restrict__ mask, float* __restrict__ dz,
                     float* __restrict__ coef, float* __restrict__ dwp,
                     float* __restrict__ dbp, int n_dst, int f1, int d,
                     float alpha, float beta, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int gpp = (d + 3) / 4 * 4 + 4;  // padded gp row: float4 reads
  float* wt_s = smem;                        // (d, d): W^T of client m
  float* gp_s = smem + (d * d + 3) / 4 * 4;  // (rows, gpp)
  float* z_s = gp_s + rows * gpp;            // (rows, d)

  const int m = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int r0 = tile * rows;
  const int nrows = min(rows, n_dst - r0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t row0 = static_cast<size_t>(m) * n_dst + r0;

  // the scatter grid may start its prologue now: it reads nothing of this
  // grid before its griddepcontrol.wait, which returns only once this grid
  // has finished and its stores are visible
  pdl_launch_dependents();

  if (dz != nullptr) {
    // wt[k][c] = w[c][k]: the product reads W^T rows as matmul_rows wants
    // them; W is 16 KB at d = 64 and comes from L2 after the first block
    const float* wm = w + static_cast<size_t>(m) * d * d;
    for (int i = tid; i < d * d; i += nthreads) {
      const int k = i / d;
      const int c = i - k * d;
      wt_s[i] = wm[static_cast<size_t>(c) * d + k];
    }
  }
  for (int i = tid; i < nrows * d; i += nthreads) {
    const int r = i / d;
    const int c = i - r * d;
    const size_t at = row0 * d + i;
    gp_s[r * gpp + c] = g[at] * (out[at] > 0.f ? 1.f : 0.f);
    if (dwp != nullptr) z_s[i] = z[at];
  }
  if (coef != nullptr) {
    for (int r = tid; r < nrows; r += nthreads) {
      const float* mr = mask + (row0 + r) * f1;
      float msum = 0.f;
      for (int f = 0; f < f1; ++f) msum += mr[f];
      const float denom = fmaxf(msum, 1.f);
      float* cr = coef + (row0 + r) * f1;
      for (int f = 0; f < f1; ++f) cr[f] = (1.f - alpha) * (mr[f] / denom);
    }
  }
  __syncthreads();

  if (dbp != nullptr) {
    float* pb = dbp + (static_cast<size_t>(m) * n_tiles + tile) * d;
    for (int c = tid; c < d; c += nthreads) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s += gp_s[r * gpp + c];
      pb[c] = s;
    }
  }
  if (dwp != nullptr) {
    // z^T gp over this tile's rows, r ascending: a thread owns dW rows
    // (2p, 2p + 1) x VEC columns
    float* pw = dwp + (static_cast<size_t>(m) * n_tiles + tile) * d * d;
    const int nco = d / VEC;
    const int npairs = (d + 1) / 2;
    for (int it = tid; it < npairs * nco; it += nthreads) {
      const int ka = 2 * (it / nco);
      const int kb = min(ka + 1, d - 1);
      const int c0 = (it % nco) * VEC;
      float acc_a[VEC], acc_b[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc_a[i] = acc_b[i] = 0.f;
      for (int r = 0; r < nrows; ++r) {
        const float za = z_s[r * d + ka];
        const float zb = z_s[r * d + kb];
        float gv[VEC];
        load_vec<VEC>(gp_s + r * gpp + c0, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc_a[i] = fmaf(za, gv[i], acc_a[i]);
          acc_b[i] = fmaf(zb, gv[i], acc_b[i]);
        }
      }
      store_vec<VEC>(pw + static_cast<size_t>(ka) * d + c0, acc_a);
      if (ka + 1 < d)
        store_vec<VEC>(pw + static_cast<size_t>(ka + 1) * d + c0, acc_b);
    }
  }
  if (dz != nullptr)
    matmul_rows<VEC>(gp_s, gpp, wt_s, dz + row0 * d, nrows, d, d, tid,
                     nthreads, DzMap{gp_s, gpp, beta});
}

// (2): blocks [0, n_src_tiles) scatter dz into `tile` source rows each of
// dh and dh0; the rest add (1)'s partial sums into dW and db. Null outputs
// are not needed.
__global__ void __launch_bounds__(kMaxWarps * 32)
gcnii_grad_scatter_kernel(const int* __restrict__ idx,
                          const float* __restrict__ coef,
                          const float* __restrict__ dz,
                          const float* __restrict__ dwp,
                          const float* __restrict__ dbp,
                          float* __restrict__ dh, float* __restrict__ dh0,
                          float* __restrict__ dw, float* __restrict__ db,
                          int n_src, int n_dst, int f1, int d, float alpha,
                          float beta, int tile, int n_src_tiles,
                          int n_parts) {
  extern __shared__ __align__(16) float acc_s[];
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  if (static_cast<int>(blockIdx.x) >= n_src_tiles) {
    // dW = beta * sum_t dWp[t], db = sum_t dbp[t], t ascending
    pdl_wait();
    const int nw = dw != nullptr ? d * d : 0;
    const int nb = db != nullptr ? d : 0;
    const int stride = (gridDim.x - n_src_tiles) * nthreads;
    for (int o = (blockIdx.x - n_src_tiles) * nthreads + tid; o < nw + nb;
         o += stride) {
      if (o < nw) {
        const float* p = dwp + static_cast<size_t>(m) * n_parts * d * d + o;
        float s = 0.f;
        for (int t = 0; t < n_parts; ++t)
          s += p[static_cast<size_t>(t) * d * d];
        dw[static_cast<size_t>(m) * d * d + o] = beta * s;
      } else {
        const int c = o - nw;
        const float* p = dbp + static_cast<size_t>(m) * n_parts * d + c;
        float s = 0.f;
        for (int t = 0; t < n_parts; ++t) s += p[static_cast<size_t>(t) * d];
        db[static_cast<size_t>(m) * d + c] = s;
      }
    }
    return;
  }

  // each warp's accumulators: dh's (tile, d) rows, then dh0's
  const int warps = nthreads / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int plane = tile * d;
  const int h_planes = dh != nullptr ? warps : 0;
  float* acc_h = acc_s + static_cast<size_t>(warp) * plane;
  float* acc_h0 = acc_s + static_cast<size_t>(h_planes + warp) * plane;
  if (dh != nullptr)
    for (int i = lane; i < plane; i += 32) acc_h[i] = 0.f;
  if (dh0 != nullptr)
    for (int i = lane; i < plane; i += 32) acc_h0[i] = 0.f;
  __syncwarp();
  pdl_wait();

  const int s0 = blockIdx.x * tile;
  const int n_ent = n_dst * f1;
  const int per = ((n_ent + 31) / 32 + warps - 1) / warps * 32;
  const int e_end = min(n_ent, (warp + 1) * per);
  const int* idx_m = idx + static_cast<size_t>(m) * n_ent;
  const float* coef_m =
      dh != nullptr ? coef + static_cast<size_t>(m) * n_ent : nullptr;
  const float* dz_m = dz + static_cast<size_t>(m) * n_dst * d;
  for (int base = warp * per; base < e_end; base += 32) {
    const int e = base + lane;
    int local = 0;
    float ch = 0.f;
    int self = 0;
    if (e < e_end) {
      const int s = min(max(idx_m[e], 0), n_src - 1) - s0;
      if (s >= 0 && s < tile) {
        local = s;
        if (coef_m != nullptr) ch = coef_m[e];
        self = dh0 != nullptr && e % f1 == 0;
      }
    }
    unsigned hits = __ballot_sync(kFull, ch != 0.f || self);
    while (hits != 0u) {
      // the next kBatch hits, entry ascending (warp-uniform)
      int nb = 0;
      int rr[kBatch], lr[kBatch], sf[kBatch];
      float cf[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int src = hits != 0u ? __ffs(hits) - 1 : 0;
        nb += hits != 0u;
        hits &= hits - 1u;
        rr[j] = (base + src) / f1;
        lr[j] = __shfl_sync(kFull, local, src);
        cf[j] = __shfl_sync(kFull, ch, src);
        sf[j] = __shfl_sync(kFull, self, src);
      }
      for (int c = lane; c < d; c += 32) {
        float v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          v[j] = j < nb ? dz_m[static_cast<size_t>(rr[j]) * d + c] : 0.f;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j < nb) {
            if (cf[j] != 0.f) {
              float* a = acc_h + lr[j] * d + c;
              *a = fmaf(cf[j], v[j], *a);
            }
            if (sf[j]) {
              float* a = acc_h0 + lr[j] * d + c;
              *a = fmaf(alpha, v[j], *a);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // the warps' accumulators, warp ascending; every row of the tile written
  const int nrows = min(tile, n_src - s0);
  for (int o = tid; o < nrows * d; o += nthreads) {
    const size_t at = static_cast<size_t>(m) * n_src * d +
                      static_cast<size_t>(s0) * d + o;
    if (dh != nullptr) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w)
        s += acc_s[static_cast<size_t>(w) * plane + o];
      dh[at] = s;
    }
    if (dh0 != nullptr) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w)
        s += acc_s[static_cast<size_t>(h_planes + w) * plane + o];
      dh0[at] = s;
    }
  }
}

// launch (1)'s shared memory: W^T, then `rows` rows of gp (padded for
// float4 reads) and of z
size_t dz_smem(int rows, int d) {
  const size_t d4 = (d + 3) / 4 * 4;
  return ((static_cast<size_t>(d) * d + 3) / 4 * 4 + rows * (d4 + 4 + d)) *
         sizeof(float);
}

// destination rows a block of launch (1) takes: kDzRows, fewer where W^T
// and that many rows outgrow a block's shared memory; 0 where not even one
// row fits
int dz_rows(int n_dst, int d) {
  int rows = std::min(kDzRows, n_dst);
  while (rows > 0 && dz_smem(rows, d) > kSmemLimit) --rows;
  return rows;
}

cudaError_t opt_in(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// The row tiles of launch (1) for n_dst destination rows of width d: the
// T of the partial-sum scratch gcnii_grad_launch takes; 0 where W^T and one
// row do not fit a block's shared memory (the launch then fails too).
extern "C" int gcnii_grad_parts(int n_dst, int d) {
  if (n_dst <= 0 || d <= 0) return 0;
  const int rows = dz_rows(n_dst, d);
  return rows > 0 ? (n_dst + rows - 1) / rows : 0;
}

// g, out, z: (m, n_dst, d) f32; w: (m, d, d) f32; idx: (m, n_dst, f1) i32;
// mask: (m, n_dst, f1) f32; outputs dh, dh0: (m, n_src, d), dw: (m, d, d),
// db: (m, d) f32, each null where it is not needed; scratch dz: (m, n_dst,
// d), coef: (m, n_dst, f1), dwp: (m, T, d, d), dbp: (m, T, d) with T =
// gcnii_grad_parts(n_dst, d), null where its output is not needed (dz where
// neither dh nor dh0 is, coef where dh is not). All contiguous on CUDA device `device`. Launches both kernels on
// `stream` and returns the first failing launch's cudaError_t (0 on
// success); never synchronises.
extern "C" int gcnii_grad_launch(const float* g, const float* out,
                                 const float* z, const float* w,
                                 const int* idx, const float* mask, float* dh,
                                 float* dh0, float* dw, float* db, float* dz,
                                 float* coef, float* dwp, float* dbp, int m,
                                 int n_src, int n_dst, int f1, int d,
                                 float alpha, float beta, int device,
                                 void* stream) {
  if (m <= 0 || n_dst <= 0 || d <= 0 || n_src <= 0 || f1 <= 0 ||
      (dh == nullptr && dh0 == nullptr && dw == nullptr && db == nullptr) ||
      ((dh != nullptr || dh0 != nullptr) && dz == nullptr) ||
      (dh != nullptr && coef == nullptr) || (dw != nullptr && dwp == nullptr) ||
      (db != nullptr && dbp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  // (1): float4 columns need d % 4 == 0 and 16-byte aligned dz and dWp rows
  const int rows = dz_rows(n_dst, d);
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = dz_smem(rows, d);
  const bool vec4 = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(dz) | reinterpret_cast<uintptr_t>(dwp)) &
       15) == 0;
  const void* k1 = vec4 ? reinterpret_cast<const void*>(gcnii_grad_dz_kernel<4>)
                        : reinterpret_cast<const void*>(gcnii_grad_dz_kernel<1>);
  cudaError_t e = opt_in(k1, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_parts = (n_dst + rows - 1) / rows;
  const dim3 grid1(n_parts, m);
  if (vec4)
    gcnii_grad_dz_kernel<4><<<grid1, kDzThreads, smem1, s>>>(
        g, out, z, w, mask, dz, coef, dwp, dbp, n_dst, f1, d, alpha, beta,
        rows);
  else
    gcnii_grad_dz_kernel<1><<<grid1, kDzThreads, smem1, s>>>(
        g, out, z, w, mask, dz, coef, dwp, dbp, n_dst, f1, d, alpha, beta,
        rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // (2): a warp per 64 entries, up to kMaxWarps; tile rows, then warps,
  // halved while the accumulators outgrow kScatterSmem
  const int planes = (dh != nullptr) + (dh0 != nullptr);
  const long long n_ent = static_cast<long long>(n_dst) * f1;
  int warps = static_cast<int>(
      std::min<long long>(kMaxWarps, std::max(1LL, (n_ent + 63) / 64)));
  int tile = kTileRows;
  auto smem_of = [&](int wp, int t) {
    return static_cast<size_t>(planes) * wp * t * d * sizeof(float);
  };
  while (tile > 1 && smem_of(warps, tile) > kScatterSmem) tile /= 2;
  while (warps > 1 && smem_of(warps, tile) > kScatterSmem) warps /= 2;
  const size_t smem2 = smem_of(warps, tile);
  if (smem2 > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int threads2 = warps * 32;
  const int n_src_tiles = planes > 0 ? (n_src + tile - 1) / tile : 0;
  const long long n_red = (dw != nullptr ? static_cast<long long>(d) * d : 0) +
                          (db != nullptr ? d : 0);
  const int red_blocks = static_cast<int>((n_red + threads2 - 1) / threads2);
  e = opt_in(reinterpret_cast<const void*>(gcnii_grad_scatter_kernel), smem2);
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_src_tiles + red_blocks, m);
  cfg.blockDim = dim3(threads2);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gcnii_grad_scatter_kernel, idx,
                         static_cast<const float*>(coef),
                         static_cast<const float*>(dz),
                         static_cast<const float*>(dwp),
                         static_cast<const float*>(dbp), dh, dh0, dw, db,
                         n_src, n_dst, f1, d, alpha, beta, tile, n_src_tiles,
                         n_parts);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
