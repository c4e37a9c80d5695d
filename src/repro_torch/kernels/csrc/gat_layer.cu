// Fused multi-head GAT client sub-layer for Hopper (sm_90a), all clients in
// one call of two launches chained by programmatic dependent launch.
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
// does ~13 MFLOP (~0.3 us and ~0.2 us at 3.35 TB/s and 67 TFLOP/s fp32), so
// it costs latency: two launches, and within each a chain of dependent
// steps (W and h -> wh and scores; idx -> scores -> softmax -> wh rows ->
// out). Tensor cores would buy nothing here and cost the error budget. At
// the eval shape (n_src = n_dst = 2708, F+1 = 33) the attention pass
// re-reads ~69 MB of wh rows through L2, and the loads in flight set the
// time. The design cuts each chain to as few round trips as it can:
//  - Programmatic dependent launch (PDL) chains the two passes: (b) goes
//    out with the programmatic stream serialisation attribute, (a)
//    triggers its dependents as soon as it has issued its copies, so (b)'s
//    blocks are resident and have run their prologue (idx and mask by
//    cp.async into shared memory, each entry's source row resolved, b
//    loaded) when (a) drains; griddepcontrol.wait then returns once (a) has
//    finished and its stores are visible, and only after it does (b) read
//    wh or a score. Against triggering after the last store, against two
//    plain launches and against one cooperative launch with a grid-wide
//    barrier (which cannot launch at the eval shape: the grid outgrows the
//    blocks the card holds at once), this was the fastest at every shape
//    measured (tools/gat_chain_variants.py; PERF.md, PR 17).
//  - (a) gat_project_kernel: a block owns `rows` source rows of one client
//    (blockIdx.y = m; blocks shrink to a warp while the grid would leave
//    SMs idle). Thread 0 hands the client's W (d x H*dh, 16 KB at 64 x 64,
//    one contiguous block) to the copy engine with one cp.async.bulk on an
//    mbarrier while every thread cp.asyncs its rows of h. A lane group
//    covers a pair of rows, each lane VEC adjacent columns of both: 2 x VEC
//    independent accumulators a thread, each W float4 feeding both rows,
//    h and W read kStage k-steps ahead. The per-head scores wh.a_src and
//    wh.a_dst come from those registers in the same pass, by a chain of
//    shuffles that hands the partial sum lane to lane in column order.
//  - (b) gat_attend_kernel: phase A runs a lane group per destination row
//    sized to the fanout (the next power of two >= F+1, capped at 32) times
//    the heads it takes side by side, so at F+1 = 4 one warp serves four
//    rows, both heads at once; each lane issues its score loads before the
//    first max. Phase B runs a group per row over the output columns
//    (float4 segments of the gathered wh rows) and issues the loads of a
//    batch of up to 16 fanout entries before the first add: the resolved
//    source table (padded to whole batches) leaves no branch or select on a
//    loaded index to split a batch into dependent loads. A masked entry
//    reads the row's self row, in flight anyway, with att = 0.
//  - Two register budgets of each kernel (graph_common.cuh, pick_wide): the
//    wide build keeps a whole batch of loads in flight and is taken where
//    the grid fits on the card at once with it (the training shapes); the
//    narrow one, eight blocks an SM, past that (eval, serving).
// Indices are clamped to [0, n_src), as in the other kernels.
//
// Precision: fp32 FMA throughout, no TF32, accurate expf / expm1f (no fast
// math). Every sum runs in the order of the PR 13 kernel, so the outputs
// are bitwise its outputs: the projection and each score over k / j
// ascending in one fmaf chain from 0, the softmax's max and sum as the
// butterfly of per-lane partials over f ascending (lanes past F+1 hold
// exactly 0), the weighted sum over f ascending; a masked entry's term is
// fmaf(0, wh, acc) = acc exactly for finite wh, as the skip gave (acc
// starts at +0 and is never -0).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>
#include <math.h>

#include "graph_common.cuh"

namespace {

using namespace graph_common;

constexpr int kThreads = 128;
constexpr int kStage = 8;            // k-steps of h @ W staged at once
constexpr int kRowsPerThread = 2;    // rows of h @ W a thread, sharing W reads
constexpr int kTargetBlocks = 132;   // an SM each, where the rows allow
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may opt into
constexpr float kNegInf = -1e9f;     // the reference's mask fill
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return min(max(i, 0), n - 1);
}

// (a) wh = h @ W and scores[n] = (wh.a_src per head, wh.a_dst per head).
// A lane group of `lpr` lanes covers kRowsPerThread of the block's `rows`
// rows, lane lg the column groups cg = lg, lg + lpr, ... (VEC columns
// each). Every lane runs every shuffle loop the same number of times.
template <int VEC>
__device__ __forceinline__ void
project_rows(const float* __restrict__ h, const float* __restrict__ w,
             const float* __restrict__ a_src,
             const float* __restrict__ a_dst, float* __restrict__ wh,
             float* __restrict__ scores, int n_src, int d, int n_heads,
             int dh, int lpr, int rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t w_bar;
  const int hd = n_heads * dh;
  const int hp = (d + 3) / 4 * 4 + 4;  // padded h row: float4 reads,
                                       // no bank conflict
  float* w_s = smem;                         // (d, hd) weights of client m
  float* h_s = smem + (d * hd + 3) / 4 * 4;  // (rows, hp), 16-byte aligned

  const int m = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nrows = min(rows, n_src - r0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* hm = h + (static_cast<size_t>(m) * n_src + r0) * d;

  BulkLoad w_load{&w_bar, false};
  w_load.start(w_s, w + static_cast<size_t>(m) * d * hd, d * hd, tid,
               nthreads);
  // the attention grid may start its prologue now: it reads nothing of
  // this grid before its griddepcontrol.wait, which returns only once this
  // grid has finished and its stores are visible (triggering after the
  // stores instead measured slower; PERF.md, PR 17)
  pdl_launch_dependents();
  if (d % 4 == 0 && ((reinterpret_cast<uintptr_t>(hm) |
                      reinterpret_cast<uintptr_t>(h_s)) & 15) == 0) {
    const int q = d / 4;
    for (int i = tid; i < nrows * q; i += nthreads)
      cp_async16(h_s + (i / q) * hp + (i % q) * 4, hm + i * 4);
  } else {
    for (int i = tid; i < nrows * d; i += nthreads)
      cp_async4(h_s + (i / d) * hp + i % d, hm + i);
  }

  const int ncg = hd / VEC;
  const int npass = (ncg + lpr - 1) / lpr;
  const int grp = tid / lpr;
  const int lg = tid % lpr;
  const int gph = dh / VEC;        // column groups a head
  const int h2 = 2 * n_heads;
  const float* as_m = a_src + static_cast<size_t>(m) * hd;
  const float* ad_m = a_dst + static_cast<size_t>(m) * hd;
  float* whm = wh + (static_cast<size_t>(m) * n_src + r0) * hd;
  float* sm = scores + (static_cast<size_t>(m) * n_src + r0) * h2;

  cp_async_wait_all();
  __syncthreads();
  w_load.wait();

  // a group owns rows ra .. ra + kRowsPerThread - 1: every W read feeds all
  const int ra = grp * kRowsPerThread;
  bool row_ok[kRowsPerThread];
  const float* hr[kRowsPerThread];
  float cs[kRowsPerThread], cd[kRowsPerThread];  // chains into next pass
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    row_ok[t] = ra + t < nrows;
    hr[t] = h_s + (row_ok[t] ? ra + t : 0) * hp;
    cs[t] = cd[t] = 0.f;
  }
  for (int j = 0; j < npass; ++j) {
    const int cg = j * lpr + lg;
    const bool live = cg < ncg;
    const int c0 = (live ? cg : 0) * VEC;
    float as[VEC], ad[VEC];
    load_vec<VEC>(as_m + c0, as);
    load_vec<VEC>(ad_m + c0, ad);
    float acc[kRowsPerThread][VEC];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[t][i] = 0.f;
    // kStage k-steps' operands are read before their FMAs, so the reads
    // overlap; each sum still runs k = 0, 1, ...
    int k0 = 0;
    for (; k0 + kStage <= d; k0 += kStage) {
      float wv[kStage][VEC], hv[kRowsPerThread][kStage];
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t)
        load_run<kStage>(hr[t] + k0, hv[t]);
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        load_vec<VEC>(w_s + (k0 + u) * hd + c0, wv[u]);
#pragma unroll
      for (int u = 0; u < kStage; ++u)
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[t][i] = fmaf(hv[t][u], wv[u][i], acc[t][i]);
    }
    for (int k = k0; k < d; ++k) {
      float wv[VEC];
      load_vec<VEC>(w_s + k * hd + c0, wv);
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[t][i] = fmaf(hr[t][k], wv[i], acc[t][i]);
    }
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t)
      if (row_ok[t] && live)
        store_vec<VEC>(whm + (ra + t) * hd + c0, acc[t]);

    // score chains: the lane at position pos of its head continues the
    // sum its left neighbour (or, at lane 0, the previous pass) left
    const int pos = cg % gph;
    const int step = (pos == 0 || lg == 0) ? 0 : min(pos, lg);
    float vs[kRowsPerThread], vd[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) vs[t] = vd[t] = 0.f;
    // every lane runs every step and keeps its result only at its own
    // step: no branch, so the rows' and both scores' chains interleave
    const int nsteps = min(gph, lpr);
    for (int st = 0; st < nsteps; ++st) {
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t) {
        const float in_s = __shfl_up_sync(kFull, vs[t], 1, lpr);
        const float in_d = __shfl_up_sync(kFull, vd[t], 1, lpr);
        float ts = pos == 0 ? 0.f : (lg == 0 ? cs[t] : in_s);
        float td = pos == 0 ? 0.f : (lg == 0 ? cd[t] : in_d);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          ts = fmaf(acc[t][i], as[i], ts);
          td = fmaf(acc[t][i], ad[i], td);
        }
        vs[t] = step == st ? ts : vs[t];
        vd[t] = step == st ? td : vd[t];
      }
    }
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      cs[t] = __shfl_sync(kFull, vs[t], lpr - 1, lpr);
      cd[t] = __shfl_sync(kFull, vd[t], lpr - 1, lpr);
      if (row_ok[t] && live && pos == gph - 1) {
        const int k = cg / gph;
        sm[(ra + t) * h2 + k] = vs[t];
        sm[(ra + t) * h2 + n_heads + k] = vd[t];
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 8)
gat_project_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ a_src,
                   const float* __restrict__ a_dst, float* __restrict__ wh,
                   float* __restrict__ scores, int n_src, int d, int n_heads,
                   int dh, int lpr, int rows) {
  project_rows<VEC>(h, w, a_src, a_dst, wh, scores, n_src, d, n_heads, dh,
                    lpr, rows);
}

// the same with the register budget of one block an SM (pick_wide)
template <int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gat_project_kernel_wide(const float* __restrict__ h,
                        const float* __restrict__ w,
                        const float* __restrict__ a_src,
                        const float* __restrict__ a_dst,
                        float* __restrict__ wh, float* __restrict__ scores,
                        int n_src, int d, int n_heads, int dh, int lpr,
                        int rows) {
  project_rows<VEC>(h, w, a_src, a_dst, wh, scores, n_src, d, n_heads, dh,
                    lpr, rows);
}

// (b) masked softmax attention over the fanout, mix, bias, elu. Phase A: a
// lane group of gf * gh lanes a row, lane (hs, fl) the heads hs, hs + gh,
// ... and the entries fl, fl + gf, ...; phase B: a group of gb lanes a row,
// lane lb the column groups lb, lb + gb, ... A block owns `rows` rows, one
// a group of the wider kind; groups past them (and past n_dst) still run
// phase A's shuffles, on a real row's data, and store nothing.
template <int VEC, int BATCH>
__device__ __forceinline__ void
attend_rows(const int* __restrict__ idx, const float* __restrict__ mask,
            const float* __restrict__ wh,
            const float* __restrict__ scores,
            const float* __restrict__ b, float* __restrict__ out,
            float* __restrict__ p_out, float* __restrict__ x_out,
            int n_src, int n_dst, int f1, int n_heads, int dh, int gf,
            int gh, int gb, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int hd = n_heads * dh;
  const int f1p = (f1 + BATCH - 1) / BATCH * BATCH;  // whole batches
  int* idx_s = reinterpret_cast<int*>(smem);  // (rows, f1) source ids
  float* mask_s = smem + rows * f1;           // (rows, f1)
  int* src_s = reinterpret_cast<int*>(mask_s + rows * f1);  // (rows, f1p)
  float* att_s = mask_s + rows * f1 + rows * f1p;  // (rows, f1p, H) att

  const int m = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nrows = min(rows, n_dst - r0);
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(m) * n_dst + r0;

  // prologue, overlapping the projection: nothing here reads its output
  copy_async(idx_s, idx + row0 * f1, nrows * f1, tid, kThreads);
  copy_async(mask_s, mask + row0 * f1, nrows * f1, tid, kThreads);
  const int ncg = hd / VEC;
  const int sb = __ffs(gb) - 1;  // group widths are powers of two
  const int grp_b = tid >> sb;
  const int lb = tid & (gb - 1);
  const float* bm = b + static_cast<size_t>(m) * hd;
  float bias0[VEC];
  load_vec<VEC>(bm + min(lb, ncg - 1) * VEC, bias0);
  cp_async_wait_all();
  __syncthreads();
  // each entry's source row for the weighted sum, resolved once: a masked
  // entry (and the padding up to whole batches, att 0) reads the row's
  // self row, in flight anyway
  for (int i = tid; i < nrows * f1p; i += kThreads) {
    const int r = i / f1p;
    const int f = i - r * f1p;
    const bool live = f < f1 && mask_s[r * f1 + f] != 0.f;
    src_s[i] = clamp_idx(idx_s[r * f1 + (live ? f : 0)], n_src);
    if (f >= f1)
      for (int k = 0; k < n_heads; ++k) att_s[i * n_heads + k] = 0.f;
  }
  __syncthreads();
  pdl_wait();  // wh and the scores are complete and visible from here on

  // phase A: logits, softmax, attention
  const int ga = gf * gh;
  const int sa = __ffs(ga) - 1;
  const int grp_a = tid >> sa;
  const int hs = (tid & (ga - 1)) >> (__ffs(gf) - 1);
  const int fl = tid & (gf - 1);
  const int h2 = 2 * n_heads;
  const float* sm = scores + static_cast<size_t>(m) * n_src * h2;
  const int ne = (f1 + gf - 1) / gf;
  const int nk = (n_heads + gh - 1) / gh;
  const int rr = grp_a;
  const bool row_ok = rr < nrows;
  const int* ir = idx_s + (row_ok ? rr : 0) * f1;
  const float* mr = mask_s + (row_ok ? rr : 0) * f1;
  float* ar = att_s + rr * f1p * n_heads;
  const size_t row = row0 + rr;
  const float* s_self =
      sm + static_cast<size_t>(clamp_idx(ir[0], n_src)) * h2;
  for (int kk = 0; kk < nk; ++kk) {
    const int k = hs + gh * kk;
    const bool ok = row_ok && k < n_heads;  // one value a gf-lane group
    const int kc = k < n_heads ? k : 0;
    const float ss = s_self[kc];
    float mx = -INFINITY;
    for (int e = 0; e < ne; ++e) {
      const int f = fl + gf * e;
      if (ok && f < f1) {
        const float xv = ss + sm[static_cast<size_t>(clamp_idx(ir[f], n_src))
                                     * h2 + n_heads + kc];
        float ev = xv >= 0.f ? xv : 0.2f * xv;
        if (!(mr[f] > 0.f)) ev = kNegInf;
        ar[f * n_heads + k] = ev;
        if (x_out != nullptr) x_out[(row * f1 + f) * n_heads + k] = xv;
        mx = fmaxf(mx, ev);
      }
    }
    for (int o = gf / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float sum = 0.f;
    for (int e = 0; e < ne; ++e) {
      const int f = fl + gf * e;
      if (ok && f < f1) {
        const float pv = expf(ar[f * n_heads + k] - mx);
        ar[f * n_heads + k] = pv;
        sum += pv;
      }
    }
    for (int o = gf / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(kFull, sum, o);
    for (int e = 0; e < ne; ++e) {
      const int f = fl + gf * e;
      if (ok && f < f1) {
        const float pv = ar[f * n_heads + k] / sum;
        if (p_out != nullptr) p_out[(row * f1 + f) * n_heads + k] = pv;
        ar[f * n_heads + k] = pv * mr[f];
      }
    }
  }

  __syncthreads();

  // phase B: out = elu(sum_f att[f] * wh[src_f] + b), f ascending
  const float* whm = wh + static_cast<size_t>(m) * n_src * hd;
  if (const int rr = grp_b; rr < nrows) {
    const int* sr = src_s + rr * f1p;
    const float* ar = att_s + rr * f1p * n_heads;
    float* outr = out + (row0 + rr) * hd;
    for (int cg = lb; cg < ncg; cg += gb) {
      const int c0 = cg * VEC;
      const int k = c0 / dh;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for (int fb = 0; fb < f1; fb += BATCH) {
        float a[BATCH];
        float v[BATCH][VEC];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          a[u] = ar[(fb + u) * n_heads + k];
          load_vec<VEC>(whm + static_cast<size_t>(sr[fb + u]) * hd + c0, v[u]);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(a[u], v[u][i], acc[i]);
        }
      }
      float bv[VEC];
      if (cg == lb) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) bv[i] = bias0[i];
      } else {
        load_vec<VEC>(bm + c0, bv);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float y = acc[i] + bv[i];
        acc[i] = y > 0.f ? y : expm1f(y);
      }
      store_vec<VEC>(outr + c0, acc);
    }
  }
}

template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads, 8)
gat_attend_kernel(const int* __restrict__ idx, const float* __restrict__ mask,
                  const float* __restrict__ wh,
                  const float* __restrict__ scores,
                  const float* __restrict__ b, float* __restrict__ out,
                  float* __restrict__ p_out, float* __restrict__ x_out,
                  int n_src, int n_dst, int f1, int n_heads, int dh, int gf,
                  int gh, int gb, int rows) {
  attend_rows<VEC, BATCH>(idx, mask, wh, scores, b, out, p_out, x_out, n_src,
                          n_dst, f1, n_heads, dh, gf, gh, gb, rows);
}

// the same with the register budget of one block an SM (pick_wide)
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads, 1)
gat_attend_kernel_wide(const int* __restrict__ idx,
                       const float* __restrict__ mask,
                       const float* __restrict__ wh,
                       const float* __restrict__ scores,
                       const float* __restrict__ b, float* __restrict__ out,
                       float* __restrict__ p_out, float* __restrict__ x_out,
                       int n_src, int n_dst, int f1, int n_heads, int dh,
                       int gf, int gh, int gb, int rows) {
  attend_rows<VEC, BATCH>(idx, mask, wh, scores, b, out, p_out, x_out, n_src,
                          n_dst, f1, n_heads, dh, gf, gh, gb, rows);
}

cudaError_t opt_in(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

template <int VEC>
int launch(const float* h, const int* idx, const float* mask, const float* w,
           const float* a_src, const float* a_dst, const float* b,
           float* out, float* wh, float* scores, float* p_out, float* x_out,
           int m, int n_src, int n_dst, int f1, int d, int n_heads, int dh,
           cudaStream_t s) {
  const int hd = n_heads * dh;
  const int ncg = hd / VEC;

  // (a): a lane group of lpr lanes a row pair; threads a block halved
  // (down to one warp) while the grid would leave SMs idle
  const int lpr = min(32, pow2_ceil(ncg));
  int threads_a = kThreads;
  while (threads_a > 32 &&
         m * n_src / (threads_a / lpr * kRowsPerThread) < kTargetBlocks)
    threads_a /= 2;
  const int rows_a = threads_a / lpr * kRowsPerThread;
  const size_t hp = (d + 3) / 4 * 4 + 4;
  const size_t smem_w = (static_cast<size_t>(d) * hd + 3) / 4 * 4 *
                        sizeof(float);
  const size_t smem_a = smem_w + rows_a * hp * sizeof(float);

  // (b): lane groups of gf * gh (phase A) and gb (phase B) lanes a row
  const int gf = min(32, pow2_ceil(f1));
  const int gh = min(pow2_floor(n_heads), 32 / gf);
  const int gb = min(32, pow2_ceil(ncg));
  const int rows_b = kThreads / max(gf * gh, gb);
  const int batch = f1 <= 4 ? 4 : 16;
  const size_t f1p = (f1 + batch - 1) / batch * batch;
  const size_t smem_b = rows_b * (2 * static_cast<size_t>(f1) +
                                  f1p * (1 + n_heads)) * sizeof(float);
  if (smem_a > kMaxSmem || smem_b > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);

  using Project = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, int, int, int, int,
                           int, int);
  using Attend = void (*)(const int*, const float*, const float*,
                          const float*, const float*, float*, float*, float*,
                          int, int, int, int, int, int, int, int, int);
  // wh loads in flight a lane: one batch of 4 a row at the training
  // fanout, batches of 16 past it (three at the eval fanout of 33)
  const Attend attend_narrow = batch == 4 ? gat_attend_kernel<VEC, 4>
                                          : gat_attend_kernel<VEC, 16>;
  const Attend attend_wide = batch == 4 ? gat_attend_kernel_wide<VEC, 4>
                                        : gat_attend_kernel_wide<VEC, 16>;
  const void* kernels[4] = {
      reinterpret_cast<const void*>(gat_project_kernel<VEC>),
      reinterpret_cast<const void*>(gat_project_kernel_wide<VEC>),
      reinterpret_cast<const void*>(attend_narrow),
      reinterpret_cast<const void*>(attend_wide)};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = opt_in(kernels[i], i < 2 ? smem_a : smem_b);
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  const dim3 grid_a((n_src + rows_a - 1) / rows_a, m);
  const Project project =
      pick_wide<Project>(gat_project_kernel<VEC>, gat_project_kernel_wide<VEC>,
                         grid_a.x * grid_a.y, threads_a, smem_a);
  project<<<grid_a, threads_a, smem_a, s>>>(
      h, w, a_src, a_dst, wh, scores, n_src, d, n_heads, dh, lpr, rows_a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 grid_b((n_dst + rows_b - 1) / rows_b, m);
  const Attend attend = pick_wide(attend_narrow, attend_wide,
                                  grid_b.x * grid_b.y, kThreads, smem_b);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid_b;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_b;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, attend, idx, mask,
                         static_cast<const float*>(wh),
                         static_cast<const float*>(scores), b, out, p_out,
                         x_out, n_src, n_dst, f1, n_heads, dh, gf, gh, gb,
                         rows_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 columns need dh % 4 == 0 and 16-byte aligned vectors (a view
  // with an odd storage offset takes the scalar instantiation)
  const bool vec4 = dh % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a_src) | reinterpret_cast<uintptr_t>(a_dst)
        | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)
        | reinterpret_cast<uintptr_t>(wh)) & 15) == 0;
  if (vec4)
    return launch<4>(h, idx, mask, w, a_src, a_dst, b, out, wh, scores,
                     p_out, x_out, m, n_src, n_dst, f1, d, n_heads, dh, s);
  return launch<1>(h, idx, mask, w, a_src, a_dst, b, out, wh, scores, p_out,
                   x_out, m, n_src, n_dst, f1, d, n_heads, dh, s);
}
