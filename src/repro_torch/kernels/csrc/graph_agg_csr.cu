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
// What bounds it on this card: latency. At the serving shape (M = 2,
// n_src = 67600, n_dst = 1040, slab = 128 * 33, d = d_out = 32) one launch
// reads the three slabs (12 B a slot, 0.9 MB), the h rows its live edges
// name (128 B each) and W: under 2 MB, ~0.5 us at 3.35 TB/s, and a few
// MFLOP (chip_smoke.py computes the bound from each run's inputs). What a
// launch costs is its chain of dependent round trips: seg -> row ranges ->
// idx -> h rows -> mean -> product.
//
// What the first version lost, and what this design does about it:
//  - One block per (tile, client) gave 18 blocks on 132 SMs. Now a block
//    takes `rows` rows of one tile (16 at d = 32, fewer while the grid
//    would leave SMs idle): blockIdx.x = tile * groups + group, blockIdx.y
//    = client; 144 blocks at the serving shape.
//  - Every launch counting-sorted every slab into device scratch, though
//    every slab the port builds is in row order (ell_to_slabs: row-major
//    slots; plan_csr_slabs: CSR order, pads last). Now the block copies the
//    tile's seg into shared memory (cp.async, in windows of up to 8192
//    slots), checks that it (pads counted as 128) never decreases, and
//    finds its rows' first slots by binary search. Only a tile that is out
//    of order takes the sorting path, inside the kernel: count (one shared
//    integer atomic a distinct row a warp), scan, and a stable placement of
//    the block's own rows' slot positions (in slab order, ranked by
//    __match_any_sync), each then resolved to its (idx, ew). The sorted
//    run stays in shared memory when it fits, else goes to device scratch
//    (8 B a slot, allocated by the wrapper; blocks of one tile write
//    disjoint ranges). Either way the block's rows own one contiguous run
//    of slots, which comes into shared memory by cp.async when it fits.
//  - One warp summed a row, (idx, ew) shuffled out one entry at a time and
//    each h load under a branch; a hub row of 6000 edges was one warp's
//    serial chain. Now a lane group of `gw` lanes (8 at d = 32; VEC = 4
//    columns a lane, float4 loads) owns a row and issues the h loads of a
//    batch of slots (17 at the serving fanout of 33: two batches a row)
//    before the first add, with no branch between them: the batch's tail
//    past the row's end reads the row's last slot's source row with weight
//    0, and a weight-0 slot (an ELL mask's zero) adds fmaf(0, h, s) = s. A
//    row of more than kHub slots is a hub: every lane group of the block
//    takes one fixed contiguous chunk of it, and the partial sums are added
//    in chunk order in shared memory.
//  - W was staged with plain loads and the product was one chain an output.
//    Now W comes by one cp.async.bulk on an mbarrier (graph_common.cuh
//    BulkLoad) under the index work, and the product (matmul_rows) gives
//    each thread two rows x VEC columns of independent accumulators.
// There are no floating-point atomics: a row's sums run in slab order
// (a hub row's chunks in order too), so the result is the same on every
// run. Source ids are clamped to [0, n_src) so a bad index cannot fault.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_runtime.h>

#include "graph_common.cuh"

namespace {

using namespace graph_common;

constexpr int kTile = 128;            // DST_BLOCK of the layout
constexpr int kThreads = 128;
constexpr int kWindow = 8192;         // slots of seg / of a run in smem
constexpr int kHub = 64;              // a row of more slots is split
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int key_of(int seg) {
  return static_cast<unsigned>(seg) < static_cast<unsigned>(kTile) ? seg
                                                                   : kTile;
}

// One (tile, client)'s slab and its scratch.
struct Slab {
  const int* idx;
  const int* seg;
  const float* ew;
  int* sidx;
  float* sew;
  int n;  // slots
};

// Shared state of the index work.
struct Index {
  int* seg_s;  // a window of seg
  int win;     // its capacity, slots
  int* start;  // [kTile + 1] first slot of each row, in slab or sorted order
  int* count;  // [kTile] slots of each row (the sorting path)
  int* carry;  // the last key of the previous window
};

// Calls body(w0, wn) with seg[w0, w0 + wn) in ix.seg_s, window by window.
// A slab that fits one window is copied in once and left there.
template <class Body>
__device__ __forceinline__ void for_windows(const Slab& t, const Index& ix,
                                            bool& loaded, int tid, int nt,
                                            Body body) {
  for (int w0 = 0; w0 < t.n; w0 += ix.win) {
    const int wn = min(ix.win, t.n - w0);
    if (!loaded) {
      __syncthreads();  // the previous window's readers are done
      copy_async(ix.seg_s, t.seg + w0, wn, tid, nt);
      cp_async_wait_all();
      __syncthreads();
      loaded = t.n <= ix.win;
    }
    body(w0, wn);
  }
}

// Rows [lo, hi] of a tile in row order start at start[lo .. hi]: start[r]
// is the number of slots whose key (seg, or 128 for a pad) is below r.
// Checks that the key never steps down (the tile is in row order), and if
// so finds each start by binary search: over the slab in shared memory
// when it fit one window, else in device memory. Ends on a barrier.
__device__ bool find_rows(const Slab& t, const Index& ix, bool& loaded,
                          int lo, int hi, int tid, int nt) {
  int bad = 0;
  for_windows(t, ix, loaded, tid, nt, [&](int w0, int wn) {
#pragma unroll 4
    for (int i = tid; i < wn; i += nt) {
      const int kp = i > 0 ? key_of(ix.seg_s[i - 1])
                           : (w0 > 0 ? *ix.carry : -1);
      bad |= key_of(ix.seg_s[i]) < kp;
    }
    if (tid == 0) *ix.carry = key_of(ix.seg_s[wn - 1]);
  });
  if (__syncthreads_or(bad)) return false;
  const int* keys = loaded ? ix.seg_s : t.seg;
  for (int r = lo + tid; r <= hi; r += nt) {
    int a = 0;
    int b = t.n;
    while (a < b) {
      const int mid = (a + b) / 2;
      if (key_of(keys[mid]) < r) a = mid + 1;
      else b = mid;
    }
    ix.start[r] = a;
  }
  __syncthreads();
  return true;
}

// Where the slots of rows [lo, hi) are read from once the index work is
// done: slot e's source id and weight at idx[e - off] and ew[e - off].
struct Run {
  const int* idx;
  const float* ew;
  int off;
};

// A tile out of row order: find start[lo .. hi] in the order that sorts
// the slab by row, place the slot positions of rows [lo, hi) stably (in
// slab order) at start[r] ..., and resolve each placed position to its
// clamped source id and weight. Every row's slots are counted (one shared
// atomic a distinct row a warp) and scanned, and warp w places rows lo + w,
// lo + w + nwarps, ... ranked by __match_any_sync. The run
// [start[lo], start[hi]) goes to `area` (2 * ix.win words of shared memory:
// ids, then positions and weights) when one is given and the run fits
// ix.win, else to t.sidx / t.sew. Ends on a barrier.
__device__ Run sort_rows(const Slab& t, const Index& ix, bool& loaded,
                         int lo, int hi, int n_src, int* area, int tid,
                         int nt) {
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nt / 32;  // a power of two
  const unsigned lower = (1u << lane) - 1u;
  for (int r = tid; r < kTile; r += nt) ix.count[r] = 0;
  __syncthreads();
  for_windows(t, ix, loaded, tid, nt, [&](int, int wn) {
    for (int b = warp * 32; b < wn; b += nt) {
      const int i = b + lane;
      const int k = i < wn ? key_of(ix.seg_s[i]) : kTile;
      const unsigned peers = __match_any_sync(kFull, k);
      if (k < kTile && (peers & lower) == 0)
        atomicAdd(&ix.count[k], __popc(peers));
    }
  });
  __syncthreads();
  if (warp == 0) {  // exclusive scan, four rows a lane
    int c[kTile / 32];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      c[k] = ix.count[lane * (kTile / 32) + k];
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
      ix.start[lane * (kTile / 32) + k] = run;
      ix.count[lane * (kTile / 32) + k] = 0;  // from here: placed so far
      run += c[k];
    }
    if (lane == 31) ix.start[kTile] = run;
  }
  __syncthreads();
  const int ra = ix.start[lo];
  const int run = ix.start[hi] - ra;
  const bool smem = area != nullptr && run <= ix.win;
  // positions of the run: beside the seg window in shared memory, or in
  // the scratch
  int* pos = smem ? area + ix.win : t.sidx + ra;
  for_windows(t, ix, loaded, tid, nt, [&](int w0, int wn) {
    if (warp >= hi - lo) return;  // owns no row
    for (int b = 0; b < wn; b += 32) {
      const int i = b + lane;
      const int k = i < wn ? key_of(ix.seg_s[i]) : kTile;
      const bool own = k >= lo && k < hi && ((k - lo) & (nwarps - 1)) == warp;
      const unsigned peers = __match_any_sync(kFull, own ? k : -1);
      const int rank = __popc(peers & lower);
      if (own) pos[ix.start[k] - ra + ix.count[k] + rank] = w0 + i;
      __syncwarp();
      if (own && rank == 0) ix.count[k] += __popc(peers);
      __syncwarp();
    }
  });
  __syncthreads();
  // resolve: ids over the (no longer needed) seg window, weights over the
  // positions, each thread in place of what it read
  int* di = smem ? area : t.sidx + ra;
  float* de = smem ? reinterpret_cast<float*>(area + ix.win) : t.sew + ra;
  constexpr int kDepth = 8;  // positions resolved a thread at once
  for (int j0 = 0; j0 < run; j0 += kDepth * nt) {
    int p[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int j = j0 + u * nt + tid;
      p[u] = j < run ? pos[j] : 0;
    }
    int iv[kDepth];
    float ev[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      iv[u] = t.idx[p[u]];
      ev[u] = t.ew[p[u]];
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int j = j0 + u * nt + tid;
      if (j < run) {
        di[j] = min(max(iv[u], 0), n_src - 1);
        de[j] = ev[u];
      }
    }
  }
  __syncthreads();
  return Run{di, de, ra};
}

// s[:] += sum of ew_e * h[idx_e, c0 .. c0 + VEC) and ws += sum of ew_e over
// slots e in [a, b), in that order. A batch's loads all go out before its
// first add.
template <int VEC, int BATCH>
__device__ __forceinline__ void
gather_range(const float* __restrict__ hm, const Run& src, int a, int b,
             int n_src, int d, int c0, float (&s)[VEC], float& ws) {
  for (int fb = a; fb < b; fb += BATCH) {
    int row[BATCH];
    float wv[BATCH];
    float v[BATCH][VEC];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = min(fb + u, b - 1) - src.off;
      row[u] = min(max(src.idx[e], 0), n_src - 1);
      wv[u] = fb + u < b ? src.ew[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      load_vec<VEC>(hm + static_cast<size_t>(row[u]) * d + c0, v[u]);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      ws += wv[u];
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[i] = fmaf(wv[u], v[u][i], s[i]);
    }
  }
}

// A lane group of `gw` lanes gathers a row, lane lg the column groups lg,
// lg + gw, ... (VEC columns each); the block's `rows` rows start at tile
// row `group * rows`.
template <int VEC, int BATCH>
__device__ __forceinline__ void
csr_rows(const float* __restrict__ h, const int* __restrict__ idx,
         const int* __restrict__ seg, const float* __restrict__ ew,
         const float* __restrict__ w, float* __restrict__ out,
         float* __restrict__ mean_out, int* sidx, float* sew,
         int n_src, int n_dst, int n_tiles, int slab, int d, int d_out,
         int gw, int rows, int groups, int win) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t w_bar;
  __shared__ int start[kTile + 1], count[kTile], carry;
  const int tile = blockIdx.x / groups;
  const int lo = (blockIdx.x % groups) * rows;    // first tile row
  const int nrows = min(rows, min(kTile, n_dst - tile * kTile) - lo);
  if (nrows <= 0) return;  // past n_dst: the whole block
  const int hi = lo + nrows;
  const int m = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ngroups = nt / gw;

  const int ap = (d + 3) / 4 * 4 + 4;  // padded mean row: float4 reads,
                                       // no bank conflict
  float* w_s = smem;                            // (d, d_out) of client m
  float* a_s = smem + (d * d_out + 3) / 4 * 4;  // (rows, ap) means
  float* part_s = a_s + rows * ap;              // (ngroups, ap) hub chunks
  float* partw_s = part_s + ngroups * ap;       // (ngroups,) their weights
  // seg windows, then the block's run of (idx, ew): 2 * win words
  int* area = reinterpret_cast<int*>(partw_s + (ngroups + 3) / 4 * 4);

  BulkLoad w_load{&w_bar, false};
  w_load.start(w_s, w + static_cast<size_t>(m) * d * d_out, d * d_out, tid,
               nt);
  const size_t base = (static_cast<size_t>(m) * n_tiles + tile) * slab;
  const Slab t{idx + base, seg + base, ew + base, sidx + base, sew + base,
               slab};
  Run src{t.idx, t.ew, 0};  // a tile in row order is read in place
  bool in_smem = false;
  const Index ix{area, win, start, count, &carry};
  bool loaded = false;
  if (!find_rows(t, ix, loaded, lo, hi, tid, nt)) {
    src = sort_rows(t, ix, loaded, lo, hi, n_src, area, tid, nt);
    in_smem = src.idx == area;
  }
  // the block's run of slots into shared memory, where it fits and the
  // sort did not leave it there
  const int ra = start[lo];
  const int run = start[hi] - ra;
  if (!in_smem && run <= win) {
    float* ew_s = reinterpret_cast<float*>(area + win);
    copy_async(area, src.idx + ra - src.off, run, tid, nt);
    copy_async(ew_s, src.ew + ra - src.off, run, tid, nt);
    cp_async_wait_all();
    __syncthreads();
    src = Run{area, ew_s, ra};
  }

  const float* hm = h + static_cast<size_t>(m) * n_src * d;
  const size_t row0 = static_cast<size_t>(m) * n_dst + tile * kTile + lo;
  float* mean_rows = mean_out == nullptr ? nullptr : mean_out + row0 * d;
  const int ncg = d / VEC;
  const int sw = __ffs(gw) - 1;  // gw is a power of two
  const int q = tid >> sw;       // lane group
  const int lq = tid & (gw - 1);
  // rows of up to kHub slots: a lane group each
  if (q < nrows) {
    const int a = start[lo + q];
    const int b = start[lo + q + 1];
    if (b - a <= kHub) {
      for (int cg = lq; cg < ncg; cg += gw) {
        const int c0 = cg * VEC;
        float s[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = 0.f;
        float ws = 0.f;
        gather_range<VEC, BATCH>(hm, src, a, b, n_src, d, c0, s, ws);
        const float denom = fmaxf(ws, 1.f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = s[i] / denom;
        store_vec<VEC>(a_s + q * ap + c0, s);
        if (mean_rows != nullptr)
          store_vec<VEC>(mean_rows + static_cast<size_t>(q) * d + c0, s);
      }
    }
  }
  // hub rows, one at a time: lane group q sums the q-th of ngroups
  // contiguous chunks, then the chunks are added in order
  for (int r = 0; r < nrows; ++r) {
    const int a = start[lo + r];
    const int n = start[lo + r + 1] - a;
    if (n <= kHub) continue;
    const int size = (n + ngroups - 1) / ngroups;
    const int ca = a + min(q * size, n);
    const int cb = a + min((q + 1) * size, n);
    for (int cg = lq; cg < ncg; cg += gw) {
      const int c0 = cg * VEC;
      float s[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[i] = 0.f;
      float ws = 0.f;
      gather_range<VEC, BATCH>(hm, src, ca, cb, n_src, d, c0, s, ws);
      store_vec<VEC>(part_s + q * ap + c0, s);
      if (cg == 0) partw_s[q] = ws;
    }
    __syncthreads();
    for (int c = tid; c < d; c += nt) {
      float s = part_s[c];
      float ws = partw_s[0];
      for (int p = 1; p < ngroups; ++p) {
        s += part_s[p * ap + c];
        ws += partw_s[p];
      }
      s = s / fmaxf(ws, 1.f);
      a_s[r * ap + c] = s;
      if (mean_rows != nullptr) mean_rows[static_cast<size_t>(r) * d + c] = s;
    }
    __syncthreads();
  }
  w_load.wait();
  __syncthreads();

  // (rows x d) @ (d x d_out) from shared memory
  matmul_rows<VEC>(a_s, ap, w_s, out + row0 * d_out, nrows, d, d_out, tid,
                   nt);
}

// The narrow register budget here is six blocks an SM (80 registers), not
// graph_common.cuh's eight: at the serving slab a block's shared memory
// (~43 KB) already caps an SM at five, and at 64 registers the sorting
// path spills.
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads, 6)
graph_agg_csr_kernel(const float* __restrict__ h, const int* __restrict__ idx,
                     const int* __restrict__ seg,
                     const float* __restrict__ ew,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ mean_out, int* sidx, float* sew,
                     int n_src, int n_dst, int n_tiles, int slab, int d,
                     int d_out, int gw, int rows, int groups, int win) {
  csr_rows<VEC, BATCH>(h, idx, seg, ew, w, out, mean_out, sidx, sew, n_src,
                       n_dst, n_tiles, slab, d, d_out, gw, rows, groups, win);
}

// the same with the register budget of one block an SM (pick_wide)
template <int VEC, int BATCH>
__global__ void __launch_bounds__(kThreads, 1)
graph_agg_csr_kernel_wide(const float* __restrict__ h,
                          const int* __restrict__ idx,
                          const int* __restrict__ seg,
                          const float* __restrict__ ew,
                          const float* __restrict__ w,
                          float* __restrict__ out,
                          float* __restrict__ mean_out, int* sidx, float* sew,
                          int n_src, int n_dst, int n_tiles, int slab, int d,
                          int d_out, int gw, int rows, int groups, int win) {
  csr_rows<VEC, BATCH>(h, idx, seg, ew, w, out, mean_out, sidx, sew, n_src,
                       n_dst, n_tiles, slab, d, d_out, gw, rows, groups, win);
}

template <int VEC>
int launch(const float* h, const int* idx, const int* seg, const float* ew,
           const float* w, float* out, float* mean_out, int* sidx, float* sew,
           int m, int n_src, int n_dst, int n_tiles, int slab, int d,
           int d_out, cudaStream_t s) {
  const int gw = min(32, pow2_ceil(d / VEC));
  const int ngroups = kThreads / gw;
  // rows a block: a lane group each, halved while the grid would leave SMs
  // idle (a hub row still takes every lane group of its block)
  int rows = ngroups;
  while (rows > 1 && m * n_tiles * (kTile / rows) < kFillBlocks) rows /= 2;
  const int groups = kTile / rows;
  const int win = (min(slab, kWindow) + 3) / 4 * 4;
  const size_t ap = (d + 3) / 4 * 4 + 4;
  const size_t smem =
      ((static_cast<size_t>(d) * d_out + 3) / 4 * 4 + (rows + ngroups) * ap +
       (ngroups + 3) / 4 * 4 + 2 * static_cast<size_t>(win)) * sizeof(float);
  // h loads in flight a lane: batches of 4 where rows average up to 4
  // slots, of 17 where they average 17-34 (two for the 33 slots of a
  // serving row), else of 16; 8 in the narrow build, which would spill
  // more under its register budget (the batch only groups the loads:
  // every sum keeps slab order)
  const int batch = slab <= 4 * kTile ? 4
                    : slab > 16 * kTile && slab <= 34 * kTile ? 17 : 16;
  const dim3 grid(n_tiles * groups, m);
  if (batch == 4)
    return launch_pick(graph_agg_csr_kernel<VEC, 4>,
                       graph_agg_csr_kernel_wide<VEC, 4>, grid, kThreads,
                       smem, s, h, idx, seg, ew, w, out, mean_out, sidx, sew,
                       n_src, n_dst, n_tiles, slab, d, d_out, gw, rows,
                       groups, win);
  return launch_pick(graph_agg_csr_kernel<VEC, 8>,
                     batch == 17 ? graph_agg_csr_kernel_wide<VEC, 17>
                                 : graph_agg_csr_kernel_wide<VEC, 16>,
                     grid, kThreads, smem, s, h, idx, seg, ew, w, out,
                     mean_out, sidx, sew, n_src, n_dst, n_tiles, slab, d,
                     d_out, gw, rows, groups, win);
}

}  // namespace

// h: (m, n_src, d) f32; idx/seg: (m, n_tiles * slab) i32; ew: (m, n_tiles *
// slab) f32; w: (m, d, d_out) f32; out: (m, n_dst, d_out) f32; mean_out:
// null or (m, n_dst, d) f32; sidx/sew: (m, n_tiles * slab) i32/f32 scratch
// for tiles out of row order; all contiguous on CUDA device `device`.
// Launches on `stream` and returns the launch's cudaGetLastError() (0 on
// success); never synchronises. The library links its own CUDA runtime, so
// the device is set here rather than inherited from the caller's runtime.
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 columns need d and d_out multiples of 4 and 16-byte aligned
  // rows (a view with an odd storage offset takes the scalar instantiation)
  const bool vec4 = d % 4 == 0 && d_out % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(mean_out)) & 15) == 0;
  if (vec4)
    return launch<4>(h, idx, seg, ew, w, out, mean_out, sidx, sew, m, n_src,
                     n_dst, n_tiles, slab, d, d_out, s);
  return launch<1>(h, idx, seg, ew, w, out, mean_out, sidx, sew, m, n_src,
                   n_dst, n_tiles, slab, d, d_out, s);
}
