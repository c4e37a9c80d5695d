// Flash attention for Hopper (sm_90a): online-softmax attention with native
// GQA, causal, sliding-window or bidirectional.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py. For every batch b, query head h
// (kv head h / (H / Kv)) and query row i:
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, kvh])
//                  * v[b, j, kvh]
//
// over the visible keys j: j < T, j <= i when causal, j > i - window with a
// window. As in the reference, scores and the running (m, l, acc) stay in
// fp32, masked scores take the finite NEG_INF = -1e30 (a row whose first
// visited tile is fully masked takes p = 1 there, and the first real score
// wipes it through alpha = exp(-1e30 - m) = 0; -inf would give
// exp(-inf + inf) = NaN), the kv loop is bounded per query tile (causal
// `hi`, window `lo`), the row is divided at the end by max(l, 1e-30), and
// the output is rounded once to q's dtype. Every row must see a key: the
// wrapper refuses a window with S >= T + window.
//
// Two kernels, chosen by an explicit dispatch on the dtype in the entry
// point (not a fallback; each dtype has exactly one kernel):
//
// bf16: `flash_attention_kernel_mma`, on the tensor cores.
//   What bounds it on this card: at the main-path shape (B 4, S = T = 4096,
//   H 15, Kv 5, dh 64, causal) one launch does 4 * B * H * dh * (visible
//   pairs) = 1.29e11 flops, 130 us at 989 TFLOP/s bf16, and moves 84 MB (q,
//   k, v, out once each), 25 us at 3.35 TB/s: it is compute-bound.
//   Design. One block of 4 warps per (64-row query tile, query head, batch),
//   one 1-D grid walked longest query tile first over all heads and
//   batches (a causal tile's work grows with its index). Each warp owns 16
//   query rows.
//   - q . k^T: bf16 `mma.sync.m16n8k16` with fp32 accumulators. The q tile
//     is copied to shared memory once per block; its A fragments (again
//     each kv tile, so they hold no registers) and k's B fragments are read
//     by `ldmatrix`. The products of bf16 values are exact in fp32; the scale,
//     folded with log2(e), multiplies the fp32 scores, and exp2 on the
//     special-function unit (`ex2.approx`) gives the softmax weights.
//   - softmax: scores, m and l stay in registers; the row max reduces over
//     the four lanes of a row (quad shuffles), l is kept per lane and
//     reduced once at the end.
//   - p . v with P at better than bf16: a single bf16 P is about 2^-9
//     relative a weight, which puts the output far outside one bf16
//     rounding of the fp32 result at S = 4096. So P is split in registers into
//     hi = bf16(p) and lo = bf16(p - hi) (p - hi is exact in fp32; hi + lo
//     is within 2^-18 of p) and both go through the MMA against the same
//     V fragments (`ldmatrix.trans`) into one fp32 accumulator: 1.5x the
//     tensor-core work of a plain flash-2 step. The m16n8 accumulator
//     fragment of the scores is the m16n8k16 A fragment of P, so P never
//     touches shared memory.
//   - K/V tiles of 64 keys go global -> shared by `cp.async` (16 B a
//     thread, zero-filled past T) into a two-stage ring: tile j + 1 loads
//     while tile j is multiplied. Each thread copies a fixed column chunk
//     of fixed rows (`TileLoader`), so a tile costs it a few address
//     steps. Rows of q, K and V tiles are padded by 16 B in shared memory,
//     so the 8 rows of every `ldmatrix` phase fall in distinct banks. dh
//     is padded with zeros up to DHP, a multiple of 16 (the MMA's k);
//     shared memory is 5 * 64 * (DHP + 8) * 2 bytes (87 KB at DHP 128,
//     opted into as dynamic shared memory above 48 KB).
//   - Masking: the per-element mask runs only on tiles that hold the
//     diagonal, a window edge or the ragged end of T.
//   - The output goes through shared memory (each warp's own q rows) and
//     is written as 16-byte rows into the contiguous (B, S, H, dh) result.
//   Layout it requires: unit stride on dh, every other stride of an
//   extent above 1 a multiple of 8 elements, 16-byte aligned pointers (so
//   every row is 16-byte aligned for cp.async), dh a multiple of 8 up to
//   128. The entry point returns cudaErrorInvalidValue otherwise (the
//   wrapper raises first).
//
// fp32: `flash_attention_kernel_f32`, on the CUDA cores in full fp32 FMA
//   (TF32 on the tensor cores would break the reference's 2e-5 fp32
//   tolerance). q is cast to fp32 and scaled before the dot, as in the
//   reference. One block of 128 threads per (64-row query tile, head,
//   batch); K (transposed) and V tiles of 64 keys staged in shared memory
//   as fp32 through any strides; thread (rg, cg) owns rows 4rg .. 4rg+3 and
//   keys 8cg .. 8cg+7 of the score tile, P goes through shared memory. dh
//   pads to 32, 64, 96 or 128; (196 * dh_pad + 4352) * 4 bytes of shared
//   memory (117.8 KB at dh 128). Slow (67 TFLOP/s fp32 peak); it serves
//   the fp32 callers (the reduced configs, fp32 decode-vs-prefill checks).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;        // the reference's finite NEG_INF
constexpr size_t kMaxSmem = 232448;      // 227 KB a block may opt into
constexpr size_t kStaticSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                         // element strides of (B, S, H, dh)
  long long b, s, h, d;
};

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= kStaticSmem) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// ------------------------------------------------- bf16, tensor cores (mma)
constexpr int kMmaBQ = 64;               // query rows of a block
constexpr int kMmaBK = 64;               // keys of a kv tile
constexpr int kMmaThreads = 128;         // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit: relative error below 2^-22, results
// under 2^-126 flushed to 0 (a weight that small adds nothing to a row whose
// largest weight is 1); exp2f would add a denormal-range fix-up per score
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 -> one bf16x2 register (x in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// P's A fragment of one 16-key step as hi = bf16(p) and lo = bf16(p - hi)
__device__ __forceinline__ void split_p(float x, float y, uint32_t& hi,
                                        uint32_t& lo) {
  hi = pack_bf16(x, y);
  lo = pack_bf16(x - __uint_as_float(hi << 16),
                 y - __uint_as_float(hi & 0xffff0000u));
}

template <int DHP>
struct MmaTile {
  static constexpr int kLd = DHP + 8;    // bf16 a shared row (+16 B)
  static constexpr size_t kBytes =
      static_cast<size_t>(kMmaBQ + 4 * kMmaBK) * kLd * 2;  // q, 2 K, 2 V
};

// The 16-byte chunks one thread copies of every 64-row tile: column chunk
// tid % kLanes of rows tid / kLanes + i * kRowStep, where kLanes is DHP / 8
// rounded up to a power of two (lanes past dh / 8 copy nothing). Each
// thread's row, column and shared offset are fixed for the whole launch,
// so a tile costs it kPasses address steps and cp.async issues.
template <int DHP>
struct TileLoader {
  static_assert(kMmaBQ == kMmaBK, "q and kv tiles share the loader");
  static constexpr int kChunks = DHP / 8;
  static constexpr int kLanes = kChunks <= 2 ? 2 : kChunks <= 4 ? 4
                                : kChunks <= 8 ? 8 : 16;
  static constexpr int kRowStep = kMmaThreads / kLanes;
  static constexpr int kPasses = kMmaBK / kRowStep;
  static constexpr int kLd = MmaTile<DHP>::kLd;
  int row, col;
  uint32_t dst;                          // byte offset of its first chunk
  bool on;                               // its chunk lies inside dh
  __device__ TileLoader(int tid, int dh)
      : row(tid / kLanes), col((tid % kLanes) * 8),
        dst(static_cast<uint32_t>((row * kLd + col) * 2)), on(col < dh) {}
  // rows [row0, row0 + 64) of a (rows, dh) slab into the tile at shared
  // address `tile`, rows past n_rows zero-filled
  __device__ __forceinline__ void load(uint32_t tile,
                                       const __nv_bfloat16* base,
                                       long long stride, int row0,
                                       int n_rows) const {
    if (!on) return;
    const int r0 = row0 + row;
    const __nv_bfloat16* src = base + r0 * stride + col;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const bool valid = r0 + i * kRowStep < n_rows;
      cp_async16(tile + dst + i * kRowStep * kLd * 2,
                 valid ? src + i * kRowStep * stride : base, valid);
    }
  }
};

template <int DHP>
__global__ void __launch_bounds__(kMmaThreads, DHP <= 64 ? 3 : 1)
flash_attention_kernel_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int s_len,
                           int t_len, int n_heads, int n_batch, int group,
                           int dh, Strides sq, Strides sk, Strides sv,
                           int causal, int window, float scale_log2) {
  constexpr int kLd = MmaTile<DHP>::kLd;
  constexpr int KS = DHP / 16;           // k-steps of q . k^T over dh
  constexpr int NT = DHP / 8;            // 8-wide column tiles of the output
  constexpr int NK = kMmaBK / 8;         // 8-key column tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * kLd;           // [2][kMmaBK][kLd]
  __nv_bfloat16* vs = ks + 2 * kMmaBK * kLd;       // [2][kMmaBK][kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment row, pair
  const int heads_batches = n_heads * n_batch;
  const int n_q_tiles = (s_len + kMmaBQ - 1) / kMmaBQ;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x) /
                                         heads_batches;
  const int hb = static_cast<int>(blockIdx.x) % heads_batches;
  const int head = hb % n_heads, batch = hb / n_heads;
  const int q_start = q_tile * kMmaBQ;

  const __nv_bfloat16* qb = q + batch * sq.b + head * sq.h;
  const __nv_bfloat16* kb = k + batch * sk.b + (head / group) * sk.h;
  const __nv_bfloat16* vb = v + batch * sv.b + (head / group) * sv.h;

  // kv tiles this query tile can see
  const int n_kv_tiles = (t_len + kMmaBK - 1) / kMmaBK;
  const int hi = causal ? min((q_start + kMmaBQ + kMmaBK - 1) / kMmaBK,
                              n_kv_tiles)
                        : n_kv_tiles;
  const int lo = window > 0 ? max(q_start - window + 1, 0) / kMmaBK : 0;

  // the zero padding dh .. DHP of every tile (cp.async never writes it)
  if (dh < DHP) {
    for (int i = tid; i < (kMmaBQ + 4 * kMmaBK) * (DHP - dh);
         i += kMmaThreads) {
      const int r = i / (DHP - dh), c = dh + i % (DHP - dh);
      qs[r * kLd + c] = __float2bfloat16(0.f);
    }
  }
  const TileLoader<DHP> ld(tid, dh);
  const uint32_t ks_addr = smem_addr(ks), vs_addr = smem_addr(vs);
  constexpr uint32_t kTileBytes = kMmaBK * kLd * 2;
  ld.load(smem_addr(qs), qb, sq.s, q_start, s_len);
  cp_async_commit();
  if (lo < hi) {
    ld.load(ks_addr, kb, sk.s, lo * kMmaBK, t_len);
    ld.load(vs_addr, vb, sv.s, lo * kMmaBK, t_len);
  }
  cp_async_commit();
  cp_async_wait<1>();                    // q has landed
  __syncthreads();

  // where this lane's ldmatrix of q's A fragments (rows 16 warp .. 16 warp
  // + 15) starts; they are read again each tile rather than held in
  // registers
  const uint32_t q_addr = smem_addr(
      qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
      (lane >> 4) * 8);

  const int row0 = q_start + warp * 16 + g;        // this lane's two rows
  const int row1 = row0 + 8;
  const int q_last = min(q_start + kMmaBQ, s_len) - 1;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    const int buf = (tile - lo) & 1;
    if (tile + 1 < hi) {                 // the next tile loads meanwhile
      const int nb = buf ^ 1;
      ld.load(ks_addr + nb * kTileBytes, kb, sk.s, (tile + 1) * kMmaBK,
              t_len);
      ld.load(vs_addr + nb * kTileBytes, vb, sv.s, (tile + 1) * kMmaBK,
              t_len);
    }
    cp_async_commit();
    cp_async_wait<1>();                  // this tile has landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * kMmaBK * kLd;
    const __nv_bfloat16* vt = vs + buf * kMmaBK * kLd;
    const int k_start = tile * kMmaBK;

    // scores: s[j] holds keys 8j + 2 t4 (+1) of rows g (e 0, 1), g + 8 (2, 3)
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4];
      ldsm_x4(q_addr + kk * 32, qf);       // 16 bf16 = 32 bytes a k-step
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t b[4];
        const int r = jp * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(kt + r * kLd + c), b);
        mma_bf16(s[2 * jp], qf, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf, b[2], b[3]);
      }
    }

    // scale (log2 domain), mask where the tile needs it, online softmax
    const bool edge = k_start + kMmaBK > t_len ||
                      (causal && k_start + kMmaBK - 1 > q_start) ||
                      (window > 0 && k_start <= q_last - window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k_start + 8 * j + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? row0 : row1;
          bool ok = kpos < t_len;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = fast_exp2(s[j][0] - mn0);
      s[j][1] = fast_exp2(s[j][1] - mn0);
      s[j][2] = fast_exp2(s[j][2] - mn1);
      s[j][3] = fast_exp2(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;              // this lane's share of the row sum
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += (p_hi + p_lo) . v, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = np * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(smem_addr(vt + r * kLd + c), b);
        mma_bf16(acc[2 * np], ph, b[0], b[1]);
        mma_bf16(acc[2 * np], pl, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * np + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                     // the next tile refills buf
  }
  cp_async_wait<0>();

  // finish the row sums over the quad, divide, round once to bf16, stage
  // in this warp's own q rows, write 16-byte chunks
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* stage = qs + warp * 16 * kLd;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(stage + g * kLd + c) =
        pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + c) =
        pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
  __syncwarp();
  constexpr int kChunks = DHP / 8;
#pragma unroll
  for (int i = 0; i < kChunks / 2; ++i) {  // 16 rows x kChunks, 32 lanes
    const int c = lane + i * 32;
    const int r = c / kChunks, ch = c % kChunks;
    const int row = q_start + warp * 16 + r;
    if (row < s_len && ch * 8 < dh) {
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(batch) * s_len + row) * n_heads +
                 head) * dh;
      *reinterpret_cast<uint4*>(orow + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + ch * 8);
    }
  }
}

template <int DHP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int s, int t, int h, int kv, int dh, Strides sq, Strides sk,
               Strides sv, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = MmaTile<DHP>::kBytes;
  auto kernel = flash_attention_kernel_mma<DHP>;
  const int e = opt_in_smem(kernel, smem);
  if (e != 0) return e;
  const long long blocks =
      static_cast<long long>((s + kMmaBQ - 1) / kMmaBQ) * h * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), s, t, h, b, h / kv, dh, sq, sk, sv,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_dh(const void* q, const void* k, const void* v, void* out,
                  int b, int s, int t, int h, int kv, int dh, Strides sq,
                  Strides sk, Strides sv, int causal, int window, float scale,
                  cudaStream_t stream) {
  switch ((dh + 15) / 16) {
#define FLASH_MMA_CASE(n)                                                   \
  case n:                                                                   \
    return launch_mma<16 * n>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, \
                              causal, window, scale, stream);
    FLASH_MMA_CASE(1)
    FLASH_MMA_CASE(2)
    FLASH_MMA_CASE(3)
    FLASH_MMA_CASE(4)
    FLASH_MMA_CASE(5)
    FLASH_MMA_CASE(6)
    FLASH_MMA_CASE(7)
    FLASH_MMA_CASE(8)
#undef FLASH_MMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// true when pointer p and every stride of an extent above 1 keep each
// dh-row of a bf16 tensor 16-byte aligned, with unit stride on dh
bool rows_aligned(const void* p, Strides st, int b, int rows, int heads) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || st.d != 1) return false;
  return (b == 1 || st.b % 8 == 0) && (rows == 1 || st.s % 8 == 0) &&
         (heads == 1 || st.h % 8 == 0);
}

// ---------------------------------------------------- fp32, CUDA cores
constexpr int kBQ = 64;                  // query rows of a block
constexpr int kBK = 64;                  // keys of a kv tile
constexpr int kBKP = kBK + 4;            // padded row of the K^T and P tiles
constexpr int kThreads = 128;            // 16 row groups x 8 column groups

constexpr size_t smem_floats(int dhp) {
  return static_cast<size_t>(dhp) * kBQ + static_cast<size_t>(dhp) * kBKP +
         static_cast<size_t>(kBK) * dhp + static_cast<size_t>(kBQ) * kBKP;
}

template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int s_len, int t_len,
                           int n_heads, int group, int dh, Strides sq,
                           Strides sk, Strides sv, int causal, int window,
                           float scale) {
  constexpr int NC = DHP / 8;            // output columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [DHP][kBQ]  q * scale, transposed
  float* kt = qt + DHP * kBQ;            // [DHP][kBKP] k tile, transposed
  float* vs = kt + DHP * kBKP;           // [kBK][DHP]  v tile
  float* ps = vs + kBK * DHP;            // [kBQ][kBKP] probabilities

  const int tid = threadIdx.x;
  const int rg = tid >> 3;               // rows 4rg .. 4rg+3
  const int cg = tid & 7;                // keys 8cg .., columns cg*NC ..
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int q_start = q_tile * kBQ;

  const float* qb = q + batch * sq.b + head * sq.h;
  const float* kb = k + batch * sk.b + (head / group) * sk.h;
  const float* vb = v + batch * sv.b + (head / group) * sv.h;

  for (int i = tid; i < kBQ * DHP; i += kThreads) {
    const int r = i / DHP, d = i % DHP;
    const int row = q_start + r;
    float x = 0.f;
    if (row < s_len && d < dh) x = qb[row * sq.s + d * sq.d] * scale;
    qt[d * kBQ + r] = x;
  }

  // kv tiles this query tile can see
  const int n_kv_tiles = (t_len + kBK - 1) / kBK;
  const int hi = causal ? min((q_start + kBQ + kBK - 1) / kBK, n_kv_tiles)
                        : n_kv_tiles;
  const int lo = window > 0 ? max(q_start - window + 1, 0) / kBK : 0;

  float m_run[4], l_run[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int tile = lo; tile < hi; ++tile) {
    const int k_start = tile * kBK;
    __syncthreads();                     // the last tile's readers are done
    for (int i = tid; i < kBK * DHP; i += kThreads) {
      const int r = i / DHP, d = i % DHP;
      const int key = k_start + r;
      float kx = 0.f, vx = 0.f;
      if (key < t_len && d < dh) {
        kx = kb[key * sk.s + d * sk.d];
        vx = vb[key * sv.s + d * sv.d];
      }
      kt[d * kBKP + r] = kx;
      vs[r * DHP + d] = vx;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(qt + d * kBQ + rg * 4);
      const float4 k0 =
          *reinterpret_cast<const float4*>(kt + d * kBKP + cg * 8);
      const float4 k1 =
          *reinterpret_cast<const float4*>(kt + d * kBKP + cg * 8 + 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, online softmax over the 8 threads of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k_start + cg * 8 + j;
        bool ok = kpos < t_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      float* prow = ps + (rg * 4 + i) * kBKP + cg * 8;
      *reinterpret_cast<float4*>(prow) =
          make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
      *reinterpret_cast<float4*>(prow + 4) =
          make_float4(sc[i][4], sc[i][5], sc[i][6], sc[i][7]);
    }
    __syncthreads();

    // acc[i][c] += sum_k p[row i][k] * v[k][cg * NC + c]
    for (int kk = 0; kk < kBK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (rg * 4 + i) * kBKP + kk);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * DHP + cg * NC;
#pragma unroll
        for (int c4 = 0; c4 < NC / 4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * c4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * c4 + 0] = fmaf(pr[i][u], vv.x, acc[i][4 * c4 + 0]);
            acc[i][4 * c4 + 1] = fmaf(pr[i][u], vv.y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(pr[i][u], vv.z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(pr[i][u], vv.w, acc[i][4 * c4 + 3]);
          }
        }
      }
    }
  }

  // out is contiguous (B, S, H, dh)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + rg * 4 + i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(batch) * s_len + row) *
                             n_heads + head) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg * NC + c;
      if (col < dh) orow[col] = acc[i][c] / denom;
    }
  }
}

template <int DHP>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int s, int t, int h, int kv, int dh, Strides sq, Strides sk,
               Strides sv, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_floats(DHP) * sizeof(float);
  auto kernel = flash_attention_kernel_f32<DHP>;
  const int e = opt_in_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, t, h,
      h / kv, dh, sq, sk, sv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_dh(const void* q, const void* k, const void* v, void* out,
                  int b, int s, int t, int h, int kv, int dh, Strides sq,
                  Strides sk, Strides sv, int causal, int window, float scale,
                  cudaStream_t stream) {
  if (dh <= 32)
    return launch_f32<32>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv,
                          causal, window, scale, stream);
  if (dh <= 64)
    return launch_f32<64>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv,
                          causal, window, scale, stream);
  if (dh <= 96)
    return launch_f32<96>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv,
                          causal, window, scale, stream);
  return launch_f32<128>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv,
                         causal, window, scale, stream);
}

}  // namespace

// q: (b, s, h, dh); k, v: (b, t, kv, dh), each read through its element
// strides (s*_b, s*_s, s*_h, s*_d); all fp32 (bf16 = 0) or all bf16
// (bf16 = 1), on CUDA device `device`. out: contiguous (b, s, h, dh) of the
// same dtype. h % kv == 0, dh a multiple of 8 up to 128; window <= 0 means
// none; scale is the reference's 1 / sqrt(dh), computed by the caller.
// bf16 goes to the tensor-core kernel, which also needs unit stride on dh
// and 16-byte aligned rows (see the header); fp32 to the CUDA-core kernel,
// any strides. Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for what neither
// kernel reads; never synchronises. The library links its own CUDA
// runtime, so the device is set here rather than inherited from the caller.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int b, int s,
    int t, int h, int kv, int dh, long long sqb, long long sqs,
    long long sqh, long long sqd, long long skb, long long sks,
    long long skh, long long skd, long long svb, long long svs,
    long long svh, long long svd, int causal, int window, float scale,
    int bf16, int device, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || h <= 0 || kv <= 0 || h % kv != 0 ||
      dh <= 0 || dh % 8 != 0 || dh > 128 || h > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{sqb, sqs, sqh, sqd}, sk{skb, sks, skh, skd},
      sv{svb, svs, svh, svd};
  if (bf16 && !(rows_aligned(q, sq, b, s, h) &&
                rows_aligned(k, sk, b, t, kv) &&
                rows_aligned(v, sv, b, t, kv) &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_mma_dh(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, causal,
                         window, scale, st);
  return launch_f32_dh(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, causal,
                       window, scale, st);
}
