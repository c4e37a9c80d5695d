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
// window. The arithmetic is the reference's: q is cast to fp32 and scaled
// before the dot, scores and the running (m, l, acc) stay in fp32, masked
// scores take the finite NEG_INF = -1e30 (a row whose first visited tile is
// fully masked takes p = 1 there, and the first real score wipes it through
// alpha = exp(-1e30 - m) = 0; -inf would give exp(-inf + inf) = NaN), the
// kv loop is bounded per query tile (causal `hi`, window `lo`), and the row
// is divided at the end by max(l, 1e-30). The output is in q's dtype.
//
// What bounds it on this card: at the main-path shape (B 4, S = T = 4096,
// H 15, Kv 5, dh 64, bf16, causal) one launch does 4 * B * H * dh * (visible
// pairs) = 1.29e11 flops, 130 us at 989 TFLOP/s bf16 on the tensor cores,
// and moves 84 MB (q, k, v, out once each), 25 us at 3.35 TB/s: it is
// compute-bound. This kernel runs on the CUDA cores in fp32 (67 TFLOP/s
// peak, about 1.9 ms for the same work) and is expected to be far from
// either number; a tensor-core version (mma / wgmma with TMA-fed tiles) is
// later work.
//
// Design. One block of 128 threads per (query tile of 64 rows, query head,
// batch); the grid walks query tiles longest-first (a causal tile's work
// grows with its index). The block stages q * scale once, transposed, then
// for each visible kv tile of 64 keys stages K (transposed) and V in shared
// memory as fp32, reading (B, S, H, dh) / (B, T, Kv, dh) through their
// strides (no moveaxis or padding copies). Thread (rg, cg) owns query rows
// 4rg .. 4rg+3: it computes the 4 x 8 scores of keys 8cg .. 8cg+7, the
// row max and sum reduce over the 8 threads of the row (warp shuffles), the
// probabilities go through shared memory, and it accumulates output columns
// cg * dh_pad / 8 .. of its rows in registers. The head width is padded to
// 32, 64, 96 or 128 with zeros (any multiple of 8 up to 128). Shared memory
// is (196 * dh_pad + 4352) * 4 bytes: 117.8 KB at dh 128, above the 48 KB
// static limit, so the launch opts in to dynamic shared memory.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C entry point at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                  // query rows of a block
constexpr int kBK = 64;                  // keys of a kv tile
constexpr int kBKP = kBK + 4;            // padded row of the K^T and P tiles
constexpr int kThreads = 128;            // 16 row groups x 8 column groups
constexpr float kNegInf = -1e30f;        // the reference's finite NEG_INF
constexpr size_t kMaxSmem = 232448;      // 227 KB a block may opt into

struct Strides {                         // element strides of (B, S, H, dh)
  long long b, s, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);              // round to nearest even
}

constexpr size_t smem_floats(int dhp) {
  return static_cast<size_t>(dhp) * kBQ + static_cast<size_t>(dhp) * kBKP +
         static_cast<size_t>(kBK) * dhp + static_cast<size_t>(kBQ) * kBKP;
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int s_len, int t_len, int n_heads, int group, int dh,
                       Strides sq, Strides sk, Strides sv, int causal,
                       int window, float scale) {
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

  const T* qb = q + batch * sq.b + head * sq.h;
  const T* kb = k + batch * sk.b + (head / group) * sk.h;
  const T* vb = v + batch * sv.b + (head / group) * sv.h;

  for (int i = tid; i < kBQ * DHP; i += kThreads) {
    const int r = i / DHP, d = i % DHP;
    const int row = q_start + r;
    float x = 0.f;
    if (row < s_len && d < dh) {
      x = to_f32(qb[row * sq.s + d * sq.d]) * scale;
    }
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
        kx = to_f32(kb[key * sk.s + d * sk.d]);
        vx = to_f32(vb[key * sv.s + d * sv.d]);
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
    T* orow = out + ((static_cast<long long>(batch) * s_len + row) * n_heads +
                     head) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg * NC + c;
      if (col < dh) store(orow + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int h, int kv, int dh, Strides sq, Strides sk,
           Strides sv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(DHP) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_kernel<T, DHP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, t, h, h / kv, dh,
      sq, sk, sv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int b,
              int s, int t, int h, int kv, int dh, Strides sq, Strides sk,
              Strides sv, int causal, int window, float scale,
              cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, causal,
                         window, scale, stream);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, causal,
                         window, scale, stream);
  if (dh <= 96)
    return launch<T, 96>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, causal,
                         window, scale, stream);
  return launch<T, 128>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv, causal,
                        window, scale, stream);
}

}  // namespace

// q: (b, s, h, dh); k, v: (b, t, kv, dh), each read through its element
// strides (s*_b, s*_s, s*_h, s*_d); all fp32 (bf16 = 0) or all bf16
// (bf16 = 1), on CUDA device `device`. out: contiguous (b, s, h, dh) of the
// same dtype. h % kv == 0, dh a multiple of 8 up to 128; window <= 0 means
// none; scale is the reference's 1 / sqrt(dh), computed by the caller.
// Launches on `stream` and returns the launch's cudaGetLastError() (0 on
// success); never synchronises. The library links its own CUDA
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
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Strides sq{sqb, sqs, sqh, sqd}, sk{skb, sks, skh, skd},
      sv{svb, svs, svh, svd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, out, b, s, t, h, kv, dh, sq, sk,
                                    sv, causal, window, scale, st);
  return launch_dh<float>(q, k, v, out, b, s, t, h, kv, dh, sq, sk, sv,
                          causal, window, scale, st);
}
