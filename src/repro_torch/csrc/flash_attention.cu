// Online-softmax attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
// flash_attention` (`_attn_kernel`): causal, full or sliding-window masks,
// GQA (query head h reads KV head h / group), keys at or past `T` masked
// (the reference's `kv_len`), KV tiles that lie wholly above the diagonal
// or outside the window skipped, f32 accumulation, output in the input
// dtype.
//
// What bounds it on an H100: operations. At the serving path's prefill
// shape (B = 1, S = T = 2048, H = 32, KV = 4, hd = 64, causal) it does
// ~17 GFLOP on 2 MB of inputs, ~1,000x more FLOPs than bytes. This first
// version uses plain fp32 FMAs (no tensor cores; `wgmma`, TMA and a bf16
// tensor-core path are later work), so its ceiling is the 67 TFLOP/s fp32
// rate, and the design keeps the FMA units fed from shared memory:
//
//   * one CTA per (64-row query block, query head, batch row), 256 threads;
//     the grid walks query blocks from the last, so the causal blocks with
//     the most tiles start first;
//   * the query block (converted to f32) stays in shared memory; each
//     64-key K/V tile is loaded into shared memory once and read by all
//     64 query rows;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty..4ty+3:
//     for S = Q K^T it computes keys tx + 16 j (j < 4), for O += P V the
//     columns 64 jj + 4 tx .. +3 (jj < hd / 64), with float4 reads from
//     padded rows (no bank conflicts);
//   * running max, sum and the output accumulator live in registers; the
//     16 threads of a row group sit in one half-warp, so row max and sum
//     are half-warp shuffles and P goes through shared memory behind a
//     __syncwarp, not a block barrier.
//
// Masked scores are -1e30, not -inf, as in the reference: a row with no
// valid key in its first processed tile gets p = 1 on the masked keys, and
// the correction exp(m_prev - m_new) = 0 wipes that at its first valid key
// (with -inf it would be exp(-inf + inf) = NaN).
//
// Layout: element strides for batch, head and sequence of q, k, v and o
// (unit stride along hd), so the (B, S, H, hd) tensors of the model are
// read and written in place, without a head-major copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int PP = BK + 4;    // padded row of P in shared memory
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int smem_floats(int hd) {
  return BQ * (hd + 4) + BK * (hd + 4) + BK * hd + BQ * PP;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       long long osb, long long osh, long long oss,
                       int S, int T_len, int group, int causal, int window,
                       float scale) {
  constexpr int QP = HD + 4;  // padded rows: float4-aligned, conflict-free
  constexpr int KP = HD + 4;
  constexpr int NJ = HD / 64;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // BQ x QP
  float* sK = sQ + BQ * QP;                     // BK x KP
  float* sV = sK + BK * KP;                     // BK x HD
  float* sP = sV + BK * HD;                     // BQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + (h / group) * ksh;
  const T* vp = v + b * vsb + (h / group) * vsh;
  T* op = o + b * osb + h * osh;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    sQ[r * QP + d] = row < S ? to_f32(qp[row * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  // tiles to visit: keys below T; causal: k0 <= q0 + BQ - 1; window:
  // k0 + BK - 1 > q0 - window (the reference's block-level skip)
  int end = (T_len + BK - 1) / BK;
  if (causal) end = min(end, (q0 + BQ - 1) / BK + 1);
  int begin = 0;
  if (window) {
    const int lo = q0 - window - BK + 2;
    if (lo > 0) begin = (lo + BK - 1) / BK;
  }

  for (int kt = begin; kt < end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx % HD;
      const int key = k0 + c;
      const bool ok = key < T_len;
      sK[c * KP + d] = ok ? to_f32(kp[key * kss + d]) : 0.f;
      sV[c * HD + d] = ok ? to_f32(vp[key * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(4 * ty + i) * QP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * KP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < T_len && (!causal || kpos <= qpos) &&
                        (!window || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(4 * ty + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read in its warp

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(4 * ty + i) * PP + c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(c + e) * HD + 64 * jj + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = lane(pv[i], e);
            acc[i][jj][0] = fmaf(p, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out(&op[row * oss + 64 * jj + 4 * tx + e],
                  acc[i][jj][e] / denom);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int S, int T_len, int group,
           int causal, int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats(HD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<HD, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], S,
      T_len, group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              const long long* st, int B, int H, int S, int T_len, int group,
              int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64, T>(q, k, v, o, st, B, H, S, T_len, group, causal,
                           window, scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, st, B, H, S, T_len, group, causal,
                            window, scale, stream);
    case 256:
      return launch<256, T>(q, k, v, o, st, B, H, S, T_len, group, causal,
                            window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_smem_bytes(int hd) {
  return smem_floats(hd) * static_cast<int>(sizeof(float));
}

// q (B, H, S, hd), k and v (B, KV, T, hd), o (B, H, S, hd), addressed by
// the element strides `st` = (q: batch, head, seq; k: ...; v: ...; o: ...).
// dtype 0 = float32, 1 = bfloat16 (all four tensors alike).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, int B, int H, int KV, int S, int T_len, int hd, int dtype,
    int causal, int window, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / KV;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, st, B, H, S, T_len, group, causal,
                            window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, st, B, H, S, T_len, group,
                                    causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
