// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of
// softmax(scale Q K^T + mask) V from (Q, K, V, O, lse, dO), fp32 and bf16
// inputs, computed in fp32, returned in the input dtype.
//
// The counterpart of `repro/models/attention.py::_make_flash`'s `flash_bwd`
// (the FlashAttention-2 backward of the reference's custom VJP, not a
// Pallas kernel): only (q, k, v, o, lse) are kept from the forward, and P is
// recomputed blockwise as exp(scale S - lse), so no (S, T) matrix is ever
// written to device memory. With D = rowsum(dO * O):
//
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * scale,
//   dQ = dS K,    dK = dS^T Q   (dK, dV summed over the G query heads of
//                                each KV head)
//
// Masks as the forward's: causal (key <= query), a sliding window (key >
// query - window), keys at or past T; a masked (query, key) pair gets
// P = 0 exactly (no exp of -inf - -inf), so a key that no query sees gets
// dK = dV = 0 and a row with no key gets dQ = 0.
//
// Design (a first, simple version: fp32 FMAs, no tensor cores). Two
// kernels, neither with atomics, so the gradients are deterministic:
//   * dq_kernel, grid (S / BQ, H, B): a CTA keeps its query block's Q and
//     dO in shared memory, computes D for its rows (written for the second
//     kernel) and loops over the key tiles the mask lets it see (the
//     forward's tile range), recomputing S and dP per tile and
//     accumulating dQ += dS K in registers;
//   * dkdv_kernel, grid (T / BK, KV, B): a CTA keeps its key block's K and
//     V in shared memory and loops over the G query heads of its KV head
//     and over the query blocks that see its keys, recomputing S and dP,
//     and accumulating dV += P^T dO and dK += dS^T Q in registers.
// Both share the tile products: 256 threads as 16 x 16, each a register
// tile of (BQ / 16) x (BK / 16) scores, rows of shared memory padded by one
// float so a warp's reads of 16 rows hit 16 banks.
//
// Bound (PERF.md section 6): five products of 2 B H S T hd FLOPs each over
// the unmasked pairs (this design does seven: S and dP twice); at
// tinyllama's 2048-token layer (B = 1, H = 32, KV = 4, hd = 64, causal)
// 42.9 GFLOP, 0.26 ms at 3xTF32 on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;          // threads per CTA, 16 x 16

// query rows BQ and keys BK per tile, by head dim (both kernels)
template <int HD> struct Tiles { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows r0 .. r0 + ROWS - 1 of a (len, HD) slab at `src` (row stride `ss`
// elements, unit stride along HD) into fp32 rows of LD floats; rows at or
// past `len` are zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0, int len) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < ROWS * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    dst[r * LD + d] = row < len ? to_f32(src[(long long)row * ss + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int T_len,
                                        int causal, int window) {
  return qpos < S && kpos < T_len && (!causal || kpos <= qpos) &&
         (!window || kpos > qpos - window);
}

// One tile's P and dS for this thread's (BQ / 16) x (BK / 16) pairs: rows
// ty * RM + i, keys tx + 16 j. Qs, dOs: (BQ, HD + 1); Ks, Vs: (BK, HD + 1).
template <int HD, int BQ, int BK>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* D_s, int q0, int k0, int S, int T_len,
    int causal, int window, float scale, float (&p)[BQ / 16][BK / 16],
    float (&ds)[BQ / 16][BK / 16]) {
  constexpr int LD = HD + 1, RM = BQ / 16, CN = BK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RM][CN], dp[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[RM], ga[RM], kb[CN], vb[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      qa[i] = Qs[(ty * RM + i) * LD + d];
      ga[i] = dOs[(ty * RM + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      kb[j] = Ks[(tx + 16 * j) * LD + d];
      vb[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const bool ok = visible(q0 + r, k0 + tx + 16 * j, S, T_len, causal,
                              window);
      const float pv = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - D_s[r]) * scale;
    }
  }
}

template <typename T, int HD>
struct Smem {
  static constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK, LD = HD + 1;
  static constexpr int LDS = BK + 1;
  // dq_kernel: Q, dO, K, V, dS, lse, D
  static constexpr int DQ = (2 * BQ + 2 * BK) * LD + BQ * LDS + 2 * BQ;
  // dkdv_kernel: K, V, Q, dO, P, dS, lse, D
  static constexpr int DKDV = (2 * BK + 2 * BQ) * LD + 2 * BQ * LDS + 2 * BQ;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ dsum,
    T* __restrict__ dq, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, long long dsb,
    long long dsh, long long dss, int H, int S, int T_len, int group,
    int causal, int window, float scale) {
  using M = Smem<T, HD>;
  constexpr int BQ = M::BQ, BK = M::BK, LD = M::LD, LDS = M::LDS;
  constexpr int RM = BQ / 16, CJ = HD / 16, TPR = NT / BQ;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LDS;
  float* D_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int kvh = h / group;
  const T* qp = q + b * qsb + h * qsh;
  const T* dop = dout + b * dsb + h * dsh;
  load_rows<T, HD, BQ>(Qs, qp, qss, q0, S);
  load_rows<T, HD, BQ>(dOs, dop, dss, q0, S);
  {  // D = rowsum(dO * O) for the block's rows, TPR threads a row
    const int r = tid / TPR, part = tid % TPR, row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + b * osb + h * osh + (long long)row * oss;
      const T* grow = dop + (long long)row * dss;
      for (int d = part; d < HD; d += TPR)
        acc = fmaf(to_f32(grow[d]), to_f32(orow[d]), acc);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      const long long at = ((long long)b * H + h) * S + row;
      D_s[r] = acc;
      lse_s[r] = row < S ? lse[at] : 0.f;
      if (row < S) dsum[at] = acc;
    }
  }
  // the forward's tile range: keys below T; causal: k0 <= q0 + BQ - 1;
  // window: k0 + BK - 1 > q0 - window
  int end = (T_len + BK - 1) / BK;
  if (causal) end = min(end, (q0 + BQ - 1) / BK + 1);
  int begin = 0;
  if (window) {
    const int lo = q0 - window - BK + 2;
    if (lo > 0) begin = (lo + BK - 1) / BK;
  }
  float acc[RM][CJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;
  for (int kt = begin; kt < end; ++kt) {
    const int k0 = kt * BK;
    load_rows<T, HD, BK>(Ks, kp, kss, k0, T_len);
    load_rows<T, HD, BK>(Vs, vp, vss, k0, T_len);
    __syncthreads();
    float p[RM][BK / 16], ds[RM][BK / 16];
    tile_p_ds<HD, BQ, BK>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, S, T_len,
                          causal, window, scale, p, ds);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        dSs[(ty * RM + i) * LDS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS K: rows ty * RM + i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RM], kb[CJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = dSs[(ty * RM + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kb[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], kb[j], acc[i][j]);
    }
    __syncthreads();   // K, V and dS are replaced by the next tile
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= S) continue;
    T* out = dq + (((long long)b * S + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store_out(out + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long dsb,
    long long dsh, long long dss, int H, int KV, int S, int T_len, int group,
    int causal, int window, float scale) {
  using M = Smem<T, HD>;
  constexpr int BQ = M::BQ, BK = M::BK, LD = M::LD, LDS = M::LDS;
  constexpr int RM = BQ / 16, CM = BK / 16, CJ = HD / 16;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDS;
  float* lse_s = dSs + BQ * LDS;
  float* D_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kvh = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BK;
  load_rows<T, HD, BK>(Ks, k + b * ksb + kvh * ksh, kss, k0, T_len);
  load_rows<T, HD, BK>(Vs, v + b * vsb + kvh * vsh, vss, k0, T_len);
  // the query blocks that see a key of this block: causal, rows at or
  // past k0; a window, rows before the last key + window
  const int nqb = (S + BQ - 1) / BQ;
  const int qb_begin = causal ? min(nqb, k0 / BQ) : 0;
  int qb_end = nqb;
  if (window) {
    const int last = min(k0 + BK, T_len) - 1;
    qb_end = min(nqb, (last + window - 1) / BQ + 1);
  }
  float dka[CM][CJ], dva[CM][CJ];
#pragma unroll
  for (int i = 0; i < CM; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qp = q + b * qsb + h * qsh;
    const T* dop = dout + b * dsb + h * dsh;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();   // the last block's Q, dO, P and dS are read
      load_rows<T, HD, BQ>(Qs, qp, qss, q0, S);
      load_rows<T, HD, BQ>(dOs, dop, dss, q0, S);
      for (int r = tid; r < BQ; r += NT) {
        const int row = q0 + r;
        const long long at = ((long long)b * H + h) * S + row;
        lse_s[r] = row < S ? lse[at] : 0.f;
        D_s[r] = row < S ? dsum[at] : 0.f;
      }
      __syncthreads();
      float p[RM][CM], ds[RM][CM];
      tile_p_ds<HD, BQ, BK>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, S, T_len,
                            causal, window, scale, p, ds);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          Ps[(ty * RM + i) * LDS + tx + 16 * j] = p[i][j];
          dSs[(ty * RM + i) * LDS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty * CM + i, columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pa[CM], da[CM], gb[CJ], qb_[CJ];
#pragma unroll
        for (int i = 0; i < CM; ++i) {
          pa[i] = Ps[r * LDS + ty * CM + i];
          da[i] = dSs[r * LDS + ty * CM + i];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          gb[j] = dOs[r * LD + tx + 16 * j];
          qb_[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < CM; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dva[i][j] = fmaf(pa[i], gb[j], dva[i][j]);
            dka[i][j] = fmaf(da[i], qb_[j], dka[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    const int key = k0 + ty * CM + i;
    if (key >= T_len) continue;
    const long long at = (((long long)b * T_len + key) * KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      store_out(dk + at + tx + 16 * j, dka[i][j]);
      store_out(dv + at + tx + 16 * j, dva[i][j]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq, void* dk,
           void* dv, const long long* st, int B, int H, int KV, int S,
           int T_len, int causal, int window, float scale,
           cudaStream_t stream) {
  using M = Smem<T, HD>;
  const int group = H / KV;
  constexpr int dq_smem = M::DQ * 4, dkdv_smem = M::DKDV * 4;
  auto kdq = flash_bwd_dq_kernel<T, HD>;
  auto kkv = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dkdv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  // dQ first: it writes D, which the dK / dV kernel reads
  kdq<<<dim3((S + M::BQ - 1) / M::BQ, H, B), NT, dq_smem, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dt, lse, dsum,
      static_cast<T*>(dq), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], H, S,
      T_len, group, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kkv<<<dim3((T_len + M::BK - 1) / M::BK, KV, B), NT, dkdv_smem, stream>>>(
      qt, kt, vt, dt, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12],
      st[13], st[14], H, KV, S, T_len, group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, const long long* st, int B, int H,
              int KV, int S, int T_len, int causal, int window, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, st, B, H,
                           KV, S, T_len, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, st, B, H,
                            KV, S, T_len, causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, dsum, dq, dk, dv, st, B, H,
                            KV, S, T_len, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD>
int smem_of(int which) {
  return 4 * (which == 0 ? Smem<float, HD>::DQ : Smem<float, HD>::DKDV);
}

}  // namespace

// Shared-memory bytes of one CTA of the dQ (which = 0) or the dK / dV
// (which = 1) kernel at head dim hd (fp32 staging whatever the dtype); the
// wrapper's `bwd_plan` computes the same and checks that the two agree.
extern "C" int flash_attention_bwd_smem_bytes(int hd, int which) {
  switch (hd) {
    case 64: return smem_of<64>(which);
    case 128: return smem_of<128>(which);
    case 256: return smem_of<256>(which);
    default: return -1;
  }
}

// q, o, dout (B, S, H, hd), k and v (B, T, KV, hd), addressed by the
// element strides (batch, head, seq) of q, k, v, o, dout in that order,
// unit stride along hd; lse (B, H, S) fp32 as the forward wrote it; dsum a
// (B, H, S) fp32 scratch (D); dq (B, S, H, hd), dk and dv (B, T, KV, hd)
// contiguous, in the inputs' dtype (0 = float32, 1 = bfloat16). Two
// launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, long long dsb, long long dsh,
    long long dss, int B, int H, int KV, int S, int T_len, int hd, int dtype,
    int causal, int window, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                            vss, osb, osh, oss, dsb, dsh, dss};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(dsum);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, dout, l, d, dq, dk, dv, st, B, H,
                            KV, S, T_len, causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<bf16>(hd, q, k, v, o, dout, l, d, dq, dk, dv, st, B, H,
                           KV, S, T_len, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
