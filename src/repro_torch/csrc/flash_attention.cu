// Online-softmax attention forward for Hopper (sm_90a) on the tensor cores:
// TMA loads, `wgmma`, 3xTF32 for fp32 inputs and native bf16 for bf16.
//
// Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
// flash_attention` (`_attn_kernel`): causal, full or sliding-window masks,
// GQA (query head h reads KV head h / group), keys at or past `T` masked
// (the reference's `kv_len`), KV tiles that lie wholly above the diagonal
// or outside the window skipped, f32 accumulation, output in the input
// dtype.
//
// What bounds it on an H100: operations. At the serving path's prefill
// shape (B = 1, S = T = 2048, H = 32, KV = 4, hd = 64, causal) the two
// products are 17.19 GFLOP on 37.7 MB of q, k, v and o. In fp32 they run as
// three TF32 products each (3 x 17.19 GFLOP at 494.7 TFLOP/s: 0.104 ms),
// in bf16 as one (989 TFLOP/s: 0.0174 ms); the 67.1 M exponentials take
// 0.016 ms on the special-function units.
//
// Design:
//   * one CTA per (query block of BQ = 64 or 128 rows, query head, batch
//     row); the grid's slowest dimension walks the query blocks from the
//     last, so the causal blocks with the most tiles start first;
//   * a producer warp issues the TMA loads (`cp.async.bulk.tensor`, one
//     4-D tensor map each for K and V, read through the model's (B, S, H,
//     hd) strides, 128-byte swizzle, zero fill past T) into a ring of two
//     stages counted on mbarriers; one or two consumer warpgroups of 64
//     query rows each compute;
//   * S = Q K^T is `wgmma` with Q the A operand from registers (its
//     fragments read from a padded copy of the query block in shared
//     memory) and the K tile the K-major B operand from shared memory;
//   * fp32 is 3xTF32: a = a_hi + a_lo with a_hi a's top 11 significant
//     bits, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi accumulated in fp32
//     (the dropped a_lo b_lo is ~2^-22 of the product). Q and P are split in
//     registers. The tensor core reads an fp32 word as TF32 by ignoring
//     its low 13 mantissa bits (checked on the card: writing K's hi part
//     over the tile first gave the same outputs to the last bit), so the
//     raw K tile serves as K's hi part and only its lo part (K minus its
//     top 19 bits) gets a tile of its own;
//   * O += P V is `wgmma` with P the A operand from registers. TF32 `wgmma`
//     reads B K-major only, and V arrives keys x hd, so the consumers write
//     V's hi and lo parts transposed (hd x keys, swizzled as TMA would)
//     before the product. The P fragments are taken straight from S's
//     accumulator layout; that puts key 2t + e of each 8-key group in the
//     slot the fragment calls t + 4e, and the transposed V tile is written
//     in the same key order. bf16 takes V as it arrives (the descriptor's
//     transpose bit) and P rounded to bf16;
//   * running max, sum and the output accumulator live in registers; the
//     four lanes that share a row reduce with two shuffles.
//
// Masked scores are -1e30, not -inf, as in the reference: a row with no
// valid key in its first processed tile gets p = 1 on the masked keys, and
// the correction exp(m_prev - m_new) = 0 wipes that at its first valid key
// (with -inf it would be exp(-inf + inf) = NaN). A warpgroup whose rows all
// lie above a causal tile skips its products for that tile (p would be 0).
#include "hopper_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ plans
// Tiles per (dtype, head dim), mirrored by `flash_plan` in
// kernels/flash_attention/kernel.py. BQ = 64 rows per consumer warpgroup;
// BK keys per K/V tile; Q_SMEM: the query block is copied into shared
// memory (else its fragments are read from device memory every tile, fp32
// hd 256 only, where a copy does not fit beside two stages).
template <typename T, int HD>
struct Plan;
template <> struct Plan<float, 64> {
  static constexpr int BQ = 128, BK = 64, STAGES = 2, QC = 8;
  static constexpr bool Q_SMEM = true;
};
template <> struct Plan<float, 128> {
  static constexpr int BQ = 128, BK = 32, STAGES = 2, QC = 4;
  static constexpr bool Q_SMEM = true;
};
template <> struct Plan<float, 256> {
  static constexpr int BQ = 64, BK = 32, STAGES = 2, QC = 4;
  static constexpr bool Q_SMEM = false;
};
template <> struct Plan<bf16, 64> {
  static constexpr int BQ = 128, BK = 64, STAGES = 2, QC = 4;
  static constexpr bool Q_SMEM = true;
};
template <> struct Plan<bf16, 128> {
  static constexpr int BQ = 128, BK = 64, STAGES = 2, QC = 8;
  static constexpr bool Q_SMEM = true;
};
template <> struct Plan<bf16, 256> {
  static constexpr int BQ = 64, BK = 64, STAGES = 2, QC = 8;
  static constexpr bool Q_SMEM = true;
};

// Shared-memory layout in bytes; every tile starts on 1024 bytes, where the
// 128-byte swizzle's pattern repeats. QC: k-steps of Q's fragments held in
// registers at once.
template <typename T, int HD>
struct Layout {
  using P = Plan<T, HD>;
  static constexpr int ES = sizeof(T);
  static constexpr bool FP32 = ES == 4;
  static constexpr int NWG = P::BQ / 64;
  static constexpr int NC = NWG * 128;              // consumer threads
  static constexpr int THREADS = NC + 32;           // + the producer warp
  static constexpr int QLD = HD + 16 / ES;          // padded row of Q
  static constexpr int BOXES = HD * ES / 128;       // 128-byte column boxes
  static constexpr int TILE = P::BK * HD * ES;      // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + (P::Q_SMEM ? align1k(P::BQ * QLD * ES) : 0);
  static constexpr int V = K + P::STAGES * TILE;
  static constexpr int KLO = V + P::STAGES * TILE;  // fp32: K's lo part
  static constexpr int VT = KLO + (FP32 ? TILE : 0);  // fp32: V^T hi, lo
  static constexpr int BARS = VT + (FP32 ? 2 * TILE : 0);
  static constexpr int TOTAL = BARS + 16 * P::STAGES + 1024;  // + alignment
  static_assert(TILE % 1024 == 0, "tiles keep the swizzle's alignment");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<T, HD>::THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const T* __restrict__ q, T* __restrict__ o,
                       float* __restrict__ lse,
                       long long qsb, long long qsh, long long qss,
                       long long osb, long long osh, long long oss, int S,
                       int T_len, int group, int causal, int window,
                       float scale) {
  using L = Layout<T, HD>;
  using P = Plan<T, HD>;
  constexpr int BQ = P::BQ, BK = P::BK, ST = P::STAGES, NC = L::NC;
  constexpr bool FP32 = L::FP32;
  constexpr int NB = BK / 8;                 // n8 blocks of S
  constexpr int NO = HD / 64;                // 64-column blocks of O
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  // tiles to visit: keys below T; causal: k0 <= q0 + BQ - 1; window:
  // k0 + BK - 1 > q0 - window (the reference's block-level skip)
  int end = (T_len + BK - 1) / BK;
  if (causal) end = min(end, (q0 + BQ - 1) / BK + 1);
  int begin = 0;
  if (window) {
    const int lo = q0 - window - BK + 2;
    if (lo > 0) begin = (lo + BK - 1) / BK;
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NC / 32) {     // the producer warp: K and V tiles by TMA
    if (lane == 0) {
      const int kvh = h / group;
      for (int kt = begin, it = 0; kt < end; ++kt, ++it) {
        const int s = it % ST;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect(&full[s], 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c) {
          tma_load(sm + L::K + s * L::TILE + c * BK * 128, &kmap, &full[s],
                   c * 128 / L::ES, kt * BK, kvh, b);
          tma_load(sm + L::V + s * L::TILE + c * BK * 128, &vmap, &full[s],
                   c * 128 / L::ES, kt * BK, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;   // this thread's rows r0, r0 + 8
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const T* qp = q + b * qsb + h * qsh;
  const T* qsrc[2];
  bool qok[2] = {true, true};
  if constexpr (P::Q_SMEM) {
    T* sQ = reinterpret_cast<T*>(sm + L::Q);
    constexpr int U = HD * L::ES / 16;            // 16-byte units of a row
    for (int i = tid; i < BQ * U; i += NC) {
      const int r = i / U, c = (i % U) * (16 / L::ES), row = q0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < S) x = *reinterpret_cast<const uint4*>(qp + row * qss + c);
      *reinterpret_cast<uint4*>(sQ + r * L::QLD + c) = x;
    }
    consumers_sync(NC);
    qsrc[0] = sQ + r0 * L::QLD;
    qsrc[1] = sQ + (r0 + 8) * L::QLD;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qok[i] = qrow[i] < S;
      qsrc[i] = qp + (qok[i] ? qrow[i] : 0) * qss;
    }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float oacc[NO][32];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[n][i] = 0.f;
  const uint32_t klo_a = smem_u32(sm + L::KLO), vth_a = smem_u32(sm + L::VT);
  const uint32_t vtl_a = vth_a + L::TILE;

  for (int kt = begin, it = 0; kt < end; ++kt, ++it) {
    const int s = it % ST, k0 = kt * BK;
    uint8_t* sK = sm + L::K + s * L::TILE;
    const uint32_t k_a = smem_u32(sK), v_a = smem_u32(sm + L::V + s * L::TILE);
    mbar_wait(&full[s], (it / ST) & 1);
    if constexpr (FP32) {
      consumers_sync(NC);        // every consumer is done with the last split
      split_lo<L::TILE, NC>(sK, sm + L::KLO);        // K's lo part
      split_t<HD, BK, NC>(sm + L::V + s * L::TILE, 0,  // V^T's hi, lo
                          sm + L::VT, sm + L::VT + L::TILE);
      fence_to_async();
      consumers_sync(NC);
    }
    // a warpgroup whose rows all lie above this causal tile skips it
    const bool active = !(causal && k0 > q0 + wg * 64 + 63);
    float sacc[BK / 2];
    if (active) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
      // S = Q K^T, QC k-steps of Q's fragments at a time
      constexpr int KS = FP32 ? HD / 8 : HD / 16;
#pragma unroll
      for (int c0 = 0; c0 < KS; c0 += P::QC) {
        uint32_t ahi[P::QC][4], alo[P::QC][4];
#pragma unroll
        for (int kk = 0; kk < P::QC; ++kk) {
          const int ks = c0 + kk;
          if constexpr (FP32) {
            const int c = 8 * ks + t;
            const float x[4] = {qok[0] ? qsrc[0][c] : 0.f,
                                qok[1] ? qsrc[1][c] : 0.f,
                                qok[0] ? qsrc[0][c + 4] : 0.f,
                                qok[1] ? qsrc[1][c + 4] : 0.f};
#pragma unroll
            for (int j = 0; j < 4; ++j) split_tf32(x[j], ahi[kk][j], alo[kk][j]);
          } else {
            const int c = 16 * ks + 2 * t;
            ahi[kk][0] = *reinterpret_cast<const uint32_t*>(qsrc[0] + c);
            ahi[kk][1] = *reinterpret_cast<const uint32_t*>(qsrc[1] + c);
            ahi[kk][2] = *reinterpret_cast<const uint32_t*>(qsrc[0] + c + 8);
            ahi[kk][3] = *reinterpret_cast<const uint32_t*>(qsrc[1] + c + 8);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P::QC; ++kk) {
          const int ks = c0 + kk;
          const uint32_t off = (ks / 4) * BK * 128 + (ks % 4) * 32;
          const uint64_t dk = sdesc(k_a + off, 16, 1024);
          if constexpr (FP32) {
            mma_tf32<BK>(sacc, alo[kk], dk);
            mma_tf32<BK>(sacc, ahi[kk], sdesc(klo_a + off, 16, 1024));
            mma_tf32<BK>(sacc, ahi[kk], dk);
          } else {
            wgmma_bf16_n64<0>(sacc, ahi[kk], dk);
          }
        }
        wgmma_commit();
        wgmma_wait();
        hold(sacc);
        hold(ahi);
        if constexpr (FP32) hold(alo);
      }
    }
    if constexpr (FP32) {       // K and V are split: the stage is free
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (active) {
      // online softmax on this thread's two rows (four lanes per row)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qpos = qrow[hf];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            const bool ok = kpos < T_len && (!causal || kpos <= qpos) &&
                            (!window || kpos > qpos - window);
            float& x = sacc[4 * j + 2 * hf + e];
            x = ok ? x * scale : NEG_INF;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        const float corr = expf(m[hf] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sacc[4 * j + 2 * hf + e];
            x = expf(x - m_new);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hf] = l[hf] * corr + sum;
        m[hf] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            oacc[n][4 * j + 2 * hf] *= corr;
            oacc[n][4 * j + 2 * hf + 1] *= corr;
          }
      }
      // O += P V
      if constexpr (FP32) {
        uint32_t phi[NB][4], plo[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          // slot order of the fragment: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          // <- keys 2t, 2t (row g+8), 2t+1, 2t+1 (row g+8) of block j
          const int src[4] = {4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3};
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(sacc[src[i]], phi[j][i], plo[j][i]);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const uint32_t off = (j / 4) * HD * 128 + n * 64 * 128 + (j % 4) * 32;
            const uint64_t dh = sdesc(vth_a + off, 16, 1024);
            wgmma_tf32_n64(oacc[n], plo[j], dh);
            wgmma_tf32_n64(oacc[n], phi[j], sdesc(vtl_a + off, 16, 1024));
            wgmma_tf32_n64(oacc[n], phi[j], dh);
          }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int n = 0; n < NO; ++n) hold(oacc[n]);
        hold(phi);
        hold(plo);
      } else {
        uint32_t pb[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pb[j][i] = pack_bf16(sacc[8 * j + 2 * i], sacc[8 * j + 2 * i + 1]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
#pragma unroll
          for (int n = 0; n < NO; ++n)
            wgmma_bf16_n64<1>(oacc[n], pb[j],
                              sdesc(v_a + n * BK * 128 + j * 16 * 128,
                                    BK * 128, 1024));
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int n = 0; n < NO; ++n) hold(oacc[n]);
        hold(pb);
      }
    }
    if constexpr (!FP32) {      // V was read in place: free the stage now
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  T* op = o + b * osb + h * osh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = qrow[hf];
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[hf], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(op + row * oss + n * 64 + 8 * j + 2 * t,
               oacc[n][4 * j + 2 * hf] * inv, oacc[n][4 * j + 2 * hf + 1] * inv);
    // the row's log-sum-exp of the scaled scores, natural-log units (the
    // softmax above takes expf of scale * S, so m and l are already in
    // them): what the backward recomputes P from
    if (lse != nullptr && t == 0)
      lse[((long long)b * gridDim.x + h) * S + row] =
          m[hf] + logf(fmaxf(l[hf], 1e-30f));
  }
}

// ------------------------------------------------------------------ host
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int H, int KV, int S, int T_len,
           int group, int causal, int window, float scale,
           cudaStream_t stream) {
  using L = Layout<T, HD>;
  constexpr bool fp32 = L::FP32;
  CUtensorMap kmap, vmap;
  int err = make_map(&kmap, k, fp32, HD, T_len, KV, B, st[5], st[4], st[3],
                     Plan<T, HD>::BK);
  if (err) return err;
  err = make_map(&vmap, v, fp32, HD, T_len, KV, B, st[8], st[7], st[6],
                 Plan<T, HD>::BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (S + Plan<T, HD>::BQ - 1) / Plan<T, HD>::BQ);
  flash_attention_kernel<T, HD><<<grid, L::THREADS, L::TOTAL, stream>>>(
      kmap, vmap, static_cast<const T*>(q), static_cast<T*>(o), lse, st[0],
      st[1],
      st[2], st[9], st[10], st[11], S, T_len, group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              float* lse, const long long* st, int B, int H, int KV, int S,
              int T_len, int group, int causal, int window, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, st, B, H, KV, S, T_len, group, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, st, B, H, KV, S, T_len, group,
                            causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, st, B, H, KV, S, T_len, group,
                            causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int smem_hd(int hd) {
  switch (hd) {
    case 64: return Layout<T, 64>::TOTAL;
    case 128: return Layout<T, 128>::TOTAL;
    case 256: return Layout<T, 256>::TOTAL;
    default: return -1;
  }
}

}  // namespace

// Shared-memory bytes of one CTA (the wrapper's `flash_plan` computes the
// same and checks that the two agree); dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_smem_bytes(int hd, int dtype) {
  return dtype == 0 ? smem_hd<float>(hd) : smem_hd<bf16>(hd);
}

// q (B, H, S, hd), k and v (B, KV, T, hd), o (B, H, S, hd), addressed by
// the element strides `st` = (q: batch, head, seq; k: ...; v: ...; o: ...);
// unit stride along hd, base addresses and the strides of k and v (in
// bytes) multiples of 16. dtype 0 = float32, 1 = bfloat16 (all four alike).
// `lse`, when not null, receives each row's log-sum-exp of the scaled
// scores, contiguous fp32 (B, H, S), for the backward; null (every serving
// prefill) writes nothing more.
// Returns a CUDA error code, or 10000 when libcuda offers no
// cuTensorMapEncodeTiled and 10001 + its CUresult when it refuses a map.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, int B, int H, int KV, int S, int T_len, int hd, int dtype,
    int causal, int window, float scale, void* stream, void* lse) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / KV;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, static_cast<float*>(lse), st, B,
                            H, KV, S, T_len, group, causal, window, scale, s);
  if (dtype == 1)
    return launch_hd<bf16>(hd, q, k, v, o, static_cast<float*>(lse), st, B,
                           H, KV, S, T_len, group, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
