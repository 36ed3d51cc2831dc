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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr uint32_t TF32_MASK = 0xffffe000u;

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

__host__ __device__ constexpr int align1k(int n) { return (n + 1023) / 1024 * 1024; }

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

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Waits for the phase of `parity` to complete. A wait past 10 s (a broken
// pipeline: no wait of a working one lasts a tile's compute) traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (n == 0) t0 = now_ns();
    else if (!done && (n & 1023) == 0 && now_ns() - t0 > 10000000000ull)
      __trap();
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the consumer warpgroups only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}
// orders this thread's shared-memory writes before the async proxy's reads
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps registers that an in-flight wgmma reads or writes in place until the
// wait (the compiler may not move or reuse them across this point)
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: rows of 128
// bytes, 8-row groups SBO bytes apart, (MN-major operands) 64-element column
// blocks LBO bytes apart.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma with A from registers: m64nNk8 TF32 and m64n64k16 bf16 (TRANS_B = 1
// reads B MN-major)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B)
      : "memory");
}


// v = hi + lo: hi is v rounded to TF32's 11 significant bits, lo = v - hi
// exact in fp32 (the tensor core reads lo's top 11 bits: 2^-22 of v lost)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// S's products, one wgmma of N = BK keys
template <int BK>
__device__ __forceinline__ void mma_s_tf32(float (&d)[BK / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BK == 64) wgmma_tf32_n64(d, a, desc);
  else wgmma_tf32_n32(d, a, desc);
}

// The K tile's lo part, and V's hi and lo parts
// transposed to hd x keys with each 8-key group in the order of P's
// fragments (slot t + 4e holds key 2t + e), swizzled in 32-key chunks.
template <int HD, int BK, int NC>
__device__ __forceinline__ void split_tiles(const uint8_t* k, uint8_t* klo,
                                            const uint8_t* v, uint8_t* vth,
                                            uint8_t* vtl) {
  const int tid = threadIdx.x;
  const float4* k4 = reinterpret_cast<const float4*>(k);
  float4* l4 = reinterpret_cast<float4*>(klo);
  for (int i = tid; i < BK * HD / 4; i += NC) {
    const float4 x = k4[i];
    const float4 hi = make_float4(
        __uint_as_float(__float_as_uint(x.x) & TF32_MASK),
        __uint_as_float(__float_as_uint(x.y) & TF32_MASK),
        __uint_as_float(__float_as_uint(x.z) & TF32_MASK),
        __uint_as_float(__float_as_uint(x.w) & TF32_MASK));
    l4[i] = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
  }
  for (int i = tid; i < HD * BK / 4; i += NC) {
    const int d = i % HD, uk = i / HD;      // uk: 16-byte unit of V^T's row
    const int key0 = 8 * (uk >> 1) + (uk & 1);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 2 * e;
      const float x = *reinterpret_cast<const float*>(
          v + (d / 32) * BK * 128 + key * 128 +
          ((((d % 32) >> 2) ^ (key & 7)) << 4) + (d & 3) * 4);
      split_tf32(x, hi[e], lo[e]);
    }
    const int off = (uk / 8) * HD * 128 + d * 128 + (((uk & 7) ^ (d & 7)) << 4);
    *reinterpret_cast<uint4*>(vth + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(vtl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

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
      split_tiles<HD, BK, NC>(sK, sm + L::KLO, sm + L::V + s * L::TILE,
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
            mma_s_tf32<BK>(sacc, alo[kk], dk);
            mma_s_tf32<BK>(sacc, ahi[kk], sdesc(klo_a + off, 16, 1024));
            mma_s_tf32<BK>(sacc, ahi[kk], dk);
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
// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes beyond the CUDA runtime's
constexpr int ERR_NO_ENCODER = 10000;   // + 0
constexpr int ERR_ENCODE = 10001;       // + the CUresult

// A 4-D map of (B, KV, T, hd) read through element strides (seq, head,
// batch), boxes of 128 bytes of hd by `rows` keys, swizzled 128 bytes, zero
// fill past T.
int make_map(CUtensorMap* map, const void* base, bool fp32, int hd, int T,
             int KV, int B, long long sseq, long long shead, long long sbatch,
             int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const int es = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)KV,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sseq * es),
                                 (cuuint64_t)(shead * es),
                                 (cuuint64_t)(sbatch * es)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

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
