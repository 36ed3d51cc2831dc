// Flash attention backward for Hopper (sm_90a) on the tensor cores: dQ, dK
// and dV of softmax(scale Q K^T + mask) V from (Q, K, V, O, lse, dO), fp32
// and bf16 inputs, fp32 accumulation, returned in the input dtype.
//
// The counterpart of `repro/models/attention.py::_make_flash`'s `flash_bwd`
// (the FlashAttention-2 backward of the reference's custom VJP, not a
// Pallas kernel): only (q, k, v, o, lse) are kept from the forward, and P is
// recomputed per tile as exp(scale S - lse), so no (S, T) matrix is ever
// written to device memory. With D = rowsum(dO * O) in fp32:
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
// What bounds it on an H100: operations. Five products of 2 hd FLOPs per
// unmasked (query, key) pair; at tinyllama's 2048-token layer (B = 1,
// H = 32, KV = 4, hd = 64, causal) 42.97 GFLOP: 0.261 ms as 3xTF32 (fp32),
// 0.043 ms in bf16.
//
// Design: two kernels on one body, each the forward's pipeline (a producer
// warp bringing tiles by TMA into an mbarrier ring, consumer warpgroups of
// 64 rows running `wgmma` with A from registers, hopper_common.cuh):
//   * flash_bwd_dq_kernel: rows are queries (Q and dO resident), the ring
//     streams K and V tiles; S = Q K^T and dP = dO V^T, then dQ += dS K.
//     It also writes D for its rows (read back by the second kernel);
//   * flash_bwd_dkdv_kernel: rows are keys (K and V resident), the ring
//     streams Q and dO tiles with each tile's lse and D; S^T = K Q^T and
//     dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q. Taking the
//     products transposed keeps P^T and dS^T in the accumulators' layout,
//     so they are A operands straight from registers.
// That is seven products where five are needed (S and dP twice): two
// kernels keep D's launch order and need no cross-CTA sum of dQ, so the
// result is deterministic without extra bookkeeping; the ceiling is 5/7
// of the bound.
//   * fp32 is 3xTF32, as the forward: A operands split into hi and lo in
//     registers; a streamed tile is its own hi part as a K-major B operand
//     and gets a lo tile (split_lo); as the B operand of dQ, dV or dK (a
//     product over the tile's rows, which TF32 `wgmma` reads K-major only)
//     it is written transposed in hi and lo (split_t), in the key order of
//     the P fragments. bf16 reads every tile in place (the descriptor's
//     transpose bit for the second products), P and dS rounded to bf16.
//   * Filling the card: the dK / dV grid is (query head, batch row, key
//     block), one CTA per query head, walking the key blocks from the
//     first (under a causal mask the blocks with the most query tiles
//     start first). With G > 1 query heads per KV head each CTA writes its
//     head's dK, dV as fp32 partials; the last of the G CTAs of a key block
//     to finish (an integer counter; __threadfence before it) sums the G
//     partials in head order and writes dK and dV. No float atomics: the
//     same inputs give the same bits. The dQ grid walks the query blocks
//     from the last, as the forward.
//   * Registers: with two consumer warpgroups the producer is a warpgroup
//     (one warp of it issues the loads) that gives its registers to the
//     consumers by `setmaxnreg` (24 and 240 a thread): nine warps would
//     leave 168 a thread, and the bf16 and hd-128 plans spilled there. hd
//     256 splits the output columns over two CTAs (each recomputes S and
//     dP), so no plan holds more than 2 x 64 x 128 accumulators a
//     warpgroup. fp32 at hd 128 and 256 reads the resident rows' fragments
//     from device memory (the split tiles fill the shared memory).
#include "hopper_common.cuh"

namespace {

// ------------------------------------------------------------------ plans
// Per (dtype, head dim, kernel), mirrored by `flash_bwd_plan` in
// kernels/flash_attention/kernel.py: NWG consumer warpgroups of 64 rows; BN
// rows of each streamed tile (the products' N); STAGES in the ring; XS: the
// resident rows copied into shared memory (else their fragments are read
// from device memory every tile); SPLIT: CTAs over the output columns; QC:
// k-steps of the resident rows' fragments held in registers at once.
template <typename T, int HD, bool DKDV>
struct Plan;
#define BWD_PLAN(T_, HD_, DKDV_, NWG_, BN_, ST_, XS_, SPLIT_, QC_)        \
  template <> struct Plan<T_, HD_, DKDV_> {                               \
    static constexpr int NWG = NWG_, BN = BN_, STAGES = ST_, SPLIT = SPLIT_, \
                         QC = QC_;                                        \
    static constexpr bool XS = XS_;                                       \
  };
// dQ: rows are queries, tiles of K and V
BWD_PLAN(float, 64, false, 2, 64, 2, true, 1, 4)
BWD_PLAN(float, 128, false, 2, 32, 2, false, 1, 4)
BWD_PLAN(float, 256, false, 1, 32, 1, false, 2, 4)
BWD_PLAN(bf16, 64, false, 2, 64, 2, true, 1, 4)
BWD_PLAN(bf16, 128, false, 2, 64, 2, true, 1, 8)
BWD_PLAN(bf16, 256, false, 1, 64, 2, true, 2, 8)
// dK / dV: rows are keys, tiles of Q and dO
BWD_PLAN(float, 64, true, 2, 32, 2, true, 1, 4)
BWD_PLAN(float, 128, true, 2, 32, 2, false, 1, 1)
BWD_PLAN(float, 256, true, 1, 32, 1, false, 2, 2)
BWD_PLAN(bf16, 64, true, 2, 64, 2, true, 1, 4)
BWD_PLAN(bf16, 128, true, 2, 32, 2, true, 1, 4)
BWD_PLAN(bf16, 256, true, 1, 32, 2, true, 2, 8)
#undef BWD_PLAN

// Shared-memory layout in bytes, every tile on 1024 bytes: the resident
// rows X1 and X2 (padded rows, when copied); STAGES x (Y1, Y2) tiles; the
// dK / dV kernel's lse and D of each stage's columns; fp32: Y1's and Y2's
// lo parts and the transposed hi and lo parts (Y1 in both kernels, Y2 in
// dK / dV); two mbarriers per stage and the last-CTA flag; 1024 bytes to
// align the base.
template <typename T, int HD, bool DKDV>
struct Layout {
  using P = Plan<T, HD, DKDV>;
  static constexpr int ES = sizeof(T);
  static constexpr bool FP32 = ES == 4;
  static constexpr int BR = P::NWG * 64;             // rows per CTA
  static constexpr int NC = P::NWG * 128;            // consumer threads
  // two consumer warpgroups come with a producer warpgroup (one warp of
  // it issues the loads) so that `setmaxnreg` can move its registers to
  // the consumers: 9 warps would leave 168 a thread (3 warps on a quarter
  // SM's 16384); one consumer warpgroup takes 255 with a producer warp
  static constexpr bool MOVE_REGS = P::NWG == 2;
  static constexpr int THREADS = NC + (MOVE_REGS ? 128 : 32);
  static constexpr int HO = HD / P::SPLIT;           // output columns a CTA
  static constexpr int XLD = HD + 16 / ES;           // padded resident row
  static constexpr int BOXES = HD * ES / 128;        // 128-byte column boxes
  static constexpr int TILE = P::BN * HD * ES;       // one streamed tile
  static constexpr int TTILE = HO * P::BN * 4;       // a transposed part
  static constexpr int XB = P::XS ? align1k(BR * XLD * ES) : 0;
  static constexpr int X1 = 0, X2 = XB;
  static constexpr int Y = 2 * XB;                   // stage s: Y1, Y2
  static constexpr int VEC = Y + 2 * P::STAGES * TILE;
  static constexpr int LO = VEC + (DKDV ? align1k(2 * P::STAGES * P::BN * 4) : 0);
  static constexpr int TR = LO + (FP32 ? 2 * TILE : 0);
  static constexpr int BARS = TR + (FP32 ? (DKDV ? 4 : 2) * TTILE : 0);
  static constexpr int TOTAL = BARS + 16 * P::STAGES + 16 + 1024;
  static_assert(TILE % 1024 == 0 && TTILE % 1024 == 0,
                "tiles keep the swizzle's alignment");
  static_assert(FP32 || P::XS, "bf16 fragments come from shared memory");
};

// acc (64 rows x BN) += X (this warpgroup's rows, from xs) . Y^T (the
// streamed tile at ya, K-major; fp32: its lo part at yla), QC k-steps of
// X's fragments at a time
template <typename T, int HD, int BN, int QC>
__device__ __forceinline__ void mma_rows(float (&acc)[BN / 2],
                                         const T* const (&xs)[2],
                                         const bool (&ok)[2], int t,
                                         uint32_t ya, uint32_t yla) {
  constexpr bool FP32 = sizeof(T) == 4;
  constexpr int KS = FP32 ? HD / 8 : HD / 16;
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += QC) {
    uint32_t ahi[QC][4], alo[QC][4];
#pragma unroll
    for (int kk = 0; kk < QC; ++kk) {
      const int ks = c0 + kk;
      if constexpr (FP32) {
        const int c = 8 * ks + t;
        const float x[4] = {ok[0] ? xs[0][c] : 0.f, ok[1] ? xs[1][c] : 0.f,
                            ok[0] ? xs[0][c + 4] : 0.f,
                            ok[1] ? xs[1][c + 4] : 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(x[j], ahi[kk][j], alo[kk][j]);
      } else {
        const int c = 16 * ks + 2 * t;
        ahi[kk][0] = *reinterpret_cast<const uint32_t*>(xs[0] + c);
        ahi[kk][1] = *reinterpret_cast<const uint32_t*>(xs[1] + c);
        ahi[kk][2] = *reinterpret_cast<const uint32_t*>(xs[0] + c + 8);
        ahi[kk][3] = *reinterpret_cast<const uint32_t*>(xs[1] + c + 8);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QC; ++kk) {
      const int ks = c0 + kk;
      const uint32_t off = (ks / 4) * BN * 128 + (ks % 4) * 32;
      const uint64_t dy = sdesc(ya + off, 16, 1024);
      if constexpr (FP32) {
        mma_tf32<BN>(acc, alo[kk], dy);
        mma_tf32<BN>(acc, ahi[kk], sdesc(yla + off, 16, 1024));
        mma_tf32<BN>(acc, ahi[kk], dy);
      } else {
        mma_bf16<BN, 0>(acc, ahi[kk], dy);
      }
    }
    wgmma_commit();
    wgmma_wait();
    hold(acc);
    hold(ahi);
    if constexpr (FP32) hold(alo);
  }
}

// acc (64 rows x HO) += pv (64 rows x BN, an accumulator) . Y (the tile's
// BN rows, its columns c0 .. c0 + HO - 1): fp32 from the transposed hi and
// lo parts at th, tl; bf16 from the tile at ya in place (MN-major)
template <bool FP32, int HO, int BN>
__device__ __forceinline__ void mma_out(float (&acc)[HO / 64][32],
                                        const float (&pv)[BN / 2],
                                        uint32_t th, uint32_t tl, uint32_t ya,
                                        int c0) {
  constexpr int NB = BN / 8, NO = HO / 64;
  if constexpr (FP32) {
    uint32_t phi[NB][4], plo[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      // slot order of the fragment: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
      // <- columns 2t, 2t (row g+8), 2t+1, 2t+1 (row g+8) of block j
      const int src[4] = {4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(pv[src[i]], phi[j][i], plo[j][i]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const uint32_t off = (j / 4) * HO * 128 + n * 64 * 128 + (j % 4) * 32;
        const uint64_t dh = sdesc(th + off, 16, 1024);
        wgmma_tf32_n64(acc[n], plo[j], dh);
        wgmma_tf32_n64(acc[n], phi[j], sdesc(tl + off, 16, 1024));
        wgmma_tf32_n64(acc[n], phi[j], dh);
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int n = 0; n < NO; ++n) hold(acc[n]);
    hold(phi);
    hold(plo);
  } else {
    uint32_t pb[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pb[j][i] = pack_bf16(pv[8 * j + 2 * i], pv[8 * j + 2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int n = 0; n < NO; ++n)
        wgmma_bf16_n64<1>(acc[n], pb[j],
                          sdesc(ya + (c0 / 64 + n) * BN * 128 + j * 16 * 128,
                                BN * 128, 1024));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int n = 0; n < NO; ++n) hold(acc[n]);
    hold(pb);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

struct Args {
  const void* x1;        // dQ: q; dK / dV: k
  const void* x2;        // dQ: dout; dK / dV: v
  const void* o;         // dQ: the forward's output (for D)
  const float* lse;      // (B, H, S)
  float* dsum;           // D, (B, H, S): written by dQ, read by dK / dV
  void* out1;            // dQ: dq; dK / dV: dk
  void* out2;            // dK / dV: dv
  float* part1;          // dK / dV with G > 1: fp32 partials (B, T, H, hd)
  float* part2;
  int* counters;         // dK / dV with G > 1: zeroed, one per key block
  long long x1sb, x1sh, x1ss, x2sb, x2sh, x2ss, osb, osh, oss;
  int H, KV, S, T_len, causal, window;
  float scale;
};

template <typename T, int HD, bool DKDV>
__device__ __forceinline__ void bwd_body(const CUtensorMap* y1map,
                                         const CUtensorMap* y2map,
                                         const Args& A) {
  using L = Layout<T, HD, DKDV>;
  using P = Plan<T, HD, DKDV>;
  constexpr int BR = L::BR, BN = P::BN, ST = P::STAGES, NC = L::NC;
  constexpr int HO = L::HO, NB = BN / 8, NO = HO / 64;
  constexpr bool FP32 = L::FP32;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + ST;
  int* last_flag = reinterpret_cast<int*>(empty + ST);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x % P::SPLIT, h = blockIdx.x / P::SPLIT;
  const int b = blockIdx.y, S = A.S, T_len = A.T_len, H = A.H;
  const int group = H / A.KV, kvh = h / group;
  const int c0 = split * HO;                       // this CTA's columns
  // dQ walks the query blocks from the last, dK / dV the key blocks from
  // the first: under a causal mask the blocks with the most tiles first
  const int rb = DKDV ? blockIdx.z : gridDim.z - 1 - blockIdx.z;
  const int row0 = rb * BR;
  const bool causal = A.causal != 0;
  const int window = A.window;
  // the streamed tiles that meet this row block under the mask
  int begin = 0, end;
  if constexpr (!DKDV) {     // the forward's key range
    end = (T_len + BN - 1) / BN;
    if (causal) end = min(end, (row0 + BR - 1) / BN + 1);
    if (window) {
      const int lo = row0 - window - BN + 2;
      if (lo > 0) begin = (lo + BN - 1) / BN;
    }
  } else {                   // queries at or past the first key; a window:
    end = (S + BN - 1) / BN; // before the last key + window
    if (causal) begin = min(end, row0 / BN);
    if (window) {
      const int last = min(row0 + BR, T_len) - 1;
      end = min(end, (last + window - 1) / BN + 1);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], DKDV ? 32 : 1);
      mbar_init(&empty[s], NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC / 32) {     // the producer warp (of its warpgroup)
    if constexpr (L::MOVE_REGS) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
      if (warp != NC / 32) return;
    }
    const int yh = DKDV ? h : kvh;
    if (DKDV || lane == 0) {
      for (int kt = begin, it = 0; kt < end; ++kt, ++it) {
        const int s = it % ST;
        mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        if constexpr (DKDV) {  // the tile's lse and D, one lane a column
          float* vl = reinterpret_cast<float*>(sm + L::VEC) + s * 2 * BN;
          for (int c = lane; c < BN; c += 32) {
            const int q = kt * BN + c;
            const long long at = ((long long)b * H + h) * S + q;
            vl[c] = q < S ? A.lse[at] : 0.f;
            vl[BN + c] = q < S ? A.dsum[at] : 0.f;
          }
        }
        if (lane == 0) {
          mbar_expect(&full[s], 2 * L::TILE);
          uint8_t* y1 = sm + L::Y + s * 2 * L::TILE;
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c) {
            tma_load(y1 + c * BN * 128, y1map, &full[s], c * 128 / L::ES,
                     kt * BN, yh, b);
            tma_load(y1 + L::TILE + c * BN * 128, y2map, &full[s],
                     c * 128 / L::ES, kt * BN, yh, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63
  if constexpr (L::MOVE_REGS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;   // this thread's rows r0, r0 + 8
  const int rowp[2] = {row0 + r0, row0 + r0 + 8};
  const int rows_len = DKDV ? T_len : S;
  const int xh = DKDV ? kvh : h;
  const T* x1p = static_cast<const T*>(A.x1) + b * A.x1sb + xh * A.x1sh;
  const T* x2p = static_cast<const T*>(A.x2) + b * A.x2sb + xh * A.x2sh;
  const T* xs1[2];
  const T* xs2[2];
  bool xok[2] = {true, true};
  if constexpr (P::XS) {
    T* s1 = reinterpret_cast<T*>(sm + L::X1);
    T* s2 = reinterpret_cast<T*>(sm + L::X2);
    constexpr int U = HD * L::ES / 16;            // 16-byte units of a row
    for (int i = tid; i < BR * U; i += NC) {
      const int r = i / U, c = (i % U) * (16 / L::ES), row = row0 + r;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), d = a;
      if (row < rows_len) {
        a = *reinterpret_cast<const uint4*>(x1p + row * A.x1ss + c);
        d = *reinterpret_cast<const uint4*>(x2p + row * A.x2ss + c);
      }
      *reinterpret_cast<uint4*>(s1 + r * L::XLD + c) = a;
      *reinterpret_cast<uint4*>(s2 + r * L::XLD + c) = d;
    }
    consumers_sync(NC);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs1[i] = s1 + (r0 + 8 * i) * L::XLD;
      xs2[i] = s2 + (r0 + 8 * i) * L::XLD;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xok[i] = rowp[i] < rows_len;
      xs1[i] = x1p + (xok[i] ? rowp[i] : 0) * A.x1ss;
      xs2[i] = x2p + (xok[i] ? rowp[i] : 0) * A.x2ss;
    }
  }
  // dQ: each row's lse, and D = rowsum(dO * O) (the row's four lanes, each
  // over columns t, t + 4, ...), written once for the dK / dV kernel
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
    const T* op = static_cast<const T*>(A.o) + b * A.osb + h * A.osh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rowp[i];
      float acc = 0.f;
      if (row < S) {
        const T* orow = op + row * A.oss;
        for (int d = t; d < HD; d += 4)
          acc = fmaf(to_f32(xs2[i][d]), to_f32(orow[d]), acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      d_r[i] = acc;
      const long long at = ((long long)b * H + h) * S + row;
      if (row < S) {
        lse_r[i] = A.lse[at];
        if (t == 0 && split == 0) A.dsum[at] = acc;
      }
    }
  }

  float acc1[NO][32];                 // dQ, or dK
  float acc2[DKDV ? NO : 1][32];      // dV
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc1[n][i] = 0.f;
  if constexpr (DKDV)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc2[n][i] = 0.f;
  const uint32_t lo1 = smem_u32(sm + L::LO), lo2 = lo1 + L::TILE;
  const uint32_t t1h = smem_u32(sm + L::TR), t1l = t1h + L::TTILE;
  const uint32_t t2h = t1l + L::TTILE, t2l = t2h + L::TTILE;
  const int wr0 = row0 + wg * 64;      // this warpgroup's first row

  for (int kt = begin, it = 0; kt < end; ++kt, ++it) {
    const int s = it % ST, col0 = kt * BN;
    uint8_t* sY1 = sm + L::Y + s * 2 * L::TILE;
    uint8_t* sY2 = sY1 + L::TILE;
    const uint32_t y1a = smem_u32(sY1), y2a = smem_u32(sY2);
    const float* vl = reinterpret_cast<const float*>(sm + L::VEC) + s * 2 * BN;
    mbar_wait(&full[s], (it / ST) & 1);
    if constexpr (FP32) {
      consumers_sync(NC);        // every consumer is done with the last split
      split_lo<L::TILE, NC>(sY1, sm + L::LO);
      split_lo<L::TILE, NC>(sY2, sm + L::LO + L::TILE);
      split_t<HO, BN, NC>(sY1, c0, sm + L::TR, sm + L::TR + L::TTILE);
      if constexpr (DKDV)
        split_t<HO, BN, NC>(sY2, c0, sm + L::TR + 2 * L::TTILE,
                            sm + L::TR + 3 * L::TTILE);
      fence_to_async();
      consumers_sync(NC);
    }
    // a warpgroup whose pairs all lie outside the causal mask or the
    // window skips the tile (every p would be 0)
    const int qmin = DKDV ? col0 : wr0, qmax = DKDV ? col0 + BN - 1 : wr0 + 63;
    const int kmin = DKDV ? wr0 : col0, kmax = DKDV ? wr0 + 63 : col0 + BN - 1;
    const bool active = !(causal && kmin > qmax) &&
                        !(window && kmax <= qmin - window);
    float sacc[BN / 2], pacc[BN / 2];
    if (active) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sacc[i] = pacc[i] = 0.f;
      mma_rows<T, HD, BN, P::QC>(sacc, xs1, xok, t, y1a, lo1);  // S
      mma_rows<T, HD, BN, P::QC>(pacc, xs2, xok, t, y2a, lo2);  // dP
      // P = exp(scale S - lse) where visible, else 0; dS = P (dP - D) scale
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * t + e;
            const int qpos = DKDV ? col0 + cl : rowp[hf];
            const int kpos = DKDV ? rowp[hf] : col0 + cl;
            const bool ok = qpos < S && kpos < T_len &&
                            (!causal || kpos <= qpos) &&
                            (!window || kpos > qpos - window);
            const float lv = DKDV ? vl[cl] : lse_r[hf];
            const float dv = DKDV ? vl[BN + cl] : d_r[hf];
            float& sv = sacc[4 * j + 2 * hf + e];
            float& pv = pacc[4 * j + 2 * hf + e];
            const float p = ok ? expf(sv * A.scale - lv) : 0.f;
            pv = p * (pv - dv) * A.scale;
            sv = p;
          }
    }
    if constexpr (FP32) {       // the raw tiles and vectors are read: free
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (active) {
      if constexpr (DKDV) mma_out<FP32, HO, BN>(acc2, sacc, t2h, t2l, y2a, c0);
      mma_out<FP32, HO, BN>(acc1, pacc, t1h, t1l, y1a, c0);
    }
    if constexpr (!FP32) {      // the second products read the stage in place
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  if constexpr (!DKDV) {
    T* out = static_cast<T*>(A.out1);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = rowp[hf];
      if (row >= S) continue;
      T* op = out + (((long long)b * S + row) * H + h) * HD + c0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store2(op + n * 64 + 8 * j + 2 * t, acc1[n][4 * j + 2 * hf],
                 acc1[n][4 * j + 2 * hf + 1]);
    }
  } else if (group == 1) {     // one query head per KV head: dK, dV direct
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = rowp[hf];
      if (key >= T_len) continue;
      const long long at = (((long long)b * T_len + key) * A.KV + kvh) * HD + c0;
      T* dk = static_cast<T*>(A.out1) + at;
      T* dv = static_cast<T*>(A.out2) + at;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n * 64 + 8 * j + 2 * t;
          store2(dk + c, acc1[n][4 * j + 2 * hf], acc1[n][4 * j + 2 * hf + 1]);
          store2(dv + c, acc2[n][4 * j + 2 * hf], acc2[n][4 * j + 2 * hf + 1]);
        }
    }
  } else {
    // this head's fp32 partials; the last of the G heads' CTAs of this key
    // block (and column split) sums them in head order
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = rowp[hf];
      if (key >= T_len) continue;
      const long long at = (((long long)b * T_len + key) * H + h) * HD + c0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n * 64 + 8 * j + 2 * t;
          store2(A.part1 + at + c, acc1[n][4 * j + 2 * hf],
                 acc1[n][4 * j + 2 * hf + 1]);
          store2(A.part2 + at + c, acc2[n][4 * j + 2 * hf],
                 acc2[n][4 * j + 2 * hf + 1]);
        }
    }
    __threadfence();
    consumers_sync(NC);
    if (tid == 0) {
      int* cnt = A.counters +
                 (((long long)b * A.KV + kvh) * gridDim.z + rb) * P::SPLIT + split;
      *last_flag = atomicAdd(cnt, 1) == group - 1;
    }
    consumers_sync(NC);
    if (*last_flag) {
      __threadfence();
      constexpr int U = HO / 4;                   // 4-column units of a row
      for (int i = tid; i < BR * U; i += NC) {
        const int r = i / U, c = c0 + (i % U) * 4, key = row0 + r;
        if (key >= T_len) continue;
        const long long src = (((long long)b * T_len + key) * H + kvh * group) * HD + c;
        float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = k4;
        for (int gg = 0; gg < group; ++gg) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(
              A.part1 + src + (long long)gg * HD));
          const float4 d = __ldcg(reinterpret_cast<const float4*>(
              A.part2 + src + (long long)gg * HD));
          k4 = make_float4(k4.x + a.x, k4.y + a.y, k4.z + a.z, k4.w + a.w);
          v4 = make_float4(v4.x + d.x, v4.y + d.y, v4.z + d.z, v4.w + d.w);
        }
        const long long at = (((long long)b * T_len + key) * A.KV + kvh) * HD + c;
        T* dk = static_cast<T*>(A.out1) + at;
        T* dv = static_cast<T*>(A.out2) + at;
        store2(dk, k4.x, k4.y);
        store2(dk + 2, k4.z, k4.w);
        store2(dv, v4.x, v4.y);
        store2(dv + 2, v4.z, v4.w);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<T, HD, false>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ Args args) {
  bwd_body<T, HD, false>(&kmap, &vmap, args);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Layout<T, HD, true>::THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ Args args) {
  bwd_body<T, HD, true>(&qmap, &dmap, args);
}

// st: element strides (batch, head, seq) of q, k, v, o, dout in that order
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq, void* dk,
           void* dv, float* pdk, float* pdv, int* counters,
           const long long* st, int B, int H, int KV, int S, int T_len,
           int causal, int window, float scale, cudaStream_t stream) {
  using LQ = Layout<T, HD, false>;
  using LK = Layout<T, HD, true>;
  constexpr bool fp32 = LQ::FP32;
  constexpr int BNQ = Plan<T, HD, false>::BN, BNK = Plan<T, HD, true>::BN;
  CUtensorMap kmap, vmap, qmap, dmap;
  int err = make_map(&kmap, k, fp32, HD, T_len, KV, B, st[5], st[4], st[3], BNQ);
  if (!err) err = make_map(&vmap, v, fp32, HD, T_len, KV, B, st[8], st[7], st[6], BNQ);
  if (!err) err = make_map(&qmap, q, fp32, HD, S, H, B, st[2], st[1], st[0], BNK);
  if (!err) err = make_map(&dmap, dout, fp32, HD, S, H, B, st[14], st[13], st[12], BNK);
  if (err) return err;
  auto kdq = flash_bwd_dq_kernel<T, HD>;
  auto kkv = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           LK::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{q, dout, o, lse, dsum, dq, nullptr, nullptr, nullptr, nullptr,
         st[0], st[1], st[2], st[12], st[13], st[14], st[9], st[10], st[11],
         H, KV, S, T_len, causal, window, scale};
  // dQ first: it writes D, which the dK / dV kernel reads
  kdq<<<dim3(H * Plan<T, HD, false>::SPLIT, B, (S + LQ::BR - 1) / LQ::BR),
        LQ::THREADS, LQ::TOTAL, stream>>>(kmap, vmap, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  a = Args{k, v, nullptr, lse, dsum, dk, dv, pdk, pdv, counters,
           st[3], st[4], st[5], st[6], st[7], st[8], 0, 0, 0,
           H, KV, S, T_len, causal, window, scale};
  kkv<<<dim3(H * Plan<T, HD, true>::SPLIT, B, (T_len + LK::BR - 1) / LK::BR),
        LK::THREADS, LK::TOTAL, stream>>>(qmap, dmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, float* pdk, float* pdv,
              int* counters, const long long* st, int B, int H, int KV, int S,
              int T_len, int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, pdk, pdv,
                           counters, st, B, H, KV, S, T_len, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, pdk, pdv,
                            counters, st, B, H, KV, S, T_len, causal, window,
                            scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, dsum, dq, dk, dv, pdk, pdv,
                            counters, st, B, H, KV, S, T_len, causal, window,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// (rows per CTA, rows of a streamed tile, stages, resident rows in shared
// memory, column splits, shared-memory bytes) of one kernel's plan
template <typename T, int HD, bool DKDV>
int plan_field(int field) {
  using L = Layout<T, HD, DKDV>;
  using P = Plan<T, HD, DKDV>;
  const int f[6] = {L::BR, P::BN, P::STAGES, P::XS ? 1 : 0, P::SPLIT, L::TOTAL};
  return f[field];
}
template <typename T, int HD>
int plan_kernel(int which, int field) {
  return which == 0 ? plan_field<T, HD, false>(field)
                    : plan_field<T, HD, true>(field);
}
template <typename T>
int plan_hd(int hd, int which, int field) {
  switch (hd) {
    case 64: return plan_kernel<T, 64>(which, field);
    case 128: return plan_kernel<T, 128>(which, field);
    case 256: return plan_kernel<T, 256>(which, field);
    default: return -1;
  }
}

}  // namespace

// One field of the plan of the dQ (which = 0) or dK / dV (which = 1)
// kernel at head dim hd in dtype (0 = float32, 1 = bfloat16): field 0 rows
// per CTA, 1 rows of a streamed tile, 2 stages, 3 resident rows in shared
// memory (1) or not (0), 4 column splits, 5 shared-memory bytes per CTA;
// -1 for what is not built. The wrapper's `flash_bwd_plan` computes the
// same and checks that the two agree.
extern "C" int flash_attention_bwd_plan(int hd, int dtype, int which,
                                        int field) {
  if (field < 0 || field > 5 || (which != 0 && which != 1)) return -1;
  if (dtype == 0) return plan_hd<float>(hd, which, field);
  if (dtype == 1) return plan_hd<bf16>(hd, which, field);
  return -1;
}

// q, o, dout (B, S, H, hd), k and v (B, T, KV, hd), addressed by the
// element strides (batch, head, seq) of q, k, v, o, dout in that order,
// unit stride along hd; q, k, v and dout (read by TMA) start on 16 bytes
// with strides of multiples of 16 bytes. lse (B, H, S) fp32 as the forward
// wrote it; dsum a (B, H, S) fp32 scratch (D); dq (B, S, H, hd), dk and dv
// (B, T, KV, hd) contiguous, in the inputs' dtype (0 = float32, 1 =
// bfloat16). With H > KV: pdk and pdv fp32 (B, T, H, hd) scratch and
// `counters` B * KV * ceil(T / rows) * splits zeroed ints (the dK / dV
// plan's rows and splits); null otherwise. Two launches on `stream`;
// returns a CUDA error code (0 on success), or 10000 when libcuda offers
// no cuTensorMapEncodeTiled and 10001 + its CUresult when it refuses a map.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, void* pdk, void* pdv, void* counters, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss, int B, int H,
    int KV, int S, int T_len, int hd, int dtype, int causal, int window,
    float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H > KV && (pdk == nullptr || pdv == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                            vss, osb, osh, oss, dsb, dsh, dss};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(dsum);
  auto* pk = static_cast<float*>(pdk);
  auto* pv = static_cast<float*>(pdv);
  auto* cnt = static_cast<int*>(counters);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, dout, l, d, dq, dk, dv, pk, pv,
                            cnt, st, B, H, KV, S, T_len, causal, window,
                            scale, s);
  if (dtype == 1)
    return launch_hd<bf16>(hd, q, k, v, o, dout, l, d, dq, dk, dv, pk, pv,
                           cnt, st, B, H, KV, S, T_len, causal, window, scale,
                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}
