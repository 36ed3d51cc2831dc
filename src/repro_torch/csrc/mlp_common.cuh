// Device code shared by the denoiser kernels (`denoiser_chain.cu`,
// `denoiser_step.cu`): the eps-MLP fc1 -> mish -> fc2 -> mish -> fc3 of
// the paper's denoiser (H = 256) on a cluster of C = 8 CTAs that split the
// hidden width, each holding its slices of the weights in shared memory.
// fc1 and fc2 run on the tensor cores (`mma.sync.m16n8k8`, 3xTF32); fc2's
// and fc3's partial sums travel between the CTAs by bulk copies counted on
// the receivers' mbarriers. Each kernel source is its own translation unit
// and library, so the anonymous namespace gives each its own copy.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mish(float v) {
  // softplus as logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|)), as
  // jax.nn.softplus computes it
  const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return v * tanhf(sp);
}

constexpr int R = 16;              // batch rows per cluster tile (one m16 tile)
constexpr int GROUPS = 4;          // column groups of a CTA's slice
constexpr int WARPS = 2 * GROUPS;  // a column group's k halves
constexpr int THREADS = WARPS * 32;
// The hidden width the paper's denoiser uses, split over a cluster of C
// CTAs of NCOL columns each (NT column tiles of 8 per column group): fixed
// at compile time, so the mma loops unroll with every shared-memory offset
// a constant.
constexpr int H = 256;
constexpr int C = 8;
constexpr int NT = 1;
constexpr int NCOL = NT * GROUPS * 8;
static_assert(NCOL * C == H, "the cluster covers the hidden width");

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// the least m >= n with m = 4 mod 16
__host__ __device__ constexpr int pad16_4(int n) { return (n + 11) / 16 * 16 + 4; }

// fc2's partial blocks: R x NCOL, rows padded to LDO floats
constexpr int LDO = NCOL + 4, BLK = R * LDO;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The exchange between the CTAs of a cluster: a CTA copies a contiguous
// block of its shared memory into another's with one bulk asynchronous copy
// (cp.async.bulk, shared::cta to shared::cluster), which counts the bytes
// on the receiver's mbarrier; the receiver expects the bytes of each step
// and waits for the phase. No cluster-wide barrier (and none of the
// GPU-scope fence that barrier.cluster's release costs) sits on the step's
// path.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}
// Copies `bytes` (a multiple of 16) from this CTA's `src` to `dst` in CTA
// `rank` (`dst` names the same offset in this CTA's shared memory), counted
// on that CTA's `bar`; returns once `src` has been read, so the caller may
// overwrite it.
__device__ __forceinline__ void bulk_to_peer(void* dst, const void* src,
                                             int bytes, uint64_t* bar,
                                             int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::"r"(peer_addr(dst, rank)),
      "r"(smem_addr(src)), "r"(bytes), "r"(peer_addr(bar, rank))
      : "memory");
}
// Orders this thread's shared-memory writes before the async proxy's reads
// (the bulk copies started after the next __syncthreads).
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// v = hi + lo: hi is v rounded to TF32's 11 significant bits (to nearest,
// ties away, on the bit pattern: two integer operations, where cvt.rna
// costs many), lo = v - hi is exact in fp32, and the mma reads lo's top 11
// bits, so hi + lo carries v to 2^-21 of |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float2 split_pair(float v) {
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (this lane's m16n8 fragment of column tile j) = the sum over nk
// k-tiles of a (R x 8 per k-tile, (hi, lo) pairs, row-major, lda) times
// w[8k.., n0 + 8j ..] (fp32, row-major, ldw), in 3xTF32. Fragment layout of
// m16n8k8 (g = lane / 4, t = lane % 4): a {(g, t), (g+8, t), (g, t+4),
// (g+8, t+4)}, b {(t, g), (t+4, g)}, d {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)}. KP k-tiles are loaded together and multiplied into KP
// independent accumulators (nk must be a multiple of KP); called with
// constant nk, lda and ldw, the loop unrolls to loads at fixed offsets.
template <int NT, int KP>
__device__ __forceinline__ void mma_range(const float2* __restrict__ a,
                                          int lda, int nk,
                                          const float* __restrict__ w,
                                          int ldw, int n0,
                                          float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float big[KP][NT][4], small[KP][NT][4];
#pragma unroll
  for (int p = 0; p < KP; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) big[p][j][i] = small[p][j][i] = 0.f;
  const float2* arow = a + g * lda + t;
  const float* wcol = w + t * ldw + n0 + g;
#pragma unroll
  for (int k0 = 0; k0 < nk; k0 += KP) {
    float2 ra[KP][4];
    float rb[KP][NT][2];
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const float2* ap = arow + (k0 + p) * 8;
      ra[p][0] = ap[0];
      ra[p][1] = ap[8 * lda];
      ra[p][2] = ap[4];
      ra[p][3] = ap[8 * lda + 4];
      const float* wp = wcol + (k0 + p) * 8 * ldw;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        rb[p][j][0] = wp[j * 8];
        rb[p][j][1] = wp[4 * ldw + j * 8];
      }
    }
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = __float_as_uint(ra[p][i].x);
        al[i] = __float_as_uint(ra[p][i].y);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(rb[p][j][0], bh0, bl0);
        split_tf32(rb[p][j][1], bh1, bl1);
        mma_tf32(small[p][j], al, bh0, bh1);
        mma_tf32(small[p][j], ah, bl0, bl1);
        mma_tf32(big[p][j], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = big[0][j][i] + small[0][j][i];
#pragma unroll
      for (int p = 1; p < KP; ++p) s += big[p][j][i] + small[p][j][i];
      acc[j][i] = s;
    }
}

// fc1's product for this CTA's columns: warp (grp, kh) = (warp % 4,
// warp / 4) multiplies its column group over k-tiles [kh nk, (kh + 1) nk);
// the halves meet in shared memory (the lower half's sum first, in every
// CTA and every run), and each warp returns the finished sum for half the
// rows: row g + 8 kh, columns n0 + 8j + 2t and + 1, in v[j].
template <int NT>
__device__ __forceinline__ void linear_half(const float2* __restrict__ a,
                                            int lda, int nk,
                                            const float* __restrict__ w,
                                            int ldw, float* __restrict__ red,
                                            float (&v)[NT][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp % GROUPS, kh = warp / GROUPS;
  float acc[NT][4];
  mma_range<NT, 1>(a + kh * nk * 8, lda, nk, w + kh * nk * 8 * ldw, ldw,
                   grp * NT * 8, acc);
  // red: [kh of the writer][grp][j][lane][2]; each warp hands over the rows
  // its partner finishes
  float* mine = red + (((kh * GROUPS + grp) * NT) * 32 + lane) * 2;
  const float* theirs = red + ((((1 - kh) * GROUPS + grp) * NT) * 32 + lane) * 2;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    *reinterpret_cast<float2*>(mine + j * 64) =
        kh ? make_float2(acc[j][0], acc[j][1]) : make_float2(acc[j][2], acc[j][3]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 o = *reinterpret_cast<const float2*>(theirs + j * 64);
    v[j][0] = kh ? o.x + acc[j][2] : acc[j][0] + o.x;
    v[j][1] = kh ? o.y + acc[j][3] : acc[j][1] + o.y;
  }
}

// fc2 over this CTA's rows of W2 (sW2, NCOL x H, rows padded to H + 8) on
// its columns of h1 (sH1, (hi, lo) pairs, rows padded to pad16_4(NCOL)):
// partial sums for all H columns, kept by the CTA that owns them (block q
// of sOut for CTA q, this CTA's own in its slot of sRecv); then each block
// goes to its owner in one bulk copy, counted on the owner's bar_h.
__device__ __forceinline__ void fc2_send(const float2* __restrict__ sH1,
                                         const float* __restrict__ sW2,
                                         float* sOut, float* sRecv,
                                         uint64_t* bar_h, int rank) {
  constexpr int NT2 = H / (8 * WARPS);    // fc2 column tiles per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  {
    float acc[NT2][4];
    const int nb = warp * (H / WARPS);    // warp w has columns w H/8 ..
    mma_range<NT2, 1>(sH1, pad16_4(NCOL), NCOL / 8, sW2, H + 8, nb, acc);
    const int q = nb / NCOL;   // the owner of these columns
    float* blk = (q == rank ? sRecv + rank * BLK : sOut + q * BLK);
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int n = nb % NCOL + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(blk + g * LDO + n) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(blk + (g + 8) * LDO + n) =
          make_float2(acc[j][2], acc[j][3]);
    }
    fence_to_async();
  }
  __syncthreads();
  if (tid >= THREADS - (C - 1)) {   // block q to CTA q, one thread each
    const int q = (rank + THREADS - tid) % C;
    bulk_to_peer(sRecv + rank * BLK, sOut + q * BLK, BLK * 4, bar_h, q);
  }
}

// Waits for every CTA's partials of this CTA's columns; h2 = mish(fc2 +
// b2), the partials summed in rank order.
__device__ __forceinline__ void fc2_finish(const float* __restrict__ sRecv,
                                           const float* __restrict__ sB2,
                                           float* __restrict__ sH2,
                                           uint64_t* bar_h, uint32_t phase) {
  mbar_wait(bar_h, phase);
  for (int i = threadIdx.x; i < R * NCOL; i += THREADS) {
    const int r = i / NCOL, c = i % NCOL;
    float sum = sRecv[r * LDO + c];
#pragma unroll
    for (int q = 1; q < C; ++q) sum += sRecv[q * BLK + r * LDO + c];
    sH2[r * LDO + c] = mish(sum + sB2[c]);
  }
}

// fc3 over this CTA's rows of W3 (sW3, NCOL x A): thread i < R A computes
// its partial for (row i / A, action dim i % A) into this CTA's slot of
// sPart.
__device__ __forceinline__ void fc3_partial(const float* __restrict__ sH2,
                                            const float* __restrict__ sW3,
                                            float* sPart, int rank, int A) {
  const int tid = threadIdx.x, RA = R * A;
  if (tid < RA) {
    const int a = tid % A;
    const float* h = sH2 + (tid / A) * LDO;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
    for (int k = 0; k < NCOL; k += 4) {
      p0 = fmaf(h[k], sW3[k * A + a], p0);
      p1 = fmaf(h[k + 1], sW3[(k + 1) * A + a], p1);
      p2 = fmaf(h[k + 2], sW3[(k + 2) * A + a], p2);
      p3 = fmaf(h[k + 3], sW3[(k + 3) * A + a], p3);
    }
    sPart[rank * RA + tid] = (p0 + p1) + (p2 + p3);
    fence_to_async();
  }
}

// This CTA's fc3 partial into its slot in every other CTA (after a
// __syncthreads that follows fc3_partial), counted on their bar_p.
__device__ __forceinline__ void fc3_send(float* sPart, uint64_t* bar_p,
                                         int rank, int RA) {
  const int tid = threadIdx.x;
  if (tid >= THREADS - (C - 1))
    bulk_to_peer(sPart + rank * RA, sPart + rank * RA, RA * 4, bar_p,
                 (rank + THREADS - tid) % C);
}

// fc3's sum for element i of the tile, the partials in rank order 0..C-1,
// so every CTA holds the same value, bit for bit.
__device__ __forceinline__ float fc3_sum(const float* sPart, int i, int RA) {
  float sum = sPart[i];
#pragma unroll
  for (int q = 1; q < C; ++q) sum += sPart[q * RA + i];
  return sum;
}

}  // namespace
