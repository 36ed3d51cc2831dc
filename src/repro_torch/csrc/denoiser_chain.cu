// The whole K-step reverse-diffusion chain in one launch, on a thread-block
// cluster with its weights resident and fc1 / fc2 on the tensor cores.
//
// Replaces the Pallas kernel `repro/kernels/denoiser/kernel.py`
// (`_chain_kernel`, launched by `denoiser_chain`). For j = 0..K-1:
//   eps = tanh(W3 mish(W2 mish(W1 [x, temb_j, f_s] + b1) + b2) + b3)
//   x   = c_x[j] x + c_e[j] eps + c_n[j] noise_j
// and the result is tanh(x). Weights are row-major (in, out), as in the
// reference's params.
//
// Bound: operations. At the paper's widths (A = 10, F = 12..20, H = 256) a
// row costs ~160 kFLOP per step, dominated by the H x H product, while the
// weights are ~317 KB. The chain is sequential in j, so the card is covered
// by splitting each step's work, not the steps:
//
// * A cluster of C = 8 CTAs (`cudaLaunchAttributeClusterDimension`) owns a
//   tile of R = 16 batch rows; the hidden width H = 256 is fixed at compile
//   time, 32 columns per CTA. CTA r owns hidden columns
//   [r H/C, (r+1) H/C): those columns of W1 and b1, the same rows of W2 and
//   W3 and columns of b2. Its slices are copied into shared memory once per
//   launch with cp.async (W1 in one group, W2 and W3 in a second still in
//   flight while the first step's fc1 runs) and stay there for every step
//   of every tile the cluster walks: W2 is read from L2 once per CTA, not
//   once per step.
// * fc1 and fc2 run on the tensor cores with `mma.sync.m16n8k8` in TF32 at
//   fp32 accuracy (3xTF32): each operand v is split into a TF32 v_hi and
//   v_lo = v - v_hi, and a product is a_hi b_hi + a_hi b_lo + a_lo b_hi with
//   fp32 accumulation. Plain TF32 (11 significant bits) would break the
//   chain's 1e-4; the dropped a_lo b_lo term is ~2^-22 of the product. At
//   R = 16 one m16 tile covers the rows, so `wgmma` (64-row tiles) would
//   run three quarters empty. fc1 multiplies only x on the tensor cores:
//   b1 + f_s W1 holds for the whole chain and is summed once per tile, and
//   temb_j W1 is one row per step, summed in fp32 by threads that would
//   otherwise wait.
// * fc2 is split by its rows: CTA r multiplies its own columns of h1 by its
//   rows of W2 into partial sums for all H columns, and sends each other
//   CTA the block of partials of that CTA's columns in one bulk copy
//   (cp.async.bulk shared::cta -> shared::cluster). Each CTA sums the C
//   blocks of its columns in rank order, so h1 never leaves its CTA. fc3 is
//   split the same way: each CTA sends its partial (R x A) over its rows of
//   W3 to every other, and every CTA sums the C partials in rank order
//   0..C-1, so every CTA holds the same x, bit for bit.
// * A bulk copy counts its bytes on the receiver's mbarrier, which the
//   receiver arms with the step's expected bytes and waits on: the two
//   exchanges of a step need no cluster-wide barrier, whose release costs a
//   GPU-scope fence (MEMBAR.ALL.GPU) on every thread.
// * A step's noise rows, temb_j and coefficients are staged into shared
//   memory with 4-byte cp.async while the step before is computed.
// * Clusters are persistent: the grid holds as many clusters as can be
//   resident (the wrapper asks `cudaOccupancyMaxActiveClusters`, at most one
//   per row tile), and each walks the row tiles tile = id, id + clusters, ...
//   with its weights still in shared memory. A partial last tile computes on
//   zero rows and stores only the rows < B.
//
// The affine update and the final tanh round as the reference's `_pin`
// does (__fmul_rn / __fadd_rn). The cluster's pieces (the mma loops, the
// exchanges, mish) are `mlp_common.cuh`'s, shared with `denoiser_step.cu`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"

namespace {

// Shared-memory layout of one CTA, in floats; each region starts on 16
// bytes. Mirrored by `chain_smem_bytes` in kernels/denoiser/kernel.py. The
// A operands (the x tile and this CTA's h1 columns) are kept split, as (hi,
// lo) float pairs, so the mma loops load them with 8-byte loads and split
// only the weights. The fc2 partials are kept by owner: block q holds the
// R x ncol partial sums of CTA q's columns, contiguous, so it goes to CTA q
// in one bulk copy. Leading dimensions are padded so the fragments' shared
// loads hit distinct banks: the weights' rows (ncol + 8 and H + 8 floats)
// = 8 mod 32, the A operands' rows (LDX and pad16_4(ncol) pairs) = 4 mod
// 16.
constexpr int XK = 16;             // x's columns in fc1's mma (A <= 16)
constexpr int LDX = pad16_4(XK);

struct Layout {
  int D, w1rows, stage;
  int w1, w2, w3, b1, b2, b3, in, h1, out, recv, h2, fsb, tb, step, part,
      red, bars, total;
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ constexpr Layout make_layout(int A, int F, int TD) {
  Layout L{};
  const int ncol = NCOL;
  const int blk = R * (ncol + 4);              // R x ncol, padded, floats
  L.D = A + TD + F;
  L.w1rows = imax(XK, L.D);
  L.stage = round4(R * A + TD + 3);            // one step's noise, temb, c_*
  int off = 0;
  L.w1 = off;   off += round4(L.w1rows * (ncol + 8));  // W1[:, cols]
  L.w2 = off;   off += round4(ncol * (H + 8)); // W2[cols, :]
  L.w3 = off;   off += round4(ncol * A);       // W3[cols, :]
  L.b1 = off;   off += round4(ncol);
  L.b2 = off;   off += round4(ncol);
  L.b3 = off;   off += round4(A);
  L.in = off;   off += 2 * R * LDX;            // [x, 0 pad] pairs
  L.h1 = off;   off += 2 * R * pad16_4(ncol);  // this CTA's columns of h1
  L.out = off;  off += C * blk;                // fc2 partials, by owner
  L.recv = off; off += C * blk;                // fc2 partials in, by rank
  L.h2 = off;   off += blk;                    // this CTA's columns of h2
  L.fsb = off;  off += blk;                    // b1 + f_s W1, per tile
  L.tb = off;   off += 2 * round4(ncol);       // temb_j W1, two steps
  L.step = off; off += 2 * L.stage;            // two steps' inputs
  L.part = off; off += round4(C * R * A);      // fc3 partials by rank
  L.red = off;  off += 16 * ncol;              // fc1's k halves' exchange
  L.bars = off; off += 4;                      // two mbarriers (8 bytes)
  L.total = off;
  return L;
}


__global__ void __launch_bounds__(THREADS)
chain_cluster_kernel(const float* __restrict__ x,
                     const float* __restrict__ noises,
                     const float* __restrict__ fs,
                     const float* __restrict__ tembs,
                     const float* __restrict__ cx,
                     const float* __restrict__ ce,
                     const float* __restrict__ cn,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out,
                     int B, int A, int F, int TD, int K) {
  constexpr int LDW = NCOL + 8, LDW2 = H + 8, LDB = pad16_4(NCOL);
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Layout L = make_layout(A, F, TD);
  float* sW1 = sm + L.w1;
  float* sW2 = sm + L.w2;
  float* sW3 = sm + L.w3;
  float* sB1 = sm + L.b1;
  float* sB2 = sm + L.b2;
  float* sB3 = sm + L.b3;
  float2* sIn = reinterpret_cast<float2*>(sm + L.in);
  float2* sH1 = reinterpret_cast<float2*>(sm + L.h1);
  float* sOut = sm + L.out;
  float* sRecv = sm + L.recv;
  float* sH2 = sm + L.h2;
  float* sPart = sm + L.part;
  float* sRed = sm + L.red;
  // mbarriers: the other CTAs' fc2 partials, and their fc3 partials, in
  uint64_t& bar_h = *reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t& bar_p = *reinterpret_cast<uint64_t*>(sm + L.bars + 2);
  float* sFsb = sm + L.fsb;
  float* sTb = sm + L.tb;
  float* sStep = sm + L.step;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = L.D, RA = R * A;
  const int c0 = rank * NCOL;      // first hidden column this CTA owns
  const int row_h = g + 8 * (warp / GROUPS);             // fc1 epilogue row
  const int n0 = (warp % GROUPS) * NT * 8 + 2 * t;       // + 8j: columns
  // bytes that arrive from the other CTAs each step
  const uint32_t tx_h = (C - 1) * BLK * 4, tx_p = (C - 1) * RA * 4;
  // Step s's inputs (noise rows of the tile, temb_s, c_x, c_e, c_n) into
  // stage buffer s % 2 with 4-byte asynchronous copies; rows >= B get 0.
  auto stage = [&](int row0, int s) {
    float* st = sStep + (s & 1) * L.stage;
    for (int i = tid; i < RA + TD + 3; i += THREADS) {
      if (i < RA) {
        const int row = row0 + i / A;
        if (row < B)
          cp_async4(st + i, noises + ((size_t)s * B + row) * A + i % A);
        else
          st[i] = 0.f;
      } else if (i < RA + TD) {
        cp_async4(st + i, tembs + (size_t)s * TD + (i - RA));
      } else {
        const int c = i - RA - TD;
        cp_async4(st + i, (c == 0 ? cx : c == 1 ? ce : cn) + s);
      }
    }
  };

  // fc1's embedding part of step s, temb_s W1[A.., cols] (the same for every
  // row, fp32), into buffer s % 2, by the last NCOL threads (past fc3's
  // when R A + NCOL <= THREADS); stage(s) must be visible.
  auto embed_part = [&](int s) {
    const int c = tid - (THREADS - NCOL);
    if (c >= 0) {
      const float* st = sStep + (s & 1) * L.stage;
      float acc = 0.f;
      for (int d = 0; d < TD; ++d)
        acc = fmaf(st[RA + d], sW1[(A + d) * LDW + c], acc);
      sTb[(s & 1) * round4(NCOL) + c] = acc;
    }
  };

  // Weight slices, once per launch, with the first tile's step-0 inputs:
  // group 0 (W1, b1, b2, the inputs) is waited for before the first tile,
  // group 1 (W2, W3) before the first fc2. W2's slice is its rows c0.., one
  // contiguous stretch of global memory.
  constexpr int V4 = NCOL / 4;
  for (int i = tid; i < D * V4; i += THREADS) {
    const int d = i / V4, c = i % V4;
    cp_async16(sW1 + d * LDW + 4 * c, w1 + (size_t)d * H + c0 + 4 * c);
  }
  for (int i = tid; i < V4; i += THREADS) {
    cp_async16(sB1 + 4 * i, b1 + c0 + 4 * i);
    cp_async16(sB2 + 4 * i, b2 + c0 + 4 * i);
  }
  if (K > 0) stage((blockIdx.x / C) * R, 0);
  cp_async_commit();
  for (int i = tid; i < NCOL * (H / 4); i += THREADS) {
    const int k = i / (H / 4), c = i % (H / 4);
    cp_async16(sW2 + k * LDW2 + 4 * c, w2 + (size_t)(c0 + k) * H + 4 * c);
  }
  for (int i = tid; i < NCOL * A / 4; i += THREADS)
    cp_async16(sW3 + 4 * i, w3 + (size_t)c0 * A + 4 * i);
  cp_async_commit();
  // while they fly: W1's zero rows under fc1's x columns past D, b3 and the
  // mbarriers, each completing a phase on its own arrival plus the step's
  // bytes
  for (int i = tid; i < (L.w1rows - D) * LDW; i += THREADS) sW1[D * LDW + i] = 0.f;
  for (int i = tid; i < A; i += THREADS) sB3[i] = b3[i];
  if (tid == 0) {
    mbar_init(&bar_h, 1);
    mbar_init(&bar_p, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started, its mbarriers ready, before any
  // copies into another's shared memory
  cluster.sync();

  const int tiles = (B + R - 1) / R;
  const int clusters = gridDim.x / C;
  uint32_t phase = 0;      // parity of the mbarriers' current phase
  bool first = true;
  for (int tile = blockIdx.x / C; tile < tiles; tile += clusters) {
    const int row0 = tile * R;
    if (!first && K > 0) {
      stage(row0, 0);
      cp_async_commit();
    }
    if (first) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    // the tile's x, split, with zero columns up to XK; and fc1's part that
    // holds for the whole chain, b1 + f_s W1[A + TD.., cols], in fp32
    for (int i = tid; i < R * XK; i += THREADS) {
      const int r = i / XK, d = i % XK, row = row0 + r;
      sIn[r * LDX + d] =
          split_pair(row < B && d < A ? x[(size_t)row * A + d] : 0.f);
    }
    for (int i = tid; i < R * NCOL; i += THREADS) {
      const int r = i / NCOL, c = i % NCOL, row = row0 + r;
      float acc = sB1[c];
      if (row < B)
        for (int f = 0; f < F; ++f)
          acc = fmaf(fs[(size_t)row * F + f], sW1[(A + TD + f) * LDW + c], acc);
      sFsb[r * LDO + c] = acc;
    }
    if (K > 0) embed_part(0);
    for (int s = 0; s < K; ++s, phase ^= 1) {
      const float* st = sStep + (s & 1) * L.stage;
      if (s > 0) cp_async_wait<0>();
      if (tid == 0) {           // the bytes this step will receive
        mbar_expect(&bar_h, tx_h);
        mbar_expect(&bar_p, tx_p);
      }
      __syncthreads();
      // fc1 + mish: x's part on the tensor cores (the two k-tiles of
      // [x, 0 pad], one per k half), plus the parts above
      {
        float v[NT][2];
        linear_half<NT>(sIn, LDX, XK / 16, sW1, LDW, sRed, v);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + 8 * j;
          const float* fb = sFsb + row_h * LDO + n;
          const float* tb = sTb + (s & 1) * round4(NCOL) + n;
          const float2 h0 = split_pair(mish(v[j][0] + fb[0] + tb[0]));
          const float2 h1 = split_pair(mish(v[j][1] + fb[1] + tb[1]));
          *reinterpret_cast<float4*>(sH1 + row_h * LDB + n) =
              make_float4(h0.x, h0.y, h1.x, h1.y);
        }
      }
      if (first) {
        cp_async_wait<0>();
        first = false;
      }
      __syncthreads();          // h1's columns, W2 and W3
      // fc2 over this CTA's rows of W2, the partials to their owners
      fc2_send(sH1, sW2, sOut, sRecv, &bar_h, rank);
      if (s + 1 < K) {          // the next step's inputs, while the copies fly
        stage(row0, s + 1);
        cp_async_commit();
      }
      fc2_finish(sRecv, sB2, sH2, &bar_h, phase);
      cp_async_wait<0>();       // the next step's inputs
      __syncthreads();
      fc3_partial(sH2, sW3, sPart, rank, A);
      if (s + 1 < K) embed_part(s + 1);   // threads past fc3's, mostly
      __syncthreads();
      fc3_send(sPart, &bar_p, rank, RA);
      mbar_wait(&bar_p, phase);
      // eps and the affine update, the same in every CTA: partials summed
      // in rank order
      if (tid < RA) {
        const float eps = tanhf(fc3_sum(sPart, tid, RA) + sB3[tid % A]);
        float2* xp = sIn + (tid / A) * LDX + tid % A;
        const float xv = xp->x + xp->y;   // hi + lo is x exactly
        *xp = split_pair(__fadd_rn(
            __fadd_rn(__fmul_rn(st[RA + TD], xv), __fmul_rn(st[RA + TD + 1], eps)),
            __fmul_rn(st[RA + TD + 2], st[tid])));
      }
    }
    __syncthreads();
    if (rank == 0 && tid < RA) {
      const int row = row0 + tid / A;
      const float2 xp = sIn[(tid / A) * LDX + tid % A];
      if (row < B) out[(size_t)row * A + tid % A] = tanhf(xp.x + xp.y);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // K = 0: nothing waited for the weights
  // no CTA leaves while copies into it may be in flight
  cluster.sync();
}

cudaLaunchConfig_t config(int clusters, size_t smem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Shared memory a block may opt into on an H100 (sharedMemPerBlockOptin).
constexpr int SMEM_OPTIN = 232448;

}  // namespace

// Shared-memory bytes of one CTA (the wrapper's plan computes the same and
// checks that the two agree).
extern "C" int denoiser_chain_smem_bytes(int A, int F, int TD) {
  return (int)(sizeof(float) * make_layout(A, F, TD).total);
}

// Opts the kernel into SMEM_OPTIN bytes of shared memory on the current
// device and writes to *out how many clusters of C CTAs can be resident at
// once (the grid's cap). Called once per plan and device, before the first
// launch. Returns a CUDA error code.
extern "C" int denoiser_chain_max_clusters(int A, int F, int TD, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_OPTIN);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(
      1, sizeof(float) * make_layout(A, F, TD).total, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, chain_cluster_kernel, &cfg);
}

// All pointers are device pointers to contiguous fp32 arrays; w1, w2, w3,
// b1 and b2 16-byte aligned; the hidden width is H. Returns the launch's
// CUDA error code.
extern "C" int denoiser_chain_launch(
    const float* x, const float* noises, const float* fs, const float* tembs,
    const float* cx, const float* ce, const float* cn, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, float* out, int B, int A, int F, int TD, int K,
    int clusters, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(clusters, sizeof(float) * make_layout(A, F, TD).total,
             static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, chain_cluster_kernel, x, noises,
                                       fs, tembs, cx, ce, cn, w1, b1, w2, b2,
                                       w3, b3, out, B, A, F, TD, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
