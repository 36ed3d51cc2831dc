// One eps-MLP forward (the distilled student's whole decision) in one
// launch, on the chain kernel's cluster design.
//
// Replaces the Pallas kernel `repro/kernels/denoiser/kernel.py`
// (`_denoiser_kernel`, launched by `denoiser_step`): for inp (B, D) =
// [x, temb, f_s],
//   out = tanh(mish(mish(inp W1 + b1) W2 + b2) W3 + b3),   (B, A).
// The kernel reads x (B, A), the timestep embedding and f_s (B, F) where
// they lie, with no concatenated input: the embedding is one row per batch
// row or, with row stride 0, one row for all (the distilled sampler's
// constant T). Weights are row-major (in, out), as in the reference's
// params.
//
// Bound: operations, and far under a launch. At the main path's shape
// (B = 256, D = 42, H = 256, A = 10) the products are 40.4 MFLOP: 0.245 us
// as 3xTF32 on the tensor cores (0.60 us as fp32 FMAs), against 0.37 MB
// (317 KB of it weights, 0.11 us at 3.35 TB/s). What a call costs is
// latency: the weights into shared memory, then fc1, fc2 and fc3 in
// sequence with two exchanges.
//
// Design: one step of the denoiser_chain kernel (`mlp_common.cuh`). A
// cluster of C = 8 CTAs owns a tile of R = 16 rows; CTA r holds hidden
// columns [32 r, 32 (r+1)): those columns of W1, b1 and b2 and the same
// rows of W2 and W3, copied into shared memory with cp.async (W1 first,
// W2 and W3 in a second group still in flight while fc1 runs). fc1 runs on
// the tensor cores over the whole input [x, temb, f_s] (D padded to a
// multiple of 16 with zero rows of W1), and fc2 in 3xTF32 split by its rows,
// the partial sums of each CTA's columns sent to it by bulk copies counted
// on its mbarrier; fc3's partials travel the same way and rank 0 stores
// tanh(eps). B = 256 gives 16 clusters on 128 SMs; the clusters are
// persistent over the row tiles when more tiles than resident clusters.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"

namespace {

// Shared-memory layout of one CTA, in floats; each region starts on 16
// bytes. Mirrored by `step_smem_bytes` in kernels/denoiser/kernel.py. XK:
// fc1's depth, D rounded up to 16 (one k-tile of 8 per half-warp group of
// `linear_half`, in two halves).
struct Layout {
  int XK;
  int w1, w2, w3, b1, b2, b3, in, h1, out, recv, h2, part, red, bars, total;
};

__host__ __device__ constexpr Layout make_layout(int A, int D) {
  Layout L{};
  L.XK = (D + 15) / 16 * 16;
  int off = 0;
  L.w1 = off;   off += round4(L.XK * (NCOL + 8));  // W1[:, cols], zero rows past D
  L.w2 = off;   off += round4(NCOL * (H + 8));     // W2[cols, :]
  L.w3 = off;   off += round4(NCOL * A);           // W3[cols, :]
  L.b1 = off;   off += round4(NCOL);
  L.b2 = off;   off += round4(NCOL);
  L.b3 = off;   off += round4(A);
  L.in = off;   off += 2 * R * pad16_4(L.XK);      // [x, temb, f_s] pairs
  L.h1 = off;   off += 2 * R * pad16_4(NCOL);      // this CTA's columns of h1
  L.out = off;  off += C * BLK;                    // fc2 partials, by owner
  L.recv = off; off += C * BLK;                    // fc2 partials in, by rank
  L.h2 = off;   off += BLK;                        // this CTA's columns of h2
  L.part = off; off += round4(C * R * A);          // fc3 partials by rank
  L.red = off;  off += 16 * NCOL;                  // fc1's k halves' exchange
  L.bars = off; off += 4;                          // two mbarriers
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(THREADS)
step_cluster_kernel(const float* __restrict__ x,
                    const float* __restrict__ temb, int temb_stride,
                    const float* __restrict__ fs,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2,
                    const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ out,
                    int B, int A, int F, int TD) {
  constexpr int LDW = NCOL + 8, LDW2 = H + 8, LDB = pad16_4(NCOL);
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int D = A + TD + F;
  const Layout L = make_layout(A, D);
  const int XK = L.XK, LDX = pad16_4(XK);
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int RA = R * A;
  const int c0 = rank * NCOL;      // first hidden column this CTA owns
  const int row_h = (lane >> 2) + 8 * (warp / GROUPS);   // fc1 epilogue row
  const int n0 = (warp % GROUPS) * NT * 8 + 2 * t;       // + 8j: columns
  // bytes that arrive from the other CTAs each tile
  const uint32_t tx_h = (C - 1) * BLK * 4, tx_p = (C - 1) * RA * 4;

  // Weight slices, once per launch: group 0 (W1, b1, b2) is waited for
  // before fc1, group 1 (W2, W3) before fc2. W2's slice is its rows c0..,
  // one contiguous stretch of global memory.
  constexpr int V4 = NCOL / 4;
  for (int i = tid; i < D * V4; i += THREADS) {
    const int d = i / V4, c = i % V4;
    cp_async16(sW1 + d * LDW + 4 * c, w1 + (size_t)d * H + c0 + 4 * c);
  }
  for (int i = tid; i < V4; i += THREADS) {
    cp_async16(sB1 + 4 * i, b1 + c0 + 4 * i);
    cp_async16(sB2 + 4 * i, b2 + c0 + 4 * i);
  }
  cp_async_commit();
  for (int i = tid; i < NCOL * (H / 4); i += THREADS) {
    const int k = i / (H / 4), c = i % (H / 4);
    cp_async16(sW2 + k * LDW2 + 4 * c, w2 + (size_t)(c0 + k) * H + 4 * c);
  }
  for (int i = tid; i < NCOL * A / 4; i += THREADS)
    cp_async16(sW3 + 4 * i, w3 + (size_t)c0 * A + 4 * i);
  cp_async_commit();
  // while they fly: W1's zero rows past D, b3 and the mbarriers
  for (int i = tid; i < (XK - D) * LDW; i += THREADS) sW1[D * LDW + i] = 0.f;
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
  for (int tile = blockIdx.x / C; tile < tiles; tile += clusters, phase ^= 1) {
    const int row0 = tile * R;
    // the tile's input [x, temb, f_s], split, zero past D and past B
    for (int i = tid; i < R * XK; i += THREADS) {
      const int r = i / XK, d = i % XK, row = row0 + r;
      float v = 0.f;
      if (row < B) {
        if (d < A) v = x[(size_t)row * A + d];
        else if (d < A + TD) v = temb[(size_t)row * temb_stride + d - A];
        else if (d < D) v = fs[(size_t)row * F + d - A - TD];
      }
      sIn[r * LDX + d] = split_pair(v);
    }
    if (first) cp_async_wait<1>();    // W1, b1, b2
    if (tid == 0) {                   // the bytes this tile will receive
      mbar_expect(&bar_h, tx_h);
      mbar_expect(&bar_p, tx_p);
    }
    __syncthreads();
    // fc1 + mish on the tensor cores, D in two k halves
    {
      float v[NT][2];
      linear_half<NT>(sIn, LDX, XK / 16, sW1, LDW, sRed, v);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j;
        const float2 h0 = split_pair(mish(v[j][0] + sB1[n]));
        const float2 h1 = split_pair(mish(v[j][1] + sB1[n + 1]));
        *reinterpret_cast<float4*>(sH1 + row_h * LDB + n) =
            make_float4(h0.x, h0.y, h1.x, h1.y);
      }
    }
    if (first) {
      cp_async_wait<0>();             // W2, W3
      first = false;
    }
    __syncthreads();                  // h1's columns, W2 and W3
    fc2_send(sH1, sW2, sOut, sRecv, &bar_h, rank);
    fc2_finish(sRecv, sB2, sH2, &bar_h, phase);
    __syncthreads();
    fc3_partial(sH2, sW3, sPart, rank, A);
    __syncthreads();
    fc3_send(sPart, &bar_p, rank, RA);
    mbar_wait(&bar_p, phase);
    if (rank == 0 && tid < RA) {
      const int row = row0 + tid / A;
      if (row < B)
        out[(size_t)row * A + tid % A] =
            tanhf(fc3_sum(sPart, tid, RA) + sB3[tid % A]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // a cluster with no tile waited for nothing
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

size_t smem_bytes(int A, int F, int TD) {
  return sizeof(float) * make_layout(A, A + TD + F).total;
}

}  // namespace

// Shared-memory bytes of one CTA (the wrapper's plan computes the same and
// checks that the two agree).
extern "C" int denoiser_step_smem_bytes(int A, int F, int TD) {
  return (int)smem_bytes(A, F, TD);
}

// Opts the kernel into SMEM_OPTIN bytes of shared memory on the current
// device and writes to *out how many clusters of C CTAs can be resident at
// once (the grid's cap). Called once per plan and device, before the first
// launch. Returns a CUDA error code.
extern "C" int denoiser_step_max_clusters(int A, int F, int TD, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      step_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_OPTIN);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(1, smem_bytes(A, F, TD), nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, step_cluster_kernel, &cfg);
}

// All pointers are device pointers to contiguous fp32 arrays; w1, b1, w2,
// b2 and w3 16-byte aligned; the hidden width is H. temb row r is at
// temb + r * temb_stride (0: one row for all). Returns the launch's CUDA
// error code.
extern "C" int denoiser_step_launch(
    const float* x, const float* temb, const float* fs, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, float* out, int temb_stride, int B, int A, int F,
    int TD, int clusters, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(clusters, smem_bytes(A, F, TD),
                                  static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, step_cluster_kernel, x, temb,
                                       temb_stride, fs, w1, b1, w2, b2, w3,
                                       b3, out, B, A, F, TD);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
