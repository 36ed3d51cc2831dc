// The whole K-step reverse-diffusion chain in one launch.
//
// Replaces the Pallas kernel `repro/kernels/denoiser/kernel.py`
// (`_chain_kernel`, launched by `denoiser_chain`). For j = 0..K-1:
//   eps = tanh(W3 mish(W2 mish(W1 [x, temb_j, f_s] + b1) + b2) + b3)
//   x   = c_x[j] x + c_e[j] eps + c_n[j] noise_j
// and the result is tanh(x). Weights are row-major (in, out), as in the
// reference's params.
//
// Bound: fp32 operations. At the paper's widths (A = 10, F = 16..20,
// H = 256) a row costs ~160 kFLOP per step, dominated by the H x H product,
// while the weights are ~317 KB, read once from device memory. One block
// owns ROWS batch rows for the whole chain: x, f_s, the timestep embedding
// and both hidden activations stay in shared memory across all K steps, W1,
// W3 and the biases are copied into shared memory once, and W2 (256 KB, too
// large for one block's 227 KB next to W1) is streamed from global memory,
// where it stays in L2, each load feeding ROWS fused multiply-adds. Plain
// fp32 FMAs, one hidden column per thread; wgmma, TMA or a 2-CTA cluster
// holding W2 on chip is later work.
#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

constexpr int ROWS = 4;       // batch rows per block
constexpr int THREADS = 256;  // one hidden column per thread (strided if H > 256)

__global__ void __launch_bounds__(THREADS)
chain_kernel(const float* __restrict__ x, const float* __restrict__ noises,
             const float* __restrict__ fs, const float* __restrict__ tembs,
             const float* __restrict__ cx, const float* __restrict__ ce,
             const float* __restrict__ cn, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ w3,
             const float* __restrict__ b3, float* __restrict__ out, int B,
             int A, int F, int TD, int H, int K) {
  extern __shared__ float sm[];
  const int D = A + TD + F;
  float* sW1 = sm;               // D x H
  float* sW3 = sW1 + D * H;      // H x A
  float* sB1 = sW3 + H * A;      // H
  float* sB2 = sB1 + H;          // H
  float* sB3 = sB2 + H;          // A
  float* sIn = sB3 + A;          // ROWS x D: [x, temb, f_s]
  float* sH1 = sIn + ROWS * D;   // ROWS x H
  float* sH2 = sH1 + ROWS * H;   // ROWS x H

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  for (int i = tid; i < D * H; i += THREADS) sW1[i] = w1[i];
  for (int i = tid; i < H * A; i += THREADS) sW3[i] = w3[i];
  for (int i = tid; i < H; i += THREADS) { sB1[i] = b1[i]; sB2[i] = b2[i]; }
  for (int i = tid; i < A; i += THREADS) sB3[i] = b3[i];
  for (int i = tid; i < ROWS * A; i += THREADS) {
    const int r = i / A, a = i % A, row = row0 + r;
    sIn[r * D + a] = row < B ? x[(size_t)row * A + a] : 0.f;
  }
  for (int i = tid; i < ROWS * F; i += THREADS) {
    const int r = i / F, f = i % F, row = row0 + r;
    sIn[r * D + A + TD + f] = row < B ? fs[(size_t)row * F + f] : 0.f;
  }

  for (int s = 0; s < K; ++s) {
    for (int i = tid; i < ROWS * TD; i += THREADS) {
      const int r = i / TD, j = i % TD;
      sIn[r * D + A + j] = tembs[s * TD + j];
    }
    __syncthreads();
    // fc1 + mish: W1 and the inputs from shared memory
    for (int j = tid; j < H; j += THREADS) {
      float acc[ROWS] = {};
      for (int d = 0; d < D; ++d) {
        const float w = sW1[d * H + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sIn[r * D + d], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sH1[r * H + j] = mish(acc[r] + sB1[j]);
    }
    __syncthreads();
    // fc2 + mish: W2 streamed from global memory (L2), coalesced over j
    for (int j = tid; j < H; j += THREADS) {
      float acc[ROWS] = {};
#pragma unroll 8
      for (int i = 0; i < H; ++i) {
        const float w = __ldg(&w2[(size_t)i * H + j]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sH1[r * H + i], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sH2[r * H + j] = mish(acc[r] + sB2[j]);
    }
    __syncthreads();
    // fc3 + tanh + the affine update: one warp per (row, action dim)
    for (int p = warp; p < ROWS * A; p += THREADS / 32) {
      const int r = p / A, a = p % A, row = row0 + r;
      float acc = 0.f;
      for (int i = lane; i < H; i += 32) acc = fmaf(sH2[r * H + i], sW3[i * A + a], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float eps = tanhf(acc + sB3[a]);
        const float nz = row < B ? noises[((size_t)s * B + row) * A + a] : 0.f;
        const float xv = sIn[r * D + a];
        sIn[r * D + a] = __fadd_rn(__fadd_rn(__fmul_rn(cx[s], xv),
                                             __fmul_rn(ce[s], eps)),
                                   __fmul_rn(cn[s], nz));
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < ROWS * A; i += THREADS) {
    const int r = i / A, a = i % A, row = row0 + r;
    if (row < B) out[(size_t)row * A + a] = tanhf(sIn[r * D + a]);
  }
}

size_t smem_bytes(int A, int F, int TD, int H) {
  const int D = A + TD + F;
  return sizeof(float) *
         ((size_t)D * H + (size_t)H * A + 2 * H + A + ROWS * (D + 2 * H));
}

}  // namespace

extern "C" int denoiser_chain_smem_bytes(int A, int F, int TD, int H) {
  return (int)smem_bytes(A, F, TD, H);
}

// All pointers are device pointers to contiguous fp32 arrays. Returns
// cudaGetLastError() after the launch.
extern "C" int denoiser_chain_launch(
    const float* x, const float* noises, const float* fs, const float* tembs,
    const float* cx, const float* ce, const float* cn, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, float* out, int B, int A, int F, int TD, int H, int K,
    void* stream) {
  const size_t smem = smem_bytes(A, F, TD, H);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + ROWS - 1) / ROWS), block(THREADS);
  chain_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, noises, fs, tembs, cx, ce, cn, w1, b1, w2, b2, w3, b3, out, B, A, F,
      TD, H, K);
  return (int)cudaGetLastError();
}
