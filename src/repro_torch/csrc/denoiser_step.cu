// One eps-MLP forward (the distilled student's whole decision) in one
// launch.
//
// Replaces the Pallas kernel `repro/kernels/denoiser/kernel.py`
// (`_denoiser_kernel`, launched by `denoiser_step`): for inp (B, D) =
// [x, temb, f_s],
//   out = tanh(mish(mish(inp W1 + b1) W2 + b2) W3 + b3),   (B, A).
// Weights are row-major (in, out), as in the reference's params.
//
// Bound: latency and launch, not bytes or operations. At the main path's
// shape (B = 256, D = 42, H = 256, A = 10) the three products are 40.4
// MFLOP of fp32 FMAs (0.60 us at 67 TFLOP/s) and the function reads
// 0.37 MB, 317 KB of it weights (0.11 us at 3.35 TB/s); both lie under the
// ~0.9 us a launch of any kernel takes on the card.
//
// Design: unlike in the chain, each weight is used once per block, so
// nothing is staged in shared memory. W1, W2 and W3 are read through the
// read-only path (__ldg) and stay in L2 across blocks; thread j reads
// column j, so a warp's loads coalesce, and each load feeds ROWS fused
// multiply-adds. A block owns ROWS batch rows and keeps them and both
// hidden activations in shared memory; B = 256 gives 32 blocks. fc3 and
// the tanh take one warp per (row, action dim). Plain fp32 FMAs: no
// cuBLAS, no wgmma yet.
#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

constexpr int ROWS = 8;       // batch rows per block
constexpr int THREADS = 256;  // one hidden column per thread (strided if H > 256)
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__global__ void __launch_bounds__(THREADS)
denoiser_step_kernel(const float* __restrict__ inp,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out,
                     int B, int D, int H, int A) {
  extern __shared__ float sm[];
  float* sIn = sm;               // ROWS x D
  float* sH1 = sIn + ROWS * D;   // ROWS x H
  float* sH2 = sH1 + ROWS * H;   // ROWS x H

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  // the block's rows are contiguous in inp; rows past B read as zeros
  for (int i = tid; i < ROWS * D; i += THREADS)
    sIn[i] = i / D < nrows ? inp[(size_t)row0 * D + i] : 0.f;
  __syncthreads();
  // fc1 + mish
  for (int j = tid; j < H; j += THREADS) {
    float acc[ROWS] = {};
#pragma unroll 6
    for (int d = 0; d < D; ++d) {
      const float w = __ldg(&w1[(size_t)d * H + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sIn[r * D + d], w, acc[r]);
    }
    const float bj = __ldg(&b1[j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sH1[r * H + j] = mish(acc[r] + bj);
  }
  __syncthreads();
  // fc2 + mish
  for (int j = tid; j < H; j += THREADS) {
    float acc[ROWS] = {};
#pragma unroll 8
    for (int i = 0; i < H; ++i) {
      const float w = __ldg(&w2[(size_t)i * H + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(sH1[r * H + i], w, acc[r]);
    }
    const float bj = __ldg(&b2[j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sH2[r * H + j] = mish(acc[r] + bj);
  }
  __syncthreads();
  // fc3 + tanh: one warp per (row, action dim)
  for (int p = warp; p < nrows * A; p += THREADS / 32) {
    const int r = p / A, a = p % A;
    float acc = 0.f;
    for (int i = lane; i < H; i += 32)
      acc = fmaf(sH2[r * H + i], __ldg(&w3[(size_t)i * A + a]), acc);
    acc = warp_sum(acc);
    if (lane == 0) out[(size_t)(row0 + r) * A + a] = tanhf(acc + __ldg(&b3[a]));
  }
}

size_t smem_bytes(int D, int H) {
  return sizeof(float) * (size_t)ROWS * ((size_t)D + 2 * (size_t)H);
}

}  // namespace

extern "C" int denoiser_step_smem_bytes(int D, int H) {
  return (int)smem_bytes(D, H);
}

// All pointers are device pointers to contiguous fp32 arrays. Returns
// cudaGetLastError() after the launch.
extern "C" int denoiser_step_launch(const float* inp, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, const float* w3,
                                    const float* b3, float* out, int B, int D,
                                    int H, int A, void* stream) {
  const size_t smem = smem_bytes(D, H);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err =
        cudaFuncSetAttribute(denoiser_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + ROWS - 1) / ROWS), block(THREADS);
  denoiser_step_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      inp, w1, b1, w2, b2, w3, b3, out, B, D, H, A);
  return (int)cudaGetLastError();
}
