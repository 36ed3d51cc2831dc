// Mamba selective scan for Hopper (sm_90a), fp32 and bf16 inputs, fp32 state.
//
// Replaces the TPU kernel `repro/kernels/ssm_scan/kernel.py::ssm_scan`
// (`_ssm_kernel`). For each batch row b and channel i, over t = 0..S-1:
//
//   h_t[n] = exp(dt_t[i] * A[i, n]) * h_{t-1}[n] + (dt_t[i] * x_t[i]) * B_t[n]
//   y_t[i] = sum_n C_t[n] * h_t[n]
//
// from h_{-1} = h0[b, i], returning y (B, S, I) in the inputs' dtype and the
// final state hT (B, I, N) in fp32. A, h0 and the state are fp32 whatever the
// inputs' dtype (the Mamba block forms A = -exp(A_log) in fp32), and
// dt_t * x_t is formed in fp32, as the TPU kernel forms it.
//
// What bounds it on an H100. At the Jamba prefill shape (B = 1, S = 2048,
// I = 8192, N = 16, fp32) the function reads dt and x and writes y, 3 x 64 MB,
// plus 1.8 MB of B, C, A, h0 and hT: 203 MB, 60.5 us at 3.35 TB/s. It takes
// S * I * N = 268 M exponentials; at the SFU's 16 per clock per SM (Hopper
// white paper: 4 per SM sub-partition), 132 SMs and the 1.98 GHz boost clock
// that is 64.2 us; its ~6 other fp32 operations per state and step take
// 24 us at 67 TFLOP/s. So the bound is the exponentials, 64 us, with the
// bytes close behind.
//
// The TPU kernel carries the (block_i, N) state in VMEM across a sequential
// grid axis over S. Blocks on the H100 run in parallel and in no order, so
// here each block walks the whole sequence in a loop for its channels, with
// the state in registers:
//
//   * one block per (64 channels, batch row); a channel's N states lie across
//     N / 4 neighbouring lanes, 4 states per lane (16 N threads a block), so
//     Jamba's B * I * N = 131,072 states are 1,024 warps, not 256; y_t is the
//     sum of each lane's 4 products and N / 4 - 1 xor-shuffles;
//   * the scan's loop-carried dependency is one FMA per state; the
//     exponential and the input term of a step do not depend on h, so a
//     lane's 4 states and the warps of an SM overlap them;
//   * a tile of TS timesteps of dt and x (64 channels wide, coalesced rows),
//     and of B_t and C_t (N floats, shared by every channel of the row), is
//     staged in shared memory as fp32; the next tile's loads are issued into
//     registers before the current tile is scanned, so their latency hides
//     behind it; y_t goes to a shared tile and out in coalesced rows;
//   * the exponential is `expf` (full fp32 accuracy, no fast-math).
//
// Ragged edges are masked here, not padded by the caller: channels at or past
// I scan zeros and store nothing, and the last tile runs only the steps left.
// dt, x, B and C are read through batch and sequence strides (unit stride
// along the last axis), so the x_proj splits B and C are read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CB = 64;  // channels per block
constexpr int TS = 32;  // timesteps per shared-memory tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(16 * N) ssm_scan_kernel(
    const T* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ x, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hT,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int S, int I) {
  constexpr int LPC = N / 4;              // lanes per channel
  constexpr int NT = CB * LPC;            // threads per block
  constexpr int PER_X = TS * CB / NT;     // dt / x elements a thread stages
  constexpr int PER_BC = TS * N / NT;     // B / C elements a thread stages
  static_assert(N % 4 == 0 && 32 % LPC == 0, "N / 4 lanes must divide a warp");
  static_assert(TS * CB % NT == 0 && TS * N % NT == 0, "tile split");

  __shared__ float s_dt[TS][CB];
  __shared__ float s_x[TS][CB];
  __shared__ float s_y[TS][CB];
  __shared__ __align__(16) float s_b[TS][N];
  __shared__ __align__(16) float s_c[TS][N];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CB;
  const int cl = tid / LPC;               // this lane's channel in the block
  const int q = tid % LPC;                // its quarter of the N states
  const int ch = c0 + cl;
  const bool live = ch < I;

  const T* dt_b = dt + (long long)b * dt_sb + c0;
  const T* x_b = x + (long long)b * x_sb + c0;
  const T* b_b = bm + (long long)b * b_sb;
  const T* c_b = cm + (long long)b * c_sb;

  float av[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long k = (long long)ch * N + 4 * q + j;
    av[j] = live ? a[k] : 0.f;
    h[j] = live ? h0[(long long)b * I * N + k] : 0.f;
  }

  float r_dt[PER_X], r_x[PER_X], r_b[PER_BC], r_c[PER_BC];
  // the tile from timestep s0 into registers; zeros past S and past I
  auto load_tile = [&](int s0) {
#pragma unroll
    for (int k = 0; k < PER_X; ++k) {
      const int e = tid + k * NT, t = e / CB, c = e % CB, s = s0 + t;
      const bool ok = s < S && c0 + c < I;
      r_dt[k] = ok ? to_f32(dt_b[(long long)s * dt_ss + c]) : 0.f;
      r_x[k] = ok ? to_f32(x_b[(long long)s * x_ss + c]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < PER_BC; ++k) {
      const int e = tid + k * NT, t = e / N, n = e % N, s = s0 + t;
      r_b[k] = s < S ? to_f32(b_b[(long long)s * b_ss + n]) : 0.f;
      r_c[k] = s < S ? to_f32(c_b[(long long)s * c_ss + n]) : 0.f;
    }
  };
  auto stage_tile = [&]() {
#pragma unroll
    for (int k = 0; k < PER_X; ++k) {
      const int e = tid + k * NT;
      s_dt[e / CB][e % CB] = r_dt[k];
      s_x[e / CB][e % CB] = r_x[k];
    }
#pragma unroll
    for (int k = 0; k < PER_BC; ++k) {
      const int e = tid + k * NT;
      s_b[e / N][e % N] = r_b[k];
      s_c[e / N][e % N] = r_c[k];
    }
  };

  load_tile(0);
  stage_tile();
  __syncthreads();
  for (int s0 = 0; s0 < S; s0 += TS) {
    const int steps = min(TS, S - s0);
    if (s0 + TS < S) load_tile(s0 + TS);  // in flight during the scan below
    for (int t = 0; t < steps; ++t) {
      const float dtv = s_dt[t][cl];
      const float dtx = dtv * s_x[t][cl];
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[t][4 * q]);
      const float4 cv = *reinterpret_cast<const float4*>(&s_c[t][4 * q]);
      h[0] = expf(dtv * av[0]) * h[0] + dtx * bv.x;
      h[1] = expf(dtv * av[1]) * h[1] + dtx * bv.y;
      h[2] = expf(dtv * av[2]) * h[2] + dtx * bv.z;
      h[3] = expf(dtv * av[3]) * h[3] + dtx * bv.w;
      float p = h[0] * cv.x + h[1] * cv.y + h[2] * cv.z + h[3] * cv.w;
#pragma unroll
      for (int off = LPC / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (q == 0) s_y[t][cl] = p;
    }
    __syncthreads();  // the tile is scanned: s_y is full, s_dt .. s_c free
    for (int e = tid; e < TS * CB; e += NT) {
      const int t = e / CB, c = e % CB;
      if (t < steps && c0 + c < I)
        store_out(&y[((long long)b * S + s0 + t) * I + c0 + c], s_y[t][c]);
    }
    if (s0 + TS < S) stage_tile();
    __syncthreads();
  }
  if (live) {
    float4* out = reinterpret_cast<float4*>(
        &hT[((long long)b * I + ch) * N + 4 * q]);
    *out = make_float4(h[0], h[1], h[2], h[3]);
  }
}

template <typename T>
int launch_t(const void* dt, const float* a, const void* bm, const void* cm,
             const void* x, const float* h0, void* y, float* hT,
             long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
             long long b_sb, long long b_ss, long long c_sb, long long c_ss,
             int B, int S, int I, int N, cudaStream_t stream) {
  const dim3 grid((I + CB - 1) / CB, B);
#define SSM_LAUNCH(NN)                                                      \
  ssm_scan_kernel<T, NN><<<grid, 16 * NN, 0, stream>>>(                     \
      static_cast<const T*>(dt), a,                                         \
      static_cast<const T*>(bm), static_cast<const T*>(cm),                 \
      static_cast<const T*>(x), h0, static_cast<T*>(y), hT, dt_sb, dt_ss,   \
      x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, S, I)
  switch (N) {
    case 4: SSM_LAUNCH(4); break;
    case 16: SSM_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, x: (B, S, I) with batch and sequence strides dt_sb, dt_ss, x_sb, x_ss;
// bm, cm: (B, S, N) likewise; a: contiguous fp32 (I, N); h0, hT: contiguous
// fp32 (B, I, N); y: contiguous (B, S, I). dtype 0 = fp32, 1 = bf16 for dt,
// bm, cm, x and y. N in {4, 16}. Launches on `stream`; returns the
// launch's CUDA error code (0 on success).
extern "C" int ssm_scan_launch(
    const void* dt, const void* a, const void* bm, const void* cm,
    const void* x, const void* h0, void* y, void* hT,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int B, int S, int I, int N, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* h0f = static_cast<const float*>(h0);
  auto* hTf = static_cast<float*>(hT);
  if (dtype == 0)
    return launch_t<float>(dt, af, bm, cm, x, h0f, y, hTf, dt_sb, dt_ss, x_sb,
                           x_ss, b_sb, b_ss, c_sb, c_ss, B, S, I, N, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(dt, af, bm, cm, x, h0f, y, hTf, dt_sb,
                                   dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss,
                                   B, S, I, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
