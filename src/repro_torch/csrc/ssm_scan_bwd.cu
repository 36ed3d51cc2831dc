// Mamba selective scan backward for Hopper (sm_90a), fp32 and bf16 inputs,
// fp32 state and arithmetic.
//
// The gradient of csrc/ssm_scan.cu's function (the counterpart of autodiff
// through the reference's `repro/models/blocks.py::_mamba_scan_chunked`,
// whose 64-step chunks are `jax.checkpoint`-ed): with
//
//   a_t = exp(dt_t A),  u_t = dt_t x_t,  h_t = a_t h_{t-1} + u_t B_t,
//   y_t = C_t . h_t
//
// and G_t = dL/dh_t = dy_t C_t + a_{t+1} G_{t+1} (G past the last step is
// dhT, the gradient of the final state), it returns
//
//   dC_t = sum_i dy_t h_t          dB_t = sum_i G_t u_t
//   du_t = sum_n G_t B_t           ddt_t = du_t x_t + sum_n G_t h_{t-1} a_t A
//   dx_t = du_t dt_t               dA = sum_{b,t} G_t h_{t-1} a_t dt_t
//   dh0 = a_0 G_0
//
// from the forward's states at the start of each 64-step chunk (`hc`, the
// forward kernel's optional output, (B, chunks, I, N)); no (B, S, I, N)
// tensor is made.
//
// Design (a first, simple version). A block holds CB = 256 / N channels,
// one thread per (channel, state), a channel's N states in N neighbouring
// lanes; the grid is (I / CB, B). The block walks the chunks last first.
// Per chunk it stages dt, x, dy, B and C as fp32 in shared memory; each
// thread rebuilds its 64 states h_t from the chunk's checkpoint in
// registers, with the forward's own exponential (`ex2.approx` of
// dt * (A log2 e), the same product the forward forms), then runs the
// reverse recurrence, taking the exponential again. Per step the sums over
// n (du, the dt term) are shuffles among the channel's lanes; the sums over
// channels (dB, dC) are shuffles among the warp's channels and then a fixed-
// order sum over the block's 8 warps through shared memory, written as one
// partial per block: (I / CB, B, S, N). The wrapper sums the partials over
// that block axis (`torch.sum`, kernels/ssm_scan/kernel.py::ssm_scan_bwd),
// and dA's per-batch-row partials (B, I, N) likewise, so the result is
// deterministic. Steps past S and channels past I are staged as zeros: a
// zero step is the identity (a = 1, u = 0) and passes G unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int L = 64;            // steps per chunk (the forward's)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared memory in floats: dt, x, dy, ddt and dx tiles of L x CB, B and C
// tiles of L x N, and the cross-warp partials of dC and dB, L x NW x N x 2
__host__ __device__ constexpr int smem_floats(int n) {
  return 5 * L * (NT / n) + 2 * L * n + 2 * L * NW * n;
}

template <typename T, int N>
__global__ void __launch_bounds__(NT) ssm_scan_bwd_kernel(
    const T* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ x, const float* __restrict__ hc,
    const T* __restrict__ dy, const float* __restrict__ dhT,
    T* __restrict__ ddt, T* __restrict__ dx, float* __restrict__ pdb,
    float* __restrict__ pdc, float* __restrict__ pda, float* __restrict__ dh0,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, int B,
    int S, int I) {
  constexpr int CB = NT / N;
  extern __shared__ __align__(16) float sm[];
  float* dt_s = sm;
  float* x_s = dt_s + L * CB;
  float* dy_s = x_s + L * CB;
  float* ddt_s = dy_s + L * CB;
  float* dx_s = ddt_s + L * CB;
  float* b_s = dx_s + L * CB;
  float* c_s = b_s + L * N;
  float* red = c_s + L * N;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = tid / N, n = tid % N;
  const int b = blockIdx.y, c0 = blockIdx.x * CB, ch = c0 + c;
  const bool live = ch < I;
  const long long state = ((long long)b * I + ch) * N + n;
  const float af = live ? a[(long long)ch * N + n] : 0.f;
  const float ap = af * LOG2E;     // the forward's A' = A log2 e
  float G = live ? dhT[state] : 0.f;
  float da_acc = 0.f;
  const int chunks = (S + L - 1) / L;

  for (int k = chunks - 1; k >= 0; --k) {
    __syncthreads();   // the previous chunk's outputs have left the tiles
    for (int i = tid; i < L * CB; i += NT) {
      const int t = i / CB, cc = i % CB, s = k * L + t;
      const bool ok = s < S && c0 + cc < I;
      dt_s[i] = ok ? to_f32(dt[b * dt_sb + s * dt_ss + c0 + cc]) : 0.f;
      x_s[i] = ok ? to_f32(x[b * x_sb + s * x_ss + c0 + cc]) : 0.f;
      dy_s[i] = ok ? to_f32(dy[((long long)b * S + s) * I + c0 + cc]) : 0.f;
    }
    for (int i = tid; i < L * N; i += NT) {
      const int t = i / N, nn = i % N, s = k * L + t;
      b_s[i] = s < S ? to_f32(bm[b * b_sb + s * b_ss + nn]) : 0.f;
      c_s[i] = s < S ? to_f32(cm[b * c_sb + s * c_ss + nn]) : 0.f;
    }
    __syncthreads();

    // rebuild the chunk's states from its checkpoint
    const float h_in = live ? hc[(((long long)b * chunks + k) * I + ch) * N + n]
                            : 0.f;
    float hs[L];
    float h = h_in;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const float dtv = dt_s[t * CB + c];
      const float e = exp2_approx(dtv * ap);
      h = fmaf(e, h, dtv * x_s[t * CB + c] * b_s[t * N + n]);
      hs[t] = h;
    }
    // the reverse recurrence
#pragma unroll
    for (int t = L - 1; t >= 0; --t) {
      const float dtv = dt_s[t * CB + c], xv = x_s[t * CB + c];
      const float dyv = dy_s[t * CB + c];
      const float e = exp2_approx(dtv * ap);
      G = fmaf(dyv, c_s[t * N + n], G);                 // G_t
      const float hp = t ? hs[t - 1] : h_in;
      const float gda = G * hp * e;                     // dL/d(dt A)
      da_acc = fmaf(gda, dtv, da_acc);
      float du = G * b_s[t * N + n];
      float ddt_a = gda * af;
      float dcv = dyv * hs[t];
      float dbv = G * (dtv * xv);
      G *= e;                                           // a_t G_t
#pragma unroll
      for (int off = 1; off < N; off *= 2) {            // over the states
        du += __shfl_xor_sync(FULL, du, off);
        ddt_a += __shfl_xor_sync(FULL, ddt_a, off);
      }
#pragma unroll
      for (int off = N; off < 32; off *= 2) {           // over the channels
        dcv += __shfl_xor_sync(FULL, dcv, off);
        dbv += __shfl_xor_sync(FULL, dbv, off);
      }
      if (n == 0) {
        ddt_s[t * CB + c] = fmaf(du, xv, ddt_a);
        dx_s[t * CB + c] = du * dtv;
      }
      if (lane < N) {
        float* r = red + ((t * NW + w) * N + n) * 2;
        r[0] = dcv;
        r[1] = dbv;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * CB; i += NT) {
      const int t = i / CB, cc = i % CB, s = k * L + t;
      if (s >= S || c0 + cc >= I) continue;
      const long long at = ((long long)b * S + s) * I + c0 + cc;
      store_out(ddt + at, ddt_s[i]);
      store_out(dx + at, dx_s[i]);
    }
    for (int i = tid; i < L * N; i += NT) {
      const int t = i / N, nn = i % N, s = k * L + t;
      if (s >= S) continue;
      float sc = 0.f, sb = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) {
        sc += red[((t * NW + ww) * N + nn) * 2];
        sb += red[((t * NW + ww) * N + nn) * 2 + 1];
      }
      const long long at =
          (((long long)blockIdx.x * B + b) * S + s) * N + nn;
      pdc[at] = sc;
      pdb[at] = sb;
    }
  }
  if (live) {
    dh0[state] = G;
    pda[state] = da_acc;
  }
}

template <typename T, int N>
int launch_n(const void* dt, const float* a, const void* bm, const void* cm,
             const void* x, const float* hc, const void* dy,
             const float* dhT, void* ddt, void* dx, float* pdb, float* pdc,
             float* pda, float* dh0, const long long* st, int B, int S, int I,
             cudaStream_t stream) {
  constexpr int smem = smem_floats(N) * 4;
  auto kern = ssm_scan_bwd_kernel<T, N>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((I + NT / N - 1) / (NT / N), B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(dt), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x), hc,
      static_cast<const T*>(dy), dhT, static_cast<T*>(ddt),
      static_cast<T*>(dx), pdb, pdc, pda, dh0, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], B, S, I);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int N, const void* dt, const float* a, const void* bm,
             const void* cm, const void* x, const float* hc, const void* dy,
             const float* dhT, void* ddt, void* dx, float* pdb, float* pdc,
             float* pda, float* dh0, const long long* st, int B, int S, int I,
             cudaStream_t s) {
  switch (N) {
    case 4:
      return launch_n<T, 4>(dt, a, bm, cm, x, hc, dy, dhT, ddt, dx, pdb, pdc,
                            pda, dh0, st, B, S, I, s);
    case 16:
      return launch_n<T, 16>(dt, a, bm, cm, x, hc, dy, dhT, ddt, dx, pdb, pdc,
                             pda, dh0, st, B, S, I, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory of one block, bytes, for state size N; -1 for an N the
// kernel is not built for.
extern "C" int ssm_scan_bwd_smem_bytes(int N) {
  return N == 4 || N == 16 ? smem_floats(N) * 4 : -1;
}

// dt, x: (B, S, I) and bm, cm: (B, S, N) with batch and sequence strides
// (unit last stride); a: contiguous fp32 (I, N); hc: the forward's chunk
// states, contiguous fp32 (B, ceil(S / 64), I, N); dy: contiguous (B, S, I)
// in the inputs' dtype; dhT: contiguous fp32 (B, I, N). Writes ddt and dx
// (B, S, I) contiguous in the inputs' dtype, the partials pdb and pdc
// (ceil(I / (256 / N)), B, S, N) and pda (B, I, N), and dh0 (B, I, N), all
// fp32. dtype 0 = fp32, 1 = bf16. Launches on `stream`; returns the
// launch's CUDA error code (0 on success).
extern "C" int ssm_scan_bwd_launch(
    const void* dt, const void* a, const void* bm, const void* cm,
    const void* x, const void* hc, const void* dy, const void* dhT,
    void* ddt, void* dx, void* pdb, void* pdc, void* pda, void* dh0,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, int B,
    int S, int I, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || I <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* hcf = static_cast<const float*>(hc);
  const auto* dhf = static_cast<const float*>(dhT);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_t<float>(N, dt, af, bm, cm, x, hcf, dy, dhf, ddt, dx,
                           f(pdb), f(pdc), f(pda), f(dh0), st, B, S, I, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(N, dt, af, bm, cm, x, hcf, dy, dhf, ddt,
                                   dx, f(pdb), f(pdc), f(pda), f(dh0), st, B,
                                   S, I, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
