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
// plus 1.8 MB of B, C, A, h0 and hT: 203 MB, 60.6 us at 3.35 TB/s. It takes
// S * I * N = 268 M exponentials; at the SFU's 16 per clock per SM (Hopper
// white paper: 4 per SM sub-partition), 132 SMs and the 1.98 GHz boost clock
// that is 64.2 us; its ~6 other fp32 operations per state and step take
// 24 us at 67 TFLOP/s. So the bound is the exponentials, 64 us, with the
// bytes close behind. Each exponential is taken exactly once.
//
// Design: the sequence is split across the threads of a block, not across
// blocks, and combined with the associative operator of the reference's
// chunked scan (`_ssm_comb`, repro/models/blocks.py):
// (a1, b1) o (a2, b2) = (a2 a1, a2 b1 + b2).
//
//   * A block holds CB = 32 channels x P = 8 time segments (256 threads); a
//     warp holds 4 channels x 8 segments, so a channel's segments are 8
//     neighbouring lanes. The block walks S in chunks of L = P x R = 64
//     steps; the thread of segment s owns the run of R = 8 consecutive
//     steps s R .. s R + R - 1 of its channel in each chunk.
//   * Per state n (G = 2 at a time, the N / G groups unrolled so that one
//     group's scan overlaps the next one's fold): a_t = 2^(dt_t A'_n) with
//     A' = A log2 e
//     formed once per block (one FMUL and one MUFU.EX2, `ex2.approx.ftz`),
//     b_t = (dt_t x_t) B_t[n]; the run is folded to its cumulative pairs
//     (prod a, h from 0) in registers; the carry into the chunk is folded
//     into segment 0's pair; an inclusive scan of the channel's 8 pairs by
//     shuffles (3 levels) gives each segment its end state and, one lane
//     up, its start state; the run is swept again from there with the
//     cumulative pairs still in registers (h_t = A_t h_in + B_t, no second
//     exponential, no serial chain), accumulating y_t += C_t[n] h_t. The
//     last segment's end state is the next chunk's carry.
//   * dt, x, B and C tiles of a chunk are staged by cp.async into a
//     two-stage shared-memory ring: the next chunk's copies fly while this
//     one is scanned. dt and x rows are 32 channels wide (coalesced); B and
//     C rows are read in place through their strides (the x_proj splits).
//     Copies are 16 bytes where a tensor's base and strides allow, else 8 or
//     4 (zero-filled past S and I), else, for bf16 on 2-byte alignment,
//     plain loads. Each segment's rows are followed by 16 bytes of padding,
//     so the 8 segments of a warp read 8 different banks.
//   * y goes into the stage's y tile (each thread its own elements) and
//     leaves in coalesced rows during the next chunk's pass, so one barrier
//     per chunk serves the staging, the y tile and the ring; hT is written
//     from the last chunk's carry.
//   * One launch per call, no device scratch; the grid is (I / 32, B), 256
//     blocks at Jamba's shape, two resident per SM (__launch_bounds__(256,
//     2): at most 128 registers; G = 4 spills there), 16 warps per SM.
//
// What holds it above the bound (`tools/ab_decision.py --kernels`,
// PERF.md), on an H100 at Jamba's shape: at N = 4 (the same dt, x and y, a
// quarter of the per-state work) it takes ~0.083 ms, 1.4x the bytes'
// bound; each further state adds ~7.6 us, against 4.0 us of exponentials
// at the SFU rate. So neither the bytes nor the exponentials hold it
// alone: a state's exponential, shuffles, B and C reads and FMAs take
// ~1.9x the SFU time with 16 warps per SM (the register file's limit at
// ~120 registers a thread) to hide their latency. Bulk copies of one row
// per thread (cp.async.bulk on an mbarrier) instead of the cp.async
// pieces were slower.
//
// Ragged edges are masked here, not padded by the caller: channels past I
// and steps past S are staged as zeros, and a zero step is the identity
// (a = 2^0 = 1, b = 0), so the carry passes it unchanged; only rows and
// channels inside (S, I) are stored.
#include "ssm_common.cuh"

namespace {

// states a group of the sweep: the cumulative pairs of GROUP states x R
// steps stay in registers (2 GROUP R of them); the groups are unrolled, so
// one group's scan overlaps the next one's fold
constexpr int GROUP = 2;

// byte sizes of the shared-memory layout (mirrored by `ssm_smem_bytes` in
// kernels/ssm_scan/kernel.py): per stage a dt, an x and a y tile of P
// segments of R rows of CB elements, a B and a C tile of P segments of R
// rows of N elements; two stages; then A' and the carry, CB rows of N + 4
// floats
__host__ __device__ constexpr int stage_bytes(int n, int elt) {
  return P * (3 * x_seg(elt) + 2 * bc_seg(n, elt));
}
__host__ __device__ constexpr int smem_bytes(int n, int elt) {
  return 2 * stage_bytes(n, elt) + 2 * CB * (n + 4) * 4;
}

template <typename T, int N, int G>
__global__ void __launch_bounds__(NT, 2) ssm_scan_kernel(
    const T* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ x, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hT, float* __restrict__ h_chunk,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int S, int I, int u_dt, int u_x, int u_b, int u_c, int u_y) {
  static_assert(N % G == 0 && 32 % P == 0, "groups and segments");
  constexpr int E = sizeof(T);
  constexpr int XS = x_seg(E), BS = bc_seg(N, E), ST = stage_bytes(N, E);
  constexpr int AW = N + 4;     // row stride of A' and the carry, floats
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem + 2 * ST);
  float* s_h = s_a + CB * AW;

  const int tid = threadIdx.x, lane = tid & 31;
  const int seg = lane % P;                       // this thread's segment
  const int cl = (tid / 32) * CPW + lane / P;     // its channel in the block
  const int b = blockIdx.y, c0 = blockIdx.x * CB;
  const int width = I - c0;                       // channels inside I

  for (int i = tid; i < CB * N; i += NT) {
    const int c = i / N, n = i % N;
    const bool live = c < width;
    s_a[c * AW + n] = live ? a[(long long)(c0 + c) * N + n] * LOG2E : 0.f;
    s_h[c * AW + n] = live ? h0[((long long)b * I + c0 + c) * N + n] : 0.f;
  }

  const T* dt_b = dt + b * dt_sb + c0;
  const T* x_b = x + b * x_sb + c0;
  const T* b_b = bm + b * b_sb;
  const T* c_b = cm + b * c_sb;
  auto issue = [&](int k) {   // chunk k's tiles into stage k % 2
    unsigned char* st = smem + (k & 1) * ST;
    const int s0 = k * L;
    load_tile(st, dt_b, dt_ss, s0, S, width, CB * E, XS, u_dt, tid);
    load_tile(st + P * XS, x_b, x_ss, s0, S, width, CB * E, XS, u_x, tid);
    load_tile(st + 2 * P * XS, b_b, b_ss, s0, S, N, N * E, BS, u_b, tid);
    load_tile(st + 2 * P * XS + P * BS, c_b, c_ss, s0, S, N, N * E, BS, u_c,
              tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // chunk k's y rows from the y tile of stage k % 2 to y, coalesced
  T* y_b = y + (long long)b * S * I + c0;
  auto store_y = [&](int k) {
    constexpr int per_row = CB * E / 16;
    const unsigned char* y_t = smem + (k & 1) * ST + 2 * P * XS + 2 * P * BS;
    for (int i = tid; i < L * per_row; i += NT) {
      const int t = i / per_row, o = (i % per_row) * 16, s = k * L + t;
      const int col = o / E;
      if (s >= S || col >= width) continue;
      const unsigned char* src = y_t + (t / R) * XS + (t % R) * CB * E + o;
      T* dst = y_b + (long long)s * I + col;
      if (u_y == 16 && col + 16 / E <= width) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < 16 / E && col + e < width; ++e)
          dst[e] = reinterpret_cast<const T*>(src)[e];
      }
    }
  };

  // One barrier per chunk: after it chunk k is staged, chunk k - 1's y is
  // in its tile, and every thread is done with stage (k + 1) % 2 (chunk
  // k - 1's inputs, and chunk k - 2's y, stored in the pass before).
  const int chunks = (S + L - 1) / L;
  issue(0);
  for (int k = 0; k < chunks; ++k) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (k + 1 < chunks) issue(k + 1);
    unsigned char* st = smem + (k & 1) * ST;
    if (k > 0) store_y(k - 1);   // the previous chunk's y, staged last pass
    const T* dt_s = reinterpret_cast<const T*>(st + seg * XS) + cl;
    const T* x_s = reinterpret_cast<const T*>(st + P * XS + seg * XS) + cl;
    T* y_s = reinterpret_cast<T*>(st + 2 * P * XS + 2 * P * BS + seg * XS)
             + cl;
    const T* b_s = reinterpret_cast<const T*>(st + 2 * P * XS + seg * BS);
    const T* c_s =
        reinterpret_cast<const T*>(st + 2 * P * XS + P * BS + seg * BS);
    const float* a_c = s_a + cl * AW;
    float* h_c = s_h + cl * AW;
    // the state at the chunk's start, for the backward (h_chunk: (B, chunks,
    // I, N) fp32): the channel's lanes read its carry before any of them
    // replaces it (the group loop's __syncwarp below orders the two)
    if (h_chunk != nullptr && cl < width) {
      float* dst = h_chunk + (((long long)b * chunks + k) * I + c0 + cl) * N;
      for (int n = seg; n < N; n += P) dst[n] = h_c[n];
    }

    float dtv[R], dtx[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dtv[r] = to_f32(dt_s[r * CB]);
      dtx[r] = dtv[r] * to_f32(x_s[r * CB]);
      acc[r] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < N; g += G) {
      // fold the run: ca[j][r] = a_0 .. a_r, cb[j][r] = h_r from h = 0
      float ap[G], ca[G][R], cb[G][R];
      load_g<G>(ap, a_c + g);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float bv[G];
        load_g<G>(bv, b_s + r * N + g);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float e = exp2_approx(dtv[r] * ap[j]);
          const float u = dtx[r] * bv[j];
          ca[j][r] = r ? ca[j][r - 1] * e : e;
          cb[j][r] = r ? fmaf(e, cb[j][r - 1], u) : u;
        }
      }
      // the channel's segments: carry into segment 0, inclusive scan
      float hc[G], hin[G], hout[G];
      load_g<G>(hc, h_c + g);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float pa = ca[j][R - 1], pb = cb[j][R - 1];
        if (seg == 0) { pb = fmaf(pa, hc[j], pb); pa = 0.f; }
#pragma unroll
        for (int d = 1; d < P; d *= 2) {
          const float qb = __shfl_up_sync(FULL, pb, d, P);
          if (2 * d < P) {
            const float qa = __shfl_up_sync(FULL, pa, d, P);
            if (seg >= d) { pb = fmaf(pa, qb, pb); pa *= qa; }
          } else if (seg >= d) {
            pb = fmaf(pa, qb, pb);
          }
        }
        const float prev = __shfl_up_sync(FULL, pb, 1, P);
        hin[j] = seg ? prev : hc[j];
        hout[j] = pb;
      }
      __syncwarp();   // every lane has read the carry before it is replaced
      if (seg == P - 1) store_g<G>(h_c + g, hout);
      // sweep the run from its start state
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cv[G];
        load_g<G>(cv, c_s + r * N + g);
#pragma unroll
        for (int j = 0; j < G; ++j)
          acc[r] = fmaf(cv[j], fmaf(ca[j][r], hin[j], cb[j][r]), acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) store_out(&y_s[r * CB], acc[r]);
  }
  __syncthreads();
  store_y(chunks - 1);

  for (int i = tid; i < CB * N; i += NT) {
    const int c = i / N, n = i % N;
    if (c < width) hT[((long long)b * I + c0 + c) * N + n] = s_h[c * AW + n];
  }
}

template <typename T, int N>
int launch_n(const void* dt, const float* a, const void* bm, const void* cm,
             const void* x, const float* h0, void* y, float* hT, float* hc,
             long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
             long long b_sb, long long b_ss, long long c_sb, long long c_ss,
             int B, int S, int I, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  constexpr int smem = smem_bytes(N, E);
  auto kern = ssm_scan_kernel<T, N, (N < GROUP ? N : GROUP)>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int u_dt = unit_of(dt, dt_sb, dt_ss, B, S, E, CB * E);
  const int u_x = unit_of(x, x_sb, x_ss, B, S, E, CB * E);
  const int u_b = unit_of(bm, b_sb, b_ss, B, S, E, N * E);
  const int u_c = unit_of(cm, c_sb, c_ss, B, S, E, N * E);
  const int u_y = unit_of(y, (long long)S * I, I, B, S, E, CB * E);
  const dim3 grid((I + CB - 1) / CB, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(dt), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x), h0,
      static_cast<T*>(y), hT, hc, dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb,
      c_ss, S, I, u_dt, u_x, u_b, u_c, u_y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* dt, const float* a, const void* bm, const void* cm,
             const void* x, const float* h0, void* y, float* hT, float* hc,
             long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
             long long b_sb, long long b_ss, long long c_sb, long long c_ss,
             int B, int S, int I, int N, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch_n<T, 4>(dt, a, bm, cm, x, h0, y, hT, hc, dt_sb, dt_ss, x_sb,
                            x_ss, b_sb, b_ss, c_sb, c_ss, B, S, I, stream);
    case 16:
      return launch_n<T, 16>(dt, a, bm, cm, x, h0, y, hT, hc, dt_sb, dt_ss, x_sb,
                             x_ss, b_sb, b_ss, c_sb, c_ss, B, S, I, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory of one block, bytes, for state size N and dtype (0 = fp32,
// 1 = bf16); -1 for a pair the kernel is not built for.
extern "C" int ssm_scan_smem_bytes(int N, int dtype) {
  if ((N != 4 && N != 16) || (dtype != 0 && dtype != 1)) return -1;
  return smem_bytes(N, dtype == 0 ? 4 : 2);
}

// dt, x: (B, S, I) with batch and sequence strides dt_sb, dt_ss, x_sb, x_ss;
// bm, cm: (B, S, N) likewise; a: contiguous fp32 (I, N); h0, hT: contiguous
// fp32 (B, I, N); y: contiguous (B, S, I). dtype 0 = fp32, 1 = bf16 for dt,
// bm, cm, x and y. N in {4, 16}. `hc`, when not null, receives the fp32
// state at the start of every 64-step chunk, (B, ceil(S / 64), I, N): the
// checkpoints the backward rebuilds the states from; null writes nothing
// more. Launches on `stream`; returns the launch's CUDA error code (0 on
// success).
extern "C" int ssm_scan_launch(
    const void* dt, const void* a, const void* bm, const void* cm,
    const void* x, const void* h0, void* y, void* hT,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int B, int S, int I, int N, int dtype, void* stream, void* hc) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* h0f = static_cast<const float*>(h0);
  auto* hTf = static_cast<float*>(hT);
  auto* hcf = static_cast<float*>(hc);
  if (dtype == 0)
    return launch_t<float>(dt, af, bm, cm, x, h0f, y, hTf, hcf, dt_sb, dt_ss, x_sb,
                           x_ss, b_sb, b_ss, c_sb, c_ss, B, S, I, N, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(dt, af, bm, cm, x, h0f, y, hTf, hcf, dt_sb,
                                   dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss,
                                   B, S, I, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
