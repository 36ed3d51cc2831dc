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
// What bounds it on an H100: bytes. At Jamba's layer (B = 1, S = 2048,
// I = 8192, N = 16, fp32) it reads dt, x, dy, the chunk states and writes
// ddt and dx, 354.9 MB: 0.106 ms at 3.35 TB/s; its 268.4 M exponentials
// take 0.064 ms on the special-function units, and the kernel takes each
// once.
//
// Design: the forward's (ssm_common.cuh), run twice per chunk, the second
// time in reverse. A block holds CB = 32 channels x P = 8 time segments;
// a channel's segments are 8 neighbouring lanes and the thread of segment
// s owns the run of R = 8 steps s R .. s R + R - 1 of each 64-step chunk,
// walking the N states G = 2 at a time in its own registers. The block
// walks the chunks last first; per chunk and state:
//   * rebuild: a_t = 2^(dt_t A'_n) (the forward's `ex2.approx` of the same
//     product, A' = A log2 e), the run folded to its cumulative pairs, the
//     chunk's checkpoint folded into segment 0, a shuffle scan of the
//     channel's 8 pairs, and h_t = A_t h_in + B_t: the forward's own
//     arithmetic, so the rebuilt states are the forward's. The run's a_t
//     stay in registers;
//   * reverse: G_t = a_{t+1} G_{t+1} + dy_t C_t is linear in the G that
//     enters the run from its right, G = P G_in + Q: the run folds to (prod
//     a, Q) from its last step back, the carry from the later chunk (or
//     dhT) is folded into segment 7, a shuffle scan from the right (the
//     reference's `_ssm_comb` taken backwards) gives each segment its G_in,
//     and the run is swept from there with the same a_t. One exponential
//     per state and step in all;
//   * du_t = sum_n G B and the dt term sum_n G h_{t-1} a A are sums inside
//     the thread (no shuffles); dA's per-thread partial stays in shared
//     memory until the end; dB_t and dC_t are summed over the warp's 4
//     channels by a two-level reduce-scatter (12 shuffles a state and run,
//     each lane keeps 4 sums), then over the 8 warps through shared memory
//     in warp order, and leave as one partial per block of 32 channels,
//     (I / 32, B, N, S). A second launch (`ssm_scan_bwd_sum_kernel`) sums
//     those over the blocks and dA's (B, I, N) partials over the batch, in
//     a fixed order: the same inputs give the same bits.
//   * dt, x, dy, B, C and the chunk's checkpoints come through a two-stage
//     cp.async ring, read in place through their strides (the x_proj
//     splits); ddt and dx leave through a tile in coalesced rows during the
//     next chunk. Two barriers a chunk. One block per SM (~200 registers
//     a thread; the cross-warp sums' 64 KB of shared memory at N = 16),
//     the grid (I / 32, B); the state groups run one after the other
//     (unrolled, they spill).
// Steps past S and channels past I are staged as zeros: a zero step is the
// identity (a = 1, u = 0) and passes G unchanged; only rows and channels
// inside (S, I) are stored.
#include "ssm_common.cuh"

namespace {

constexpr int GROUP = 2;          // states a thread walks at once
constexpr int NW = NT / 32;       // warps per block

// byte sizes of the shared-memory layout (mirrored by `bwd_smem_bytes` in
// kernels/ssm_scan/kernel.py): per stage a dt, an x and a dy tile (P
// segments of R rows of CB elements), a B and a C tile (P segments of R
// rows of N elements) and the chunk's checkpoints (CB rows of N + 4
// floats); two stages; the ddt and dx tiles; A', A and the G carry (CB rows
// of N + 4 floats each); dA's per-thread partials (N x NT floats); the
// cross-warp dB and dC sums (NW warps x 2 x N x L floats)
__host__ __device__ constexpr int bwd_stage_bytes(int n, int elt) {
  return P * (3 * x_seg(elt) + 2 * bc_seg(n, elt)) + CB * (n + 4) * 4;
}
__host__ __device__ constexpr int bwd_smem_bytes(int n, int elt) {
  return 2 * bwd_stage_bytes(n, elt) + 2 * P * x_seg(elt) +
         3 * CB * (n + 4) * 4 + n * NT * 4 + NW * 2 * n * L * 4;
}

template <typename T, int N, int G>
__global__ void __launch_bounds__(NT, 1) ssm_scan_bwd_kernel(
    const T* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const T* __restrict__ x, const float* __restrict__ hc,
    const T* __restrict__ dy, const float* __restrict__ dhT,
    T* __restrict__ ddt, T* __restrict__ dx, float* __restrict__ pdb,
    float* __restrict__ pdc, float* __restrict__ pda, float* __restrict__ dh0,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, int B,
    int S, int I, int u_dt, int u_x, int u_dy, int u_b, int u_c, int u_o) {
  static_assert(N % G == 0 && 32 % P == 0 && CPW == 4 && R == 8,
                "groups, segments, and the reduce-scatter's 4 channels x 8 steps");
  constexpr int E = sizeof(T);
  constexpr int XS = x_seg(E), BS = bc_seg(N, E), ST = bwd_stage_bytes(N, E);
  constexpr int AW = N + 4;     // row stride of A', A, the carries, floats
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* outs = smem + 2 * ST;                 // ddt tile, dx tile
  float* s_a = reinterpret_cast<float*>(outs + 2 * P * XS);
  float* s_af = s_a + CB * AW;
  float* s_g = s_af + CB * AW;
  float* s_da = s_g + CB * AW;                         // [n][thread]
  float* red = s_da + N * NT;                          // [warp][q][n][t]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int seg = lane % P;                       // this thread's segment
  const int cl = w * CPW + lane / P;              // its channel in the block
  const int b = blockIdx.y, c0 = blockIdx.x * CB;
  const int width = I - c0;                       // channels inside I
  const int chunks = (S + L - 1) / L;

  for (int i = tid; i < CB * N; i += NT) {
    const int c = i / N, n = i % N;
    const bool live = c < width;
    const float av = live ? a[(long long)(c0 + c) * N + n] : 0.f;
    s_a[c * AW + n] = av * LOG2E;
    s_af[c * AW + n] = av;
    s_g[c * AW + n] = live ? dhT[((long long)b * I + c0 + c) * N + n] : 0.f;
  }
  for (int i = tid; i < N * NT; i += NT) s_da[i] = 0.f;

  const T* dt_b = dt + b * dt_sb + c0;
  const T* x_b = x + b * x_sb + c0;
  const T* dy_b = dy + (long long)b * S * I + c0;
  const T* b_b = bm + b * b_sb;
  const T* c_b = cm + b * c_sb;
  auto issue = [&](int k, int stage) {   // chunk k's tiles into `stage`
    unsigned char* st = smem + stage * ST;
    const int s0 = k * L;
    load_tile(st, dt_b, dt_ss, s0, S, width, CB * E, XS, u_dt, tid);
    load_tile(st + P * XS, x_b, x_ss, s0, S, width, CB * E, XS, u_x, tid);
    load_tile(st + 2 * P * XS, dy_b, (long long)I, s0, S, width, CB * E, XS,
              u_dy, tid);
    load_tile(st + 3 * P * XS, b_b, b_ss, s0, S, N, N * E, BS, u_b, tid);
    load_tile(st + 3 * P * XS + P * BS, c_b, c_ss, s0, S, N, N * E, BS, u_c,
              tid);
    // the checkpoints: CB rows of N floats, contiguous in hc
    float* hs = reinterpret_cast<float*>(st + 3 * P * XS + 2 * P * BS);
    const float* src = hc + (((long long)b * chunks + k) * I + c0) * N;
    for (int i = tid; i < CB * N / 4; i += NT) {
      const int c = i / (N / 4), o = (i % (N / 4)) * 4;
      const bool live = c < width;
      copy_unit(hs + c * AW + o, src + (live ? c * N + o : 0), 16,
                live ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // chunk k's ddt and dx rows from their tiles to device memory, coalesced
  T* ddt_b = ddt + (long long)b * S * I + c0;
  T* dx_b = dx + (long long)b * S * I + c0;
  auto store_rows = [&](int k) {
    constexpr int per_row = CB * E / 16;
    for (int i = tid; i < 2 * L * per_row; i += NT) {
      const int which = i / (L * per_row), j = i % (L * per_row);
      const int t = j / per_row, o = (j % per_row) * 16, s = k * L + t;
      const int col = o / E;
      if (s >= S || col >= width) continue;
      const unsigned char* src = outs + which * P * XS + (t / R) * XS +
                                 (t % R) * CB * E + o;
      T* dst = (which ? dx_b : ddt_b) + (long long)s * I + col;
      if (u_o == 16 && col + 16 / E <= width) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < 16 / E && col + e < width; ++e)
          dst[e] = reinterpret_cast<const T*>(src)[e];
      }
    }
  };

  // Two barriers a chunk: after the first, chunk k is staged, chunk k + 1's
  // ddt and dx are in their tiles and every thread is done with the other
  // stage and with the cross-warp sums; after the second, the sums of this
  // chunk are complete and chunk k + 1's rows have left the tiles.
  const int b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;   // lane's channel bits
  issue(chunks - 1, 0);
  for (int j = 0; j < chunks; ++j) {
    const int k = chunks - 1 - j;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (j + 1 < chunks) issue(k - 1, (j + 1) & 1);
    if (j > 0) store_rows(k + 1);
    const unsigned char* st = smem + (j & 1) * ST;
    const T* dt_s = reinterpret_cast<const T*>(st + seg * XS) + cl;
    const T* x_s = reinterpret_cast<const T*>(st + P * XS + seg * XS) + cl;
    const T* dy_s = reinterpret_cast<const T*>(st + 2 * P * XS + seg * XS) + cl;
    const T* b_s = reinterpret_cast<const T*>(st + 3 * P * XS + seg * BS);
    const T* c_s =
        reinterpret_cast<const T*>(st + 3 * P * XS + P * BS + seg * BS);
    const float* hcs = reinterpret_cast<const float*>(
        st + 3 * P * XS + 2 * P * BS) + cl * AW;
    const float* a_c = s_a + cl * AW;
    const float* af_c = s_af + cl * AW;
    float* g_c = s_g + cl * AW;

    float dtv[R], dtx[R], xv[R], dyv[R], du[R], dtt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dtv[r] = to_f32(dt_s[r * CB]);
      xv[r] = to_f32(x_s[r * CB]);
      dtx[r] = dtv[r] * xv[r];
      dyv[r] = to_f32(dy_s[r * CB]);
      du[r] = dtt[r] = 0.f;
    }
    // the state groups one after the other (unrolling them overflows the
    // registers; the groups' own loops unroll)
#pragma unroll 1
    for (int g = 0; g < N; g += G) {
      // rebuild: ea[j][r] = a_r; ca[j][r] = a_0 .. a_r; cb[j][r] = h_r from
      // h = 0 (the forward's fold)
      float ap[G], ea[G][R], ca[G][R], cb[G][R];
      load_g<G>(ap, a_c + g);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float bv[G];
        load_g<G>(bv, b_s + r * N + g);
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const float e = exp2_approx(dtv[r] * ap[jj]);
          const float u = dtx[r] * bv[jj];
          ea[jj][r] = e;
          ca[jj][r] = r ? ca[jj][r - 1] * e : e;
          cb[jj][r] = r ? fmaf(e, cb[jj][r - 1], u) : u;
        }
      }
      // the channel's segments: the checkpoint into segment 0, inclusive
      // scan (the forward's), then h_r = A_r h_in + B_r in place of cb
      float hck[G], hin[G];
      load_g<G>(hck, hcs + g);
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        float pa = ca[jj][R - 1], pb = cb[jj][R - 1];
        if (seg == 0) { pb = fmaf(pa, hck[jj], pb); pa = 0.f; }
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
        hin[jj] = seg ? prev : hck[jj];
#pragma unroll
        for (int r = 0; r < R; ++r)
          cb[jj][r] = fmaf(ca[jj][r], hin[jj], cb[jj][r]);
      }
      // reverse: the run as G_in -> (prod a) G_in + Q, where Q folds
      // c_r = dy_r C_r from the last step back; the carry from the right
      // into segment 7; a scan from the right gives each segment its G_in
      float gc[G], gin[G], gout[G];
      load_g<G>(gc, g_c + g);
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        float cv[G];
        load_g<G>(cv, c_s + (R - 1) * N + g);
        float q = dyv[R - 1] * cv[jj];
#pragma unroll
        for (int i = 1; i < R; ++i) {     // steps R - 2 .. 0
          const int r = R - 1 - i;
          load_g<G>(cv, c_s + r * N + g);
          q = fmaf(ea[jj][r + 1], q, dyv[r] * cv[jj]);
        }
        float pa = ca[jj][R - 1], pb = ea[jj][0] * q;
        if (seg == P - 1) { pb = fmaf(pa, gc[jj], pb); pa = 0.f; }
#pragma unroll
        for (int d = 1; d < P; d *= 2) {
          const float qb = __shfl_down_sync(FULL, pb, d, P);
          if (2 * d < P) {
            const float qa = __shfl_down_sync(FULL, pa, d, P);
            if (seg + d < P) { pb = fmaf(pa, qb, pb); pa *= qa; }
          } else if (seg + d < P) {
            pb = fmaf(pa, qb, pb);
          }
        }
        const float next = __shfl_down_sync(FULL, pb, 1, P);
        gin[jj] = seg == P - 1 ? gc[jj] : next;
        gout[jj] = pb;
      }
      __syncwarp();   // every lane has read the carry before it is replaced
      if (seg == 0) store_g<G>(g_c + g, gout);
      // sweep the run from its G_in, last step first
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        float gv = gin[jj], da = 0.f, vb[R], vc[R];
        const float afj = af_c[g + jj];
#pragma unroll
        for (int i = 0; i < R; ++i) {     // steps R - 1 .. 0
          const int r = R - 1 - i;
          float bv[G], cv[G];
          load_g<G>(bv, b_s + r * N + g);
          load_g<G>(cv, c_s + r * N + g);
          gv = fmaf(dyv[r], cv[jj], gv);                  // G_r
          const float hp = r ? cb[jj][r - 1] : hin[jj];   // h_{r-1}
          const float gda = gv * hp * ea[jj][r];          // dL/d(dt A)
          da = fmaf(gda, dtv[r], da);
          du[r] = fmaf(gv, bv[jj], du[r]);
          dtt[r] = fmaf(gda, afj, dtt[r]);
          vb[r] = gv * dtx[r];
          vc[r] = dyv[r] * cb[jj][r];
          gv *= ea[jj][r];                                // a_r G_r
        }
        s_da[(g + jj) * NT + tid] += da;
        // dB, dC over the warp's 4 channels (lanes 8 and 16 apart): the
        // lane keeps dB (b4 = 0) or dC (b4 = 1) of steps 4 b3 .. 4 b3 + 3
        float k1[R];
#pragma unroll
        for (int m = 0; m < R; ++m)
          k1[m] = (b4 ? vc[m] : vb[m]) +
                  __shfl_xor_sync(FULL, b4 ? vb[m] : vc[m], 16);
        float k2[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          k2[m] = (b3 ? k1[4 + m] : k1[m]) +
                  __shfl_xor_sync(FULL, b3 ? k1[m] : k1[4 + m], 8);
        *reinterpret_cast<float4*>(
            red + ((w * 2 + b4) * N + g + jj) * L + seg * R + 4 * b3) =
            make_float4(k2[0], k2[1], k2[2], k2[3]);
      }
    }
    __syncthreads();
    // ddt and dx of this chunk into their tiles (the rows of chunk k + 1
    // have left them before the barrier)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T* o0 = reinterpret_cast<T*>(outs + seg * XS + r * CB * E) + cl;
      T* o1 = reinterpret_cast<T*>(outs + P * XS + seg * XS + r * CB * E) + cl;
      store_out(o0, fmaf(du[r], xv[r], dtt[r]));
      store_out(o1, du[r] * dtv[r]);
    }
    // dB and dC of this chunk: the 8 warps' sums in warp order, one
    // partial of the block, (I / 32, B, N, S)
    for (int i = tid; i < 2 * N * L; i += NT) {
      const int q = i / (N * L), n = (i / L) % N, t = i % L, s = k * L + t;
      if (s >= S) continue;
      float v = 0.f;
#pragma unroll
      for (int ww = 0; ww < NW; ++ww) v += red[((ww * 2 + q) * N + n) * L + t];
      (q ? pdc : pdb)[(((long long)blockIdx.x * B + b) * N + n) * S + s] = v;
    }
  }
  __syncthreads();
  store_rows(0);
  for (int i = tid; i < CB * N; i += NT) {
    const int c = i / N, n = i % N;
    if (c >= width) continue;
    // dA over the channel's 8 segments in order (the thread of segment s
    // of channel c is (c / CPW) 32 + (c % CPW) P + s)
    const float* d = s_da + n * NT + (c / CPW) * 32 + (c % CPW) * P;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < P; ++s) v += d[s];
    const long long at = ((long long)b * I + c0 + c) * N + n;
    pda[at] = v;
    dh0[at] = s_g[c * AW + n];
  }
}

// dbm, dcm (B, S, N) in the inputs' dtype from the blocks' partials (I /
// 32, B, N, S), summed over the blocks in order; da (I, N) fp32 from the
// batch rows' partials (B, I, N), summed in order
template <typename T>
__global__ void __launch_bounds__(256) ssm_scan_bwd_sum_kernel(
    const float* __restrict__ pdb, const float* __restrict__ pdc,
    const float* __restrict__ pda, T* __restrict__ dbm, T* __restrict__ dcm,
    float* __restrict__ da, int blocks, int B, int S, int I, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bns = (long long)B * N * S;
  if (i < bns) {              // i = (b, n, s), s fastest: coalesced reads
    float vb = 0.f, vc = 0.f;
    for (int k = 0; k < blocks; ++k) {
      vb += pdb[k * bns + i];
      vc += pdc[k * bns + i];
    }
    const long long bb = i / ((long long)N * S), n = (i / S) % N, s = i % S;
    const long long at = (bb * S + s) * N + n;
    store_out(dbm + at, vb);
    store_out(dcm + at, vc);
  } else if (i < bns + (long long)I * N) {
    const long long j = i - bns;
    float v = 0.f;
    for (int bb = 0; bb < B; ++bb) v += pda[(long long)bb * I * N + j];
    da[j] = v;
  }
}

template <typename T, int N>
int launch_n(const void* dt, const float* a, const void* bm, const void* cm,
             const void* x, const float* hc, const void* dy,
             const float* dhT, void* ddt, void* dx, void* dbm, void* dcm,
             float* da, float* pdb, float* pdc, float* pda, float* dh0,
             const long long* st, int B, int S, int I, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  constexpr int smem = bwd_smem_bytes(N, E);
  auto kern = ssm_scan_bwd_kernel<T, N, (N < GROUP ? N : GROUP)>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int u_dt = unit_of(dt, st[0], st[1], B, S, E, CB * E);
  const int u_x = unit_of(x, st[2], st[3], B, S, E, CB * E);
  const int u_dy = unit_of(dy, (long long)S * I, I, B, S, E, CB * E);
  const int u_b = unit_of(bm, st[4], st[5], B, S, E, N * E);
  const int u_c = unit_of(cm, st[6], st[7], B, S, E, N * E);
  const int u_o = unit_of(ddt, (long long)S * I, I, B, S, E, CB * E);
  const int blocks = (I + CB - 1) / CB;
  kern<<<dim3(blocks, B), NT, smem, stream>>>(
      static_cast<const T*>(dt), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x), hc,
      static_cast<const T*>(dy), dhT, static_cast<T*>(ddt),
      static_cast<T*>(dx), pdb, pdc, pda, dh0, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], B, S, I, u_dt, u_x, u_dy, u_b, u_c, u_o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = (long long)B * N * S + (long long)I * N;
  ssm_scan_bwd_sum_kernel<T><<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      pdb, pdc, pda, static_cast<T*>(dbm), static_cast<T*>(dcm), da, blocks, B,
      S, I, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int N, const void* dt, const float* a, const void* bm,
             const void* cm, const void* x, const float* hc, const void* dy,
             const float* dhT, void* ddt, void* dx, void* dbm, void* dcm,
             float* da, float* pdb, float* pdc, float* pda, float* dh0,
             const long long* st, int B, int S, int I, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch_n<T, 4>(dt, a, bm, cm, x, hc, dy, dhT, ddt, dx, dbm, dcm,
                            da, pdb, pdc, pda, dh0, st, B, S, I, s);
    case 16:
      return launch_n<T, 16>(dt, a, bm, cm, x, hc, dy, dhT, ddt, dx, dbm, dcm,
                             da, pdb, pdc, pda, dh0, st, B, S, I, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory of one block of the main kernel, bytes, for state size N
// and dtype (0 = fp32, 1 = bf16); -1 for a pair it is not built for.
extern "C" int ssm_scan_bwd_smem_bytes(int N, int dtype) {
  if ((N != 4 && N != 16) || (dtype != 0 && dtype != 1)) return -1;
  return bwd_smem_bytes(N, dtype == 0 ? 4 : 2);
}

// dt, x: (B, S, I) and bm, cm: (B, S, N) with batch and sequence strides
// (unit last stride); a: contiguous fp32 (I, N); hc: the forward's chunk
// states, contiguous fp32 (B, ceil(S / 64), I, N); dy: contiguous (B, S, I)
// in the inputs' dtype; dhT: contiguous fp32 (B, I, N). Writes ddt and dx
// (B, S, I) and dbm and dcm (B, S, N), contiguous in the inputs' dtype,
// and da (I, N) and dh0 (B, I, N) fp32, through the fp32 scratch pdb and
// pdc (ceil(I / 32), B, N, S) and pda (B, I, N). dtype 0 = fp32, 1 = bf16.
// Two launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int ssm_scan_bwd_launch(
    const void* dt, const void* a, const void* bm, const void* cm,
    const void* x, const void* hc, const void* dy, const void* dhT,
    void* ddt, void* dx, void* dbm, void* dcm, void* da, void* dh0,
    void* pdb, void* pdc, void* pda,
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
    return launch_t<float>(N, dt, af, bm, cm, x, hcf, dy, dhf, ddt, dx, dbm,
                           dcm, f(da), f(pdb), f(pdc), f(pda), f(dh0), st, B,
                           S, I, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(N, dt, af, bm, cm, x, hcf, dy, dhf, ddt,
                                   dx, dbm, dcm, f(da), f(pdb), f(pdc),
                                   f(pda), f(dh0), st, B, S, I, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
