// Fused env decision step for B parallel envs: one warp per env.
//
// Replaces the Pallas kernel `repro/kernels/env_step/kernel.py`
// (`_env_step_kernel`, launched by `env_step_pallas`). One launch advances
// every env by one scheduling decision: lazy retirement, first-match slot
// pick, complete-gang reuse, fragmentation-aware fresh pick by counting
// rank, steps / exec / init / quality, the masked state update, the Eq.-4a
// reward, the next-event clock, the next visible queue by counting rank and
// the Eq.-6 observation. With FAULTS the down mask, cold wipe, straggler
// factor and in-flight crash (status 3) are added; the fault-free build is a
// separate instantiation, so it runs exactly the fault-free program.
//
// Bound: an env holds a few KB (E servers, K tasks), so the whole batch
// moves well under a MB per decision (0.18 us at 3.35 TB/s for B = 256,
// E = 8, K = 32); what a warp waits for is the latency of its round trips
// to L2, and the launch. So:
//
//   * one round of loads: before any value is used, each warp issues every
//     load its env needs (the server rows, the whole task rows with the
//     statics c, model, noise, step_base, init_base, scale and arr over all
//     K, the queue, the action and the fault windows) as read-only loads of
//     one element a lane (a row is one coalesced request, whatever its
//     alignment), all before the first result is stored into the warp's
//     slice of shared memory; the gathers at the chosen task and the next
//     queue's reads of c and model are then shared-memory reads. (A
//     cp.async copy of each row into shared memory, 16 bytes where a row
//     allows and 4 where not, was slower on an H100.)
//   * no reads back from device memory: the new task status and finish
//     stay in shared memory for the done flag and the next queue, and each
//     output is written once;
//   * the slot pick is one integer max over keys that order like the
//     scores, integer sums and minima are `__reduce_*_sync`;
//   * when E, K, l and A are at most 32 (the ONE instantiation: every
//     paper cell) a lane holds one element of every row, so the
//     lane-strided loops are single passes and the gang counts are a match
//     and two ballots (counting ranks stay loops over shared memory: ranks
//     by 32 shuffles of registers were slower); wider envs take the
//     general instantiation, whose lanes stride over servers and tasks.
//     At paper-8srv, B = 256 on an H100 the general build takes ~28 % more
//     device time than ONE (`tools/ab_decision.py --kernels`, which builds
//     it with -DENV_STEP_GENERAL_ONLY);
//   * two envs per block, so 256 envs spread over 128 SMs; no block-wide
//     barrier; `__launch_bounds__(64, 1)` lets ptxas keep its ~128
//     registers (without the minimum it spilled).
// What is left at paper-8srv is a chain of short dependent steps, each a
// shared-memory read or a warp reduction, and the launch itself: one env
// alone on the card (B = 2, one block) takes ~94 % of the time of 256
// (`tools/ab_decision.py --kernels`).
//
// Exactness: the clock and every integer and boolean must equal the plain
// PyTorch version. Products and sums are written as __fmul_rn / __fadd_rn
// in the reference's order (and the file is compiled with -fmad=false), the
// step count rounds half to even (__float2int_rn), divisions are IEEE (no
// fast math). Only the reward's sum over K is taken in another order (the
// xor butterfly of `warp_sumf`).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

// Mirrored field for field by `_Cfg` in kernels/env_step/kernel.py.
struct EnvStepCfg {
  int E, K, L, F, A, num_models, max_steps, s_min, s_max;
  float time_limit, alpha_q, beta_t, mu_t, k_time, lambda_q, p_quality,
      q_min, inv_ts, inv_nm;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;  // the reference's INF sentinel
constexpr int WARPS = 2;      // envs per block

enum {
  I_TIME, I_FREE, I_SMODEL, I_SGANG, I_SGSIZE, I_TSTATUS, I_TSTART,
  I_TFINISH, I_TSTEPS, I_TQUAL, I_TRELOAD, I_STAKEN, I_ARR, I_C, I_MODEL,
  I_NOISE, I_STEPB, I_INITB, I_SCALE, I_ACTION, I_QIDX, I_QVALID, I_QQUEUED,
  I_FDS, I_FDE, I_FSLOW, I_FCOLD,
  O_TIME, O_FREE, O_SMODEL, O_SGANG, O_SGSIZE, O_TSTATUS, O_TSTART,
  O_TFINISH, O_TSTEPS, O_TQUAL, O_TRELOAD, O_STAKEN, O_QIDX, O_QVALID,
  O_QQUEUED, O_OBS, O_REWARD, O_DONE, N_PTRS
};

struct Ptrs {
  void* p[N_PTRS];
};

// Regions of a warp's slice of shared memory, each starting on 16 bytes:
// the staged inputs (time, steps taken and the cold flag share the first
// 16 bytes), then the work arrays. Mirrored by `env_smem_bytes` in
// kernels/env_step/kernel.py, region for region.
enum {
  R_SCALARS, R_FREE, R_SMODEL, R_SGANG, R_SGSIZE, R_TSTATUS, R_TSTART,
  R_TFINISH, R_TSTEPS, R_TQUAL, R_TRELOAD, R_ARR, R_C, R_MODEL, R_NOISE,
  R_STEPB, R_INITB, R_SCALE, R_ACTION, R_QIDX, R_QVALID, R_QQUEUED, R_FDS,
  R_FDE, R_FSLOW, R_IDLE, R_OK, R_MOK, R_SEL, R_SCORE, R_PRIO, N_REGIONS
};

struct Layout {
  int off[N_REGIONS];
  int bytes;  // one warp's slice
};

Layout make_layout(const EnvStepCfg& c, bool faults) {
  const int E = c.E, K = c.K, ef = faults ? E * c.F : 0;
  const int size[N_REGIONS] = {
      16, 4 * E, 4 * E, 4 * E, 4 * E,                           // servers
      4 * K, 4 * K, 4 * K, 4 * K, 4 * K, 4 * K,                 // task state
      4 * K, 4 * K, 4 * K, 4 * K, 4 * K, 4 * K, 4 * K,          // statics
      4 * c.A, 4 * c.L, c.L, K,                                 // action, queue
      4 * ef, 4 * ef, faults ? 4 * E : 0,                       // faults
      4 * E, 4 * E, 4 * E, 4 * E, 4 * E, 4 * K};                // work
  Layout lay;
  int at = 0;
  for (int r = 0; r < N_REGIONS; ++r) {
    lay.off[r] = at;
    at += (size[r] + 15) & ~15;
  }
  lay.bytes = at;
  return lay;
}

__device__ __forceinline__ float warp_sumf(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_minf(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_maxf(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Lane-strided over [0, n); when ONE (every row of the env fits a warp,
// n <= 32) the compiler sees one pass at most, with no loop around it.
#define LANES(v, n) \
  for (int v = lane, v##_end = ONE ? min((n), lane + 1) : (n); v < v##_end; \
       v += 32)

// ONE: E, K, l and A are at most 32, so one warp covers every row of an
// env: the lane-strided loops are single passes, the gang counts are a
// match and two ballots.
template <bool FAULTS, bool ONE>
__global__ void __launch_bounds__(WARPS * 32, 1)
env_step_kernel(Ptrs P, EnvStepCfg c, Layout lay, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int E = c.E, K = c.K, L = c.L, F = c.F, A = c.A;
  unsigned char* base = smem + warp * lay.bytes;
  auto at = [&](int r) { return base + lay.off[r]; };

  // --- one round of loads ------------------------------------------------
  // Element i = 32 w + lane of every row, for each window w of 32 (one
  // window when E, K, A, l and E F are at most 32): all loads are issued
  // (read-only, 4 bytes or 1 a lane, so a row is one coalesced request)
  // before the first is stored to shared memory.
  {
    const int rows = max(max(K, E * (FAULTS ? F : 1)), max(A, L));
#pragma unroll 1   // one window's loads in flight at a time
    for (int i = lane; i < rows + (32 - rows % 32) % 32; i += 32) {
      constexpr int NV = 22;
      unsigned v[NV];
      unsigned char q0 = 0, q1 = 0;
      auto ld = [&](int slot, int n) -> unsigned {
        return i < n ? __ldg(static_cast<const unsigned*>(P.p[slot])
                             + (size_t)b * n + i) : 0u;
      };
      auto ld1 = [&](int slot, int n) -> unsigned char {
        return i < n ? __ldg(static_cast<const unsigned char*>(P.p[slot])
                             + (size_t)b * n + i) : (unsigned char)0;
      };
      v[0] = ld(I_FREE, E); v[1] = ld(I_SMODEL, E);
      v[2] = ld(I_SGANG, E); v[3] = ld(I_SGSIZE, E);
      v[4] = ld(I_TSTATUS, K); v[5] = ld(I_TSTART, K);
      v[6] = ld(I_TFINISH, K); v[7] = ld(I_TSTEPS, K);
      v[8] = ld(I_TQUAL, K); v[9] = ld(I_TRELOAD, K);
      v[10] = ld(I_ARR, K); v[11] = ld(I_C, K); v[12] = ld(I_MODEL, K);
      v[13] = ld(I_NOISE, K); v[14] = ld(I_STEPB, K);
      v[15] = ld(I_INITB, K); v[16] = ld(I_SCALE, K);
      v[17] = ld(I_ACTION, A); v[18] = ld(I_QIDX, L);
      q0 = ld1(I_QVALID, L); q1 = ld1(I_QQUEUED, K);
      if (FAULTS) {
        v[19] = ld(I_FDS, E * F); v[20] = ld(I_FDE, E * F);
        v[21] = ld(I_FSLOW, E);
      }
      unsigned t0 = 0, t1 = 0, t2 = 0;
      if (i == 0) {
        t0 = __ldg(static_cast<const unsigned*>(P.p[I_TIME]) + b);
        t1 = __ldg(static_cast<const unsigned*>(P.p[I_STAKEN]) + b);
        if (FAULTS) t2 = __ldg(static_cast<const unsigned*>(P.p[I_FCOLD]) + b);
      }
      auto st = [&](int r, int n, unsigned val) {
        if (i < n) reinterpret_cast<unsigned*>(at(r))[i] = val;
      };
      st(R_FREE, E, v[0]); st(R_SMODEL, E, v[1]); st(R_SGANG, E, v[2]);
      st(R_SGSIZE, E, v[3]);
      st(R_TSTATUS, K, v[4]); st(R_TSTART, K, v[5]); st(R_TFINISH, K, v[6]);
      st(R_TSTEPS, K, v[7]); st(R_TQUAL, K, v[8]); st(R_TRELOAD, K, v[9]);
      st(R_ARR, K, v[10]); st(R_C, K, v[11]); st(R_MODEL, K, v[12]);
      st(R_NOISE, K, v[13]); st(R_STEPB, K, v[14]); st(R_INITB, K, v[15]);
      st(R_SCALE, K, v[16]); st(R_ACTION, A, v[17]); st(R_QIDX, L, v[18]);
      if (i < L) at(R_QVALID)[i] = q0;
      if (i < K) at(R_QQUEUED)[i] = q1;
      if (FAULTS) {
        st(R_FDS, E * F, v[19]); st(R_FDE, E * F, v[20]);
        st(R_FSLOW, E, v[21]);
      }
      if (i == 0) {
        auto* sc = reinterpret_cast<unsigned*>(at(R_SCALARS));
        sc[0] = t0; sc[1] = t1; sc[2] = t2;
      }
    }
    __syncwarp();
  }

  const float t = reinterpret_cast<const float*>(at(R_SCALARS))[0];
  const int staken = reinterpret_cast<const int*>(at(R_SCALARS))[1] + 1;
  const float fcold = reinterpret_cast<const float*>(at(R_SCALARS))[2];
  float* s_free = reinterpret_cast<float*>(at(R_FREE));
  int* s_model = reinterpret_cast<int*>(at(R_SMODEL));
  int* s_gang = reinterpret_cast<int*>(at(R_SGANG));
  int* s_gsize = reinterpret_cast<int*>(at(R_SGSIZE));
  int* s_tstatus = reinterpret_cast<int*>(at(R_TSTATUS));
  const float* s_tstart = reinterpret_cast<const float*>(at(R_TSTART));
  float* s_tfinish = reinterpret_cast<float*>(at(R_TFINISH));
  const int* s_tsteps = reinterpret_cast<const int*>(at(R_TSTEPS));
  const float* s_tqual = reinterpret_cast<const float*>(at(R_TQUAL));
  const int* s_treload = reinterpret_cast<const int*>(at(R_TRELOAD));
  const float* arr = reinterpret_cast<const float*>(at(R_ARR));
  const int* s_c = reinterpret_cast<const int*>(at(R_C));
  const int* s_tmodel = reinterpret_cast<const int*>(at(R_MODEL));
  const float* s_noise = reinterpret_cast<const float*>(at(R_NOISE));
  const float* s_stepb = reinterpret_cast<const float*>(at(R_STEPB));
  const float* s_initb = reinterpret_cast<const float*>(at(R_INITB));
  const float* s_scale = reinterpret_cast<const float*>(at(R_SCALE));
  const float* act = reinterpret_cast<const float*>(at(R_ACTION));
  const int* qidx = reinterpret_cast<const int*>(at(R_QIDX));
  const bool* qvalid = reinterpret_cast<const bool*>(at(R_QVALID));
  const bool* queued = reinterpret_cast<const bool*>(at(R_QQUEUED));
  const float* fds = reinterpret_cast<const float*>(at(R_FDS));
  const float* fde = reinterpret_cast<const float*>(at(R_FDE));
  const float* s_fslow = reinterpret_cast<const float*>(at(R_FSLOW));
  int* s_idle = reinterpret_cast<int*>(at(R_IDLE));
  int* s_ok = reinterpret_cast<int*>(at(R_OK));
  int* s_mok = reinterpret_cast<int*>(at(R_MOK));
  int* s_sel = reinterpret_cast<int*>(at(R_SEL));
  float* s_score = reinterpret_cast<float*>(at(R_SCORE));
  float* s_prio = reinterpret_cast<float*>(at(R_PRIO));
  const size_t bE = (size_t)b * E, bK = (size_t)b * K, bL = (size_t)b * L;

  // --- servers: cold wipe, idle mask -------------------------------------
  LANES(e, E) {
    bool down = false;
    if (FAULTS) {
      bool started = false;
      for (int f = 0; f < F; ++f) {
        const float s = fds[e * F + f], en = fde[e * F + f];
        down |= (s <= t) && (t < en);
        started |= (s <= t);
      }
      if (started && fcold > 0.f) {
        s_model[e] = -1; s_gang[e] = -1; s_gsize[e] = 0;
      }
    }
    s_idle[e] = (s_free[e] <= t) && !down;
  }

  // --- slot pick: first-match argmax over the preference scores ----------
  // A NaN score counts as the largest (jnp.argmax). Each score becomes an
  // int whose order is the floats' (-0 as +0, so equal scores tie; NaN
  // above everything); the slot is the first index holding the largest.
  // Either way slot < L.
  int key = INT_MIN, first = L;
  LANES(j, L) {
    const float s = __fadd_rn(qvalid[j] ? act[2 + j] : -BIG, 0.f);
    const int bits = __float_as_int(s);
    const int kj = isnan(s) ? INT_MAX : bits >= 0 ? bits : bits ^ INT_MAX;
    if (kj > key) { key = kj; first = j; }
  }
  const int best = __reduce_max_sync(FULL, key);
  const int slot = __reduce_min_sync(FULL, key == best ? first : L);
  const int k = min(max(qidx[slot], 0), K - 1);
  const bool k_valid = qvalid[slot];

  const bool want_exec = act[0] <= 0.5f;
  const int c_k = s_c[k];
  const int m_k = s_tmodel[k];
  const float scale_k = s_scale[k];
  __syncwarp();
  int n_idle = 0;
  LANES(e, E) {
    const bool idle = s_idle[e], has_gang = s_gang[e] >= 0;
    n_idle += idle;
    s_ok[e] = idle && has_gang && s_model[e] == m_k && s_gsize[e] == c_k;
    s_mok[e] = idle && has_gang;
  }
  n_idle = __reduce_add_sync(FULL, n_idle);
  const bool feasible = want_exec && k_valid && (n_idle >= c_k);
  __syncwarp();

  // --- server selection: reuse detection + counting-rank fresh pick ------
  bool any_complete = false;
  int g_min = 1 << 30;
  unsigned same_g = 0, ok_m = 0, mok_m = 0;   // ONE: lanes by gang, masks
  if (ONE) {
    const bool live = lane < E;
    same_g = __match_any_sync(FULL, live ? s_gang[lane] : INT_MIN);
    ok_m = __ballot_sync(FULL, live && s_ok[lane]);
    mok_m = __ballot_sync(FULL, live && s_mok[lane]);
  }
  LANES(e, E) {
    const int g = s_gang[e];
    int cnt = 0, cnt_all = 0;
    if (ONE) {
      cnt = __popc(same_g & ok_m);
      cnt_all = __popc(same_g & mok_m);
    } else {
#pragma unroll 8
      for (int j = 0; j < E; ++j) {
        const bool same = s_gang[j] == g;
        cnt += same && s_ok[j];
        cnt_all += same && s_mok[j];
      }
    }
    if (s_ok[e] && cnt == c_k) {
      any_complete = true;
      g_min = min(g_min, g);
    }
    const int gs = s_gsize[e];
    const bool intact = s_mok[e] && cnt_all == gs && gs > 0;
    s_score[e] = s_idle[e]
        ? __fadd_rn(__fmul_rn(intact ? 1.f : 0.f,
                              __fadd_rn(100.f, __fmul_rn(10.f, (float)gs))),
                    __fmul_rn(0.001f, (float)e))
        : BIG;
  }
  const bool reuse = __any_sync(FULL, any_complete);
  const int g_star = __reduce_min_sync(FULL, g_min);
  __syncwarp();
  LANES(e, E) {
    int rank = 0;
    const float se = s_score[e];
#pragma unroll 8
    for (int j = 0; j < E; ++j) rank += s_score[j] < se;
    s_sel[e] = reuse ? (s_ok[e] && s_gang[e] == g_star)
                     : (s_idle[e] && rank < c_k);
  }
  __syncwarp();

  // --- timing / quality of the candidate decision ------------------------
  // a NaN step knob stays NaN through the clip and converts to 0 steps
  // (cvt.rni: round half to even, NaN -> 0), as in the reference
  const float a1 = isnan(act[1]) ? act[1] : fminf(fmaxf(act[1], 0.f), 1.f);
  const int steps = __float2int_rn(__fadd_rn(
      (float)c.s_min, __fmul_rn(a1, (float)(c.s_max - c.s_min))));
  const float steps_f = (float)steps;
  float t_exec = __fmul_rn(__fmul_rn(s_stepb[k], steps_f), scale_k);
  if (FAULTS) {  // gang speed = slowest member's speed
    float slow = -CUDART_INF_F;
    LANES(e, E)
      slow = fmaxf(slow, s_sel[e] ? s_fslow[e] : 1.f);
    t_exec = __fmul_rn(t_exec, warp_maxf(slow));
  }
  const float t_init = reuse ? 0.f : __fmul_rn(s_initb[k], scale_k);
  const float finish = __fadd_rn(__fadd_rn(t, t_exec), t_init);
  const float q_k = __fadd_rn(
      __fmul_rn(0.285f, __fsub_rn(1.f, expf(__fmul_rn(-steps_f, 0.1f)))),
      s_noise[k]);
  const float pen = q_k < c.q_min ? c.p_quality : 0.f;
  const float t_resp = __fsub_rn(finish, arr[k]);

  int sched_status = 1;
  float rec_finish = finish;
  bool will_fail = false;
  if (FAULTS) {  // in-flight crash of a selected server before the finish
    float crash_t = BIG;
    LANES(e, E) {
      if (!s_sel[e]) continue;
      for (int f = 0; f < F; ++f) {
        const float s = fds[e * F + f];
        if (s > t && s < finish) crash_t = fminf(crash_t, s);
      }
    }
    crash_t = warp_minf(crash_t);
    will_fail = crash_t < BIG;
    sched_status = will_fail ? 3 : 1;
    rec_finish = will_fail ? crash_t : finish;
  }

  // --- apply schedule to the servers (masked) ----------------------------
  const bool fz = feasible;
  float next_completion = BIG;
  LANES(e, E) {
    const bool sel_f = s_sel[e] && fz;
    const float nf = sel_f ? rec_finish : s_free[e];
    const int nm = sel_f ? m_k : s_model[e];
    static_cast<float*>(P.p[O_FREE])[bE + e] = nf;
    static_cast<int*>(P.p[O_SMODEL])[bE + e] = nm;
    static_cast<int*>(P.p[O_SGANG])[bE + e] = sel_f ? k : s_gang[e];
    static_cast<int*>(P.p[O_SGSIZE])[bE + e] = sel_f ? c_k : s_gsize[e];
    s_free[e] = nf;
    s_model[e] = nm;
    if (nf > t) next_completion = fminf(next_completion, nf);
  }

  // --- tasks: retire, apply, reward terms, next arrival ------------------
  int n_still = 0;
  float wait_sum = 0.f, next_arrival = BIG;
  LANES(kk, K) {
    const int s0 = s_tstatus[kk];
    const float tf = s_tfinish[kk];
    const int s = (s0 == 1 && tf <= t) ? 2 : s0;
    const bool hit = kk == k && fz;
    const int s2 = hit ? sched_status : s;
    const float tf2 = hit ? rec_finish : tf;
    static_cast<int*>(P.p[O_TSTATUS])[bK + kk] = s2;
    static_cast<float*>(P.p[O_TSTART])[bK + kk] = hit ? t : s_tstart[kk];
    static_cast<float*>(P.p[O_TFINISH])[bK + kk] = tf2;
    static_cast<int*>(P.p[O_TSTEPS])[bK + kk] = hit ? steps : s_tsteps[kk];
    static_cast<float*>(P.p[O_TQUAL])[bK + kk] = hit ? q_k : s_tqual[kk];
    static_cast<int*>(P.p[O_TRELOAD])[bK + kk] =
        hit ? (reuse ? 0 : 1) : s_treload[kk];
    s_tstatus[kk] = s2;     // kept for the done flag and the next queue
    s_tfinish[kk] = tf2;
    const float a = arr[kk];
    if (queued[kk] && kk != k) {
      ++n_still;
      wait_sum = __fadd_rn(wait_sum, __fsub_rn(t, a));
    }
    if (a > t) next_arrival = fminf(next_arrival, a);
  }
  n_still = __reduce_add_sync(FULL, n_still);
  wait_sum = warp_sumf(wait_sum);
  const float t_avg = wait_sum / fmaxf((float)n_still, 1.f);
  const float denom = __fadd_rn(
      __fadd_rn(__fmul_rn(c.beta_t, t_resp), __fmul_rn(c.mu_t, t_avg)), 1e-3f);
  const float r = __fadd_rn(
      __fsub_rn(__fmul_rn(c.alpha_q, q_k), __fmul_rn(c.lambda_q, pen)),
      c.k_time / denom);
  const float reward = (fz && !will_fail) ? r : 0.f;

  // --- advance time on a no-op --------------------------------------------
  float next_event = fminf(warp_minf(next_arrival), warp_minf(next_completion));
  if (FAULTS) {  // recoveries are events too
    float rec = BIG;
    LANES(e, E)
      for (int f = 0; f < F; ++f) {
        const float s = fds[e * F + f], en = fde[e * F + f];
        if (s <= t && en > t) rec = fminf(rec, en);
      }
    next_event = fminf(next_event, warp_minf(rec));
  }
  const float t_new =
      fz ? t : (next_event < BIG ? next_event : __fadd_rn(t, 1.f));

  // --- done flag and the next queue's priorities --------------------------
  bool all_resolved = true;
  int n_queued = 0;
  LANES(kk, K) {
    const int s2 = s_tstatus[kk];
    const float tf2 = s_tfinish[kk];
    all_resolved &= s2 == 2 || (s2 == 1 && tf2 <= t_new) || (FAULTS && s2 == 3);
    const bool q2 = s2 == 0 && arr[kk] <= t_new;
    static_cast<bool*>(P.p[O_QQUEUED])[bK + kk] = q2;
    n_queued += q2;
    s_prio[kk] = q2 ? arr[kk] : BIG;
  }
  all_resolved = __all_sync(FULL, all_resolved);
  n_queued = __reduce_add_sync(FULL, n_queued);
  __syncwarp();

  // --- next visible queue by counting rank (ties: lower index first) ------
  const int W = E + L;
  float* obs = static_cast<float*>(P.p[O_OBS]) + (size_t)b * 3 * W;
  LANES(kk, K) {
    const float p = s_prio[kk];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < K; ++j)
      rank += s_prio[j] < p || (s_prio[j] == p && j < kk);
    if (rank < L) {
      const bool v = rank < n_queued;
      static_cast<int*>(P.p[O_QIDX])[bL + rank] = kk;
      static_cast<bool*>(P.p[O_QVALID])[bL + rank] = v;
      obs[E + rank] = v ? __fmul_rn(__fsub_rn(t_new, arr[kk]), c.inv_ts) : 0.f;
      obs[W + E + rank] = v ? (float)s_c[kk] / 8.f : 0.f;
      obs[2 * W + E + rank] =
          (v && c.num_models > 1)
              ? __fmul_rn(__fadd_rn((float)s_tmodel[kk], 1.f), c.inv_nm)
              : 0.f;
    }
  }

  // --- Eq.-6 observation of the servers -----------------------------------
  LANES(e, E) {
    const float nf = s_free[e];
    bool up = nf <= t_new;
    if (FAULTS)
      for (int f = 0; f < F; ++f) {
        const float s = fds[e * F + f], en = fde[e * F + f];
        up &= !((s <= t_new) && (t_new < en));
      }
    obs[e] = up ? 1.f : 0.f;
    obs[W + e] = __fmul_rn(fmaxf(__fsub_rn(nf, t_new), 0.f), c.inv_ts);
    obs[2 * W + e] = __fmul_rn(__fadd_rn((float)s_model[e], 1.f), c.inv_nm);
  }

  if (lane == 0) {
    static_cast<float*>(P.p[O_TIME])[b] = t_new;
    static_cast<int*>(P.p[O_STAKEN])[b] = staken;
    static_cast<float*>(P.p[O_REWARD])[b] = reward;
    static_cast<bool*>(P.p[O_DONE])[b] =
        all_resolved || t_new >= c.time_limit || staken >= c.max_steps;
  }
}

}  // namespace

// Shared memory of one block, bytes (WARPS slices), for `cfg` with or
// without faults.
extern "C" int env_step_smem_bytes(const EnvStepCfg* cfg, int faults) {
  return WARPS * make_layout(*cfg, faults != 0).bytes;
}

// ptrs: N_PTRS device pointers in the enum's order (the fault inputs may be
// null when faults == 0). Returns cudaGetLastError() after the launch.
extern "C" int env_step_launch(const EnvStepCfg* cfg, void* const* ptrs,
                               int B, int faults, void* stream) {
  Ptrs P;
  for (int i = 0; i < N_PTRS; ++i) P.p[i] = ptrs[i];
  const Layout lay = make_layout(*cfg, faults != 0);
  const size_t smem = (size_t)WARPS * lay.bytes;
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef ENV_STEP_GENERAL_ONLY   // the A/B tool's build without ONE
  const bool one = false;
#else
  const bool one = cfg->E <= 32 && cfg->K <= 32 && cfg->L <= 32 &&
                   cfg->A <= 32;
#endif
  auto kern = faults ? (one ? env_step_kernel<true, true>
                            : env_step_kernel<true, false>)
                     : (one ? env_step_kernel<false, true>
                            : env_step_kernel<false, false>);
  if (smem > 48 * 1024) {  // past the default, opt in (the plan caps it)
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, block, smem, s>>>(P, *cfg, lay, B);
  return (int)cudaGetLastError();
}

extern "C" int env_step_ptr_count() { return N_PTRS; }
