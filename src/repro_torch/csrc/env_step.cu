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
// Bound: launch latency. An env holds a few KB (E servers, K tasks), so the
// whole batch moves well under a MB per decision. The design keeps every
// env inside one warp: lanes stride over servers and tasks (so E, K > 32
// loop), cross-lane sums, mins and counting ranks are warp shuffles or
// reads of the warp's own slice of shared memory, and no block-wide
// barrier is needed.
//
// Exactness: the clock and every integer and boolean must equal the plain
// PyTorch version. Products and sums are written as __fmul_rn / __fadd_rn
// in the reference's order (and the file is compiled with -fmad=false), the
// step count rounds half to even (__float2int_rn), divisions are IEEE (no
// fast math). Only the reward's sum over K is taken in another order.
#include <cuda_runtime.h>
#include <math_constants.h>

// Mirrored field for field by `_Cfg` in kernels/env_step/kernel.py.
struct EnvStepCfg {
  int E, K, L, F, A, num_models, max_steps, s_min, s_max;
  float time_limit, alpha_q, beta_t, mu_t, k_time, lambda_q, p_quality,
      q_min, inv_ts, inv_nm;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;  // the reference's INF sentinel
constexpr int WARPS = 4;      // envs per block

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

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
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
__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T* ptr(const Ptrs& P, int i) {
  return static_cast<T*>(P.p[i]);
}

template <bool FAULTS>
__global__ void __launch_bounds__(WARPS * 32)
env_step_kernel(Ptrs P, EnvStepCfg c, int B) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int E = c.E, K = c.K, L = c.L, F = c.F, A = c.A;

  // this warp's slice of shared memory: 7 int and 2 float arrays of E,
  // one float array of K
  int* s_gang = smem + warp * (9 * E + K);
  int* s_model = s_gang + E;
  int* s_gsize = s_model + E;
  int* s_idle = s_gsize + E;
  int* s_ok = s_idle + E;
  int* s_mok = s_ok + E;
  int* s_sel = s_mok + E;
  float* s_score = reinterpret_cast<float*>(s_sel + E);
  float* s_free = s_score + E;
  float* s_prio = s_free + E;

  const size_t bE = (size_t)b * E, bK = (size_t)b * K, bL = (size_t)b * L;
  const float t = ptr<const float>(P, I_TIME)[b];
  const float* fds = FAULTS ? ptr<const float>(P, I_FDS) : nullptr;
  const float* fde = FAULTS ? ptr<const float>(P, I_FDE) : nullptr;

  // --- servers: load, cold wipe, idle mask -------------------------------
  for (int e = lane; e < E; e += 32) {
    int g = ptr<const int>(P, I_SGANG)[bE + e];
    int m = ptr<const int>(P, I_SMODEL)[bE + e];
    int gs = ptr<const int>(P, I_SGSIZE)[bE + e];
    const float fr = ptr<const float>(P, I_FREE)[bE + e];
    bool down = false;
    if (FAULTS) {
      bool started = false;
      for (int f = 0; f < F; ++f) {
        const float s = fds[(bE + e) * F + f], en = fde[(bE + e) * F + f];
        down |= (s <= t) && (t < en);
        started |= (s <= t);
      }
      if (started && ptr<const float>(P, I_FCOLD)[b] > 0.f) {
        m = -1; g = -1; gs = 0;
      }
    }
    s_gang[e] = g; s_model[e] = m; s_gsize[e] = gs; s_free[e] = fr;
    s_idle[e] = (fr <= t) && !down;
  }

  // --- slot pick: first-match argmax over the preference scores ----------
  // A NaN score counts as the largest (jnp.argmax); fmaxf skips NaN, so the
  // first NaN is tracked apart. Either way slot < L.
  const float* act = ptr<const float>(P, I_ACTION) + (size_t)b * A;
  const int* qidx = ptr<const int>(P, I_QIDX) + bL;
  const bool* qvalid = ptr<const bool>(P, I_QVALID) + bL;
  float best = -CUDART_INF_F;
  int nan_slot = L;
  for (int j = lane; j < L; j += 32) {
    const float s = qvalid[j] ? act[2 + j] : -BIG;
    if (isnan(s)) nan_slot = min(nan_slot, j);
    best = fmaxf(best, s);
  }
  best = warp_maxf(best);
  nan_slot = warp_min(nan_slot);
  int slot = L;
  for (int j = lane; j < L; j += 32)
    if ((qvalid[j] ? act[2 + j] : -BIG) == best) slot = min(slot, j);
  slot = warp_min(slot);
  if (nan_slot < L) slot = nan_slot;
  const int k = min(max(qidx[slot], 0), K - 1);
  const bool k_valid = qvalid[slot];

  const bool want_exec = act[0] <= 0.5f;
  const int c_k = ptr<const int>(P, I_C)[bK + k];
  const int m_k = ptr<const int>(P, I_MODEL)[bK + k];
  const float scale_k = ptr<const float>(P, I_SCALE)[bK + k];
  __syncwarp();
  int n_idle = 0;
  for (int e = lane; e < E; e += 32) {
    const bool idle = s_idle[e], has_gang = s_gang[e] >= 0;
    n_idle += idle;
    s_ok[e] = idle && has_gang && s_model[e] == m_k && s_gsize[e] == c_k;
    s_mok[e] = idle && has_gang;
  }
  n_idle = warp_sum(n_idle);
  const bool feasible = want_exec && k_valid && (n_idle >= c_k);
  __syncwarp();

  // --- server selection: reuse detection + counting-rank fresh pick ------
  bool any_complete = false;
  int g_min = 1 << 30;
  for (int e = lane; e < E; e += 32) {
    const int g = s_gang[e];
    int cnt = 0, cnt_all = 0;
    for (int j = 0; j < E; ++j) {
      const bool same = s_gang[j] == g;
      cnt += same && s_ok[j];
      cnt_all += same && s_mok[j];
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
  const int g_star = warp_min(g_min);
  __syncwarp();
  for (int e = lane; e < E; e += 32) {
    int rank = 0;
    const float se = s_score[e];
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
  float t_exec = __fmul_rn(
      __fmul_rn(ptr<const float>(P, I_STEPB)[bK + k], steps_f), scale_k);
  if (FAULTS) {  // gang speed = slowest member's speed
    float slow = -CUDART_INF_F;
    for (int e = lane; e < E; e += 32)
      slow = fmaxf(slow, s_sel[e] ? ptr<const float>(P, I_FSLOW)[bE + e] : 1.f);
    t_exec = __fmul_rn(t_exec, warp_maxf(slow));
  }
  const float t_init =
      reuse ? 0.f : __fmul_rn(ptr<const float>(P, I_INITB)[bK + k], scale_k);
  const float finish = __fadd_rn(__fadd_rn(t, t_exec), t_init);
  const float q_k = __fadd_rn(
      __fmul_rn(0.285f, __fsub_rn(1.f, expf(__fmul_rn(-steps_f, 0.1f)))),
      ptr<const float>(P, I_NOISE)[bK + k]);
  const float pen = q_k < c.q_min ? c.p_quality : 0.f;
  const float* arr = ptr<const float>(P, I_ARR) + bK;
  const float t_resp = __fsub_rn(finish, arr[k]);

  int sched_status = 1;
  float rec_finish = finish;
  bool will_fail = false;
  if (FAULTS) {  // in-flight crash of a selected server before the finish
    float crash_t = BIG;
    for (int e = lane; e < E; e += 32) {
      if (!s_sel[e]) continue;
      for (int f = 0; f < F; ++f) {
        const float s = fds[(bE + e) * F + f];
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
  for (int e = lane; e < E; e += 32) {
    const bool sel_f = s_sel[e] && fz;
    const float nf = sel_f ? rec_finish : s_free[e];
    const int nm = sel_f ? m_k : s_model[e];
    ptr<float>(P, O_FREE)[bE + e] = nf;
    ptr<int>(P, O_SMODEL)[bE + e] = nm;
    ptr<int>(P, O_SGANG)[bE + e] = sel_f ? k : s_gang[e];
    ptr<int>(P, O_SGSIZE)[bE + e] = sel_f ? c_k : s_gsize[e];
    s_free[e] = nf;
    s_model[e] = nm;
    if (nf > t) next_completion = fminf(next_completion, nf);
  }

  // --- tasks: retire, apply, reward terms, next arrival ------------------
  const bool* queued = ptr<const bool>(P, I_QQUEUED) + bK;
  int n_still = 0;
  float wait_sum = 0.f, next_arrival = BIG;
  for (int kk = lane; kk < K; kk += 32) {
    const int s0 = ptr<const int>(P, I_TSTATUS)[bK + kk];
    const float tf = ptr<const float>(P, I_TFINISH)[bK + kk];
    const int s = (s0 == 1 && tf <= t) ? 2 : s0;
    const bool hit = kk == k && fz;
    ptr<int>(P, O_TSTATUS)[bK + kk] = hit ? sched_status : s;
    ptr<float>(P, O_TSTART)[bK + kk] =
        hit ? t : ptr<const float>(P, I_TSTART)[bK + kk];
    ptr<float>(P, O_TFINISH)[bK + kk] = hit ? rec_finish : tf;
    ptr<int>(P, O_TSTEPS)[bK + kk] =
        hit ? steps : ptr<const int>(P, I_TSTEPS)[bK + kk];
    ptr<float>(P, O_TQUAL)[bK + kk] =
        hit ? q_k : ptr<const float>(P, I_TQUAL)[bK + kk];
    ptr<int>(P, O_TRELOAD)[bK + kk] =
        hit ? (reuse ? 0 : 1) : ptr<const int>(P, I_TRELOAD)[bK + kk];
    const float a = arr[kk];
    if (queued[kk] && kk != k) {
      ++n_still;
      wait_sum = __fadd_rn(wait_sum, __fsub_rn(t, a));
    }
    if (a > t) next_arrival = fminf(next_arrival, a);
  }
  n_still = warp_sum(n_still);
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
    for (int e = lane; e < E; e += 32)
      for (int f = 0; f < F; ++f) {
        const float s = fds[(bE + e) * F + f], en = fde[(bE + e) * F + f];
        if (s <= t && en > t) rec = fminf(rec, en);
      }
    next_event = fminf(next_event, warp_minf(rec));
  }
  const float t_new =
      fz ? t : (next_event < BIG ? next_event : __fadd_rn(t, 1.f));
  const int staken = ptr<const int>(P, I_STAKEN)[b] + 1;

  // --- done flag and the next queue's priorities --------------------------
  bool all_resolved = true;
  int n_queued = 0;
  for (int kk = lane; kk < K; kk += 32) {
    const int s2 = ptr<const int>(P, O_TSTATUS)[bK + kk];
    const float tf2 = ptr<const float>(P, O_TFINISH)[bK + kk];
    all_resolved &= s2 == 2 || (s2 == 1 && tf2 <= t_new) || (FAULTS && s2 == 3);
    const bool q2 = s2 == 0 && arr[kk] <= t_new;
    ptr<bool>(P, O_QQUEUED)[bK + kk] = q2;
    n_queued += q2;
    s_prio[kk] = q2 ? arr[kk] : BIG;
  }
  all_resolved = __all_sync(FULL, all_resolved);
  n_queued = warp_sum(n_queued);
  __syncwarp();

  // --- next visible queue by counting rank (ties: lower index first) ------
  const int W = E + L;
  float* obs = ptr<float>(P, O_OBS) + (size_t)b * 3 * W;
  for (int kk = lane; kk < K; kk += 32) {
    const float p = s_prio[kk];
    int rank = 0;
    for (int j = 0; j < K; ++j)
      rank += s_prio[j] < p || (s_prio[j] == p && j < kk);
    if (rank < L) {
      const bool v = rank < n_queued;
      ptr<int>(P, O_QIDX)[bL + rank] = kk;
      ptr<bool>(P, O_QVALID)[bL + rank] = v;
      obs[E + rank] = v ? __fmul_rn(__fsub_rn(t_new, arr[kk]), c.inv_ts) : 0.f;
      obs[W + E + rank] =
          v ? (float)ptr<const int>(P, I_C)[bK + kk] / 8.f : 0.f;
      obs[2 * W + E + rank] =
          (v && c.num_models > 1)
              ? __fmul_rn(__fadd_rn((float)ptr<const int>(P, I_MODEL)[bK + kk],
                                    1.f), c.inv_nm)
              : 0.f;
    }
  }

  // --- Eq.-6 observation of the servers -----------------------------------
  for (int e = lane; e < E; e += 32) {
    const float nf = s_free[e];
    bool up = nf <= t_new;
    if (FAULTS)
      for (int f = 0; f < F; ++f) {
        const float s = fds[(bE + e) * F + f], en = fde[(bE + e) * F + f];
        up &= !((s <= t_new) && (t_new < en));
      }
    obs[e] = up ? 1.f : 0.f;
    obs[W + e] = __fmul_rn(fmaxf(__fsub_rn(nf, t_new), 0.f), c.inv_ts);
    obs[2 * W + e] = __fmul_rn(__fadd_rn((float)s_model[e], 1.f), c.inv_nm);
  }

  if (lane == 0) {
    ptr<float>(P, O_TIME)[b] = t_new;
    ptr<int>(P, O_STAKEN)[b] = staken;
    ptr<float>(P, O_REWARD)[b] = reward;
    ptr<bool>(P, O_DONE)[b] =
        all_resolved || t_new >= c.time_limit || staken >= c.max_steps;
  }
}

}  // namespace

// ptrs: N_PTRS device pointers in the enum's order (the fault inputs may be
// null when faults == 0). Returns cudaGetLastError() after the launch.
extern "C" int env_step_launch(const EnvStepCfg* cfg, void* const* ptrs,
                               int B, int faults, void* stream) {
  Ptrs P;
  for (int i = 0; i < N_PTRS; ++i) P.p[i] = ptrs[i];
  const size_t smem = (size_t)WARPS * (9 * cfg->E + cfg->K) * sizeof(int);
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (faults)
    env_step_kernel<true><<<grid, block, smem, s>>>(P, *cfg, B);
  else
    env_step_kernel<false><<<grid, block, smem, s>>>(P, *cfg, B);
  return (int)cudaGetLastError();
}

extern "C" int env_step_ptr_count() { return N_PTRS; }
