"""Decision-latency profiling: how long does the scheduler take to decide?
(Port of `repro/telemetry/profile.py`.)

EAT's QoS accounting (Eq. 4a) treats the scheduler itself as free, but the
diffusion actor pays K denoise steps per decision — at high arrival rates
that inference cost, not env throughput, bounds the achievable line rate
("Accelerating AIGC Services with Latent Action Diffusion", PAPERS.md).
This module measures it:

* `DecisionProfile` — streaming histograms (`LatencyHistogram` on
  decision-scaled log edges) of the three per-decision phases the serving
  backend can split at its program boundaries: `policy` (inference),
  `env_advance` (mirror decision step), `executor` (real model work).
* `profile_policy` — the standalone probe: times one scheduling decision
  (state -> action) of any rollout-protocol policy on a representative
  (trace, state, obs) through the policy's `ActorProgram.act`, its first
  call (the graph capture on the card) excluded. Each decision is timed
  as the reference times it: the host clock around the call and, on the
  card, the device's synchronisation (its `block_until_ready`).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.telemetry.metrics import LatencyHistogram

# decision latencies live in microseconds..seconds, two decades below the
# QoS response-latency edges — ~10 log-bins per decade across 1e-6..1e2 s
DECISION_EDGES = np.geomspace(1e-6, 1e2, 81).astype(np.float64)

PHASES = ("policy", "env_advance", "executor")


class DecisionProfile:
    """Per-phase streaming latency histograms with percentile summaries."""

    def __init__(self):
        self.hists: Dict[str, LatencyHistogram] = {
            p: LatencyHistogram(DECISION_EDGES) for p in PHASES}
        self.sums: Dict[str, float] = {p: 0.0 for p in PHASES}

    def observe(self, phase: str, seconds: float) -> None:
        self.hists[phase].add_values([seconds])
        self.sums[phase] += float(seconds)

    def counts(self, phase: str) -> int:
        return self.hists[phase].total

    def summary(self) -> Dict[str, float]:
        """Flat scalars: `<phase>_latency_{p50,p95,p99,mean}_s` + counts,
        with the policy phase doubled under the headline `decision_*`
        names every consumer keys on."""
        out: Dict[str, float] = {}
        for p in PHASES:
            h = self.hists[p]
            if h.total == 0:
                continue
            out[f"{p}_latency_p50_s"] = h.percentile(0.50)
            out[f"{p}_latency_p95_s"] = h.percentile(0.95)
            out[f"{p}_latency_p99_s"] = h.percentile(0.99)
            out[f"{p}_latency_mean_s"] = self.sums[p] / h.total
            out[f"{p}_decisions"] = float(h.total)
        for k in ("p50", "p95", "p99", "mean"):
            src = f"policy_latency_{k}_s"
            if src in out:
                out[f"decision_latency_{k}_s"] = out[src]
        return out


# ----------------------------------------------------------------------
def profile_policy(ecfg, policy, params, generator=None, *, trace=None,
                   state=None, iters: int = 50, warmup: int = 2,
                   batch: int = 0, device=None) -> Dict[str, float]:
    """Time `iters` single decisions of one rollout-protocol policy.

    The probe runs the shared actor layer's per-decision program
    (`repro_torch.actors.actor_program(ecfg, policy).act`: on the card the
    CUDA graph of the policy a serving decision replays), so the measured
    work is the one a serving decision pays per arriving task. No env
    step, no executor. `trace` is one trace (dict of (K,) tensors; default
    a seeded `make_trace` of the env's shape) and `state` one unbatched
    `EnvState` (default the reset state); the decision draws from
    `generator` (default a fresh one). Returns
    `decision_latency_{p50,p95,p99,mean}_s` (+ `_n`, + `sampler` when the
    policy carries a sampler label).

    ``batch > 0`` measures the batched view instead — the policy across
    `batch` envs on broadcast trace/state/obs, what the fused rollout pays
    per decision step. Single-decision timings on small nets are floored
    by launch latency; the batched probe is where a cheaper sampler's
    compute saving is visible, so latency gates compare samplers at batch
    scale. Each decision is timed by `time.perf_counter()` around the
    `act` call and, on the card, `torch.cuda.synchronize` (the input
    copies, the replay, the output copies and the host's launch work),
    the reference's measure on every device.
    """
    from repro_torch.actors.program import actor_program
    from repro_torch.common.device import resolve_device, to_device
    from repro_torch.core import env as EV
    from repro_torch.core.workload import TraceConfig, make_trace

    dev = resolve_device(device)
    if trace is None:
        trace = make_trace(TraceConfig(num_tasks=ecfg.max_tasks,
                                       max_servers=ecfg.num_servers,
                                       num_models=ecfg.num_models),
                           generator=torch.Generator(dev).manual_seed(0),
                           device=dev)
    B = batch if batch > 0 else 1
    btrace = {k: v.to(dev).expand((B,) + v.shape).contiguous()
              for k, v in trace.items()}
    if state is None:
        bstate = EV.reset(ecfg, B, device=dev)
    else:
        bstate = EV.EnvState(*(x.to(dev).expand((B,) + x.shape).contiguous()
                               for x in state))
    _, bobs = EV.reset_view(ecfg, btrace, bstate)
    params = to_device(params, dev)
    gen = torch.Generator(dev) if generator is None else generator
    aprog = actor_program(ecfg, policy)

    def run():
        return aprog.act(btrace, bstate, bobs, gen, params)[0]
    cuda = dev.type == "cuda"
    for _ in range(1 + warmup):                      # capture, then warm
        run()
    if cuda:
        torch.cuda.synchronize(dev)

    hist = LatencyHistogram(DECISION_EDGES)
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        hist.add_values([dt])
        total += dt
    out = {
        "decision_latency_p50_s": hist.percentile(0.50),
        "decision_latency_p95_s": hist.percentile(0.95),
        "decision_latency_p99_s": hist.percentile(0.99),
        "decision_latency_mean_s": total / max(iters, 1),
        "decision_latency_n": float(iters),
    }
    if batch > 0:
        out["decision_batch"] = float(batch)
    if aprog.sampler:
        out["sampler"] = aprog.sampler
    return out
