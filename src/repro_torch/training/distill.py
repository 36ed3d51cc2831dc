"""Consistency distillation of the diffusion actor (port of
`repro/training/distill.py`): the T-step teacher chain compressed into one
student forward pass.

A denoiser-shaped student g(x_T, T, f_s) regresses the FROZEN teacher's
deterministic endpoint on the exact (x_T, f_s) pairing inference sees:

* observations come from rolling the deterministic ddpm teacher itself
  through `batch_rollout` (`collect_obs`), so the state distribution
  matches deployment; on the card that runs the env-step and chain
  kernels;
* the target is the full-grid DDIM chain (eta = 0, K = T) of the same
  denoiser, the probability-flow endpoint, a deterministic function of
  (x_T, f_s); on the card the targets for the whole dataset are one
  `denoiser_chain` launch;
* each sample's x_T is drawn once and fed to both teacher and student, as
  `actors.samplers.distilled_sample` feeds its first draw at inference;
* plain MSE on the tanh-bounded x_0 and the reference's Adam on the
  student only: encoder and sigma head are the teacher's.

    params, hist = distill_actor(teacher_params, ecfg, acfg)
    policy = actor_policy(ecfg, acfg, sampler="distilled")

The returned params dict is the teacher's (its own tensors) plus
``"student"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.actors import samplers as SMP
from repro_torch.actors.policies import actor_policy, init_student
from repro_torch.common.device import resolve_device, to_device
from repro_torch.core import agent as AG
from repro_torch.core import diffusion as DF
from repro_torch.core import env as EV
from repro_torch.core import rollout as RO
from repro_torch.core.workload import TraceConfig, make_trace_batch
from repro_torch.telemetry.trace import NULL_TRACER
from repro_torch.training.optimizer import (adam_init, adam_update,
                                            apply_updates, value_and_grad)


@dataclass(frozen=True)
class DistillConfig:
    steps: int = 400              # gradient steps
    batch: int = 256              # samples per step
    lr: float = 1e-3
    dataset: int = 4096           # (obs, x_T) pairs distilled over
    noise_per_obs: int = 4        # fresh x_T draws per collected obs
    collect_episodes: int = 8     # teacher rollouts that supply the obs
    collect_steps: Optional[int] = None   # decision budget per rollout
    log_every: int = 0

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.dataset < 1 or self.batch < 1:
            raise ValueError("dataset and batch must be >= 1")


def collect_obs(teacher_params, ecfg: EV.EnvConfig, acfg: AG.AgentConfig,
                episodes: int = 8, num_steps: Optional[int] = None, *,
                generator=None, device=None) -> torch.Tensor:
    """Observations from the teacher's own induced state distribution:
    `episodes` deterministic ddpm teacher rollouts on fresh traces, valid
    steps only, flattened to (N, 3, E+l)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    tcfg = TraceConfig(num_tasks=ecfg.max_tasks, max_servers=ecfg.num_servers,
                       num_models=ecfg.num_models)
    traces = make_trace_batch(tcfg, episodes, generator=gen, device=dev)
    policy = actor_policy(ecfg, acfg, deterministic=True, sampler="ddpm",
                          device=dev)
    res = RO.batch_rollout(ecfg, traces, policy, teacher_params,
                           generator=gen, num_steps=num_steps, collect=True,
                           device=dev)
    tr = res.transitions
    return tr.obs[tr.valid]


def _teacher_targets(teacher_params, obs, *, ecfg: EV.EnvConfig,
                     acfg: AG.AgentConfig, generator=None, x_T=None,
                     impl: str = "auto"):
    """Frozen-teacher supervision for a batch of observations (N, 3, E+l):
    f_s (N, F), the full-grid DDIM chain's x_0 (N, A) and the x_T (N, A) it
    starts from (drawn from `generator` unless given), all N in one chain
    call."""
    with torch.no_grad():
        f_s = AG._encode(teacher_params, acfg, obs)
        if x_T is None:
            x_T = torch.randn(f_s.shape[:-1] + (ecfg.action_dim,),
                              generator=generator, device=f_s.device)
        sched = DF.vp_schedule(acfg.T, device=f_s.device)
        x0 = SMP.chain_sample(teacher_params["denoiser"], sched, f_s,
                              ecfg.action_dim, kind="ddim", K=acfg.T,
                              x_T=x_T, impl=impl)
    return f_s, x0, x_T


def _student_step(student, opt, f_s, x0, x_T, *, acfg: AG.AgentConfig,
                  lr: float):
    """One Adam step of the student on the MSE to the teacher's x_0.
    Returns (student', opt', loss before the step)."""
    i = torch.full(x_T.shape[:-1], acfg.T, device=x_T.device)

    def loss_fn(sp):
        pred = DF.denoise_eps(sp, x_T, i, f_s)
        return torch.mean(torch.square(pred - x0)), None

    loss, _, grads = value_and_grad(loss_fn, student)
    upd, opt = adam_update(grads, opt, student, lr)
    return apply_updates(student, upd), opt, loss


def distill_actor(teacher_params, ecfg: EV.EnvConfig, acfg: AG.AgentConfig,
                  dcfg: DistillConfig = DistillConfig(), *,
                  obs: Optional[torch.Tensor] = None, tracer=None,
                  generator=None, device=None) -> Tuple[Dict, List[Dict]]:
    """Distill the frozen teacher chain into a one-call student head.

    Returns (params, history): `params` is the teacher dict (its own
    tensors) plus the trained ``"student"``; `history` rows carry (step,
    loss), every `log_every` steps and at the last. `obs` overrides the
    self-collected observation set (any (N, 3, E+l) tensor). `tracer`
    (a `telemetry.trace.Tracer`; None: no spans) gets the reference's
    "distill" span (cat "train", args steps and samples) around the
    student's steps."""
    if acfg.policy != "diffusion":
        raise ValueError(
            f"distillation needs a diffusion teacher; variant "
            f"{acfg.variant!r} is Gaussian")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev) if generator is None else generator
    teacher = to_device(teacher_params, dev)
    if obs is None:
        obs = collect_obs(teacher, ecfg, acfg, episodes=dcfg.collect_episodes,
                          num_steps=dcfg.collect_steps, generator=gen,
                          device=dev)
    obs = obs.to(dev)
    n_obs = int(obs.shape[0])
    if n_obs == 0:
        raise ValueError("no observations to distill over")

    # dataset: sampled obs rows, one fresh x_T per (obs, draw) pair
    n = min(dcfg.dataset, n_obs * dcfg.noise_per_obs)
    rows = torch.randint(0, n_obs, (n,), generator=gen, device=dev)
    f_s, x0, x_T = _teacher_targets(teacher, obs[rows], ecfg=ecfg, acfg=acfg,
                                    generator=gen)

    student = init_student(ecfg, acfg, generator=gen, device=dev)
    opt = adam_init(student)
    history: List[Dict] = []
    tracer = NULL_TRACER if tracer is None else tracer
    with tracer.span("distill", cat="train", steps=dcfg.steps, samples=n):
        for s in range(dcfg.steps):
            idx = torch.randint(0, n, (min(dcfg.batch, n),), generator=gen,
                                device=dev)
            student, opt, loss = _student_step(
                student, opt, f_s[idx], x0[idx], x_T[idx], acfg=acfg,
                lr=dcfg.lr)
            if dcfg.log_every and s % dcfg.log_every == 0:
                row = {"step": s, "loss": float(loss)}
                history.append(row)
                print(f"[distill {s:4d}] loss={row['loss']:.5f}")
    history.append({"step": dcfg.steps - 1, "loss": float(loss)})
    out = dict(teacher_params)
    out["student"] = student
    return out, history
