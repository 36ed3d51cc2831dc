"""CLI serving launcher (port of `repro/launch/serve.py` and of the loop of
`examples/serve_cluster.py`, which the reference runs by `runpy`).

    PYTHONPATH=src python -m repro_torch.launch.serve --servers 4 \\
        --archs qwen2-1.5b,tinyllama-1.1b --tasks 12 --policy eat \\
        [--device {cuda,cpu}]

Submits a batch of AIGC requests (prompts against the zoo's models), lets
the chosen scheduler gang-allocate logical edge servers
(`serving.engine.ServingEngine`), really executes patch-parallel prefill
+ decode on the loaded weights, and reports the Table-IX/X/XI metrics.
Virtual time (time_dilation=1) accounts busy time with the calibrated
Table-VI latency model, so a run is deterministic. The CLI serves the
models reduced, as the reference's does; `run(reduced=False)` serves them
at their published widths. It runs on the card unless `--device cpu` is
given.
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import agent as AG
from repro_torch.core import env as EV
from repro_torch.core import sac as SAC
from repro_torch.serving.engine import Request, ServingEngine


def make_policy(name: str, num_servers: int, queue_window: int, *,
                device=None):
    """policy(obs (3, E + l) numpy, generator) -> env-space action."""
    if name == "fifo":
        # always execute the oldest task with mid steps
        def fifo(obs, generator):
            a = np.zeros(2 + queue_window, np.float32)
            a[1] = 0.5
            a[2] = 1.0
            return a
        return fifo
    if name == "greedy":
        # prefer the task whose patch count matches an idle loaded gang
        def greedy(obs, generator):
            a = np.zeros(2 + queue_window, np.float32)
            a[1] = 1.0                       # max steps (paper's Greedy)
            a[2:] = obs[0, -queue_window:]   # prefer longest-waiting
            return a
        return greedy
    # eat: the full attention+diffusion actor, untrained (random weights
    # from seed 7)
    dev = resolve_device(device)
    ecfg = EV.EnvConfig(num_servers=num_servers, queue_window=queue_window)
    acfg = AG.AgentConfig(variant="eat")
    actor = AG.init_actor(ecfg, acfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(7))

    def eat(obs, generator):
        a = SAC.policy_act(actor, torch.as_tensor(obs, device=dev),
                           ecfg=ecfg, acfg=acfg, generator=generator)
        return AG.to_env_action(a).cpu().numpy()
    return eat


def make_requests(archs: Sequence[str], tasks: int, servers: int,
                  seed: int):
    """Batched request arrivals (D_g exponential at 0.05 tasks/s, D_c over
    {1, 2, 4}), 24-token prompts, 8 new tokens each."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for rid in range(tasks):
        t += rng.exponential(1.0 / 0.05)
        c = int(rng.choice([1, 2, 4], p=[0.4, 0.4, 0.2]))
        c = min(c, servers)
        reqs.append(Request(
            rid=rid, arch=archs[rid % len(archs)],
            prompt=rng.integers(1, 100, size=24).astype(np.int32),
            patches=c, arrive_t=t, max_new_tokens=8))
    return reqs


def run(policy: str = "eat", *, servers: int = 4, tasks: int = 12,
        archs: Sequence[str] = ("qwen2-1.5b", "tinyllama-1.1b"),
        seed: int = 0, reduced: bool = True, device=None,
        verbose: bool = True) -> ServingEngine:
    """Serve `tasks` requests on `servers` logical servers with `policy`
    (eat, greedy or fifo) deciding, at most 10 decisions a task; returns
    the engine (`done`, `qos_summary()`)."""
    dev = resolve_device(device)
    archs = list(archs)
    eng = ServingEngine(servers, archs, queue_window=8, reduced=reduced,
                        time_dilation=1.0, seed=seed, device=dev)
    pending = sorted(make_requests(archs, tasks, servers, seed),
                     key=lambda r: r.arrive_t)
    act = make_policy(policy, servers, eng.l, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    decisions = 0
    while (pending or eng.queue) and decisions < 10 * tasks:
        now = eng.now()
        while pending and pending[0].arrive_t <= now:
            eng.submit(pending.pop(0))
        if not eng.queue:
            eng._advance(max(0.5, pending[0].arrive_t - now) if pending
                         else 1.0)
            continue
        done = eng.try_schedule(act(eng.observe(), generator))
        decisions += 1
        if done is not None and verbose:
            print(f"[{done.finish_t:8.1f}s] req {done.rid:2d} "
                  f"({done.arch}, c={done.patches}) steps={done.steps} "
                  f"reused={done.reused} resp={done.finish_t - done.arrive_t:7.1f}s "
                  f"tokens={done.tokens[:4]}...")
    return eng


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="eat",
                    choices=["eat", "greedy", "fifo"])
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--tasks", type=int, default=12)
    ap.add_argument("--archs", default="qwen2-1.5b,tinyllama-1.1b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    eng = run(args.policy, servers=args.servers, tasks=args.tasks,
              archs=args.archs.split(","), seed=args.seed,
              device=args.device)
    m = eng.qos_summary()
    print(f"\npolicy={args.policy} servers={args.servers}: "
          f"scheduled {m['tasks_scheduled']}/{args.tasks}, "
          f"latency p50/p95 {m['latency_p50']:.1f}/{m['latency_p95']:.1f}s, "
          f"quality {m['avg_quality']:.3f}, "
          f"cold-start rate {m['cold_start_rate']:.2f} "
          f"({m['model_loads']} loads, {m['model_reuses']} reuses)")
    return eng


if __name__ == "__main__":
    main()
