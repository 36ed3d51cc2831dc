"""ActorProgram: the one owner of a policy's decision on one env config
(port of `repro/actors/program.py`).

The reference jits one decision (`act`) and compiles the rollout's scan
body into one XLA program. The port's counterpart is a captured CUDA
graph. `actor_program(ecfg, policy)` is cached per (EnvConfig, policy
callable), and the policy factories are cached on their arguments, so one
program, and the graphs it captured, serve every call with the same
policy. Its views:

* ``policy`` — the rollout-protocol callable. The port's policies are
  batched already, so the policy itself is the batched view the
  reference's ``vmapped`` gives.
* ``sampler`` — the policy's sampler label when it carries one.
* ``act(traces, state, obs, generator, params)`` — one decision, the
  serving seam: (action, extras). On the card a CUDA graph of the policy
  per call signature (batch shape included); the first call runs eagerly
  and is then captured, every later call replays.
* ``rollout(...)`` — the fused engine's decision loop behind
  `core.rollout.batch_rollout`: the policy, the env step through its
  `EnvStepPlan`, the freeze of finished envs and the return and length
  accumulators, written as a body that reads one set of state buffers and
  writes the other (ping-pong), so on the card each direction is one
  captured graph and a rollout is T replays; on the CPU the same body
  runs eagerly.

What a replay cannot see, the program keeps fixed or copies in:
* inputs (traces, weights, initial state) are copied into the program's
  static buffers once per rollout (or per `act` call); a weight leaf
  that is the same tensor at the same version as last time is not copied
  again, and the last source leaves are held so their addresses cannot be
  reused by new tensors;
* draws come from a generator the program owns, registered with its
  graphs; its state is set from the caller's generator before a rollout
  and handed back after, so the caller's generator advances exactly as in
  the eager loop and the draws are the same;
* kernel launch counts (the wrappers' Python counters): a capture records
  how many launches of each kernel it made and adds that at every replay;
* collected transitions go into (B, T, ...) buffers at a decision index
  held on the device, written inside the graph; a finished rollout hands
  out copies.

A capture that fails raises; nothing falls back to the eager loop.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.common.pytree import tree_leaves, tree_map, tree_paths
from repro_torch.core import env as EV
from repro_torch.core.rollout import RolloutResult, Transitions
from repro_torch.kernels.env_step import ops as EK


# ----------------------------------------------------------------------
# launch-count bookkeeping
def kernel_wrappers():
    """The five kernel wrappers whose `launches` counters the program
    keeps true through replays."""
    from repro_torch.kernels.denoiser import kernel as DK
    from repro_torch.kernels.env_step import kernel as EK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssm_scan import kernel as SK
    return (EK.env_step, DK.denoiser_chain, DK.denoiser_step,
            FK.flash_attention, SK.ssm_scan)


def counted_capture(fn):
    """Run `fn()` (a capture: Python runs, the card launches nothing) and
    return {wrapper: launches it recorded}, with every counter put back
    as it was before."""
    wrappers = kernel_wrappers()
    before = [w.launches for w in wrappers]
    try:
        fn()
    finally:
        after = [w.launches for w in wrappers]
        for w, b in zip(wrappers, before):
            w.launches = b
    return {w: a - b for w, a, b in zip(wrappers, after, before) if a != b}


def count_replay(delta):
    """Add one replay's launches (`counted_capture`'s dict) to the
    counters."""
    for w, n in delta.items():
        w.launches += n


# ----------------------------------------------------------------------
def _signature(tree):
    """Structure, shapes, dtypes and devices of a tree of tensors (other
    leaves by value): what a graph's fixed buffers are built for."""
    return tuple((k, (tuple(v.shape), v.dtype, v.device)
                  if isinstance(v, torch.Tensor) else v)
                 for k, v in sorted(tree_paths(tree).items()))


def _empty_like(x):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


class StaticTree:
    """Fixed device buffers for a tree of tensors, refilled by `load`.

    `load(tree)` copies a leaf only when it is another tensor than the one
    copied last time, or that tensor was modified in place since (its
    version moved). The last source leaves are held, so no new tensor can
    take their address while they are compared by identity."""

    def __init__(self, tree):
        self.tree = tree_map(lambda x: _empty_like(x)
                             if isinstance(x, torch.Tensor) else x, tree)
        self._dst = [x for x in tree_leaves(self.tree)
                     if isinstance(x, torch.Tensor)]
        self._src = [None] * len(self._dst)
        self._ver = [None] * len(self._dst)
        self.copies = 0

    def load(self, tree):
        src = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
        for i, (s, d) in enumerate(zip(src, self._dst)):
            if s is not self._src[i] or s._version != self._ver[i]:
                d.copy_(s)
                self._src[i], self._ver[i] = s, s._version
                self.copies += 1
        return self.tree


class _Side(NamedTuple):
    """One set of the decision loop's carried buffers."""
    state: EV.EnvState
    q: EV.QueueView
    obs: torch.Tensor
    done: torch.Tensor      # (B,) bool, done before this decision
    total: torch.Tensor     # (B,) f32 return so far
    length: torch.Tensor    # (B,) i32 decisions taken before done


def _side_like(state, q, obs):
    B, dev = obs.shape[0], obs.device
    return _Side(EV.EnvState(*map(_empty_like, state)),
                 EV.QueueView(*map(_empty_like, q)), _empty_like(obs),
                 torch.zeros((B,), dtype=torch.bool, device=dev),
                 torch.zeros((B,), dtype=torch.float32, device=dev),
                 torch.zeros((B,), dtype=torch.int32, device=dev))


def _bcast(flag, like):
    return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))


def _register(graph, gen):
    reg = getattr(graph, "register_generator_state", None)
    if reg is None:
        raise RuntimeError(
            f"torch {torch.__version__} cannot register a generator with a "
            "CUDA graph (CUDAGraph.register_generator_state); the decision "
            "graph draws from the rollout's own generator")
    reg(gen)


class _Capturer:
    """Eager warm-up and captures of one loop or call signature: one side
    stream, one memory pool shared by its graphs (they never run at the
    same time), the program's generator registered with each graph."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.device = device
        self.pool = None
        self.captures = 0
        self.seconds = 0.0

    def eager(self, fn):
        """`fn()` on the capture stream, ordered after and before the
        current stream's work: the warm-up that builds every lazy cache
        (kernel plans, embeddings, cuBLAS workspaces) a capture may not."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn, gen):
        """(graph, launches it records) of `fn()`."""
        g = torch.cuda.CUDAGraph()
        _register(g, gen)
        t0 = time.perf_counter()

        def run():
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                fn()
        delta = counted_capture(run)
        if self.pool is None:
            self.pool = g.pool()
        self.captures += 1
        self.seconds += time.perf_counter() - t0
        return g, delta


def _replay(graph):
    graph[0].replay()
    count_replay(graph[1])


class _Loop:
    """The fused decision loop for one (device, B, traces and params
    signature, impl, and T when collecting): static traces and statics
    with the env step bound to them, two sides of carried buffers, the
    records, and on the card the two graphs (reading side 0, side 1)."""

    def __init__(self, ecfg, policy, traces, params, state, T, collect,
                 impl, dev):
        self.ecfg, self.policy, self.collect, self.T = ecfg, policy, collect, T
        self.tr = {k: _empty_like(v) for k, v in traces.items()}
        for k, v in traces.items():
            self.tr[k].copy_(v)
        # trace columns alias self.tr; the computed ones are refreshed
        self.st = EV.decision_statics(ecfg, self.tr)
        self.step = EK.env_stepper(ecfg, self.st, state.time.shape[0], dev,
                                   impl=impl)
        self.params = StaticTree(params)
        q, obs = EV.reset_view(ecfg, self.tr, state)
        self.sides = (_side_like(state, q, obs), _side_like(state, q, obs))
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.rec = None
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.gen = torch.Generator(device=dev)
            self.cap = _Capturer(dev)
            self.graphs = [None, None]
            self.warm = False

    def body(self, i, gen):
        """One decision from side i into side 1 - i: exactly the eager
        loop's decision (`core.rollout._loop`), written with `out=`."""
        src, dst = self.sides[i], self.sides[1 - i]
        action, extras = self.policy(self.params.tree, gen, self.tr,
                                     src.state, src.obs)
        nstate, nq, nobs, r, d = self.step(src.state, action, src.q)
        done = src.done
        for new, old, out in zip((*nstate, *nq), (*src.state, *src.q),
                                 (*dst.state, *dst.q)):
            torch.where(_bcast(done, new), old, new, out=out)
        torch.where(done[:, None, None], src.obs, nobs, out=dst.obs)
        r = torch.where(done, 0.0, r)
        valid = ~done
        torch.add(src.total, r, out=dst.total)
        torch.add(src.length, valid.to(torch.int32), out=dst.length)
        torch.logical_or(done, d, out=dst.done)
        if self.collect:
            row = [src.obs, action, r, dst.obs, d.to(torch.float32), valid]
            row += [extras[k] for k in sorted(extras)]
            if self.rec is None:
                self.keys = sorted(extras)
                self.rec = [torch.empty((x.shape[0], self.T) + x.shape[1:],
                                        dtype=x.dtype, device=x.device)
                            for x in row]
            for buf, x in zip(self.rec, row):
                buf.index_copy_(1, self.t, x.unsqueeze(1))
            self.t.add_(1)

    def run(self, traces, params, gen, state0, T) -> RolloutResult:
        ecfg = self.ecfg
        for k, v in traces.items():
            self.tr[k].copy_(v)
        for k, v in EV.decision_statics(ecfg, self.tr).items():
            if v is not self.st[k]:
                self.st[k].copy_(v)
        self.params.load(params)
        a = self.sides[0]
        q, obs = EV.reset_view(ecfg, self.tr, state0)
        for dst, src in zip((*a.state, *a.q, a.obs), (*state0, *q, obs)):
            dst.copy_(src)
        for x in (a.done, a.total, a.length, self.t):
            x.zero_()
        if not self.cuda:
            for i in range(T):
                self.body(i % 2, gen)
        else:
            self.gen.set_state(gen.get_state())
            for i in range(T):
                self._decide(i % 2)
            gen.set_state(self.gen.get_state())
        final = self.sides[T % 2]
        metrics = dict(EV.episode_metrics(ecfg, self.tr, final.state))
        metrics["episode_return"] = final.total.clone()
        metrics["episode_len"] = final.length.clone()
        traj = None
        if self.collect:
            rec = [x.clone() for x in self.rec]
            traj = Transitions(*rec[:6], extras=dict(zip(self.keys, rec[6:])))
        return RolloutResult(metrics=metrics, final_state=EV.EnvState(
            *(x.clone() for x in final.state)), transitions=traj)

    def _decide(self, i):
        """Decision from side i on the card: the first of the loop's life
        eagerly, then each direction captured once and replayed."""
        if self.graphs[i] is None:
            if not self.warm:
                self.cap.eager(lambda: self.body(i, self.gen))
                self.warm = True
                return
            self.graphs[i] = self.cap.capture(lambda: self.body(i, self.gen),
                                              self.gen)
        _replay(self.graphs[i])


class _Act:
    """`ActorProgram.act` on the card for one call signature: the inputs'
    static buffers and the graph of one policy call."""

    def __init__(self, policy, inputs, dev):
        self.policy = policy
        self.inputs = StaticTree(inputs)
        self.gen = torch.Generator(device=dev)
        self.cap = _Capturer(dev)
        self.graph = None

    def __call__(self, inputs, gen):
        tr, st, obs, params = self.inputs.load(inputs)
        self.gen.set_state(gen.get_state())

        def call():
            return self.policy(params, self.gen, tr, st, obs)
        if self.graph is None:
            out = self.cap.eager(call)

            def keep():
                self.out = call()
            self.graph = self.cap.capture(keep, self.gen)
        else:
            _replay(self.graph)
            out = self.out
        gen.set_state(self.gen.get_state())
        action, extras = out
        return action.clone(), {k: v.clone() for k, v in extras.items()}


class ActorProgram:
    """The decision of one rollout-protocol policy on one env config.

    Build via `actor_program(ecfg, policy)`: the cached factory is what
    keeps one program, and one set of captured graphs, per (env config,
    policy callable)."""

    def __init__(self, ecfg, policy):
        self.ecfg = ecfg
        self.policy = policy
        self.sampler = getattr(policy, "sampler", None)
        self._loops: Dict = {}
        self._acts: Dict = {}

    def _capturers(self):
        return [x.cap for x in (*self._loops.values(), *self._acts.values())
                if hasattr(x, "cap")]

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far (none on the CPU)."""
        return sum(c.captures for c in self._capturers())

    @property
    def capture_seconds(self) -> float:
        """Host seconds spent capturing them."""
        return sum(c.seconds for c in self._capturers())

    @property
    def loops_built(self) -> int:
        """Decision loops (sets of static buffers) built so far."""
        return len(self._loops)

    def act(self, traces, state, obs, generator: Optional[torch.Generator]
            = None, params=None):
        """One decision at the serving seam: (action, extras), drawing from
        `generator` (advanced as the policy would advance it; None: a
        fresh default-seeded one). On the card a CUDA graph per call
        signature; on the CPU the policy itself."""
        gen = (torch.Generator(device=obs.device) if generator is None
               else generator)
        if obs.device.type != "cuda":
            return self.policy(params, gen, traces, state, obs)
        inputs = (traces, state, obs, params)
        key = _signature(inputs)
        if key not in self._acts:
            self._acts[key] = _Act(self.policy, inputs, obs.device)
        return self._acts[key](inputs, gen)

    def rollout(self, traces, params, generator, state, *, num_steps: int,
                collect: bool = False, impl: str = "auto") -> RolloutResult:
        """`num_steps` decisions of the fused engine from `state` (B, ...)
        on `traces` (B, K), every tensor on one device: what
        `core.rollout.batch_rollout` runs by default."""
        dev = state.time.device
        key = (dev, state.time.shape[0], num_steps if collect else None,
               impl, _signature(traces), _signature(params))
        loop = self._loops.get(key)
        if loop is None:
            loop = self._loops[key] = _Loop(self.ecfg, self.policy, traces,
                                            params, state, num_steps,
                                            collect, impl, dev)
        return loop.run(traces, params, generator, state, num_steps)

    def __repr__(self):
        s = f", sampler={self.sampler!r}" if self.sampler else ""
        return (f"ActorProgram({getattr(self.policy, '__name__', 'policy')}"
                f"{s})")


@functools.lru_cache(maxsize=None)
def actor_program(ecfg, policy) -> ActorProgram:
    """One `ActorProgram` per (EnvConfig, policy callable), cached for the
    process lifetime."""
    return ActorProgram(ecfg, policy)
