"""In-process edge-serving engine: the paper's Fig.-1 system, executable
(port of `repro/serving/engine.py`).

Components (mirroring the paper's implementation, §VI.A.1, minus Docker
and NCCL):
  * ``ServerPool`` (`serving.pool`) — N logical edge servers; each holds at
    most one loaded model (params on the device). Loading is real work
    (weights drawn on the device); reuse skips it, exactly the cold-start
    economics the paper schedules around.
  * ``ModelExecutor`` (`serving.executor`) — cached zoo models and real
    patch-parallel prefill + decode; on the card every prefill layer
    launches the hand-written flash attention kernel.
  * ``Request`` — an AIGC task: (service/arch id, prompt tokens, patches
    c_k, arrival time). "Inference steps" map to decode steps for LM
    services.
  * ``ServingEngine`` — the host loop: keeps the waiting queue, builds the
    Eq.-6 state from the real pool state through the port's `core.obs`
    path, takes a scheduler action (execute?, steps, task scores),
    gang-allocates c_k servers, runs real prefill + decode on the selected
    model, and reports QoS in the `StreamAggregator` schema
    (`qos_summary`).

The pool and queue state is the host's, so the Eq.-6 mirror is built on
the CPU; the weights, the KV caches and the generation live on `device`.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import env as EV
from repro_torch.core import obs as OBS
from repro_torch.core import timemodel as TM
from repro_torch.core.quality import quality_of
from repro_torch.serving.executor import ModelExecutor
from repro_torch.serving.pool import LogicalServer, ServerPool
from repro_torch.traffic import metrics as MX


@dataclass
class Request:
    rid: int
    arch: str
    prompt: np.ndarray            # (S,) int
    patches: int                  # c_k
    arrive_t: float
    max_new_tokens: int = 16
    # filled on completion
    tokens: Optional[np.ndarray] = None
    start_t: float = 0.0
    finish_t: float = 0.0
    steps: int = 0
    reused: bool = False
    quality: float = 0.0


class ServingEngine:
    """Scheduler actions are vectors in [0,1]^(2+l): [a_c, a_s, scores]."""

    def __init__(self, num_servers: int, archs: List[str], *,
                 queue_window: int = 8, s_min: int = 4, s_max: int = 32,
                 reduced: bool = True, seed: int = 0,
                 time_dilation: float = 0.0, device=None):
        self.device = resolve_device(device)
        self.pool = ServerPool(num_servers)
        self.archs = archs
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.l = queue_window
        self.s_min, self.s_max = s_min, s_max
        self.reduced = reduced
        self.executor = ModelExecutor(reduced=reduced, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.clock = 0.0
        self.n_submitted = 0
        # >0: simulated seconds per Table-VI unit (deterministic virtual
        # time); 0: wall clock.
        self.time_dilation = time_dilation
        self._t0 = time.time()

    # -- time -----------------------------------------------------------
    def now(self) -> float:
        if self.time_dilation:
            return self.clock
        return time.time() - self._t0

    def _advance(self, dt: float):
        if self.time_dilation:
            self.clock += dt

    # -- model management -------------------------------------------------
    def _load(self, server: LogicalServer, arch: str):
        """Draw the server's weights from the engine's generator on the
        device. The old weights are dropped first, so a reload does not
        hold two copies."""
        server.params = None
        server.params = self.executor.init_params(arch, self.generator)
        server.model_name = arch
        self.pool.load_count += 1

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)
        self.n_submitted += 1

    def _mirror(self):
        """Pool/queue state as an (EnvConfig, trace, EnvState) triple with a
        batch of one — the exact inputs of the simulator's Eq.-6 path.
        Queue slots hold the visible requests sorted by arrival; empty task
        slots get arr_time=+inf so they are never queued."""
        now = self.now()
        E = len(self.pool.servers)
        reqs = sorted(self.queue, key=lambda r: r.arrive_t)
        K = max(len(reqs), self.l, 1)
        arr = np.full(K, np.inf, np.float32)
        c = np.ones(K, np.int32)
        model = np.zeros(K, np.int32)
        for j, r in enumerate(reqs):
            arr[j] = r.arrive_t
            c[j] = r.patches
            model[j] = self.archs.index(r.arch) if r.arch in self.archs else 0
        cfg = EV.EnvConfig(num_servers=E, queue_window=self.l, max_tasks=K,
                           num_models=len(self.archs))

        def row(a, dtype):
            return torch.tensor(np.asarray(a)[None], dtype=dtype)

        f32, i32 = torch.float32, torch.int32
        trace = {"arr_time": row(arr, f32), "c": row(c, i32),
                 "model": row(model, i32), "noise": torch.zeros((1, K))}
        servers = self.pool.servers
        midx = [self.archs.index(s.model_name) if s.model_name in self.archs
                else -1 for s in servers]
        zf, zi = torch.zeros((1, K)), torch.zeros((1, K), dtype=i32)
        state = EV.EnvState(
            time=torch.tensor([now], dtype=f32),
            server_free_at=row([s.busy_until for s in servers], f32),
            server_model=row(midx, i32),
            server_gang=row([s.gang for s in servers], i32),
            server_gang_size=row([s.gang_size for s in servers], i32),
            task_status=zi, task_start=zf, task_finish=zf, task_steps=zi,
            task_quality=zf, task_reload=zi,
            steps_taken=torch.zeros((1,), dtype=i32))
        return cfg, trace, state

    def observe(self) -> np.ndarray:
        """Eq.-6 matrix (3, E + l) from the real pool state, through the
        port's shared normalisation path (`core.obs.observe_from`)."""
        cfg, trace, state = self._mirror()
        q = OBS.visible_queue(cfg, trace, state)
        return OBS.observe_from(cfg, trace, state, q)[0].numpy()

    # -- execution ---------------------------------------------------------
    def _generate(self, req: Request, steps: int,
                  servers: List[LogicalServer]):
        """Real patch-parallel prefill + decode on the gang leader's params."""
        req.tokens = self.executor.generate(
            req.arch, servers[0].params, req.prompt, len(servers), steps,
            req.max_new_tokens)

    def try_schedule(self, action: np.ndarray) -> Optional[Request]:
        """One scheduler decision (Algorithm 1 lines 4-31)."""
        action = np.asarray(action)
        now = self.now()
        if action[0] > 0.5 or not self.queue:
            self._advance(1.0)
            return None
        visible = sorted(self.queue, key=lambda r: r.arrive_t)[: self.l]
        scores = action[2: 2 + len(visible)]
        req = visible[int(np.argmax(scores))]
        steps = int(round(self.s_min + float(np.clip(action[1], 0, 1))
                          * (self.s_max - self.s_min)))
        gang = self.pool.find_reusable_gang(req.arch, req.patches, now)
        reused = gang is not None
        if gang is None:
            gang = self.pool.pick_fresh(req.patches, now, arch=req.arch)
            if gang is None:
                self._advance(1.0)
                return None              # infeasible: not enough idle servers
        self.queue.remove(req)
        req.start_t = now
        req.steps = steps
        req.reused = reused
        if not reused:
            for s in gang:
                self._load(s, req.arch)
        else:
            self.pool.reuse_count += 1
            # share the already-loaded params across the gang
            for s in gang[1:]:
                s.params = gang[0].params
        self._generate(req, steps, gang)
        # account busy time with the Table-VI latency model (virtual) or
        # wall clock (real)
        c_t = torch.tensor(req.patches)
        t_model = float(TM.exec_time(c_t, torch.tensor(steps)))
        t_init = 0.0 if reused else float(TM.init_time(c_t))
        busy = (t_model + t_init) if self.time_dilation else (self.now() - now)
        for s in gang:
            s.gang = req.rid
            s.gang_size = req.patches
            s.busy_until = now + busy
        self._advance(busy if self.time_dilation else 0.0)
        req.finish_t = now + busy
        req.quality = float(quality_of(torch.tensor(steps)))
        self.done.append(req)
        return req

    # -- metrics ------------------------------------------------------------
    def qos_summary(self, resp_sla: float = 120.0,
                    q_min: float = 0.23) -> Dict[str, float]:
        """Run-level QoS in the `StreamAggregator` schema (latency
        p50/p95/p99, violation, goodput, cold_start, utilization, ...), the
        keys the simulated streaming backends report."""
        agg = MX.StreamAggregator(len(self.pool.servers), q_min, resp_sla)
        now = self.now()
        resp = np.asarray([r.finish_t - r.arrive_t for r in self.done],
                          np.float64)
        quality = np.asarray([r.quality for r in self.done], np.float64)
        counts = np.zeros(len(MX.DEFAULT_EDGES) + 1, np.int64)
        np.add.at(counts, np.searchsorted(MX.DEFAULT_EDGES, resp), 1)
        viol_q = quality < q_min
        viol_t = resp > resp_sla
        agg.update({
            "n_injected": self.n_submitted,
            "n_sched": len(self.done),
            "n_done": int(sum(r.finish_t <= now for r in self.done)),
            "n_dropped": 0,
            "n_reload": int(sum(not r.reused for r in self.done)),
            "n_viol": int(np.sum(viol_q | viol_t)),
            "n_viol_q": int(np.sum(viol_q)),
            "n_viol_t": int(np.sum(viol_t)),
            "sum_resp": float(resp.sum()),
            "sum_quality": float(quality.sum()),
            "sum_steps": float(sum(r.steps for r in self.done)),
            "busy_time": float(sum(r.patches * (r.finish_t - r.start_t)
                                   for r in self.done)),
            "elapsed": now,
            "hist": counts,
            "max_resp": float(resp.max()) if len(resp) else 0.0,
        })
        out = agg.summary()
        out.update(self.pool.counters())
        out["wall_clock"] = not bool(self.time_dilation)
        return out

    def metrics(self) -> Dict[str, float]:
        """Deprecated ad-hoc metrics dict; use `qos_summary()` (the
        StreamAggregator schema) instead."""
        warnings.warn(
            "ServingEngine.metrics is deprecated; use "
            "ServingEngine.qos_summary (the StreamAggregator QoS schema)",
            DeprecationWarning, stacklevel=2)
        if not self.done:
            return {"completed": 0}
        resp = [r.finish_t - r.arrive_t for r in self.done]
        return {
            "completed": len(self.done),
            "avg_response": float(np.mean(resp)),
            "avg_quality": float(np.mean([r.quality for r in self.done])),
            "reload_rate": 1.0 - self.pool.reuse_count / max(1, len(self.done)),
            "loads": self.pool.load_count,
            "reuses": self.pool.reuse_count,
        }
