"""Grid sweeps on the `repro_torch.api` facade (port of
`repro/traffic/sweep.py`): (scenario cell x policy) streaming runs with QoS
telemetry rows, JSON output, and wall-clock throughput.

A cell is a `core.scenarios.Scenario`; its `arrival` field selects the
open-loop process (None falls back to Poisson at the cell's tcfg rate). Each
(cell, policy) pair is one `api.Simulator` streaming run — `num_windows`
windows of `window_tasks` tasks over `num_streams` parallel streams on the
chosen execution backend — so a default sweep covers >= 10^5 tasks per
policy at O(window) memory. Every row carries `trained` (weight
provenance) and `exec_backend`, in the reference's schema.

The (cell ci, policy pi) run takes child pi of `split_generator(child ci
of split_generator(generator, len(cells)), len(policies))`, where the
reference folds `ci` and then `pi` into its key.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.api import (ExecSpec, PolicySpec, Simulator, WorkloadSpec,
                             resolve_cell)
from repro_torch.api.simulator import split_generator
from repro_torch.common.device import resolve_device
from repro_torch.core.scenarios import Scenario
from repro_torch.traffic.stream import StreamConfig

__all__ = ["resolve_cell", "run_cell", "run_sweep"]


def _workload(sc: Scenario, stream: StreamConfig,
              window_tasks: Optional[int]) -> WorkloadSpec:
    return WorkloadSpec.streaming(
        sc, streams=stream.num_streams, num_windows=stream.num_windows,
        window_tasks=window_tasks,
        max_steps_per_window=stream.max_steps_per_window,
        max_carry=stream.max_carry, resp_sla=stream.resp_sla,
        chunk_size=stream.chunk_size)


def run_cell(sc: Scenario, policy_name: str, generator, *,
             stream: StreamConfig = StreamConfig(),
             window_tasks: Optional[int] = None,
             checkpoint: Optional[str] = None, seed: int = 0,
             exec_spec: ExecSpec = ExecSpec(), device=None) -> Dict:
    """One (cell, policy) streaming run -> flat telemetry row.

    `exec_spec` picks the execution backend; a pre-facade caller's explicit
    ``StreamConfig(fused=False)`` still selects the unfused engine when
    `exec_spec` is left at its default."""
    if not stream.fused and exec_spec == ExecSpec():
        exec_spec = ExecSpec(backend="reference")
    sim = Simulator(_workload(sc, stream, window_tasks), exec_spec,
                    device=device)
    res = sim.run(PolicySpec(name=policy_name, checkpoint=checkpoint,
                             seed=seed), generator)
    row = res.row()
    row["tasks_per_wall_s"] = (row["tasks_injected"]
                               / max(row["wall_s"], 1e-9))
    return row


def run_sweep(cells: Sequence[Scenario], policy_names: Sequence[str],
              generator, *, stream: StreamConfig = StreamConfig(),
              window_tasks: Optional[int] = None,
              checkpoint: Optional[str] = None,
              exec_spec: ExecSpec = ExecSpec(),
              out: Optional[str] = None, verbose: bool = True,
              device=None) -> List[Dict]:
    """Sweep the (cell x policy) grid; optionally dump rows to JSON.
    `generator` is a `torch.Generator` or an int seed."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    rows = []
    for sc, g_cell in zip(cells, split_generator(generator, len(cells), dev)):
        for pname, g in zip(policy_names,
                            split_generator(g_cell, len(policy_names), dev)):
            row = run_cell(sc, pname, g, stream=stream,
                           window_tasks=window_tasks, checkpoint=checkpoint,
                           exec_spec=exec_spec, device=dev)
            rows.append(row)
            if verbose:
                flag = "" if row["trained"] else " [UNTRAINED]"
                print(f"[{row['cell']:>18s} | {pname:>6s}{flag}] "
                      f"tasks={row['tasks_injected']:7d} "
                      f"p50={row['latency_p50']:8.1f}s "
                      f"p99={row['latency_p99']:8.1f}s "
                      f"viol={row['qos_violation_rate']:.3f} "
                      f"util={row['utilization']:.2f} "
                      f"goodput={row['goodput_per_s']:.3f}/s "
                      f"wall={row['wall_s']:6.1f}s "
                      f"({row['tasks_per_wall_s']:8.0f} tasks/s)",
                      flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
        if verbose:
            print(f"wrote {len(rows)} rows -> {out}")
    return rows
