"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes and record FLOPs, bytes, collectives, reshards and the
roofline terms (port of `repro/launch/dryrun.py`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out artifacts/dryrun_torch

A host analysis by nature, as the reference's is (it forces 512 host
devices): each case's arguments are meta tensors (shapes, no storage)
placed as DTensors on a `DeviceMesh` over a fake process group of 256 or
512 ranks (`launch.mesh.make_production_mesh`), and the step runs once,
eagerly, on the CPU under the counting modes (`launch.hlo_analysis`) and
the reshard policy (`launch.reshard`). No kernel runs and no device memory
is touched: the steps take the plain attention and scan (`impl="ref"`), as
the reference's dry-run traces its jnp paths. Where the reference lowers
and compiles (`lower_s`, `compile_s`), a record has `trace_s`. The
recurrences (Jamba's Mamba scan, xLSTM's mLSTM and sLSTM) trace two steps
and count the second for the rest, as XLA counts a `lax.scan`'s body once
(`sharding.loops`); `loops_scaled` names each with its loops and trip
count. A trace that runs past `TRACE_BUDGET_S` seconds stops with an error
that names the model line it reached.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.common.config import ASSIGNED_ARCHS, get_config
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch.augment_roofline import MESH_DEVS, dp_degree_for
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analytic_terms
from repro_torch.launch.shapes import SHAPES, adapt_config
from repro_torch.launch.steps import build_case, lower_case

# seconds a case's trace may take: every case takes at most ~85 s on one
# CPU core with torch 2.13; the Jamba and xLSTM train / prefill cases, were
# their per-token loops not scaled, would take hours
TRACE_BUDGET_S = 120.0


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            budget_s: float = float("inf"), **case_kw):
    shape = SHAPES[shape_name]
    base_cfg = get_config(arch)
    cfg = adapt_config(base_cfg, shape)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "total_s": 0.0,
                "reason": "pair skipped per DESIGN.md §4 (enc-dec @ 500k)"}
    import torch.distributed as dist
    created = not dist.is_initialized()
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        n_dev = mesh.size()
        rec["devices"] = n_dev
        rec.update(analytic_terms(cfg, shape, MESH_DEVS[mesh_kind],
                                  dp_degree_for(shape_name, mesh_kind)))
        case = build_case(base_cfg, shape, mesh, impl="ref", **case_kw)
        analysis = HA.analyze(lower_case(case, mesh, budget_s=budget_s))
        rec.update(analysis)
        mf = model_flops(case.cfg, shape)
        rec["model_flops_global"] = mf
        per_dev = analysis["hlo_flops"]
        rec["model_flops_per_device"] = mf / n_dev
        rec["useful_flop_ratio"] = (mf / n_dev) / per_dev if per_dev else 0.0
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches for train shapes")
    ap.add_argument("--tp-inference", action="store_true",
                    help="replicate weights over the data axis for "
                         "prefill/decode (tensor-parallel only, no per-step "
                         "FSDP all-gathers)")
    ap.add_argument("--resume", action="store_true",
                    help="skip pairs whose artifact JSON already has status ok/skipped")
    args = ap.parse_args()

    archs = list(ASSIGNED_ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                tag = f"{arch}__{shape}__{mk}"
                path = os.path.join(args.out, tag + ".json")
                if args.resume and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        results.append(prev)
                        print(f"--- {tag}: cached ({prev['status']})", flush=True)
                        continue
                print(f"=== {tag} ===", flush=True)
                rec = run_one(arch, shape, mk, budget_s=TRACE_BUDGET_S,
                              remat=not args.no_remat,
                              microbatches=args.microbatches,
                              tp_inference=args.tp_inference)
                results.append(rec)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                status = rec["status"]
                extra = (f" flops/dev={rec.get('hlo_flops', 0):.3e}"
                         f" coll={rec.get('collective_bytes', 0):.3e}B"
                         f" bottleneck={rec.get('bottleneck', '-')}"
                         f" reshards={sum(rec.get('reshards', {}).values())}"
                         if status == "ok" else rec.get("error", ""))
                print(f"--- {tag}: {status} ({rec['total_s']}s){extra}",
                      flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n{n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} errors / {len(results)} cases")
    return results


if __name__ == "__main__":
    main()
