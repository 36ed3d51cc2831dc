"""The port's dry-run analysis on the CPU (`launch.dryrun`, `hlo_analysis`,
`roofline`, `augment_roofline`, `reshard`, `mesh.make_production_mesh`,
`steps.lower_case`), against the reference where the reference needs no
compile.

* The shapes table, the pair list, `model_flops`, `dp_degree_for` and
  `analytic_terms` against the reference's, for all 39 pairs and both
  meshes: the analytic terms equal the reference's times the ratio of the
  two sets of hardware constants (its TPU constants are read from
  `repro.launch.mesh` by name), within 1e-12 relative.
* The collective counter on known redistributions of a 4-rank fake world,
  and `roofline_terms` at one second of each term.
* The level of the FLOP count and of the memory peak: per device. A
  matmul split over both axes of a (2, 2) mesh counts a quarter of its
  global FLOPs; a reduced dense LM whose dims all divide the mesh counts,
  times the 4 ranks, its plain meta trace's global FLOPs within 1 %, with
  no reshard; `LocalMemTracker` tracks a product's local shard, not the
  global shape DTensor's propagation runs. `FlopCounterMode`
  itself counts the global shapes too on an op signature DTensor has not
  propagated before (pinned here: why the port counts with a mode of its
  own).
* The reshard policy: a view DTensor refuses (KV heads that do not divide
  `model`) is retried with `model` replicated and keeps the batch's `data`
  shard; an op with no sharding rule runs locally on replicated operands.
* The attention split over `model`: a reduced GQA LM (8 heads over 2 KV
  heads) on a (2, 4) mesh, train and prefill, counts a device's attention
  FLOPs as an eighth of its plain global trace's, within 1 %, and reshards
  at most K's and V's head views, two a layer and forward pass.
* The CLI in a subprocess on the 512-rank mesh; both CLIs on tinyllama-1.1b
  prefill_32k: the port's peak within 16x the reference's compiled peak.
* The KV write past a cache's end: the reference clamps it into the last
  slot, the port raises.

Every fake process group is destroyed by its fixture, so the next test of
the worker starts with none.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.common import config as JCFG
from repro.launch import augment_roofline as JAUG
from repro.launch import mesh as JMX
from repro.launch import roofline as JRF
from repro.launch import shapes as JSH
from repro.models import blocks as JB
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.launch import augment_roofline as TAUG
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import mesh as TMX
from repro_torch.launch import roofline as TRF
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.launch.reshard import ReshardPolicy
from repro_torch.models import blocks as TB
from repro_torch.sharding.specs import NamedSharding

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _xla_flags_kept():
    """`repro.launch.dryrun` sets XLA_FLAGS when imported; put them back so
    no later jax start in this worker sees 512 host devices."""
    old = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _ref_model_flops():
    with _xla_flags_kept():
        from repro.launch.dryrun import model_flops
    return model_flops


# ------------------------------------------------------------ the tables
def test_shapes_and_pairs_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in TSH.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSH.SHAPES.items()}
    pairs = TSH.pair_list()
    assert pairs == JSH.pair_list() and len(pairs) == 39
    for arch in TCFG.ASSIGNED_ARCHS:
        for s in TSH.SHAPES:
            t = TSH.adapt_config(TCFG.get_config(arch), TSH.SHAPES[s])
            j = JSH.adapt_config(JCFG.get_config(arch), JSH.SHAPES[s])
            assert (t is None) == (j is None), (arch, s)
            if t is not None:
                assert t.sliding_window == j.sliding_window, (arch, s)


def test_model_flops_match_reference():
    jmf = _ref_model_flops()
    for arch, s in TSH.pair_list():
        t = TDR.model_flops(TSH.adapt_config(TCFG.get_config(arch),
                                             TSH.SHAPES[s]), TSH.SHAPES[s])
        j = jmf(JSH.adapt_config(JCFG.get_config(arch), JSH.SHAPES[s]),
                JSH.SHAPES[s])
        assert t == j, (arch, s)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dp_degree_matches_reference(mesh):
    assert TAUG.MESH_DEVS == JAUG.MESH_DEVS
    for s in TSH.SHAPES:
        assert TAUG.dp_degree_for(s, mesh) == JAUG.dp_degree_for(s, mesh)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_analytic_terms_match_reference_up_to_constants(mesh):
    ratio = {
        "a_compute_s": JMX.PEAK_FLOPS_BF16 / TMX.PEAK_FLOPS_BF16,
        "a_memory_s": JMX.HBM_BW / TMX.HBM_BW,
        "a_collective_s": JMX.ICI_BW * 4 / (TMX.LINK_BW * TMX.NUM_LINKS),
    }
    for arch, s in TSH.pair_list():
        shape = TSH.SHAPES[s]
        n, dp = TAUG.MESH_DEVS[mesh], TAUG.dp_degree_for(s, mesh)
        t = TRF.analytic_terms(TSH.adapt_config(TCFG.get_config(arch),
                                                shape), shape, n, dp)
        j = JRF.analytic_terms(JSH.adapt_config(JCFG.get_config(arch),
                                                JSH.SHAPES[s]),
                               JSH.SHAPES[s], n, dp)
        assert set(t) == set(j), (arch, s)
        for key, jv in j.items():
            if key in ("a_bottleneck", "a_fits_hbm"):
                continue
            want = jv * ratio.get(key, 1.0)
            assert t[key] == pytest.approx(want, rel=1e-12), (arch, s, key)
        assert t["a_bottleneck"] == max(
            ("compute", "memory", "collective"),
            key=lambda k: t[f"a_{k}_s"])
        assert t["a_fits_hbm"] == (t["a_resident_bytes_dev"]
                                   < TMX.HBM_PER_DEVICE * 0.9)


def test_roofline_terms_one_second_each():
    coll = {"total": TMX.LINK_BW * TMX.NUM_LINKS}
    terms = HA.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12},
                              coll)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    assert terms["collective_s"] == pytest.approx(1.0)
    assert terms["bottleneck"] in ("compute", "memory", "collective")
    assert HA.roofline_terms({"flops": 1.0}, {}, num_links=1)[
        "bottleneck"] == "compute"


# ------------------------------------------------------- fake worlds
@pytest.fixture
def fake_world():
    """make(shape, names) -> a DeviceMesh on "cpu" over a fresh fake
    process group; destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape, names):
        dist.init_process_group("fake", world_size=math.prod(shape), rank=0,
                                store=FakeStore())
        return init_device_mesh("cpu", shape, mesh_dim_names=names)
    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_production_mesh(fake_world):
    assert not dist.is_initialized()          # importing touched nothing
    mesh = TMX.make_production_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (16, 16) and dist.get_world_size() == 256
    assert TMX.make_production_mesh().size() == 256    # the same group
    with pytest.raises(ValueError, match="256 ranks exists"):
        TMX.make_production_mesh(multi_pod=True)


def test_collective_counter_bytes_by_kind(fake_world):
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = fake_world((2, 2), ("data", "model"))
    f32 = dict(dtype=torch.float32, device="meta")
    comm = HA.CollectiveCounter()
    with comm:
        # all-gather: (8, 16) split over data -> replicated, (8, 16) out
        x = distribute_tensor(torch.empty(8, 16, **f32), mesh,
                              [Shard(0), Replicate()])
        x.redistribute(mesh, [Replicate(), Replicate()])
        # all-reduce: a partial sum of (8, 16) over model
        p = DTensor.from_local(torch.empty(8, 16, **f32), mesh,
                               [Replicate(), Partial()], run_check=False)
        p.redistribute(mesh, [Replicate(), Replicate()])
        # reduce-scatter: a partial sum of (8, 16) into rows over model
        p.redistribute(mesh, [Replicate(), Shard(0)])
    cb = HA.collective_bytes({"coll_bytes": comm.coll_bytes,
                              "coll_ops": comm.coll_ops})
    assert cb == {"all-gather": 8 * 16 * 4.0, "all-reduce": 8 * 16 * 4.0,
                  "reduce-scatter": 4 * 16 * 4.0,
                  "total": (8 + 8 + 4) * 16 * 4.0, "ops": 3}
    assert sum(comm.get_comm_counts().values()) == 3


def _matmul_case(mesh, m=64, k=96, n=128):
    meta = dict(dtype=torch.float32, device="meta")
    return TST.Case(fn=lambda a, b: a @ b,
                    arg_structs=(torch.empty(m, k, **meta),
                                 torch.empty(k, n, **meta)),
                    in_shardings=(NamedSharding(mesh, ("data", None)),
                                  NamedSharding(mesh, (None, "model"))),
                    out_shardings=None, donate_argnums=(), cfg=None)


def test_hlo_flops_are_per_device(fake_world):
    mesh = fake_world((2, 2), ("data", "model"))
    rec = HA.analyze(TST.lower_case(_matmul_case(mesh), mesh))
    assert rec["hlo_flops"] == 2 * 64 * 96 * 128 / 4
    assert rec["reshards"] == {} and rec["collectives"]["ops"] == 0
    # bytes: the local operands and result, once each
    assert rec["hlo_bytes"] == 4 * (32 * 96 + 96 * 64 + 32 * 64)
    assert rec["memory"]["argument_bytes"] == 4 * (32 * 96 + 96 * 64)
    assert rec["memory"]["temp_bytes"] == 4 * 32 * 64      # the product
    assert rec["peak_device_bytes"] == 4 * (32 * 96 + 96 * 64 + 32 * 64)


def test_local_mem_tracker_counts_the_local_shards(fake_world):
    """A product of a (64, 96) DTensor split over both axes of (2, 2):
    `LocalMemTracker` counts its (32, 48) local output, not the global
    shape DTensor's sharding propagation runs (tracked by torch 2.11's own
    MemTracker)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = fake_world((2, 2), ("data", "model"))
    x = distribute_tensor(torch.empty(64, 96, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    mem = HA.LocalMemTracker()
    with mem:
        y = x * 2.0 + 1.0
    assert tuple(y.to_local().shape) == (32, 48)
    peak = sum(d["Total"] for d in mem.get_tracker_snapshot("peak").values())
    assert peak == 2 * 32 * 48 * 4


def test_flop_counter_mode_counts_global_on_a_fresh_signature(fake_world):
    """Why `LocalCounter` exists: under `CommDebugMode`, FlopCounterMode
    counts a DTensor matmul's local FLOPs plus, the first time DTensor
    propagates that op signature, its global FLOPs (the FakeTensor run of
    the propagation)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    mesh = fake_world((2, 2), ("data", "model"))
    m, k, n = 72, 88, 104               # a signature no other test uses
    a = distribute_tensor(torch.empty(m, k, device="meta"), mesh,
                          [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty(k, n, device="meta"), mesh,
                          [Replicate(), Shard(1)])
    counts = []
    for _ in range(2):
        f = FlopCounterMode(display=False)
        with f, CommDebugMode():
            torch.mm(a, b)
        counts.append(f.get_total_flops())
    glob = 2 * m * k * n
    assert counts == [glob + glob // 4, glob // 4]


def _reduced(arch, **kw):
    return dataclasses.replace(TCFG.get_config(arch).reduced(), **kw)


def _plain_flops(case) -> int:
    local = HA.LocalCounter()
    with local:
        case.fn(*case.arg_structs)
    return sum(local.flops.values())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_lm_flops_split_evenly(fake_world, kind):
    """tinyllama reduced (heads 4, KV 4, d_ff 512, vocab 1024, 2 layers):
    every sharded dim divides a (2, 2) mesh, so each rank does a quarter
    of the global matmul FLOPs and nothing is resharded."""
    mesh = fake_world((2, 2), ("data", "model"))
    cfg = _reduced("tinyllama-1.1b")
    shape = TSH.ShapeSpec("s", kind, 64, 4)
    case = TST.build_case(cfg, shape, mesh, impl="ref")
    rec = HA.analyze(TST.lower_case(case, mesh))
    glob = _plain_flops(TST.build_case(cfg, shape, mesh, impl="ref"))
    assert rec["hlo_flops"] * 4 == pytest.approx(glob, rel=0.01)
    assert rec["reshards"] == {} and rec["shards_dropped"] == {}
    assert rec["collectives"]["total"] > 0
    # train and prefill gather the weights; a decode step (2 tokens a
    # device) keeps them on their shards (`reshard.matmul_partition`)
    assert rec["policy"]["matmul_weight_stationary" if kind == "decode"
                         else "matmul_right_replicated"]


def test_reshard_keeps_the_batch_shard(fake_world):
    """2 KV heads on a `model` axis of 4: the K / V head split is refused,
    retried with `model` replicated, and the batch stays split over
    `data`. A decode step refuses two views a layer, K's and V's head
    split: the query's GQA split of its 4 heads into (2, 2) runs on each
    device's T slice of the cache (`sharding.context.on_seq_shards`), on
    local tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_world((2, 4), ("data", "model"))
    k = distribute_tensor(torch.empty(4, 1, 128, device="meta"), mesh,
                          [Shard(0), Shard(2)])
    policy = ReshardPolicy(dp_dims=(0,))
    with policy:
        out = k.view(4, 1, 2, 64)
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert policy.reshards == {"aten.view.default": 1}
    # the same through a decode case: every layer's K and V split
    cfg = _reduced("qwen2-1.5b")
    assert cfg.num_kv_heads == 2
    case = TST.build_case(cfg, TSH.ShapeSpec("d", "decode", 64, 4), mesh,
                          impl="ref")
    rec = HA.analyze(TST.lower_case(case, mesh))
    assert rec["reshards"] == {"aten.view.default": 2 * cfg.num_layers}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_attention_splits_over_model(fake_world, kind):
    """tinyllama reduced to 8 query heads over 2 KV heads, S = 1024 (two
    query blocks), on (2, 4): a device runs its batch half and its 2 heads
    of every attention block, an eighth of the plain global trace's
    attention FLOPs (`aten.bmm`); K's and V's head views (2 KV heads over
    4) are the only reshards, two a layer and forward pass (the train
    step's remat runs each layer's forward twice)."""
    mesh = fake_world((2, 4), ("data", "model"))
    cfg = _reduced("tinyllama-1.1b", num_heads=8, num_kv_heads=2,
                   head_dim=32)
    shape = TSH.ShapeSpec("s", kind, 1024, 4)
    rec = HA.analyze(TST.lower_case(
        TST.build_case(cfg, shape, mesh, impl="ref"), mesh))
    local = HA.LocalCounter()
    case = TST.build_case(cfg, shape, mesh, impl="ref")
    with local:
        case.fn(*case.arg_structs)
    assert rec["flops_by_op"]["aten.bmm"] * 8 == pytest.approx(
        local.flops["aten.bmm"], rel=0.01)
    passes = 2 if kind == "train" else 1
    assert set(rec["reshards"]) <= {"aten.view.default"}, rec["reshards"]
    assert sum(rec["reshards"].values()) <= 2 * passes * cfg.num_layers
    assert rec["shards_dropped"] == {}


def test_reshard_policy_local_rule_and_plain_tensors(fake_world):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    mesh = fake_world((2, 2), ("data", "model"))
    idx = distribute_tensor(torch.tensor([0, 2, 2, 5]), mesh,
                            [Replicate(), Replicate()])
    x = distribute_tensor(torch.arange(8.0).reshape(4, 2), mesh,
                          [Shard(0), Replicate()])
    policy = ReshardPolicy(dp_dims=(0,))
    with policy:
        counts = torch.bincount(idx, minlength=7)     # no sharding rule
        y = x + torch.ones(4, 2)                      # a plain tensor
    assert isinstance(counts, DTensor)
    assert counts.to_local().tolist() == [1, 0, 2, 0, 0, 1, 0]
    assert policy.reshards == {
        "aten.bincount.default [local, replicated operands]": 1}
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert policy.record()["policy"]["plain_tensors_replicated"] == 1


def test_moe_fixed_shape_dispatch_matches_sorted():
    """The dry-run's MoE path (a meta tensor takes it) computes the sorted
    dispatch's output, drops included."""
    cfg = TCFG.get_config("olmoe-1b-7b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = TB.init_moe(gen, cfg, cfg.moe)
    x = torch.randn(3, 37, cfg.d_model, generator=gen)
    e, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    probs = torch.softmax(TB.linear(p["router"], x).float(), -1)
    topw, topi = torch.topk(probs, k, -1)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    outs = []
    for cf in (1.25, 0.5):
        cap = max(1, min(37, math.ceil(37 * k / e * cf)))
        y, _ = TB.moe_apply(p, cfg, cfg.moe, x, capacity_factor=cf)
        torch.testing.assert_close(TB._moe_buffers(p, x, topi, topw, e, cap),
                                   y, rtol=1e-5, atol=1e-6)
        outs.append(y)
    assert not torch.equal(outs[0], outs[1])           # 0.5 drops some
    meta = lambda t: t.to("meta")                      # noqa: E731
    ym, aux = TB.moe_apply({n: {kk: meta(v) for kk, v in w.items()}
                            if isinstance(w, dict) else meta(w)
                            for n, w in p.items()}, cfg, cfg.moe, meta(x))
    assert ym.shape == x.shape and ym.is_meta and aux.shape == ()


# ------------------------------------------------------------------ CLI
def test_dryrun_cli_one_case(tmp_path):
    """The CLI on the 512-rank mesh, as the reference's slow test runs its
    own (here in ~15 s)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-125m", "--shape", "decode_32k", "--mesh", "multi",
         "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert "1 ok, 0 skipped, 0 errors / 1 cases" in out.stdout, \
        out.stdout[-2000:] + out.stderr[-2000:]
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__multi.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 512
    assert rec["hlo_flops"] > 0
    for key in ("reshards", "useful_flop_ratio", "trace_s", "a_compute_s",
                "a_fits_hbm", "collectives", "peak_device_bytes"):
        assert key in rec, key


def test_prefill_peak_within_16x_the_reference(tmp_path):
    """tinyllama-1.1b prefill_32k on the 256-rank mesh through both CLIs:
    the port's `peak_device_bytes` (its argument shards plus MemTracker's
    peak) at most 16x the reference's compiled peak (XLA's memory stats)."""
    peaks = {}
    for pkg in ("repro", "repro_torch"):
        out = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch",
             "tinyllama-1.1b", "--shape", "prefill_32k", "--mesh", "single",
             "--out", str(tmp_path / pkg)],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     JAX_PLATFORMS="cpu"))
        assert "1 ok, 0 skipped, 0 errors / 1 cases" in out.stdout, \
            out.stdout[-2000:] + out.stderr[-2000:]
        rec = json.loads((tmp_path / pkg / "tinyllama-1.1b__prefill_32k__"
                          "single.json").read_text())
        peaks[pkg] = rec["peak_device_bytes"]
    assert 0 < peaks["repro_torch"] <= 16 * peaks["repro"], peaks


# ------------------------------------------------------------ KV overrun
def test_kv_write_past_the_end_reference_clamps_port_raises():
    """A 4-slot cache (not a ring), a token at pos == 4: the reference's
    `dynamic_update_slice_in_dim` clamps the write into slot 3; the port
    raises a ValueError naming the position and the capacity."""
    jcfg = JCFG.get_config("tinyllama-1.1b").reduced()
    tcfg = TCFG.get_config("tinyllama-1.1b").reduced()
    B, T, hd, kv = 2, 4, jcfg.resolved_head_dim, jcfg.num_kv_heads
    jp = JB.init_attn(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).standard_normal(
        (B, 1, jcfg.d_model)).astype(np.float32)
    cache = {"k": jnp.zeros((B, T, kv, hd), jnp.float32),
             "v": jnp.zeros((B, T, kv, hd), jnp.float32)}
    _, jc = JB.attn_decode(jp, jcfg, jnp.asarray(x), cache, jnp.int32(T))
    pos = jnp.full((B, 1), T, jnp.int32)
    _, k, v = JB._qkv(jp, jcfg, jnp.asarray(x), pos)
    np.testing.assert_array_equal(np.asarray(jc["k"][:, T - 1]),
                                  np.asarray(k[:, 0]))
    np.testing.assert_array_equal(np.asarray(jc["v"][:, T - 1]),
                                  np.asarray(v[:, 0]))
    assert not np.asarray(jc["k"][:, :T - 1]).any()

    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    tcache = {"k": torch.zeros(B, T, kv, hd), "v": torch.zeros(B, T, kv, hd)}
    with pytest.raises(ValueError, match=r"position 4 into a cache of 4"):
        TB.attn_decode(tp, tcfg, torch.from_numpy(x), tcache, T)
    assert not tcache["k"].any()                 # nothing written
    TB.attn_decode(tp, tcfg, torch.from_numpy(x), tcache, T - 1)
    assert tcache["k"][:, T - 1].any() and not tcache["k"][:, :T - 1].any()
