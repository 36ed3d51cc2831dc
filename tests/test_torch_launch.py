"""The port's launch layer on the CPU, against the reference: the input
shapes (`launch.shapes`), the partition rules (`sharding.specs`), the
activation-sharding context (`sharding.context`), the step builders
(`launch.steps`) and the serving CLI (`launch.serve`).

The partition rules read only axis names and sizes, so both sides are
asked on plain shapes (1 x 1, 16 x 16, 2 x 16 x 16) for every parameter
and cache path of the ten assigned archs, reduced: the reference through
an object with its mesh's `shape` mapping, which is all its rules read.
Weights are drawn by the reference and carried across as numpy through
`params_from_jax`; batches come from numpy seeds. Tolerances:

* a train step with fp32 compute: the loss at 1e-5 relative, every param
  leaf at 1e-5 absolute (one Adam step at lr 1e-4 moves an entry by at
  most ~1e-4); with the default bf16 compute the reference test's bounds
  (`tests/test_perf_paths.py`: loss 2e-3 relative, params 5e-3
  absolute);
* prefill and decode logits (fp32 compute, bf16 caches) within 1e-3 of
  their largest magnitude;
* the specs, shapes and the CLI's printed records exactly.
"""
import dataclasses
import functools
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JCFG
from repro.common.pytree import tree_paths as jtree_paths
from repro.launch import mesh as JMX
from repro.launch import shapes as JSH
from repro.launch import steps as JST
from repro.models.zoo import build_model as jbuild
from repro.serving.executor import ModelExecutor as JExecutor
from repro.sharding import specs as JSP
from repro.training.optimizer import adam_init as jadam_init
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import tree_leaves, tree_paths
from repro_torch.launch import mesh as TMX
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.models import lm as TLM
from repro_torch.models.zoo import build_model as tbuild
from repro_torch.serving.engine import ServingEngine
from repro_torch.sharding import context as TCTX
from repro_torch.sharding import specs as TSP
from repro_torch.training.optimizer import adam_init as tadam_init

ROOT = Path(__file__).resolve().parents[1]
MESH_SHAPES = {"1x1": {"data": 1, "model": 1},
               "16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCH = "tinyllama-1.1b"
JAMBA = "jamba-v0.1-52b"


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = JCFG.get_config(arch).reduced()
    return jbuild(cfg).init(jax.random.PRNGKey(0))


def _sharding_paths(tree, prefix=""):
    """{'a/b/c': NamedSharding} of a tree whose leaves are the port's
    NamedShardings (a NamedTuple, so not walked into)."""
    if isinstance(tree, TSP.NamedSharding):
        return {prefix: tree}
    items = (sorted(tree.items()) if isinstance(tree, dict) else
             zip(getattr(tree, "_fields", range(len(tree))), tree))
    out = {}
    for k, v in items:
        out.update(_sharding_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _entries(spec):
    """A spec's entries as a tuple, a one-axis group as its axis name
    (jax's PartitionSpec stores ('data',) as 'data'; both mean one axis)."""
    def one(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(one(e) for e in spec)


# ---------------------------------------------------------------- shapes
def test_shapes_pairs_and_adapt_config_match_reference():
    assert list(TSH.SHAPES) == list(JSH.SHAPES)
    for name, s in TSH.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSH.SHAPES[name])
    assert TSH.SLIDING_WINDOW_LONG == JSH.SLIDING_WINDOW_LONG
    pairs = TSH.pair_list()
    assert pairs == JSH.pair_list() and len(pairs) == 39
    for arch in TCFG.ASSIGNED_ARCHS:
        for name in TSH.SHAPES:
            t = TSH.adapt_config(TCFG.get_config(arch), TSH.SHAPES[name])
            j = JSH.adapt_config(JCFG.get_config(arch), JSH.SHAPES[name])
            assert (t is None) == (j is None), (arch, name)
            if t is not None:
                assert dataclasses.asdict(t) == dataclasses.asdict(j), \
                    (arch, name)


# ------------------------------------------------------- partition rules
def _path_shapes(tree):
    return {p: tuple(getattr(v, "shape", ())) for p, v in tree.items()}


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
def test_partition_rules_match_reference(mesh_name):
    sizes = MESH_SHAPES[mesh_name]
    jmesh = SimpleNamespace(shape=dict(sizes))
    assert TSP.PARAM_RULES == JSP.PARAM_RULES
    for batch in (1, 2, 3, 16, 32, 128, 256, 512):
        assert TSP.batch_spec(sizes, batch) == JSP.batch_spec(jmesh, batch)
    n_paths = 0
    for arch in TCFG.ASSIGNED_ARCHS:
        tcfg = TCFG.get_config(arch).reduced()
        jcfg = JCFG.get_config(arch).reduced()
        tm, jm = tbuild(tcfg), jbuild(jcfg)
        tparams = tree_paths(tm.init(None, device="meta"))
        jparams = jtree_paths(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        assert _path_shapes(tparams) == _path_shapes(jparams), arch
        shard = _sharding_paths(TSP.tree_shardings(
            tm.init(None, device="meta"), sizes))
        assert sorted(shard) == sorted(jparams)
        for path, leaf in jparams.items():
            want = _entries(JSP.spec_for(path, leaf.shape, jmesh))
            assert TSP.spec_for(path, leaf.shape, sizes) == want, (arch, path)
            assert shard[path] == TSP.NamedSharding(sizes, want)
        # caches: batch over the dp axes, sequence over the others
        tcache = tree_paths(tm.make_cache(4, 32, device="meta"))
        jcache = jtree_paths(jax.eval_shape(
            functools.partial(jm.make_cache, 4, 32, jnp.bfloat16)))
        assert _path_shapes(tcache) == _path_shapes(jcache), arch
        dp = JSP.batch_spec(jmesh, 4)
        seq = tuple(a for a in ("pod", "data", "model")
                    if a in sizes and a not in dp)
        for args in ((dp or None, seq or None), ("data", "model"),
                     (None, None)):
            rules = TSP.cache_rules(*args)
            assert rules == JSP.cache_rules(*args)
            for path, leaf in jcache.items():
                want = _entries(JSP.spec_for(path, leaf.shape, jmesh,
                                             rules=rules))
                assert _entries(TSP.spec_for(path, leaf.shape, sizes,
                                             rules=rules)) == want, \
                    (arch, path, args)
        n_paths += len(jparams) + len(jcache)
    assert n_paths > 300


def test_specs_read_meshes_and_placements():
    mesh = TMX.make_debug_mesh(2, 3, device="cpu")
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    assert TSP.mesh_shape(mesh) == {"data": 2, "model": 3}
    assert TSP.spec_for("periods/blk0_attn/wq/w", (4, 8, 9), mesh) == \
        (None, "data", "model")
    assert TSP.spec_for("periods/blk0_attn/wq/w", (4, 8, 10), mesh) == \
        (None, "data")                      # 10 % 3: replicated, trimmed
    data = TMX.make_data_mesh(4, device="cpu")
    assert data.shape == {"data": 4} and data.devices == (
        torch.device("cpu"),) * 4
    assert TMX.make_data_mesh(device="cpu").size == 1
    assert TMX.make_data_mesh(["cpu", "cpu"], axis="x").shape == {"x": 2}
    with pytest.raises(ValueError, match="needs 4 devices"):
        TMX.Mesh((torch.device("cpu"),) * 3, ("data", "model"), (2, 2))

    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert TSP.to_placements((("pod", "data"), None, "model"), names) == \
        [Shard(0), Shard(0), Shard(2)]
    assert TSP.to_placements((), names) == [Replicate()] * 3
    assert TSP.to_placements((None, "data"), ("data",)) == [Shard(1)]
    with pytest.raises(ValueError, match="splits two dims"):
        TSP.to_placements(("data", "data"), names)
    with pytest.raises(ValueError, match="not one of"):
        TSP.to_placements(("seq",), names)


# --------------------------------------------------- activation context
@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def test_constrain_unarmed_and_plain_pass_through():
    x = torch.randn(2, 3, 4)
    assert TCTX.constrain(x) is x and TCTX.constrain_moe(x[None]) is not None
    sh = TSP.NamedSharding({"data": 1}, ("data", None, None))
    with TCTX.activation_sharding(sh, sh):
        assert TCTX.constrain(x) is x               # not a DTensor
        assert TCTX.constrain(x[0]) is not None
    assert TCTX._ACT_SHARDING.get() is None and TCTX._MOE_SHARDING.get() is None


def test_constrain_redistributes_a_dtensor(one_rank_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = one_rank_group
    x = distribute_tensor(torch.randn(2, 3, 4), mesh, [Replicate(),
                                                       Replicate()])
    e = distribute_tensor(torch.randn(2, 4, 3, 5), mesh, [Replicate(),
                                                          Replicate()])
    assert TCTX.constrain(x) is x
    act = TSP.NamedSharding(mesh, (("data",), None, None))
    moe = TSP.NamedSharding(mesh, ("data", "model", None, None))
    with TCTX.activation_sharding(act, moe):
        y = TCTX.constrain(x)
        f = TCTX.constrain_moe(e)
        assert TCTX.constrain_moe(x) is x           # rank 3: not an expert buffer
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert tuple(f.placements) == (Shard(0), Shard(1))
    torch.testing.assert_close(y.full_tensor(), x.full_tensor(), rtol=0,
                               atol=0)


# ----------------------------------------------------------- step builders
def test_input_specs_and_case_structs_match_reference():
    jmesh = JMX.make_debug_mesh(1, 1)
    tmesh = TMX.make_debug_mesh(1, 1, device="cpu")
    for arch, name in TSH.pair_list():
        tcfg = TCFG.get_config(arch).reduced()
        jcfg = JCFG.get_config(arch).reduced()
        ts = TST.input_specs(TSH.adapt_config(tcfg, TSH.SHAPES[name]),
                             TSH.SHAPES[name])
        js = JST.input_specs(JSH.adapt_config(jcfg, JSH.SHAPES[name]),
                             JSH.SHAPES[name])
        assert sorted(ts) == sorted(js), (arch, name)
        for k in js:
            assert ts[k].is_meta and tuple(ts[k].shape) == js[k].shape
            assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype)
    # a whole case's argument structs and input shardings, one per kind
    for name in TSH.SHAPES:
        shape = dataclasses.replace(TSH.SHAPES[name], seq_len=64,
                                    global_batch=4)
        tc = TST.build_case(TCFG.get_config(ARCH).reduced(), shape, tmesh)
        jc = JST.build_case(JCFG.get_config(ARCH).reduced(),
                            JSH.ShapeSpec(**dataclasses.asdict(shape)), jmesh)
        targs = [tree_paths(a) for a in tc.arg_structs]
        jargs = [jtree_paths(a) for a in jc.arg_structs]
        for t, j in zip(targs[:1] + targs[-1:], jargs[:1] + jargs[-1:]):
            assert _path_shapes(t) == _path_shapes(j), name
        tin = [_sharding_paths(s) for s in tc.in_shardings]
        jin = [jtree_paths(s) for s in jc.in_shardings]
        for t, j in zip(tin[:1] + tin[-1:], jin[:1] + jin[-1:]):
            assert sorted(t) == sorted(j)
            for p in j:
                assert _entries(t[p].spec) == _entries(j[p].spec), (name, p)
        assert tc.donate_argnums == jc.donate_argnums


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return toks


@pytest.mark.parametrize("mb,dtype", [(1, "float32"), (4, "float32"),
                                      (1, "bfloat16"), (4, "bfloat16")])
def test_build_case_train_matches_reference(mb, dtype):
    tcfg, jcfg = (TCFG.get_config(ARCH).reduced(),
                  JCFG.get_config(ARCH).reduced())
    shape = TSH.ShapeSpec("tiny_train", "train", 32, 4)
    toks = _batch(jcfg, 4, 32, 0)
    jp = _ref_params(ARCH)
    jcase = JST.build_case(jcfg, JSH.ShapeSpec("tiny_train", "train", 32, 4),
                           JMX.make_debug_mesh(1, 1), microbatches=mb,
                           compute_dtype=getattr(jnp, dtype))
    jp2, jopt, jloss, _ = jcase.fn(
        jax.tree_util.tree_map(jnp.copy, jp), jadam_init(jp),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    tcase = TST.build_case(tcfg, shape, TMX.make_debug_mesh(1, 1,
                                                            device="cpu"),
                           microbatches=mb,
                           compute_dtype=getattr(torch, dtype))
    tp = _carry(jp)
    t = torch.from_numpy(toks)
    tp2, topt, tloss, tmetrics = tcase.fn(tp, tadam_init(tp),
                                          {"tokens": t, "labels": t})
    assert tp2 is tp and int(topt.step) == 1            # updated in place
    assert set(tmetrics) == {"nll", "aux", "ntokens"}
    fp32 = dtype == "float32"
    assert float(tloss) == pytest.approx(float(jloss),
                                         rel=1e-5 if fp32 else 2e-3)
    jmu, jnew = jtree_paths(jopt.mu), jtree_paths(jp2)
    tmu, tnew = tree_paths(topt.mu), tree_paths(tp2)
    assert sorted(tnew) == sorted(jnew)
    for path in jnew:
        err = np.abs(np.asarray(jnew[path]) - tnew[path].numpy())
        if not fp32:
            assert err.max() < 5e-3, (path, err.max())
            continue
        # Adam's first moment is 0.1 g: the gradients agree at 1e-5 of
        # each leaf's largest. Its first step moves an entry by lr g /
        # (|g| + 1e-8), which is ill-conditioned where |g| is near 1e-8:
        # there the step (1e-4) bounds the difference; where |g| >= 1e-6
        # the params agree at 1e-5
        a = np.asarray(jmu[path])
        assert np.abs(a - tmu[path].numpy()).max() <= \
            1e-5 * np.abs(a).max(), path
        assert err.max() <= 1e-4 + 1e-6, path
        big = np.abs(a) >= 0.1 * 1e-6
        assert not big.any() or err[big].max() < 1e-5, path


@pytest.mark.parametrize("arch", [ARCH, JAMBA])
def test_build_case_prefill_decode_match_reference(arch, monkeypatch):
    tcfg, jcfg = (TCFG.get_config(arch).reduced(),
                  JCFG.get_config(arch).reduced())
    B, S = 2, 24
    jp = _ref_params(arch)
    tp = _carry(jp)
    toks = _batch(jcfg, B, S, 1)
    tmesh = TMX.make_debug_mesh(1, 1, device="cpu")
    jmesh = JMX.make_debug_mesh(1, 1)
    kw = dict(compute_dtype=jnp.float32)
    jpre = JST.build_case(jcfg, JSH.ShapeSpec("p", "prefill", S, B), jmesh,
                          **kw)
    jdec = JST.build_case(jcfg, JSH.ShapeSpec("d", "decode", S, B), jmesh,
                          **kw)
    tpre = TST.build_case(tcfg, TSH.ShapeSpec("p", "prefill", S, B), tmesh,
                          compute_dtype=torch.float32)
    tdec = TST.build_case(tcfg, TSH.ShapeSpec("d", "decode", S, B), tmesh,
                          compute_dtype=torch.float32)
    seen = []
    plain = TLM.constrain
    monkeypatch.setattr(TLM, "constrain", lambda x: (
        seen.append(TCTX._ACT_SHARDING.get()), plain(x))[1])
    # caches with room for the decoded token (the reference clamps a write
    # past the end into the last slot, the port raises)
    jl, jc = jpre.fn(jp, {"tokens": jnp.asarray(toks)},
                     jbuild(jcfg).make_cache(B, S + 8, jnp.bfloat16))
    tcache = tbuild(tcfg).make_cache(B, S + 8, torch.bfloat16, device="cpu")
    tl, tc = tpre.fn(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    assert tc["periods"] is tcache["periods"]          # written in place
    assert seen and all(s == TSP.NamedSharding(tmesh, (("data",), None,
                                                       None)) for s in seen)
    _close(tl, jl, f"{arch} prefill")
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jl2, _ = jdec.fn(jp, jc, jnp.asarray(nxt))
    tl2, tc2 = tdec.fn(tp, tc, torch.from_numpy(nxt))
    assert tc2["pos"] == S + 1
    _close(tl2, jl2, f"{arch} decode")


def _close(t, j, ctx):
    j = np.asarray(j, np.float32)
    t = t.to(torch.float32).numpy()
    assert t.shape == j.shape, ctx
    err = float(np.max(np.abs(t - j))) / float(np.max(np.abs(j)))
    assert err < 1e-3, (ctx, err)


# -------------------------------------------------------------- serve CLI
def test_serve_cli_matches_reference_example(capsys, monkeypatch):
    """`launch.serve.main` against `runpy` of `examples/serve_cluster.py`
    with the same argv: the same printed records (rid, arch, c, steps,
    reused, response, first tokens) and summary. The port's engine loads
    the reference's weight draws (its engine splits its key once a load)."""
    script = str(ROOT / "examples" / "serve_cluster.py")
    argv = ["--policy", "fifo", "--tasks", "4"]
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(script, run_name="__main__")
    want = capsys.readouterr().out.splitlines()

    jex = JExecutor(reduced=True)
    keys = {}

    def carried_load(self, server, arch):
        key = keys.get(id(self), jax.random.PRNGKey(0))
        keys[id(self)], k = jax.random.split(key)
        server.params = _carry(jex.init_params(arch, k))
        server.model_name = arch
        self.pool.load_count += 1
    monkeypatch.setattr(ServingEngine, "_load", carried_load)
    eng = TSERVE.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(eng.done) == 4 and got[-1].startswith("policy=fifo")
    assert sum("tokens=[" in line for line in got) == 4
    assert got == want
