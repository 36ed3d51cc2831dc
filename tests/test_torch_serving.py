"""The port's serving layer (`repro_torch.serving`, `traffic.metrics`,
`telemetry`) against the reference on the CPU.

Pool semantics are ported test for test from `tests/test_serving.py`. The
executor runs the reference's weights, carried across as numpy, and must
give the reference's tokens exactly. The engine, fed the same requests
and the same action sequence as the reference's in virtual time, must
give the same `done` records to the last bit and the same observations
and QoS summary (1e-6); its tokens differ, since the two draw their
weights from different generators.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro.traffic import metrics as JMX
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.faults.inject import ExecutorTimeout
from repro_torch.serving import (ModelExecutor, Request, ServerPool,
                                 ServingEngine, chunkable)
from repro_torch.telemetry.metrics import LatencyHistogram
from repro_torch.traffic import metrics as TMX

ARCH = "tinyllama-1.1b"


def _req(cls, rid, c=2, t=0.0, prompt_len=8, max_new_tokens=4):
    rng = np.random.default_rng(rid)
    return cls(rid=rid, arch=ARCH, prompt=rng.integers(0, 1000, prompt_len),
               patches=c, arrive_t=t, max_new_tokens=max_new_tokens)


def _engine(num_servers=2, **kw):
    kw = dict(dict(queue_window=4, reduced=True, time_dilation=1.0,
                   s_min=2, s_max=4), **kw)
    return ServingEngine(num_servers=num_servers, archs=[ARCH],
                         device="cpu", **kw)


def _random_policy(engine, rng):
    a = rng.uniform(size=2 + engine.l).astype(np.float32)
    a[0] = 0.0  # always try to execute
    return a


# ---------------------------------------------------------------- pool
def _assign(pool, sids, arch, gang, size, busy=0.0):
    for sid in sids:
        s = pool.servers[sid]
        s.model_name, s.gang, s.gang_size, s.busy_until = arch, gang, size, busy
        s.params = object()


def test_pool_find_reusable_gang_exact_match():
    pool = ServerPool(4)
    _assign(pool, [0, 1], "a", gang=5, size=2)
    _assign(pool, [2, 3], "a", gang=7, size=2)
    pool.servers[3].busy_until = 10.0          # gang 7 broken: member busy
    got = pool.find_reusable_gang("a", 2, now=0.0)
    assert got is not None and {s.sid for s in got} == {0, 1}
    assert pool.find_reusable_gang("a", 1, now=0.0) is None
    assert pool.find_reusable_gang("b", 2, now=0.0) is None
    pool.servers[1].gang = 9
    assert pool.find_reusable_gang("a", 2, now=0.0) is None
    pool.servers[3].busy_until = 0.0
    got = pool.find_reusable_gang("a", 2, now=0.0)
    assert got is not None and {s.sid for s in got} == {2, 3}


def test_pool_pick_fresh_fragmentation_ordering():
    pool = ServerPool(6)
    _assign(pool, [0, 1], "a", gang=1, size=2)      # intact, small
    _assign(pool, [2, 3, 4], "a", gang=2, size=3)   # intact, big
    got = pool.pick_fresh(2, now=0.0)
    assert [s.sid for s in got] == [5, 0]   # free first, then smallest intact
    pool.servers[2].busy_until = 10.0
    got = pool.pick_fresh(3, now=0.0)
    assert [s.sid for s in got] == [3, 4, 5]
    assert pool.pick_fresh(6, now=0.0) is None
    # among equally fragmented servers, the ones holding `arch` come first
    pool = ServerPool(3)
    _assign(pool, [1], "b", gang=-1, size=0)
    assert [s.sid for s in pool.pick_fresh(1, 0.0, arch="b")] == [1]
    assert [s.sid for s in pool.pick_fresh(1, 0.0)] == [0]


def test_pool_counter_economics_interleaved_gangs():
    eng = _engine(4, s_min=2, s_max=2)
    rng = np.random.default_rng(0)
    eng.submit(_req(Request, 0, c=2))
    eng.try_schedule(_random_policy(eng, rng))      # cold: +2 loads
    eng.submit(_req(Request, 1, c=1, t=eng.clock))
    eng.try_schedule(_random_policy(eng, rng))      # cold c=1 on s2/s3: +1
    assert (eng.pool.load_count, eng.pool.reuse_count) == (3, 0)
    eng.clock = max(s.busy_until for s in eng.pool.servers) + 1
    eng.submit(_req(Request, 2, c=2, t=eng.clock))
    eng.try_schedule(_random_policy(eng, rng))      # reuse the c=2 gang
    assert (eng.pool.load_count, eng.pool.reuse_count) == (3, 1)
    assert eng.pool.counters() == {"model_loads": 3, "model_reuses": 1}
    assert all(v == 0 for v in eng.pool.fault_counters().values())
    eng.pool.reset()
    assert eng.pool.counters() == {"model_loads": 0, "model_reuses": 0}
    assert all(s.params is None and s.gang == -1 for s in eng.pool.servers)


# ---------------------------------------------------------------- executor
@pytest.fixture(scope="module")
def carried():
    """A reference executor and the port's on the CPU, with the same
    reduced tinyllama weights (the reference's draw, carried across)."""
    jex = JExecutor(reduced=True)
    jp = jex.init_params(ARCH, jax.random.PRNGKey(4))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jex, jp, ModelExecutor(reduced=True, device="cpu"), tp


@pytest.mark.parametrize("prompt_len,c,steps,mnt,chunked", [
    (12, 1, 6, 16, True),       # c = 1, chunked
    (12, 1, 6, 16, False),      # c = 1, unchunked
    (10, 4, 5, 16, None),       # c = 4: the prompt is left-padded by 2
    (9, 2, 12, 4, None),        # steps > max_new_tokens: cache sized by both
])
def test_generate_matches_reference_tokens(carried, prompt_len, c, steps,
                                           mnt, chunked):
    jex, jp, tex, tp = carried
    prompt = np.random.default_rng(prompt_len).integers(1, 1000, prompt_len)
    want = jex.generate(ARCH, jp, prompt.astype(np.int32), c, steps, mnt,
                        force_chunked=chunked)
    got = tex.generate(ARCH, tp, prompt, c, steps, mnt, force_chunked=chunked)
    assert got.dtype == np.int32 and len(got) == steps
    np.testing.assert_array_equal(got, want)
    assert tex.shape_key(ARCH, prompt_len, c, steps, mnt) == \
        jex.shape_key(ARCH, prompt_len, c, steps, mnt)


def test_generate_prefill_impls_and_cache(carried):
    """`prefill` is `generate`'s first half; the plain attention (`impl=
    "ref"`) gives the same logits on the CPU; c=1 chunked == unchunked."""
    _, _, tex, tp = carried
    prompt = np.arange(1, 14)
    la, ca = tex.prefill(ARCH, tp, prompt, 1, 3, force_chunked=True)
    lb, cb = tex.prefill(ARCH, tp, prompt, 1, 3, force_chunked=False)
    lr, _ = tex.prefill(ARCH, tp, prompt, 1, 3, impl="ref")
    assert torch.equal(la, lb) and torch.equal(la, lr)
    assert ca["pos"] == cb["pos"] == 13
    for key in ("k", "v"):
        a, b = ca["periods"]["blk0_attn"][key], cb["periods"]["blk0_attn"][key]
        assert a.shape == b.shape == (2, 1, 13 + 16, 4, 64)
        assert torch.equal(a, b)
    assert chunkable(tex.model(ARCH).cfg)


def test_executor_deadline_and_warm(carried):
    _, _, tex, tp = carried
    with pytest.raises(ExecutorTimeout, match="budget"):
        tex.generate(ARCH, tp, np.arange(1, 9), 1, 4, deadline_s=1e-9)
    assert len(tex.generate(ARCH, tp, np.arange(1, 9), 2, 0)) == 0
    assert tex.warm(ARCH, 8, 2, 3, 4) is True
    assert tex.warm(ARCH, 8, 2, 3, 4) is False


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelExecutor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(num_servers=2, archs=[ARCH])
    assert ModelExecutor(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------- engine
def _drive_both(actions, reqs, num_servers=3, l=4):
    """Run the reference's and the port's engines on the same requests
    (submitted as the clock reaches them) and the same action sequence;
    returns both engines and the paired observations."""
    kw = dict(queue_window=l, reduced=True, time_dilation=1.0, s_min=2,
              s_max=6)
    j = JEngine(num_servers=num_servers, archs=[ARCH], **kw)
    t = ServingEngine(num_servers=num_servers, archs=[ARCH], device="cpu",
                      **kw)
    pending = sorted(reqs, key=lambda r: r[3])
    obs = []
    for a in actions:
        while pending and pending[0][3] <= j.now():
            rid, prompt, c, arrive = pending.pop(0)
            j.submit(JRequest(rid, ARCH, prompt.astype(np.int32), c, arrive,
                              max_new_tokens=4))
            t.submit(Request(rid, ARCH, prompt, c, arrive, max_new_tokens=4))
        obs.append((j.observe(), t.observe()))
        rj, rt = j.try_schedule(a), t.try_schedule(a)
        assert (rj is None) == (rt is None)
        assert j.now() == t.now()
    return j, t, obs


def test_engine_matches_reference_schedule_and_qos():
    rng = np.random.default_rng(11)
    reqs = [(i, rng.integers(1, 1000, 6 + 2 * (i % 3)),
             int(rng.choice([1, 2])), float(4.0 * i)) for i in range(5)]
    actions = rng.uniform(size=(40, 6)).astype(np.float32)
    actions[::3, 0] = 0.9               # wait now and then
    actions[1::3, 0] = 0.2
    j, t, obs = _drive_both(actions, reqs)
    assert len(t.done) == len(j.done) >= 3
    for rj, rt in zip(j.done, t.done):
        for f in ("rid", "start_t", "finish_t", "steps", "reused",
                  "quality", "patches", "arrive_t"):
            assert getattr(rj, f) == getattr(rt, f), f
        assert len(rt.tokens) == rt.steps
    for oj, ot in obs:
        assert ot.shape == oj.shape and ot.dtype == np.float32
        np.testing.assert_allclose(ot, oj, rtol=1e-6, atol=1e-6)
    qj, qt = j.qos_summary(), t.qos_summary()
    assert sorted(qj) == sorted(qt)
    for key, v in qj.items():
        if isinstance(v, float):
            assert qt[key] == pytest.approx(v, rel=1e-6, abs=1e-6), key
        else:
            assert qt[key] == v, key
    assert t.pool.counters() == j.pool.counters()
    with pytest.deprecated_call():
        mt = t.metrics()
    with pytest.deprecated_call():
        mj = j.metrics()
    assert mt == mj


def test_engine_observation_parity_with_reference_state():
    """The hand-built pool state of `tests/test_serving.py` gives the same
    Eq.-6 matrix in both engines."""
    archs = [ARCH, "qwen2-1.5b"]
    kw = dict(queue_window=2, reduced=True, time_dilation=1.0)
    j = JEngine(num_servers=3, archs=archs, **kw)
    t = ServingEngine(num_servers=3, archs=archs, device="cpu", **kw)
    for eng, cls in ((j, JRequest), (t, Request)):
        eng.clock = 12.0
        s0, s1, s2 = eng.pool.servers
        s0.model_name, s0.busy_until, s0.gang, s0.gang_size = \
            archs[1], 30.0, 7, 1
        s1.model_name, s1.gang, s1.gang_size = archs[0], 3, 2
        s2.model_name, s2.gang, s2.gang_size = archs[0], 3, 2
        eng.submit(cls(0, archs[0], np.arange(8), 2, 2.0))
        eng.submit(cls(1, archs[1], np.arange(8), 1, 9.0))
    np.testing.assert_allclose(t.observe(), j.observe(), rtol=1e-6,
                               atol=1e-6)
    assert t.observe().shape == (3, 5)


def test_engine_gang_infeasible_and_empty_queue():
    eng = _engine(2)
    rng = np.random.default_rng(0)
    assert eng.try_schedule(_random_policy(eng, rng)) is None   # empty
    assert eng.clock == 1.0
    eng.submit(Request(rid=0, arch=ARCH, prompt=np.arange(8), patches=4,
                       arrive_t=0.0))
    assert eng.try_schedule(_random_policy(eng, rng)) is None  # 4 > 2 servers
    assert len(eng.queue) == 1 and eng.clock == 2.0
    with pytest.deprecated_call():
        assert eng.metrics() == {"completed": 0}


# ---------------------------------------------------------------- QoS
def test_stream_aggregator_and_buckets_match_reference():
    rng = np.random.default_rng(2)
    edges = TMX.DEFAULT_EDGES
    assert np.array_equal(edges, JMX.DEFAULT_EDGES)
    vals = rng.uniform(0.0, 300.0, 64).astype(np.float32)
    vals[:3] = (edges[0], edges[5], 1e6)       # on an edge, past the top
    mask = rng.random(64) < 0.7
    got = TMX.bucketize_counts(torch.from_numpy(vals),
                               torch.from_numpy(mask), edges)
    want = JMX.bucketize_counts(vals, mask, edges)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stats = []
    for w in range(3):
        r = np.random.default_rng(w)
        hist = np.stack([np.bincount(
            np.searchsorted(edges, r.uniform(0, 200, 9)),
            minlength=len(edges) + 1) for _ in range(2)])
        stats.append({k: r.integers(0, 9, 2).astype(np.float64)
                      for k in ("n_injected", "n_sched", "n_done",
                                "n_dropped", "n_reload", "n_viol",
                                "n_viol_q", "n_viol_t", "sum_steps")}
                     | {"sum_resp": r.uniform(0, 900, 2),
                        "sum_quality": r.uniform(0, 2, 2),
                        "busy_time": r.uniform(0, 400, 2),
                        "elapsed": r.uniform(50, 100, 2),
                        "hist": hist, "max_resp": r.uniform(100, 200, 2)})
    ta, ja = (TMX.StreamAggregator(8, 0.23, 120.0),
              JMX.StreamAggregator(8, 0.23, 120.0))
    for st in stats:
        ta.update(st)
        ja.update(st)
    assert ta.summary() == ja.summary()
    h = LatencyHistogram()
    h.add_values(rng.uniform(0, 50, 100))
    assert h.total == 100 and 0 < h.percentile(0.5) < 50
