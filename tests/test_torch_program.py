"""The port's `ActorProgram` (`repro_torch.actors.program`) on the CPU.

On the card the program captures one decision as CUDA graphs; on the CPU
the same body runs eagerly over the same two sets of static buffers, so
these tests hold that body, its input copies and its bookkeeping to the
eager loop (`batch_rollout(graph=False)`): every tensor equal. The graphs
themselves are held to the eager loop on the card by `chip_smoke.py`
(phase 15).
"""
import numpy as np
import pytest
import torch

from repro_torch.actors import policies as TPOL
from repro_torch.actors import program as PG
from repro_torch.core import agent as TAG
from repro_torch.core import env as TEV
from repro_torch.core import replay as TRP
from repro_torch.core import rollout as TRO
from repro_torch.core import sac as TSAC
from repro_torch.core import workload as TWL
from repro_torch.kernels.denoiser import kernel as DK
from repro_torch.kernels.env_step import kernel as EK

ECFG = TEV.EnvConfig(num_servers=4, max_tasks=8, queue_window=4, max_steps=48)
TC = TWL.TraceConfig(num_tasks=8, max_servers=4, arrival_rate=0.08)
ACFG = TAG.AgentConfig(T=3, hidden=32)


def _traces(seed, B=3):
    return TWL.make_trace_batch(TC, B, generator=torch.Generator().manual_seed(seed),
                                device="cpu")


def _actor(seed):
    return TAG.init_actor(ECFG, ACFG, generator=torch.Generator().manual_seed(seed),
                          device="cpu")


def _same(a, b, ctx):
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(a.final_state, f),
                           getattr(b.final_state, f)), f"{ctx} {f}"
    assert set(a.metrics) == set(b.metrics)
    for k in a.metrics:
        assert torch.equal(a.metrics[k], b.metrics[k]), f"{ctx} {k}"
    if a.transitions is not None:
        for f in TRO.Transitions._fields[:-1]:
            assert torch.equal(getattr(a.transitions, f),
                               getattr(b.transitions, f)), f"{ctx} {f}"
        assert set(a.transitions.extras) == set(b.transitions.extras)
        for k, v in a.transitions.extras.items():
            assert torch.equal(v, b.transitions.extras[k]), f"{ctx} {k}"


def _run(pol, params, traces, graph, seed=5, **kw):
    return TRO.batch_rollout(ECFG, traces, pol, params, collect=True,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu", graph=graph, **kw)


@pytest.mark.parametrize("name", ["fifo", "uniform", "ddpm", "ddim:2",
                                  "distilled"])
def test_static_body_equals_eager_loop(name):
    """The program's ping-pong body against the eager loop, collecting,
    twice with new weights and traces in between: the second rollout reads
    the new weights and traces, and the first rollout's results are not
    overwritten by the second."""
    if name in ("fifo", "uniform"):
        pol = {"fifo": TRO.fifo_policy, "uniform": TRO.uniform_policy}[name](ECFG)
        params = [{}, {}]
    else:
        pol = TPOL.actor_policy(ECFG, ACFG, sampler=name, device="cpu")
        params = [_actor(0), _actor(1)]
        if name == "distilled":
            for i, p in enumerate(params):
                p["student"] = TPOL.init_student(
                    ECFG, ACFG, generator=torch.Generator().manual_seed(7 + i),
                    device="cpu")
    first = _run(pol, params[0], _traces(1), True)
    kept = {k: v.clone() for k, v in first.metrics.items()}
    for i, seed in ((0, 1), (1, 2)):
        got = _run(pol, params[i], _traces(seed), True)
        want = _run(pol, params[i], _traces(seed), False)
        _same(got, want, f"{name} rollout {i}")
    for k, v in kept.items():
        assert torch.equal(first.metrics[k], v), k
    if name not in ("fifo", "uniform"):
        # the new weights changed the trajectory on the same traces
        other = _run(pol, params[1], _traces(1), True)
        assert not torch.equal(other.transitions.action,
                               first.transitions.action)
    assert PG.actor_program(ECFG, pol).loops_built == 1


def test_weights_changed_in_place_are_read():
    pol = TPOL.actor_policy(ECFG, ACFG, sampler="ddpm", device="cpu")
    params = _actor(3)
    tr = _traces(4)
    before = _run(pol, params, tr, True)
    with torch.no_grad():
        params["denoiser"]["layers"][2]["b"] += 0.5
    got = _run(pol, params, tr, True)
    _same(got, _run(pol, params, tr, False), "in place")
    assert not torch.equal(got.transitions.action, before.transitions.action)


def test_static_body_resumes_from_a_carried_state():
    pol = TRO.uniform_policy(ECFG)
    tr = _traces(6)
    mid = _run(pol, {}, tr, False, num_steps=7).final_state
    got = _run(pol, {}, tr, True, init_state=mid)
    _same(got, _run(pol, {}, tr, False, init_state=mid), "resumed")


def test_static_body_sequence_and_greedy_without_collect():
    tr = _traces(8, B=4)
    seq = torch.rand((4, 20, ECFG.action_dim),
                     generator=torch.Generator().manual_seed(0))
    for pol, params in ((TRO.sequence_policy(ECFG), {"seq": seq}),
                        (TRO.greedy_policy(ECFG), {})):
        kw = dict(device="cpu", num_steps=20)
        a = TRO.batch_rollout(ECFG, tr, pol, params, **kw)
        b = TRO.batch_rollout(ECFG, tr, pol, params, graph=False, **kw)
        assert a.transitions is None
        _same(a, b, "no collect")


def test_actor_program_is_cached_per_env_and_policy():
    pol = TPOL.actor_policy(ECFG, ACFG, sampler="ddim:2", device="cpu")
    assert pol is TPOL.actor_policy(ECFG, ACFG, sampler="DDIM:2",
                                    device=torch.device("cpu"))
    assert pol is not TPOL.actor_policy(ECFG, ACFG, sampler="ddim:2",
                                        deterministic=True, device="cpu")
    prog = PG.actor_program(ECFG, pol)
    assert prog is PG.actor_program(ECFG, pol)
    assert prog.policy is pol and prog.sampler == "ddim:2"
    assert PG.actor_program(ECFG, TRO.fifo_policy(ECFG)) is not prog
    other = TEV.EnvConfig(num_servers=4, max_tasks=8, queue_window=4)
    assert PG.actor_program(other, pol) is not prog
    assert "sampler='ddim:2'" in repr(prog)


def test_act_equals_the_policy():
    pol = TPOL.actor_policy(ECFG, ACFG, sampler="ddpm", device="cpu")
    params = _actor(2)
    tr = _traces(3)
    state = TEV.reset(ECFG, 3, device="cpu")
    obs = TEV.observe(ECFG, tr, state)
    prog = PG.actor_program(ECFG, pol)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for _ in range(2):
        a, ex = prog.act(tr, state, obs, g1, params)
        b, ex2 = pol(params, g2, tr, state, obs)
        assert torch.equal(a, b)
        assert torch.equal(ex["agent_action"], ex2["agent_action"])
    assert torch.equal(g1.get_state(), g2.get_state())


def test_launch_count_bookkeeping():
    """A capture's launches are recorded and taken back out of the
    counters (the card ran nothing); each replay adds them again."""
    saved = (EK.env_step.launches, DK.denoiser_chain.launches)
    try:
        EK.env_step.launches, DK.denoiser_chain.launches = 10, 3

        def capture():
            EK.env_step.launches += 1
            DK.denoiser_chain.launches += 2
        delta = PG.counted_capture(capture)
        assert delta == {EK.env_step: 1, DK.denoiser_chain: 2}
        assert (EK.env_step.launches, DK.denoiser_chain.launches) == (10, 3)
        for _ in range(5):
            PG.count_replay(delta)
        assert (EK.env_step.launches, DK.denoiser_chain.launches) == (15, 13)
        assert PG.counted_capture(lambda: None) == {}
        # a capture that raises still puts the counters back
        with pytest.raises(RuntimeError):
            def boom():
                EK.env_step.launches += 4
                raise RuntimeError("capture failed")
            PG.counted_capture(boom)
        assert EK.env_step.launches == 15
    finally:
        EK.env_step.launches, DK.denoiser_chain.launches = saved
    names = [w.__name__ for w in PG.kernel_wrappers()]
    assert names == ["env_step", "denoiser_chain", "denoiser_step",
                     "flash_attention", "ssm_scan"]


def test_static_tree_copies_only_what_changed():
    a = {"w": torch.ones(3), "layers": [{"b": torch.zeros(2)}]}
    st = PG.StaticTree(a)
    st.load(a)
    assert st.copies == 2 and torch.equal(st.tree["w"], a["w"])
    assert st.tree["w"] is not a["w"]
    st.load(a)
    assert st.copies == 2                     # same tensors, same versions
    a["w"].add_(1.0)                          # in place: its version moved
    st.load(a)
    assert st.copies == 3 and torch.equal(st.tree["w"], a["w"])
    b = {"w": a["w"].clone(), "layers": [{"b": torch.full((2,), 5.0)}]}
    st.load(b)                                # new tensors
    assert st.copies == 5 and torch.equal(st.tree["layers"][0]["b"],
                                          b["layers"][0]["b"])


def test_collect_batch_reuses_its_program():
    """Two SAC collection rounds with new actor weights: one program, one
    decision loop (on the card: one pair of graphs, captured once)."""
    pol = TSAC.actor_policy(ECFG, ACFG, device="cpu")
    prog = PG.actor_program(ECFG, pol)
    built = prog.loops_built
    buf = TRP.ReplayBuffer(1 << 12, ECFG.obs_shape, ECFG.action_dim)
    gen = torch.Generator().manual_seed(0)
    for seed in (0, 1):
        m, n = TSAC.collect_batch(ECFG, ACFG, _actor(seed), _traces(seed, B=2),
                                  gen, buf, device="cpu")
        assert n > 0 and m["episode_len"].shape == (2,)
    assert TSAC.actor_policy(ECFG, ACFG, device="cpu") is pol
    assert PG.actor_program(ECFG, pol) is prog
    assert prog.loops_built == built + 1      # the two rounds share a loop
    assert prog.captures == 0                 # nothing is captured on the CPU
    assert np.isfinite(buf.reward[:buf.size]).all()


def test_new_entry_points_need_cuda_unless_told(monkeypatch):
    """device=None means CUDA: without it this slice's entry points raise
    instead of running on the CPU."""
    from repro_torch.core import baselines as TBL
    from repro_torch.core import ppo as TPPO
    from repro_torch.core import scenarios as TSC
    from repro_torch.traffic import arrivals as TAR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = TSC.paper_scenarios()[0]
    one = {k: v[0] for k, v in _traces(0, B=1).items()}
    calls = [
        lambda: TSC.run_scenario(sc, TRO.fifo_policy(sc.ecfg), batch=2),
        lambda: TPPO.init_ppo(ECFG),
        lambda: TPPO.train_ppo(ECFG, TPPO.PPOConfig(), None, 1),
        lambda: TAR.PoissonArrivals().init(2),
        lambda: TAR.generate_trace(TAR.MMPPArrivals(), TC, 2),
        lambda: TWL.sample_task_attrs(TC, (2, 8)),
        lambda: TBL.genetic_schedule(ECFG, one),
        lambda: TRO.rollout_episode(ECFG, one, TRO.fifo_policy(ECFG), {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
