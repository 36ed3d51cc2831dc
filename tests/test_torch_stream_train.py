"""The port's streaming trainers (`repro_torch.training.stream_train`) on
the CPU.

The reference's trainers reach `repro.api` (`_make_runner`), which this
suite's warning filter refuses, so collection is held to the reference's
`traffic.stream.StreamRunner(collect=True)` directly: its task source is
recorded and replayed into the port (`draws=`), and its warm-up actions
are replayed through the port's warm-up policy (teacher forcing). The
flattened replay-buffer transitions must then agree: exact on actions,
done flags and counts, 1e-6 on observations, 1e-5 on rewards. The port is
also held to itself: the first round's transitions equal a `StreamRunner`
window on the generators the trainer derives, and the reference and fused
backends train identically.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import env as JEV
from repro.core import sac as JSAC
from repro.core.workload import TraceConfig as JTC
from repro.traffic import stream as JS
from repro.traffic.arrivals import PoissonArrivals as JPoisson
from repro.training import stream_train as JST
from repro_torch import api
from repro_torch.api.simulator import split_generator
from repro_torch.core import agent as TAG
from repro_torch.core import env as TEV
from repro_torch.core import ppo as TPPO
from repro_torch.core import sac as TSAC
from repro_torch.core import scenarios as TSC
from repro_torch.core.workload import TraceConfig as TTC
from repro_torch.telemetry import metrics as TMET
from repro_torch.telemetry import schema as TSCH
from repro_torch.telemetry import trace as TTR
from repro_torch.traffic import stream as TS
from repro_torch.training import stream_train as ST

E, K, STREAMS = 4, 8, 2
ENV = dict(num_servers=E, max_tasks=K, queue_window=4, max_steps=64)
JECFG, TECFG = JEV.EnvConfig(**ENV), TEV.EnvConfig(**ENV)
ACFG = TAG.AgentConfig(T=3, hidden=32)
SCFG = TSAC.SACConfig(batch_size=16, warmup_steps=24)
FLOAT_TOL = 1e-6
RTOL = 1e-5


def _cell(name="poisson", rate=0.1):
    return TSC.Scenario(name, TECFG, TTC(num_tasks=K, arrival_rate=rate,
                                         max_servers=E))


@pytest.mark.parametrize("kw,match", [
    (dict(sampler="distilled"), "distilled"),
    (dict(rounds=-1), "rounds"),
    (dict(windows_per_round=0), "windows_per_round"),
    (dict(streams=0), "streams"),
    (dict(rate_scale=0.0), "rate_scale")])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ST.StreamTrainConfig(**kw)
    with pytest.raises(ValueError, match=match):
        JST.StreamTrainConfig(**kw)


def test_resolve_cells_match_reference():
    from repro.core import scenarios as JSC
    cur = TSC.training_curriculum(TECFG)
    jcur = JSC.training_curriculum(JECFG)
    got = ST.resolve_cells(TECFG, None, cur, rate_scale=2.0)
    want = JST.resolve_cells(JECFG, None, jcur, rate_scale=2.0)
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (_, tp, tt), (_, jp, jt) in zip(got, want):
        assert type(tp).__name__ == type(jp).__name__
        assert tt.num_tasks == jt.num_tasks == K
        assert tt.arrival_rate == jt.arrival_rate
    (name, proc, tc), = ST.resolve_cells(TECFG, None, None)
    (jname, jproc, jtc), = JST.resolve_cells(JECFG, None, None)
    assert name == jname and proc.rate == jproc.rate
    with pytest.raises(ValueError, match="either scenario= or curriculum="):
        ST.resolve_cells(TECFG, _cell(), cur)
    other = TSC.Scenario("x", TEV.EnvConfig(num_servers=8), _cell().tcfg)
    with pytest.raises(ValueError, match="different EnvConfig"):
        ST.resolve_cells(TECFG, other, None)


def test_first_round_equals_stream_runner_window():
    """Round 0 (warm-up) collects exactly a `StreamRunner(collect=True)`
    window on the generators the trainer derives from its seed."""
    seen = {}
    stcfg = ST.StreamTrainConfig(rounds=1, streams=STREAMS)
    ST.train_stream_sac(TECFG, ACFG, SCFG, stcfg, scenario=_cell(), seed=3,
                        transition_hook=lambda r, f: seen.setdefault(r, f),
                        device="cpu")
    gen = torch.Generator().manual_seed(3)
    TSAC.host_rng(gen)
    TSAC.init_train_state(TECFG, ACFG, generator=gen, device="cpu")
    g_src, g_stream = split_generator(gen, 2)
    (_, proc, tc), = ST.resolve_cells(TECFG, _cell(), None)
    src = TS.CurriculumTaskSource([(proc, tc)], g_src, num_streams=STREAMS,
                                  device="cpu")
    runner = TS.StreamRunner(TECFG, TSAC.warmup_policy(TECFG), {}, src,
                             g_stream, TS.StreamConfig(num_streams=STREAMS),
                             device="cpu")
    want = TSAC.flatten_valid_transitions(
        runner.run_window(collect=True).transitions)
    for a, b in zip(want, seen[0]):
        np.testing.assert_array_equal(a, b)


def _recording(src):
    rec = []
    for i, (samp, attr) in enumerate(zip(src._samplers, src._attr_fns)):
        def s_(state, samp=samp):
            state, gaps = samp(state)
            rec.append({"gaps": np.asarray(gaps)})
            return state, gaps

        def a_(key, attr=attr):
            c, model, noise = attr(key)
            rec[-1].update(c=np.asarray(c), model=np.asarray(model),
                           noise=np.asarray(noise))
            return c, model, noise
        src._samplers[i], src._attr_fns[i] = s_, a_
    return rec


def test_collected_transitions_match_reference(monkeypatch):
    """Two warm-up rounds: the port's replay-buffer batches == the
    reference StreamRunner's on the same tasks and the same actions."""
    rounds = 2
    key = jax.random.PRNGKey(0)
    jsrc = JS.CurriculumTaskSource([(JPoisson(rate=0.2), JTC(num_tasks=K))],
                                   key, num_streams=STREAMS)
    rec = _recording(jsrc)
    jr = JS.StreamRunner(JECFG, JSAC.warmup_policy(JECFG), {}, jsrc, key,
                         JS.StreamConfig(num_streams=STREAMS))
    jwins = [jr.run_window(collect=True).transitions for _ in range(rounds)]
    want = [JSAC.flatten_valid_transitions(t) for t in jwins]

    holder = {"w": 0}

    def replay_factory(ecfg):
        def policy(params, generator, traces, state, obs):
            tr = jwins[holder["w"]]
            idx = state.steps_taken.to(torch.int64)
            rows = torch.arange(obs.shape[0])
            env_a = torch.from_numpy(np.array(tr.action))[rows, idx]
            agent = torch.from_numpy(np.array(
                tr.extras["agent_action"]))[rows, idx]
            return env_a, {"agent_action": agent}
        return policy

    def replay_source(cells, generator, num_streams, chunk_size, device):
        return TS.CurriculumTaskSource(cells, None, num_streams=num_streams,
                                       draws=rec)
    replay = replay_factory(TECFG)
    monkeypatch.setattr(TSAC, "warmup_policy", lambda ecfg: replay)
    monkeypatch.setattr(ST, "CurriculumTaskSource", replay_source)
    got = []

    def hook(r, flat):
        got.append(flat)
        holder["w"] += 1
    ST.train_stream_sac(TECFG, ACFG, TSAC.SACConfig(warmup_steps=10 ** 6),
                        ST.StreamTrainConfig(rounds=rounds, streams=STREAMS),
                        scenario=_cell(rate=0.2), transition_hook=hook,
                        device="cpu")
    assert len(got) == rounds
    for w, (a, b) in enumerate(zip(want, got)):
        for name, x, y in zip(("obs", "action", "reward", "next_obs", "done"),
                              a, b):
            x = np.asarray(x)
            assert x.shape == y.shape, (w, name)
            if name in ("action", "done"):
                np.testing.assert_array_equal(y, x, err_msg=f"{w} {name}")
            else:
                np.testing.assert_allclose(
                    y, x, rtol=RTOL if name == "reward" else 0.0,
                    atol=FLOAT_TOL, err_msg=f"{w} {name}")


def test_sac_rounds_rows_backends_and_telemetry(tmp_path):
    """Two rounds (warm-up, then the actor with updates): rows in the
    reference's schema, eat_train_* gauges, the reference and fused
    backends train identically, and a traced run passes the strict
    schema."""
    stcfg = ST.StreamTrainConfig(rounds=2, streams=STREAMS,
                                 max_updates_per_round=2)
    runs = []
    for backend in ("reference", "fused"):
        flats = []
        res = ST.train_stream_sac(
            TECFG, ACFG, SCFG, stcfg, scenario=_cell(), seed=1,
            exec_spec=api.ExecSpec(backend=backend),
            transition_hook=lambda r, f, flats=flats: flats.append(f),
            device="cpu")
        runs.append((res, flats))
    (ra, fa), (rb, fb) = runs
    for x, y in zip(fa, fb):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    wa = ra.state.actor["denoiser"]["layers"][0]["w"]
    wb = rb.state.actor["denoiser"]["layers"][0]["w"]
    assert torch.equal(wa, wb)
    h = ra.history
    assert [r["warmup"] for r in h] == [True, False]
    assert [r["updates"] for r in h] == [2, 2]   # the buffer warms in round 0
    want = ({"round", "cell", "transitions", "updates",
             "episode_return_mean", "backlog", "warmup", "buffer_size"}
            | set(JST.QOS_KEYS))
    assert ST.QOS_KEYS == JST.QOS_KEYS
    assert all(set(r) == want for r in h)
    parsed = TMET.parse_prometheus(TMET.default_registry().to_prometheus())
    assert any(k.startswith("eat_train_episode_return_mean") for k in parsed)
    TTR.reset_tracers()
    tcfg = TTR.TraceConfig(enabled=True, path=str(tmp_path / "tr.json"))
    ST.train_stream_sac(TECFG, ACFG, SCFG, stcfg, scenario=_cell(), seed=1,
                        exec_spec=api.ExecSpec(trace=tcfg), device="cpu")
    assert not TSCH.validate_trace(str(tmp_path / "tr.json"),
                                   strict_names=True)
    import json
    names = {e["name"] for e in json.load(open(tmp_path / "tr.json"))[
        "traceEvents"]}
    assert {"train_round", "replay_push", "gradient_update",
            "window"} <= names
    TTR.reset_tracers()


def test_ppo_rounds_and_curriculum():
    """train_stream_ppo: rounds pool GAE over each window and update; a
    curriculum picks its cells with the host rng, distinct per seed."""
    stcfg = ST.StreamTrainConfig(rounds=2, streams=STREAMS,
                                 max_updates_per_round=2)
    res = ST.train_stream_ppo(TECFG, TPPO.PPOConfig(epochs=1), stcfg,
                              scenario=_cell(), device="cpu")
    assert [r["updates"] for r in res.history] == [2, 2]
    assert all(r["transitions"] > 0 for r in res.history)
    assert int(res.state.step) == 4
    cur = TSC.training_curriculum(TECFG)
    names = {c.name for c in cur}
    seqs = []
    for seed in (0, 1):
        r = ST.train_stream_sac(TECFG, ACFG, SCFG,
                                ST.StreamTrainConfig(rounds=4, streams=1,
                                                     max_updates_per_round=1),
                                curriculum=cur, seed=seed, device="cpu")
        seqs.append([row["cell"] for row in r.history])
        assert set(seqs[-1]) <= names
    assert seqs[0] != seqs[1]
