"""The port's baselines (`repro_torch.core.baselines`) and the rest of its
rollout engine (`rollout_episode`, the unfused path, `greedy_policy`)
against the reference on the CPU.

Greedy and fifo are deterministic, so they run closed loop on both sides
from the same numpy traces. Genetic and harmony take their draws from the
reference's keys (rebuilt here with the reference's splits) on both sides.
Integers, booleans, the clock and every chosen action must be equal;
quality and the float metrics built from it within 1e-6, rewards and
returns within 1e-5 relative (an exp and a reordered sum, as in
`tests/test_torch_rollout.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JBL
from repro.core import env as JEV
from repro.core import rollout as JRO
from repro_torch.core import baselines as TBL
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO

FLOAT_TOL = 1e-6
REWARD_RTOL = 1e-5
INT_METRICS = ("num_scheduled", "num_done", "num_failed", "episode_len")
# (E, K, l, max_steps): a small cell, and the paper's 8- and 12-server
# cells (K = 32, l = 8) with the step limit cut to keep the CPU run short
CELLS = {"small": (4, 8, 4, 64), "paper-8srv": (8, 32, 8, 160),
         "paper-12srv": (12, 32, 8, 160)}
RATE = {"small": 0.08, "paper-8srv": 0.1, "paper-12srv": 0.15}


def _cfgs(cell):
    E, K, l, T = CELLS[cell]
    kw = dict(num_servers=E, max_tasks=K, queue_window=l, max_steps=T)
    return JEV.EnvConfig(**kw), TEV.EnvConfig(**kw)


def _np_traces(seed, B, cell):
    E, K = CELLS[cell][:2]
    rng = np.random.default_rng(seed)
    support = np.array([c for c in (1, 2, 4, 8) if c <= E])
    probs = np.array([0.35, 0.35, 0.2, 0.1])[:len(support)]
    gaps = (rng.exponential(size=(B, K)) / RATE[cell]).astype(np.float32)
    return {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
            "c": rng.choice(support, (B, K), p=probs / probs.sum()).astype(np.int32),
            "model": np.zeros((B, K), np.int32),
            "noise": (0.004 * rng.standard_normal((B, K))).astype(np.float32)}


def _j(tr):
    return {k: jnp.asarray(v) for k, v in tr.items()}


def _t(tr):
    return {k: torch.from_numpy(np.array(v)) for k, v in tr.items()}


def _assert_state(js, ts, ctx):
    for f in JEV.EnvState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if f == "task_quality":
            np.testing.assert_allclose(b, a, atol=FLOAT_TOL, err_msg=f"{ctx} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {f}")


def _assert_metrics(jm, tm, ctx):
    assert set(jm) == set(tm), ctx
    for k in jm:
        a, b = np.asarray(jm[k]), np.asarray(tm[k])
        if k in INT_METRICS:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {k}")
        elif k == "episode_return":
            np.testing.assert_allclose(b, a, rtol=REWARD_RTOL, atol=FLOAT_TOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=f"{ctx} {k}")


def _port_state(js):
    return TEV.EnvState(*(torch.from_numpy(np.array(x)) for x in js))


# ---------------------------------------------------------------- greedy
@pytest.mark.parametrize("cell", ["paper-8srv", "paper-12srv"])
@pytest.mark.parametrize("steps", [0, 6, 25])
def test_greedy_act_matches_reference(cell, steps):
    """The same choice per env on states reached by a uniform rollout."""
    jcfg, tcfg = _cfgs(cell)
    tr = _np_traces(steps + 1, 6, cell)
    keys = jax.random.split(jax.random.PRNGKey(steps), 6)
    js = JRO.batch_rollout(jcfg, _j(tr), JRO.uniform_policy(jcfg), {}, keys,
                           num_steps=steps, fused_impl="ref").final_state \
        if steps else jax.vmap(lambda _: JEV.reset(jcfg))(jnp.arange(6))
    want = jax.vmap(lambda t, s: JBL.greedy_act(jcfg, t, s))(_j(tr), js)
    got = TBL.greedy_act(tcfg, _t(tr), _port_state(js))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (6, tcfg.action_dim)


def test_candidate_actions_match_reference():
    jcfg, tcfg = _cfgs("paper-8srv")
    np.testing.assert_array_equal(TBL.candidate_actions(tcfg),
                                  np.asarray(JBL._candidate_actions(jcfg)))


@pytest.mark.parametrize("cell", ["small", "paper-8srv", "paper-12srv"])
@pytest.mark.parametrize("name", ["greedy", "fifo"])
def test_closed_loop_matches_reference(cell, name):
    jcfg, tcfg = _cfgs(cell)
    tr = _np_traces(len(cell), 3, cell)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jpol = {"greedy": JRO.greedy_policy, "fifo": JRO.fifo_policy}[name]
    tpol = {"greedy": TRO.greedy_policy, "fifo": TRO.fifo_policy}[name]
    jr = JRO.batch_rollout(jcfg, _j(tr), jpol(jcfg), {}, keys, collect=True,
                           fused_impl="ref")
    got = TRO.batch_rollout(tcfg, _t(tr), tpol(tcfg), {}, collect=True,
                            device="cpu")
    ctx = f"{name} {cell}"
    _assert_state(jr.final_state, got.final_state, ctx)
    _assert_metrics(jr.metrics, got.metrics, ctx)
    np.testing.assert_array_equal(got.transitions.action.numpy(),
                                  np.asarray(jr.transitions.action), ctx)
    assert int(np.asarray(jr.metrics["num_scheduled"]).sum()) > 0


def test_greedy_prefers_quality_and_beats_random():
    """The reference's own checks of the baseline, on the port."""
    _, tcfg = _cfgs("small")
    tr = _t(_np_traces(3, 8, "small"))
    g = TRO.batch_rollout(tcfg, tr, TRO.greedy_policy(tcfg), {}, device="cpu")
    r = TRO.batch_rollout(tcfg, tr, TRO.uniform_policy(tcfg), {},
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert float(g.metrics["avg_steps"].mean()) > 0.8 * tcfg.s_max
    assert float(g.metrics["episode_return"].mean()) >= \
        float(r.metrics["episode_return"].mean())


def test_evaluate_policy_matches_reference():
    """The host-loop evaluator with the greedy act, one trace."""
    jcfg, tcfg = _cfgs("small")
    tr = _np_traces(9, 1, "small")
    one_j = {k: jnp.asarray(v[0]) for k, v in tr.items()}
    one_t = {k: torch.from_numpy(v[0]) for k, v in tr.items()}
    want = JBL.evaluate_policy(jcfg, one_j,
                               lambda k, s, o: JBL.greedy_act(jcfg, one_j, s),
                               jax.random.PRNGKey(0))
    got = TBL.evaluate_policy(
        tcfg, one_t, lambda g, s, o: TBL.greedy_act(tcfg, {
            k: v[None] for k, v in one_t.items()}, s), None, device="cpu")
    _assert_metrics(want, got, "evaluate_policy greedy")


def test_evaluate_policy_batch_is_the_rollout():
    _, tcfg = _cfgs("small")
    tr = _t(_np_traces(4, 4, "small"))
    got = TBL.evaluate_policy_batch(tcfg, tr, TRO.fifo_policy(tcfg),
                                    device="cpu")
    want = TRO.batch_rollout(tcfg, tr, TRO.fifo_policy(tcfg), {},
                             device="cpu").metrics
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), k)


# ------------------------------------------------------ sequence rollouts
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollout_sequence_matches_reference(seed):
    jcfg, tcfg = _cfgs("small")
    tr = _np_traces(seed, 1, "small")
    seq = np.random.default_rng(seed).uniform(
        size=(64, tcfg.action_dim)).astype(np.float32)
    jr, js = JBL.rollout_sequence(jcfg, {k: jnp.asarray(v[0]) for k, v in tr.items()},
                                  jnp.asarray(seq))
    tr_, ts = TBL.rollout_sequence(tcfg, {k: torch.from_numpy(v[0])
                                          for k, v in tr.items()},
                                   torch.from_numpy(seq))
    np.testing.assert_allclose(float(tr_), float(jr), rtol=REWARD_RTOL)
    _assert_state(js, ts, f"rollout_sequence {seed}")
    # the batched fitness is the sequence rollout, row by row
    fit = TBL.sequence_fitness(tcfg, {k: torch.from_numpy(v[0])
                                      for k, v in tr.items()},
                               torch.from_numpy(seq)[None], device="cpu")
    assert float(fit[0]) == float(tr_)


def _genetic_draws(key, gcfg, T, A):
    """The reference's draws of `_genetic_generation`, rebuilt from its
    key splits."""
    _, kc, kp1, kp2, km, kmv = jax.random.split(key, 6)
    n = gcfg.population - gcfg.elites
    return {"i1": jax.random.randint(kp1, (n,), 0, gcfg.parents),
            "i2": jax.random.randint(kp2, (n,), 0, gcfg.parents),
            "xmask": jax.random.bernoulli(kc, 0.5, (n, T, A)),
            "mmask": jax.random.bernoulli(km, gcfg.mutation_prob, (n, T, A)),
            "mval": jax.random.uniform(kmv, (n, T, A))}


@pytest.mark.parametrize("parents", [4, 10])
def test_genetic_generation_matches_reference(parents):
    """One generation at population 8, seq_len 64 (parents 10 > 8 takes
    the reference's clamped parent indices)."""
    jcfg, tcfg = _cfgs("small")
    gcfg = JBL.GeneticConfig(population=8, parents=parents, seq_len=64)
    tgcfg = TBL.GeneticConfig(population=8, parents=parents, seq_len=64)
    tr = _np_traces(5, 1, "small")
    one_j = {k: jnp.asarray(v[0]) for k, v in tr.items()}
    one_t = {k: torch.from_numpy(v[0]) for k, v in tr.items()}
    A = tcfg.action_dim
    # quantised genes make fitness ties likely, so the stable sort counts
    pop = np.round(np.random.default_rng(1).uniform(size=(8, 64, A)) * 4) / 4
    pop = pop.astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_pop, _ = JBL._genetic_generation(jcfg, gcfg, one_j, jnp.asarray(pop),
                                          key)
    want_fit = jax.vmap(lambda s: JBL.rollout_sequence(jcfg, one_j, s)[0])(
        jnp.asarray(pop))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _genetic_draws(key, gcfg, 64, A).items()}
    got_pop, got_fit = TBL._genetic_generation(tcfg, tgcfg, one_t,
                                               torch.from_numpy(pop),
                                               draws=draws)
    np.testing.assert_allclose(got_fit.numpy(), np.asarray(want_fit),
                               rtol=REWARD_RTOL)
    np.testing.assert_array_equal(got_pop.numpy(), np.asarray(want_pop))


def _harmony_draws(kb, hcfg, n, T, A):
    draws = {k: [] for k in ("pick", "use_mem", "rand", "adj", "bw")}
    for key in jax.random.split(kb, n):
        km, kr, kp, kbw, kn = jax.random.split(key, 5)
        draws["pick"].append(jax.random.randint(km, (T, A), 0, hcfg.memory_size))
        draws["use_mem"].append(jax.random.bernoulli(kr, hcfg.hmcr, (T, A)))
        draws["rand"].append(jax.random.uniform(kn, (T, A)))
        draws["adj"].append(jax.random.bernoulli(kp, hcfg.par, (T, A)))
        draws["bw"].append(jax.random.uniform(kbw, (T, A), minval=-1.0,
                                              maxval=1.0))
    return {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for k, v in draws.items()}


def test_harmony_round_matches_reference():
    """One round: improvise 4 candidates from a memory of 8 (seq_len 64),
    score them, merge them; memory and fitness equal the reference's."""
    jcfg, tcfg = _cfgs("small")
    hcfg = JBL.HarmonyConfig(memory_size=8, improvisations=4, improv_batch=4,
                             seq_len=64)
    thcfg = TBL.HarmonyConfig(memory_size=8, improvisations=4,
                              improv_batch=4, seq_len=64)
    tr = _np_traces(6, 1, "small")
    one_j = {k: jnp.asarray(v[0]) for k, v in tr.items()}
    one_t = {k: torch.from_numpy(v[0]) for k, v in tr.items()}
    A, T = tcfg.action_dim, 64
    mem = np.random.default_rng(2).uniform(size=(8, T, A)).astype(np.float32)
    jfit = jax.vmap(lambda s: JBL.rollout_sequence(jcfg, one_j, s)[0])
    kb = jax.random.PRNGKey(11)
    jnew = jax.vmap(lambda k, m: JBL._harmony_improvise(k, m, hcfg, T, A),
                    in_axes=(0, None))(jax.random.split(kb, 4), jnp.asarray(mem))
    jmem, jf = JBL._harmony_merge(jnp.asarray(mem), jfit(jnp.asarray(mem)),
                                  jnew, jfit(jnew))
    tnew = TBL._harmony_improvise(torch.from_numpy(mem), thcfg,
                                  _harmony_draws(kb, hcfg, 4, T, A))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    tmem = torch.from_numpy(mem)
    tf = TBL.sequence_fitness(tcfg, one_t, tmem, device="cpu")
    tmem, tf = TBL._harmony_merge(tmem, tf, tnew,
                                  TBL.sequence_fitness(tcfg, one_t, tnew,
                                                       device="cpu"))
    np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=REWARD_RTOL)


@pytest.mark.parametrize("which", ["genetic", "harmony"])
def test_meta_heuristic_schedules_run_and_improve(which):
    """A short schedule on the port returns a sequence whose fitness is its
    rollout's return and at least the best of its first population."""
    _, tcfg = _cfgs("small")
    one = {k: torch.from_numpy(v[0]) for k, v in _np_traces(8, 1, "small").items()}
    gen = torch.Generator().manual_seed(4)
    if which == "genetic":
        cfg = TBL.GeneticConfig(population=8, parents=4, generations=3,
                                seq_len=64)
        first = torch.rand((8, 64, tcfg.action_dim),
                           generator=torch.Generator().manual_seed(4))
        best, fit = TBL.genetic_schedule(tcfg, one, cfg, generator=gen,
                                         device="cpu")
    else:
        cfg = TBL.HarmonyConfig(memory_size=8, improvisations=8,
                                improv_batch=4, seq_len=64)
        first = torch.rand((8, 64, tcfg.action_dim),
                           generator=torch.Generator().manual_seed(4))
        best, fit = TBL.harmony_schedule(tcfg, one, cfg, generator=gen,
                                         device="cpu")
    assert best.shape == (64, tcfg.action_dim)
    assert float(fit) == float(TBL.rollout_sequence(tcfg, one, best)[0])
    assert float(fit) >= float(TBL.sequence_fitness(tcfg, one, first,
                                                    device="cpu").max())


# ------------------------------------------------ the rest of the rollout
@pytest.mark.parametrize("name", ["fifo", "uniform", "greedy"])
def test_unfused_and_episode_equal_fused(name):
    """rollout_episode and the unfused engine give the fused engine's
    trajectory exactly (the same draws in the same order)."""
    _, tcfg = _cfgs("small")
    tr = _t(_np_traces(2, 3, "small"))
    pol = {"fifo": TRO.fifo_policy, "uniform": TRO.uniform_policy,
           "greedy": TRO.greedy_policy}[name](tcfg)
    runs = [TRO.batch_rollout(tcfg, tr, pol, {}, collect=True, device="cpu",
                              generator=torch.Generator().manual_seed(3),
                              fused=fused) for fused in (True, False)]
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(runs[0].final_state, f),
                           getattr(runs[1].final_state, f)), f
    for f in TRO.Transitions._fields[:-1]:
        assert torch.equal(getattr(runs[0].transitions, f),
                           getattr(runs[1].transitions, f)), f
    one = TRO.batch_rollout(tcfg, {k: v[:1] for k, v in tr.items()}, pol, {},
                            collect=True, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    ep = TRO.rollout_episode(tcfg, {k: v[0] for k, v in tr.items()}, pol, {},
                             collect=True, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    for k, v in one.metrics.items():
        assert torch.equal(ep.metrics[k], v[0]), k
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(ep.final_state, f),
                           getattr(one.final_state, f)[0]), f
    assert torch.equal(ep.transitions.action, one.transitions.action[0])


def test_rollout_episode_matches_reference_and_resumes():
    jcfg, tcfg = _cfgs("small")
    tr = _np_traces(12, 1, "small")
    one_j = {k: jnp.asarray(v[0]) for k, v in tr.items()}
    one_t = {k: torch.from_numpy(v[0]) for k, v in tr.items()}
    jr = JRO.rollout_episode(jcfg, one_j, JRO.fifo_policy(jcfg), {},
                             jax.random.PRNGKey(0), num_steps=10)
    tr_ = TRO.rollout_episode(tcfg, one_t, TRO.fifo_policy(tcfg), {},
                              num_steps=10, device="cpu")
    _assert_state(jr.final_state, tr_.final_state, "episode 10")
    _assert_metrics(jr.metrics, tr_.metrics, "episode 10")
    # resumed from the carried state, the episode finishes as the
    # reference's does
    jr2 = JRO.rollout_episode(jcfg, one_j, JRO.fifo_policy(jcfg), {},
                              jax.random.PRNGKey(0), init_state=jr.final_state)
    tr2 = TRO.rollout_episode(tcfg, one_t, TRO.fifo_policy(tcfg), {},
                              init_state=tr_.final_state, device="cpu")
    _assert_state(jr2.final_state, tr2.final_state, "episode resumed")


def test_policy_factories_are_cached():
    _, tcfg = _cfgs("small")
    for factory in (TRO.uniform_policy, TRO.fifo_policy, TRO.greedy_policy,
                    TRO.sequence_policy):
        assert factory(tcfg) is factory(tcfg)
    assert TRO.fifo_policy(tcfg, 0.25) is not TRO.fifo_policy(tcfg)
