"""The port's distilled decision path (`repro_torch`) against the
reference (`repro`) on the CPU: the one-call denoiser (`denoise_eps_fused`,
the `denoiser_step` kernel's plain path), the distilled sampler and policy,
the distillation's teacher targets and student step, a whole distillation
run of the port, and parameter checkpoints in both directions.

The reference's `denoiser_step` runs in interpret mode, as its own tests
run it on the CPU. Its draws (per-sample x_T from the chain keys) are
rebuilt from its keys and handed to the port. Tolerances: 1e-6 on one MLP
forward, 2e-5 on a whole DDIM chain (as tests/test_torch_actor.py), 1e-6
on one Adam step of the student.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actors import samplers as JSMP
from repro.actors.policies import actor_policy as jactor_policy
from repro.actors.policies import init_student as jinit_student
from repro.common.checkpoint import restore_checkpoint
from repro.common.checkpoint import save_checkpoint as jsave_checkpoint
from repro.core import agent as JAG
from repro.core import diffusion as JDF
from repro.core import env as JEV
from repro.core import rollout as JRO
from repro.kernels.denoiser import ops as JKOPS
from repro.training import distill as JDIS
from repro.training import optimizer as JOPT
from repro_torch.actors import policies as TPOL
from repro_torch.actors import samplers as TSMP
from repro_torch.common import checkpoint as TCK
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import agent as TAG
from repro_torch.core import diffusion as TDF
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.kernels.denoiser import kernel as TKER
from repro_torch.kernels.denoiser import ops as TKOPS
from repro_torch.training import distill as TDIS
from repro_torch.training import optimizer as TOPT

ECFG = dict(num_servers=4, max_tasks=8, queue_window=4, max_steps=48)
JECFG, TECFG = JEV.EnvConfig(**ECFG), TEV.EnvConfig(**ECFG)
A = JECFG.action_dim
F = JECFG.obs_shape[1]
T = 4
H = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_torch(tree):
    return TCK.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               device="cpu")


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _obs(rng, B):
    return rng.uniform(0.0, 1.5, (B,) + JECFG.obs_shape).astype(np.float32)


# ------------------------------------------------------------- one-call denoiser
@pytest.mark.parametrize("batch", [(), (1,), (7,), (130,)],
                         ids=["1d", "b1", "b7", "b130"])
def test_denoise_eps_fused_matches_reference_kernel(batch):
    """The port's one-call path (plain on the CPU) against the reference's
    `denoiser_step` Pallas kernel in interpret mode; B = 130 spans two of
    the reference's 128-row blocks."""
    rng = np.random.default_rng(len(batch) and batch[0])
    p = JDF.init_denoiser(jax.random.PRNGKey(1), A, F, H)
    x = rng.standard_normal(batch + (A,)).astype(np.float32)
    i = rng.integers(1, T + 1, batch).astype(np.int32)
    f_s = rng.standard_normal(batch + (F,)).astype(np.float32)
    want = JKOPS.denoise_eps_fused(p, jnp.asarray(x), jnp.asarray(i),
                                   jnp.asarray(f_s), interpret=True)
    before = TKER.denoiser_step.launches
    got = TKOPS.denoise_eps_fused(_to_torch(p), _t(x), _t(i), _t(f_s))
    assert tuple(got.shape) == batch + (A,)
    _close(got, want, 1e-6)
    _close(got, TDF.denoise_eps(_to_torch(p), _t(x), _t(i), _t(f_s)), 1e-6)
    assert TKER.denoiser_step.launches == before      # CPU: no launch


@pytest.mark.parametrize("batch", [(), (1,), (7,), (130,)],
                         ids=["1d", "b1", "b7", "b130"])
def test_denoise_eps_fused_with_one_embedding_row_matches_reference(batch):
    """The distilled sampler's call: one embedding row for every row (the
    kernel reads it with row stride 0), from `step_embedding`'s cache,
    against the reference's `denoiser_step` Pallas kernel in interpret mode
    and `denoise_eps` on the per-row embedding of the same T, at 1e-5."""
    rng = np.random.default_rng(20 + (len(batch) and batch[0]))
    p = JDF.init_denoiser(jax.random.PRNGKey(2), A, F, H)
    x = rng.standard_normal(batch + (A,)).astype(np.float32)
    i = np.full(batch, T, dtype=np.int32)
    f_s = rng.standard_normal(batch + (F,)).astype(np.float32)
    want = JKOPS.denoise_eps_fused(p, jnp.asarray(x), jnp.asarray(i),
                                   jnp.asarray(f_s), interpret=True)
    tp = _to_torch(p)
    temb = TSMP.step_embedding(T, 16, torch.device("cpu"))
    assert tuple(temb.shape) == (16,)
    got = TKOPS.denoise_eps_fused(tp, _t(x), None, _t(f_s), temb=temb)
    assert tuple(got.shape) == batch + (A,)
    _close(got, want, 1e-5)
    _close(got, TDF.denoise_eps(tp, _t(x), _t(i), _t(f_s)), 1e-5)
    # the wrapper's own door: one row, or the row repeated per batch row
    if batch:
        w = TKOPS._flat_weights(tp)
        rows = temb.expand(batch + (16,)).contiguous()
        _close(TKER.denoiser_step(_t(x), temb, _t(f_s), *w),
               TKER.denoiser_step(_t(x), rows, _t(f_s), *w), 0)


def test_step_embedding_is_cached_per_step_and_width():
    """One tensor per (T, t_dim, device), equal to the embedding of T; a
    different T or t_dim gives a different row."""
    cpu = torch.device("cpu")
    a = TSMP.step_embedding(T, 16, cpu)
    assert TSMP.step_embedding(T, 16, cpu) is a
    np.testing.assert_array_equal(
        a.numpy(), TDF.timestep_embedding(torch.tensor([T]), 16)[0].numpy())
    _close(a, JDF.timestep_embedding(jnp.asarray(T), 16), 1e-6)
    other_t = TSMP.step_embedding(T + 1, 16, cpu)
    wider = TSMP.step_embedding(T, 32, cpu)
    assert tuple(other_t.shape) == (16,) and tuple(wider.shape) == (32,)
    assert not torch.equal(a, other_t)
    assert not torch.equal(a, wider[:16])
    _close(wider, JDF.timestep_embedding(jnp.asarray(T), 32), 1e-6)


def test_denoise_eps_fused_rejects_wrong_layer_count():
    p = _to_torch(JDF.init_denoiser(jax.random.PRNGKey(0), 3, 8, 16))
    args = (torch.zeros(2, 3), torch.ones(2, dtype=torch.int32),
            torch.zeros(2, 8))
    for n in (2, 4):
        with pytest.raises(ValueError, match="exactly 3 MLP layers"):
            TKOPS.denoise_eps_fused({"layers": (p["layers"] * 2)[:n]}, *args)


def test_distilled_sample_matches_reference():
    """Same x_T (the reference's first draw from the chain key): the port's
    distilled sampler, both impls, equals the reference's `impl="ref"`."""
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    student = JDF.init_denoiser(ks[0], A, F, H)
    f_s = jax.random.normal(ks[1], (6, F))
    want = JSMP.distilled_sample(student, f_s, ks[2], A, T, impl="ref")
    x_T = np.asarray(jax.random.normal(jax.random.split(ks[2])[0], (6, A)))
    tp = _to_torch(student)
    for impl in ("auto", "ref"):
        got = TSMP.distilled_sample(tp, _t(f_s), A, T, x_T=_t(x_T), impl=impl)
        _close(got, want, 1e-6, impl)
    # drawn from a generator, x_T is the sampler's only draw
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = TSMP.distilled_sample(tp, _t(f_s), A, T, generator=g1)
    _close(got, TSMP.distilled_sample(tp, _t(f_s), A, T,
                                      x_T=torch.randn((6, A), generator=g2)), 0)
    assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))
    with pytest.raises(ValueError, match="impl"):
        TSMP.distilled_sample(tp, _t(f_s), A, T, impl="pallas")


def test_distilled_sampler_parsing_and_gaussian_rejection():
    assert TSMP.parse_sampler(" Distilled ") == ("distilled", None)
    assert TSMP.normalize_sampler("distilled") == "distilled"
    for variant in ("eat-d", "eat-da"):
        with pytest.raises(ValueError, match="diffusion actor"):
            TPOL.actor_policy(TECFG, TAG.AgentConfig(variant=variant, T=T),
                              sampler="distilled", device="cpu")
    acfg = TAG.AgentConfig(variant="eat", T=T, hidden=H)
    student = TPOL.init_student(TECFG, acfg, generator=torch.Generator(),
                                device="cpu")
    want = jinit_student(jax.random.PRNGKey(0), JECFG,
                         JAG.AgentConfig(variant="eat", T=T, hidden=H))
    assert [tuple(x.shape) for x in tree_leaves(student)] == \
        [x.shape for x in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("deterministic", [False, True], ids=["sample", "det"])
def test_distilled_policy_is_student_plus_gaussian_head(deterministic):
    """The "distilled" policy draws x_T, then the exploration eps, and
    applies the sigma head to the student's mean."""
    acfg = TAG.AgentConfig(variant="eat", T=T, hidden=H)
    p = TAG.init_actor(TECFG, acfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    p["student"] = TPOL.init_student(
        TECFG, acfg, generator=torch.Generator().manual_seed(1), device="cpu")
    obs = _t(_obs(np.random.default_rng(2), 5))
    pol = TPOL.actor_policy(TECFG, acfg, deterministic=deterministic,
                            sampler="distilled", device="cpu")
    assert pol.sampler == "distilled"
    env_a, extras = pol(p, torch.Generator().manual_seed(9), None, None, obs)
    g = torch.Generator().manual_seed(9)
    f_s = TAG._encode(p, acfg, obs)
    mean = TSMP.distilled_sample(p["student"], f_s, A, T, generator=g)
    a, _ = TAG.gaussian_head(p, acfg, mean, generator=g,
                             deterministic=deterministic)
    _close(extras["agent_action"], a, 0)
    _close(env_a, TAG.to_env_action(a), 0)


def test_distilled_teacher_forced_matches_reference():
    """The reference's distilled actor acts; its actions replayed through
    the port's env give the same trajectory."""
    jacfg = JAG.AgentConfig(variant="eat", T=T, hidden=H)
    params = JAG.init_actor(jax.random.PRNGKey(1), JECFG, jacfg)
    params["student"] = jinit_student(jax.random.PRNGKey(2), JECFG, jacfg)
    rng = np.random.default_rng(3)
    gaps = rng.exponential(size=(4, 8)) / 0.08
    tr = {"arr_time": np.cumsum(gaps, axis=1).astype(np.float32),
          "c": rng.choice([1, 2, 4], (4, 8)).astype(np.int32),
          "model": np.zeros((4, 8), np.int32),
          "noise": (0.004 * rng.standard_normal((4, 8))).astype(np.float32)}
    jr = JRO.batch_rollout(JECFG, {k: jnp.asarray(v) for k, v in tr.items()},
                           jactor_policy(JECFG, jacfg, sampler="distilled"),
                           params, jax.random.split(jax.random.PRNGKey(4), 4),
                           collect=True, fused_impl="ref")
    jt = jax.tree_util.tree_map(np.asarray, jr.transitions)
    got = TRO.batch_rollout(TECFG, {k: _t(v) for k, v in tr.items()},
                            TRO.sequence_policy(TECFG), {"seq": _t(jt.action)},
                            collect=True, device="cpu")
    for f in JEV.EnvState._fields:
        a, b = np.asarray(getattr(jr.final_state, f)), \
            getattr(got.final_state, f).numpy()
        if f == "task_quality":
            _close(b, a, 1e-6, f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("valid", "done"):
        np.testing.assert_array_equal(getattr(got.transitions, f).numpy(),
                                      getattr(jt, f), err_msg=f)
    _close(got.transitions.next_obs.numpy(), jt.next_obs, 1e-6)
    np.testing.assert_array_equal(got.metrics["num_scheduled"].numpy(),
                                  np.asarray(jr.metrics["num_scheduled"]))
    assert int(np.asarray(jr.metrics["num_scheduled"]).sum()) > 0


# ------------------------------------------------------------- distillation
def _teacher():
    jacfg = JAG.AgentConfig(variant="eat-a", T=T, hidden=H)
    return jacfg, JAG.init_actor(jax.random.PRNGKey(0), JECFG, jacfg)


def test_teacher_targets_and_student_step_match_reference():
    jacfg, jp = _teacher()
    tacfg = TAG.AgentConfig(variant="eat-a", T=T, hidden=H)
    obs = _obs(np.random.default_rng(5), 12)
    kds = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(3),
                                                  jnp.arange(12))
    jf, jx0, jxT = JDIS._teacher_targets(jp, jnp.asarray(obs), kds,
                                         ecfg=JECFG, acfg=jacfg)
    x_T = np.asarray(jax.vmap(lambda kd: jax.random.normal(
        jax.random.split(kd)[0], (A,)))(kds))
    np.testing.assert_array_equal(x_T, np.asarray(jxT))
    tp = _to_torch(jp)
    tf, tx0, txT = TDIS._teacher_targets(tp, _t(obs), ecfg=TECFG, acfg=tacfg,
                                         x_T=_t(x_T))
    _close(tf, jf, 1e-5, "f_s")
    _close(tx0, jx0, 2e-5, "x0")
    assert torch.equal(txT, _t(x_T))

    js = jinit_student(jax.random.PRNGKey(6), JECFG, jacfg)
    js2, jopt, jloss = JDIS._student_step(js, JOPT.adam_init(js), jf, jx0, jxT,
                                          acfg=jacfg, lr=1e-3)
    ts_ = _to_torch(js)
    ts2, topt, tloss = TDIS._student_step(ts_, TOPT.adam_init(ts_), _t(jf),
                                          _t(jx0), _t(jxT), acfg=tacfg,
                                          lr=1e-3)
    _close(tloss, jloss, 1e-6, "loss")
    assert int(topt.step) == int(jopt.step) == 1
    for name, a, b in (("student", js2, ts2), ("mu", jopt.mu, topt.mu)):
        for w, g in zip(jax.tree_util.tree_leaves(a), tree_leaves(b)):
            _close(g.numpy(), w, 1e-6, name)


def test_port_distill_reduces_loss_and_tracks_teacher():
    """As tests/test_actors.py asks of the reference: the loss halves, and
    on unseen x_T draws the student lands far closer to the teacher's DDIM
    endpoint than an untrained student."""
    acfg = TAG.AgentConfig(variant="eat-a", T=T, hidden=H)
    gen = torch.Generator().manual_seed(0)
    teacher = TAG.init_actor(TECFG, acfg, generator=gen, device="cpu")
    obs = torch.randn((64,) + TECFG.obs_shape, generator=gen)
    dcfg = TDIS.DistillConfig(steps=300, batch=128, dataset=512,
                              noise_per_obs=16, log_every=100)
    params, hist = TDIS.distill_actor(teacher, TECFG, acfg, dcfg, obs=obs,
                                      generator=gen, device="cpu")
    assert params["denoiser"] is teacher["denoiser"]
    assert set(params) == set(teacher) | {"student"}
    assert [h["step"] for h in hist] == [0, 100, 200, 299]
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"]

    sched = TDF.vp_schedule(T, device="cpu")
    f_s = TAG._encode(teacher, acfg, obs[:1]).expand(32, -1)
    x_T = torch.randn((32, A), generator=torch.Generator().manual_seed(9))
    want = TSMP.chain_sample(teacher["denoiser"], sched, f_s, A, kind="ddim",
                             K=T, x_T=x_T)
    got = TSMP.distilled_sample(params["student"], f_s, A, T, x_T=x_T)
    fresh = TSMP.distilled_sample(
        TPOL.init_student(TECFG, acfg, generator=torch.Generator().manual_seed(5),
                          device="cpu"), f_s, A, T, x_T=x_T)
    err = (got - want).abs().mean().item()
    err_fresh = (fresh - want).abs().mean().item()
    assert err < 0.6 * err_fresh, (err, err_fresh)


def test_distill_collects_its_own_observations():
    """Without `obs` the teacher's deterministic rollouts supply them."""
    acfg = TAG.AgentConfig(variant="eat", T=2, hidden=16)
    gen = torch.Generator().manual_seed(1)
    teacher = TAG.init_actor(TECFG, acfg, generator=gen, device="cpu")
    obs = TDIS.collect_obs(teacher, TECFG, acfg, episodes=2, num_steps=12,
                           generator=gen, device="cpu")
    assert obs.ndim == 3 and tuple(obs.shape[1:]) == TECFG.obs_shape
    assert 0 < obs.shape[0] <= 24
    params, hist = TDIS.distill_actor(
        teacher, TECFG, acfg,
        TDIS.DistillConfig(steps=3, batch=8, dataset=16, collect_episodes=2,
                           collect_steps=12), generator=gen, device="cpu")
    assert "student" in params and len(hist) == 1
    assert np.isfinite(hist[0]["loss"])


def test_distill_rejects_gaussian_teacher_and_tracer(monkeypatch, tmp_path):
    """A Gaussian teacher is refused. A recording tracer (accepted since the
    port has telemetry) gets the reference's spans: the same names,
    categories and args around the student's steps."""
    from repro.telemetry import trace as JT
    from repro_torch.telemetry import trace as TT
    acfg = TAG.AgentConfig(variant="eat-d", T=T, hidden=H)
    teacher = TAG.init_actor(TECFG, acfg, generator=torch.Generator(),
                             device="cpu")
    with pytest.raises(ValueError, match="diffusion teacher"):
        TDIS.distill_actor(teacher, TECFG, acfg, device="cpu")
    acfg = TAG.AgentConfig(variant="eat", T=T, hidden=H)
    jacfg = JAG.AgentConfig(variant="eat", T=T, hidden=H)
    kw = dict(steps=2, batch=4, dataset=8, log_every=0)
    obs = np.random.default_rng(0).uniform(
        size=(6,) + TECFG.obs_shape).astype(np.float32)
    jtr = JT.Tracer(JT.TraceConfig(enabled=True, path=str(tmp_path / "j")))
    JDIS.distill_actor(jax.random.PRNGKey(1),
                       JAG.init_actor(jax.random.PRNGKey(0), JECFG, jacfg),
                       JECFG, jacfg, JDIS.DistillConfig(**kw),
                       obs=jnp.asarray(obs), tracer=jtr)
    ttr = TT.Tracer(TT.TraceConfig(enabled=True, path=str(tmp_path / "t")))
    TDIS.distill_actor(
        TAG.init_actor(TECFG, acfg, generator=torch.Generator().manual_seed(0),
                       device="cpu"),
        TECFG, acfg, TDIS.DistillConfig(**kw), obs=torch.from_numpy(obs),
        tracer=ttr, generator=torch.Generator().manual_seed(1), device="cpu")

    def spans(tr):
        return [(e["name"], e["cat"], e["ph"], e["args"]) for e in tr.events]
    assert spans(ttr) == spans(jtr) == [
        ("distill", "train", "X", {"steps": 2, "samples": 8, "depth": 0})]
    with pytest.raises(ValueError, match="steps"):
        TDIS.DistillConfig(steps=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDIS.distill_actor({}, TECFG, acfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPOL.init_student(TECFG, acfg)


# ------------------------------------------------------------- checkpoints
def test_checkpoints_round_trip_with_the_reference(tmp_path):
    """An actor plus student saved by the port restores through the
    reference's `restore_checkpoint` into a JAX-initialised target, and a
    reference-saved one loads into the port, with equal arrays."""
    jacfg = JAG.AgentConfig(variant="eat", T=T, hidden=H)
    tacfg = TAG.AgentConfig(variant="eat", T=T, hidden=H)
    gen = torch.Generator().manual_seed(2)
    tp = TAG.init_actor(TECFG, tacfg, generator=gen, device="cpu")
    tp["student"] = TPOL.init_student(TECFG, tacfg, generator=gen,
                                      device="cpu")
    final = TCK.save_checkpoint(str(tmp_path / "port"), 3, tp)
    assert final.endswith("3")
    target = JAG.init_actor(jax.random.PRNGKey(0), JECFG, jacfg)
    target["student"] = jinit_student(jax.random.PRNGKey(1), JECFG, jacfg)
    restored = restore_checkpoint(str(tmp_path / "port"), target)
    want = jax.tree_util.tree_leaves(restored)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())

    jsave_checkpoint(str(tmp_path / "ref"), 5, target)
    loaded = TCK.load_params(str(tmp_path / "ref"), device="cpu")
    for g, w in zip(tree_leaves(loaded), jax.tree_util.tree_leaves(target)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the port reads its own checkpoints back, and overwrites a step whole
    TCK.save_checkpoint(str(tmp_path / "port"), 3, tp)
    again = TCK.load_params(str(tmp_path / "port"), device="cpu")
    for g, w in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(g, w)
