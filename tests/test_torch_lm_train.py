"""LM training through the port's model zoo on the CPU, against the
reference: the Markov token pipeline (`repro_torch.training.data`),
`Model.loss` and its gradients for every assigned architecture (reduced),
activation checkpointing, the train step, `train_lm`'s checkpoint and the
`launch.train` CLI.

Weights are drawn by the reference and carried across as numpy through
`params_from_jax`; batches come from numpy seeds. On the CPU the attention
and the scan run as their kernels' plain versions inside the port's
autograd Functions (the path the card's backward kernels are held to).
Tolerances:

* the loss at 1e-5 relative, each gradient leaf at 1e-4 of its largest
  magnitude: fp32 sums in other orders through <= 8 layers (the
  reference's chunked associative scan and blockwise attention against the
  port's sequential and plain ones);
* `remat=True` against `remat=False`: exact (the same operations, run
  again);
* three train steps: loss and grad norm at 1e-5 relative; each param
  leaf's change from the start at 5e-3 of its largest change (Adam's
  m / (sqrt(v) + eps) is ill-conditioned where |g| is near eps, so a
  gradient that differs at 1e-7 moves such an entry's update by up to
  ~1e-3 of the step; measured 1.3e-3 on the embedding table);
* the token pipeline byte for byte.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JCFG
from repro.common.checkpoint import restore_checkpoint as jrestore
from repro.models.zoo import build_model as jbuild
from repro.training import data as JDATA
from repro.training import optimizer as JOPT
from repro.training import train_loop as JTL
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import tree_leaves, tree_paths
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import zoo as TZOO
from repro_torch.training import data as TDATA
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train_loop as TTL

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
UPDATE_TOL = 5e-3


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _arch(name):
    jc = JCFG.get_config(name).reduced()
    tc = TCFG.get_config(name).reduced()
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(11))
    return jc, tc, jm, jp


def _batch(cfg, B, S, seed):
    """tokens and labels (a few -100), and the frontend's input."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} > {tol} x {scale}"


# ------------------------------------------------------------------ data
def test_markov_tokens_byte_identical_to_reference():
    cfg = dict(vocab_size=300, seq_len=17, batch_size=3, seed=5)
    jd = JDATA.MarkovTokens(JDATA.DataConfig(**cfg))
    td = TDATA.MarkovTokens(TDATA.DataConfig(**cfg))
    assert TDATA.DataConfig() == TDATA.DataConfig(
        **vars(JDATA.DataConfig()))
    for _ in range(3):
        jb, tb = jd.sample_batch(), td.sample_batch()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            assert jb[k].tobytes() == tb[k].tobytes(), k


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("name", TCFG.ASSIGNED_ARCHS)
def test_model_loss_and_grads_match_reference(name):
    jc, tc, jm, jp = _arch(name)
    # Jamba's reduced period crosses a 64-step scan chunk
    S = 70 if jc.layer_pattern == "jamba" else 20
    batch = _batch(jc, 2, S, seed=len(name))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True))(jp)
    tm = TZOO.build_model(tc)
    tloss, tmet, tgrads = TOPT.value_and_grad(
        lambda p: tm.loss(p, _tbatch(batch)), _carry(jp))
    _rel_close(tloss.numpy(), jloss, LOSS_RTOL, "loss")
    for key in ("nll", "ntokens") + (("aux",) if "aux" in jmet else ()):
        _rel_close(tmet[key].detach().numpy(), jmet[key], LOSS_RTOL, key)
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jgrads))
    tflat = tree_paths(tgrads)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        if np.abs(want).max() == 0:
            assert float(tflat[key].abs().max()) == 0.0, key
        else:
            _rel_close(tflat[key].numpy(), want, GRAD_TOL, key)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "tinyllama-1.1b"])
def test_remat_gives_the_same_loss_and_grads(name):
    _, tc, _, jp = _arch(name)
    batch = _tbatch(_batch(tc, 2, 20, seed=4))
    tm = TZOO.build_model(tc)
    runs = [TOPT.value_and_grad(lambda p: tm.loss(p, batch, remat=r),
                                _carry(jp)) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- steps
def test_train_step_matches_reference_for_three_steps():
    jc, tc, jm, jp = _arch("olmoe-1b-7b")
    tcfg = dict(lr=3e-3, warmup=2, total_steps=3)
    jstep = JTL.make_train_step(jm, JTL.TrainConfig(**tcfg))
    tstep = TTL.make_train_step(TZOO.build_model(tc), TTL.TrainConfig(**tcfg))
    start = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    jstate, tparams = JOPT.adam_init(jp), _carry(jp)
    tstate = TOPT.adam_init(tparams)
    data = JDATA.MarkovTokens(JDATA.DataConfig(
        vocab_size=jc.vocab_size, seq_len=16, batch_size=2, seed=3))
    for step in range(3):
        batch = data.sample_batch()
        jp, jstate, jloss, jnorm = jstep(
            jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, tloss, tnorm = tstep(tparams, tstate,
                                              _tbatch(batch))
        _rel_close(tloss.numpy(), jloss, STEP_TOL, f"loss {step}")
        _rel_close(tnorm.numpy(), jnorm, STEP_TOL, f"grad norm {step}")
    assert int(tstate.step) == 3
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    for key, val in tree_paths(tparams).items():
        _rel_close(val.numpy() - start[key], jflat[key] - start[key],
                   UPDATE_TOL, key)


def test_train_lm_checkpoint_reads_in_the_reference(tmp_path):
    _, tc, jm, jp = _arch("xlstm-125m")
    tcfg = TTL.TrainConfig(total_steps=2, warmup=1, log_every=1,
                           ckpt_dir=str(tmp_path))
    dcfg = TDATA.DataConfig(vocab_size=tc.vocab_size, seq_len=8,
                            batch_size=2)
    params, history = TTL.train_lm(tc, tcfg, dcfg, seed=1, verbose=False,
                                   device="cpu")
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["step_ms"] > 0 for h in history)
    restored = jrestore(str(tmp_path), jax.tree_util.tree_map(np.asarray, jp))
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, restored))
    tflat = tree_paths(params)
    assert sorted(jflat) == sorted(tflat)
    for key, val in tflat.items():
        np.testing.assert_array_equal(jflat[key], val.numpy(), err_msg=key)


def test_launch_train_runs_on_the_cpu(capsys):
    history = TLAUNCH.main(["--device", "cpu", "--steps", "3", "--batch",
                            "2", "--seq", "32"])
    assert [h["step"] for h in history] == [0, 2]
    out = capsys.readouterr().out
    assert "training tinyllama-1.1b-reduced" in out and "final loss" in out
    args = TLAUNCH.parse_args([])
    assert args.device == "cuda" and args.reduced
    assert not TLAUNCH.parse_args(["--full"]).reduced


def test_in_place_adam_equals_the_functional_update():
    """`clip_by_global_norm_` and `adam_apply_` (the train step's donated
    update) give the functional `clip_by_global_norm`, `adam_update` and
    `apply_updates` bit for bit, tiny gradients included."""
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((5, 3), generator=g),
              "b": [torch.randn(7, generator=g)]}
    state = TOPT.adam_init(params)
    clone = lambda t: TOPT.tree_map(torch.clone, t)  # noqa: E731
    for step in range(3):
        grads = {"a": 1e-9 * torch.randn((5, 3), generator=g),
                 "b": [torch.randn(7, generator=g)]}
        lr = TOPT.cosine_schedule(state.step, 1e-2, 1, 10)
        clipped, norm = TOPT.clip_by_global_norm(grads, 1.0)
        updates, want_state = TOPT.adam_update(clipped, state, params, lr,
                                               weight_decay=0.01)
        want = TOPT.apply_updates(params, updates)
        got, got_grads = clone(params), clone(grads)
        got_state = TOPT.AdamState(state.step, clone(state.mu),
                                   clone(state.nu))
        assert torch.equal(TOPT.clip_by_global_norm_(got_grads, 1.0), norm)
        got_state = TOPT.adam_apply_(got_grads, got_state, got, lr,
                                     weight_decay=0.01)
        assert int(got_state.step) == step + 1
        for a, b in zip(tree_leaves((want, want_state.mu, want_state.nu)),
                        tree_leaves((got, got_state.mu, got_state.nu))):
            assert torch.equal(a, b)
        params, state = want, want_state
