"""The dry-run's scaled recurrences (`repro_torch.sharding.loops`): the
Mamba scan's plain version, the mLSTM and the sLSTM loops, each traced as
step 0 plus step 1 counted for steps 1 .. n - 1, forward and backward.

* At S = 128 on a fake (2, 2) mesh, a reduced Jamba-like hybrid (a Mamba
  layer and an attention layer with experts) and reduced xlstm-125m (three
  mLSTM blocks and an sLSTM block), train and prefill: the hybrid's train
  step with remat, as the dry-run runs it, xLSTM's without (its full
  trace is the costliest here, and remat's recomputation goes through the
  same `_StandIn`): the armed trace's FLOPs by op, bytes, collective
  bytes and counts by kind, reshards, dropped shards and the policy's
  counts equal the unarmed trace's (every step run) within 1 %
  (`SCALE_TOL`); `loops_scaled` names each loop with trip count 128.
* The same on plain CPU tensors for each block alone (d_model 64),
  forward and backward, with a prefill's cache written at its shapes.
* Unarmed, and armed at 1 or 2 steps (a decode), the loops give results
  bit-equal to the loops as they were written before the seam (kept
  verbatim here), states and gradients included.
* `LoopScaler`'s arithmetic: k more, none (-1), nested, and its record.
* The seam's direction: no module of `models/`, `kernels/` or `sharding/`
  imports `launch`.
"""
import ast
import contextlib
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.common import config as TCFG
from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels.ssm_scan.ref import CHUNK, ssm_scan_ref
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.models import blocks as TB
from repro_torch.models.layers import log_sigmoid
from repro_torch.sharding import loops as L
from repro_torch.training.optimizer import value_and_grad

SCALE_TOL = 0.01
S = 128
SCAN = "kernels/ssm_scan/ref.py:ssm_scan_ref"
MLSTM = "models/blocks.py:_mlstm_scan"
SLSTM = "models/blocks.py:_slstm_apply"


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


def _unarmed(monkeypatch):
    """`Lowered.analyze` with the scaler made but not armed: every step
    runs."""
    monkeypatch.setattr(L, "scaled_loops", lambda counters:
                        contextlib.nullcontext(L.LoopScaler(counters)))


def _hybrid():
    """jamba reduced cut to one period of 2: Mamba, attention with
    experts."""
    cfg = TCFG.get_config("jamba-v0.1-52b").reduced()
    return dataclasses.replace(cfg, attn_period=2, num_layers=2)


def _close(got, want, what):
    assert got == pytest.approx(want, rel=SCALE_TOL), what


def _same_counts(got, want):
    assert set(got) == set(want)
    for key, val in want.items():
        if isinstance(val, dict):
            _same_counts(got[key], val)
        else:
            _close(got[key], val, key)


# ------------------------------------------------------------- the LMs
@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["jamba-hybrid", "xlstm-125m"])
def test_scaled_loops_count_as_the_full_trace(fake_world, monkeypatch, arch,
                                              kind):
    mesh = fake_world((2, 2), ("data", "model"))
    cfg = (_hybrid() if arch == "jamba-hybrid"
           else TCFG.get_config(arch).reduced())
    shape = TSH.ShapeSpec("s", kind, S, 4)
    remat = arch == "jamba-hybrid"
    armed = HA.analyze(TST.lower_case(
        TST.build_case(cfg, shape, mesh, impl="ref", remat=remat), mesh))
    _unarmed(monkeypatch)
    full = HA.analyze(TST.lower_case(
        TST.build_case(cfg, shape, mesh, impl="ref", remat=remat), mesh))
    assert full["loops_scaled"] == {}

    # remat runs the forward twice
    passes = 2 if kind == "train" and remat else 1
    want = ({SCAN: {"loops": passes, "trip_count": S}}
            if arch == "jamba-hybrid" else
            {MLSTM: {"loops": 3 * passes, "trip_count": S},
             SLSTM: {"loops": passes, "trip_count": S}})
    assert armed["loops_scaled"] == want
    assert armed["hlo_flops"] > 0
    _same_counts(armed["flops_by_op"], full["flops_by_op"])
    _close(armed["hlo_bytes"], full["hlo_bytes"], "bytes")
    assert full["collectives"]["total"] > 0
    _same_counts(armed["collectives"], full["collectives"])
    for key in ("reshards", "shards_dropped", "policy"):
        _same_counts(armed[key], full[key])


# ------------------------------------------------ the blocks, plain tensors
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _block_case(block, s=S):
    """(params, cfg, x, cache) of one reduced block at d_model 64 on the
    CPU."""
    cfg = dataclasses.replace(_hybrid() if block == "mamba" else
                              TCFG.get_config("xlstm-125m").reduced(),
                              d_model=64)
    p = getattr(TB, f"init_{block}")(_gen(), cfg, cfg.ssm)
    cache = getattr(TB, f"init_{block}_cache")(cfg, cfg.ssm, 2)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    return p, cfg, x, cache


def _run_block(block, kind, p, cfg, x, cache):
    """A block's train forward and backward, or its prefill (the Mamba
    block on the scan's plain version, as the dry-run runs it)."""
    kw = {"impl": "ref"} if block == "mamba" else {}
    if kind == "prefill":
        return getattr(TB, f"{block}_prefill")(p, cfg, cfg.ssm, x, cache,
                                               **kw)[0]
    train = getattr(TB, f"{block}_train")
    return value_and_grad(lambda q: (
        train(q, cfg, cfg.ssm, x, **kw).square().sum(), None), p)[0]


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_scaled_block_counts_plain_tensors(block, kind):
    """Each loop alone on plain CPU tensors: the armed block's FLOPs and
    bytes equal the full loop's within `SCALE_TOL`; a prefill leaves its
    cache at its shapes."""
    p, cfg, x, cache = _block_case(block)
    shapes = {k: v.shape for k, v in cache.items()}
    rec = {}
    for armed in (True, False):
        local = HA.LocalCounter()
        arm = (L.scaled_loops((local,)) if armed
               else contextlib.nullcontext(L.LoopScaler((local,))))
        with local, arm as scaler:
            y = _run_block(block, kind, p, cfg, x, cache)
        assert y.shape == (x.shape if kind == "prefill" else ())
        rec[armed] = (sum(local.flops.values()), local.bytes, scaler.record())
    assert {k: v.shape for k, v in cache.items()} == shapes
    site = {"mamba": SCAN, "mlstm": MLSTM, "slstm": SLSTM}[block]
    assert rec[True][2] == {site: {"loops": 1, "trip_count": S}}
    assert rec[False][2] == {}
    _close(rec[True][0], rec[False][0], "flops")
    _close(rec[True][1], rec[False][1], "bytes")


# ----------------------------------------------- unarmed: as written before
def _old_ssm_scan_ref(dt, a, bm, cm, x, h0, *, chunk_states=False):
    f32 = torch.float32
    a32 = a.to(f32)
    h = h0.to(f32)
    ys, starts = [], []
    for t in range(dt.shape[1]):
        if chunk_states and t % CHUNK == 0:
            starts.append(h)
        da = torch.exp(dt[:, t, :, None].to(f32) * a32)
        h = da * h + (dt[:, t] * x[:, t])[..., None].to(f32) \
            * bm[:, t, None, :].to(f32)
        ys.append(torch.einsum("bin,bn->bi", h, cm[:, t].to(f32)))
    y = torch.stack(ys, dim=1).to(dt.dtype)
    if chunk_states:
        return y, h, torch.stack(starts, dim=1)
    return y, h


def _old_mlstm_scan(qkvif, state):
    q, k, v, igate, fgate = qkvif
    C, nvec, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], igate[:, t], fgate[:, t]
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])
        nvec = f_p[..., None] * nvec + i_p[..., None] * kt
        m = m_new
        num = torch.einsum("bhij,bhj->bhi", C, qt)
        den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", nvec, qt)),
                          min=1.0)
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1), {"C": C, "n": nvec, "m": m}


def _old_slstm_loop(wx, rk, state):
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(wx.shape[1]):
        rec = torch.einsum("bhj,hjk->bhk", h, rk)
        zt, it, ft, ot = torch.chunk(wx[:, t] + rec, 4, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        ft = log_sigmoid(ft)
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "h": h, "m": m}


def _new_slstm_loop(wx, rk, state):
    hs, (c, n, h, m) = L.scan(SLSTM, TB._slstm_step, tuple(
        state[k] for k in "cnhm"), (wx, rk), wx.shape[1])
    return hs, {"c": c, "n": n, "h": h, "m": m}


def _loop_inputs(loop, s, rng):
    """Random inputs (leaves that require grad) of one loop at length s."""
    f = lambda *shape, lo=-1.0, hi=1.0: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, shape).astype(np.float32)).requires_grad_(True)
    if loop == "scan":
        B, I, N = 2, 24, 8
        return (f(B, s, I, lo=0.01, hi=0.2), -f(I, N, lo=0.5, hi=2.0),
                f(B, s, N), f(B, s, N), f(B, s, I), f(B, I, N))
    B, nh, dh = 2, 2, 8
    state = ({"C": f(B, nh, dh, dh), "n": f(B, nh, dh),
              "m": f(B, nh, lo=-2.0, hi=0.0)} if loop == "mlstm" else
             {k: f(B, nh, dh) for k in "cnhm"})
    if loop == "mlstm":
        return tuple(f(B, s, nh, dh) for _ in range(3)) + (
            f(B, s, nh), f(B, s, nh, lo=-3.0, hi=0.0)), state
    return (f(B, s, nh, 4 * dh), f(nh, dh, 4 * dh)), state


def _call(loop, ins, new):
    if loop == "scan":
        return (ssm_scan_ref if new else _old_ssm_scan_ref)(*ins)
    if loop == "mlstm":
        return (TB._mlstm_scan if new else _old_mlstm_scan)(*ins)
    return (_new_slstm_loop if new else _old_slstm_loop)(*ins[0], ins[1])


@pytest.mark.parametrize("loop", ["scan", "mlstm", "slstm"])
def test_unarmed_loops_bit_equal_to_the_loops_before(loop):
    """The three loops through `sharding.loops.scan`, unarmed at S in {1, 2,
    65} and armed at S in {1, 2} (a decode runs every step): outputs, final
    states and every input's gradient bit-equal to the loops as written
    before the seam; the scan's chunk states too."""
    for s, armed in ((1, False), (2, False), (65, False), (1, True),
                     (2, True)):
        ins = _loop_inputs(loop, s, np.random.default_rng(s))
        outs = {}
        for new in (True, False):
            with L.scaled_loops(()) if armed else contextlib.nullcontext():
                got = tree_leaves(_call(loop, ins, new))
            seed = sum((o.double() * (i + 1)).sum()
                       for i, o in enumerate(got))
            outs[new] = got + list(torch.autograd.grad(seed, tree_leaves(ins)))
        for a, b in zip(outs[True], outs[False]):
            assert torch.equal(a, b), (loop, s, armed)
    if loop == "scan":
        ins = _loop_inputs(loop, 2 * CHUNK + 3, np.random.default_rng(7))
        for a, b in zip(ssm_scan_ref(*ins, chunk_states=True),
                        _old_ssm_scan_ref(*ins, chunk_states=True)):
            assert torch.equal(a, b)


# ---------------------------------------------------------- the arithmetic
class _Count:
    def __init__(self):
        self.n, self.by = 0, {}

    def snapshot(self):
        return self.n, dict(self.by)

    def restore(self, snap):
        self.n, self.by = snap[0], dict(snap[1])

    def add(self, key="op"):
        self.n += 1
        self.by[key] = self.by.get(key, 0) + 1


def test_loop_scaler_arithmetic():
    c = _Count()
    sc = L.LoopScaler((c,))
    c.add()
    with sc.repeated(4):                 # 1 + 4 times
        c.add("a")
        with sc.repeated(2):             # nested: 3 x 5 times
            c.add("b")
    with sc.repeated(-1):                # not at all
        c.add("c")
    assert (c.n, c.by) == (1 + 5 + 15, {"op": 1, "a": 5, "b": 15})
    sc.loops["x.py:f", 8] += 2
    sc.loops["x.py:g", 8] += 1
    sc.loops["x.py:g", 4] += 1
    assert sc.record() == {"x.py:f": {"loops": 2, "trip_count": 8},
                           "x.py:g@4": {"loops": 1, "trip_count": 4},
                           "x.py:g@8": {"loops": 1, "trip_count": 8}}
    assert L._SCALER.get() is None
    with L.scaled_loops((c,)) as armed:
        assert L._SCALER.get() is armed
    assert L._SCALER.get() is None


def test_models_and_kernels_do_not_import_launch():
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    files = [p for d in ("models", "kernels", "sharding")
             for p in sorted((src / d).rglob("*.py"))]
    assert src / "sharding" / "loops.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.startswith("repro_torch.launch")
                           for n in names), path
