"""The port's plain attention, `repro_torch.models.attention.flash_attention`:
the reference's blocked `flash_attention_jnp` (query blocks outer, KV blocks
inner, online softmax in f32) with its blocked backward (the reference's
custom VJP `flash_bwd`, KV blocks outer) as a `torch.autograd.Function`.
No GPU: inputs come from numpy seeds and go to both sides.

* The output and dq, dk, dv against `flash_attention_jnp` and `jax.vjp`
  of it, blocks of 32 at S = 100 and T = 100 or 72, causal, full and
  sliding-window masks, GQA with H / KV of 1, 2 and 4, a q_offset, fp32
  and bf16: the output at 2e-5 (fp32) / 3e-2 (bf16), the gradients at
  2e-4 / 3e-2, rtol = atol (PERF.md section 2's flash tolerances).
* A shard's heads (`h0`, `g`): each slice of query heads against the same
  heads of the whole; its dk and dv are partial sums that add up to the
  whole's. On a fake (2, 4) mesh `sharding.context.on_head_shards` runs the
  blocks on rank 0's shards (6 heads: an uneven split over 4) and places
  the output as q.
* Memory: no tensor of S x T elements per (batch, head) is made, forward
  or backward (a dispatch mode records every output's shape; the naive
  oracle trips it); on meta tensors the MemTracker peak at 2S stays under
  2.5x the peak at S (the oracle's quadruples).
* Real collectives on 4 gloo ranks, a (2, 2) mesh: the blocked attention
  on DTensors, the loss's vocab-parallel log-sum-exp and gold logits and
  the MoE dispatch's row scatter, values and gradients against plain
  tensors.
* The block loops through `sharding.loops.scan`: unarmed they are the loop
  over every block, bit for bit; armed (the dry-run) a reduced GQA LM's
  train step on a fake (2, 4) mesh counts the FLOPs and the collectives
  of the unarmed trace, with the nested KV loop's repeats multiplied
  inside the query loop's.
"""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.attention import flash_attention_jnp
from repro_torch.common import config as TCFG
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.models import attention as TA
from repro_torch.sharding import loops as L
from repro_torch.sharding.context import activation_sharding, on_head_shards
from repro_torch.sharding.specs import NamedSharding

# dtype -> (jax dtype, torch dtype, output tol, gradient tol)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-2)}
BLOCK = 32
HD = 16

# (case, B, S, T, H, KV, causal, window, q_offset)
CASES = [
    ("causal, GQA 2", 2, 100, 100, 4, 2, True, 0, 0),
    ("full, T 72, GQA 4", 2, 100, 72, 4, 1, False, 0, 0),
    ("window 20, MHA", 1, 100, 100, 4, 4, True, 20, 0),
    ("full, T 72, MHA", 1, 100, 72, 2, 2, False, 0, 0),
    ("window 9, GQA 4", 1, 100, 100, 8, 2, True, 9, 0),
    ("causal, q_offset 28, GQA 2", 2, 72, 100, 4, 2, True, 0, 28),
]


def _inputs(b, s, t, h, kv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, HD), (b, t, kv, HD), (b, t, kv, HD), (b, s, h, HD))]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_blocked_matches_reference_and_its_vjp(case, dname):
    _, b, s, t, h, kv, causal, window, q_offset = case
    jdt, tdt, otol, gtol = DTYPES[dname]
    q, k, v, do = _inputs(b, s, t, h, kv, seed=s + t + h + window)
    kw = dict(causal=causal, window=window, q_block=BLOCK, k_block=BLOCK,
              q_offset=q_offset)
    want_o, vjp = jax.vjp(lambda a, c, d: flash_attention_jnp(a, c, d, **kw),
                          *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    o = TA.flash_attention(tq, tk, tv, **kw)
    assert o.dtype == tdt and o.shape == (b, s, h, HD)
    assert type(o.grad_fn).__name__ == "BlockedAttentionBackward"
    got = torch.autograd.grad(o, (tq, tk, tv),
                              torch.from_numpy(do).to(tdt))
    _close(o.detach().float(), want_o.astype(jnp.float32), otol, "o")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        _close(g.float(), w.astype(jnp.float32), gtol, name)


def test_lse_is_the_rows_log_sum_exp():
    q, k, v, _ = _inputs(2, 100, 72, 4, 2, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = TA.BlockedAttention.apply(tq, tk, tv, False, 0, BLOCK, BLOCK,
                                       0, 2, 0)
    sc = torch.einsum("bshd,bthd->bsht", tq,
                      tk.repeat_interleave(2, dim=2)) / math.sqrt(HD)
    assert lse.shape == (2, 100, 4) and lse.dtype == torch.float32
    _close(lse, torch.logsumexp(sc, dim=-1), 2e-5, "lse")


# ------------------------------------------------------- a shard's heads
@pytest.mark.parametrize("h,kv,width", [(8, 2, 2), (8, 2, 4), (6, 2, 3),
                                        (4, 4, 1)])
def test_head_slices_add_up_to_the_whole(h, kv, width):
    """Query heads [h0, h0 + width) with the whole K / V (a shard whose K
    and V are replicated): the same output and dq as those heads of the
    whole, and dk, dv partial sums over the slices."""
    q, k, v, do = _inputs(2, 100, 100, h, kv, seed=h + width)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = dict(causal=True, window=0, q_block=BLOCK, k_block=BLOCK,
              q_offset=0)
    whole = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o = TA.flash_attention(*whole, **kw)
    dq, dk, dv = torch.autograd.grad(o, whole, tdo)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for h0 in range(0, h, width):
        part = [tq[:, :, h0:h0 + width].clone().requires_grad_(),
                tk.clone().requires_grad_(), tv.clone().requires_grad_()]
        o_p = TA.BlockedAttention.apply(*part, *kw.values(), h // kv, h0)[0]
        g = torch.autograd.grad(o_p, part, tdo[:, :, h0:h0 + width])
        torch.testing.assert_close(o_p, o[:, :, h0:h0 + width], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(g[0], dq[:, :, h0:h0 + width], rtol=0,
                                   atol=1e-5)
        dk_sum += g[1]
        dv_sum += g[2]
    torch.testing.assert_close(dk_sum, dk, rtol=0, atol=1e-5)
    torch.testing.assert_close(dv_sum, dv, rtol=0, atol=1e-5)


@pytest.fixture
def fake_world():
    """make(shape, names) -> a DeviceMesh on "cpu" over a fresh fake
    process group (this process is rank 0); destroyed after the test."""
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


@pytest.mark.parametrize("h,kv", [(8, 2), (6, 2), (8, 4)])
def test_on_head_shards_runs_rank_0s_heads(fake_world, h, kv):
    """On a (2, 4) mesh, q's batch over `data` and heads over `model` (6
    heads: 2, 2, 2 and 0 a rank), k and v replicated over `model` (split
    there too where `model` divides KV): rank 0's output is the plain
    attention of its batch rows and heads, placed as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_world((2, 4), ("data", "model"))
    q, k, v, _ = _inputs(4, 64, 64, h, kv, seed=h)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = TA.flash_attention(tq, tk, tv)
    hl = -(-h // 4)
    dq = DTensor.from_local(tq[:2, :, :hl], mesh, [Shard(0), Shard(2)],
                            run_check=False, shape=tq.shape,
                            stride=tq.stride())
    dk, dv = (DTensor.from_local(x[:2], mesh, [Shard(0), Replicate()],
                                 run_check=False, shape=x.shape,
                                 stride=x.stride()) for x in (tk, tv))
    with activation_sharding(NamedSharding(mesh, ("data", None, None))):
        out = TA.flash_attention(dq, dk, dv)
        calls = []
        on_head_shards(lambda *a: calls.append(a[3:]) or (a[0],), dq, dk, dv)
    assert isinstance(out, DTensor)
    assert tuple(out.placements) == (Shard(0), Shard(2))
    assert out.shape == tq.shape
    torch.testing.assert_close(out.to_local(), want[:2, :, :hl], rtol=0,
                               atol=1e-6)
    assert calls == [(h // kv, 0)]          # (g, h0) of rank 0


# ------------------------------------------------------------- memory
class _Shapes(TorchDispatchMode):
    """The largest number of elements any op output has per (batch,
    head)."""

    def __init__(self, bh):
        super().__init__()
        self.bh, self.most = bh, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor):
                self.most = max(self.most, o.numel() // self.bh)
        return out


def _fwd_bwd(fn, b, s, h, kv, device="cpu"):
    q, k, v = (torch.zeros(shape, device=device, requires_grad=True)
               for shape in ((b, s, h, 64), (b, s, kv, 64), (b, s, kv, 64)))
    o = fn(q, k, v)
    torch.autograd.grad(o, (q, k, v), torch.ones_like(o))


def test_no_tensor_of_s_by_t():
    b, s, h, kv = 1, 256, 4, 2
    blocked = _Shapes(b * h)
    with blocked:
        _fwd_bwd(lambda q, k, v: TA.flash_attention(
            q, k, v, q_block=BLOCK, k_block=BLOCK), b, s, h, kv)
    assert blocked.most <= s * 64, blocked.most     # q-sized: S x hd
    naive = _Shapes(b * h)
    with naive:
        _fwd_bwd(lambda q, k, v: TA.simple_attention(q, k, v, causal=True),
                 b, s, h, kv)
    assert naive.most >= s * s


def _meta_peak(fn, s):
    from torch.distributed._tools.mem_tracker import MemTracker
    mem = MemTracker()
    with mem:
        _fwd_bwd(fn, 1, s, 4, 2, device="meta")
    return sum(d["Total"] for d in mem.get_tracker_snapshot("peak").values())


def test_meta_peak_grows_linearly():
    blocked = [_meta_peak(lambda q, k, v: TA.flash_attention(q, k, v), s)
               for s in (2048, 4096)]
    assert blocked[1] < 2.5 * blocked[0], blocked
    naive = [_meta_peak(lambda q, k, v: TA.simple_attention(
        q, k, v, causal=True), s) for s in (2048, 4096)]
    assert naive[1] > 3 * naive[0], naive


# ------------------------------------------------------ the block loops
def test_unarmed_loops_run_every_block_bit_for_bit(monkeypatch):
    """`scan` unarmed, and armed at two blocks a loop (not scaled), is the
    loop over every block: the same output and gradients as a plain Python
    loop in its place."""
    q, k, v, do = _inputs(2, 64, 64, 4, 2, seed=3)

    def run():
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o = TA.flash_attention(*ts, q_block=BLOCK, k_block=BLOCK)
        return (o, *torch.autograd.grad(o, ts, torch.from_numpy(do)))
    seam = run()
    with L.scaled_loops(()) as armed:
        two = run()
    assert armed.record() == {}

    def loop(site, step, carry, xs, n):
        ys = []
        for t in range(n):
            carry, y = step(carry, xs, t)
            ys.append(y)
        if ys[0] is None:
            return None, carry
        if isinstance(ys[0], tuple):
            return tuple(torch.stack(c, 1) for c in zip(*ys)), carry
        return torch.stack(ys, 1), carry
    monkeypatch.setattr(TA, "scan", loop)
    plain = run()
    for a, b_, c in zip(seam, two, plain):
        assert torch.equal(a, c) and torch.equal(b_, c)


class _Count:
    def __init__(self):
        self.n = 0

    def snapshot(self):
        return self.n

    def restore(self, snap):
        self.n = snap


def test_nested_armed_scans_multiply():
    """A scan of 3 steps inside each step of a scan of 5: the inner step
    counted 15 times, the inner loop 5 times."""
    c = _Count()

    def inner(carry, xs, t):
        c.n += 1
        return carry, None

    def outer(carry, xs, t):
        L.scan("x.py:inner", inner, (), (), 3)
        return carry, torch.zeros(2)
    with L.scaled_loops((c,)) as scaler:
        ys, _ = L.scan("x.py:outer", outer, (), (), 5)
    assert c.n == 15 and ys.shape == (2, 5)
    assert scaler.record() == {"x.py:inner": {"loops": 5, "trip_count": 3},
                               "x.py:outer": {"loops": 1, "trip_count": 5}}


def _gqa_lm():
    """tinyllama reduced to 8 heads over 2 KV heads (head_dim 32), 2
    layers."""
    cfg = TCFG.get_config("tinyllama-1.1b").reduced()
    return dataclasses.replace(cfg, num_heads=8, num_kv_heads=2,
                               head_dim=32)


def test_armed_blocks_count_as_every_block(fake_world, monkeypatch):
    """The reduced GQA LM's train step at S = 4096 (8 query blocks of 512,
    4 KV blocks of 1024) on a (2, 4) mesh, with remat: the armed trace's
    FLOPs by op and collectives equal the unarmed trace's, which runs all
    32 blocks of each layer's forward, recomputation and backward."""
    mesh = fake_world((2, 4), ("data", "model"))
    shape = TSH.ShapeSpec("s", "train", 4096, 4)

    def trace():
        return HA.analyze(TST.lower_case(
            TST.build_case(_gqa_lm(), shape, mesh, impl="ref"), mesh))
    armed = trace()
    monkeypatch.setattr(L, "scaled_loops", lambda counters:
                        contextlib.nullcontext(L.LoopScaler(counters)))
    full = trace()
    assert full["loops_scaled"] == {}
    layers = 2
    assert armed["loops_scaled"] == {
        "models/attention.py:_fwd": {"loops": 2 * layers, "trip_count": 8},
        "models/attention.py:_fwd_q_block": {"loops": 16 * layers,
                                             "trip_count": 4},
        "models/attention.py:_bwd": {"loops": layers, "trip_count": 4},
        "models/attention.py:_bwd_kv_block": {"loops": 4 * layers,
                                              "trip_count": 8}}
    assert armed["flops_by_op"] == full["flops_by_op"]
    assert armed["collectives"] == full["collectives"]
    assert armed["hlo_bytes"] == pytest.approx(full["hlo_bytes"], rel=0.01)
    assert armed["reshards"] == full["reshards"]


# ------------------------------------------- real collectives, 4 ranks
def _gloo_rank(rank, world, path, kv, result):
    """One rank of a (2, 2) gloo mesh: the blocked attention on DTensors
    (batch over `data`, heads over `model`, K / V replicated there), the
    loss's vocab-parallel pieces and the MoE dispatch's row scatter
    (`scatter_along`), their values and gradients gathered whole, against
    plain tensors."""
    from repro_torch.sharding.context import scatter_along
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.layers import next_token_nll
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        q, k, v, do = (torch.from_numpy(x) for x in
                       _inputs(2, 40, 40, 6, kv, seed=11))
        logits = torch.randn((2, 40, 24), generator=torch.Generator()
                             .manual_seed(4))
        labels = torch.randint(-1, 24, (2, 40), generator=torch.Generator()
                               .manual_seed(5))

        src = torch.randn((2, 12, 8), generator=torch.Generator()
                          .manual_seed(6))
        rows = torch.randperm(13, generator=torch.Generator()
                              .manual_seed(7))[:12]
        index = rows[None, :, None].expand(2, 12, 8)

        def plain():
            xs = [t.clone().requires_grad_() for t in (q, k, v, logits, src)]
            o = TA.flash_attention(*xs[:3], q_block=16, k_block=16)
            nll, _ = next_token_nll(xs[3], labels)
            buf = torch.zeros((2, 13, 8)).scatter(1, index, xs[4])
            torch.autograd.backward([o, nll, buf],
                                    [do, torch.ones(()), torch.ones_like(buf)])
            return [o.detach(), nll.detach(), buf.detach()] + \
                [x.grad for x in xs]

        def placed(t, pl):
            return distribute_tensor(t, mesh, pl).requires_grad_()
        batch = [Shard(0), Replicate()]
        split = [Shard(0), Shard(2)]
        xs = [placed(q, split), placed(k, batch), placed(v, batch),
              placed(logits, split), placed(src, split)]
        with activation_sharding(NamedSharding(mesh, ("data", None, None))):
            o = TA.flash_attention(*xs[:3], q_block=16, k_block=16)
            nll, _ = next_token_nll(xs[3], distribute_tensor(labels, mesh,
                                                             batch))
            zeros = distribute_tensor(torch.zeros((2, 1, 8)), mesh, split)
            buf = scatter_along(zeros.expand(2, 13, 8), 1,
                                distribute_tensor(index, mesh, batch), xs[4])
            torch.autograd.backward(
                [o, nll, buf],
                [distribute_tensor(do, mesh, o.placements),
                 distribute_tensor(torch.ones(()), mesh, [Replicate()] * 2),
                 distribute_tensor(torch.ones((2, 13, 8)), mesh,
                                   buf.placements)])
        got = [o.full_tensor(), nll.full_tensor(), buf.full_tensor()] + \
            [x.grad.full_tensor() for x in xs]
        if rank == 0:
            result.put([(g - w).abs().max().item()
                        for g, w in zip(got, plain())])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kv", [2, 3])
def test_head_shards_and_vocab_loss_on_four_gloo_ranks(tmp_path, kv):
    """Real collectives: the attention's output and dq, dk, dv, the loss
    and its logits' gradient, a row scatter and its source's gradient, on
    4 gloo ranks, against the plain tensors: 1e-5. 6 query heads, 3 a
    `model` rank; 2 KV heads split over `model` as well, or 3 replicated
    there (KV head 1 read by both ranks' query heads: K's and V's
    gradients partial sums over `model`)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, 4, tmp_path / "store", kv, result))
             for r in range(4)]
    for p in procs:
        p.start()
    errs = result.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert max(errs) < 1e-5, errs
