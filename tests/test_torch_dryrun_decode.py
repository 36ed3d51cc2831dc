"""Decode on the KV cache's sequence shards (`sharding.context.write_slot`,
`on_seq_shards`; `models.attention.decode_partial`, `merge_partials`).

* On plain tensors: the split softmax over n in {1, 2, 4, 16} slices of a
  cache, merged, against the one-slice `decode_attention` (fp32, 1e-6) and
  the reference's `decode_attention` (2e-5, `test_torch_models.py`'s decode
  tolerance): cache_len an int and a (B,) tensor, GQA groups 1 and 4, a
  sliding window, a wrapped ring, slices with no valid slot. Such a slice
  has m = NEG_INF and a merge weight of exactly 0.
* On plain tensors: the masked local write on each slice, concatenated,
  equals the whole cache's indexed write exactly, a ring's index included.
* Unarmed, `decode_attention` and `attn_decode` are bit-equal to verbatim
  copies of the one-slice versions they replaced.
* On a fake (2, 4) world: a reduced tinyllama decode step (8 query heads
  over 2 KV heads: the query's GQA view refused by DTensor; and 8 over 8,
  olmoe's pattern) gathers no cache: the write at most the new token's K
  and V rows, the attention the query (B / 2 x H x hd a layer) and then
  all-reduces; `aten.bmm` counts a device's batch half and T quarter, an
  eighth of the plain global trace's.
* On 4 gloo ranks, (2, 2): `write_slot` and `decode_attention` on DTensor
  caches split over both axes, against plain tensors, real collectives.
  JAX is imported inside the one test that reads the reference, so the
  spawned ranks start without it.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.common import config as TCFG
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.models import attention as TATT
from repro_torch.models import blocks as TB
from repro_torch.models.layers import linear
from repro_torch.sharding.context import activation_sharding, \
    write_local_slot, write_slot
from repro_torch.sharding.specs import NamedSharding

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from dryrun_sites import site_rows, tally_sites  # noqa: E402

T = 64


def _inputs(b, h, kv, hd, t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(dtype))
                 for s in ((b, 1, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def _stacked(x, op):
    return x.amax(0) if op == "max" else x.sum(0)


def _split(q, k, v, cache_len, n, *, window=0, ring=False):
    """decode_attention as n slices of the cache, merged."""
    t = k.shape[1]
    step = t // n
    parts = [TATT.decode_partial(q, k[:, a:a + step], v[:, a:a + step],
                                 cache_len, a, t, window=window, ring=ring)
             for a in range(0, t, step)]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    b, _, h, hd = q.shape
    out = TATT.merge_partials(m, l, o, _stacked)
    return out.to(v.dtype).reshape(b, 1, h, hd).to(q.dtype)


# window, ring, cache_len: ints and (B,) lengths; 13 leaves 12 of 16
# slices with no valid slot, the window's lower edge empties the first ones,
# 100 and [70, 130, 40] wrap the 64-slot ring
CASES = [(0, False, 13), (0, False, [3, 40, 64]), (24, False, 50),
         (24, False, [10, 30, 64]), (T, True, 100), (T, True, [70, 130, 40])]


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window,ring,clen", CASES)
def test_split_softmax_matches_one_slice_and_reference(n, g, window, ring,
                                                       clen):
    import jax.numpy as jnp
    from repro.models import attention as JATT
    kv, hd = 2, 16
    q, k, v = _inputs(3, kv * g, kv, hd, T, seed=n + 7 * g + window)
    cache_len = clen if isinstance(clen, int) else \
        torch.tensor(clen, dtype=torch.int32)
    got = _split(q, k, v, cache_len, n, window=window, ring=ring)
    one = TATT.decode_attention(q, k, v, cache_len, window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=1e-6)
    want = JATT.decode_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                 jnp.asarray(np.asarray(clen, np.int32)),
                                 window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_empty_slice_weighs_exactly_zero():
    """A slice past cache_len: m is NEG_INF (finite), its merge weight
    exp(m - max) exactly 0, and the merge equals the valid slice's own
    normalised output."""
    q, k, v = _inputs(2, 4, 2, 16, T, seed=3)
    parts = [TATT.decode_partial(q, k[:, a:a + 32], v[:, a:a + 32], 10, a, T)
             for a in (0, 32)]
    m, l, o = (torch.stack(x) for x in zip(*parts))
    assert torch.all(m[1] == TATT.NEG_INF) and torch.isfinite(m[1]).all()
    assert torch.all(torch.exp(m[1] - _stacked(m, "max")) == 0)
    merged = TATT.merge_partials(m, l, o, _stacked)
    assert torch.equal(merged, o[0] / torch.clamp(l[0], min=1e-30))


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("pos,ring", [(0, False), (17, False), (63, False),
                                      (100, True), (191, True)])
def test_masked_local_write_matches_whole_write(n, pos, ring):
    _, cache, _ = _inputs(3, 1, 2, 16, T, seed=5)
    new = torch.randn((3, 2, 16), generator=torch.Generator().manual_seed(6))
    index = pos % T if ring else pos
    want = cache.clone()
    want[:, index] = new
    step = T // n
    slices = [cache[:, a:a + step].clone() for a in range(0, T, step)]
    for a, s in zip(range(0, T, step), slices):
        write_local_slot(s, index, new, a)
    assert torch.equal(torch.cat(slices, dim=1), want)


# ------------------------------------------- unarmed: bit for bit
def _old_decode_attention(q, k_cache, v_cache, cache_len, *, window=0,
                          ring=False):
    """`decode_attention` before the split softmax, verbatim."""
    b, _, h, hd = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    qg = TATT._gqa_split(q, kv)[:, 0]
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    sc = torch.einsum("bkgh,btkh->bkgt", qg.to(dt),
                      k_cache.to(dt)).to(torch.float32)
    sc = sc / math.sqrt(hd)
    pos = torch.arange(t, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        clen = cache_len.reshape(-1, 1)
        hi = torch.clamp(clen, max=t) if ring else clen
    else:
        clen = int(cache_len)
        hi = min(clen, t) if ring else clen
    valid = pos[None, :] < hi
    if window and not ring:
        valid = valid & (pos[None, :] >= clen - window)
    sc = torch.where(valid[:, None, None, :], sc, TATT.NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh",
                       (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype),
                       v_cache)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _old_attn_decode(p, cfg, x, cache, pos, *, window=0):
    """`attn_decode` before `write_slot`, verbatim (the past-the-end
    check aside)."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    ring = bool(window) and t == window
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = TB._qkv(p, cfg, x, positions)
    widx = pos % t if ring else pos
    cache["k"][:, widx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, widx] = v[:, 0].to(cache["v"].dtype)
    o = _old_decode_attention(q, cache["k"], cache["v"], pos + 1,
                              window=window, ring=ring)
    return linear(p["wo"], o.reshape(b, 1, -1)), cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,ring,clen", CASES)
def test_unarmed_decode_attention_is_bit_equal(dtype, window, ring, clen):
    q, k, v = (x.to(dtype) for x in _inputs(3, 8, 2, 16, T, seed=9))
    cache_len = clen if isinstance(clen, int) else torch.tensor(clen)
    assert torch.equal(
        TATT.decode_attention(q, k, v, cache_len, window=window, ring=ring),
        _old_decode_attention(q, k, v, cache_len, window=window, ring=ring))


@pytest.mark.parametrize("window,pos", [(0, 5), (16, 21)])
def test_unarmed_attn_decode_is_bit_equal(window, pos):
    cfg = dataclasses.replace(TCFG.get_config("tinyllama-1.1b").reduced(),
                              num_heads=8, num_kv_heads=2, head_dim=32)
    p = TB.init_attn(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    t = window or 32
    cache = {n: torch.randn((2, t, 2, 32), generator=torch.Generator()
                            .manual_seed(i + 2)) for i, n in enumerate("kv")}
    old = {n: c.clone() for n, c in cache.items()}
    got, _ = TB.attn_decode(p, cfg, x, cache, pos, window=window)
    want, _ = _old_attn_decode(p, cfg, x, old, pos, window=window)
    assert torch.equal(got, want)
    assert all(torch.equal(cache[n], old[n]) for n in "kv")


# ------------------------------------------- fake (2, 4) world
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


@pytest.mark.parametrize("kv", [2, 8])
def test_decode_step_runs_on_the_cache_shards(fake_world, kv):
    """Batch 4 over `data`, a 1024-slot cache over `model` (256 slots a
    device), 8 query heads of 32. The write and the attention gather no
    cache: the write at most the new token's K and V rows, the attention
    the query, and its other collectives are the softmax's all-reduces;
    `aten.bmm` is a device's slice. The sites' bytes (tools/dryrun_sites.py)
    add up to the record's."""
    mesh = fake_world((2, 4), ("data", "model"))
    cfg = dataclasses.replace(TCFG.get_config("tinyllama-1.1b").reduced(),
                              num_heads=8, num_kv_heads=kv, head_dim=32)
    shape = TSH.ShapeSpec("d", "decode", 1024, 4)
    with tally_sites() as made:
        rec = HA.analyze(TST.lower_case(
            TST.build_case(cfg, shape, mesh, impl="ref"), mesh))
    rows = site_rows(made[-1])
    assert sum(r["bytes"] for r in rows) == rec["collective_bytes"]
    write = [r for r in rows
             if r["model_line"].startswith("repro_torch/models/blocks.py")
             and r["port_line"].startswith("repro_torch/sharding/")]
    attn = [r for r in rows
            if r["model_line"].startswith("repro_torch/models/attention.py")]
    # the write places the new token's K / V rows (B / 2 x KV x hd, bf16)
    # as the cache's batch: an all-gather only where their heads were split
    row = 2 * kv * 32 * 2
    assert {r["kind"] for r in write} <= {"all-gather"}, write
    assert sum(r["bytes"] for r in write) <= cfg.num_layers * 2 * row
    # the attention: the query's all-gather (B / 2 x H x hd), then
    # all-reduces
    q_gather = [r for r in attn if r["kind"] == "all-gather"]
    assert sum(r["bytes"] for r in q_gather) <= cfg.num_layers * 2 * 8 * 32 * 2
    assert {r["kind"] for r in attn} <= {"all-gather", "all-reduce"}, attn
    assert {r["kind"] for r in attn if r not in q_gather} == {"all-reduce"}
    local_cache = 2 * 256 * kv * 32 * 2         # a device's K of one layer
    assert sum(r["bytes"] for r in write + q_gather) < local_cache
    local = HA.LocalCounter()
    case = TST.build_case(cfg, shape, mesh, impl="ref")
    with local:
        case.fn(*case.arg_structs)
    assert rec["flops_by_op"]["aten.bmm"] * 8 == local.flops["aten.bmm"]
    assert rec["flops_by_op"]["aten.bmm"] == \
        cfg.num_layers * 2 * 2 * 2 * 8 * 256 * 32


# ------------------------------------------- real collectives, 4 ranks
def _gloo_rank(rank, world, path, result):
    """One rank of a (2, 2) gloo mesh: `write_slot`, then
    `decode_attention`, on DTensor caches (batch over `data` and T over
    `model`, or a batch of 1 and T over both), the query's heads and the
    new rows' KV heads over `model`, armed; the caches and the outputs
    gathered whole against the plain write and the one-slice attention."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        errs = []
        # (batch, placements of the caches, pos, window, ring)
        for b, pl, pos, window, ring in [
                (2, [Shard(0), Shard(1)], 11, 0, False),
                (2, [Shard(0), Shard(1)], 3, 0, False),
                (2, [Shard(0), Shard(1)], 13, 6, False),
                (2, [Shard(0), Shard(1)], 37, 16, True),
                (1, [Shard(1), Shard(1)], 9, 16, True),
                (1, [Shard(1), Shard(1)], 14, 0, False)]:
            q, k, v = _inputs(b, 8, 2, 8, 16, seed=pos + window)
            new_k, new_v = (x[:, pos % 16] + 1.0 for x in (k, v))
            idx = pos % 16 if ring else pos
            want_k, want_v = k.clone(), v.clone()
            want_k[:, idx], want_v[:, idx] = new_k, new_v
            want = TATT.decode_attention(q, want_k, want_v, pos + 1,
                                         window=window, ring=ring)
            batch = [p if p == Shard(0) else Replicate() for p in pl]
            heads = [batch[0], Shard(1)]
            kd, vd = (distribute_tensor(x, mesh, pl) for x in (k, v))
            with activation_sharding(NamedSharding(
                    mesh, ("data" if b == 2 else None, None, None))):
                write_slot(kd, idx, distribute_tensor(new_k, mesh, heads))
                write_slot(vd, idx, distribute_tensor(new_v, mesh, heads))
                got = TATT.decode_attention(
                    distribute_tensor(q, mesh, [batch[0], Shard(2)]), kd, vd,
                    pos + 1, window=window, ring=ring)
            errs.append(max(
                (got.full_tensor() - want).abs().max().item(),
                float(not torch.equal(kd.full_tensor(), want_k)),
                float(not torch.equal(vd.full_tensor(), want_v))))
        if rank == 0:
            result.put(errs)
    finally:
        dist.destroy_process_group()


def test_seq_shards_on_four_gloo_ranks(tmp_path):
    """Real collectives: the masked local writes and the split softmax's
    all-reduces (max, then sums) on 4 gloo ranks equal the plain write
    exactly and the one-slice attention within 1e-6: slots in either T
    shard, a sliding window across the shard edge, a wrapped ring, and a
    batch of 1 with T split over both mesh dims (long_500k's layout)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, 4, tmp_path / "store", result))
             for r in range(4)]
    for p in procs:
        p.start()
    errs = result.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert all(e < 1e-6 for e in errs), errs
