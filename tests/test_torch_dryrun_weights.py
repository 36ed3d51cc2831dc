"""Decode keeps weights, experts and the embedding table on their shards
in the dry-run (`launch.reshard.matmul_partition`, the weight-stationary
product; `sharding.context.lookup_rows`, the masked lookup).

* The byte rule as a pure function of shapes and placements: at 8 tokens a
  device the product is weight-stationary, at 65,536 the weight is
  gathered (tinyllama's projections, an expert einsum, on 16 x 16 and 2 x
  16 x 16); the masked lookup likewise at decode and at train.
* On a fake (2, 4) world, a reduced tinyllama and a reduced olmoe decode
  step at batch 8: no collective at `linear`'s matmul, `embed`'s lookup or
  the expert einsums moves more than the step's (B, d) activation; each
  op's FLOPs a device are an eighth of the plain global trace's, as before;
  the collectives and the peak are below the weight-gathering figures.
* A reduced train step on (2, 2): the same record as before, and
  `matmul_weight_stationary` empty.
* Unarmed, `embed`, `linear` and `_moe_buffers` are bit-equal to verbatim
  copies of the versions before the seam; on plain tensors the masked
  lookup summed over n row slices equals `table[tokens]` exactly.
* On 4 gloo ranks, (2, 2): the weight-stationary products (both layouts,
  mm and bmm) and the masked lookup on real DTensors against plain
  tensors. The spawned ranks never import JAX (nothing here does).
"""
import inspect
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.common import config as TCFG
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import reshard as RS
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.sharding.context import activation_sharding, \
    constrain_moe, lookup_local_rows, lookup_rows, masked_lookup_cheaper, \
    scatter_along
from repro_torch.sharding.specs import NamedSharding

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from dryrun_sites import _site  # noqa: E402

MM, BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)


# ------------------------------------------- the byte rule, pure
# (op, left (rows -> shape), left placements, right shape, right
# placements, (b)'s left placements) on (data, model); rows = 16 x tokens
# a device. tinyllama-1.1b's wq, wk, wo, ffn down and lm_head, and
# qwen3-moe's gate and down experts (E over `model`, one slot a token).
RULES = [
    (MM, lambda r: (r, 2048), [S0, R], (2048, 2048), [S0, S1], [S1, R]),
    (MM, lambda r: (r, 2048), [S0, R], (2048, 256), [S0, S1], [S1, R]),
    (MM, lambda r: (r, 2048), [S0, R], (2048, 2048), [S1, S0], [R, S1]),
    (MM, lambda r: (r, 5632), [S0, S1], (5632, 2048), [S1, S0], [R, S1]),
    (MM, lambda r: (r, 2048), [S0, R], (2048, 32000), [S0, S1], [S1, R]),
    (BMM, lambda r: (128, r, 2048), [S1, S0], (128, 2048, 768), [S1, S0],
     [S2, S0]),
    (BMM, lambda r: (128, r, 768), [S1, S0], (128, 768, 2048), [S2, S0],
     [R, S0]),
]


@pytest.mark.parametrize("pod", [False, True])
@pytest.mark.parametrize("tokens", [8, 65536])
@pytest.mark.parametrize("rule", range(len(RULES)))
def test_byte_rule_by_tokens_a_device(rule, tokens, pod):
    op, left, lpl, rshape, rpl, placed = RULES[rule]
    sizes, rows = (16, 16), 16 * tokens
    if pod:
        # the batch over (`pod`, `data`), the weights replicated over `pod`
        sizes, rows = (2, 16, 16), 2 * rows
        lpl, rpl, placed = [lpl[0]] + lpl, [R] + rpl, [lpl[0]] + placed
    lshape = left(rows)
    data = 1 if pod else 0
    part = RS.matmul_partition(op, lshape, lpl, rshape, rpl, sizes, 2, 2,
                               batch_dims=(0, 1) if pod else (0,))
    assert part.reduce == []
    if tokens == 8:
        assert (part.gather, part.stationary) == ([], [data])
        assert part.left == placed
    else:
        assert (part.gather, part.stationary) == ([data], [])
        assert part.left is None


def test_byte_rule_leaves_partial_biased_and_model_dim_products():
    """(b) needs a right operand split, not a partial sum, a product with
    no bias (`addmm`) and a batch mesh dim (the train step's weight
    gradients meet split activations over `model`): elsewhere the right
    operand is gathered at any size."""
    args = ((128, 2048), [S0, R], (2048, 2048))
    assert RS.matmul_partition(MM, *args, [Partial(), S1], (16, 16), 2, 2,
                               batch_dims=(0,)).stationary == []
    part = RS.matmul_partition(torch.ops.aten.addmm.default, *args,
                               [S0, S1], (16, 16), 2, 2, batch_dims=(0,))
    assert (part.gather, part.stationary) == ([0], [])
    # tinyllama train_4k's weight gradient x^T @ dy on 16 x 16
    part = RS.matmul_partition(MM, (2048, 1048576), [S1, S0],
                               (1048576, 2048), [S0, S0], (16, 16), 2, 2,
                               batch_dims=(0,))
    assert (part.gather, part.stationary) == ([1], [])


@pytest.mark.parametrize("batch,seq,masked", [(128, 1, True), (1, 1, True),
                                              (256, 4096, False),
                                              (32, 32768, False)])
def test_masked_lookup_rule(batch, seq, masked):
    """tinyllama's (32000, 2048) table, (`model`, `data`), at decode_32k,
    long_500k (one row, replicated), train_4k and prefill_32k."""
    ids_pl = [S0 if batch % 16 == 0 else R, R]
    assert masked_lookup_cheaper((32000, 2048), [S1, S0], (batch, seq),
                                 ids_pl, (16, 16), 2) is masked


# ------------------------------------------- fake (2, 4) world
@pytest.fixture
def fake_world():
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


def _lines(fn, text):
    """The `file:line`s of `fn`'s source lines holding `text`, as
    `tools/dryrun_sites.py` names a model line."""
    src, start = inspect.getsourcelines(fn)
    path = inspect.getsourcefile(fn).split("src/")[-1]
    return {f"{path}:{start + i}" for i, line in enumerate(src)
            if text in line}


@pytest.fixture
def each_collective(monkeypatch):
    """The (model line, output bytes) of every collective the dry-run's
    counter sees."""
    seen = []
    counted = HA.CollectiveCounter.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        out = counted(self, func, types, args, kwargs)
        pkt = getattr(func, "_overloadpacket", None)
        if out is not NotImplemented and pkt in self.comm_registry:
            seen.append((_site()[0], HA._nbytes(out)))
        return out
    monkeypatch.setattr(HA.CollectiveCounter, "__torch_dispatch__", dispatch)
    return seen


# the parent tree's records of the same steps (the weights gathered):
# collective bytes a device, peak bytes, FLOPs by op. olmoe's router
# (d, E) has no `model` split, so its products repeat over `model`.
GATHERED = {"tinyllama-1.1b": (1089856.0, 2962992,
                               {"aten.mm": 3145728, "aten.bmm": 524288}),
            "olmoe-1b-7b": (1110528.0, 2971184,
                            {"aten.mm": 1589248, "aten.bmm": 2097152})}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_decode_keeps_weights_on_their_shards(fake_world, each_collective,
                                              arch):
    mesh = fake_world((2, 4), ("data", "model"))
    cfg = TCFG.get_config(arch).reduced()
    shape = TSH.ShapeSpec("d", "decode", 256, 8)
    rec = HA.analyze(TST.lower_case(
        TST.build_case(cfg, shape, mesh, impl="ref"), mesh))
    sites = (_lines(TL.linear, "x @") | _lines(TL.embed, "lookup_rows(")
             | _lines(TB._moe_buffers, "torch.einsum("))
    assert len(sites) == 5
    activation = 8 * cfg.d_model * 2                    # (B, d) in bf16
    moved = [b for line, b in each_collective if line in sites]
    assert moved and max(moved) <= activation, sorted(moved)[-5:]
    assert sum(b for _, b in each_collective) == rec["collective_bytes"]
    assert rec["policy"]["matmul_weight_stationary"]["aten.mm.default"]
    if cfg.moe is not None:
        assert rec["policy"]["matmul_weight_stationary"]["aten.bmm.default"]
        assert "aten.bmm.default" not in \
            rec["policy"]["matmul_right_replicated"]
    gathered, peak, flops = GATHERED[arch]
    assert rec["collective_bytes"] < gathered / 5
    assert rec["peak_device_bytes"] < peak
    assert {op: rec["flops_by_op"][op] for op in flops} == flops
    local = HA.LocalCounter()
    case = TST.build_case(cfg, shape, mesh, impl="ref")
    with local:
        case.fn(*case.arg_structs)
    for op in ("aten.mm", "aten.bmm") if cfg.moe is None else ("aten.bmm",):
        assert rec["flops_by_op"][op] * 8 == local.flops[op], op


# the parent tree's record of this step: collectives by kind, FLOPs by op,
# peak bytes
TRAIN = {"tinyllama-1.1b": ({"all-gather": 9840640.0,
                             "reduce-scatter": 4392448.0,
                             "all-reduce": 3169288.0, "ops": 137},
                            {"aten.mm": 1476395008, "aten.bmm": 75497472},
                            16020564),
         "olmoe-1b-7b": ({"all-gather": 12865536.0,
                          "reduce-scatter": 4796928.0,
                          "all-reduce": 1371272.0, "ops": 158},
                         {"aten.mm": 741343232, "aten.bmm": 578813952},
                         15795284)}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_train_step_keeps_the_weight_gather(fake_world, arch):
    """64 tokens a device: every product gathers its weight, as before."""
    mesh = fake_world((2, 2), ("data", "model"))
    cfg = TCFG.get_config(arch).reduced()
    rec = HA.analyze(TST.lower_case(TST.build_case(
        cfg, TSH.ShapeSpec("t", "train", 64, 8), mesh, impl="ref"), mesh))
    coll, flops, peak = TRAIN[arch]
    assert {k: v for k, v in rec["collectives"].items()
            if k != "total"} == coll
    assert rec["flops_by_op"] == flops
    assert rec["peak_device_bytes"] == peak
    assert rec["policy"]["matmul_weight_stationary"] == {}
    assert rec["policy"]["matmul_right_replicated"]


# ------------------------------------------- unarmed: bit for bit
def _old_linear(p, x):
    """`linear` before the seam, verbatim."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _old_embed(p, tokens, dtype=torch.float32):
    """`embed` before the seam, verbatim."""
    return p["table"].to(dtype)[tokens]


def _old_moe_buffers(p, x, topi, topw, e: int, cap: int):
    """`_moe_buffers` before the seam, verbatim."""
    b, s, d = x.shape
    k = topi.shape[-1]
    flat_e = topi.reshape(b, s * k)                             # (B, S*k)
    onehot = F.one_hot(flat_e, e)                               # (B, S*k, E)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(
        2, flat_e[..., None])[..., 0]                           # rank
    keep = pos < cap
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    dest = torch.where(keep, slot, e * cap)[..., None].expand(b, s * k, d)
    # zeros placed as x (a DTensor's `new_zeros` is replicated: the whole
    # global batch's buffer on every device)
    buf = scatter_along(torch.zeros_like(x[:, :1]).expand(b, e * cap + 1, d),
                        1, dest, x[:, tok])
    buf = constrain_moe(buf[:, :e * cap].reshape(b, e, cap, d))
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["gate"].to(x.dtype))) * \
        torch.einsum("becd,edf->becf", buf, p["up"].to(x.dtype))
    out_e = constrain_moe(torch.einsum("becf,efd->becd", h,
                                       p["down"].to(x.dtype)))
    got = out_e.reshape(b, e * cap, d).gather(
        1, slot[..., None].expand(b, s * k, d))                 # (B, S*k, d)
    w = (topw.reshape(b, s * k) * keep).to(x.dtype)
    return (got * w[..., None]).reshape(b, s, k, d).sum(2)


def _randn(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unarmed_layers_are_bit_equal(dtype):
    g = torch.Generator().manual_seed(0)
    emb = TL.init_embedding(g, 100, 32)
    tokens = torch.randint(0, 100, (3, 7), generator=g)
    assert torch.equal(TL.embed(emb, tokens, dtype),
                       _old_embed(emb, tokens, dtype))
    lin = TL.init_linear(g, 32, 48, bias=True)
    x = _randn(3, 7, 32, seed=1).to(dtype)
    assert torch.equal(TL.linear(lin, x), _old_linear(lin, x))
    # armed with plain tensors: the indexed lookup too
    with activation_sharding(NamedSharding(None, (None, None, None))):
        assert torch.equal(lookup_rows(emb["table"].to(dtype), tokens),
                           _old_embed(emb, tokens, dtype))


@pytest.mark.parametrize("cap", [1, 3])
def test_unarmed_moe_buffers_are_bit_equal(cap):
    e, d, f, b, s, k = 4, 16, 24, 2, 5, 2
    p = {"gate": _randn(e, d, f, seed=2), "up": _randn(e, d, f, seed=3),
         "down": _randn(e, f, d, seed=4)}
    x = _randn(b, s, d, seed=5)
    probs = torch.softmax(_randn(b, s, e, seed=6), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    assert torch.equal(TB._moe_buffers(p, x, topi, topw, e, cap),
                       _old_moe_buffers(p, x, topi, topw, e, cap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_masked_lookup_sums_to_the_lookup(n, dtype):
    table = _randn(64, 12, seed=7).to(dtype)
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, 64, (3, 5)))
    step = 64 // n
    got = sum(lookup_local_rows(table[a:a + step], tokens, a)
              for a in range(0, 64, step))
    assert torch.equal(got, table[tokens])


# ------------------------------------------- real collectives, 4 ranks
def _gloo_rank(rank, world, path, result):
    """One rank of a (2, 2) gloo mesh (`data`, `model`): products under
    `ReshardPolicy` (which takes the weight-stationary partition at these
    sizes) and the armed masked lookup, on DTensors, gathered whole
    against the plain results."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        errs = []
        # (op, left, its placements, right, its placements): a
        # projection (x @ wq), the attention's output (o @ wo, o whole
        # over `model`), the FFN's down, the experts' gate and down
        for op, ls, lp, rs, rp in [
                (torch.mm, (4, 32), [S0, R], (32, 64), [S0, S1]),
                (torch.mm, (4, 64), [S0, R], (64, 32), [S1, S0]),
                (torch.mm, (4, 64), [S0, S1], (64, 32), [S1, S0]),
                (torch.bmm, (2, 4, 32), [S1, S0], (2, 32, 16), [S1, S0]),
                (torch.bmm, (2, 4, 16), [S1, S0], (2, 16, 32), [S2, S0])]:
            a, w = _randn(*ls, seed=len(errs)), _randn(*rs, seed=9)
            policy = RS.ReshardPolicy(dp_dims=(0,))
            with policy:
                got = op(distribute_tensor(a, mesh, lp),
                         distribute_tensor(w, mesh, rp))
            assert policy.stationary and not policy.gathers, op
            assert list(got.placements)[0] == lp[0]
            want = op(a, w)
            errs.append(((got.full_tensor() - want).abs().max()
                         / want.abs().max()).item())
        # 65 rows: the vocab split uneven (33 and 32 rows a device)
        table = _randn(65, 32, seed=10)
        for batch, pl in ((4, [S0, R]), (1, [R, R])):
            tokens = torch.from_numpy(np.random.default_rng(11).integers(
                0, 65, (batch, 1)))
            assert masked_lookup_cheaper(table.shape, [S1, S0], tokens.shape,
                                         pl, (2, 2), 4)
            with activation_sharding(NamedSharding(
                    mesh, ("data" if batch == 4 else None, None, None))):
                got = lookup_rows(distribute_tensor(table, mesh, [S1, S0]),
                                  distribute_tensor(tokens, mesh, pl))
            # placed as the token activations, as `constrain` places them
            assert list(got.placements) == [pl[0], R]
            errs.append(float(not torch.equal(got.full_tensor(),
                                              table[tokens])))
        if rank == 0:
            result.put(errs)
    finally:
        dist.destroy_process_group()


def test_stationary_products_and_lookup_on_four_gloo_ranks(tmp_path):
    """Real collectives: the weight-stationary products within 1e-6 of the
    plain products' largest magnitude (fp32: their partial sums add in
    another order), the masked lookup equal to the plain lookup exactly (a
    batch split over `data`, and one row replicated)."""
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
    assert len(errs) == 7 and all(e < 1e-6 for e in errs), errs
