"""The host-side plans of the port's CUDA kernels, on the CPU.

* `chain_plan` and `step_plan` (kernels/denoiser/kernel.py) give the
  denoiser_chain and denoiser_step kernels' cluster size C, row tile R and
  shared memory; they are pure Python. Every shape the port's paths give
  them must fit one CTA's shared memory with C dividing H into 32 columns,
  and an unsupported H or an overflow raises.
* `flash_plan` (kernels/flash_attention/kernel.py) gives the flash
  attention kernel's tiles and shared memory per (head dim, dtype); every
  head dim the models use must fit in fp32 and bf16, and a head dim the
  kernel is not built for raises. The strides it hands TMA are checked on
  CPU tensors.
* `EnvStepPlan` (kernels/env_step/kernel.py) binds the env_step kernel to
  one rollout's constants. A plan on the CPU checks the same tensors and
  takes the plain version, so its spec checks, its output carving and its
  pointer table are all reachable here; the launch itself runs only on the
  card (`chip_smoke.py` phase 2). `env_smem_bytes` mirrors the kernel's
  shared-memory slices (one per env) and must fit every shape.
* `ssm_plan` (kernels/ssm_scan/kernel.py) gives the scan kernel's chunk,
  run, segments, grid and shared memory; every shape the port's paths give
  it must fit a block's shared memory with two blocks resident per SM. A
  torch emulation of the kernel's segmented scan (runs folded, the
  channel's segments scanned with the chunk's carry first, runs swept
  again) is held to the JAX package's sequential oracle at 2e-5, which
  checks the combine order on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_scan_ref
from repro_torch.common import config as TCFG
from repro_torch.core import env as EV
from repro_torch.core import workload as WL
from repro_torch.kernels.denoiser import kernel as DK
from repro_torch.kernels.env_step import kernel as EK
from repro_torch.kernels.env_step import ops as EKO
from repro_torch.kernels.env_step.ref import env_step_ref
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssm_scan import kernel as SK

A, T_DIM, H = 10, 16, 256


# ------------------------------------------------------------- chain plan
@pytest.mark.parametrize("F", [12, 16, 20])
@pytest.mark.parametrize("B", [1, 3, 16, 256, 300, 4096])
def test_chain_plan_fits_every_path_shape(B, F):
    """Rollouts at 256, collection at 16, serving at 1, the distiller at
    its N = 4096; F of the 4-, 8- and 12-server cells."""
    plan = DK.chain_plan(B, A, F, T_DIM, H)
    assert plan.smem_bytes <= 232448 == DK.SMEM_LIMIT
    assert H % plan.C == 0 and H // plan.C == 32
    assert plan.C == 8 and plan.R == 16
    assert plan.tiles == -(-B // 16) and (plan.tiles - 1) * 16 < B
    assert plan.smem_bytes == DK.chain_smem_bytes(A, F, T_DIM)


def test_chain_plan_covers_the_card_at_the_main_path_shape():
    """B = 256 gives 16 clusters of 8 CTAs, 128 of 132 SMs; a B = 1
    serving decision runs on 8 SMs."""
    plan = DK.chain_plan(256, A, 16, T_DIM, H)
    assert (plan.C, plan.tiles, plan.C * plan.tiles) == (8, 16, 128)
    assert DK.chain_plan(1, A, 16, T_DIM, H).C == 8


@pytest.mark.parametrize("H_", [48, 64, 96, 128, 512])
def test_chain_plan_raises_on_unsupported_width(H_):
    with pytest.raises(ValueError, match=f"H={H_}; the kernel is compiled "
                       f"for H=256 only"):
        DK.chain_plan(256, A, 16, T_DIM, H_)


def test_chain_plan_raises_when_shared_memory_overflows():
    """W1's slice grows with F: past F = 846 a CTA's slices no longer fit
    a block's shared memory."""
    assert DK.chain_smem_bytes(A, 846, T_DIM) <= DK.SMEM_LIMIT \
        < DK.chain_smem_bytes(A, 847, T_DIM)
    with pytest.raises(ValueError, match="bytes of shared memory per CTA at "
                       "A=10 F=2000"):
        DK.chain_plan(256, A, 2000, T_DIM, H)


def test_chain_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="B=0"):
        DK.chain_plan(0, A, 16, T_DIM, H)
    with pytest.raises(ValueError, match="must each be <= 16"):
        DK.chain_plan(256, 17, 16, T_DIM, H)
    with pytest.raises(ValueError, match="must each be <= 16"):
        DK.chain_plan(256, A, 16, 32, H)


# ------------------------------------------------------------- step plan
@pytest.mark.parametrize("F", [12, 16, 20])
@pytest.mark.parametrize("B", [1, 16, 256, 300, 4096])
def test_step_plan_fits_every_path_shape(B, F):
    """The distilled decision at B = 256 (and 1 when serving), the student
    at the distiller's batch; F of the 4-, 8- and 12-server cells."""
    plan = DK.step_plan(B, A, F, T_DIM, H)
    assert plan.smem_bytes <= DK.SMEM_LIMIT
    assert (plan.C, plan.R) == (8, 16) and H // plan.C == 32
    assert plan.tiles == -(-B // 16) and (plan.tiles - 1) * 16 < B
    assert plan.smem_bytes == DK.step_smem_bytes(A, F, T_DIM)
    # fc1 reads [x, temb, f_s] padded to a multiple of 16 columns
    assert DK.step_smem_bytes(A, F, T_DIM) == DK.step_smem_bytes(
        A, -(-(A + T_DIM + F) // 16) * 16 - A - T_DIM, T_DIM)


@pytest.mark.parametrize("H_", [48, 64, 128, 512])
def test_step_plan_refuses_other_widths(H_):
    with pytest.raises(ValueError, match=f"denoiser_step kernel: H={H_}; "
                       f"the kernel is compiled for H=256 only"):
        DK.step_plan(256, A, 16, T_DIM, H_)


def test_step_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="B=0"):
        DK.step_plan(0, A, 16, T_DIM, H)
    with pytest.raises(ValueError, match="A=17 must be <= 16"):
        DK.step_plan(256, 17, 16, T_DIM, H)
    with pytest.raises(ValueError, match="bytes of shared memory per CTA"):
        DK.step_plan(256, A, 4000, T_DIM, H)


# ------------------------------------------------------------- flash plan
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
def test_flash_plan_fits_every_head_dim(hd, dtype):
    """Every head dim of the configs fits a block's shared memory in both
    dtypes, with a ring of two stages and tiles that keep the 128-byte
    swizzle's 1024-byte alignment."""
    plan = FK.flash_plan(hd, dtype)
    es = torch.finfo(dtype).bits // 8
    assert plan.smem_bytes <= DK.SMEM_LIMIT
    assert plan.stages >= 2 and plan.BQ in (64, 128)
    assert plan.threads == plan.BQ // 64 * 128 + 32    # + the producer warp
    assert (plan.BK * hd * es) % 1024 == 0 and (hd * es) % 128 == 0
    assert plan.BK % 16 == 0


def test_flash_plan_main_path_tiles():
    """tinyllama's fp32 prefill: 128 query rows by 64 keys, two consumer
    warpgroups; fp32 at hd 256 keeps its query block out of shared memory
    to fit two stages and the split tiles."""
    assert FK.flash_plan(64, torch.float32)[:4] == (128, 64, 2, True)
    assert FK.flash_plan(128, torch.float32)[:4] == (128, 32, 2, True)
    plan = FK.flash_plan(256, torch.float32)
    assert (plan.BQ, plan.q_in_smem) == (64, False)
    assert DK.SMEM_LIMIT - plan.smem_bytes < 4096


@pytest.mark.parametrize("hd", [32, 80, 96, 192, 512])
def test_flash_plan_raises_on_head_dims_it_does_not_take(hd):
    with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
        FK.flash_plan(hd, torch.float32)


def test_flash_plan_raises_on_dtype():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FK.flash_plan(64, torch.float16)


def test_flash_strides_for_tma():
    """Head-major views of the model's (B, S, H, hd) tensors pass as they
    are; a size-1 dimension's stride is replaced by a 16-byte multiple; a
    stride or base off 16 bytes raises."""
    q = torch.zeros(1, 40, 8, 64).transpose(1, 2)         # (B, H, S, hd)
    assert FK._strides("q", q, 4) == [40 * 8 * 64, 64, 8 * 64]
    # a size-1 batch with a stride of 3 elements gets the tensor's span
    odd = torch.as_strided(torch.zeros(40 * 8 * 64), (1, 8, 40, 64),
                           (3, 64, 8 * 64, 1))
    assert FK._strides("q", odd, 4) == [40 * 8 * 64, 64, 8 * 64]
    k = torch.zeros(2, 40, 2, 64).transpose(1, 2)
    assert FK._strides("k", k, 4) == [40 * 2 * 64, 64, 2 * 64]
    with pytest.raises(ValueError, match="k's strides"):
        FK._strides("k", torch.zeros(2, 40, 2, 66)[..., :64].transpose(1, 2),
                    4)
    with pytest.raises(ValueError, match="v must start on 16 bytes"):
        FK._strides("v", torch.zeros(2, 40, 2, 65)[..., 1:].transpose(1, 2),
                    4)


# ------------------------------------------------------------ env_step plan
def _setup(E=8, K=32, l=8, B=6, faults=False, seed=0):
    cfg = EV.EnvConfig(num_servers=E, max_tasks=K, queue_window=l)
    g = torch.Generator().manual_seed(seed)
    tc = WL.TraceConfig(num_tasks=K, arrival_rate=0.2, max_servers=E)
    traces = WL.make_trace_batch(tc, B, generator=g, device="cpu")
    if faults:
        rng = np.random.default_rng(seed)
        ds = rng.uniform(0.0, 80.0, (B, E, 3)).astype(np.float32)
        traces["f_down_start"] = torch.from_numpy(ds)
        traces["f_down_end"] = torch.from_numpy(ds + 5.0)
        traces["f_slow"] = torch.ones((B, E))
        traces["f_cold"] = torch.ones((B, 1))
    state = EV.reset(cfg, B, device="cpu")
    statics = EV.decision_statics(cfg, traces)
    q, _ = EV.reset_view(cfg, traces, state)
    action = torch.rand((B, cfg.action_dim), generator=g)
    return cfg, statics, state, action, q


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_env_step_plan_views_match_the_plain_outputs(faults):
    """The 18 carved views have the plain version's dtype and shape, in
    the kernel's output order, and the table holds their addresses."""
    cfg, statics, state, action, q = _setup(faults=faults)
    plan = EK.EnvStepPlan(cfg, statics, 6)
    views = plan.carve(plan.buffers())
    want = env_step_ref(cfg, statics, state, action, q)
    flat = list(want[0]) + list(want[1]) + list(want[2:])
    assert len(views) == len(flat) == 18
    for j, (v, w) in enumerate(zip(views, flat)):
        assert v.dtype == w.dtype and v.shape == w.shape, j
        assert v.is_contiguous()
        assert plan._table[len(EK._INPUTS) + j] == v.data_ptr()


def test_env_step_plan_views_are_disjoint_and_fresh():
    cfg, statics, *_ = _setup(B=5)
    plan = EK.EnvStepPlan(cfg, statics, 5)
    bufs = plan.buffers()
    assert {b.dtype for b in bufs.values()} == {torch.float32, torch.int32,
                                                torch.bool}
    views = plan.carve(bufs)
    spans = {}
    for v in views:
        lo = v.data_ptr()
        spans.setdefault(v.dtype, []).append((lo, lo + v.numel()
                                              * v.element_size()))
    total = 0
    for dtype, s in spans.items():
        s.sort()
        assert all(a[1] <= b[0] for a, b in zip(s, s[1:])), dtype
        total += sum(hi - lo for lo, hi in s)
    # the views tile the three buffers exactly
    assert total == sum(b.numel() * b.element_size() for b in bufs.values())
    again = plan.carve(plan.buffers())
    ptrs = {v.untyped_storage().data_ptr() for v in views}
    assert not ptrs & {v.untyped_storage().data_ptr() for v in again}


def test_env_step_plan_on_cpu_equals_plain_version():
    cfg, statics, state, action, q = _setup(seed=3)
    got = EK.EnvStepPlan(cfg, statics, 6)(state, action, q)
    want = env_step_ref(cfg, statics, state, action, q)
    for g, w in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert torch.equal(g, w)
    step = EKO.env_stepper(cfg, statics, 6, "cpu")
    for g, w in zip(step(state, action, q)[0], want[0]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name, bad", [
    ("time", lambda s, a, q: (s._replace(time=s.time.double()), a, q)),
    ("tsteps", lambda s, a, q: (s._replace(task_steps=s.task_steps[:, :-1]),
                                a, q)),
    ("free", lambda s, a, q: (s._replace(
        server_free_at=s.server_free_at.t().contiguous().t()), a, q)),
    ("staken", lambda s, a, q: (s._replace(
        steps_taken=s.steps_taken.long()), a, q)),
    ("action", lambda s, a, q: (s, a[:-1], q)),
    ("qvalid", lambda s, a, q: (s, a, q._replace(valid=q.valid.int()))),
    ("qqueued", lambda s, a, q: (s, a, q._replace(queued=q.queued[:, ::2]))),
])
def test_env_step_plan_check_names_the_wrong_tensor(name, bad):
    cfg, statics, state, action, q = _setup()
    plan = EK.EnvStepPlan(cfg, statics, 6)
    with pytest.raises(ValueError, match=f"env_step kernel: {name} must be"):
        plan(*bad(state, action, q))


@pytest.mark.parametrize("key, name", [("c", "c"), ("scale", "scale"),
                                       ("f_slow", "fslow")])
def test_env_step_plan_checks_statics_once(key, name):
    cfg, statics, *_ = _setup(faults=True)
    statics = dict(statics)
    statics[key] = statics[key][:-1]
    with pytest.raises(ValueError, match=f"env_step kernel: {name} must be"):
        EK.EnvStepPlan(cfg, statics, 6)


def test_env_stepper_rejects_unknown_impl():
    cfg, statics, *_ = _setup()
    with pytest.raises(ValueError, match="impl must be"):
        EKO.env_stepper(cfg, statics, 6, "cpu", impl="fast")


def test_env_step_takes_one_cpu_path_through_the_plan():
    """`env_stepper` gives a plan on the CPU too, and `env_step_fused`
    builds one per call, so both check the same tensors before the plain
    version runs."""
    cfg, statics, state, action, q = _setup()
    assert isinstance(EKO.env_stepper(cfg, statics, 6, "cpu"), EK.EnvStepPlan)
    with pytest.raises(ValueError, match="env_step kernel: action must be"):
        EKO.env_step_fused(cfg, statics, state, action.double(), q)
    got = EKO.env_step_fused(cfg, statics, state, action, q, impl="ref")
    want = env_step_ref(cfg, statics, state, action, q)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))


@pytest.mark.parametrize("faults", [0, 4], ids=["plain", "faults"])
@pytest.mark.parametrize("K", [30, 32])
@pytest.mark.parametrize("E", [4, 5, 8, 12])
def test_env_step_shared_memory_fits(E, K, faults):
    """The kernel's two slices (one per env) fit the 48 KB a block gets
    without opting in, at every server count of the cells, K 30 and 32,
    l 8, with and without 4 fault columns; each region starts on 16 bytes,
    so a slice is a multiple of 16 and a plan on the CPU carries the same
    size."""
    l, A = 8, 2 + 8
    smem = EK.env_smem_bytes(E, K, l, A, faults)
    assert smem % (16 * EK.ENV_WARPS) == 0
    assert smem <= 48 * 1024
    assert EK.env_smem_bytes(E, K, l, A, faults) >= EK.ENV_WARPS * 4 * (
        4 * E + 13 * K + A + l) + EK.ENV_WARPS * (l + K)
    cfg, statics, *_ = _setup(E=E, K=K, faults=bool(faults), B=3)
    F = statics["f_down_start"].shape[2] if faults else 0
    assert EK.EnvStepPlan(cfg, statics, 3).smem_bytes == \
        EK.env_smem_bytes(E, K, l, cfg.action_dim, F)


def test_env_step_shared_memory_by_region():
    """paper-8srv (E 8, K 32, l 8, A 10, no faults), region by region: 16
    bytes of scalars, 4 server rows of 32, 13 task rows of 128, the action
    (40 -> 48), the queue's 32 + 8 (-> 16) + 32 bytes, 5 work rows of 32
    and the 128 of priorities: 2224 bytes an env, 4448 a block."""
    assert EK.env_smem_bytes(8, 32, 8, 10, 0) == 2 * (
        16 + 4 * 32 + 13 * 128 + 48 + 32 + 16 + 32 + 5 * 32 + 128) == 4448
    # faults add two E x F windows (128 bytes each at F 4) and E slow factors
    assert EK.env_smem_bytes(8, 32, 8, 10, 4) == 4448 + 2 * (128 + 128 + 32)


# -------------------------------------------------------------- ssm plan
def _ssm_path_shapes():
    """(B, S, I, N) the port's paths give the scan: Jamba's prefill at full
    width (I 8192) for S from 1 to 2048, and the reduced configs of
    tests/test_torch_mamba.py (inner 512, batch 2) at their lengths."""
    jamba = TCFG.get_config("jamba-v0.1-52b")
    red = jamba.reduced()
    I, N = jamba.ssm.expand * jamba.d_model, jamba.ssm.state_dim
    Ir, Nr = red.ssm.expand * red.d_model, red.ssm.state_dim
    assert (I, N, Ir, Nr) == (8192, 16, 512, 16)
    return ([(1, S, I, N) for S in (1, 5, 63, 64, 65, 129, 1000, 2047, 2048)]
            + [(2, S, Ir, Nr) for S in (1, 12, 20, 28)]
            + [(1, 7, 16, 4), (2, 300, 520, 4)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,I,N", _ssm_path_shapes())
def test_ssm_plan_fits_every_path_shape(B, S, I, N, dtype):
    """Shared memory within a block's 227 KB, two blocks resident per SM
    (16 warps), the grid covering I by 32 channels and B, the chunks
    covering S."""
    plan = SK.ssm_plan(B, S, I, N, dtype)
    assert plan.smem_bytes <= SK.SMEM_LIMIT == DK.SMEM_LIMIT
    assert plan.blocks_per_sm >= 2
    assert plan.blocks_per_sm * plan.threads // 32 >= 16
    assert plan.chunk == plan.run * plan.segments == 64
    assert plan.threads == plan.channels * plan.segments == 256
    assert plan.grid == (-(-I // 32), B)
    assert (plan.chunks - 1) * plan.chunk < S <= plan.chunks * plan.chunk
    assert plan.smem_bytes == SK.ssm_smem_bytes(N, dtype.itemsize)


def test_ssm_plan_at_jamba_prefill():
    """256 blocks of 8 warps for 132 SMs at two per SM; 71,936 bytes of
    shared memory in fp32 (two stages of dt, x, y, B and C tiles, 33,408
    bytes each, and 5,120 of A' and carries), 39,168 in bf16."""
    plan = SK.ssm_plan(1, 2048, 8192, 16, torch.float32)
    assert (plan.grid, plan.chunks, plan.blocks_per_sm) == ((256, 1), 32, 2)
    assert plan.smem_bytes == 2 * 33408 + 5120 == 71936
    assert SK.ssm_plan(1, 2048, 8192, 16, torch.bfloat16).smem_bytes == 39168


@pytest.mark.parametrize("N", [1, 2, 8, 32])
def test_ssm_plan_raises_on_state_sizes_it_does_not_take(N):
    with pytest.raises(ValueError, match=f"state size {N} not in"):
        SK.ssm_plan(1, 64, 64, N, torch.float32)


def test_ssm_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        SK.ssm_plan(1, 64, 64, 16, torch.float16)
    with pytest.raises(ValueError, match="empty input"):
        SK.ssm_plan(1, 0, 64, 16, torch.float32)


def _segmented_scan(dt, a, bm, cm, x, h0):
    """The kernel's scan in torch, op for op in its combine order: S in
    chunks of P runs of R steps (zero steps past S); per run the cumulative
    pairs (prod a, h from 0) with a = 2^(dt A log2 e); the chunk's carry
    folded into segment 0's pair; an inclusive Hillis-Steele scan of the P
    pairs (the last level updates h only); each run swept from the end
    state of the segment before it; y summed over N."""
    P, R = SK.SSM_SEGMENTS, SK.SSM_RUN
    L = P * R
    B, S, I = dt.shape
    nc = -(-S // L)

    def chunks(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, nc * L - S))
        return t.reshape(B, nc, P, R, t.shape[-1])
    dt, x, bm, cm = (chunks(t) for t in (dt, x, bm, cm))
    a2 = a * torch.tensor(1.4426950408889634, dtype=torch.float32)
    h = h0.clone()
    ys = []
    for k in range(nc):
        e = torch.exp2(dt[:, k, ..., None] * a2)          # (B, P, R, I, N)
        u = (dt[:, k] * x[:, k])[..., None] * bm[:, k, :, :, None, :]
        ca, cb = [e[:, :, 0]], [u[:, :, 0]]
        for r in range(1, R):
            ca.append(ca[-1] * e[:, :, r])
            cb.append(e[:, :, r] * cb[-1] + u[:, :, r])
        pa, pb = ca[-1].clone(), cb[-1].clone()            # (B, P, I, N)
        pb[:, 0] = pa[:, 0] * h + pb[:, 0]
        pa[:, 0] = 0.0
        d = 1
        while d < P:
            qa, qb = pa[:, :-d].clone(), pb[:, :-d].clone()
            pb[:, d:] = pa[:, d:] * qb + pb[:, d:]
            if 2 * d < P:
                pa[:, d:] = pa[:, d:] * qa
            d *= 2
        hin = torch.cat([h[:, None], pb[:, :-1]], dim=1)   # (B, P, I, N)
        h = pb[:, -1]
        hs = torch.stack(ca, 2) * hin[:, :, None] + torch.stack(cb, 2)
        ys.append((hs * cm[:, k, :, :, None, :]).sum(-1).reshape(B, L, I))
    return torch.cat(ys, 1)[:, :S], h


@pytest.mark.parametrize("B,S,I,N", [(1, 5, 40, 16), (2, 64, 33, 16),
                                     (1, 129, 48, 4), (2, 200, 36, 16)])
def test_segmented_scan_matches_reference(B, S, I, N):
    """The kernel's combine order on ragged S (shorter than a run, one
    chunk, a step past two chunks, off the chunk) and I off the 32-channel
    block, from a random state, against the JAX package's sequential
    oracle at the reference kernel's 2e-5."""
    rng = np.random.default_rng(B * 1000 + S)
    f32 = np.float32
    arrays = [np.log1p(np.exp(rng.standard_normal((B, S, I)))).astype(f32),
              (-np.exp(rng.standard_normal((I, N)))).astype(f32),
              rng.standard_normal((B, S, N)).astype(f32),
              rng.standard_normal((B, S, N)).astype(f32),
              rng.standard_normal((B, S, I)).astype(f32),
              rng.standard_normal((B, I, N)).astype(f32)]
    yr, hr = jax_scan_ref(*(jnp.asarray(v) for v in arrays))
    y, hT = _segmented_scan(*(torch.from_numpy(v) for v in arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hr), rtol=2e-5,
                               atol=2e-5)
