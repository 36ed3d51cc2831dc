"""Real prefill/decode execution for the serving layer (port of
`repro/serving/executor.py`).

`ModelExecutor` owns the model zoo instances (reduced or full configs) and
the generation loop the engine calls. It computes in fp32 with an fp32 KV
cache, as the reference does. Two correctness properties live here:

KV-cache sizing. The scheduler picks the inference-step count (up to
``s_max``) independently of the request's ``max_new_tokens``; the decode
loop runs ``steps`` iterations, so the cache is sized by
``max(steps, max_new_tokens)`` (rounded up to 8).

Patch-parallel prefill. A c_k-patch task splits its left-padded prompt into
c_k chunks prefilled as a batch dimension — the DistriFusion patch mapping:
each chunk is one gang member's patch, computed in parallel with no
cross-patch attention (chunk-local RoPE positions). The per-chunk KV caches
then merge back into one sequence-ordered cache (a reshape) that decode
attends over. For ``c == 1`` the chunked path equals the unchunked one.
Architectures whose caches are not pure attention KV (sliding-window
rings, Mamba and xLSTM states) and those with a frontend (audio, vision)
take the unchunked prefill.

On the card every prefill launches the hand-written kernels: flash
attention once per attention layer (`kernels.flash_attention`) and the
selective scan once per Mamba layer (`kernels.ssm_scan`), so a Jamba
period's prefill launches `ssm_scan` 7 times and `flash_attention` once,
and a whisper prefill launches flash once per encoder layer and twice per
decoder layer (self- and cross-attention).
`impl="ref"` runs the plain attention and scan instead, which is how
`chip_smoke.py` holds the served logits to them.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.config import get_config
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_map
from repro_torch.faults.inject import ExecutorTimeout
from repro_torch.models.lm import period_spec
from repro_torch.models.zoo import Model, build_model
from repro_torch.telemetry.trace import NULL_TRACER

# decode-capacity rounding: buckets cache shapes per (arch, chunk shape,
# capacity bucket). Value-safe: decode attention masks entries at or beyond
# `pos` (`attention.decode_attention`).
_CAP_ROUND = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _shapes(prompt_len: int, c: int, steps: int, max_new_tokens: int):
    """(c, left pad, padded prompt length, decode-cache capacity)."""
    c = max(int(c), 1)
    pad = (-int(prompt_len)) % c
    S_pad = int(prompt_len) + pad
    return c, pad, S_pad, S_pad + _round_up(
        max(int(steps), int(max_new_tokens)), _CAP_ROUND)


def chunkable(cfg) -> bool:
    """True when the patch-parallel (batched-chunk) prefill applies: every
    mixer is plain full attention (KV merge is a reshape) and no frontend
    tokens are prepended per batch row."""
    if cfg.family == "audio" or cfg.frontend != "none":
        return False
    if cfg.sliding_window:
        return False
    return all(mixer == "attn" for mixer, _f in period_spec(cfg))


def _merge_chunk_cache(model: Model, ccache: Dict, S_pad: int,
                       capacity: int, device) -> Dict:
    """(c, chunk)-batched prefill caches -> one (1, capacity) decode cache.

    Chunks are consecutive prompt slices, so concatenating their KV along
    the sequence axis — a reshape of (periods, c, chunk, kv, hd) — restores
    prompt order exactly; `pos = S_pad` points decode past the merged KV."""
    big = model.make_cache(1, capacity, dtype=torch.float32, device=device)

    def merge(dst, src):
        npd, c, chunk, nk, hd = src.shape
        dst[:, :, :c * chunk] = src.reshape(npd, 1, c * chunk, nk, hd)
        return dst

    periods = tree_map(merge, big["periods"], ccache["periods"])
    return {"periods": periods, "pos": S_pad}


class ModelExecutor:
    """Cached models and the generation loop, shared by every server.

    `device=None` means CUDA (and raises without it); pass `device="cpu"`
    for the plain PyTorch path."""

    def __init__(self, reduced: bool = True, tracer=None, *, device=None):
        self.device = resolve_device(device)
        self.reduced = reduced
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._models: Dict[str, Model] = {}
        self._warm_params: Dict[str, object] = {}   # throwaway warm params
        self._warmed: set = set()                   # shape buckets warmed

    def model(self, arch: str) -> Model:
        if arch not in self._models:
            cfg = get_config(arch)
            self._models[arch] = build_model(cfg.reduced() if self.reduced
                                             else cfg)
        return self._models[arch]

    def init_params(self, arch: str, generator: torch.Generator):
        """Real weight materialisation on the executor's device — the
        cold-start cost being scheduled around (the Table-VI init_time
        stands in for its wall-clock)."""
        return self.model(arch).init(generator, device=self.device)

    # ------------------------------------------------------------------
    def shape_key(self, arch: str, prompt_len: int, c: int, steps: int,
                  max_new_tokens: int) -> tuple:
        """The shape bucket a `generate` call lands in: (arch, chunk count,
        padded prompt length, cache capacity)."""
        c, _pad, S_pad, capacity = _shapes(prompt_len, c, steps,
                                           max_new_tokens)
        use_chunked = chunkable(self.model(arch).cfg)
        return (arch, c if use_chunked else 1, S_pad, capacity)

    def warm(self, arch: str, prompt_len: int, c: int, steps: int,
             max_new_tokens: int) -> bool:
        """Run the shapes a `generate` with these arguments would hit once
        (first-use kernel builds, library handles, allocator pools); returns
        True when it ran. One throwaway single-step generate with per-arch
        cached dummy params drawn from their own generator (seed 0), so the
        callers' weight draws are untouched, against the same chunk shape
        and cache capacity."""
        k = self.shape_key(arch, prompt_len, c, steps, max_new_tokens)
        if k in self._warmed:
            return False
        _arch, _c, S_pad, capacity = k
        if arch not in self._warm_params:
            self._warm_params[arch] = self.init_params(
                arch, torch.Generator(device=self.device).manual_seed(0))
        prompt = np.zeros(int(prompt_len), np.int64)
        self.generate(arch, self._warm_params[arch], prompt, c, 1,
                      capacity - S_pad)
        self._warmed.add(k)
        return True

    # ------------------------------------------------------------------
    def _elapsed(self, t_start: float) -> float:
        """Wall seconds since `t_start`, the device's queued work included."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t_start

    def _full_batch(self, cfg, prompt: np.ndarray) -> Dict:
        """The unchunked prefill's batch: the prompt, and zero stub frontend
        inputs as the reference passes them (VLM: (1, frontend_tokens,
        frontend_dim) patch embeddings; audio: (1, frontend_tokens,
        d_model) frames)."""
        dev = self.device
        batch = {"tokens": torch.from_numpy(prompt[None]).to(dev)}
        if cfg.frontend == "vision":
            batch["image_embeds"] = torch.zeros(
                (1, cfg.frontend_tokens, cfg.frontend_dim), device=dev)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (1, cfg.frontend_tokens, cfg.d_model), device=dev)
        return batch

    def prefill(self, arch: str, params, prompt, c: int, steps: int,
                max_new_tokens: int = 16, *,
                force_chunked: Optional[bool] = None, impl: str = "auto"):
        """The prompt's prefill, as `generate` runs it: returns the
        last-position logits (1, 1, padded_vocab) and the decode cache of
        capacity S_pad + round_up(max(steps, max_new_tokens), 8).

        `force_chunked` overrides the chunking heuristic (tests hold the
        c=1 chunked path to the unchunked one). `impl` picks the prefill
        attention and scan ("auto": the kernels on the card; "ref": the
        plain versions)."""
        model = self.model(arch)
        dev = self.device
        f32 = torch.float32
        prompt = np.asarray(prompt, np.int64)
        c, pad, S_pad, capacity = _shapes(len(prompt), c, steps,
                                          max_new_tokens)
        use_chunked = (chunkable(model.cfg) if force_chunked is None
                       else force_chunked)
        if use_chunked:
            # left-pad so the prompt's true final token ends the last chunk
            # — its last-position logits are the next-token distribution
            chunks = torch.from_numpy(
                np.pad(prompt, (pad, 0)).reshape(c, -1)).to(dev)
            ccache = model.make_cache(c, chunks.shape[1], dtype=f32,
                                      device=dev)
            logits, ccache = model.prefill(params, {"tokens": chunks},
                                           ccache, f32, impl=impl)
            cache = _merge_chunk_cache(model, ccache, S_pad, capacity, dev)
            return logits[-1:], cache   # the last token ends chunk c-1
        cache = model.make_cache(1, capacity, dtype=f32, device=dev)
        return model.prefill(params, self._full_batch(model.cfg, prompt),
                             cache, f32, impl=impl)

    def generate(self, arch: str, params, prompt, c: int, steps: int,
                 max_new_tokens: int = 16, *,
                 force_chunked: Optional[bool] = None,
                 deadline_s: float = 0.0, impl: str = "auto") -> np.ndarray:
        """Greedy generation of `steps` tokens on a c-patch gang's params.

        `force_chunked` and `impl` are `prefill`'s. `deadline_s > 0` bounds
        the attempt's wall clock: the decode loop checks the budget once
        per iteration (waiting for the device first) and raises
        `faults.ExecutorTimeout` when exceeded; 0 disables the check, and
        the loop then never waits for the device until its tokens are
        read."""
        t_start = time.perf_counter()
        model = self.model(arch)
        cfg = model.cfg
        steps = int(steps)
        c, _pad, S_pad, capacity = _shapes(len(prompt), c, steps,
                                           max_new_tokens)
        tr = self.tracer
        with tr.span("prefill", cat="serving", arch=arch, c=c, seq=S_pad,
                     chunked=bool(chunkable(cfg) if force_chunked is None
                                  else force_chunked)):
            logits, cache = self.prefill(arch, params, prompt, c, steps,
                                         max_new_tokens,
                                         force_chunked=force_chunked,
                                         impl=impl)
            if tr.enabled:   # wall attribution only: sync inside the span
                self._elapsed(t_start)
        out = []
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        with tr.span("decode", cat="serving", arch=arch, steps=steps,
                     capacity=capacity):
            for i in range(steps):
                if deadline_s > 0.0 and self._elapsed(t_start) > deadline_s:
                    raise ExecutorTimeout(
                        f"{arch} generate exceeded {deadline_s:.1f}s "
                        f"budget at decode step {i}/{steps}")
                out.append(tok)
                logits, cache = model.decode(params, cache, tok,
                                             torch.float32)
                tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        if not out:
            return np.zeros((0,), np.int32)
        return torch.cat(out, dim=1)[0].cpu().numpy().astype(np.int32)
