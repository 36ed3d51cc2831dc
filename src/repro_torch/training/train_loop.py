"""LM pretraining loop (port of `repro/training/train_loop.py`): Adam with
decoupled weight decay, a cosine schedule, global-norm clipping and
checkpoints, for every architecture of the zoo.

`make_train_step` is eager: one step is the forward, autograd's backward
(on the card the attention and scan backward kernels), the clip and the
Adam update, each a PyTorch call or a kernel launch. The step donates its
params and optimizer state: it updates them in place with the reference's
arithmetic (`clip_by_global_norm_`, `adam_apply_`), so a step holds one
copy of the params, grads and moments. `train_lm` runs on the card unless
given `device="cpu"`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.common.checkpoint import save_checkpoint
from repro_torch.common.config import ArchConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.training.data import DataConfig, MarkovTokens
from repro_torch.training.optimizer import (adam_apply_, adam_init,
                                            clip_by_global_norm_,
                                            cosine_schedule, value_and_grad)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 50
    total_steps: int = 300
    max_grad_norm: float = 1.0
    weight_decay: float = 0.01
    log_every: int = 20
    ckpt_every: int = 0          # 0 = only final
    ckpt_dir: Optional[str] = None


def make_train_step(model, tcfg: TrainConfig):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss,
    grad_norm), the reference's step: grads of `model.loss`, clipped to
    `max_grad_norm`, Adam at the cosine schedule's rate. `params` and
    `opt_state` are updated in place and returned."""
    def train_step(params, opt_state, batch):
        loss, _metrics, grads = value_and_grad(
            lambda p: model.loss(p, batch), params)
        gnorm = clip_by_global_norm_(grads, tcfg.max_grad_norm)
        lr = cosine_schedule(opt_state.step, tcfg.lr, tcfg.warmup,
                             tcfg.total_steps)
        opt_state = adam_apply_(grads, opt_state, params, lr,
                                weight_decay=tcfg.weight_decay)
        return params, opt_state, loss, gnorm

    return train_step


def batch_to_device(batch, device):
    """A numpy batch of `MarkovTokens` as tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_lm(cfg: ArchConfig, tcfg: TrainConfig, dcfg: DataConfig,
             seed: int = 0, verbose: bool = True, *, device=None):
    """Train `cfg` from random params drawn from `seed` on
    `MarkovTokens(dcfg)` for `tcfg.total_steps` steps on `device` (the
    card by default). Returns (params, history): a row per logged step
    with its loss, grad norm, seconds since the start and `step_ms`, the
    step's wall time on the host clock, synchronised by reading the loss.
    Checkpoints go to `tcfg.ckpt_dir` in the reference's format."""
    dev = resolve_device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    opt_state = adam_init(params)
    step_fn = make_train_step(model, tcfg)
    history = []
    t0 = time.time()
    for step, batch in enumerate(MarkovTokens(dcfg)):
        if step >= tcfg.total_steps:
            break
        batch = batch_to_device(batch, dev)
        ts = time.perf_counter()
        params, opt_state, loss, gnorm = step_fn(params, opt_state, batch)
        loss_v, gnorm_v = float(loss), float(gnorm)
        step_ms = 1e3 * (time.perf_counter() - ts)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            history.append({"step": step, "loss": loss_v,
                            "grad_norm": gnorm_v,
                            "elapsed": time.time() - t0, "step_ms": step_ms})
            if verbose:
                print(f"[train step {step:4d}] loss={loss_v:.4f} "
                      f"gnorm={gnorm_v:.2f} ({time.time() - t0:.1f}s)")
        if tcfg.ckpt_dir and tcfg.ckpt_every and step and \
                step % tcfg.ckpt_every == 0:
            save_checkpoint(tcfg.ckpt_dir, step, params)
    if tcfg.ckpt_dir:
        save_checkpoint(tcfg.ckpt_dir, tcfg.total_steps, params)
    return params, history
