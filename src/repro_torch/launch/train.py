"""CLI training launcher (port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        [--reduced | --full] [--steps 100] [--batch 8] [--seq 256] \\
        [--ckpt-dir DIR] [--device {cuda,cpu}]

Runs the pretraining loop (Adam + cosine + grad clip + checkpoints) on the
selected architecture, reduced by default; `--full` trains it at its
published width. It runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.common.config import ASSIGNED_ARCHS, get_config
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import TrainConfig, train_lm


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup=max(5, args.steps // 10),
                       ckpt_dir=args.ckpt_dir)
    dcfg = DataConfig(vocab_size=min(cfg.vocab_size, 2048),
                      seq_len=args.seq, batch_size=args.batch,
                      seed=args.seed)
    _params, history = train_lm(cfg, tcfg, dcfg, seed=args.seed,
                                device=args.device)
    print(f"final loss {history[-1]['loss']:.4f} "
          f"({history[0]['loss']:.4f} at step 0)")
    return history


if __name__ == "__main__":
    main()
