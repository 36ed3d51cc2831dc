"""The four assigned input shapes + per-(arch, shape) applicability rules
(port of `repro/launch/shapes.py`, copied)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.common.config import ArchConfig

SLIDING_WINDOW_LONG = 16384     # window used by dense archs for long_500k


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def adapt_config(cfg: ArchConfig, shape: ShapeSpec) -> Optional[ArchConfig]:
    """Returns the (possibly shape-adapted) config, or None if the pair is
    skipped (recorded in DESIGN.md §4)."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return None          # enc-dec: no 500k decode story (DESIGN.md)
        if not cfg.is_subquadratic():
            # dense/moe/vlm archs: sliding-window variant (sub-quadratic)
            return dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def pair_list():
    """All (arch_name, shape_name) baseline pairs (skips excluded)."""
    from repro_torch.common.config import ASSIGNED_ARCHS, get_config
    out = []
    for a in ASSIGNED_ARCHS:
        for s in SHAPES.values():
            if adapt_config(get_config(a), s) is not None:
                out.append((a, s.name))
    return out
