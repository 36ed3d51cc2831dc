"""The one checkpoint-restore door for policy weights (port of
`repro/api/checkpoints.py`).

Every `PolicySpec(checkpoint=...)` restores through `restore_params`. Kept
separate from `common.checkpoint` (the raw npz store, the reference's
format) so the facade owns path/step resolution and error wording.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.common.checkpoint import latest_step, restore_checkpoint


def restore_params(directory: str, target: Any,
                   step: Optional[int] = None) -> Any:
    """Restore a weight tree into the structure of `target`, on its
    tensors' devices and dtypes.

    `step=None` picks the latest step under `directory`. Raises
    FileNotFoundError when the directory holds no checkpoint — a PolicySpec
    that names a checkpoint must never fall back to fresh weights silently.
    """
    if step is None and latest_step(directory) is None:
        raise FileNotFoundError(
            f"no checkpoint steps under {directory!r}; a PolicySpec with "
            "checkpoint= must point at a saved run (or pass params= / omit "
            "both for fresh weights)")
    return restore_checkpoint(directory, target, step=step)
