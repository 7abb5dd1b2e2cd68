"""Training checkpoint/resume.

The reference has no runtime checkpointing — its only persistence is the
exported network text file (SURVEY.md section 5: "recovery is restart the
app"). For long training runs this module adds orbax-backed pytree
checkpoints of (params, opt_state, step), plus the text export as the
portable final artifact. orbax is optional: only ``train --checkpoint-dir``
needs it.
"""

from __future__ import annotations

import os
from typing import Any, Optional

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _checkpointer():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ValueError(
            "--checkpoint-dir needs the orbax-checkpoint package, which is "
            "not installed"
        ) from e

    return ocp.PyTreeCheckpointer()


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write `state` (any pytree) under directory/step_N; returns the path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    _checkpointer().save(path, state)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str, step: Optional[int] = None, template: Any = None
) -> Any:
    """Restore the given (or latest) step's pytree; None if none exists.

    ``template``: a pytree of the same structure to restore INTO — required
    when the saved state contains typed containers (optax NamedTuple
    optimizer states restore as plain dicts otherwise).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(os.path.abspath(directory), f"step_{step:08d}")
    if template is None:
        return _checkpointer().restore(path)
    return _checkpointer().restore(path, item=template)
