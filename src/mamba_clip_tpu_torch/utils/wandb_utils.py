"""The wandb sink of ``--report-to wandb``, gated on the package.

Counterpart of ``mamba_clip_tpu/utils/wandb_utils.py``: ``init_wandb``,
``log`` and ``finish``. ``wandb`` is imported at the first call; where it
is missing every call is a no-op and ``init_wandb`` warns once, naming the
package, so a run never fails on a missing logging backend.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .logging import get_logger, warning_once

logger = get_logger(__name__)

_wandb = None
_checked = False


def _get():
    """The ``wandb`` module, or None where it is not installed (looked up
    once a process)."""
    global _wandb, _checked
    if not _checked:
        _checked = True
        try:
            import wandb as w

            _wandb = w
        except ImportError:
            _wandb = None
    return _wandb


def available() -> bool:
    return _get() is not None


def init_wandb(args, run_state, params: Optional[Dict[str, Any]] = None):
    """Start the run's wandb run: the project, the run's name, the notes and
    the flags as its config; None (and one warning) without wandb."""
    w = _get()
    if w is None:
        warning_once(logger, "wandb requested via --report-to but not installed")
        return None
    return w.init(
        project=args.wandb_project_name,
        name=run_state.name,
        notes=args.wandb_notes,
        config=args.to_dict(),
        resume="auto" if args.resume else None,
    )


def log(data: Dict[str, Any], step: Optional[int] = None) -> None:
    w = _get()
    if w is not None and w.run is not None:
        w.log(data, step=step)


def finish() -> None:
    w = _get()
    if w is not None and w.run is not None:
        w.finish()
