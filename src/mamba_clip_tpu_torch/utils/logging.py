"""Library logging for the port.

A copy of ``mamba_clip_tpu/utils/logging.py`` (which imports no JAX) under
the port's own root logger: verbosity from ``MAMBA_CLIP_VERBOSITY``
(``debug|detail|info|warning|error|critical``; ``detail`` adds file:line),
colour on a TTY, a rank prefix in multi-process runs, the
``results.jsonl`` sink ``ResultsWriter``, and ``create_log_path``, the
experiment-name scheme (stage 2 finds its stage-1 run with it).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Mapping, Optional

_lock = threading.Lock()
_default_handler: Optional[logging.Handler] = None

_LEVELS = {
    "debug": logging.DEBUG,
    "detail": logging.DEBUG,  # DEBUG + file:line format
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_ROOT_NAME = "mamba_clip_tpu_torch"

_COLORS = {
    logging.DEBUG: "\x1b[37m",      # grey
    logging.INFO: "\x1b[32m",       # green
    logging.WARNING: "\x1b[33m",    # yellow
    logging.ERROR: "\x1b[31m",      # red
    logging.CRITICAL: "\x1b[1;31m",  # bold red
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    """Level-colored console formatter (replaces the reference's colorlog)."""

    def __init__(self, fmt: str, datefmt: str, use_color: bool):
        super().__init__(fmt, datefmt)
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        out = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            out = f"{color}{out}{_RESET}"
        return out


def _env_verbosity() -> str:
    # MAMBA_CLIP_VERBOSITY preferred; GOML_VERBOSITY kept as the reference's
    # env name (reference: utils/logging.py:59-73).
    return (
        os.environ.get("MAMBA_CLIP_VERBOSITY")
        or os.environ.get("GOML_VERBOSITY")
        or ""
    ).lower()


def _detail_mode() -> bool:
    return _env_verbosity() == "detail"


def _env_level() -> int:
    return _LEVELS.get(_env_verbosity(), logging.INFO)


def _rank_prefix() -> str:
    """Best-effort rank prefix without forcing a jax import at log-setup time."""
    rank = os.environ.get("MAMBA_CLIP_RANK")
    if rank is None:
        return ""
    return f"[rank {rank}] "


def _build_formatter(use_color: bool) -> logging.Formatter:
    if _detail_mode():
        fmt = (
            "%(asctime)s | " + _rank_prefix()
            + "%(levelname)s | %(name)s:%(filename)s:%(lineno)d | %(message)s"
        )
    else:
        fmt = "%(asctime)s | " + _rank_prefix() + "%(levelname)s | %(message)s"
    return _ColorFormatter(fmt, datefmt="%Y-%m-%d,%H:%M:%S", use_color=use_color)


def _configure_root() -> None:
    global _default_handler
    with _lock:
        if _default_handler is not None:
            return
        _default_handler = logging.StreamHandler(sys.stderr)
        use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
        _default_handler.setFormatter(_build_formatter(use_color))
        root = logging.getLogger(_ROOT_NAME)
        root.addHandler(_default_handler)
        root.setLevel(_env_level())
        root.propagate = False


def get_logger(name: Optional[str] = None) -> logging.Logger:
    _configure_root()
    if name is None:
        name = _ROOT_NAME
    elif not name.startswith(_ROOT_NAME):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)


def set_verbosity(level: int) -> None:
    _configure_root()
    logging.getLogger(_ROOT_NAME).setLevel(level)


def logger_setup(
    log_level: int = logging.INFO,
    log_file: Optional[str] = None,
    rank: int = 0,
) -> logging.Logger:
    """Configure the run logger: console + optional per-rank file.

    Mirrors the reference's ``logger_setup``
    (reference: utils/logging.py:440-491): rank header on every record,
    optional per-rank log file, level override.
    """
    os.environ["MAMBA_CLIP_RANK"] = str(rank)
    _configure_root()
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(log_level)
    # Rebuild console formatter so the rank prefix takes effect.
    if _default_handler is not None:
        use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty()
        _default_handler.setFormatter(_build_formatter(use_color))
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_build_formatter(use_color=False))
        root.addHandler(fh)
    return root


def create_log_path(args: Any, latest: bool = False,
                    containing: Optional[str] = None) -> str:
    """Experiment-name scheme ``date-model-lr-b-j-p[-trial]``.

    With ``latest=True``, instead of minting a new name, returns the most
    recent existing run dir for the same model and hyperparameters (stage 2
    finds the stage-1 run this way). ``containing`` keeps only run dirs that
    hold the given relative path, so that a newer stage-2 run of the same
    hyperparameters, which holds no stage-1 checkpoint, does not shadow the
    stage-1 run.
    """
    model_name = str(getattr(args, "model", "model")).replace("/", "-")
    base = "-".join(
        [
            "{date}",
            f"model_{model_name}",
            f"lr_{getattr(args, 'lr', None)}",
            f"b_{getattr(args, 'batch_size', None)}",
            f"j_{getattr(args, 'workers', None)}",
            f"p_{getattr(args, 'precision', None)}",
        ]
    )
    logs_root = getattr(args, "logs", "./logs")
    if latest:
        # the newest dir matching everything but the date prefix
        suffix = base.split("{date}", 1)[1]
        candidates = []
        if os.path.isdir(logs_root):
            for d in os.listdir(logs_root):
                if d.endswith(suffix) or suffix in d:
                    if containing is not None and not os.path.exists(
                        os.path.join(logs_root, d, containing)
                    ):
                        continue
                    candidates.append(d)
        if not candidates:
            what = f" containing {containing}" if containing else ""
            raise FileNotFoundError(
                f"no existing run matching '*{suffix}'{what} under {logs_root}"
            )
        candidates.sort(
            key=lambda d: os.path.getmtime(os.path.join(logs_root, d))
        )
        return candidates[-1]
    date_str = time.strftime("%Y_%m_%d-%H_%M_%S")
    name = base.format(date=date_str)
    trial = getattr(args, "trial", None)
    if trial is not None:
        name = f"{name}-trial_{trial}"
    return name


class ResultsWriter:
    """Append-only ``results.jsonl`` metric sink (reference: eval.py:163-165)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, metrics: Mapping[str, Any]) -> None:
        clean = {}
        for k, v in metrics.items():
            try:
                json.dumps(v)
                clean[k] = v
            except TypeError:
                clean[k] = float(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(clean) + "\n")
