"""Logging, precision policies, the wandb sink and trace attribution."""

from .logging import (
    ResultsWriter,
    create_log_path,
    get_logger,
    logger_setup,
    warning_once,
)
from .precision import Policy, get_input_dtype, get_policy

__all__ = [
    "ResultsWriter", "create_log_path", "get_logger", "logger_setup", "warning_once",
    "Policy", "get_policy", "get_input_dtype",
]
