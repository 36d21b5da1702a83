"""Ops: on-device preprocessing and the selective scan (plain and CUDA), also
sharded over the sequence."""

from .preprocess import OPENAI_MEAN, OPENAI_STD, eval_preprocess, train_preprocess
from .selective_scan import selective_scan, selective_scan_flops, selective_scan_tm
from .sharded_scan import sharded_selective_scan_tm

__all__ = [
    "OPENAI_MEAN", "OPENAI_STD", "eval_preprocess", "train_preprocess",
    "selective_scan", "selective_scan_tm", "selective_scan_flops",
    "sharded_selective_scan_tm",
]
