"""CLI entry point: parse the flags, run the pipeline or a search.

Counterpart of ``mamba_clip_tpu/cli/main.py``, flag for flag: the parser
is generated from the ``Args`` dataclass (``config.py``), the same as the
JAX package's. Run on the card (the default ``--device auto``) or, with
``--device cpu``, on the CPU:

    python -m mamba_clip_tpu_torch.cli.main --data-path data/isic-2024-challenge/ --stage 1 ...
    python -m mamba_clip_tpu_torch.cli.main --synthetic-data --stage 1 ...

``--quant`` takes every mode: the five native int8 modes and the aqt
modes ``int8`` and ``int8_fwd`` (``ops/aqt.py``). Ranks: ``torchrun
--nproc-per-node N -m mamba_clip_tpu_torch.cli.main ...`` runs N
processes laid out as (data, fsdp, model) by ``--mesh-fsdp`` and
``--mesh-model`` (``parallel/mesh.py``). ``--hyperparameter-tuning`` runs
a search instead of the pipeline, by ``--hyperparameter-strategy``:
``asha``, the native ASHA search (``integrations/ray.py::
native_asha_pipeline``), ``optuna`` and ``ray`` (each needs its package,
and names it where it is missing). ``pipeline`` refuses only ``--quant``
under ``--mesh-model`` above 1.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..config import arg_parser as _arg_parser
from ..config import parse_args

arg_parser = _arg_parser


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (the process's arguments when None); run the search
    of ``--hyperparameter-strategy`` under ``--hyperparameter-tuning``,
    else ``pipeline``. Returns what that returns."""
    args = parse_args(argv)
    if args.hyperparameter_tuning:
        if args.hyperparameter_strategy == "optuna":
            from ..integrations.optuna import optuna_pipeline

            return optuna_pipeline(args)
        elif args.hyperparameter_strategy == "ray":
            from ..integrations.ray import ray_tune_pipeline

            return ray_tune_pipeline(args)
        elif args.hyperparameter_strategy == "asha":
            from ..integrations.ray import native_asha_pipeline

            return native_asha_pipeline(args)
        raise ValueError(
            f"unknown hyperparameter strategy: {args.hyperparameter_strategy}"
        )
    from ..pipeline import pipeline

    return pipeline(args)


if __name__ == "__main__":
    main(sys.argv[1:])
