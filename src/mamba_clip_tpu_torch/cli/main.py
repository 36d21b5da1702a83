"""CLI entry point: parse the flags, run the pipeline.

Counterpart of ``mamba_clip_tpu/cli/main.py``, flag for flag: the parser
is generated from the ``Args`` dataclass (``config.py``), the same as the
JAX package's. Run on the card (the default ``--device auto``) or, with
``--device cpu``, on the CPU:

    python -m mamba_clip_tpu_torch.cli.main --data-path data/isic-2024-challenge/ --stage 1 ...
    python -m mamba_clip_tpu_torch.cli.main --synthetic-data --stage 1 ...

``--quant`` takes every mode: the five native int8 modes and the aqt
modes ``int8`` and ``int8_fwd`` (``ops/aqt.py``). Ranks: ``torchrun
--nproc-per-node N -m mamba_clip_tpu_torch.cli.main ...`` runs the data
axis over N processes (``parallel/mesh.py``). ``--hyperparameter-tuning``
(the optuna, ray and ASHA searches) is not ported yet: ``pipeline``
refuses it, as it refuses ``--mesh-fsdp``/``--mesh-model`` above 1.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..config import arg_parser as _arg_parser
from ..config import parse_args

arg_parser = _arg_parser


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (the process's arguments when None) and run
    ``pipeline``, which refuses a flag whose feature is not ported yet,
    ``--hyperparameter-tuning`` among them."""
    from ..pipeline import pipeline

    return pipeline(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
