"""mamba_clip_tpu_torch: the PyTorch/CUDA port of mamba_clip_tpu.

The JAX package ``mamba_clip_tpu`` is the reference; this package mirrors
its names, flags and module layout: the two-stage pipeline (stage-1
contrastive CLIP, stage-2 classifier head, pAUC evaluation) through
``cli/main.py``, checkpoints with resume and remote sync, the quantized
modes and low-precision policies, the mesh axes across processes,
serving artifacts and the HTTP host, and the hyperparameter searches
(``integrations/``). Plain tensor code is PyTorch, and each Pallas kernel
of the JAX package is a CUDA kernel written for Hopper (``csrc/``), built
with ``nvcc`` at first use. The data, fsdp and model axes run over
ranks (``parallel/``), and so do the sequence-parallel scan
(``ops/sharded_scan.py``), GPipe (``parallel/pipeline.py``), data-sharded
serving artifacts and the scaling bench (``bench_scaling.py``).
"""

__version__ = "0.1.0"

from .config import Args, RunState, arg_parser, parse_args

__all__ = [
    "Args", "RunState", "arg_parser", "parse_args", "__version__",
    # lazily re-exported (see __getattr__): pipeline, models, losses, ...
]

_LAZY = {
    "pipeline": ".pipeline",
    "losses": ".losses",
    "schedules": ".schedules",
    "optim": ".optim",
    "checkpoint": ".checkpoint",
    "models": ".models",
    "ops": ".ops",
    "data": ".data",
    "parallel": ".parallel",
    "train": ".train",
    "eval": ".eval",
    "serving": ".serving",
    "convert": ".convert",
    "integrations": ".integrations",
    "utils": ".utils",
}


def __getattr__(name):
    """Lazy submodule access: ``import mamba_clip_tpu_torch`` imports no
    torch until a compute module is touched."""
    if name in _LAZY:
        import importlib

        return importlib.import_module(_LAZY[name], __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
