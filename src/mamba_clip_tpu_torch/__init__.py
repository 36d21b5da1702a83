"""mamba_clip_tpu_torch: the PyTorch/CUDA port of mamba_clip_tpu.

The JAX package ``mamba_clip_tpu`` is the reference; this package mirrors
its names and module layout. Plain tensor code is PyTorch, and each Pallas
kernel of the JAX package becomes a CUDA kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use. Ported so far: the
``classify`` serving path of the VSSM ("medmamba") classifier, with the
selective-scan forward kernel.
"""

__version__ = "0.1.0"
