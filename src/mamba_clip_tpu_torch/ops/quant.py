"""The ``--quant`` flag: which int8 dot the towers' Dense layers take.

Counterpart of ``mamba_clip_tpu/ops/quant.py``. The native modes map to the
dots of ``ops/qdot.py``:

- ``int8_fast`` and ``int8_fast_attn``: :class:`~.qdot.Int8FastDotGeneral`,
  per-tensor scales calibrated on each call; ``int8_fast_attn`` also moves
  the attention interior to int8 (:func:`attn_int8`);
- ``int8_delayed`` and ``int8_delayed_attn``:
  :class:`~.qdot.Int8DelayedDotGeneral`, which quantizes with the scales
  of the previous step kept in the module's state; ``int8_delayed_attn``
  also moves the interior to int8 with delayed per-head scales
  (:func:`attn_int8_delayed`);
- ``int8_serve``: :class:`~.qdot.Int8ServeDotGeneral`, per-output-channel
  weight scales, for inference.

- ``int8`` and ``int8_fwd``: the ``aqt`` library's configurations in the
  JAX package, written out in :mod:`.aqt` (:class:`~.aqt.AqtInt8DotGeneral`,
  :class:`~.aqt.AqtInt8FwdDotGeneral`). They leave the attention interior
  as it is.
"""

from __future__ import annotations

from typing import Optional

_VALID = ("int8", "int8_fwd", "int8_fast", "int8_fast_attn", "int8_delayed",
          "int8_delayed_attn", "int8_serve")


def attn_int8(quant) -> bool:
    """True when ``--quant`` also moves the attention interior's dots (QK^T,
    P.V and their backward dots) to int8 with per-(batch, head) scales
    calibrated on each call."""
    return quant == "int8_fast_attn"


def attn_int8_delayed(quant) -> bool:
    """True when ``--quant`` moves the attention interior to int8 with
    delayed per-head q/k/v scales and the static 1/127 probability scale."""
    return quant == "int8_delayed_attn"


def make_dot_general_cls(quant: Optional[str]):
    """Map a ``--quant`` value to the dot class the Dense layers take (None:
    unquantized). An unknown value raises, so that a typo cannot run
    unquantized."""
    if not quant or quant == "none":
        return None
    from . import qdot

    if quant in ("int8_fast", "int8_fast_attn"):
        return qdot.Int8FastDotGeneral
    if quant in ("int8_delayed", "int8_delayed_attn"):
        return qdot.Int8DelayedDotGeneral
    if quant == "int8_serve":
        return qdot.Int8ServeDotGeneral
    if quant in ("int8", "int8_fwd"):
        from . import aqt

        return aqt.AqtInt8DotGeneral if quant == "int8" else aqt.AqtInt8FwdDotGeneral
    raise ValueError(f"unknown --quant '{quant}'; one of {_VALID} or none")
