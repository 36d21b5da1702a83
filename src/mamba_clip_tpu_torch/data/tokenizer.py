"""Text tokenization for the text tower.

A copy of ``HashTokenizer`` and ``get_tokenizer`` from
``mamba_clip_tpu/data/tokenizer.py``: a deterministic, vocabulary-free
word tokenizer. Lowercased word/number/punct pieces map to stable ids by
FNV-1a hashing into the BERT-sized id space; CLS first, SEP last, PAD = 0,
so the text tower's pad mask works unchanged. Output is a fixed-shape int32
array (batch, context_length).

The HuggingFace WordPiece adapter is not ported: it needs ``transformers``
and a local vocabulary (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode("utf-8"):
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    PAD = 0
    UNK = 1
    CLS = 2
    SEP = 3
    N_SPECIAL = 4

    N_SPECIAL_PER_SEQ = 2  # CLS + SEP

    def __init__(self, context_length: int = 256, vocab_size: int = 30522):
        self.context_length = context_length
        self.vocab_size = vocab_size
        # "truncate" (clip to the context) or "error" (a trimmed
        # --text-context: a longer report means the bucket is stale)
        self.on_overflow = "truncate"
        # word -> id memo, bounded: report text is templated, so the live
        # vocabulary is small, but numeric strings are not
        self._memo: dict = {}

    @property
    def pad_id(self) -> int:
        return self.PAD

    def _encode_one(self, text: str) -> List[int]:
        space = self.vocab_size - self.N_SPECIAL
        memo = self._memo
        out = []
        for t in _WORD_RE.findall(text.lower()):
            tid = memo.get(t)
            if tid is None:
                tid = self.N_SPECIAL + (_fnv1a(t) % space)
                if len(memo) < 1_000_000:
                    memo[t] = tid
            out.append(tid)
        return out

    def count_tokens(self, text: str) -> int:
        """Token count WITHOUT special tokens (for context measurement)."""
        return len(_WORD_RE.findall(text.lower()))

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        cap = self.context_length - 2
        out = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            body = self._encode_one(t)
            if len(body) > cap and self.on_overflow == "error":
                raise ValueError(
                    f"text of {len(body)} tokens overflows the trimmed "
                    f"context {self.context_length} (--text-context); pass "
                    "a larger bucket or leave --text-context unset for the "
                    "reference's 256-with-truncation"
                )
            ids = [self.CLS] + body[:cap] + [self.SEP]
            out[i, : len(ids)] = ids
        return out


def get_tokenizer(name_or_path: str, context_length: int = 256,
                  require_real: bool = False):
    """Tokenizer factory. ``hash``/``none``/empty -> :class:`HashTokenizer`.
    A local path would take the HuggingFace WordPiece tokenizer, which is
    not ported: with ``require_real`` (pretrained weights) that raises,
    otherwise it falls back to the hash tokenizer with a warning, as the
    JAX package does when the HF tokenizer fails to load. Any other name
    (a hub name: there is no network) -> the hash tokenizer, with a
    warning, or an error under ``require_real``."""
    if name_or_path and os.path.exists(str(name_or_path)):
        if require_real:
            raise RuntimeError(
                f"--tokenizer {name_or_path}: the HF WordPiece tokenizer is not "
                "ported (ROADMAP.md); pretrained weights require it")
        logger.warning(
            f"tokenizer path {name_or_path!r}: the HF tokenizer is not ported; "
            "falling back to the hash tokenizer")
        return HashTokenizer(context_length=context_length)
    if str(name_or_path).lower() in ("hash", "none", ""):
        return HashTokenizer(context_length=context_length)
    if require_real:
        raise RuntimeError(
            f"tokenizer {name_or_path!r} is not a local path. Pretrained "
            "(converted) weights need the matching WordPiece tokenizer — "
            "pass --tokenizer <dir with vocab.txt/tokenizer.json>, or "
            "--tokenizer hash to explicitly accept the stand-in."
        )
    logger.warning(
        f"tokenizer {name_or_path!r} is not a local path (no network "
        "access): using the deterministic HASH tokenizer stand-in. Fine for "
        "training from scratch; NOT compatible with converted pretrained "
        "text towers."
    )
    return HashTokenizer(context_length=context_length)
