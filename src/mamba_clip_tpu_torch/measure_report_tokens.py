"""The report token-length distribution against the text tower's 256-token
context.

Counterpart of ``tools/measure_report_tokens.py``, with its flags and its
JSON keys:

- rows: ISIC-shaped synthetic metadata with every field populated (the 15
  measurement columns, the patient triplet, the symmetry pair, ``iddx_1``),
  the worst case for a report's length;
- draws: the train-mode draws (template choice and shuffle on, sentence
  dropout 0.1, as the dataset applies them) and the deterministic eval
  draw, tokenized by the hash tokenizer (CLS and SEP counted, no padding);
- the exact per-row upper bound over all draws
  (``report_gen.report_token_upper_bound``), which ``--text-context auto``
  uses.

It is host-only numpy: at the same ``--rows/--draws/--seed`` its numbers
are the JAX tool's. It prints the JSON object, and writes it to ``--out``
when that is given (no file otherwise).

    python -m mamba_clip_tpu_torch.measure_report_tokens [--rows 2000] [--draws 3] [--seed 0] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .data.dataset import ColumnTable, synthetic_metadata
from .data.report_gen import generate_report, report_token_upper_bound
from .data.tokenizer import HashTokenizer


def fully_populated(n: int, seed: int) -> ColumnTable:
    """Synthetic metadata with no missing field (the longest reports)."""
    meta = synthetic_metadata(n, seed)
    rng = np.random.default_rng(seed + 1)
    cols = {c: meta[c] for c in meta.columns}
    cols["age_approx"] = rng.choice([25, 40, 55, 70], n)
    cols["sex"] = rng.choice(["male", "female"], n)
    cols["anatom_site_general"] = rng.choice(
        ["head/neck", "upper extremity", "lower extremity", "torso"], n)
    return ColumnTable(cols)


def measure(rows: int = 2000, draws: int = 3, seed: int = 0) -> dict:
    """The JAX tool's statistics over ``rows`` rows and ``draws`` train-mode
    draws a row (plus the eval draw)."""
    tok = HashTokenizer(context_length=4096)  # no truncation while measuring
    meta = fully_populated(rows, seed)
    lengths, bounds = [], []
    for i in range(len(meta)):
        row = meta.row(i)
        # stage-1 train/val reports carry the diagnosis sentence
        bounds.append(2 + report_token_upper_bound(row, tok.count_tokens, include_target=True))
        rng = np.random.default_rng((seed, 0, i))
        texts = [generate_report(row, is_eval=True, include_target=True)]
        for _ in range(draws):
            texts.append(generate_report(row, is_eval=False, shuffle=True, dropout=0.1,
                                         include_target=True, rng=rng))
        lengths.extend(2 + tok.count_tokens(t) for t in texts)  # + CLS/SEP

    L = np.asarray(lengths)
    B = np.asarray(bounds)
    if int(B.max()) < int(L.max()):
        raise AssertionError(f"upper bound violated: {int(L.max())} > {int(B.max())}")
    return {
        "rows": rows,
        "draws_per_row": draws + 1,
        "seed": seed,
        "population": "all 15 measurement fields + patient triplet + "
                      "symmetry + iddx_1 (fully populated, worst case)",
        "tokenizer": "hash (word-level; CLS/SEP counted)",
        "reference_context": 256,
        "observed": {
            "mean": round(float(L.mean()), 1),
            "p50": int(np.percentile(L, 50)),
            "p99": int(np.percentile(L, 99)),
            "max": int(L.max()),
        },
        "exact_upper_bound": {
            "mean": round(float(B.mean()), 1),
            "p99": int(np.percentile(B, 99)),
            "max": int(B.max()),
        },
        "auto_bucket_multiple16": int(-(-int(B.max()) // 16) * 16),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--draws", type=int, default=3,
                    help="train-mode draws per row (plus one eval draw)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    args = ap.parse_args(argv)
    out = measure(args.rows, args.draws, args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
