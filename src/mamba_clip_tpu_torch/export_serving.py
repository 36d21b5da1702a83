"""Export a trained model as a serving artifact.

Counterpart of ``tools/export_serving.py``, with the same flags: load the
weights from a checkpoint of the port (as the training pipeline writes
it), then write the artifact (``serving.export_serving``: the state dict,
the manifest and the tokenizer) for ``serving.load_serving`` and the HTTP
host (``serve_http.py``).

Usage:
    python -m mamba_clip_tpu_torch.export_serving --out DIR \\
        [--model biomedclip|medmamba|mambavision] [--clip] \\
        [--checkpoint <checkpoint dir, e.g. .../stage_1_epoch_latest>] \\
        [--num-classes 2] [--image-size 224] [--compress-weights] \\
        [--quant int8_serve] [--tokenizer <vocab.txt or tokenizer dir>] \\
        [--precision amp|bf16|pure_bf16|fp16|pure_fp16|fp32] [--data-shards S]

Without ``--checkpoint`` it exports a fresh init (seed 0). With it the
parameters keep the type ``--precision`` trains them in (bf16 under
``bf16``/``pure_bf16``, fp16 under ``pure_fp16``), in the artifact too.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="biomedclip")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir of this package to load params from")
    p.add_argument("--quant", default=None,
                   help="int8_serve: per-channel int8 dots in the towers' Dense "
                        "layers (int8_fast, int8_fast_attn and the aqt modes int8 "
                        "and int8_fwd export too; the int8_delayed modes are "
                        "training modes and raise)")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--context-length", type=int, default=256)
    p.add_argument("--precision", default="amp")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="recorded in the manifest only: the artifact is a state dict "
                        "that the module code runs on any device, so nothing is "
                        "lowered for a target (default: this process's platform)")
    p.add_argument("--data-shards", type=int, default=1,
                   help="above 1: a data-parallel artifact, served by one replica a "
                        "card (the batch dimension becomes data_shards*b)")
    p.add_argument("--tokenizer", default=None,
                   help="local tokenizer dir/vocab.txt to ship with the "
                        "artifact (text serving needs it host-side)")
    p.add_argument("--compress-weights", action="store_true",
                   help="store large 2-D kernels and embedding tables as int8 "
                        "with one fp32 scale a row (about 4x smaller)")
    p.add_argument("--scan-impl", default=None,
                   help="selective-scan impl for VSSM exports: default "
                        "(the kernel on the card, the plain loop on the CPU), "
                        "cuda or plain")
    p.add_argument("--clip", action="store_true",
                   help="export CLIP tower entry points (image_embed/"
                        "text_embed) for mamba-family names, which "
                        "otherwise resolve to the classifier zoo")
    a = p.parse_args(argv)

    from .serving import export_serving, make_serving_fns

    kw = dict(quant=a.quant, num_classes=a.num_classes,
              image_size=a.image_size, context_length=a.context_length,
              precision=a.precision, scan_impl=a.scan_impl, is_clip=a.clip)

    variables = None
    if a.checkpoint:
        from .checkpoint import load_params_only
        from .utils.precision import get_policy

        model, _, _ = make_serving_fns(a.model, device="cpu", **kw)
        # the parameters in the precision's type, as training kept them: a
        # pure_bf16 checkpoint's values load as they are, and the artifact
        # keeps them in bf16
        get_policy(a.precision).cast_params(model)
        variables = load_params_only(os.path.abspath(a.checkpoint), model).state_dict()

    manifest = export_serving(
        a.out, a.model, variables=variables, data_shards=a.data_shards,
        tokenizer=a.tokenizer, compress_weights=a.compress_weights,
        platforms=tuple(a.platforms) if a.platforms else None, **kw)
    total = sum(os.path.getsize(os.path.join(a.out, f))
                for f in os.listdir(a.out) if os.path.isfile(os.path.join(a.out, f)))
    print(f"exported {sorted(manifest['entry_points'])} for "
          f"{manifest['platforms']} to {a.out} ({total / 1e6:.1f} MB)")
    return manifest


if __name__ == "__main__":
    main()
