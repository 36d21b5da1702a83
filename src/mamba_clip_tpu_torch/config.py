"""Typed run configuration and CLI flag system.

The port's own copy of ``mamba_clip_tpu/config.py`` (it imports the
standard library only): ``Args``, the one source of every flag, its name,
default and type; ``IGNORED_FLAGS`` with ``warn_ignored_flags``;
``RunState``; the parser generated from ``Args`` (``arg_parser``,
``parse_args``) and the JSON round trip (``args_from_dict``,
``save_args``, ``load_args``). Every field, default and type equals the
JAX package's, ``dist_backend = "jax"`` included, because a default is part
of what ``params.txt`` records and the two packages take the same command
lines.

The config is not mutated as global run state: what a run derives (rank,
world size, device, resolved paths, the loop's meters) lives in
``RunState``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, get_args, get_origin


@dataclass
class Args:
    """All run flags. Names mirror the reference CLI one-for-one."""

    # -- data ---------------------------------------------------------------
    data_path: Optional[str] = None
    val_data_path: Optional[str] = None
    train_num_samples: Optional[int] = None
    val_num_samples: Optional[int] = None
    zero_shot: bool = False
    num_classes: Optional[int] = None
    sampling: Optional[str] = None  # instance|class|sqrt|cbrt|prog
    undersample: Optional[int] = None
    undersample_by: Optional[str] = None
    undersample_sort_by: Optional[str] = None
    add_remaining_samples: bool = False
    balanced_mixup: float = 0.0  # mixup alpha; 0 disables
    workers: int = 4
    synthetic_data: bool = False  # ISIC-shaped synthetic data (tests, smoke runs)
    on_device_preprocess: bool = True  # augment and normalize on the device
    cache_staging: Optional[str] = None  # dir for a decoded-image memmap cache

    # -- run placement / logging --------------------------------------------
    device: str = "auto"  # auto|cuda: the card, or an error; cpu: the CPU
    logs: str = "./logs/"
    log_local: bool = False
    name: Optional[str] = None
    log_every_n_steps: int = 100
    report_to: str = ""  # "", "tensorboard", "wandb", comma-sep
    wandb_notes: str = ""
    wandb_project_name: str = "mamba-clip"
    debug: bool = False
    copy_codebase: bool = False

    # -- optimization ---------------------------------------------------------
    batch_size: int = 64
    epochs: int = 1
    epochs_cooldown: Optional[int] = None
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    wd: float = 0.05
    # >=1: literal step count; [0,1): fraction of total steps
    # (schedules.resolve_warmup)
    warmup: float = 1
    skip_scheduler: bool = False
    lr_scheduler: str = "cosine"  # cosine|const|const-cooldown
    lr_restart_interval: Optional[int] = None
    lr_cooldown_end: float = 0.0
    lr_cooldown_power: float = 1.0
    accum_freq: int = 1
    grad_clip_norm: Optional[float] = None
    grad_checkpointing: bool = False

    # -- checkpointing ---------------------------------------------------------
    save_frequency: int = 1
    save_most_recent: bool = False
    # N>0 saves `<stage>_epoch_<e>_step_<m>` every N optimizer steps and
    # `--resume latest` resumes exactly mid-epoch
    checkpoint_steps: int = 0
    val_frequency: int = 1
    resume: Optional[str] = None
    delete_previous_checkpoint: bool = False
    remote_sync: Optional[str] = None
    remote_sync_frequency: int = 300
    remote_sync_protocol: str = "fsspec"

    # -- precision ---------------------------------------------------------
    precision: str = "amp"  # amp|amp_bf16|amp_bfloat16|bf16|pure_bf16|fp16|pure_fp16|fp32
    # int8 training modes
    quant: Optional[str] = None  # int8|int8_fwd|int8_fast|int8_fast_attn|int8_delayed|int8_delayed_attn|int8_serve|none
    # MLP GELU form: auto = tanh when the compute dtype is bf16, exact otherwise
    gelu: str = "auto"  # auto|exact|tanh
    # attention interior: einsum (plain) or flash (the hand-written kernels
    # on the card)
    attn_impl: str = "einsum"  # einsum|flash

    # -- device mesh -------------------------------------------------------
    # the ranks lay out as data x fsdp x model (parallel/mesh.py)
    mesh_fsdp: int = 1
    mesh_model: int = 1

    # -- model ---------------------------------------------------------
    stage: int = 1
    model: Optional[str] = None
    model_stage_1: Optional[str] = None
    model_stage_2: Optional[str] = None
    use_inner_prod: bool = False
    use_visual_only: bool = False
    use_text_only: bool = False
    use_original_model: bool = False
    # path to a converted open_clip checkpoint (.npz from
    # tools/convert_weights.py, or convert.write_converted_npz)
    pretrained: Optional[str] = None
    tokenizer: Optional[str] = None
    # tokenizer context trimming: N trims the padded length to N (overflow
    # is an error); "auto" measures the data's longest report; unset pads
    # to the text tower's 256
    text_context: Optional[str] = None
    lock_image: bool = False
    lock_image_unlocked_groups: int = 0
    lock_image_freeze_bn_stats: bool = False
    lock_text: bool = False
    lock_text_unlocked_layers: int = 0
    lock_text_freeze_layer_norm: bool = True
    image_mean: Optional[List[float]] = None
    image_std: Optional[List[float]] = None
    image_interpolation: Optional[str] = None
    image_resize_mode: Optional[str] = None
    aug_cfg: List[str] = field(default_factory=list)
    force_image_size: Optional[List[int]] = None
    force_quick_gelu: bool = False
    force_patch_dropout: Optional[float] = None
    force_custom_text: bool = False
    siglip: bool = False
    use_bnb_linear: Optional[str] = None

    # -- loss ---------------------------------------------------------
    local_loss: bool = False
    gather_with_grad: bool = False
    class_weighted_loss: bool = False
    coca_caption_loss_weight: float = 2.0
    coca_contrastive_loss_weight: float = 1.0

    # -- compile / trace ---------------------------------------------------
    torchscript: bool = False
    torchcompile: bool = False
    trace: bool = False

    # -- distributed ---------------------------------------------------------
    dist_url: str = "env://"
    dist_backend: str = "jax"  # JAX's default, kept: nccl on the card, gloo on the CPU
    distributed: bool = False
    ddp_static_graph: bool = False
    no_set_device_rank: bool = False
    use_bn_sync: bool = False
    horovod: bool = False

    # -- misc ---------------------------------------------------------
    seed: int = 0
    small_test: bool = False
    is_test: bool = False

    # -- HPO ---------------------------------------------------------
    hyperparameter_tuning: bool = False
    hyperparameter_strategy: str = "optuna"
    optuna_study_name: str = "mamba_clip_study"
    optuna_storage: Optional[str] = None
    training_iterations: int = 30
    eval_loss: Optional[str] = None
    study_name: str = "mamba_clip_study"
    return_best: bool = False
    hopt_direction: str = "minimize"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump(self, path: str) -> None:
        """``params.txt``: one ``name: value`` line a flag, sorted."""
        with open(path, "w") as f:
            for k in sorted(self.to_dict()):
                f.write(f"{k}: {getattr(self, k)}\n")

    def replace(self, **kw) -> "Args":
        return dataclasses.replace(self, **kw)


# Flags accepted for CLI parity but without effect in this port, with the
# reason: anything accepted-but-ignored appears here; everything else parsed
# from Args has an effect or fails when the pipeline starts.
IGNORED_FLAGS = {
    "torchscript": "the steps are eager PyTorch with hand-written kernels; "
                   "nothing is scripted",
    "torchcompile": "the steps are eager PyTorch with hand-written kernels; "
                    "nothing is compiled by torch.compile",
    "use_bnb_linear": "bitsandbytes is not used; the int8 modes are --quant",
    "use_bn_sync": "BatchNorm always takes the global batch's statistics "
                   "across the ranks, as the JAX mesh does",
    "ddp_static_graph": "DDP tuning knob; no DDP wrapper exists in the port",
    "no_set_device_rank": "each rank always takes cuda:<LOCAL_RANK>",
    "horovod": "alternative torch launcher; the port's ranks are torchrun's",
    "zero_shot": "parsed by the reference and likewise never read "
                 "(cli/main.py:15)",
    "coca_caption_loss_weight": "CoCa loss weights; the reference parses "
                                "them but ships no CoCa path",
    "coca_contrastive_loss_weight": "see coca_caption_loss_weight",
    "force_custom_text": "open_clip custom-text toggle; the reference "
                         "never reads it",
    "image_resize_mode": "the reference never reads it either "
                         "(cli/main.py:66); host staging implements the "
                         "'shortest' keep-ratio mode",
}


def warn_ignored_flags(args: "Args", logger) -> list:
    """Warn once a run for each IGNORED_FLAGS entry set away from its
    default, so that 'accepted but ignored' is loud. Returns the names."""
    hit = []
    defaults = Args()
    for name, why in IGNORED_FLAGS.items():
        if getattr(args, name, None) != getattr(defaults, name, None):
            hit.append(name)
            logger.warning(
                f"--{name.replace('_', '-')} has no effect in this port: {why}"
            )
    return hit


@dataclass
class RunState:
    """What a run derives: placement, names and paths, and the loop's
    meters (epoch -> the data and batch meters of ``train_one_epoch``)."""

    rank: int = 0
    local_rank: int = 0
    world_size: int = 1
    distributed: bool = False
    device: str = "cuda"
    name: str = ""
    log_path: Optional[str] = None
    checkpoint_path: str = ""
    tensorboard_path: str = ""
    tensorboard: bool = False
    wandb: bool = False
    resume_from: Optional[str] = None
    meters: Dict[int, Dict[str, Any]] = field(default_factory=dict)


def _flag_name(field_name: str) -> str:
    return "--" + field_name.replace("_", "-")


def _unwrap_optional(tp):
    if get_origin(tp) is not None and type(None) in get_args(tp):
        inner = [a for a in get_args(tp) if a is not type(None)]
        if len(inner) == 1:
            return inner[0]
    return tp


def arg_parser() -> argparse.ArgumentParser:
    """Generate the argparse parser from the Args dataclass."""
    parser = argparse.ArgumentParser("mamba-clip-torch")
    for f in fields(Args):
        name = _flag_name(f.name)
        tp = _unwrap_optional(f.type if not isinstance(f.type, str) else eval(f.type))  # noqa: S307
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        )
        if tp is bool:
            parser.add_argument(name, dest=f.name, action="store_true", default=default)
            if default:  # allow turning off a default-on bool
                parser.add_argument(
                    "--no-" + name[2:], dest=f.name, action="store_false"
                )
        elif get_origin(tp) is list or tp is list:
            elem = get_args(tp)[0] if get_args(tp) else str
            parser.add_argument(name, dest=f.name, type=elem, nargs="*", default=default)
        else:
            parser.add_argument(name, dest=f.name, type=tp, default=default)
    return parser


def parse_args(argv: Optional[List[str]] = None) -> Args:
    ns = arg_parser().parse_args(argv)
    valid = {f.name for f in fields(Args)}
    return Args(**{k: v for k, v in vars(ns).items() if k in valid})


def args_from_dict(d: dict) -> Args:
    valid = {f.name for f in fields(Args)}
    return Args(**{k: v for k, v in d.items() if k in valid})


def save_args(args: Args, path: str) -> None:
    with open(path, "w") as f:
        json.dump(args.to_dict(), f, indent=2, default=str)


def load_args(path: str) -> Args:
    with open(path) as f:
        return args_from_dict(json.load(f))
