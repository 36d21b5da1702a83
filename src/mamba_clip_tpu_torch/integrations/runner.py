"""The per-epoch trial lifecycle that every search shares.

Counterpart of ``mamba_clip_tpu/integrations/runner.py``:

- :class:`TrialRunner` builds the data, the classifier zoo model and its
  train step for one configuration of hyperparameters, and exposes
  ``step()`` (one epoch of training, then the evaluation: a dict of
  metrics), ``save()`` and ``restore()``;
- :func:`asha_search` is the native Asynchronous Successive Halving loop
  over TrialRunners, which needs neither ray nor optuna. The trials run one
  after another, rung by rung; each rung keeps the best
  ``max(1, alive // reduction_factor)`` trials, ASHA's decision rule, and
  its decisions, ranking and histories are the JAX package's.

A trial runs on the card (``cuda:0``) unless ``args.device`` is ``cpu``
(``pipeline.resolve_device``). The port's ``train_one_epoch`` feeds the
device itself and its ``save_checkpoint`` has committed when it returns,
so the runner passes ``device=`` and ``seed=`` where the JAX package's
passes ``device_put_fn=`` and saves with ``block=True``. The trial's
weights are drawn from a generator seeded with ``args.seed + trial_id``,
and its steps take that seed too.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

from ..config import Args, RunState
from ..utils.logging import get_logger

logger = get_logger(__name__)


class TrialRunner:
    """One trial with a per-epoch ``step()``: trains the classifier zoo
    model (``models.build_classifier`` of ``args.model``, or
    ``model_factory(args)``, an ``nn.Module``) on the args' data (synthetic
    or ISIC) as a stage-2 classifier."""

    def __init__(self, args: Args, trial_id: int = 0, model_factory=None):
        import torch

        from ..data.preprocess_cfg import get_transform_config
        from ..data.tokenizer import get_tokenizer
        from ..eval import make_eval_step
        from ..models import build_classifier
        from ..pipeline import _build_data, parse_aug_cfg, prepare_params, resolve_device
        from ..utils.precision import get_policy

        self.args = args
        self.trial_id = trial_id
        self.run = RunState(rank=0, world_size=1, device=resolve_device(args.device))
        self.seed = args.seed + trial_id
        policy = get_policy(args.precision)
        image_size = (args.force_image_size or [224])[0]
        tcfg_train = get_transform_config(
            parse_aug_cfg(args.aug_cfg), image_size, is_train=True,
            mean=args.image_mean, std=args.image_std,
            interpolation=args.image_interpolation,
        )
        tcfg_val = get_transform_config(
            None, image_size, is_train=False, mean=args.image_mean,
            std=args.image_std, interpolation=args.image_interpolation,
        )
        if model_factory is not None:
            model = model_factory(args)
        else:
            model = build_classifier(
                args.model, num_classes=args.num_classes or 2,
                dtype=policy.compute_dtype, grad_checkpointing=args.grad_checkpointing,
                quant=args.quant, generator=torch.Generator().manual_seed(self.seed),
            )
        tokenizer = get_tokenizer(args.tokenizer or "hash")
        self.data = _build_data(args, self.run, tokenizer, tcfg_train, tcfg_val)
        cw = self.data["train"].class_weights if "train" in self.data else None
        self.class_weights = cw if args.class_weighted_loss else None
        self.params = prepare_params(args, model, self.data, self.run, stage=2,
                                     takes_text=False, class_weights=cw)
        self.model = self.params["state"].model
        self.policy = self.params["policy"]
        self.tcfg_val = tcfg_val
        self.eval_step = make_eval_step(
            self.model, self.policy, tcfg_val, stage=2,
            class_weights=self.class_weights, takes_text=False,
        )
        self.epoch = 0

    def step(self) -> Dict[str, float]:
        """Train one epoch, evaluate, return the metrics (``val_loss``
        among them) with ``training_iteration``, the epochs done."""
        from ..eval import evaluate
        from ..train import train_one_epoch

        self.params["state"] = train_one_epoch(
            self.params["step_fn"], self.params["state"], self.data, self.epoch, self.args,
            self.seed, run_state=self.run, device=self.run.device,
        )
        self.epoch += 1
        metrics = evaluate(
            self.model, self.params["state"], self.data, self.epoch, self.args, self.policy,
            self.tcfg_val, run_state=self.run, stage=2, takes_text=False,
            eval_step=self.eval_step, class_weights=self.class_weights,
            device=self.run.device,
        )
        metrics["training_iteration"] = self.epoch
        return metrics

    def save(self, ckpt_dir: str) -> str:
        """Write ``trial_<id>_epoch_<epoch>`` under ``ckpt_dir``; returns its
        path once it has committed."""
        from ..checkpoint import save_checkpoint

        return save_checkpoint(
            ckpt_dir, self.params["state"], self.epoch, self.args,
            name=f"trial_{self.trial_id}_epoch_{self.epoch}",
        )

    def restore(self, path: str) -> None:
        from ..checkpoint import load_checkpoint

        self.params["state"], self.epoch = load_checkpoint(path, self.params["state"])


def asha_search(
    make_args: Callable[[int], Args],
    n_trials: int,
    metric: str = "val_loss",
    mode: str = "min",
    max_t: Optional[int] = None,
    grace_period: int = 1,
    reduction_factor: int = 2,
    model_factory=None,
) -> Dict[str, Any]:
    """Native ASHA over TrialRunners.

    Rungs at ``grace_period * reduction_factor**k`` epochs below ``max_t``
    (``args.epochs`` of trial 0 when None), then ``max_t``; at each rung
    below ``max_t`` the bottom ``1 - 1/reduction_factor`` of the surviving
    trials stop. Returns ``{"best_trial", "best_metrics", "pruned",
    "history"}``."""
    sign = 1.0 if mode == "min" else -1.0
    runners: List[Optional[TrialRunner]] = []
    scores: List[float] = []
    history: List[List[Dict[str, float]]] = []
    for t in range(n_trials):
        runners.append(TrialRunner(make_args(t), trial_id=t, model_factory=model_factory))
        scores.append(math.inf)
        history.append([])
    max_t = max_t or runners[0].args.epochs
    pruned: List[int] = []

    rungs = []
    r = grace_period
    while r < max_t:
        rungs.append(r)
        r *= reduction_factor
    rungs.append(max_t)

    prev_rung = 0
    for rung in rungs:
        for t, runner in enumerate(runners):
            if runner is None:
                continue
            for _ in range(prev_rung, rung):
                history[t].append(runner.step())
            scores[t] = sign * float(history[t][-1][metric])
        if rung < max_t:
            alive = [t for t, r_ in enumerate(runners) if r_ is not None]
            keep = max(1, len(alive) // reduction_factor)
            ranked = sorted(alive, key=lambda t: scores[t])
            for t in ranked[keep:]:
                logger.info(
                    f"ASHA: pruning trial {t} at epoch {rung} "
                    f"({metric}={sign * scores[t]:.4f})"
                )
                runners[t] = None
                pruned.append(t)
        prev_rung = rung

    alive = [t for t, r_ in enumerate(runners) if r_ is not None]
    best = min(alive, key=lambda t: scores[t])
    return {
        "best_trial": best,
        "best_metrics": history[best][-1],
        "pruned": pruned,
        "history": history,
    }
