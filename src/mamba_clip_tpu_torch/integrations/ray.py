"""The ray Tune search, and the native ASHA search behind the same search
space.

Counterpart of ``mamba_clip_tpu/integrations/ray.py``: an ASHA scheduler
over the search space of :func:`suggest_config`, attached to a SLURM
cluster through the ``ip_head``/``redis_password`` environment when it is
set; the Trainable builds a :class:`~.runner.TrialRunner` in ``setup`` and
steps one epoch a ``step``, with checkpoint save and restore hooks. A trial
takes one card (``{"cpu": 1, "gpu": 1}``), or one CPU under ``--device
cpu``.

ray is optional: it is imported when the ray search runs, and its absence is
an ``ImportError`` that names it. :func:`native_asha_pipeline` needs
neither ray nor optuna (``--hyperparameter-strategy asha``).
"""

from __future__ import annotations

import copy
import os

from ..config import Args
from ..utils.logging import get_logger

logger = get_logger(__name__)


def _require_ray():
    try:
        import ray
        from ray import tune

        return ray, tune
    except ImportError as e:
        raise ImportError(
            "ray[tune] is not installed; install it to use "
            "--hyperparameter-tuning with the ray strategy"
        ) from e


def suggest_config(tune):
    """The search space, in ``tune``'s primitives."""
    return {
        "lr": tune.loguniform(1e-6, 1e-3),
        "beta1": tune.uniform(0.85, 0.95),
        "beta2": tune.uniform(0.95, 0.999),
        "eps": tune.loguniform(1e-9, 1e-6),
        "wd": tune.uniform(0.0, 0.4),
        "warmup": tune.randint(0, 10_000),
        "batch_size": tune.choice([32, 64, 128]),
        "grad_clip_norm": tune.loguniform(0.1, 10.0),
        "balanced_mixup": tune.uniform(0.0, 0.4),
    }


def make_trainable(base_args: Args):
    """A ``tune.Trainable`` with a per-epoch ``step`` and
    ``save_checkpoint``/``load_checkpoint`` hooks, so that the ASHA
    scheduler sees each epoch's metrics and can stop a trial mid-run; the
    lifecycle is :class:`~.runner.TrialRunner`'s."""
    _, tune = _require_ray()
    from .runner import TrialRunner

    class MambaClipTrainable(tune.Trainable):
        def setup(self, config):
            trial_args = base_args.replace(
                **{k: v for k, v in config.items() if hasattr(base_args, k)}
            )
            self.runner = TrialRunner(
                trial_args, trial_id=abs(hash(self.trial_id)) % (2 ** 31)
            )

        def step(self):
            return self.runner.step()

        def save_checkpoint(self, checkpoint_dir):
            return self.runner.save(checkpoint_dir)

        def load_checkpoint(self, path):
            self.runner.restore(path)

    return MambaClipTrainable


def ray_tune_pipeline(args: Args):
    """``--hyperparameter-strategy ray``: ``args.training_iterations``
    samples under ASHA (grace 1, reduction 2, up to ``args.epochs``);
    returns the best configuration."""
    ray, tune = _require_ray()
    from ray.tune.schedulers import ASHAScheduler

    ip_head = os.environ.get("ip_head")
    if ip_head:  # a SLURM cluster's head node
        ray.init(
            address=ip_head,
            _redis_password=os.environ.get("redis_password"),
        )
    else:
        ray.init(ignore_reinit_error=True)

    base = copy.deepcopy(args)
    scheduler = ASHAScheduler(
        time_attr="training_iteration",
        metric=args.eval_loss or "val_loss",
        mode="min" if "min" in args.hopt_direction else "max",
        max_t=args.epochs,
        grace_period=1,
        reduction_factor=2,
    )
    resources = {"cpu": 1} if args.device == "cpu" else {"cpu": 1, "gpu": 1}
    tuner = tune.Tuner(
        tune.with_resources(make_trainable(base), resources),
        param_space=suggest_config(tune),
        tune_config=tune.TuneConfig(
            scheduler=scheduler, num_samples=args.training_iterations
        ),
    )
    results = tuner.fit()
    best = results.get_best_result()
    logger.info(f"Best config: {best.config}")
    return best.config


def native_asha_pipeline(args: Args):
    """``--hyperparameter-strategy asha``: ``args.training_iterations``
    trials, each with lr, beta1, beta2, wd and grad_clip_norm drawn from
    ``np.random.default_rng(args.seed)`` (the JAX package's draws, value
    for value), under :func:`~.runner.asha_search` up to ``args.epochs``.
    Returns its result."""
    import numpy as np

    from .runner import asha_search

    rng = np.random.default_rng(args.seed)

    def sample_config():
        return dict(
            lr=float(10 ** rng.uniform(-6, -3)),
            beta1=float(rng.uniform(0.85, 0.95)),
            beta2=float(rng.uniform(0.95, 0.999)),
            wd=float(rng.uniform(0.0, 0.4)),
            grad_clip_norm=float(10 ** rng.uniform(-1, 1)),
        )

    def make_args(t):
        return args.replace(**sample_config())

    mode = "min" if "min" in args.hopt_direction else "max"
    result = asha_search(
        make_args, n_trials=args.training_iterations,
        metric=args.eval_loss or "val_loss", mode=mode, max_t=args.epochs,
    )
    logger.info(
        f"ASHA best trial {result['best_trial']}: {result['best_metrics']} "
        f"({len(result['pruned'])} pruned)"
    )
    return result
