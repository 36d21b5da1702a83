"""The optuna search.

Counterpart of ``mamba_clip_tpu/integrations/optuna.py``: every process
runs its own worker against a shared study, with the multivariate TPE
sampler seeded per rank (``--seed`` plus the rank of
``parallel/mesh.py::world_info_from_env``); a trial copies the base
flags, draws its hyperparameters (:func:`suggest_args`), trains through
:class:`~.runner.TrialRunner` and reports the evaluation metric each epoch,
so that a pruner can stop it mid-run; a NaN metric, a ``ValueError`` or a
``FloatingPointError`` scores the trial as the worst value instead of
ending the study; the study is written with joblib where it is installed.

optuna is optional: it is imported when the search runs, and its absence
is an ``ImportError`` that names it.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

from ..config import Args
from ..utils.logging import get_logger

logger = get_logger(__name__)


def _require_optuna():
    try:
        import optuna  # noqa: F401

        return optuna
    except ImportError as e:
        raise ImportError(
            "optuna is not installed; install it to use "
            "--hyperparameter-tuning with the optuna strategy"
        ) from e


def suggest_args(trial, base: Args) -> Args:
    """The search space: undersample 10k..100k by 10k, lr log [1e-6, 1e-3],
    beta1 and beta2 [0.9, 0.999], eps log [1e-9, 1e-7], wd log [1e-4,
    1e-1], the cosine schedule, restarts every epoch or none, batch size
    8..256, grad clip log [1e-2, 1e2], balanced mixup [0, 1]. ``warmup`` is
    drawn as a float in [0, 1] and read as a fraction of the total steps
    (``schedules.resolve_warmup``): read as a step count, any value below 1
    would make the first step's lr base/warmup."""
    kw = dict(
        undersample=trial.suggest_int("undersample", 10_000, 100_000, step=10_000),
        lr=trial.suggest_float("lr", 1e-6, 1e-3, log=True),
        beta1=trial.suggest_float("beta1", 0.9, 0.999),
        beta2=trial.suggest_float("beta2", 0.9, 0.999),
        eps=trial.suggest_float("eps", 1e-9, 1e-7, log=True),
        wd=trial.suggest_float("wd", 1e-4, 1e-1, log=True),
        warmup=trial.suggest_float("warmup", 0.0, 1.0),
        lr_scheduler="cosine",
        batch_size=trial.suggest_categorical(
            "batch_size", [8, 16, 32, 64, 128, 256]
        ),
        accum_freq=1,
        grad_clip_norm=trial.suggest_float("grad_clip_norm", 1e-2, 1e2, log=True),
        balanced_mixup=trial.suggest_float("balanced_mixup", 0.0, 1.0),
        lr_restart_interval=trial.suggest_categorical(
            "lr_restart_interval", [1, None]
        ),
    )
    return base.replace(**kw)


def make_objective(base_args: Args):
    """The trial objective over the classifier zoo: the metric is reported
    every epoch (``trial.report``) and ``trial.should_prune()`` stops the
    trial with ``optuna.TrialPruned``; returns the best value seen."""
    from . import runner

    def objective(trial):
        args = suggest_args(trial, copy.deepcopy(base_args))
        args = args.replace(
            name=f"{base_args.name or 'optuna'}-trial_{trial.number}",
            eval_loss=base_args.eval_loss or "val_loss",
        )
        key = args.eval_loss
        minimize = "min" in base_args.hopt_direction
        bad = math.inf if minimize else 0.0
        try:
            trial_runner = runner.TrialRunner(args, trial_id=trial.number)
            best = None
            for epoch in range(args.epochs):
                metrics = trial_runner.step()
                val = float(metrics.get(key, bad))
                if math.isnan(val):
                    return bad
                if hasattr(trial, "report"):
                    trial.report(val, epoch)
                if getattr(trial, "should_prune", lambda: False)():
                    raise _require_optuna().TrialPruned()
                best = val if best is None else (
                    min(best, val) if minimize else max(best, val)
                )
            return bad if best is None else best
        except (FloatingPointError, ValueError) as e:
            logger.warning(f"trial {trial.number} failed ({e}); scoring {bad}")
            return bad

    return objective


def _storage(args: Args, optuna):
    """The shared storage: a Redis journal for a ``redis`` URL, else the
    URL itself (an RDB URL), or None (in memory)."""
    url: Optional[str] = args.optuna_storage
    if not url:
        return None
    if url.startswith("redis"):
        from optuna.storages import JournalStorage

        try:
            from optuna.storages.journal import JournalRedisBackend
        except ImportError:
            from optuna.storages import JournalRedisStorage as JournalRedisBackend
        return JournalStorage(JournalRedisBackend(url))
    return url


def optuna_pipeline(args: Args):
    """``--hyperparameter-strategy optuna``: ``args.training_iterations``
    trials of this rank's worker; returns the study's best parameters."""
    optuna = _require_optuna()
    from ..parallel.mesh import world_info_from_env

    rank = world_info_from_env()[0]
    sampler = optuna.samplers.TPESampler(multivariate=True, seed=args.seed + rank)
    direction = "minimize" if "min" in args.hopt_direction else "maximize"
    study = optuna.create_study(
        study_name=args.optuna_study_name or args.study_name,
        storage=_storage(args, optuna),
        sampler=sampler,
        direction=direction,
        load_if_exists=True,
    )
    objective = make_objective(args)
    if args.report_to and "wandb" in args.report_to:
        # each trial tracked as a wandb run of its own
        try:
            try:
                from optuna_integration.wandb import WeightsAndBiasesCallback
            except ImportError:
                from optuna.integration.wandb import WeightsAndBiasesCallback
            import dataclasses

            wandb_kwargs = dict(
                project=args.wandb_project_name or "mamba-clip",
                name=f"{args.name or 'AutoTrain'}_{rank}",
                id=f"{args.name or 'AutoTrain'}_{rank}",
                notes=args.wandb_notes,
                resume="auto" if args.resume == "latest" else None,
                config=dataclasses.asdict(args),
            )
            wandbcb = WeightsAndBiasesCallback(wandb_kwargs=wandb_kwargs)
            objective = wandbcb.track_in_wandb()(objective)
        except ImportError:
            logger.warning(
                "--report-to wandb requested but the optuna wandb "
                "integration is not installed; trials run untracked"
            )
    study.optimize(objective, n_trials=args.training_iterations)
    try:
        import joblib

        joblib.dump(study, f"{args.logs}/{study.study_name}.pkl")
    except Exception:
        pass
    logger.info(f"Best trial: {study.best_trial.number} value {study.best_value}")
    return study.best_params
