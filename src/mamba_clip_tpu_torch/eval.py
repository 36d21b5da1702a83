"""Eval engine: contrastive val loss, CE + pAUC (the ISIC-2024 metric).

Counterpart of ``mamba_clip_tpu/eval.py``:

- stage 1: the in-batch contrastive loss of every batch, sample-weighted
  mean;
- stage 2: CE + softmax probabilities, then **pAUC above 80% TPR** by the
  complement-flip trick, the ISIC-2024 competition metric;
- gated by ``--val-frequency``; metrics appended to ``results.jsonl``;
- on the test split of a run with a checkpoint directory,
  ``submission.csv``: ``isic_id,target``, one row per evaluated sample,
  the bytes ``pd.DataFrame.to_csv(index=False)`` writes
  (``data.metadata.write_csv``).

:func:`partial_auc` runs on numpy alone: its own ROC curve with
scikit-learn's handling of ties (one point per distinct score) and of the
collinear points it drops, since the interpolation at ``max_fpr`` reads
the two curve points around it. One eval step runs under
``torch.inference_mode()`` on the batch's device; probabilities and
targets accumulate on the host as numpy.

Several ranks (``world > 1``): each evaluates its shard and the shards are
combined (:func:`evaluate`); rank 0 logs and writes. Over a mesh with an
fsdp or a model axis the shards are the batch axis's (data × fsdp; the
model peers evaluate the same rows), combined over its group, and the
sharded parameters are gathered layer by layer, each released after its
layer's forward (``parallel/sharding.py``).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from .data.dataset import ColumnTable
from .data.loader import device_prefetch
from .data.metadata import write_csv
from .losses import clip_loss, cross_entropy_loss
from .ops.preprocess import eval_preprocess
from .parallel.collectives import all_gather_, comm_device
from .parallel.sharding import plan_of
from .utils.logging import get_logger

logger = get_logger(__name__)

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fpr, tpr) of binary labels (positive = 1) as
    ``sklearn.metrics.roc_curve`` gives them: scores sorted descending by a
    stable sort, one point per distinct score, interior points of straight
    segments dropped, (0, 0) prepended. A split without negatives (or
    positives) gives NaN rates and a warning."""
    y_true = np.asarray(y_true).ravel() == 1
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    idxs = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idxs]
    fps = 1 + idxs - tps
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    rates = []
    for counts, what in ((fps, "negative"), (tps, "positive")):
        if counts[-1] <= 0:
            warnings.warn(f"No {what} samples in y_true, the ROC rate is meaningless")
            rates.append(np.full(counts.shape, np.nan))
        else:
            rates.append(counts / counts[-1])
    return rates[0], rates[1]


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under (x, y), x monotonic (``sklearn.metrics.auc``)."""
    if x.shape[0] < 2:
        raise ValueError(
            f"At least 2 points are needed to compute area under curve, but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * _trapezoid(y, x))


def partial_auc(y_true, y_pred, min_tpr: float = 0.8) -> float:
    """pAUC above a TPR floor. Flips the labels and negates the scores, so
    that the area below ``max_fpr = 1 - min_tpr`` of the flipped curve is
    the area above ``min_tpr`` of the original."""
    max_fpr = abs(1 - min_tpr)
    if not (0 < max_fpr <= 1):
        raise ValueError(f"Expected min_tpr in [0, 1), got: {min_tpr!r}")
    v_gt = np.abs(np.asarray(y_true) - 1)
    v_pred = -1.0 * np.asarray(y_pred)
    fpr, tpr = _roc_curve(v_gt, v_pred)
    if max_fpr == 1:
        return _auc(fpr, tpr)
    stop = np.searchsorted(fpr, max_fpr, "right")
    x_interp = [fpr[stop - 1], fpr[stop]]
    y_interp = [tpr[stop - 1], tpr[stop]]
    tpr = np.append(tpr[:stop], np.interp(max_fpr, x_interp, y_interp))
    fpr = np.append(fpr[:stop], max_fpr)
    return _auc(fpr, tpr)


def make_eval_step(model, policy, tcfg, stage: int = 1, class_weights=None,
                   takes_text: bool = True):
    """``step(model, batch)`` over a batch of tensors on the model's device:
    stage 1 returns the contrastive loss; stage 2 ``(loss, probs)``, the
    loss 0 for a batch without ``target`` (the unlabeled test split). The
    model is put in eval mode by :func:`evaluate`."""
    weights = (None if class_weights is None
               else torch.as_tensor(np.asarray(class_weights, np.float32)))

    def images_of(batch):
        return eval_preprocess(
            batch["image"], out_size=tcfg.image_size, mean=tcfg.mean, std=tcfg.std,
            out_dtype=policy.compute_dtype,
            interpolation=getattr(tcfg, "interpolation", None) or "bilinear")

    def stage1_step(model, batch):
        with torch.inference_mode():
            out = model(image=images_of(batch), text=batch["tokens"])
            return clip_loss(out["image_features"], out["text_features"], out["logit_scale"])

    def stage2_step(model, batch):
        with torch.inference_mode():
            images = images_of(batch)
            logits = model(images, batch.get("tokens")) if takes_text else model(images)
            probs = torch.softmax(logits.float(), dim=-1)
            if "target" not in batch:
                return torch.zeros((), device=probs.device), probs
            w = None if weights is None else weights.to(logits.device)
            return cross_entropy_loss(logits, batch["target"], weight=w), probs

    return stage1_step if stage == 1 else stage2_step


def _gather(x: np.ndarray, world: int, group=None) -> np.ndarray:
    """The ``x`` of every rank of ``group`` (None: the default group),
    stacked (world, ...), through the process group's backend."""
    t = torch.as_tensor(np.array(x)).to(comm_device(group))
    return all_gather_(t, world, group=group).cpu().numpy()


def _combine_shards(cumulative_loss, num_samples, labeled, probs, targets, world, group=None):
    """The ranks' eval shards combined (JAX ``eval.py``'s world > 1 branch):
    the loss and sample sums; labeledness agreed first, so that a rank
    without targets drops them everywhere instead of entering a mismatched
    collective; probabilities and targets padded to the longest shard,
    gathered, and cut back to each rank's count, rank-major; over
    ``group`` (a batch axis's) when one is given."""

    def gather(x):
        return _gather(x, world) if group is None else _gather(x, world, group)

    sums = gather(np.array([cumulative_loss, num_samples], np.float64))
    cumulative_loss, num_samples = float(sums[:, 0].sum()), int(sums[:, 1].sum())
    lab_all = gather(np.array(int(labeled and targets is not None), np.int64))
    if probs is not None and not lab_all.all():
        if targets is not None:
            logger.warning("eval: some ranks saw no labels; dropping targets "
                           "globally (loss/pAUC unavailable)")
        targets, labeled = None, False
    if probs is not None:
        counts = gather(np.array(probs.shape[0], np.int64))
        pad = int(counts.max()) - probs.shape[0]
        p_all = gather(np.pad(probs, ((0, pad), (0, 0))))
        probs = np.concatenate([p_all[i, :counts[i]] for i in range(world)])
        if targets is not None:
            t_all = gather(np.pad(targets, (0, pad)))
            targets = np.concatenate([t_all[i, :counts[i]] for i in range(world)])
    return cumulative_loss, num_samples, labeled, probs, targets


def evaluate(
    model,
    state,
    data: Dict[str, Any],
    epoch: int,
    args,
    policy,
    tcfg,
    run_state=None,
    stage: Optional[int] = None,
    results_writer=None,
    class_weights=None,
    takes_text: bool = True,
    eval_step=None,
    device="cuda",
    tb_writer=None,
) -> Dict[str, float]:
    """Validation over the full split on ``device``. ``state`` is the
    ``TrainState`` (its model is evaluated) or None (then ``model``).
    ``tb_writer`` gets each metric as ``val/<name>`` at ``epoch``.

    Every rank evaluates its shard of the split (the loader's full-coverage
    split: the first n % world ranks carry one more row), and the shards
    are combined as the JAX package combines them: the scalar sums, the
    labeledness agreed before any targets collective, and a padded
    all-gather of the probabilities and the targets. Logging and the
    writes stay with rank 0. A sharded model gathers its layers one at a
    time (every rank of the mesh evaluates together), and its shards of the
    split are the batch axis's."""
    metrics: Dict[str, float] = {}
    rank = getattr(run_state, "rank", 0) if run_state else 0
    world = getattr(run_state, "world_size", 1) if run_state else 1
    master = rank == 0
    if "val" not in data and "test" not in data:
        return metrics
    if args.val_frequency and not (
        (epoch % args.val_frequency) == 0 or epoch == args.epochs
    ):
        return metrics

    stage = stage or args.stage
    step = eval_step or make_eval_step(
        model, policy, tcfg, stage=stage, class_weights=class_weights,
        takes_text=takes_text,
    )
    net = getattr(state, "model", None)
    if net is None:
        net = model
    net.eval()
    plan, group = plan_of(net), None
    if plan is not None:
        world, group = plan.mesh.axis().world, plan.mesh.axis().group
    return _evaluate(net, step, data, epoch, args, stage, master, world, group, run_state,
                     results_writer, tb_writer, device)


def _evaluate(net, step, data, epoch, args, stage, master, world, group, run_state,
              results_writer, tb_writer, device):
    metrics: Dict[str, float] = {}

    split = "val" if "val" in data else "test"
    loader = data[split].loader
    loader.set_epoch(0)
    cumulative_loss = 0.0
    num_samples = 0
    all_probs, all_targets = [], []
    labeled = True
    for i, batch in enumerate(device_prefetch(iter(loader), device)):
        bs = batch["image"].shape[0]
        if stage == 1:
            loss = step(net, batch)
        else:
            loss, probs = step(net, batch)
            all_probs.append(probs.cpu().numpy())
            if "target" in batch:
                all_targets.append(batch["target"].cpu().numpy())
            else:
                labeled = False
        cumulative_loss += float(loss) * bs
        num_samples += bs
        if master and i % args.log_every_n_steps == 0:
            logger.info(
                f"Eval Epoch: {epoch} [{num_samples} / {loader.num_samples}]\t"
                f"Loss: {cumulative_loss / num_samples:.6f}"
            )

    probs = np.concatenate(all_probs, axis=0) if all_probs else None
    targets = (np.concatenate(all_targets, axis=0)
               if labeled and all_targets else None)
    if world > 1:
        cumulative_loss, num_samples, labeled, probs, targets = _combine_shards(
            cumulative_loss, num_samples, labeled, probs, targets, world, group)
    if labeled:
        metrics["val_loss"] = cumulative_loss / max(num_samples, 1)
    if probs is not None:
        if probs.shape[1] == 1:
            probs = np.concatenate([1 - probs, probs], axis=1)
        if targets is not None:  # a label-free test split has no pAUC
            metrics["partial_auc"] = partial_auc(targets, probs[:, 1])
        if master and split == "test" and getattr(run_state, "checkpoint_path", None):
            # per-sample malignancy probabilities for a challenge submission;
            # eval order is sequential, so ids align with the probability rows
            ids = list(getattr(loader.dataset, "ids", range(len(probs))))
            sub = ColumnTable({"isic_id": ids[: len(probs)], "target": probs[:, 1]})
            sub_path = os.path.join(run_state.checkpoint_path, "submission.csv")
            write_csv(sub, sub_path)
            logger.info(f"wrote {len(sub)} predictions to {sub_path}")
    metrics.update({"epoch": epoch, "num_samples": num_samples})
    if not master:
        return metrics

    logger.info(
        f"Eval Epoch: {epoch} "
        + "\t".join(f"{k}: {round(v, 4):.4f}" for k, v in metrics.items())
    )
    if tb_writer is not None:
        for k, v in metrics.items():
            tb_writer.add_scalar(f"val/{k}", float(v), epoch)
    if results_writer is not None:
        results_writer.write(metrics)
    return metrics
