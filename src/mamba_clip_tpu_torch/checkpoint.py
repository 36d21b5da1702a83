"""Checkpointing and resume discovery.

Counterpart of ``mamba_clip_tpu/checkpoint.py``: ``natural_key``,
``get_latest_checkpoint``, ``parse_step_checkpoint``,
``validate_step_resume``, ``save_checkpoint``, ``load_checkpoint``,
``load_params_only``, ``StepCheckpointer``, ``delete_previous_checkpoint``,
``wait_for_checkpoints``, ``remote_sync``, ``RemoteSyncThread`` and
``start_sync_process``.

The payload is the JAX package's: parameters, the Adam moments and count,
batch statistics (the model's buffers but its delayed int8 scales), step,
epoch, for the fp16 policies the loss scale and, under ``--quant
int8_delayed*``, the delayed scales (``quant_stats``: a resume quantizes
with the scales the interrupted run would have used). The format is the
port's own: a directory of the JAX package's name
(``[<prefix>]epoch_<N>``, ``..._step_<m>``,
``epoch_latest``), so discovery and the step names work unchanged, holding
one ``state.pt`` (``torch.save`` of CPU tensors). A save writes into a
temporary directory beside the target and renames it, so a reader sees a
whole checkpoint or none. Saves are synchronous: the tensors are copied to
the host before the call returns, which matters because the optimizer
updates parameters in place.

Everything is fp32 or integer and goes to disk and back unchanged, so a
state restored from a step checkpoint continues bit for bit.

A state sharded over the fsdp or model axes (``parallel/sharding.py``)
keeps the one-file format: every rank gathers the whole parameters and
moments (``save_checkpoint`` is then called on every rank, and rank 0
writes), and a load reads the whole file on every rank and keeps the
rank's slices, so a run resumes at another mesh shape.

The pretrained path: ``load_torch_clip`` reads the ``.npz`` that
``tools/convert_weights.py`` writes from an open_clip checkpoint (Flax
paths joined with ``/``, Flax layouts) into a port ``ClipModel``, through
``convert.py``'s name and layout rules, with ``_cubic_resize_matrix`` and
``resample_pos_embed`` for a ViT grid at another ``--force-image-size``.

The remote sync of ``--remote-sync``: ``remote_sync`` copies a run
directory to an fsspec URL (or a local directory) one pass at a time,
``RemoteSyncThread``/``start_sync_process`` repeat it in the background,
and ``get_latest_checkpoint(remote=True)`` discovers checkpoints there.
``load_checkpoint`` and ``load_params_only`` read a checkpoint under a URL
(``<protocol>://...``) through fsspec; a plain path loads from the disk.
``fsspec`` is imported inside these functions only.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .ops.qdot import delayed_scales
from .optim import AdamState
from .parallel.sharding import full_moments, full_params, plan_of, shard_of
from .utils.logging import get_logger
from .utils.precision import LossScaleState

logger = get_logger(__name__)

STATE_FILE = "state.pt"

_EPOCH_RE = re.compile(r"epoch_(\d+)(?:_step_(\d+))?$")

# mid-epoch step checkpoints (--checkpoint-steps) are named
# `<prefix>epoch_<e>_step_<m>` with e the current 0-based epoch and m the
# batches completed in it; natural sort orders them exactly right:
# epoch_e < epoch_e_step_m < epoch_{e+1}
_STEP_SUFFIX_RE = re.compile(r"epoch_(\d+)_step_(\d+)$")
_STEP_SKIP_RE = re.compile(r"epoch_\d+_step_\d+(?:\.meta\.json)?(?:/|$)")


def parse_step_checkpoint(path: str):
    """(epoch, batches_done) if `path` is a mid-epoch step checkpoint,
    else None."""
    m = _STEP_SUFFIX_RE.search(os.path.basename(path.rstrip("/")))
    return (int(m.group(1)), int(m.group(2))) if m else None


def validate_step_resume(
    path: str, batch_size: int, num_batches: Optional[int] = None
) -> None:
    """Check a step checkpoint's sidecar against this run's loader
    geometry. The stored batch offset is only meaningful under the batch
    size and epoch length it was written with, so a mismatch is an error.
    Checkpoints without a sidecar skip the check; pass ``num_batches=None``
    to skip the length check."""
    meta_path = path.rstrip("/") + ".meta.json"
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        meta = json.load(f)
    if (meta.get("batch_size") is not None
            and meta["batch_size"] != batch_size):
        raise ValueError(
            f"mid-epoch checkpoint {path} was written at --batch-size "
            f"{meta['batch_size']}; resuming at {batch_size} would "
            "fast-forward a different sample offset. Use the original "
            "batch size (or resume from an epoch checkpoint)."
        )
    if (num_batches is not None and meta.get("num_batches") is not None
            and meta["num_batches"] != num_batches):
        raise ValueError(
            f"mid-epoch checkpoint {path} was written over an epoch of "
            f"{meta['num_batches']} batches; this run's epoch has "
            f"{num_batches} — the dataset changed, so the stored batch "
            "offset points at different samples. Resume from an epoch "
            "checkpoint instead."
        )


def natural_key(s: str):
    """Natural sort key."""
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def get_latest_checkpoint(
    path: str, remote: bool = False, prefix: str = ""
) -> Optional[str]:
    """Newest ``[<prefix>]epoch_<N>`` checkpoint under `path`, a local
    directory or, with ``remote``, an fsspec URL (a local directory too).
    Checkpoints are written as ``stage_<S>_epoch_<N>``, so discovery
    matches numbered epochs with the given stage prefix and skips
    ``epoch_latest``."""
    names = []
    if remote:
        import fsspec

        fs, root = fsspec.core.url_to_fs(path)
        try:
            names = [os.path.basename(p.rstrip("/")) for p in fs.ls(root, detail=False)]
        except FileNotFoundError:
            return None
    elif os.path.isdir(path):
        names = os.listdir(path)
    cands = [n for n in names if n.startswith(prefix) and _EPOCH_RE.search(n)]
    if not cands:
        return None
    cands.sort(key=natural_key)
    return os.path.join(path, cands[-1])


def wait_for_checkpoints() -> None:
    """Block until every checkpoint write has committed. Saves are
    synchronous, so there is nothing to wait for; callers keep the call
    where an asynchronous writer would need it."""


def _buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The batch statistics: every state-dict entry that is neither a
    parameter nor a delayed int8 scale."""
    skip = {k for k, _ in model.named_parameters()} | set(delayed_scales(model))
    return {k: v for k, v in model.state_dict().items() if k not in skip}


def _to_host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def save_checkpoint(
    ckpt_dir: str,
    state,
    epoch: int,
    args=None,
    name: Optional[str] = None,
    write: bool = True,
) -> Optional[str]:
    """Write ``epoch_<N>`` (or ``name``) under ``ckpt_dir`` and return its
    path; save_frequency and delete-previous are honoured at the call site.
    The save has committed when the call returns. A sharded state is
    gathered first, a collective: every rank calls the function, and only
    the one with ``write`` writes (the others return None)."""
    model = state.model
    plan = plan_of(model)
    if not write and plan is None:
        return None
    params = _to_host(full_params(model))
    mu, nu = (_to_host(full_moments(m, plan)) for m in (state.opt_state.mu, state.opt_state.nu))
    if not write:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = name or f"epoch_{epoch}"
    path = os.path.abspath(os.path.join(ckpt_dir, tag))
    payload = {
        "params": params,
        "opt_state": {"count": int(state.opt_state.count), "mu": mu, "nu": nu},
        "batch_stats": _to_host(_buffers(model)),
        "step": int(state.step),
        "epoch": int(epoch),
    }
    if getattr(state, "loss_scale", None) is not None:
        # the dynamic fp16 scale: without it a resume would start at 2^16
        # again and skip steps until the back-off has converged
        payload["loss_scale"] = {"scale": float(state.loss_scale.scale),
                                 "growth_count": int(state.loss_scale.growth_count)}
    quant = delayed_scales(model)
    if quant:
        payload["quant_stats"] = _to_host(quant)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def _is_url(path: str) -> bool:
    return "://" in path


def _read(path: str) -> dict:
    """The payload of the checkpoint directory ``path``: a local path, or a
    URL read through fsspec."""
    if _is_url(path):
        import fsspec

        with fsspec.open(f"{path.rstrip('/')}/{STATE_FILE}", "rb") as f:
            return torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                      weights_only=True)


def _copy_into(named: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor], what: str,
               path: str) -> None:
    missing, extra = sorted(set(named) - set(saved)), sorted(set(saved) - set(named))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path}: {what} do not match the model: missing {missing[:5]}, "
            f"unexpected {extra[:5]}")
    with torch.no_grad():
        for k, t in named.items():
            if tuple(t.shape) != tuple(saved[k].shape):
                raise ValueError(
                    f"checkpoint {path}: {what[:-1]} {k} has shape {tuple(saved[k].shape)}, "
                    f"the model expects {tuple(t.shape)}")
            t.copy_(saved[k])


def _local(saved: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """The rank's slices of whole saved parameters (or moments) of a
    sharded ``model``; ``saved`` itself otherwise."""
    plan = plan_of(model)
    if plan is None:
        return saved
    return {k: shard_of(v, plan.placements.get(k), plan.mesh).clone() for k, v in saved.items()}


def load_checkpoint(path: str, state, allow_partial: bool = False):
    """Restore into an existing ``TrainState``: the parameters and buffers
    are copied into its model in place, the moments onto the parameters'
    devices. Returns (state, start_epoch). A sharded state keeps the
    rank's slices of the whole tensors.

    ``allow_partial`` permits a params-only restore when the saved optimizer
    state does not match this run's optimizer; only safe for eval-only
    runs, where fresh moments and schedule do not matter. A training
    resume keeps the hard error: silently resetting the Adam moments
    behind a warning corrupts the run."""
    wait_for_checkpoints()
    if not _is_url(path):
        path = os.path.abspath(path)
    restored = _read(path)
    model = state.model
    params = dict(model.named_parameters())
    _copy_into(params, _local(restored["params"], model), "parameters", path)
    _copy_into(_buffers(model), restored["batch_stats"], "buffers", path)

    saved_opt = dict(restored["opt_state"])
    saved_opt.update({m: _local(saved_opt[m], model) for m in ("mu", "nu")})
    fresh = state.opt_state
    matches = (set(saved_opt["mu"]) == set(fresh.mu) and all(
        tuple(saved_opt["mu"][k].shape) == tuple(fresh.mu[k].shape) for k in fresh.mu))
    if matches:
        opt_state = AdamState(
            count=int(saved_opt["count"]),
            mu={k: saved_opt["mu"][k].to(fresh.mu[k].device) for k in fresh.mu},
            nu={k: saved_opt["nu"][k].to(fresh.nu[k].device) for k in fresh.nu})
    elif allow_partial:
        logger.warning(
            f"checkpoint {path}: optimizer state does not match this run's "
            "optimizer (different schedule/masks?); restoring params only"
        )
        opt_state = fresh
    else:
        raise ValueError(
            f"checkpoint {path}: optimizer state does not match this run's optimizer "
            f"({len(saved_opt['mu'])} saved moments, {len(fresh.mu)} expected); a training "
            "resume needs the same trainable mask")
    new_state = replace(state, step=int(restored["step"]), opt_state=opt_state)
    # a checkpoint written without the optional parts (another precision or
    # quant mode) restores the rest and keeps this run's fresh scaler and
    # init-calibrated delayed scales
    fresh_parts = False
    if getattr(state, "loss_scale", None) is not None:
        if "loss_scale" in restored:
            new_state = replace(new_state, loss_scale=LossScaleState(
                scale=float(restored["loss_scale"]["scale"]),
                growth_count=int(restored["loss_scale"]["growth_count"])))
        else:
            fresh_parts = True
    quant = delayed_scales(model)
    if quant:
        if "quant_stats" in restored:
            _copy_into(quant, restored["quant_stats"], "delayed scales", path)
        else:
            fresh_parts = True
    if fresh_parts:
        logger.warning(
            f"checkpoint {path} is missing loss-scale and/or quant "
            "state; starting those fresh"
        )
    # the stored epoch is the completed one (1-based); the epoch loop is
    # 0-based, so it doubles as the next epoch index
    return new_state, int(restored["epoch"])


def load_params_only(path: str, module: nn.Module) -> nn.Module:
    """Load just the parameters and buffers of a checkpoint into ``module``
    in place (stage 2 takes stage 1's latest CLIP this way)."""
    wait_for_checkpoints()
    restored = _read(path)
    _copy_into(dict(module.named_parameters()), _local(restored["params"], module),
               "parameters", path)
    _copy_into(_buffers(module), restored.get("batch_stats", {}), "buffers", path)
    return module


class StepCheckpointer:
    """Rotating mid-epoch checkpoint writer (``--checkpoint-steps``).

    Writes ``<prefix>epoch_<e>_step_<m>`` (e = current 0-based epoch,
    m = batches completed in it) and keeps the two most recent: deletion
    lags one save behind, so a committed step checkpoint survives on disk
    whenever the process dies. ``finalize()`` removes the leftovers once
    the stage's final numbered epoch checkpoint exists.
    """

    def __init__(self, ckpt_dir: str, args=None, prefix: str = "", write: bool = True):
        self.ckpt_dir = ckpt_dir
        self.args = args
        self.prefix = prefix
        self.write = write
        self._ring: list = []

    def __call__(self, state, epoch: int, batches_done: int,
                 num_batches: Optional[int] = None) -> Optional[str]:
        """Save; a sharded state is gathered on every rank, and only a
        writer (``write``) writes and rotates."""
        path = save_checkpoint(
            self.ckpt_dir, state, epoch, self.args,
            name=f"{self.prefix}epoch_{epoch}_step_{batches_done}", write=self.write,
        )
        if path is None:
            return None
        # sidecar: the loader geometry the batch offset is meaningful in;
        # a resume validates it
        with open(path + ".meta.json", "w") as f:
            json.dump({"batch_size": getattr(self.args, "batch_size", None),
                       "num_batches": num_batches}, f)
        self._ring.append(path)
        if len(self._ring) > 2:
            doomed = self._ring.pop(0)
            if os.path.isdir(doomed):
                shutil.rmtree(doomed)
            if os.path.exists(doomed + ".meta.json"):
                os.remove(doomed + ".meta.json")
        return path

    def finalize(self) -> None:
        """Delete the remaining step checkpoints of this stage prefix,
        including ones left by an earlier process that this run resumed
        from. Call only after the final epoch checkpoint has committed:
        every mid-epoch checkpoint is then strictly older training state."""
        wait_for_checkpoints()
        try:
            names = os.listdir(self.ckpt_dir)
        except FileNotFoundError:
            names = []
        for n in names:
            if n.startswith(self.prefix) and _STEP_SKIP_RE.search(n):
                p = os.path.join(self.ckpt_dir, n)
                if os.path.isdir(p):
                    shutil.rmtree(p)
                elif os.path.isfile(p):  # the .meta.json sidecar
                    os.remove(p)
        self._ring.clear()


def delete_previous_checkpoint(ckpt_dir: str, epoch: int, prefix: str = "") -> None:
    """``--delete-previous-checkpoint``."""
    prev = os.path.join(ckpt_dir, f"{prefix}epoch_{epoch - 1}")
    if os.path.isdir(prev):
        shutil.rmtree(prev)


def remote_sync(local_dir: str, remote_dir: str, protocol: str = "fsspec") -> bool:
    """One sync pass: copy new and changed files of ``local_dir`` to
    ``remote_dir``; True unless the pass failed. Skipped: ``epoch_latest``,
    files of the same size as their remote copy, and mid-epoch step
    checkpoints (``--checkpoint-steps``): they rotate, the local ring
    deletes them seconds after they are made and the deletion is never
    mirrored, so a synced one would be a stale step directory that remote
    ``--resume latest`` discovery sorts as newest. A size probe that fails
    uploads anyway; a file that vanishes mid-walk is skipped."""
    try:
        import fsspec

        rfs, rroot = fsspec.core.url_to_fs(remote_dir)
        for dirpath, _, filenames in os.walk(local_dir):
            for fn in filenames:
                lpath = os.path.join(dirpath, fn)
                rel = os.path.relpath(lpath, local_dir)
                if "epoch_latest" in rel or _STEP_SKIP_RE.search(rel):
                    continue
                rpath = os.path.join(rroot, rel)
                try:
                    if rfs.exists(rpath) and rfs.size(rpath) == os.path.getsize(lpath):
                        continue
                except FileNotFoundError:
                    pass  # the probe raced a delete; upload
                except Exception as e:
                    # a transient probe failure: upload anyway, put()
                    # overwrites, so the worst case is an unchanged file
                    # copied again
                    logger.warning(f"remote probe failed for {rel}: {e}")
                try:
                    rfs.makedirs(os.path.dirname(rpath), exist_ok=True)
                    rfs.put(lpath, rpath)
                except FileNotFoundError:
                    continue  # a rotating file vanished mid-walk
        return True
    except Exception as e:
        logger.error(f"remote sync failed: {e}")
        return False


class RemoteSyncThread(threading.Thread):
    """Runs :func:`remote_sync` every ``frequency`` seconds until
    :meth:`stop` (a daemon thread)."""

    def __init__(self, local_dir: str, remote_dir: str, frequency: int = 300,
                 protocol: str = "fsspec"):
        super().__init__(daemon=True)
        self.local_dir = local_dir
        self.remote_dir = remote_dir
        self.frequency = frequency
        self.protocol = protocol
        self._halt = threading.Event()  # Thread reserves ``_stop``

    def run(self):
        while not self._halt.wait(self.frequency):
            remote_sync(self.local_dir, self.remote_dir, self.protocol)

    def stop(self):
        self._halt.set()


def start_sync_process(local_dir, remote_dir, frequency=300, protocol="fsspec"):
    """Start and return a :class:`RemoteSyncThread`."""
    t = RemoteSyncThread(local_dir, remote_dir, frequency, protocol)
    t.start()
    return t


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) 1-D bicubic interpolation matrix with the semantics of
    ``F.interpolate(mode="bicubic", antialias=True)``, what timm's
    ``resample_abs_pos_embed`` calls: the cubic-convolution filter with
    A = -0.5, widened by the scale factor on downscale, the window truncated
    at the borders with its weights renormalized, output centre
    ``(i + 0.5) * scale``."""
    if n_in == n_out:
        return np.eye(n_in)
    scale = n_in / n_out
    ks = max(scale, 1.0)
    support = 2.0 * ks
    A = -0.5

    def cubic(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0,
            ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * A, 0.0),
        )

    M = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(n_in, int(center + support + 0.5))
        js = np.arange(xmin, xmax)
        w = cubic((js - center + 0.5) / ks)
        M[i, js] = w / w.sum()
    return M


def resample_pos_embed(src: np.ndarray, n_tokens: int,
                       num_prefix: int = 1) -> np.ndarray:
    """Bicubic-resize a ViT absolute position table to a new patch grid.

    ``src`` is ``(1, old_grid**2 + num_prefix, C)``; returns
    ``(1, n_tokens, C)`` where ``n_tokens - num_prefix`` is the new square
    grid. The prefix (CLS) slots are kept as they are; the grid is resized
    as an image, as timm's ``resample_abs_pos_embed`` does when open_clip
    loads a checkpoint at another image size."""
    _, n_src, ch = src.shape
    g_old = int(round((n_src - num_prefix) ** 0.5))
    g_new = int(round((n_tokens - num_prefix) ** 0.5))
    if g_old * g_old != n_src - num_prefix or g_new * g_new != n_tokens - num_prefix:
        raise ValueError(
            f"resample_pos_embed: non-square grids ({n_src} -> {n_tokens} "
            f"tokens with {num_prefix} prefix)"
        )
    prefix = src[:, :num_prefix]
    grid = src[0, num_prefix:].astype(np.float64).reshape(g_old, g_old, ch)
    M = _cubic_resize_matrix(g_old, g_new)
    grid = np.einsum("ij,jkc->ikc", M, grid)      # rows
    grid = np.einsum("kj,ijc->ikc", M, grid)      # cols
    out = np.concatenate(
        [prefix.astype(np.float64), grid.reshape(1, g_new * g_new, ch)], axis=1
    )
    return out.astype(src.dtype)


def load_torch_clip(path: str, model: nn.Module, strict: bool = True) -> nn.Module:
    """Load a converted open_clip (BiomedCLIP) checkpoint, the ``.npz`` of
    ``tools/convert_weights.py`` or ``convert.write_converted_npz``, into
    ``model``'s parameters in place (a ``ClipModel``) and return it.

    Position tables longer than the model's (BERT stores 512 positions,
    BiomedCLIP runs context 256) are truncated from the front; the ViT grid
    at another ``--force-image-size`` is resampled bicubically. A parameter
    with no source tensor is an error under ``strict`` (the default for
    --pretrained runs: random weights kept in a "pretrained" tower would
    quietly destroy it), else a warning; tensors left unused are a
    warning."""
    from .convert import _convert_value, _key, flax_shapes

    with np.load(path, allow_pickle=False) as data:
        flat = dict(data.items())
    missing, used = [], set()

    def adapt(key, src, shape):
        if tuple(src.shape) == tuple(shape):
            return src
        # the ViT's patch-grid table at another --force-image-size: resample
        # the grid (before the truncation rule below, which would scramble a
        # 2-D grid flattened row-major); the text table is pos_emb
        if (key.endswith("pos_embed") and src.ndim == 3 == len(shape)
                and src.shape[0] == shape[0] == 1
                and src.shape[-1] == shape[-1]):
            resized = resample_pos_embed(src, shape[1])
            logger.info(
                f"{key}: resampled position grid {src.shape[1] - 1} -> "
                f"{shape[1] - 1} tokens (bicubic, force_image_size graft)"
            )
            return resized
        # position tables: truncate extra positions (dim -2)
        if src.ndim == len(shape) and src.shape[-1] == shape[-1] and \
                src.shape[-2] > shape[-2] and src.shape[:-2] == tuple(shape[:-2]):
            return src[..., : shape[-2], :]
        if src.size == int(np.prod(shape)):
            return src.reshape(shape)
        raise ValueError(
            f"{key}: converted tensor {src.shape} incompatible with "
            f"model param {tuple(shape)}"
        )

    filled = {}
    for key, shape in flax_shapes(model).items():
        if key in flat:
            used.add(key)
            filled[key] = adapt(key, flat[key], shape).astype(np.float32, copy=False)
        else:
            missing.append(key)
    unused = sorted(set(flat) - used)
    if missing:
        msg = (f"load_torch_clip: {len(missing)} params have NO source tensor "
               f"in {path} (kept random init): {missing[:8]}"
               f"{'...' if len(missing) > 8 else ''}")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    if unused:
        logger.warning(
            f"load_torch_clip: {len(unused)} converted tensors unused: "
            f"{unused[:8]}{'...' if len(unused) > 8 else ''}"
        )
    named = dict(model.named_parameters())
    with torch.no_grad():
        for key, arr in filled.items():
            leaf = tuple(key.split("/"))
            named[_key("params", leaf)].copy_(
                torch.from_numpy(np.array(_convert_value(leaf, arr), order="C")))
    return model
