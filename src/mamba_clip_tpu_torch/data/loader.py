"""Batch pipeline: fixed-shape numpy batches, threaded prefetch, device feed.

Counterpart of ``mamba_clip_tpu/data/loader.py``: ``BatchLoader``,
``DataInfo``, ``get_data`` (over the ISIC files or ``--synthetic-data``)
and ``device_prefetch``.

- Train batches have a fixed size (``drop_last``); eval loaders keep
  ``drop_last=False`` and yield a natural-size final batch, so every sample
  is evaluated.
- Sharding is per-host index-space slicing (``data/sampling.py``).
- A background thread assembles batches ahead of the consumer (``workers``
  is the size of its item-fetch pool).
- :func:`device_prefetch` keeps ``depth`` batches in flight to ``device``:
  on a CUDA device through pinned host buffers and ``non_blocking`` copies
  (a copy from pageable memory is synchronous), each buffer refilled only
  after the copy out of it has finished.

The batches of an epoch equal the JAX package's array for array for the
same dataset, seed and epoch.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .sampling import combo_epoch_indices, epoch_indices


def _stack(items):
    out = {}
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items])
    return out


class BatchLoader:
    """Iterable over fixed-size batches for one epoch at a time."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampling: Optional[str] = None,
        n_epochs: Optional[int] = None,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        workers: int = 4,
        balanced_mixup: bool = False,
        prefetch_batches: int = 4,
        shuffle: bool = True,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampling = sampling
        self.n_epochs = n_epochs
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.workers = max(workers, 1)
        self.balanced_mixup = balanced_mixup
        self.prefetch_batches = prefetch_batches
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        # mid-epoch resume (--checkpoint-steps): skip the first
        # `start_batch` batches of the epoch without loading them. The
        # epoch's index order is deterministic in (seed, epoch), so the tail
        # stream is identical to an uninterrupted epoch's tail.
        self.start_batch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def _per_host(self) -> int:
        n = len(self.dataset)
        if self.drop_last or self.shuffle:
            return n // self.world_size
        # full-coverage eval sharding: the first n % world hosts carry one
        # extra sample (np.array_split), so the union over hosts is the
        # whole split
        return n // self.world_size + (1 if self.rank < n % self.world_size else 0)

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self._per_host // self.batch_size
        return -(-self._per_host // self.batch_size)  # ceil

    @property
    def num_samples(self) -> int:
        if self.drop_last:
            return self.num_batches * self.batch_size
        return self._per_host

    def _indices(self):
        targets = getattr(self.dataset, "targets", None)
        n = len(self.dataset)
        if not self.shuffle:
            if self.drop_last:
                per = n // self.world_size
                base = np.arange(self.rank * per, (self.rank + 1) * per)
            else:
                base = np.array_split(np.arange(n), self.world_size)[self.rank]
            return base, None
        if self.balanced_mixup:
            return combo_epoch_indices(
                targets, self.seed, self.epoch,
                base_sampling=self.sampling or "instance",
                n_eps=self.n_epochs, rank=self.rank, world_size=self.world_size,
            )
        idx = epoch_indices(
            targets if targets is not None else np.zeros(n, np.int64),
            self.sampling, self.seed, self.epoch, self.n_epochs,
            self.rank, self.world_size,
        )
        return idx, None

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        main_idx, mix_idx = self._indices()
        nb = self.num_batches
        if nb == 0:
            raise ValueError(
                f"dataset yields 0 batches: {len(self.dataset)} samples / "
                f"{self.world_size} hosts < batch size {self.batch_size} "
                "(batches are fixed-shape; reduce --batch-size or add data)"
            )
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def fetch_chunk(chunk):
            # one task per contiguous chunk, not per item: per-item tasks
            # thrash the GIL on pure-Python items
            ds = self.dataset
            return [ds[int(i)] for i in chunk]

        def gather(pool, idx_slice):
            chunks = np.array_split(idx_slice, self.workers)
            items = []
            for part in pool.map(fetch_chunk, [c for c in chunks if len(c)]):
                items.extend(part)
            return items

        def put(item) -> bool:
            # stop-aware put: a plain q.put would block forever when the
            # consumer abandons the iterator, leaking the worker pool
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for b in range(self.start_batch, nb):
                        if stop.is_set():
                            return
                        # the final slice is naturally shorter when
                        # drop_last=False (numpy slicing clamps)
                        sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
                        batch = _stack(gather(pool, main_idx[sl]))
                        if mix_idx is not None:
                            mix = _stack(gather(pool, mix_idx[sl]))
                            batch = {**batch, **{f"mix_{k}": v for k, v in mix.items()}}
                        if not put(batch):
                            return
                put(None)
            except BaseException as e:  # propagate into the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


@dataclass
class DataInfo:
    """Loader + bookkeeping."""

    loader: BatchLoader
    targets: Optional[np.ndarray] = None
    class_weights: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        return self.loader.num_samples

    @property
    def num_batches(self) -> int:
        return self.loader.num_batches

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)


class _PinnedSlot:
    """Pinned host buffers of one in-flight batch, by (key, shape, dtype),
    and the event recorded after the copies out of them."""

    def __init__(self):
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def stage(self, key: str, arr: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        ident = (key, tuple(src.shape), src.dtype)
        buf = self.buffers.get(ident)
        if buf is None:
            buf = self.buffers[ident] = torch.empty(
                src.shape, dtype=src.dtype).pin_memory()
        buf.copy_(src)
        return buf


def device_prefetch(
    batch_iter: Iterator[Dict[str, np.ndarray]],
    device,
    depth: int = 2,
):
    """Move numpy batches to ``device`` ahead of consumption and yield
    dicts of tensors there, ``depth`` batches in flight.

    On a CUDA device each batch is staged in pinned host buffers and copied
    with ``non_blocking=True`` on the current stream, so the host does not
    wait for the copy. ``depth + 1`` sets of buffers rotate; a set is
    refilled only after the event recorded behind its last copy has
    completed. On the CPU the arrays are wrapped as tensors."""
    device = torch.device(device)
    buf: deque = deque()
    if device.type != "cuda":
        for batch in batch_iter:
            buf.append({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
            if len(buf) > depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
        return
    slots = [_PinnedSlot() for _ in range(depth + 1)]
    for i, batch in enumerate(batch_iter):
        slot = slots[i % len(slots)]
        if slot.copied is not None:
            slot.copied.synchronize()  # the copy out of these buffers is done
        dev = {k: slot.stage(k, v).to(device, non_blocking=True) for k, v in batch.items()}
        slot.copied = torch.cuda.Event()
        slot.copied.record(torch.cuda.current_stream(device))
        buf.append(dev)
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def get_data(
    args,
    train_metadata=None,
    val_metadata=None,
    test_metadata=None,
    tokenizer=None,
    staging_size: int = 256,
    rank: int = 0,
    world_size: int = 1,
) -> Dict[str, DataInfo]:
    """Build the train/val/test ``DataInfo``: ``IsicChallengeDataset`` over
    each split's metadata (images from ``<data_path>/train-image.hdf5``,
    ``test-image.hdf5`` under ``--is-test``, else the JPEG directory
    ``<data_path>/train-image/image``), or ``SyntheticIsicDataset`` under
    ``--synthetic-data``."""
    from .dataset import IsicChallengeDataset, SyntheticIsicDataset
    from .metadata import balanced_class_weights

    synthetic = getattr(args, "synthetic_data", False)
    is_test = getattr(args, "is_test", False)
    data = {}

    def make(meta, is_train: bool, split: str = "train"):
        # Stage-1 contrastive text carries the diagnosis sentence; stage 2
        # and the unlabeled test split never do.
        include_target = getattr(args, "stage", 1) == 1 and split != "test"
        # --train/val-num-samples cap the split size
        cap = (
            args.train_num_samples if split == "train"
            else args.val_num_samples if split == "val"
            else None
        )
        if synthetic:
            n = len(meta) if meta is not None else (
                args.train_num_samples or 2048 if is_train
                else args.val_num_samples or 512
            )
            if cap:
                n = min(int(n), int(cap))
            ds = SyntheticIsicDataset(
                n=int(n), tokenizer=tokenizer, staging_size=staging_size,
                is_train=is_train, include_target=include_target, seed=args.seed,
            )
        else:
            hdf5 = os.path.join(
                args.data_path, "train-image.hdf5" if not is_test else "test-image.hdf5")
            img_dir = os.path.join(args.data_path, "train-image", "image")
            path = hdf5 if os.path.exists(hdf5) else img_dir
            if cap and meta is not None and len(meta) > int(cap):
                meta = meta.take(np.arange(int(cap)))
            ds = IsicChallengeDataset(
                path, meta, tokenizer=tokenizer, staging_size=staging_size,
                is_train=is_train, include_target=include_target,
                small_test=args.small_test, seed=args.seed,
                cache_dir=getattr(args, "cache_staging", None),
            )
        loader = BatchLoader(
            ds,
            batch_size=args.batch_size,
            sampling=args.sampling if is_train else None,
            n_epochs=args.epochs,
            seed=args.seed,
            rank=rank,
            world_size=world_size,
            workers=args.workers,
            balanced_mixup=bool(args.balanced_mixup) and is_train,
            shuffle=is_train,
            drop_last=is_train,  # eval covers the full split
        )
        targets = getattr(ds, "targets", None)  # None for the label-free test split
        cw = balanced_class_weights(targets) if is_train and targets is not None else None
        return DataInfo(loader=loader, targets=targets, class_weights=cw)

    if train_metadata is not None or synthetic:
        if not is_test:
            data["train"] = make(train_metadata, is_train=True, split="train")
    if val_metadata is not None or synthetic:
        if not is_test:
            data["val"] = make(val_metadata, is_train=False, split="val")
    if test_metadata is not None:
        data["test"] = make(test_metadata, is_train=False, split="test")
    return data
