# Frozen copy of prifit_torch/data/loader.py at commit 0adee2a, for the
# benchmark's reference; see benchmark/reference/__init__.py.
"""Batching loader: worker threads and per-process sharding (the copy
leaves out the program's device prefetch, which the reference does not
use).

The port's copy of ``prifit_tpu/data/loader.py`` (``DataLoader`` and
``shard_for_host``).  It replaces ``torch.utils.data.DataLoader`` for
the numpy datasets: shuffling, fixed-size collation, deterministic
sharding of the example stream over data-parallel processes (``process_index`` of
``process_count``: the epoch shuffle is shared, and each process takes a
round-robin shard of it), and background worker threads that overlap
file parsing/collation with the device's steps (the reference's
``num_workers=4``, ``train_partseg_shapenet.py:178``).

Determinism: item loading uses a per-``(seed, epoch, index)`` rng (see
``_item_rng``) so batches are bit-identical for any ``num_workers``, and
equal to the JAX package's.  Datasets opt in by exposing ``get(index,
rng)``; plain ``dataset[i]`` access is serialized under a lock as a
fallback.

Ragged full-resolution chamfer clouds (ACD 4-tuples) are collated to a
fixed ``chamfer_npoints`` by resampling (see ``_resample``): the
reference relies on every ``.npy`` having the same resolution and then
resamples 2048 of the first 5000 on the fly
(``train_partseg_shapenet.py:441``).
"""

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


# batches loaded ahead of the consumer beyond one a worker thread
AHEAD = 2


def shard_for_host(indices: np.ndarray, process_index: int,
                   process_count: int) -> np.ndarray:
    """Static round-robin shard of an index stream for one process."""
    return indices[process_index::process_count]


def _resample(points: np.ndarray, n: int,
              rng: np.random.Generator) -> np.ndarray:
    if points.shape[0] == n:
        return points
    # subsample without replacement (unbiased; a prefix would permanently
    # drop ordered tails, e.g. ACD files sorted by component), upsample
    # with replacement
    choice = rng.choice(points.shape[0], n,
                        replace=points.shape[0] < n)
    return points[choice]


class DataLoader:
    """Iterates a dataset in collated numpy batches.

    Args:
        dataset: indexable with ``__len__``; items are tuples of arrays.
            If it exposes ``get(index, rng)``, item randomness comes from
            a per-(seed, epoch, index) rng (deterministic under workers).
        batch_size: batch size (of this process).
        shuffle: reshuffle each epoch with an epoch-derived rng.
        drop_last: drop the trailing partial batch (default True — static
            shapes; the reference instead papers over DataParallel arity
            crashes with try/except, ``train_partseg_shapenet.py:386-389``).
        chamfer_npoints: fixed collation size for ragged element 1 of ACD
            4-tuples (None = items are already fixed-size).
        process_index/process_count: data-parallel sharding of the
            stream (this process's index among ``process_count``).
        num_workers: >0 loads/collates batches in background threads,
            ``AHEAD`` beyond one a thread ahead of the consumer (0 =
            synchronous, same batches either way).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0,
                 chamfer_npoints: int | None = None,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.chamfer_npoints = chamfer_npoints
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self._seed = seed
        self._epoch = 0
        self._ds_lock = threading.Lock()

    def __len__(self):
        n = len(shard_for_host(np.arange(len(self.dataset)),
                               self.process_index, self.process_count))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _item_rng(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self._seed, epoch, index]))

    def _get_item(self, index: int, epoch: int) -> tuple:
        if hasattr(self.dataset, "get"):
            return self.dataset.get(int(index),
                                    rng=self._item_rng(epoch, int(index)))
        with self._ds_lock:
            return self.dataset[int(index)]

    def _collate(self, items: Sequence[tuple],
                 rng: np.random.Generator) -> tuple:
        cols = list(zip(*items))
        out = []
        for ci, col in enumerate(cols):
            col = list(col)
            if self.chamfer_npoints is not None and ci == 1:
                col = [_resample(c, self.chamfer_npoints, rng)
                       for c in col]
            out.append(np.stack(col))
        return tuple(out)

    def _load_batch(self, batch_idx: np.ndarray, epoch: int) -> tuple:
        items = [self._get_item(i, epoch) for i in batch_idx]
        # collation rng keyed off the first index, offset past the item
        # rng key space (SeedSequence keys must be non-negative)
        rng = self._item_rng(epoch, (1 << 32) + int(batch_idx[0]))
        return self._collate(items, rng)

    def _batches(self) -> list[np.ndarray]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            # epoch-dependent shuffle shared by all processes (same seed),
            # so the round-robin shard is disjoint and exhaustive
            epoch_rng = np.random.default_rng(
                self._seed * 100003 + self._epoch)
            epoch_rng.shuffle(indices)
        indices = shard_for_host(indices, self.process_index,
                                 self.process_count)
        out = []
        for start in range(0, len(indices), self.batch_size):
            batch_idx = indices[start:start + self.batch_size]
            if len(batch_idx) < self.batch_size and self.drop_last:
                break
            out.append(batch_idx)
        return out

    def __iter__(self) -> Iterator[tuple]:
        epoch = self._epoch
        self._epoch += 1
        batches = self._batches()
        if self.num_workers <= 0:
            for b in batches:
                yield self._load_batch(b, epoch)
            return

        # ordered sliding window of futures: workers stay
        # `num_workers + AHEAD` batches ahead of the consumer
        with ThreadPoolExecutor(self.num_workers) as pool:
            window = self.num_workers + AHEAD
            futures = deque(
                pool.submit(self._load_batch, b, epoch)
                for b in batches[:window])
            nxt = window
            while futures:
                out = futures.popleft().result()
                if nxt < len(batches):
                    futures.append(
                        pool.submit(self._load_batch, batches[nxt], epoch))
                    nxt += 1
                yield out
