"""Batching loader: worker threads, per-process sharding, device prefetch.

The port's copy of ``prifit_tpu/data/loader.py`` (``DataLoader`` and
``shard_for_host``), with :func:`prefetch_to_device` rebuilt for CUDA.
It replaces ``torch.utils.data.DataLoader`` for the numpy datasets:
shuffling, fixed-size collation, deterministic sharding of the example
stream over data-parallel processes (``process_index`` of
``process_count``: the epoch shuffle is shared, and each process takes a
round-robin shard of it), background worker threads that overlap
file parsing/collation with the device's steps (the reference's
``num_workers=4``, ``train_partseg_shapenet.py:178``), and
:func:`prefetch_to_device`, which copies the NEXT batches to the device on
a side CUDA stream while the current step runs.

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

The consumer's wait in :func:`prefetch_to_device`'s ``next()`` is the
profiler range ``data.wait``; the producer thread's own host seconds, in
the transform and in the placement, are the counters
``data.transform_s`` and ``data.place_s``, and the batches it placed
``data.batches`` (:mod:`prifit_torch.utils.profiling`).  Read by the
benchmark's ``prefetch_wait_ms`` and ``produce_ms``.
"""

import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from prifit_torch.utils.device import resolve_device
from prifit_torch.utils.profiling import add_seconds, count

# batches loaded ahead of the consumer beyond one a worker thread, and
# the depth of the device prefetch queue (double buffering)
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


_STOP = object()


def _map_batch(fn, batch):
    """``fn`` of each array of a tuple/list batch (a tuple), or of a
    batch that is one array."""
    if isinstance(batch, (tuple, list)):
        return tuple(fn(a) for a in batch)
    return fn(batch)


def _host_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.c_contiguous
                            else np.ascontiguousarray(a))


class _OnDevice:
    """A batch copied to the device on a side stream: its tensors and the
    event recorded after the copies.  The pinned host copies stay
    referenced until the batch is handed over."""

    def __init__(self, batch, event, host):
        self.batch, self.event, self.host = batch, event, host

    def tensors(self):
        return self.batch if isinstance(self.batch, tuple) \
            else (self.batch,)


class _CudaPlacer:
    """The default placement on a CUDA device: each array of the batch
    goes to pinned host memory, then to the device with a ``non_blocking``
    copy on a side stream, and an event is recorded after the copies."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch) -> _OnDevice:
        host = _map_batch(lambda a: _host_tensor(a).pin_memory(), batch)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            on_device = _map_batch(
                lambda h: h.to(self.device, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _OnDevice(on_device, event, host)


def _place_on_cpu(batch):
    return _map_batch(_host_tensor, batch)


class _PrefetchStream:
    """Iterator over prefetched, device-placed batches.

    ``close()`` (also called on garbage collection) unblocks and retires
    the producer thread, so abandoned streams don't leak blocked threads
    in long-lived processes; the thread is daemonic either way.
    """

    def __init__(self, iterable, transform, device):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=AHEAD)
        self._done = False
        self._stop = threading.Event()
        self._device = device
        if device.type == "cuda":
            self._put_fn = _CudaPlacer(device)
        else:
            self._put_fn = _place_on_cpu
        self._transform = transform
        self._iterable = iterable
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _enqueue(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _produce(self):
        try:
            for item in self._iterable:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                if self._transform is not None:
                    item = self._transform(item)
                t1 = time.perf_counter()
                placed = self._put_fn(item)
                # counted together, so that each batch counted brings
                # both of its times
                add_seconds("data.transform_s", t1 - t0)
                add_seconds("data.place_s", time.perf_counter() - t1)
                count("data.batches")
                if not self._enqueue(placed):
                    return
        except BaseException as e:   # surface worker errors to consumer
            self._enqueue((_STOP, e))
            return
        self._enqueue((_STOP, None))

    def __iter__(self):
        return self

    def __next__(self):
        with record_function("data.wait"):
            if self._done:
                # terminal latch: the producer has exited, so blocking on the
                # (empty) queue again would hang forever
                raise StopIteration
            item = self._q.get()
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _STOP:
                self._done = True
                self._stop.set()
                if item[1] is not None:
                    raise item[1]
                raise StopIteration
            if isinstance(item, _OnDevice):
                # the consumer's stream waits for the copies, and the caching
                # allocator keeps the side stream's buffers until the work the
                # consumer queues after this point is done
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(item.event)
                for t in item.tensors():
                    t.record_stream(stream)
                return item.batch
            return item

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag promptly
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass

    def __del__(self):
        self._stop.set()


def prefetch_to_device(iterable: Iterable,
                       transform: Callable | None = None,
                       device=None) -> Iterator:
    """Run ``transform`` + device placement in a background thread,
    ``AHEAD`` elements ahead of the consumer.

    The device's step then overlaps with host-side augmentation and the
    H2D copy of the NEXT batch (double buffering).
    ``transform`` runs in one thread, in stream order — host rng use
    inside it stays sequential and deterministic.

    Args:
        iterable: source of host batches (e.g. a :class:`DataLoader`).
        transform: optional host-side fn applied before the placement;
            it returns a tuple of numpy arrays, or one array.
        device: where batches go (CUDA unless named; raises without a
            GPU).  On a CUDA device the placement copies each
            array through pinned memory with a ``non_blocking`` copy on a
            side stream and records an event; ``__next__`` makes the
            current stream wait on that event and calls ``record_stream``
            on the tensors before it hands them over.  On the CPU the
            arrays become tensors that share their memory.
    Returns:
        a :class:`_PrefetchStream` iterator (supports ``close()``) of
        tuples of tensors (or tensors, for batches that are one array).
    """
    return _PrefetchStream(iterable, transform, resolve_device(device))
