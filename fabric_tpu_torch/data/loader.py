"""Multi-worker batch loader on ``torch.utils.data.DataLoader`` worker
processes (counterpart of ``fabric_tpu/data/grain_pipeline.py``, whose
Grain loader this package has no use for).

The contract is ``grain_batch_iterator``'s and ``batch_iterator``'s:
fixed-shape batches, every sample once an epoch, the remainder padded
('wrap' at weight 1 for training, 'mask' at weight 0 for evaluation), a
shuffle reproducible from the seed, ``max_batches`` and ``skip_batches``.
More than that, the batches are bit-identical to ``batch_iterator``'s: a
worker builds batch b with the same ``make_batch`` on the same
``plan_epoch``, and each row draws its augmentation from an RNG keyed by
(seed, row position), so it does not matter which worker builds which
batch, or whether the batches before it were built at all.

No batch is pickled, copied between processes or pinned per batch.
Handed over that way (the DataLoader's default: each batch in fresh
shared memory, faulted in and copied to pinned memory by one thread), 7
workers on the 8 cores of an H100 host delivered 184 ms a batch of 128 x
96^2, slower than the one thread's 169 ms (``chip_smoke.py``).  Instead:

- The dataset's arrays go into one block of shared memory once
  (:class:`SharedArrays`); the workers map it rather than hold copies.
- The batches go into a ring of slots in another shared block, mapped
  once by every process and, for the card, registered once as pinned
  memory: a worker writes batch b straight into its slot and returns the
  slot's number, and the consumer copies the slot to the card without
  blocking and records an event that guards the slot's reuse.  The ring
  has ``workers x prefetch + 2`` slots: the DataLoader keeps that many
  less two batches in flight, so the slot a new batch is written to held
  the batch two before the one just delivered.
- Workers are forked by a ``forkserver`` that has imported this module
  (a ``fork`` of the training process, which has threads, can deadlock;
  the server has none, and a worker then starts in a fraction of a
  second) and stay alive across epochs: an epoch is a list of
  (seed, batch, slot) keys handed to the same workers.
  :func:`stop_worker_server` stops the server once the loaders are
  closed, for a program that must leave no process behind.
- An exception in a worker reaches the caller as the DataLoader re-raises
  it; nothing falls back to the single thread.
- The consumer's wait for a worker's batch and for a ring slot's copy to
  the card adds to the ``loader.wait_s`` counter (``utils/profiling``);
  while a profiler traces, each batch's ``loader.next``, ``loader.slot``
  and ``loader.upload`` are spans with the batch's index as id.

Both blocks live in ``/dev/shm``, and a process that writes past a full
``/dev/shm`` dies of SIGBUS rather than raising.  So each block is
reckoned against the free space there before it is allocated, and one
that does not fit raises a ``RuntimeError`` naming the byte counts
(:func:`check_shm`); nothing shrinks the ring or falls back to the
thread.  At batch 128, patch 96 and 5 dates, one slot is 307 MB.

A multi-date loader (``multi_date``) fills an ``imgs`` slot of (B, T, ps,
ps, C) instead of ``img1`` / ``img2``, T being the dataset's dates.

A ``compat_aug_stream`` is one sequential random stream, which workers
cannot share: ``compat_reference`` training keeps the thread of
``data/pipeline.py``.

In data-parallel training each rank runs a loader of its own over its
``batch_size / process_count`` rows of every global batch
(``process_index``, as ``batch_iterator`` takes them), and on a spatial
mesh axis over its ``spatial_index``-th slice of each patch's height, so
its ring holds that many rows a slot, each of its rows of a patch, and
each rank reckons its blocks, as it allocates them, against the one
``/dev/shm`` that the ranks of a host share.
"""

from __future__ import annotations

import gc
import multiprocessing
import shutil
import time
from typing import Iterator

import numpy as np
import torch

from fabric_tpu_torch.data.pipeline import (PatchSampler, batch_shapes,
                                            height_slice, make_batch,
                                            plan_epoch)
from fabric_tpu_torch.utils import profiling

SHM = "/dev/shm"


def check_shm(need: int, what: str) -> None:
    """Raise a RuntimeError unless ``need`` bytes fit the free space of
    ``/dev/shm`` (``what`` names the block)."""
    free = shutil.disk_usage(SHM).free
    if need > free:
        raise RuntimeError(
            f"{what} needs {need} bytes of shared memory, and {SHM} has "
            f"{free} bytes free: writing past it would kill the process "
            f"with SIGBUS.  Use fewer workers, a smaller prefetch or batch, "
            f"or num_workers=0 (the prefetch thread)")


def _layout(specs: dict) -> tuple[list, int]:
    """([(name, dtype, shape, offset)], bytes) of named arrays packed in
    one block, each at a 64-byte boundary."""
    layout, size = [], 0
    for name, (dtype, shape) in specs.items():
        size = -(-size // 64) * 64
        layout.append((name, np.dtype(dtype).str, tuple(shape), size))
        size += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return layout, size


class SharedArrays:
    """Named arrays in one block of shared memory.  Pickles as the
    block's handle and the layout, so a worker process maps the block
    instead of receiving a copy."""

    def __init__(self, specs: dict, what: str = "a shared block"):
        """``specs``: {name: (dtype, shape)}; the arrays start empty.
        Raises (:func:`check_shm`, ``what`` naming the block) if the block
        does not fit ``/dev/shm``."""
        self.layout, size = _layout(specs)
        check_shm(size, what)
        self.block = torch.empty(size, dtype=torch.uint8).share_memory_()

    @property
    def nbytes(self) -> int:
        return self.block.numel()

    def arrays(self) -> dict:
        """{name: numpy view of the block}."""
        buf = self.block.numpy()
        out = {}
        for name, dtype, shape, offset in self.layout:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            out[name] = buf[offset:offset + n].view(dtype).reshape(shape)
        return out


def share_dataset(dataset: dict) -> SharedArrays:
    """A {city: {'images', 'labels'}} dataset copied once into shared
    memory, under (city, key) names."""
    shared = SharedArrays({(city, k): (a.dtype, a.shape)
                           for city, entry in dataset.items()
                           for k, a in entry.items()}, "the shared dataset")
    for (city, k), a in shared.arrays().items():
        a[...] = dataset[city][k]
    return shared


def _batch_specs(slots: int, batch_size: int, patch_size: int,
                 dates: int, channels: int, multi_date: bool,
                 rows: int | None = None) -> dict:
    shapes = batch_shapes(batch_size, patch_size, dates, channels,
                          multi_date, rows)
    return {(slot, k): spec for slot in range(slots)
            for k, spec in shapes.items()}


def ring_slots(num_workers: int, prefetch: int) -> int:
    """Slots of a loader's ring: ``num_workers x prefetch + 2``."""
    return num_workers * max(prefetch, 1) + 2


def ring_bytes(num_workers: int, prefetch: int, batch_size: int,
               patch_size: int, dates: int, channels: int,
               multi_date: bool, rows: int | None = None) -> int:
    """Shared-memory bytes of a loader's ring (what :class:`BatchLoader`
    reckons against ``/dev/shm`` before it allocates), ``rows`` of each
    patch's height a row (default: all)."""
    return _layout(_batch_specs(ring_slots(num_workers, prefetch),
                                batch_size, patch_size, dates, channels,
                                multi_date, rows))[1]


class _EpochKeys(torch.utils.data.Sampler):
    """The (seed, batch, slot) keys of the epoch being loaded; replaced
    before each pass over the loader."""

    def __init__(self) -> None:
        self.keys: list[tuple[int, int, int]] = []

    def __iter__(self):
        return iter(self.keys)

    def __len__(self) -> int:
        return len(self.keys)


class _Batches(torch.utils.data.Dataset):
    """Item (seed, b, slot) writes batch b of the epoch planned from
    ``seed`` into ring slot ``slot`` and returns the slot."""

    def __init__(self, dataset: SharedArrays, ring: SharedArrays,
                 metadata: list, patch_size: int, augment: bool,
                 batch_size: int, shuffle: bool, pad_mode: str,
                 multi_date: bool, process_index: int = 0,
                 process_count: int = 1, spatial_index: int = 0,
                 spatial_count: int = 1):
        self.dataset, self.ring = dataset, ring
        self.metadata = list(metadata)
        self.patch_size = patch_size
        self.augment = augment
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_mode = pad_mode
        self.multi_date = multi_date
        self.process_index = process_index
        self.process_count = process_count
        self.spatial_index = spatial_index
        self.spatial_count = spatial_count
        self._sampler = self._slots = self._plan = None

    def __getitem__(self, key: tuple[int, int, int]) -> int:
        seed, b, slot = key
        if self._sampler is None:  # in the worker, over the shared blocks
            data: dict = {}
            for (city, k), a in self.dataset.arrays().items():
                data.setdefault(city, {})[k] = a
            self._sampler = PatchSampler(data, self.metadata,
                                         self.patch_size, self.augment,
                                         multi_date=self.multi_date)
            self._slots = {}
            for (i, k), a in self.ring.arrays().items():
                self._slots.setdefault(i, {})[k] = a
        if self._plan is None or self._plan.seed != seed:
            self._plan = plan_epoch(len(self.metadata), self.batch_size,
                                    self.shuffle, self.pad_mode, seed)
        make_batch(self._sampler, self._plan, b, out=self._slots[slot],
                   process_index=self.process_index,
                   process_count=self.process_count,
                   spatial_index=self.spatial_index,
                   spatial_count=self.spatial_count)
        return slot


def _worker_context():
    """The ``forkserver`` context, its server preloading this module (and
    with it torch) so that the workers it forks start warm."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def stop_worker_server() -> None:
    """Stop the ``forkserver`` that forks the workers and the resource
    tracker that came with it, and wait for both to exit.  Left alone,
    each outlives this process by the moment it takes to see its parent
    gone.  Call it once every :class:`BatchLoader` is closed (a worker
    still alive is terminated first, since it holds the tracker open);
    the next loader starts both again."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # closed loaders' queues unlink their semaphores first
    for p in multiprocessing.active_children():
        p.terminate()
        p.join()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class BatchLoader:
    """Batches of one patch list, built by ``num_workers`` persistent
    worker processes and delivered as tensors on ``device``.

    ``dataset`` is :func:`share_dataset`'s block; each worker keeps
    ``prefetch`` batches in flight; ``multi_date`` batches carry every
    date of the dataset as ``imgs``; ``process_index`` of
    ``process_count`` builds that rank's rows of each global batch of
    ``batch_size``, and ``spatial_index`` of ``spatial_count`` its slice
    of each patch's height.  The ring (:func:`ring_bytes`) must
    fit ``/dev/shm`` beside the dataset, or the constructor raises a
    RuntimeError before it allocates anything.  Use as a context manager,
    or call :meth:`close`, to stop the workers and release the ring."""

    def __init__(self, dataset: SharedArrays, metadata: list,
                 patch_size: int, augment: bool, batch_size: int, *,
                 shuffle: bool, pad_mode: str = "wrap", num_workers: int,
                 device, prefetch: int = 2, multi_date: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 spatial_index: int = 0, spatial_count: int = 1):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if batch_size % process_count:
            raise ValueError(f"global batch_size {batch_size} not divisible "
                             f"by process_count {process_count}")
        rows = height_slice(patch_size, spatial_index, spatial_count)
        self.device = torch.device(device)
        self.batch_size = batch_size
        self._n = len(metadata)
        prefetch = max(prefetch, 1)
        self._k = ring_slots(num_workers, prefetch)
        dates, channels = next(((shape[0], shape[-1]) for (_, key), _, shape,
                                _ in dataset.layout if key == "images"),
                               (0, 0))
        specs = _batch_specs(self._k, batch_size // process_count,
                             patch_size, dates, channels, multi_date,
                             rows.stop - rows.start)
        ring = SharedArrays(specs, (
            f"the batch ring of {self._k} slots ({num_workers} workers x "
            f"prefetch {prefetch} + 2), beside the shared "
            f"dataset's {dataset.nbytes} bytes,"))
        arrays = {key: torch.from_numpy(a) for key, a in
                  ring.arrays().items()}
        self._slots = [{k: arrays[slot, k] for s, k in specs if s == slot}
                       for slot in range(self._k)]
        self._ring = ring
        self._events = [None] * self._k
        self._registered = None
        if self.device.type == "cuda":
            ptr, size = ring.block.data_ptr(), ring.block.numel()
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                ptr, size, 0))
            self._registered = ptr
            self._events = [torch.cuda.Event() for _ in range(self._k)]
        self._keys = _EpochKeys()
        self._loader = torch.utils.data.DataLoader(
            _Batches(dataset, ring, metadata, patch_size, augment,
                     batch_size, shuffle, pad_mode, multi_date,
                     process_index, process_count, spatial_index,
                     spatial_count),
            batch_size=None, sampler=self._keys, num_workers=num_workers,
            multiprocessing_context=_worker_context(),
            persistent_workers=True, prefetch_factor=prefetch)

    def epoch(self, seed: int = 0, max_batches: int = 0,
              skip_batches: int = 0) -> Iterator[dict]:
        """The epoch shuffled by ``seed`` from batch ``skip_batches``
        (capped at ``max_batches``), as ``batch_iterator`` gives it."""
        if self._n == 0:
            return
        num_batches = -(-self._n // self.batch_size)
        if max_batches:
            num_batches = min(num_batches, max_batches)
        batches = range(skip_batches, num_batches)
        if not batches:
            return
        self._sync()  # a copy of the last epoch may still read a slot
        self._keys.keys = [(seed, b, i % self._k)
                           for i, b in enumerate(batches)]
        it = iter(self._loader)
        for i in range(len(batches)):
            t0 = time.perf_counter()
            if i >= 2:  # the next call hands batch i-2's slot to a worker
                with profiling.span("loader.slot", id=i):
                    self._wait(i - 2)
            with profiling.span("loader.next", id=i):
                slot = next(it)
            profiling.count("loader.wait_s", time.perf_counter() - t0)
            with profiling.span("loader.upload", id=i):
                if self.device.type == "cuda":
                    batch = {k: v.to(self.device, non_blocking=True)
                             for k, v in self._slots[slot].items()}
                    self._events[slot].record()
                else:
                    batch = {k: v.clone()
                             for k, v in self._slots[slot].items()}
            yield batch

    def _wait(self, i: int) -> None:
        event = self._events[i % self._k]
        if event is not None:
            event.synchronize()

    def _sync(self) -> None:
        for i in range(self._k):
            self._wait(i)

    def close(self) -> None:
        """Stop the worker processes and release the ring."""
        it = self._loader._iterator
        if it is not None:
            it._shutdown_workers()
            self._loader._iterator = None
        if self._registered is not None:
            self._sync()
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
                self._registered))
            self._registered = None

    def __enter__(self) -> "BatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
