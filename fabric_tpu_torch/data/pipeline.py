"""Patch sampling, augmentation, batching and device prefetch
(counterpart of ``fabric_tpu/data/pipeline.py``).

- ``PatchSampler`` crops (T, ps, ps, 13) windows from the in-memory
  dataset and augments them (rot90 by k in 0..3, independent H/V flips,
  on the spatial axes of every date alike); a bi-date sampler hands out
  the first two dates, a ``multi_date`` one the whole stack.
  With ``compat_aug_stream`` (a ``random.Random``) the augmentation draws
  come from that one sequential stream in the reference's order
  (``randint(0, 3)``, then two ``random() > 0.5``), as
  ``compat_reference`` training takes them.
- ``batch_iterator`` yields fixed-shape numpy batches ({'img1', 'img2',
  'label', 'weight'}, or with ``multi_date`` {'imgs', 'label', 'weight'}
  with ``imgs`` (B, T, ps, ps, C)): the shuffled order
  is wrap-padded to whole batches (train) or padded with weight-0 rows
  (eval, ``pad_mode="mask"``); with ``ragged_tail`` the last batch is
  short instead (the reference's ``drop_last=False``).  Each row's
  augmentation draws come from its own RNG keyed by (seed, row position),
  so ``skip_batches`` can jump to batch b and produce it bit-identically
  (mid-epoch resume); a compat stream is fast-forwarded past the skipped
  rows instead (``replay_aug_draws``).  Batch b is
  ``make_batch(sampler, plan_epoch(...), b)``, which is also what the
  worker processes of ``data/loader.py`` call.  ``batch_size`` is the
  global batch: with ``process_count`` ranks (data-parallel training),
  each derives the same global order from the seed and materialises only
  its own ``batch_size / process_count`` rows, whose augmentation is
  keyed by the global row, so the ranks' rows concatenate to the
  1-process batch byte for byte.  On a mesh's spatial axis a rank keeps
  its ``spatial_index``-th of ``spatial_count`` slices of each patch's
  height, cut on the host after the augmentation: the same rows of the
  unsharded batch (the ranks of one data slice draw the same patches).
- ``prefetch_to_device`` assembles batches in a background thread, copies
  them into pinned host memory and starts non-blocking copies to the card,
  ``size`` batches ahead of the consumer.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from fabric_tpu_torch.utils import profiling


class PatchSampler:
    """Crops + augments patches from the full in-memory dataset dict."""

    def __init__(self, dataset: dict, metadata: list, patch_size: int,
                 augment: bool, compat_aug_stream=None,
                 multi_date: bool = False):
        self.dataset = dataset
        self.metadata = list(metadata)
        self.patch_size = patch_size
        self.augment = augment
        self.compat_aug_stream = compat_aug_stream
        self.multi_date = multi_date

    def __len__(self) -> int:
        return len(self.metadata)

    def _aug_decisions(self, rng: np.random.RandomState):
        """(k, flip_h, flip_w): from the compat stream when there is one
        (``rng`` is then unused), else from ``rng``."""
        st = self.compat_aug_stream
        if st is not None:
            return st.randint(0, 3), st.random() > 0.5, st.random() > 0.5
        return rng.randint(0, 4), rng.rand() > 0.5, rng.rand() > 0.5

    def sample(self, index: int, rng: np.random.RandomState):
        """(img_d1, img_d2, label) of one patch, or with ``multi_date``
        (imgs (T, ps, ps, C), label), augmented with draws from ``rng`` (or
        the compat stream)."""
        city, x, y = self.metadata[index]
        s = self.patch_size
        entry = self.dataset[city]
        img = entry["images"][:, x:x + s, y:y + s, :]
        lbl = entry["labels"][x:x + s, y:y + s]
        if self.augment:
            k, flip_h, flip_w = self._aug_decisions(rng)
            if k:
                img = np.rot90(img, k, axes=(1, 2))
                lbl = np.rot90(lbl, k, axes=(0, 1))
            if flip_h:
                img, lbl = np.flip(img, axis=1), np.flip(lbl, axis=0)
            if flip_w:
                img, lbl = np.flip(img, axis=2), np.flip(lbl, axis=1)
        if self.multi_date:
            return img, lbl
        return img[0], img[1], lbl


class EpochPlan(NamedTuple):
    """One epoch's row order (padding included), row weights and batch
    count: a pure function of the sample count and the seed."""
    order: np.ndarray
    weights: np.ndarray
    batch_size: int
    seed: int
    num_batches: int


def plan_epoch(n: int, batch_size: int, shuffle: bool,
               pad_mode: str = "wrap", seed: int = 0, max_batches: int = 0,
               ragged_tail: bool = False) -> EpochPlan:
    """The order of ``n`` samples for one epoch: shuffled by
    ``RandomState(seed)``, then wrap-padded to whole batches (weight 1,
    or 0 under ``pad_mode="mask"``), or left ragged with ``ragged_tail``;
    ``max_batches`` caps the batch count."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    pad = 0 if ragged_tail else (-n) % batch_size
    weights = np.ones(n + pad, np.float32)
    if pad:
        order = np.concatenate([order, order[:pad]])
        if pad_mode == "mask":
            weights[n:] = 0.0
    num_batches = -(-len(order) // batch_size)
    if max_batches:
        num_batches = min(num_batches, max_batches)
    return EpochPlan(order, weights, batch_size, seed, num_batches)


def height_slice(patch_size: int, spatial_index: int,
                  spatial_count: int) -> slice:
    """The rows of a patch that spatial rank ``spatial_index`` of
    ``spatial_count`` holds."""
    if patch_size % spatial_count:
        raise ValueError(f"patch_size {patch_size} does not split over the "
                         f"{spatial_count} ranks of the spatial axis")
    h = patch_size // spatial_count
    return slice(spatial_index * h, (spatial_index + 1) * h)


def make_batch(sampler: PatchSampler, plan: EpochPlan, b: int,
               out: dict | None = None, process_index: int = 0,
               process_count: int = 1, spatial_index: int = 0,
               spatial_count: int = 1) -> dict:
    """Batch ``b`` of ``plan`` as {'img1', 'img2', 'label', 'weight'}
    numpy arrays ({'imgs', 'label', 'weight'} for a ``multi_date``
    sampler), written into ``out``'s arrays when given (a full batch's
    shapes); row r draws its augmentation from an RNG keyed by (seed, lo +
    r), so the batch does not depend on the ones before.  With
    ``process_count`` > 1 only rank ``process_index``'s slice of the
    global batch, its ``batch_size / process_count`` rows in order (the
    RNG keys stay those of the rows' global positions); with
    ``spatial_count`` > 1 only the ``spatial_index``-th slice of each
    patch's height, cut after the augmentation."""
    full_lo = b * plan.batch_size
    local = min(plan.batch_size,
                len(plan.order) - full_lo) // process_count
    lo = full_lo + process_index * local
    rows = plan.order[lo:lo + local]
    cut = height_slice(sampler.patch_size, spatial_index, spatial_count)
    if out is None:
        shape = sampler.dataset[sampler.metadata[0][0]]["images"].shape
        out = {k: np.empty(s, dtype) for k, (dtype, s) in batch_shapes(
            len(rows), sampler.patch_size, shape[0], shape[-1],
            sampler.multi_date, cut.stop - cut.start).items()}
    keys = ("imgs",) if sampler.multi_date else ("img1", "img2")
    for row, i in enumerate(rows):
        rng = np.random.RandomState(
            (plan.seed * 1_000_003 + lo + row) % (2 ** 31))
        *imgs, label = sampler.sample(int(i), rng)
        for k, img in zip(keys, imgs):
            out[k][row] = img[..., cut, :, :]
        out["label"][row] = label[cut]
    out["weight"][:] = plan.weights[lo:lo + len(rows)]
    return out


def batch_shapes(n: int, patch_size: int, dates: int, channels: int,
                 multi_date: bool, rows: int | None = None) -> dict:
    """{key: (dtype, shape)} of an ``n``-row batch of patches cut from
    (dates, H, W, channels) images: ``imgs`` (n, dates, rows, ps, C) for a
    multi-date model, else ``img1`` / ``img2`` (n, rows, ps, C); ``rows``
    of each patch's height (default: all ``ps``)."""
    ps = patch_size
    h = ps if rows is None else rows
    if multi_date:
        images = {"imgs": (n, dates, h, ps, channels)}
    else:
        images = {k: (n, h, ps, channels) for k in ("img1", "img2")}
    return {**{k: (np.float32, s) for k, s in images.items()},
            "label": (np.int32, (n, h, ps)),
            "weight": (np.float32, (n,))}


def batch_iterator(sampler: PatchSampler, batch_size: int, shuffle: bool,
                   pad_mode: str = "wrap", seed: int = 0,
                   max_batches: int = 0, skip_batches: int = 0,
                   ragged_tail: bool = False, process_index: int = 0,
                   process_count: int = 1, spatial_index: int = 0,
                   spatial_count: int = 1) -> Iterator[dict]:
    """Yield {'img1', 'img2', 'label', 'weight'} (or with a
    ``multi_date`` sampler {'imgs', 'label', 'weight'}) numpy batches of
    fixed shape (the last one short with ``ragged_tail``);
    ``max_batches`` caps the epoch, ``skip_batches`` starts at that batch
    without materialising the ones before; ``process_index`` of
    ``process_count`` takes that rank's rows of each global batch, and
    ``spatial_index`` of ``spatial_count`` its slice of each patch's
    height."""
    n = len(sampler)
    if n == 0:
        return
    if batch_size % process_count:
        raise ValueError(f"global batch_size {batch_size} not divisible by "
                         f"process_count {process_count}")
    if ragged_tail and process_count != 1:
        raise ValueError("ragged_tail emits a final batch of "
                         "len(sampler) % batch_size rows; it does not "
                         "shard across processes")
    stream = sampler.compat_aug_stream
    if stream is not None and sampler.augment:
        if process_count != 1:
            raise ValueError(
                "compat_aug_stream consumes one sequential python-random "
                "stream (the reference's aug semantics): single-process "
                "only; use the default keyed-RNG augmentation for "
                "multi-process runs")
        if (n % batch_size and not ragged_tail
                and not (max_batches and max_batches <= n // batch_size)):
            # padded rows would draw (randint, random, random) triples
            # that the reference's ragged final batch never draws, and
            # every later decision would shift
            raise ValueError(
                f"compat_aug_stream with {n} samples % batch_size "
                f"{batch_size} != 0 requires ragged_tail=True: padded "
                f"rows would desynchronize the sequential augmentation "
                f"stream from the reference's ragged final batch")
        if skip_batches:
            # each skipped row drew one triple; only the last batch can be
            # short, so the replay stops at the epoch's real row count
            replay_aug_draws(stream, min(skip_batches * batch_size, n)
                             if ragged_tail else skip_batches * batch_size)
    plan = plan_epoch(n, batch_size, shuffle, pad_mode, seed, max_batches,
                      ragged_tail)
    for b in range(skip_batches, plan.num_batches):
        yield make_batch(sampler, plan, b, process_index=process_index,
                         process_count=process_count,
                         spatial_index=spatial_index,
                         spatial_count=spatial_count)


def replay_aug_draws(stream, rows: int) -> None:
    """Fast-forward a compat augmentation stream past ``rows`` samples by
    drawing what each drew (a randint and two randoms: the same Mersenne
    Twister words, which a count of skipped values would not consume)."""
    for _ in range(rows):
        stream.randint(0, 3)
        stream.random()
        stream.random()


def epoch_train_rows(n_samples: int, batch_size: int, max_batches: int = 0,
                     ragged_tail: bool = False) -> int:
    """Rows one epoch of ``batch_iterator`` materialises (padding
    included; a whole ragged epoch is exactly ``n_samples``): how far the
    compat stream advances per completed epoch."""
    nb = -(-n_samples // batch_size)
    if ragged_tail and not (max_batches and max_batches < nb):
        return n_samples  # no cap stops the epoch before its short tail
    if max_batches:
        nb = min(nb, max_batches)
    return nb * batch_size


def prefetch_to_device(iterator: Iterator[dict], device, size: int = 2
                       ) -> Iterator[dict]:
    """Batches of torch tensors on ``device``, prepared ``size`` ahead by a
    background thread (pinned host buffers, non-blocking copies to a CUDA
    device); ``size <= 0`` prepares each batch when it is asked for."""
    device = torch.device(device)

    def put(item):
        out = {}
        for k, v in item.items():
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out

    if size <= 0:
        for item in iterator:
            yield put(item)
        return
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(put(item))
        except BaseException as e:  # handed to the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True,
                              name="fabric-prefetch")
    thread.start()
    try:
        for i in itertools.count():
            t0 = time.perf_counter()
            with profiling.span("loader.next", id=i):
                item = q.get()
            profiling.count("loader.wait_s", time.perf_counter() - t0)
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on put()
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
