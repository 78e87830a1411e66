"""Patch sampling, augmentation, batching and device prefetch
(counterpart of ``fabric_tpu/data/pipeline.py``, single process).

- ``PatchSampler`` crops (2, ps, ps, 13) windows from the in-memory
  dataset and augments them (rot90 by k in 0..3, independent H/V flips).
- ``batch_iterator`` yields fixed-shape numpy batches: the shuffled order
  is wrap-padded to whole batches (train) or padded with weight-0 rows
  (eval, ``pad_mode="mask"``).  Each row's augmentation draws come from
  its own RNG keyed by (seed, row position), so ``skip_batches`` can jump
  to batch b and produce it bit-identically (mid-epoch resume).
- ``prefetch_to_device`` assembles batches in a background thread, copies
  them into pinned host memory and starts non-blocking copies to the card,
  ``size`` batches ahead of the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class PatchSampler:
    """Crops + augments patches from the full in-memory dataset dict."""

    def __init__(self, dataset: dict, metadata: list, patch_size: int,
                 augment: bool):
        self.dataset = dataset
        self.metadata = list(metadata)
        self.patch_size = patch_size
        self.augment = augment

    def __len__(self) -> int:
        return len(self.metadata)

    def sample(self, index: int, rng: np.random.RandomState):
        """(img_d1, img_d2, label) of one patch, augmented with draws from
        ``rng``."""
        city, x, y = self.metadata[index]
        s = self.patch_size
        entry = self.dataset[city]
        img = entry["images"][:, x:x + s, y:y + s, :]
        lbl = entry["labels"][x:x + s, y:y + s]
        if self.augment:
            k, flip_h, flip_w = (rng.randint(0, 4), rng.rand() > 0.5,
                                 rng.rand() > 0.5)
            if k:
                img = np.rot90(img, k, axes=(1, 2))
                lbl = np.rot90(lbl, k, axes=(0, 1))
            if flip_h:
                img, lbl = np.flip(img, axis=1), np.flip(lbl, axis=0)
            if flip_w:
                img, lbl = np.flip(img, axis=2), np.flip(lbl, axis=1)
        return img[0], img[1], lbl


def batch_iterator(sampler: PatchSampler, batch_size: int, shuffle: bool,
                   pad_mode: str = "wrap", seed: int = 0,
                   max_batches: int = 0,
                   skip_batches: int = 0) -> Iterator[dict]:
    """Yield {'img1', 'img2', 'label', 'weight'} numpy batches of fixed
    shape; ``max_batches`` caps the epoch, ``skip_batches`` starts at that
    batch without materialising the ones before."""
    n = len(sampler)
    if n == 0:
        return
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    pad = (-n) % batch_size
    weights = np.ones(n + pad, np.float32)
    if pad:
        order = np.concatenate([order, order[:pad]])
        if pad_mode == "mask":
            weights[n:] = 0.0
    num_batches = len(order) // batch_size
    if max_batches:
        num_batches = min(num_batches, max_batches)
    ps, c = sampler.patch_size, sampler.dataset[
        sampler.metadata[0][0]]["images"].shape[-1]
    for b in range(skip_batches, num_batches):
        lo = b * batch_size
        img1 = np.empty((batch_size, ps, ps, c), np.float32)
        img2 = np.empty_like(img1)
        label = np.empty((batch_size, ps, ps), np.int32)
        for row, i in enumerate(order[lo:lo + batch_size]):
            rng = np.random.RandomState(
                (seed * 1_000_003 + lo + row) % (2 ** 31))
            img1[row], img2[row], label[row] = sampler.sample(int(i), rng)
        yield {"img1": img1, "img2": img2, "label": label,
               "weight": weights[lo:lo + batch_size].copy()}


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
        while True:
            item = q.get()
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
