"""The training batches, derived again from the dataset (a frozen copy of
the semantics of the program's batch pipeline, written out from its
documentation and not imported).

The training patches are, per training city in sorted order, the
row-major stride grid of ``patch``-sized windows that fit inside the
city.  Epoch e orders them by ``numpy.random.RandomState(seed +
e).shuffle`` and wraps the order round to whole batches.  Row r of the
epoch draws (k, flip_h, flip_w) from ``RandomState((seed_e * 1000003 +
r) % 2**31)`` as ``randint(0, 4)``, ``rand() > 0.5`` twice, and its patch
is rotated by k quarter turns over (H, W), then flipped in H, then in W,
every date alike.  A bi-date batch holds the first two dates as ``img1``
and ``img2``, a multi-date one every date as ``imgs`` (N, T, p, p, C);
the labels follow the same turns and flips; every row weighs 1.
"""

from __future__ import annotations

import numpy as np


def train_patches(dataset: dict, val_cities, patch: int, stride: int):
    out = []
    for city in sorted(set(dataset) - set(val_cities)):
        h, w = dataset[city]["labels"].shape
        out += [(city, i, j) for i in range(0, h, stride)
                for j in range(0, w, stride)
                if i + patch <= h and j + patch <= w]
    return out


def batch(dataset: dict, patches: list, patch: int, batch_size: int,
          seed: int, step: int, multi_date: bool) -> dict:
    """Global batch ``step`` (counted from the start of the run, across
    epochs) as numpy arrays."""
    n = len(patches)
    per_epoch = -(-n // batch_size)
    epoch, b = divmod(step, per_epoch)
    seed_e = seed + epoch
    order = np.arange(n)
    np.random.RandomState(seed_e).shuffle(order)
    order = np.concatenate([order, order[:(-n) % batch_size]])
    lo = b * batch_size
    imgs, labels = [], []
    for r, i in enumerate(order[lo:lo + batch_size]):
        rng = np.random.RandomState((seed_e * 1_000_003 + lo + r) % (2 ** 31))
        k, fh, fw = rng.randint(0, 4), rng.rand() > 0.5, rng.rand() > 0.5
        city, y, x = patches[int(i)]
        img = dataset[city]["images"][:, y:y + patch, x:x + patch]
        lbl = dataset[city]["labels"][y:y + patch, x:x + patch]
        img, lbl = np.rot90(img, k, axes=(1, 2)), np.rot90(lbl, k)
        if fh:
            img, lbl = img[:, ::-1], lbl[::-1]
        if fw:
            img, lbl = img[:, :, ::-1], lbl[:, ::-1]
        imgs.append(img)
        labels.append(lbl)
    imgs = np.ascontiguousarray(np.stack(imgs), np.float32)
    out = {"label": np.ascontiguousarray(np.stack(labels)).astype(np.int32),
           "weight": np.ones(len(labels), np.float32)}
    if multi_date:
        out["imgs"] = imgs
    else:
        out["img1"], out["img2"] = imgs[:, 0], imgs[:, 1]
    return out
