"""Mesh-sharded whole-scene inference: the scene itself is distributed
(counterpart of ``fabric_tpu/infer/sharded_scene.py``).

``infer/device_tiling.make_scene_infer`` keeps the whole scene on one
device.  Here the scene is split into H-bands over the mesh's ``data``
axis (``parallel/mesh.py``: the devices of one process), and each shard
tiles, predicts and stitches only its own band, on its own device, with
its own replica of the model (one replica per distinct device): memory
per device is one band, and the shards do not communicate (the bands
align with the tile grid, and grid tiles are independent).  Every shard's
work is launched before any result is read back, so that separate cards
overlap; the host concatenates the bands into the (H, W) uint8 mask.

Constraints, as in ``fabric_tpu``: grid mode only, ``H % (n * patch) ==
0`` and ``W % patch == 0`` (the bucketed serving path guarantees them).
On one card a mesh of n shards (``[cuda:0] * n``) runs the same code
paths, but its memory is not divided by n.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from fabric_tpu_torch.infer.device_tiling import make_scene_infer


def replicas(model, devices) -> dict[torch.device, object]:
    """{device: ``model`` on it} for each distinct device: the model itself
    where it lives, elsewhere a copy (a module) or the forward rebuilt
    there (an int8 forward's ``replicate``).  A dict passes through."""
    if isinstance(model, dict):
        return model
    out = {}
    for d in dict.fromkeys(torch.device(x) for x in devices):
        if isinstance(model, torch.nn.Module):
            here = next(model.parameters()).device
            out[d] = model if here == d else copy.deepcopy(model).to(d)
        else:
            out[d] = model if model.device == d else model.replicate(d)
    return out


def put_scene_sharded(scene, mesh, dtype: torch.dtype | None = None
                      ) -> list[torch.Tensor]:
    """A host (H, W, C) scene (ndarray, ``np.memmap`` or tensor) as its n
    H-bands, band i on shard i's device: each band is sliced out of
    ``scene``, cast to ``dtype`` on the host and uploaded before the next
    is read, so that neither the host nor a device holds more than one
    band beyond ``scene`` itself (a memmap streams from disk)."""
    devices = mesh.data_devices()
    n, h = len(devices), scene.shape[0]
    if h % n:
        raise ValueError(f"H={h} must divide over the {n}-device data axis")
    band = h // n
    out = []
    for i, dev in enumerate(devices):
        b = scene[i * band:(i + 1) * band]
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(b))
        if dtype is not None:
            t = t.to(dtype)
        out.append(t.to(dev))
    return out


def as_bands(scene, mesh, dtype: torch.dtype) -> list[torch.Tensor]:
    """``scene`` as its bands on the shards' devices: a list made by
    :func:`put_scene_sharded` as it is, anything else placed by it."""
    if isinstance(scene, (list, tuple)):
        if len(scene) != mesh.shape["data"]:
            raise ValueError(f"{len(scene)} bands for a data axis of "
                             f"{mesh.shape['data']}")
        return [b.to(dtype) for b in scene]
    return put_scene_sharded(scene, mesh, dtype)


def gather_bands(bands: list[torch.Tensor]) -> torch.Tensor:
    """The shards' (band, W) masks read back into one host (H, W) tensor,
    in shard order (the reads wait; every launch came before them)."""
    rows = bands[0].shape[0]
    out = torch.empty((rows * len(bands),) + tuple(bands[0].shape[1:]),
                      dtype=bands[0].dtype)
    for i, b in enumerate(bands):
        out[i * rows:(i + 1) * rows].copy_(b)
    return out


def make_sharded_scene_infer(model, patch: int, scene_shape: tuple[int, int],
                             mesh, batch_size: int = 256,
                             dtype: torch.dtype = torch.bfloat16):
    """Build ``run(scene1, scene2) -> (H, W) uint8`` (a host tensor) with
    the scenes H-banded over ``mesh``'s ``data`` axis.  ``model`` is the
    serving forward (a folded model or an int8 forward) or a
    :func:`replicas` dict; the scenes are :func:`put_scene_sharded` band
    lists or whole (H, W, C) arrays."""
    h, w = scene_shape
    n = mesh.shape["data"]
    if h % (n * patch):
        raise ValueError(
            f"H={h} must divide into {n} patch-aligned bands "
            f"(H % (n_data*patch={n * patch}) == 0); pad the scene "
            "or use make_scene_infer")
    if w % patch:
        raise ValueError(f"W={w} must be a multiple of patch={patch}")
    band = h // n
    k = (band // patch) * (w // patch)
    devices = mesh.data_devices()
    runs = {d: make_scene_infer(f, patch, (band, w),
                                batch_size=min(batch_size, k), dtype=dtype)
            for d, f in replicas(model, devices).items()}

    def run(scene1, scene2) -> torch.Tensor:
        b1, b2 = (as_bands(s, mesh, dtype) for s in (scene1, scene2))
        return gather_bands([runs[d](s1, s2)
                             for d, s1, s2 in zip(devices, b1, b2)])

    return run
