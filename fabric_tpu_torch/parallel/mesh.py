"""The device mesh (counterpart of ``fabric_tpu/parallel/mesh.py``).

``fabric_tpu`` lays a ``jax.sharding.Mesh`` with the axes ("data",
"spatial", "model") over its devices.  The port keeps the axes and the
errors, with a small :class:`Mesh` of its own: an explicit list of
``torch.device``s and a ``shape`` dict.  A device may repeat in the list:
on the CPU every "device" is ``cpu``, and on one card a mesh of n shards
is ``[cuda:0] * n``, which runs the code paths of n cards but does not
divide the memory per card by n.

There is no ``NamedSharding``.  What stands in for it:

- serving (one process, the mesh's devices) puts the data axis over the
  devices of the list: each shard's H-band of a scene
  (``infer/sharded_scene.py``, ``infer/fullconv.make_sharded_fullconv_infer``)
  or its slice of a tile batch (``infer/device_tiling.make_scene_infer``);
  serving replicates the model over the ``spatial`` and ``model`` axes,
  as ``fabric_tpu``'s ``ScenePredictor`` does;
- training and evaluation lay the mesh over the processes of a
  ``torch.distributed`` group, one card each
  (``parallel/distributed.set_mesh``: rank r at (d, s, m), r = (d*S +
  s)*M + m): each rank materialises the rows of its data slice of every
  global batch (``data/pipeline.batch_iterator``'s ``process_index``),
  and of those its S-th of each patch's height (``spatial_index``), as
  ``fabric_tpu``'s ``batch_shardings`` place a batch over ("data",
  "spatial"); the ``model`` axis holds replicas (``fabric_tpu`` places
  nothing over it).  The forward's halo exchanges, which XLA's
  partitioner makes for ``fabric_tpu``, are ``parallel/spatial.py``'s.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

AXES = ("data", "spatial", "model")


class Mesh:
    """``devices`` (data x spatial x model of them, in order) and the axes'
    sizes in ``shape``."""

    def __init__(self, devices, shape: dict[str, int]):
        self.devices = [indexed_device(torch.device(d)) for d in devices]
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        if len(self.devices) != int(np.prod(list(self.shape.values()))):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")

    def data_devices(self) -> list[torch.device]:
        """The first device of each slice of the data axis: shard i's."""
        step = self.shape["spatial"] * self.shape["model"]
        return self.devices[::step]


def indexed_device(device: torch.device) -> torch.device:
    """``device`` with an index: ``cuda`` alone names the current card
    (the rank's own, once ``parallel.distributed.maybe_initialize`` set
    it)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def visible_devices() -> list[torch.device]:
    """The visible cards; raises when there is none (a mesh of CPU
    "devices" is asked for by passing ``devices``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu'] "
                           "* n to lay a mesh over the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(data: int = -1, spatial: int = 1, model: int = 1,
              devices=None) -> Mesh:
    """A (data, spatial, model) mesh over ``devices`` (default: the visible
    cards, raising without one); ``data`` -1 takes all the devices that
    remain."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if data == -1:
        if n % (spatial * model):
            raise ValueError(f"{n} devices not divisible by "
                             f"spatial*model={spatial * model}")
        data = n // (spatial * model)
    total = data * spatial * model
    if total > n:
        raise ValueError(f"mesh {data}x{spatial}x{model} needs {total} "
                         f"devices, have {n}")
    return Mesh(devices[:total], dict(zip(AXES, (data, spatial, model))))


def make_mesh_from_config(cfg, devices=None) -> Mesh:
    return make_mesh(cfg.mesh_data, cfg.mesh_spatial, cfg.mesh_model,
                     devices)


def pad_batch_to_multiple(batch: dict[str, Any],
                          multiple: int) -> dict[str, Any]:
    """Pad the batch axis (with zero weight) so it divides the data axis."""
    n = batch["label"].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, widths)
    if "weight" in out:
        out["weight"][n:] = 0.0
    return out
