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
- training puts the data axis over the processes of a
  ``torch.distributed`` group, one card each (``parallel/distributed.py``):
  each rank materialises its own row slice of every global batch
  (``data/pipeline.batch_iterator``'s ``process_index``).

Only the data axis is ported; ``spatial`` and ``model`` above 1 wait for
ROADMAP.md queue 1 item 10c.
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
    """The visible cards, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ([torch.device("cuda", i) for i in range(n)]
            or [torch.device("cpu")])


def make_mesh(data: int = -1, spatial: int = 1, model: int = 1,
              devices=None) -> Mesh:
    """A (data, spatial, model) mesh over ``devices`` (default: the visible
    cards); ``data`` -1 takes all the devices that remain."""
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
