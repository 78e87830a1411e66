"""Seeded weights, made on the device in a few large draws.

The tree has the layout that ``fabric_tpu_torch.weights`` loads, leaf by
leaf as the model's module lists them (``models/<model>.py`` ``leaves``:
path, shape and kind); ``mean`` and ``var`` go to the statistics, the
rest to the parameters.  The values are the benchmark's inputs: both the
program and the reference take them.
Kernels are normal with variance 1/fan_in; biases, BatchNorm scales,
shifts and running statistics are drawn too, so that folding BatchNorm
into the convs is not the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import manifest


def put(tree: dict, path: tuple, value) -> None:
    """Set the leaf at ``path`` of a nested dict, making its groups."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, batch_stats) trees of float32 tensors on ``device`` for a
    configuration, drawn from ``seed``: one normal draw for every kernel
    and one each for the other kinds of leaf.  The leaves are those that
    the configuration's model module (``models/<model>.py``) lists."""
    leaves = manifest.model(config["model"]).leaves(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = {}
    for _, shape, kind in leaves:
        sizes[kind] = sizes.get(kind, 0) + int(np.prod(shape))
    draws = {kind: torch.randn(n, generator=gen, device=device)
             for kind, n in sorted(sizes.items())}
    used = dict.fromkeys(draws, 0)
    params: dict = {}
    stats: dict = {}
    for path, shape, kind in leaves:
        n = int(np.prod(shape))
        z = draws[kind][used[kind]:used[kind] + n].view(shape)
        used[kind] += n
        if kind == "kernel":
            value = z * (1.0 / np.prod(shape[:-1])) ** 0.5
        elif kind == "bias":
            value = 0.05 * z
        elif kind == "scale":
            value = 1.0 + 0.1 * z
        elif kind == "shift":
            value = 0.1 * z
        elif kind == "mean":
            value = 0.1 * z
        else:  # var
            value = torch.exp(0.2 * z)
        put(stats if kind in ("mean", "var") else params, path, value)
    return params, stats


def flatten(tree: dict, prefix: str = "") -> dict:
    """{dotted path: leaf}, the names of the program's module parameters."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, name + "."))
        else:
            out[name] = value
    return out


def to_host(tree: dict) -> dict:
    """The tree's leaves as float32 numpy arrays (what the program's
    weight loader takes)."""
    return {k: to_host(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy()
            for k, v in tree.items()}
