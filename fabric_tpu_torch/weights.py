"""Weight bridge: ``fabric_tpu`` variable trees <-> the port's modules.

A ``fabric_tpu`` model is described by two nested dicts of numpy arrays,
``params`` and ``batch_stats`` (as a checkpoint stores them).  A
BiDateNet's tree is ``inc`` and ``down1-4/conv``, ``up1-4/conv`` (each
with ``conv1`` / ``conv2`` holding an HWIO ``kernel`` and a ``bias``, and
``bn1`` / ``bn2`` holding ``scale`` / ``bias`` in params and ``mean`` /
``var`` in batch_stats), plus ``outc/conv``.  This is the layout
``fabric_tpu/tools/import_torch.py`` builds from a torch state_dict.  The
multi-date families keep it and differ where their modules do: UNetLSTM
adds ``bottleneck_lstm/gates`` (an HWIO (3, 3, 16b, 32b) kernel and its
bias, no BatchNorm); UNet3D's encoder blocks sit at ``inc`` and
``down1-4`` with no ``conv`` wrapper and DHWIO (3, 3, 3, cin, cout)
kernels.  The map below runs onto the port's module names (which keep the
flax names, joined with dots), either BatchNorm-folded or with
BatchNorm; :func:`variables_of` reads a module back into such a tree
(checkpoints, tests).
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch.ops.fold_bn import fold_tree

LEVELS = ("inc", "down1", "down2", "down3", "down4",
          "up1", "up2", "up3", "up4")


def block_channels(n_channels: int, base: int) -> dict[str, tuple[int, int]]:
    """(cin, cout) of each DoubleConv block of a BiDateNet."""
    b = base
    return {"inc": (n_channels, b), "down1": (b, 2 * b),
            "down2": (2 * b, 4 * b), "down3": (4 * b, 8 * b),
            "down4": (8 * b, 8 * b), "up1": (16 * b, 4 * b),
            "up2": (8 * b, 2 * b), "up3": (4 * b, b), "up4": (2 * b, b)}


def init_variables(n_channels: int, n_classes: int, base: int,
                   generator: torch.Generator,
                   model: str = "bidate") -> tuple[dict, dict]:
    """Fresh (params, batch_stats) of a ``model`` ("bidate", "unet_lstm"
    or "unet3d") with ``fabric_tpu``'s initialisers: lecun-normal conv
    kernels (truncated normal, variance 1/fan_in), zero biases, BatchNorm
    scale 1 and bias 0, running mean 0 and var 1."""
    if model not in ("bidate", "unet_lstm", "unet3d"):
        raise ValueError(f"unknown model: {model!r}")
    def lecun(shape):
        fan_in = int(np.prod(shape[:-1]))
        std = (1.0 / fan_in) ** 0.5 / .87962566103423978
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return t.numpy()

    def conv(cin, cout, size=3, rank=2):
        return {"kernel": lecun((size,) * rank + (cin, cout)),
                "bias": np.zeros(cout, np.float32)}

    params: dict = {}
    stats: dict = {}
    for level, (cin, cout) in block_channels(n_channels, base).items():
        # UNet3D's encoder blocks are 3-D and not wrapped in "conv"
        enc3d = model == "unet3d" and not level.startswith("up")
        rank = 3 if enc3d else 2
        p = {"conv1": conv(cin, cout, rank=rank),
             "conv2": conv(cout, cout, rank=rank)}
        s = {}
        for bn in ("bn1", "bn2"):
            p[bn] = {"scale": np.ones(cout, np.float32),
                     "bias": np.zeros(cout, np.float32)}
            s[bn] = {"mean": np.zeros(cout, np.float32),
                     "var": np.ones(cout, np.float32)}
        if level != "inc" and not enc3d:
            # Down/Up levels wrap their DoubleConv in "conv"
            p, s = {"conv": p}, {"conv": s}
        params[level], stats[level] = p, s
        if model == "unet_lstm" and level == "down4":
            params["bottleneck_lstm"] = {"gates": conv(16 * base, 32 * base)}
    params["outc"] = {"conv": conv(base, n_classes, size=1)}
    return params, stats


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict's leaves under their dotted paths."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def state_dict(params: dict, batch_stats: dict,
               fold_bn: bool) -> dict[str, np.ndarray]:
    """The port's module state for a ``fabric_tpu`` variable tree: every
    leaf under its dotted flax path; with ``fold_bn`` the BatchNorm pairs
    are first folded into their convs (``ops/fold_bn.py``)."""
    if fold_bn:
        return flatten_tree(fold_tree(params, batch_stats))
    return {**flatten_tree(params), **flatten_tree(batch_stats)}


def load_variables(model: torch.nn.Module, params: dict,
                   batch_stats: dict) -> None:
    """Copy a ``fabric_tpu`` variable tree into ``model`` (folded or not,
    as the model was built), checking that names and shapes agree."""
    fold_bn = getattr(model, "fold_bn", True)
    _load_state(model, state_dict(params, batch_stats, fold_bn),
                f"variables (fold_bn={fold_bn})")


def load_folded(model: torch.nn.Module, folded: dict) -> None:
    """Copy an already BatchNorm-folded params tree (a serving bundle's,
    ``fabric_tpu``'s ``fold_batchnorm`` layout) into a folded ``model``,
    as it is: no second fold."""
    if not getattr(model, "fold_bn", True):
        raise ValueError("a folded params tree loads into a model built "
                         "with fold_bn=True")
    _load_state(model, flatten_tree(folded), "the folded params")


def _load_state(model: torch.nn.Module, state: dict, what: str) -> None:
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    bad = sorted(k for k in set(want) & set(state)
                 if tuple(want[k].shape) != state[k].shape)
    if missing or extra or bad:
        raise ValueError(
            f"{what} do not match the model: "
            f"missing {missing[:5]}, unexpected {extra[:5]}, shape "
            + ", ".join(f"{k} {state[k].shape} vs {tuple(want[k].shape)}"
                        for k in bad[:5]))
    model.load_state_dict({k: torch.from_numpy(
        np.array(v, np.float32)) for k, v in state.items()})


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`flatten_tree`."""
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def variables_of(model: torch.nn.Module) -> tuple[dict, dict]:
    """``(params, batch_stats)`` numpy trees of ``model``, in
    ``fabric_tpu``'s layout: its parameters and its BatchNorm buffers."""
    def host(t):
        return t.detach().cpu().numpy().copy()
    return (unflatten_tree({n: host(p) for n, p in
                            model.named_parameters()}),
            unflatten_tree({n: host(b) for n, b in model.named_buffers()}))
