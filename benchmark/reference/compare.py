"""The numbers that decide ``correct``, worked out against the reference.

Serving: the widest gap by which a served pixel's class lies below the
reference's best class, in the reference's logits (0 where every served
class is the reference's argmax; a near-tie may flip at the served
precision, by a small gap).

Training: over the first steps of the timed loop,

- ``loss_gap``: the largest |program loss - reference loss| / |reference
  loss| over the steps;
- ``grad_gap``: the first gradient as the optimizer took it (plain SGD:
  (p0 - p1) / lr), leaf by leaf: |norm(program) - norm(reference)| over
  the larger of the reference's norm of that leaf and the median leaf's
  norm, the worst leaf;
- ``change_gap``: the same of each leaf's change over the steps, p_k -
  p0;
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gap.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a conv bias under train-mode BatchNorm: nought in exact
arithmetic, moved by round-off alone) are left out of both leaf gaps.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.nets import Net


@torch.no_grad()
def tiled_logits(net: Net, d1: torch.Tensor, d2: torch.Tensor, patch: int,
                 block: int) -> torch.Tensor:
    """(H, W, classes) reference logits of an (H, W, C) pair served in the
    grid mode: disjoint ``patch`` tiles, each a forward of its own, in
    blocks of ``block`` tiles."""
    h, w, c = d1.shape
    if h % patch or w % patch:
        raise ValueError("the grid reference takes scenes aligned to the "
                         "patch")

    def tiles(d):
        return (d.reshape(h // patch, patch, w // patch, patch, c)
                .permute(0, 2, 1, 3, 4).reshape(-1, patch, patch, c))

    t1, t2 = tiles(d1), tiles(d2)
    out = torch.cat([net({"img1": t1[i:i + block], "img2": t2[i:i + block]})
                     for i in range(0, t1.shape[0], block)])
    k = out.shape[-1]
    return (out.reshape(h // patch, w // patch, patch, patch, k)
            .permute(0, 2, 1, 3, 4).reshape(h, w, k))


def widest_gap(ref_logits: torch.Tensor, classes: torch.Tensor) -> float:
    """max over pixels of (best reference logit - the reference logit of
    the class in ``classes``)."""
    best = ref_logits.max(-1).values
    served = torch.gather(ref_logits, -1, classes.long()[..., None])[..., 0]
    return float((best - served).max())


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def counted_leaves(ref_grad_norms: dict) -> list[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(ref_grad_norms.values())))
    return sorted(k for k, v in ref_grad_norms.items() if v >= 1e-3 * med)


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict:
    """{leaf: |norm prog - norm ref| / max(norm ref, median ref norm)}
    over ``leaves``."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))
