"""The ``spatial`` mesh axis: each patch's height split over the ranks of
a spatial group.  It has no file counterpart: in ``fabric_tpu``, XLA's
SPMD partitioner does this work, halo exchanges included, once
``parallel/mesh.batch_shardings`` puts H over "spatial".

A train or eval step runs its forward and backward inside
:func:`sharded`, each rank holding ``rows`` = H / S rows of every patch:
rank s of the spatial group (``parallel/distributed.spatial_group``)
holds rows [s H/S, (s+1) H/S).  The U-Net's five levels (inc, down1-4)
halve the rows.  A level stays split while its rows divide by S and,
for the pool into it, each shard's rows above are even (a 2x2 pool of
a shard is then the shard of the pool).  From the first level that
cannot be split, it and every deeper level are gathered: each spatial
rank holds all of their rows, and the decoder takes the rank's rows again
when it climbs back to a split level.  At patch 96, S = 2 splits every
level (48 down to 3 rows a shard); S = 4 gathers the bottleneck (down4's
pool would split 6 rows 4 ways).

The models enter each block's level with :func:`at` (or :func:`use`, for
a :class:`Level` made earlier: a rematerialised stage's recompute), and
the blocks ask :func:`current`:

- a conv of a split level reads k = size // 2 halo rows from each
  neighbour (:func:`halo_rows`: zeros past the global top and bottom, as
  SAME padding) and is VALID in H;
- a lane-packed conv (``ops/s2d_conv.py``, ``lane_pack``) of a split
  level reads the halo rows that extend the rank's rows to whole 2-row
  blocks of the global image (:func:`block_halo`: one row a side for an
  even shard, for an odd one two on the side that starts or ends
  mid-block), is VALID in H and drops an odd shard's extra output row;
  its gate reads the level's global rows (:func:`global_rows`);
- BatchNorm sums over the batch group at a split level, and over the data
  group at a gathered one, where the S spatial ranks hold the same rows
  (:func:`stats_group`);
- a Down block into a gathered level gathers its input first
  (:func:`pool_input`);
- an Up block from a split level computes its rows of the global
  upsample from its rows and a 1-row halo (:meth:`Level.upsample2x`);
  from a gathered level into a split one, the whole upsample, then its
  rows (:meth:`Level.local_rows`).

The collectives are sums over the spatial group (``all_reduce``), the one
collective that gloo runs on CUDA tensors as NCCL does, so one code path
serves several ranks on one card and one rank a card: each rank writes
its rows into its slot of a zeroed buffer, and the sum hands every rank
every slot.  A halo's backward returns each halo row's gradient to its
owner, which adds it to its own; a gather's backward sums the S ranks'
gradients of the gathered rows (each holds the share that flows through
its own rows downstream) and keeps the rank's rows.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from fabric_tpu_torch.ops.resize import (upsample2x_align_corners_rows,
                                        upsample2x_local)
from fabric_tpu_torch.parallel import distributed

LEVELS = 5  # inc, down1-4

_sharding = None  # the Sharding of the step being run
_current = None  # the Level of the block being run


def split_levels(height: int, count: int) -> list[bool]:
    """Whether each level's rows are split over ``count`` ranks, for
    patches of ``height`` rows: the first while the height divides, each
    next one while the shards above have even rows."""
    if height % count:
        raise ValueError(f"patch height {height} does not split over the "
                         f"{count} ranks of the spatial axis")
    rows, split = height // count, [True]
    for _ in range(1, LEVELS):
        split.append(split[-1] and rows % 2 == 0)
        rows //= 2
    return split


class Sharding:
    """The split of one step's patches of ``height`` rows: ``count`` (S)
    ranks in the spatial ``group``, this rank's ``index`` (s), and
    ``split[l]`` for each level."""

    def __init__(self, height: int):
        self.group = distributed.spatial_group()
        self.count = self.group.size
        self.index = distributed.coords()[1]
        self.split = split_levels(height, self.count)


class _Halo(torch.autograd.Function):
    """x with k rows of each neighbour along ``axis`` (zeros past the
    group's first and last ranks)."""

    @staticmethod
    def forward(ctx, x, k, axis, pg, index, count):
        h = x.shape[axis]
        if h < k:
            raise ValueError(f"a halo of {k} rows needs at least {k} rows a "
                             f"shard, have {h}")
        ctx.args = (k, axis, pg, index, count, h)
        ends = torch.stack([x.narrow(axis, 0, k), x.narrow(axis, h - k, k)])
        buf = x.new_zeros((count,) + ends.shape)
        buf[index] = ends
        dist.all_reduce(buf, group=pg)
        zeros = torch.zeros_like(ends[0])
        above = buf[index - 1, 1] if index > 0 else zeros
        below = buf[index + 1, 0] if index < count - 1 else zeros
        return torch.cat([above, x, below], axis)

    @staticmethod
    def backward(ctx, g):
        k, axis, pg, index, count, h = ctx.args
        buf = g.new_zeros((count, 2) + g.narrow(axis, 0, k).shape)
        if index > 0:  # the rank above's last k rows
            buf[index - 1, 1] = g.narrow(axis, 0, k)
        if index < count - 1:  # the rank below's first k rows
            buf[index + 1, 0] = g.narrow(axis, k + h, k)
        dist.all_reduce(buf, group=pg)
        gx = g.narrow(axis, k, h).clone()
        gx.narrow(axis, 0, k).add_(buf[index, 0])
        gx.narrow(axis, h - k, k).add_(buf[index, 1])
        return gx, None, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """The rows of every rank of the group, in rank order along ``axis``."""

    @staticmethod
    def forward(ctx, x, axis, pg, index, count):
        ctx.args = (axis, pg, index, x.shape[axis])
        buf = x.new_zeros((count,) + x.shape)
        buf[index] = x
        dist.all_reduce(buf, group=pg)
        return torch.cat(buf.unbind(0), axis)

    @staticmethod
    def backward(ctx, g):
        axis, pg, index, h = ctx.args
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=pg)
        return g.narrow(axis, index * h, h), None, None, None, None


class Level:
    """A block's place in the split: whether its level's rows are
    ``split`` or gathered, and whether the rows it reads are
    (``input_split``: the level above a Down block's, below an Up
    block's)."""

    def __init__(self, sharding: Sharding, split: bool, input_split: bool):
        self.sharding = sharding
        self.split = split
        self.input_split = input_split

    @property
    def count(self) -> int:
        return self.sharding.count

    @property
    def index(self) -> int:
        return self.sharding.index

    def halo(self, x: torch.Tensor, k: int, axis: int = 1) -> torch.Tensor:
        """x with k rows of each neighbour's along ``axis``."""
        return _Halo.apply(x, k, axis, self.sharding.group.pg, self.index,
                           self.count)

    def local_rows(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This rank's rows of a gathered x."""
        h = x.shape[axis] // self.count
        return x.narrow(axis, self.index * h, h)

    def upsample2x(self, x: torch.Tensor, local: bool) -> torch.Tensor:
        """This rank's rows of the 2x upsample (``local``: the
        shift-invariant one; else align-corners) of the split image whose
        rows x are."""
        ext = self.halo(x, 1)
        if local:
            after = ext[:, -1:]
            if self.index == self.count - 1:
                # the edge clamp; the halo's zero row joins it exactly, so
                # that this rank's backward runs the halo's collective as
                # every other rank's does
                after = after + x[:, -1:]
            return upsample2x_local(x, after)
        h = x.shape[1]
        return upsample2x_align_corners_rows(ext, self.index * h,
                                             h * self.count)


@contextlib.contextmanager
def sharded(rows: int):
    """Split the forwards and backwards run inside over the spatial group,
    each rank holding ``rows`` rows of every patch.  A no-op without a
    spatial axis."""
    global _sharding
    count = distributed.spatial_group().size
    if count == 1:
        yield
        return
    prev, _sharding = _sharding, Sharding(rows * count)
    try:
        yield
    finally:
        _sharding = prev


def level(index: int, source: int | None = None) -> Level | None:
    """The :class:`Level` of a block at level ``index`` that reads the
    rows of level ``source`` (default: its own); None outside
    :func:`sharded`."""
    sh = _sharding
    if sh is None:
        return None
    return Level(sh, sh.split[index],
                 sh.split[index if source is None else source])


@contextlib.contextmanager
def use(lv: Level | None):
    """Make ``lv`` the :func:`current` level inside."""
    global _current
    prev, _current = _current, lv
    try:
        yield
    finally:
        _current = prev


def at(index: int, source: int | None = None):
    """``use(level(index, source))``."""
    return use(level(index, source))


def current() -> Level | None:
    """The level of the block being run (None when nothing is split)."""
    return _current


def gather_rows(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Every spatial rank's rows of x, in rank order along ``axis`` (x
    itself without a spatial axis)."""
    group = distributed.spatial_group()
    if not group.collective:
        return x
    return _GatherRows.apply(x, axis, group.pg, distributed.coords()[1],
                             group.size)


def halo_rows(x: torch.Tensor, k: int, axis: int = 1
              ) -> tuple[torch.Tensor, int]:
    """(x, padding) for a SAME conv of radius k along ``axis``: x and k,
    or on a split level x with k halo rows each side and 0 (VALID)."""
    lv = _current
    if lv is None or not lv.split or k == 0:
        return x, k
    return lv.halo(x, k, axis), 0


def block_halo(x: torch.Tensor, axis: int = 1
               ) -> tuple[torch.Tensor, int | None]:
    """(x, None), or on a split level (ext, first) for a conv of whole
    shifted space-to-depth blocks (global rows 2j - 1, 2j), VALID in H:
    ext is the rank's rows [r0, r0 + h) with the halo rows that complete
    their blocks, global rows [r0 - 1 - r0 % 2, r0 + h + 1 + (r0 + h) % 2)
    (zeros past the image's top and bottom, as the s2d's padding), and
    ``first`` = r0 % 2 is the rank's first row in the conv's output.  An
    even shard takes a 1-row halo; an odd one a 2-row halo, cut to its
    blocks (every rank runs the same collective)."""
    lv = _current
    if lv is None or not lv.split:
        return x, None
    h = x.shape[axis]
    if h % 2 == 0:
        return lv.halo(x, 1, axis), 0
    r0 = lv.index * h
    lo, hi = 1 - r0 % 2, 1 - (r0 + h) % 2  # halo rows left out
    return lv.halo(x, 2, axis).narrow(axis, lo, h + 4 - lo - hi), r0 % 2


def global_rows(h: int) -> int:
    """The rows of the current level's whole image, of which the rank
    holds h."""
    lv = _current
    return h * lv.count if lv is not None and lv.split else h


def pool_input(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The rows a pool into the current level reads: x, gathered when the
    level is not split but x's is."""
    lv = _current
    if lv is not None and lv.input_split and not lv.split:
        return gather_rows(x, axis)
    return x


def stats_group() -> distributed.Group:
    """The ranks whose rows a BatchNorm of the current level sums: the
    data group where every spatial rank holds the level's rows, else the
    batch group."""
    lv = _current
    if lv is not None and not lv.split:
        return distributed.data_group()
    return distributed.batch_group()
