"""Process groups for training over a (data, spatial, model) mesh of
ranks, and the collectives the port's global-batch quantities use
(counterpart of ``fabric_tpu/parallel/distributed.py``).

A single process is a no-op.  A multi-process run joins a
``torch.distributed`` process group from its environment, either the
``fabric_tpu`` variables

  FABRIC_COORDINATOR=host:port FABRIC_NUM_PROCESSES=N FABRIC_PROCESS_ID=K

or what ``torchrun`` sets (``WORLD_SIZE`` > 1, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``), which plays the part of a TPU slice's
``TPU_WORKER_HOSTNAMES``.  The backend is NCCL when the process's device
is CUDA (rank r on ``cuda:{local_rank}``) and gloo on the CPU.

Under ``fabric_tpu``'s jit SPMD, batch statistics and losses are global
by construction.  Here each rank holds its own rows, so every global
quantity is built from sums: :func:`all_reduce_sum` carries its gradient
(the backward all-reduces it too), so a loss or a BatchNorm built on
all-reduced sums has the 1-process value on every rank, and the mean of
the ranks' parameter gradients (:func:`mean_gradients`) is the
1-process gradient.  These run whenever a process group exists
(:func:`active`), at any world size.

:func:`set_mesh` lays a (data, spatial, model) mesh over the ranks, rank
r at (d, s, m) with r = (d*S + s)*M + m, as ``fabric_tpu``'s mesh orders
its devices.  The ranks of one ``model`` index hold the whole batch
between them (``fabric_tpu`` places nothing over ``model``: it is
replication), so a global sum runs over the :func:`batch_group`, the
data x spatial ranks of the rank's model index, and never counts a row M
times; the :func:`spatial_group` (the spatial ranks of one (d, m)) trades
halo rows and gathers rows (``parallel/spatial.py``); the
:func:`data_group` (the data ranks of one (s, m)) sums the statistics of a
level whose rows every spatial rank holds.  Without :func:`set_mesh` the
mesh is (world size, 1, 1).
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

log = logging.getLogger("fabric_tpu_torch")

_host_group = None
_mesh = None  # the _Mesh that set_mesh laid over the process group

SELF = "self"  # the process group of a rank alone: no collective


class Group(NamedTuple):
    """Ranks a collective sums over: ``size`` of them, ``pg`` their
    process group (None: the default group; :data:`SELF`: this rank alone,
    which needs no collective)."""
    size: int
    pg: object = None

    @property
    def collective(self) -> bool:
        """True when a sum over the group runs a collective."""
        return self.pg is not SELF and active()


class _Mesh(NamedTuple):
    shape: tuple[int, int, int]
    coords: tuple[int, int, int]
    spatial: Group
    batch: Group
    data: Group


def active() -> bool:
    """True while a process group exists."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, trackers and figures:
    rank 0, or the only process."""
    return rank() == 0


def set_mesh(data: int, spatial: int = 1, model: int = 1) -> None:
    """Lay a (data, spatial, model) mesh over the process group's ranks and
    make its subgroups.  Every rank calls it, at the same point (each
    subgroup is made by every rank, in one order).  Raises unless
    data*spatial*model is the world size; without a process group (the
    mesh of one) it sets nothing."""
    global _mesh
    world, r = world_size(), rank()
    if data * spatial * model != world:
        raise ValueError(f"mesh {data}x{spatial}x{model} needs "
                         f"{data * spatial * model} devices, have {world} "
                         f"(one process a device)")
    if not active():
        _mesh = None
        return
    d, s, m = r // (spatial * model), (r // model) % spatial, r % model

    def rank_of(dd, ss, mm):
        return (dd * spatial + ss) * model + mm

    def mine(members) -> Group:
        """The group of ``members`` (lists of ranks) that holds this rank;
        made in order on every rank."""
        found = None
        for ranks in members:
            if len(ranks) == world:
                pg = None
            elif len(ranks) == 1:
                pg = SELF
            else:
                pg = dist.new_group(ranks)
            if r in ranks:
                found = Group(len(ranks), pg)
        return found

    _mesh = _Mesh(
        (data, spatial, model), (d, s, m),
        mine([[rank_of(dd, ss, mm) for ss in range(spatial)]
              for dd in range(data) for mm in range(model)]),
        mine([[rank_of(dd, ss, mm) for dd in range(data)
               for ss in range(spatial)] for mm in range(model)]),
        mine([[rank_of(dd, ss, mm) for dd in range(data)]
              for ss in range(spatial) for mm in range(model)]))


def _current_mesh() -> _Mesh:
    """The mesh set, or (world size, 1, 1)."""
    if _mesh is not None:
        return _mesh
    world = world_size()
    return _Mesh((world, 1, 1), (rank(), 0, 0), Group(1, SELF),
                 Group(world), Group(world))


def mesh_shape() -> dict[str, int]:
    """{"data": D, "spatial": S, "model": M} of the ranks' mesh."""
    return dict(zip(("data", "spatial", "model"), _current_mesh().shape))


def coords() -> tuple[int, int, int]:
    """This rank's (d, s, m) in the mesh."""
    return _current_mesh().coords


def batch_group() -> Group:
    """The data x spatial ranks of this rank's model index: between them
    they hold every row of the global batch once."""
    return _current_mesh().batch


def spatial_group() -> Group:
    """The spatial ranks of this rank's (d, m): the row slices of the same
    patches."""
    return _current_mesh().spatial


def data_group() -> Group:
    """The data ranks of this rank's (s, m): the same rows of the data
    slices' patches."""
    return _current_mesh().data


def _environment() -> tuple[str, int, int, int] | None:
    """(init_method, world size, rank, local rank) of a multi-process
    launch, or None."""
    coord = os.environ.get("FABRIC_COORDINATOR")
    nproc = os.environ.get("FABRIC_NUM_PROCESSES")
    if coord and nproc:
        r = int(os.environ.get("FABRIC_PROCESS_ID", "0"))
        cards = max(torch.cuda.device_count(), 1)
        local = int(os.environ.get("LOCAL_RANK", r % cards))
        return f"tcp://{coord}", int(nproc), r, local
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and "MASTER_ADDR" in os.environ:
        return ("env://", int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK",
                                                            "0")))
    return None


def maybe_initialize(device=None) -> bool:
    """Join the process group that the environment describes; True once a
    group exists (made here or by the caller).  ``device`` is the
    process's device kind (None means the card): NCCL and
    ``cuda:{local_rank}`` for CUDA, gloo for the CPU."""
    if active():
        return True
    env = _environment()
    if env is None:
        return False
    init_method, size, r, local = env
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if on_card:
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=init_method, world_size=size,
                            rank=r)
    log.info("torch.distributed initialised (%s): process %d/%d, %s",
             dist.get_backend(), r, size,
             f"cuda:{local}" if on_card else "cpu")
    return True


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, pg) -> torch.Tensor:
        ctx.pg = pg
        t = t.clone()
        dist.all_reduce(t, group=pg)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.pg)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group: Group | None = None
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (default: the :func:`batch_group`),
    with its gradient: the backward all-reduces the incoming gradient, so
    each rank's graph sees the sum of every rank's ∂L/∂S.  ``t`` itself
    without a process group or for a group of one."""
    group = batch_group() if group is None else group
    if not group.collective:
        return t
    return _AllReduceSum.apply(t, group.pg)


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group: Group | None = None
                ) -> torch.Tensor:
    """Sum ``t`` over ``group`` (default: the :func:`batch_group`) in
    place (no gradient)."""
    group = batch_group() if group is None else group
    if group.collective:
        dist.all_reduce(t, group=group.pg)
    return t


@torch.no_grad()
def mean_gradients(params) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks (one
    all-reduce of the flattened gradients).  On a mesh each of the M model
    replicas' D*S ranks holds D*S times its rows' share of the gradient
    (the backward of every global sum adds the D*S ranks' ∂L/∂S), so the
    world's sum over D*S*M ranks is the 1-process gradient."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every rank's parameters and buffers with rank ``src``'s."""
    if not active():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


def _host() -> "dist.ProcessGroup":
    """A gloo group for host-side flags (the default group when it is
    gloo), so that agreeing on a flag never waits for the card."""
    global _host_group
    if _host_group is None:
        _host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    return _host_group


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (a max all-reduce
    on the host); ``flag`` itself without a process group.  Every rank
    must call it at the same point."""
    if not active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host())
    return bool(t.item())


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _host_group, _mesh
    if active():
        dist.destroy_process_group()
    _host_group = _mesh = None
_mesh = None  # the _Mesh that set_mesh laid over the process group

SELF = "self"  # the process group of a rank alone: no collective


class Group(NamedTuple):
    """Ranks a collective sums over: ``size`` of them, ``pg`` their
    process group (None: the default group; :data:`SELF`: this rank alone,
    which needs no collective)."""
    size: int
    pg: object = None

    @property
    def collective(self) -> bool:
        """True when a sum over the group runs a collective."""
        return self.pg is not SELF and active()


class _Mesh(NamedTuple):
    shape: tuple[int, int, int]
    coords: tuple[int, int, int]
    spatial: Group
    batch: Group
    data: Group
