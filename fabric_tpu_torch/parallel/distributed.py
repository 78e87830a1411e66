"""Process groups for data-parallel training, and the collectives the
port's global-batch quantities use (counterpart of
``fabric_tpu/parallel/distributed.py``).

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
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("fabric_tpu_torch")

_host_group = None


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
    """Sum over the ranks; the backward sums the incoming gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, with its gradient: the backward
    all-reduces the incoming gradient, so each rank's graph sees the sum
    of every rank's ∂L/∂S.  ``t`` itself without a process group."""
    if not active():
        return t
    return _AllReduceSum.apply(t)


@torch.no_grad()
def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no gradient)."""
    if active():
        dist.all_reduce(t)
    return t


@torch.no_grad()
def mean_gradients(params) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks (one
    all-reduce of the flattened gradients)."""
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
    global _host_group
    if active():
        dist.destroy_process_group()
    _host_group = None
