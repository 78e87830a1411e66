"""The ranks of a multi-card cell: one process a card.  The process that
the benchmark was started as is rank 0; it starts the others as copies of
its own command with ``--rank``, ``--world`` and ``--port`` added, and
waits for each of them to end."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

RUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "run.py")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def environment(rank: int, world: int, port: int) -> dict:
    """The program's process-group variables for ``rank``."""
    return {"FABRIC_COORDINATOR": f"localhost:{port}",
            "FABRIC_NUM_PROCESSES": str(world),
            "FABRIC_PROCESS_ID": str(rank), "LOCAL_RANK": str(rank)}


def spawn(argv: tuple, world: int, port: int) -> list:
    procs = []
    for rank in range(1, world):
        env = dict(os.environ, **environment(rank, world, port))
        procs.append(subprocess.Popen(
            [sys.executable, RUN, *argv, "--rank", str(rank),
             "--world", str(world), "--port", str(port)],
            env=env, stdout=subprocess.DEVNULL))
    return procs


def wait(procs: list, timeout: float = 120.0) -> list[int]:
    """Wait for every rank to end (killing one that outlives
    ``timeout``); their exit codes."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes
