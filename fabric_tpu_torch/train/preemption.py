"""Graceful preemption: SIGTERM becomes a checkpoint and a clean exit
(a copy of ``fabric_tpu/train/preemption.py``).

The signal handler only sets a flag; the training loop polls it at step
boundaries, writes a mid-epoch periodic checkpoint and unwinds with
:class:`TrainingPreempted`, which ``train()`` turns into a normal return
with ``history["status"] == "preempted"``.  Relaunching with
``resume=<weight_dir>`` completes the run exactly.
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("fabric_tpu_torch")


class TrainingPreempted(Exception):
    """Raised in the epoch loop once the preemption checkpoint is written;
    carries the state at the unwind point."""

    def __init__(self, state=None, message: str = "training preempted"):
        super().__init__(message)
        self.state = state


class PreemptionGuard:
    """Flag-based signal latch.  ``install()`` swaps in a handler that
    records the request (main thread only; elsewhere the guard is a manual
    latch driven by :meth:`request`); ``uninstall()`` restores the old
    handlers."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self.installed = False

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Latch a preemption by hand (tests, external notice channels)."""
        self._event.set()

    def _handler(self, signum, frame) -> None:  # noqa: ARG002 (signal API)
        self._event.set()
        log.warning("signal %s received: checkpointing at the next step "
                    "boundary, then exiting cleanly", signum)

    def install(self) -> bool:
        """True when the handlers were installed (main thread only)."""
        if self.installed:
            return True
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
        except ValueError:  # not the main thread: manual latch mode
            for sig, old in self._previous.items():
                signal.signal(sig, old)
            self._previous.clear()
            return False
        self.installed = True
        return True

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, old in self._previous.items():
            signal.signal(sig, old)
        self._previous.clear()
        self.installed = False
