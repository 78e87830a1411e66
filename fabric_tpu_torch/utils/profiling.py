"""Tracing and step timing (counterpart of
``fabric_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of the work inside it,
  written into a directory in TensorBoard's profiler format (a Chrome
  trace, also readable by Perfetto): host activity always, the card's
  kernels when CUDA is in use.
- :func:`annotate`: a named span in such a trace.
- :func:`sync`: wait for the device work that feeds a tensor.
- :class:`StepTimer`: per-step host-clock times and their summary, with
  ``fabric_tpu``'s keys and values.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def start_trace(logdir: str, cuda: bool | None = None):
    """A started ``torch.profiler.profile`` that writes its trace into
    ``logdir`` when stopped (``.stop()``).  ``cuda``: trace the card's
    activity too (None: when this process has initialised CUDA)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if cuda is None:
        cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(logdir: str, cuda: bool | None = None):
    """Trace the body into ``logdir`` (a ``*.pt.trace.json`` file);
    yields the profiler (``key_averages()`` once the body is done)."""
    prof = start_trace(logdir, cuda)
    try:
        yield prof
    finally:
        prof.stop()


def annotate(name: str):
    """A named span visible in profiler traces."""
    return torch.profiler.record_function(name)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, torch.nn.Module):
        return next(x.parameters(), None)
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait for the device work that feeds ``x`` (a tensor, a module, or a
    list, tuple or dict of them): ``torch.cuda.synchronize`` on its
    device; nothing to wait for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Accumulates step wall-clock times; reports steps/s and
    examples/s.  A step that is only enqueued on the card is timed as
    such: the times describe the host's side of each step."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self, batch_size: int | None = None,
                skip_first: int = 1) -> dict:
        """{steps, mean_step_s, p50_step_s, p95_step_s, steps_per_sec[,
        examples_per_sec]} over the times after the first ``skip_first``
        (all of them if none is left)."""
        times = self.times[skip_first:] or self.times
        if not times:
            return {}
        mean = float(np.mean(times))
        out = {"steps": len(self.times), "mean_step_s": mean,
               "p50_step_s": float(np.percentile(times, 50)),
               "p95_step_s": float(np.percentile(times, 95)),
               "steps_per_sec": 1.0 / mean if mean else 0.0}
        if batch_size:
            out["examples_per_sec"] = batch_size / mean if mean else 0.0
        return out
