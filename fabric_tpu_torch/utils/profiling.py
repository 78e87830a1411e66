"""Tracing, spans and counters (counterpart of
``fabric_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of the work inside it,
  written into a directory in TensorBoard's profiler format (a Chrome
  trace, also readable by Perfetto): host activity always, the card's
  kernels when CUDA is in use.
- :func:`span`: a named interval of the program's work, recorded while a
  ``torch.profiler`` traces this process (:func:`spans`), and a
  ``record_function`` range in that trace.
- :func:`count`: an always-on counter (:func:`counters`).
- :func:`sync`: wait for the device work that feeds a tensor.

A span is stamped on the clock that torch's profiler stamps its own host
events with, the wall clock (``time.time_ns``; torch 2.11 and 2.13 both
report a ``record_function`` event's ``start_ns()`` on it), so a span
lies directly over the trace's device operations.  Its start is read
before the ``record_function`` range opens and its end after it closes:
the span covers its own trace event.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch

MAX_SPANS = 65536  # the record keeps the latest spans


class Span(NamedTuple):
    """One recorded span: ``start_ns`` and ``end_ns`` on the profiler's
    clock, the enclosing span's name (``parent``, None at the top), the
    ``id`` it was given or inherited from the enclosing span, and its
    keyword ``fields``."""
    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    id: object
    fields: dict


_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_open = threading.local()  # .stack: this thread's open spans
_counters: dict = {}
_counters_lock = threading.Lock()
_OFF = contextlib.nullcontext()


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


class _Recording:
    __slots__ = ("name", "id", "fields", "parent", "start", "range")

    def __init__(self, name: str, id, fields: dict):
        self.name, self.id, self.fields = name, id, fields

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.id is None and top is not None:
            self.id = top.id
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.parent, self.id,
                           self.fields))
        return False


def span(name: str, id=None, **fields):
    """A context manager around one piece of the program's work.  While a
    ``torch.profiler`` traces this process it opens a
    ``record_function(name)`` range and, on exit, appends a :class:`Span`
    to the record; ``id`` defaults to the enclosing span's, so the pieces
    of one request share it.  Otherwise it is a shared no-op: one check,
    no clock reading."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recording(name, id, fields)


def spans() -> list[Span]:
    """The recorded spans (the latest ``MAX_SPANS``), in the order they
    ended."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


def count(name: str, value=1) -> None:
    """Add ``value`` to counter ``name`` (always on)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + value


def counters() -> dict:
    """A copy of every counter."""
    with _counters_lock:
        return dict(_counters)


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
