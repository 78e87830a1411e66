"""The traced run: ``torch.profiler`` over the measured window, reduced to
the device's busy time, its operations by name and its idle gaps.

The window is the host interval of the benchmark's own ``bench.window``
span.  An operation on the device is a kernel, a copy or a memset; the
busy time is the union of their intervals inside the window.  An idle
gap is named by the innermost host activity that covers its middle (a
span of the benchmark's, an ATen op or a CUDA runtime call), or "host
(untraced)" when none does.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW = "bench.window"


def profiler():
    """A profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str):
    """A named host span in the trace (a no-op when nothing traces)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def window():
    with span(WINDOW):
        yield


def reduce(prof, top: int = 10, gaps_named: int = 500) -> dict:
    """{"window_s", "busy_s", "device_ops" [(name, start_ns, dur_ns)],
    "breakdown": {"device_ops", "idle_gaps"}} of a stopped profiler that
    traced the card."""
    return reduce_events(prof.profiler.kineto_results.events(), top,
                         gaps_named)


def reduce_events(events, top: int = 10, gaps_named: int = 500) -> dict:
    """``reduce`` of the profiler's events (each with ``name``,
    ``device_type``, ``start_ns`` and ``end_ns``).  The torch on the card
    gives its events no ``activity_type``, so an event on the device is an
    operation (a kernel, a copy or a memset) unless its name is also a
    host event's: a host span mirrored on the device's timeline.  Every
    event on the host is host activity."""
    on_card = [str(e.device_type()).lower().endswith("cuda")
               for e in events]
    host_names = {e.name() for e, c in zip(events, on_card) if not c}
    win = [e for e, c in zip(events, on_card) if not c and e.name() == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.end_ns() for e in win)
    ops, host = [], []
    for e, card in zip(events, on_card):
        if card and e.name() not in host_names:
            ops.append(e)
        elif not card and e.name() != WINDOW:
            host.append(e)
    spans = []
    for e in ops:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t > s:
            spans.append((s, t, e.name()))
    spans.sort()
    busy, gaps, cur_s, cur_t = 0, [], w0, w0
    for s, t, _ in spans:
        if s > cur_t:
            busy += cur_t - cur_s
            if s - cur_t > 0:
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if w1 > cur_t:
        gaps.append((cur_t, w1))
    by_name: dict = {}
    for s, t, name in spans:
        by_name[name] = by_name.get(name, 0) + (t - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "device_ops": [(n, s, t - s) for s, t, n in spans],
            "breakdown": {
                "device_ops": [[n, v / 1e9] for n, v in device_ops],
                "idle_gaps": _name_gaps(gaps, host, top, gaps_named)}}


def _name_gaps(gaps, host, top: int, named: int) -> list:
    """The idle time by the host activity during it, the ``top`` largest;
    the ``named`` longest gaps are named, the rest summed as one entry."""
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host)
    starts = [h[0] for h in host]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    totals: dict = {}
    for i, (s, t) in enumerate(gaps):
        if i >= named:
            totals["shorter gaps"] = totals.get("shorter gaps", 0) + (t - s)
            continue
        mid = (s + t) // 2
        name = "host (untraced)"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 4000, -1), -1):
            if host[k][1] >= mid:  # the latest start that covers it
                name = host[k][2]
                break
        totals[name] = totals.get(name, 0) + (t - s)
    best = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[n, v / 1e9] for n, v in best]
