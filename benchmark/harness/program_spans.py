"""What the readers of the program's own spans share
(``metrics/front_ms.serve.py`` and the others that read them).

The program (``fabric_tpu_torch.utils.profiling``) records its spans while
a ``torch.profiler`` traces its process, which in a traced run is the
driver's window; each span has ``name``, ``start_ns`` and ``end_ns`` on
the profiler's clock, ``id`` and ``fields``.  A program without that
record (one from before it existed) gives no spans, and every reader then
returns None.

The idle readers do not know the window's start: they take the card's idle
time as the gaps between the trace's device operations (``trace.reduce``'s
``device_ops``, already clipped to the window) within those operations'
own extent, which leaves out the idle time before the first operation and
after the last (under one scene or one step).
"""

from __future__ import annotations

# the training feed's spans: the wait for a worker's batch, the wait for a
# ring slot's copy to the card, the batch's copy enqueued
FEED = ("loader.next", "loader.slot", "loader.upload")


def record() -> list:
    """The program's recorded spans, or [] where it records none."""
    try:
        from fabric_tpu_torch.utils import profiling
        return profiling.spans()
    except (ImportError, AttributeError):
        return []


def named(spans, names) -> list:
    """The spans whose name is one of ``names``."""
    return [s for s in spans if s.name in names]


def seconds(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def _union(intervals) -> list:
    out: list = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def idle_gaps(device_ops) -> list:
    """The intervals (ns) between the device operations ((name, start_ns,
    dur_ns)), within their extent."""
    busy = _union((s, s + d) for _, s, d in device_ops)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def idle_share_under(ctx, spans) -> float | None:
    """Percent of the traced window in which the card was idle under one
    of ``spans``; None without spans, operations or a window."""
    t = ctx["trace"]
    if not spans or not t["device_ops"] or t["window_s"] <= 0:
        return None
    covered = _union((s.start_ns, s.end_ns) for s in spans)
    idle, j = 0, 0
    for g0, g1 in idle_gaps(t["device_ops"]):
        while j < len(covered) and covered[j][1] <= g0:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < g1:
            idle += min(g1, covered[k][1]) - max(g0, covered[k][0])
            k += 1
    return 100.0 * idle / 1e9 / t["window_s"]
