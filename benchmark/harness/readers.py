"""Helpers of the per-layer metric readers (``metrics/<name>.py``).  A
reader takes the traced run's context: ``trace`` (``trace.reduce``'s
dict: ``window_s``, ``busy_s``, ``device_ops``), ``counts`` and
``timings`` (the driver's), ``config``, ``workload`` and ``flops`` (the
configuration's counts module); it returns a number, or None when it
finds nothing to read."""

from __future__ import annotations

from benchmark.harness import peaks


def idle_share(ctx) -> float | None:
    """Percent of the traced window in which no operation ran on the
    device."""
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def op_seconds(ctx, patterns) -> float:
    """Device seconds of the traced operations whose name holds any of
    ``patterns``."""
    return sum(dur for name, _, dur in ctx["trace"]["device_ops"]
               if any(p in name for p in patterns)) / 1e9


def mfu(ctx, flops: float) -> float | None:
    """Percent of the card's peak in the configuration's dtype that
    ``flops`` operations over the traced window make."""
    t = ctx["trace"]
    if not flops or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    peak = peaks.PEAK_FLOPS[ctx["config"]["dtype"]]
    return 100.0 * flops / (t["window_s"] * peak)
