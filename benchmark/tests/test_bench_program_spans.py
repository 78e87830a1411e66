"""The readers of the program's own spans (``harness/program_spans.py``
and the five metrics that read it): a hand-built traced context (device
operations with known gaps) and span record give each metric its known
value, and each reader returns None where the program records no such
span, or no record at all."""

import pytest

from benchmark.harness import manifest, program_spans
from fabric_tpu_torch.utils import profiling

MS = 1_000_000  # ns


def _span(name, start_ms, end_ms, id=None, parent=None, **fields):
    return profiling.Span(name, start_ms * MS, end_ms * MS, parent, id,
                          fields)


# The card runs 0-10, 30-40 and 60-100 ms of a 100 ms window: idle 10-30
# and 40-60 (and nothing before the first or after the last operation).
OPS = [("k", 0, 10 * MS), ("copy", 30 * MS, 5 * MS), ("k", 32 * MS, 8 * MS),
       ("k", 60 * MS, 40 * MS)]

SERVE = [
    _span("serve.pad", 5, 6, 0, "serve.dispatch"),
    _span("serve.stage", 6, 16, 0, "serve.dispatch", bytes=200_000_000),
    _span("serve.stage", 16, 26, 0, "serve.dispatch", bytes=200_000_000),
    _span("serve.dispatch", 5, 28, 0),  # idle under it: 10-28
    _span("serve.stage", 45, 55, 1, "serve.dispatch", bytes=100_000_000),
    _span("serve.dispatch", 44, 70, 1),  # idle under it: 44-60
]
# 2 steps: next, slot and upload 12 + 2 and 2 + 6 + 1 ms; idle under
# them 12-26 and 40-49
FEED = [
    _span("loader.next", 12, 24, 0), _span("loader.upload", 24, 26, 0),
    _span("loader.slot", 40, 42, 1), _span("loader.next", 42, 48, 1),
    _span("loader.upload", 48, 49, 1),
]


def _ctx(steps=2):
    return {"trace": {"window_s": 0.1, "busy_s": 0.06, "device_ops": OPS},
            "counts": {"steps": steps}, "timings": {}}


def _read(metric, ctx):
    return manifest.reader(metric).read(ctx)


@pytest.mark.parametrize("metric,value", [
    ("front_ms.serve", (23 + 26) / 2),
    ("stage_gb_s.serve", 500_000_000 / 0.030 / 1e9),
    ("idle_in_front.serve", 100 * (18 + 16) / 100),
    ("feed_wait_ms.train", (12 + 2 + 2 + 6 + 1) / 2),
    ("idle_in_feed.train", 100 * (14 + 9) / 100),
])
def test_reader_values(monkeypatch, metric, value):
    monkeypatch.setattr(profiling, "spans", lambda: SERVE + FEED)
    assert _read(metric, _ctx()) == pytest.approx(value, rel=1e-9)


METRICS = ["front_ms.serve", "stage_gb_s.serve", "idle_in_front.serve",
           "feed_wait_ms.train", "idle_in_feed.train"]


@pytest.mark.parametrize("metric", METRICS)
def test_readers_without_spans(monkeypatch, metric):
    """No spans of the metric's names (an untraced run, or the other
    cell's spans alone): None."""
    other = FEED if metric.endswith(".serve") else SERVE
    monkeypatch.setattr(profiling, "spans", lambda: other)
    assert _read(metric, _ctx()) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric, _ctx()) is None


@pytest.mark.parametrize("metric", METRICS)
def test_readers_of_a_program_without_a_record(monkeypatch, metric):
    """A program from before the record (no ``profiling.spans``): None,
    no exception."""
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.record() == []
    assert _read(metric, _ctx()) is None


def test_idle_gaps_merge_overlapping_operations():
    assert program_spans.idle_gaps(OPS) == [(10 * MS, 30 * MS),
                                            (40 * MS, 60 * MS)]
    assert program_spans.idle_gaps([]) == []
