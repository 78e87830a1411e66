"""The lower-precision control (the reference one step below the
configuration's precision, ``reference/precision.py``, put in the
program's place) fails the cell's check, here at a size a test run
holds, on three seeds.  Its readings at the cells' own sizes on the card,
which the limits were set from, are in ``PERF.md``."""

import time

import pytest

import tiny
from benchmark.harness import main as harness
from benchmark.harness import manifest


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_fails_the_check(cell, seed):
    entry = manifest.cell(cell)
    ov = tiny.overrides(cell)
    ctx = harness.Ctx(cell, seed, 1, False, entry,
                      harness.merge(manifest.workload(cell), ov["workload"]),
                      harness.merge(manifest.config(entry["config"]),
                                    ov["config"]),
                      "cpu", time.perf_counter())
    readings = manifest.driver(ctx.workload["driver"]).control(ctx)
    limits = ctx.workload["limits"]
    assert any(v > limits[k] for k, v in readings.items() if k in limits), \
        readings
