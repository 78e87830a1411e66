"""The command line: no card, no program, JAX loaded, a traced run; the
trace's reduction."""

import os
import shutil

import pytest

import tiny
from benchmark.harness import trace


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    rc, out, err = tiny.run_cli(tiny.SERVE, 5, None, device="cuda")
    assert rc != 0 and out.strip() == ""
    assert "CUDA" in err


def test_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    import subprocess
    import sys
    p = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", tiny.SERVE, "--seed", "5", "--seconds", "1",
         "--trace", "0", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_jax_loaded_refuses_the_result(tmp_path):
    """A process in which ``jax`` was imported prints no result."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax\n")
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), tiny.ROOT])}
    rc, out, err = tiny.run_cli(tiny.SERVE, 5, tiny.overrides(tiny.SERVE),
                                env=env)
    assert rc != 0 and out.strip() == "", err[-2000:]
    assert "jax" in err


def test_traced_run_refused_without_the_card():
    """A trace's numbers are the card's: no traced run on the CPU."""
    rc, out, err = tiny.run_cli(tiny.SERVE, 6, tiny.overrides(tiny.SERVE),
                                trace=1)
    assert rc != 0 and out.strip() == ""
    assert "--trace 1" in err


class _Event:
    """A profiler event as the torch on the card gives it: no
    ``activity_type``."""

    def __init__(self, name, on_card, start, end):
        self._e = (name, on_card, start, end)

    def name(self):
        return self._e[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._e[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._e[2]

    def end_ns(self):
        return self._e[3]


def test_trace_reduction():
    """Busy time is the union of the card's operations inside the window;
    each idle gap is named by the host activity over its middle; a host
    span mirrored on the device's timeline is no operation."""
    events = [_Event(trace.WINDOW, False, 0, 100),
              _Event(trace.WINDOW, True, 0, 100),  # mirrored: no operation
              _Event("k1", True, 10, 30),
              _Event("k2", True, 20, 40),
              _Event("HtoD", True, 60, 70),
              _Event("late", True, 150, 160),
              _Event("aten::copy_", False, 38, 62),
              _Event("aten::copy_", True, 50, 52)]  # mirrored as well
    r = trace.reduce_events(events)
    assert r["window_s"] == 100e-9 and r["busy_s"] == 40e-9
    assert dict(map(tuple, r["breakdown"]["device_ops"])) == {
        "k1": 20e-9, "k2": 20e-9, "HtoD": 10e-9}
    assert dict(map(tuple, r["breakdown"]["idle_gaps"])) == {
        "host (untraced)": 40e-9, "aten::copy_": 20e-9}


@pytest.mark.cuda
def test_a_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc, out, err = tiny.run_cli(tiny.SERVE, 8, None, device="cuda",
                                timeout=900)
    assert rc == 0, err[-3000:]
    r = tiny.result_of(out)
    assert r["correct"] and r["device"]["platform"] == "gpu"
