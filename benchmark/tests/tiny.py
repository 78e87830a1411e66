"""Shrunk cells for the CPU tests: the same drivers, comparisons and
limits, at a width and size the CPU runs in seconds."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SERVE = "serve-bidate-grid-bf16-window2"
TRAIN = "train-bidate-p96-bf16"

_TRAIN = {"patch": 16, "stride": 8, "batch": 8, "num_workers": 0,
          "cities": [2, 48, 48], "trace_seconds": 1, "warmup_steps": 2,
          "steady_steps": 1, "steady_wait_ms": 1000, "warmup_max_steps": 4}
OVERRIDES = {
    SERVE: {"config": {"model_base": 8},
            "workload": {"scene": [64, 64], "pool": 2, "tile_batch": 16,
                         "patch": 16, "bucket": 32, "warmup_scenes": 2,
                         "check_scenes": 2, "reference_block": 16,
                         "trace_seconds": 1}},
    TRAIN: {"config": {"model_base": 8}, "workload": dict(_TRAIN)},
}


def overrides(cell: str, dtype: str | None = None, **workload) -> dict:
    """The cell shrunk; ``workload`` keys over the shrunk ones (``ranks=2,
    num_workers=1`` make the training cell data-parallel over two gloo
    ranks)."""
    ov = json.loads(json.dumps(OVERRIDES[cell]))
    if dtype:
        ov["config"]["dtype"] = dtype
    ov["workload"].update(workload)
    return ov


def run_cli(cell: str, seed: int, ov: dict | None, trace: int = 0,
            env: dict | None = None, device: str = "cpu",
            timeout: float = 240):
    """``benchmark/run.py`` in a subprocess: (exit code, stdout, stderr)."""
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds", "1",
           "--trace", str(trace)]
    if device != "cuda":
        cmd += ["--device", device]
    if ov is not None:
        cmd += ["--overrides", json.dumps(ov)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=dict(os.environ, OMP_NUM_THREADS="2",
                                **(env or {})))
    return p.returncode, p.stdout, p.stderr


def result_of(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
