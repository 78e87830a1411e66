"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found from the names in
``BENCHMARK.json``:

- ``configs/<config>.json``: the model's sizes, dtype and provenance;
- ``workloads/<cell>.json``: the traffic mix, which names its ``driver``
  (``drivers/<driver>.py``) and holds the limits of the ``correct`` check;
- ``metrics/<metric>.py``: a reader with ``read(ctx) -> float | None``;
- ``flops/<config>.py``: the configuration's operation and byte counts;
- ``models/<model>.py``: a model's leaves (the seeded weights' shapes), its
  batches' layout and its plain reference forward, for every
  configuration whose ``model`` it is.

A later change adds files and manifest entries and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, ".cache")


def use_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run compiles (the port's nvcc libraries
    build into ``fabric_tpu_torch/build/`` there); set before Triton is
    imported."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: dict | None = None) -> dict:
    """The manifest's entry of cell ``name``."""
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def _module(path: str, label: str):
    """The module of the file at ``path``, loaded once a process."""
    if label in sys.modules:
        return sys.modules[label]
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(os.path.join(BENCH_DIR, "drivers", f"{name}.py"),
                   f"benchmark_driver_{name}")


def flops(config_name: str):
    return _module(os.path.join(BENCH_DIR, "flops", f"{config_name}.py"),
                   "benchmark_flops_" + config_name.replace("-", "_"))


def model(name: str):
    return _module(os.path.join(BENCH_DIR, "models", f"{name}.py"),
                   f"benchmark_model_{name}")


def reader(metric: str):
    return _module(os.path.join(BENCH_DIR, "metrics", f"{metric}.py"),
                   "benchmark_metric_" + metric.replace(".", "_")
                   .replace("-", "_"))


def metrics_of(cell_name: str, kind: str, bench: dict | None = None
               ) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell
    ``cell_name`` reports: those listing it under ``workloads``, and those
    without the key (every cell)."""
    bench = bench or manifest()
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
