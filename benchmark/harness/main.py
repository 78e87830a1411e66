"""One run of one cell: look its pieces up by name, run its driver, read
its metrics, and build the result line.

A driver (``drivers/<name>.py``) has ``run(ctx) -> dict`` returning:

- ``end_to_end``: {metric name: value} of the window (host clock);
- ``attempted``, ``failed``: the units of work the window sent and those
  that failed or never came;
- ``checks``: {name: (number, limit)} of the ``correct`` comparison, each
  number passing when it is at most its limit;
- ``memory_peak_bytes`` (the fullest card) and ``count`` (cards used);
- ``host``: the host's side of the window as the driver reads it (the
  scenes or steps in each second, the wait for the loader), printed
  beside the result;
- with ``--trace 1``: ``trace`` (``trace.reduce``'s dict, its busy and
  window seconds averaged over the cards), and the ``counts`` and
  ``timings`` that the per-layer readers take.
"""

from __future__ import annotations

import dataclasses
import math
import sys

from benchmark.harness import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "fabric_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    entry: dict        # the manifest's entry of the cell
    workload: dict     # workloads/<cell>.json
    config: dict       # configs/<config>.json
    device: str        # "cuda" on the card; "cpu" only in CPU tests
    t0: float          # the process's start on the host clock
    rank: int = 0
    world: int = 1
    port: int = 0
    argv: tuple = ()   # the command line, for the ranks a driver starts


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``fabric_tpu_torch`` is not
    ``fabric_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def merge(base: dict, extra: dict | None) -> dict:
    """``base`` with ``extra``'s keys over it, nested dicts merged."""
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", overrides: dict | None = None,
             rank: int = 0, world: int = 1, port: int = 0,
             argv: tuple = ()) -> dict | None:
    """Run one cell once; the result line's object (None on a rank other
    than 0).  ``overrides`` ({"workload": {...}, "config": {...}}) shrink
    a cell for the CPU tests, which run it on ``device`` "cpu": never
    traced, since a trace's numbers are the card's."""
    if trace and device != "cuda":
        raise ValueError("a traced run reads the card: --trace 1 takes no "
                         f"--device {device}")
    bench = manifest.manifest()
    entry = manifest.cell(cell, bench)
    overrides = overrides or {}
    ctx = Ctx(cell, seed, seconds, trace, entry,
              merge(manifest.workload(cell), overrides.get("workload")),
              merge(manifest.config(entry["config"]),
                    overrides.get("config")),
              device, t0, rank, world, port, argv)
    out = manifest.driver(ctx.workload["driver"]).run(ctx)
    if rank != 0:
        return None
    return build_result(ctx, bench, out)


def build_result(ctx: Ctx, bench: dict, out: dict) -> dict:
    metrics = {}
    if ctx.trace:
        read_ctx = {"trace": out["trace"], "counts": out.get("counts", {}),
                    "timings": out.get("timings", {}),
                    "config": ctx.config, "workload": ctx.workload,
                    "flops": manifest.flops(ctx.entry["config"])}
        for m in manifest.metrics_of(ctx.cell, "per_layer", bench):
            value = manifest.reader(m["name"]).read(read_ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(ctx.cell, "end_to_end", bench):
            if m["name"] not in out["end_to_end"]:
                raise RuntimeError(f"the {ctx.workload['driver']} driver "
                                   f"gave no {m['name']}")
            metrics[m["name"]] = {"value": float(out["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": out.get("kind", ""), "count": out["count"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if ctx.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
    if out.get("power_limit"):
        device["power_limit"] = out["power_limit"]
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in out["checks"].items()}
    correct = bool(checks) and out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if ctx.trace:
        result["breakdown"] = out["trace"]["breakdown"]
    if out.get("notes"):
        result["notes"] = out["notes"]  # the worst leaves of the leaf gaps
    result["host"] = out.get("host", {})
    result["checks"] = checks  # last: each number compared, its limit
    return result
