"""Readings for the limits of a cell's ``correct`` check, in one process:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

For each of ``--seeds`` it runs the cell (a short window at the cell's
load, then the comparison) and prints the numbers compared; for each of
``--control-seeds`` it puts the control (the reference one precision step
below the configuration's, ``reference/precision.py``) in the program's
place and prints the same numbers.  The last line sums up: per number,
the largest program reading (the lower end of its limit) and the
smallest control reading (the upper end).  The benchmark's own runs do
not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from benchmark.harness import manifest
    manifest.use_cache_dirs()
    from benchmark.harness import main as harness

    lower: dict = {}
    upper: dict = {}
    for seed in _seeds(args.seeds):
        argv_run = ("--workload", args.workload, "--seed", str(seed),
                    "--seconds", str(args.seconds), "--trace", "0")
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             time.perf_counter(), argv=argv_run)
        values = {k: c["value"] for k, c in r["checks"].items()}
        for k, v in values.items():
            lower[k] = max(lower.get(k, v), v)
        print(json.dumps({"kind": "program", "seed": seed,
                          "failed": r["failed"], "attempted": r["attempted"],
                          "readings": values, "notes": r.get("notes", {}),
                          "metrics": {k: m["value"] for k, m in
                                      r["metrics"].items()}}), flush=True)
    entry = manifest.cell(args.workload)
    for seed in _seeds(args.control_seeds):
        ctx = harness.Ctx(args.workload, seed, args.seconds, False, entry,
                          manifest.workload(args.workload),
                          manifest.config(entry["config"]), "cuda", T0)
        values = manifest.driver(ctx.workload["driver"]).control(ctx)
        for k, v in values.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"kind": "control", "seed": seed,
                          "readings": values}), flush=True)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
