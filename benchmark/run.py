"""Run one cell of the benchmark once, on the card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the result as the last line of standard output (one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
the ``correct`` comparison compared, beside its limit), and the same
checks as the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card (or with fewer cards than the cell asks for),
and when JAX, Flax or the JAX package ``fabric_tpu`` is loaded once the
window has closed.
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


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the benchmark itself for the ranks of a multi-card cell
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    # the CPU tests drive a run without a card, shrunk
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--overrides", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import manifest
    manifest.use_cache_dirs()
    import torch
    from benchmark.harness import main as harness
    from benchmark.harness.phases import Phases
    Phases(T0)("imports")

    chips = manifest.cell(args.workload)["chips"]
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {n}; no result", file=sys.stderr)
        return 2
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), T0,
        device=args.device,
        overrides=json.loads(args.overrides) if args.overrides else None,
        rank=args.rank, world=args.world, port=args.port,
        argv=tuple(sys.argv[1:] if argv is None else argv))
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)} (JAX or "
              f"the JAX package); no result", file=sys.stderr)
        return 3
    if result is None:  # a rank other than 0: rank 0 prints
        return 0
    sys.stdout.flush()
    print("host " + " ".join(f"{k} {v!r}" for k, v in result["host"].items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
