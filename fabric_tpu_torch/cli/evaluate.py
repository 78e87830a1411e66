"""``python -m fabric_tpu_torch.cli.evaluate --config metadata.json
--resume <dir> [--city <name> ...] [--no_scene] [--output metrics.json]
[--device cuda|cpu]``

Standalone checkpoint evaluation (counterpart of
``fabric_tpu/cli/evaluate.py``): the patch-level validation metrics (the
reference's mean of per-batch cd_precisions / recalls / f1scores and the
global confusion-matrix P/R/F1) and each city's whole-scene F1 against its
label, printed as JSON.  For a run directory it evaluates the best-metric
save.  On the card unless ``--device cpu``; over the processes of a group
that the environment describes (as ``cli.train``), on the config's
(data, spatial, model) mesh of them.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--city", action="append", default=None,
                       help="city to evaluate (repeatable; default: "
                            "validation_cities)")
    extra.add_argument("--no_scene", action="store_true",
                       help="skip whole-scene inference, patch metrics only")
    extra.add_argument("--output", type=str, default=None,
                       help="also write the metrics dict to this JSON file")
    extra.add_argument("--device", default=None, help="cuda (default) or cpu")
    own, rest = extra.parse_known_args(argv)

    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.config import load_config
    from fabric_tpu_torch.evaluate import evaluate
    from fabric_tpu_torch.parallel import distributed

    cfg = load_config(argv=rest)
    if not cfg.resume:
        print("error: --resume <checkpoint file or run dir> is required",
              file=sys.stderr)
        return 2
    if os.path.isdir(cfg.resume):
        # the best-metric weights, not a newer mid-epoch periodic save
        best = ckpt.read_pointer(cfg.resume, "best")
        if best:
            cfg.resume = best
            logging.info("using best-metric checkpoint %s", best)

    joined = not distributed.active() and distributed.maybe_initialize(
        own.device)
    try:
        result = evaluate(cfg, cities=own.city,
                          run_scene_inference=not own.no_scene,
                          device=own.device)
    finally:
        if joined:
            distributed.shutdown()
    if own.output:
        with open(own.output, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        logging.info("wrote %s", own.output)
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
