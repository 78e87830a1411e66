"""``python -m fabric_tpu_torch.cli.train --config <json> [--key value ...]
[--device cuda|cpu]``

Trains ``cfg.model`` (BiDateNet, UNetLSTM or UNet3D) with the port
(counterpart of ``fabric_tpu/cli/train.py``): the same JSON config and
per-key overrides as ``fabric_tpu``, on the card unless ``--device cpu``
is given.  Data-parallel over several processes when the environment
describes a process group (``parallel/distributed.maybe_initialize``):

    torchrun --nproc_per_node 4 -m fabric_tpu_torch.cli.train --config c.json

or one process per card with ``FABRIC_COORDINATOR=host:port
FABRIC_NUM_PROCESSES=N FABRIC_PROCESS_ID=K`` set; ``batch_size`` is the
global batch, and ``--mesh_spatial`` / ``--mesh_model`` lay a (data,
spatial, model) mesh over the processes (``mesh_data`` -1 takes the rest).
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    from fabric_tpu_torch.config import load_config
    from fabric_tpu_torch.parallel import distributed
    from fabric_tpu_torch.train.loop import train

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="cuda (default) or cpu")
    opts, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(argv=rest)
    joined = not distributed.active() and distributed.maybe_initialize(
        opts.device)
    try:
        _, history = train(cfg, device=opts.device)
    finally:
        if joined:
            distributed.shutdown()
    if history.get("status") == "preempted":
        logging.getLogger("fabric_tpu_torch").warning(
            "run preempted: relaunch with --resume %s", cfg.weight_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
