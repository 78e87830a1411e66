"""The int8 matrix-rate microbench (the ``--microbench int8_matmul`` part of
``fabric_tpu/tools/ablate_train.py``; its other ablations are ROADMAP.md
queue 1 item 12).

    python -m fabric_tpu_torch.tools.ablate_train --microbench int8_matmul \
        [--m 131072] [--k 512] [--n 512] [--iters 10] [--device cpu]

Times C = A @ B in four forms: the library's bf16 product (``torch.matmul``)
and int8 product (``torch._int_mm``), the yardsticks that stand where
``fabric_tpu`` timed XLA's dot, then the hand-written kernel
(``ops/int8_matmul.py``) in bf16 and in int8.  A and B hold integers in
[-127, 127] from seed 0.  Prints one JSON line with each form's ms and
T(FL)OP/s, and ``kernel_int8_exact``: whether the kernel's int32 product
equals the plain version's.  Timed with CUDA events on the card (the host
clock on the CPU).  A form that fails raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of fn() over ``iters`` calls after one warm-up."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def microbench_int8_matmul(m: int, k: int, n: int, iters: int,
                           device=None) -> dict:
    """Time the four forms of (m, k) @ (k, n) on ``device`` (None means the
    card) and check the kernel's int8 product exactly."""
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                  int8_matmul_reference)

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    xi = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(
        np.int8)).to(device)
    wi = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(
        np.int8)).to(device)
    xb, wb = xi.to(torch.bfloat16), wi.to(torch.bfloat16)
    gop = 2.0 * m * k * n / 1e9
    out = {"microbench": "int8_matmul", "m": m, "k": k, "n": n,
           "iters": iters, "gflop": round(gop, 1), "device": str(device)}
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    out["kernel_int8_exact"] = bool(torch.equal(
        int8_matmul(xi, wi), int8_matmul_reference(xi, wi)))
    for name, fn, a, b in (
            ("torch_bf16", torch.matmul, xb, wb),
            ("torch_int8", torch._int_mm, xi, wi),
            ("kernel_bf16", int8_matmul, xb, wb),
            ("kernel_int8", int8_matmul, xi, wi)):
        ms = _ms(lambda: fn(a, b), iters, device)
        out[f"{name}_ms"] = round(ms, 4)
        out[f"{name}_tflops"] = round(gop / ms, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--microbench", choices=["int8_matmul"], required=True)
    ap.add_argument("--m", type=int, default=131072)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(microbench_int8_matmul(args.m, args.k, args.n,
                                            args.iters, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
