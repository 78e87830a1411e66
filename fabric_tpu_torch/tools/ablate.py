"""Per-stage ablation timing of the folded eval forward (counterpart of
``fabric_tpu/tools/ablate.py``).

Times PREFIXES of BiDateNet's folded serving forward: stage 0 = the input
(both dates stacked and cast), 1 = +inc, 2-5 = +down1..4, 6 = +fusion,
7-10 = +up1..4, 11 = +head/argmax, so that consecutive deltas give each
stage's cost.  The prefixes call the folded model's own modules in the
order of its forward (``models/bidate.py``), so stage 11 *is* that
forward, bit for bit: on the card the hand kernels as ``ScenePredictor``
runs them (``conv3x3_bias_relu``, ``double_conv3x3_bias_relu`` where the
gate sends a block, ``fused_mul_relu``), on the CPU their plain versions.
Timed with CUDA events on the card, the host clock on the CPU.

``fabric_tpu`` sums every intermediate into its output so that XLA cannot
drop a prefix's unused work (and says to subtract those summing passes).
Eager PyTorch runs every op it is given, so the timed prefix returns its
last output and adds no summing pass; the sum stays as the objective that
gradient callers differentiate (``tools/ablate_train.py --stage K
--grad``).

    python -m fabric_tpu_torch.tools.ablate --stage 11 --batch 256 \
        --patch 64 [--iters 20] [--device cpu]
    python -m fabric_tpu_torch.tools.ablate --verify [--device cpu]

``--verify`` checks stage 11 against the folded model's forward.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

DOWN = ("down1", "down2", "down3", "down4")
UP = ("up1", "up2", "up3", "up4")


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of fn() over ``iters`` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
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


def build_functional(model, pool_impl: str = "reduce_window"):
    """``stages(x_d1, x_d2, upto, return_last=False)`` of a folded
    BiDateNet ``model`` (``build_model(..., fold_bn=True)``): the prefix
    up to stage ``upto``; its last output with ``return_last``, else the
    float32 sum of every stage's output (``fabric_tpu``'s objective).

    ``pool_impl`` names the form as ``fabric_tpu`` does:
    ``"reduce_window"`` runs the serving forward's own modules (the
    kernels); ``"reshape"`` is the form for gradient callers, plain
    differentiable ops over the same folded weights (``F.conv2d`` + bias
    in the compute dtype, ReLU, the reshape max-pool, the align-corners
    upsample, relu(d2 * d1)), since the serving kernels have no backward.
    (In ``fabric_tpu`` the name picks the max-pool primitive, as
    ``reduce_window`` has no transpose rule; the port's pool is the
    reshape max-pool in both forms.)"""
    from fabric_tpu_torch.models.bidate import fuse
    from fabric_tpu_torch.models.blocks import max_pool2x2
    from fabric_tpu_torch.ops.resize import (pad_to_match,
                                            upsample2x_align_corners)

    if pool_impl not in ("reduce_window", "reshape"):
        raise ValueError(f"pool_impl must be 'reduce_window' or 'reshape', "
                         f"got {pool_impl!r}")
    if not model.fold_bn:
        raise ValueError("the stages are the folded forward's: build the "
                         "model with fold_bn=True")
    plain = pool_impl == "reshape"

    def dc(block, x):
        if not plain:
            return block(x)
        return torch.relu(block.conv2(torch.relu(block.conv1(x))))

    def down(name, x):
        block = getattr(model, name)
        return dc(block.conv, max_pool2x2(x)) if plain else block(x)

    def up(name, y, skip):
        block = getattr(model, name)
        if not plain:
            return block(y, skip)
        y = pad_to_match(upsample2x_align_corners(y), skip.shape[1],
                         skip.shape[2])
        return dc(block.conv, torch.cat([skip, y], dim=-1))

    def stages(x_d1, x_d2, upto: int, return_last: bool = False):
        n = x_d1.shape[0]
        acts = [torch.cat([x_d1, x_d2]).to(model.dtype)]
        if upto >= 1:
            acts.append(dc(model.inc, acts[-1]))
        for i, name in enumerate(DOWN):
            if upto >= 2 + i:
                acts.append(down(name, acts[-1]))
        if upto >= 6:
            acts = acts[:1] + [torch.relu(a[n:] * a[:n]) if plain
                               else fuse(a[:n], a[n:]) for a in acts[1:]]
        if upto >= 7:
            y, skips = acts[-1], acts[1:-1][::-1]  # f4, f3, f2, f1
            for i, name in enumerate(UP):
                if upto >= 7 + i:
                    y = up(name, y, skips[i])
                    acts.append(y)
        if upto >= 11:
            logits = model.outc(acts[-1]).float()
            acts.append(logits.argmax(-1).to(torch.uint8))
        if return_last:
            return acts[-1]
        return sum(a.float().sum() for a in acts)

    return stages


def time_stage(stages, d1, d2, stage: int, iters: int,
               device: torch.device) -> tuple[float, float]:
    """(ms a prefix, seconds of its first call) of ``stages`` up to
    ``stage`` on d1, d2."""
    t0 = time.perf_counter()
    stages(d1, d2, stage, return_last=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    ms = time_ms(lambda: stages(d1, d2, stage, return_last=True), iters,
                 device)
    return ms, first_s


def verify(model, device) -> float:
    """Mask agreement of stage 11 with ``model``'s forward on two seeded
    32^2 bf16 pairs (1.0: bit for bit)."""
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randn(2, 32, 32, 13)).to(
        device, torch.bfloat16) for _ in range(2))
    with torch.inference_mode():
        ref = model(a, b).argmax(-1).to(torch.uint8)
        got = build_functional(model)(a, b, 11, return_last=True)
    return float((ref == got).float().mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", type=int, default=11)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.models import build_model

    device = resolve_device(args.device)
    cfg = Config(dtype="bfloat16", patch_size=args.patch)
    model = build_model(cfg, device)  # folded, seed-0 weights
    if args.verify:
        agree = verify(model, device)
        print(json.dumps({"verify_mask_agreement": agree}))
        return 0 if agree == 1.0 else 1

    rng = np.random.RandomState(0)
    d1, d2 = (torch.from_numpy(rng.randn(args.batch, args.patch, args.patch,
                                         13)).to(device, torch.bfloat16)
              for _ in range(2))
    with torch.inference_mode():
        ms, first_s = time_stage(build_functional(model), d1, d2,
                                 args.stage, args.iters, device)
    rec = {"stage": args.stage, "ms": round(ms, 3),
           "compile_s": round(first_s, 1), "batch": args.batch,
           "patch": args.patch, "backend": device.type}
    if device.type == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
