"""Train-step attribution and the layout microbenches (counterpart of
``fabric_tpu/tools/ablate_train.py``).

**Variant timing** (``--variant``): one train-step variant per run, so
that differences between runs attribute the step:

  full       the train step (fwd + bwd + SGD + metrics)
  grad       forward, loss and backward; no optimizer, no metrics
  fwd        the train-mode forward + loss (BatchNorm batch statistics,
             running averages updated), no gradient recorded
  eval_fwd   the eval-mode forward + loss (running-average BatchNorm: the
             eval BatchNorm kernel, as ``evaluate`` runs it)
  full_remat full with ``cfg.remat`` (every U-Net stage rematerialised)
  no_donate  full; eager PyTorch donates no buffers, so this is the same
             step as full (its record says so)
  full_lane_pack, full_lane_pack_bwd, fwd_lane_pack
             full / fwd with ``cfg.lane_pack`` (and ``lane_pack_bwd``):
             the space-to-depth convs of ``ops/s2d_conv.py``

  full - grad     = optimizer + metrics
  grad - fwd      = backward
  fwd - eval_fwd  = train-mode BatchNorm (float32 statistics)

**Per-stage grad timing** (``--stage K --grad``): forward and backward of
a prefix of the folded forward (``tools/ablate.py``'s stages, in their
differentiable form), so that consecutive deltas give each stage's fwd +
bwd cost.

**Microbenches** (``--microbench``): ``group_conv`` (a 64-channel conv
on a 2N batch against one groups=2 conv on N at 128 channels, cuDNN
``F.conv2d`` both), ``space_to_depth`` (a direct 3x3 conv against the
port's lane-packed ``s2d_conv3x3``), ``int8_matmul`` (the library's bf16
and int8 products against the hand-written ``int8_matmul`` kernel) and
``int8_shift_conv`` (a SAME 3x3 int8 conv as the raw ``conv3x3_s8``
kernel against nine shifted ``int8_matmul`` launches, int32 exact).

A variant's steps are timed on the host clock up to a synchronize, as
``fabric_tpu`` times them; prefixes and microbenches with CUDA events on
the card (the host clock on the CPU, where the kernels are their plain
versions).  ``--xla_opt`` has no PyTorch meaning and is refused.

    python -m fabric_tpu_torch.tools.ablate_train --variant full \
        [--batch 128] [--patch 96] [--iters 10] [--device cpu]
    python -m fabric_tpu_torch.tools.ablate_train --stage 11 --grad
    python -m fabric_tpu_torch.tools.ablate_train --microbench int8_matmul \
        [--m 131072] [--k 512] [--n 512]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from fabric_tpu_torch.tools.ablate import time_ms

VARIANTS = ("full", "grad", "fwd", "eval_fwd", "full_remat", "no_donate",
            "full_lane_pack", "full_lane_pack_bwd", "fwd_lane_pack")


def _data(batch: int, patch: int, device) -> dict:
    """A seed-0 batch in ``fabric_tpu``'s draw order."""
    rng = np.random.RandomState(0)
    out = {"img1": rng.randn(batch, patch, patch, 13).astype(np.float32),
           "img2": rng.randn(batch, patch, patch, 13).astype(np.float32),
           "label": rng.randint(0, 2, (batch, patch, patch)).astype(
               np.int32),
           "weight": np.ones(batch, np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_variant(variant: str, cfg, device=None):
    """-> (carry, fn) with ``(carry, leaf) = fn(carry, batch)``: carry is
    the TrainState, ``leaf`` a tensor of that step's work (the loss, or
    for ``grad`` a gradient).  ``variant`` is one of full, full_remat,
    no_donate, grad, fwd and eval_fwd (the lane-pack variants are full and
    fwd with ``cfg.lane_pack``)."""
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step

    device = resolve_device(device)
    model = build_model(cfg, device, generator=torch.Generator().manual_seed(
        cfg.seed), fold_bn=False, train=True)
    loss_fn = get_loss_fn(cfg)
    state = create_state(cfg, model)

    if variant in ("full", "full_remat", "no_donate"):
        step = make_train_step(model, loss_fn)

        def fn(carry, batch):
            carry, stats = step(carry, batch)
            return carry, stats["loss"]
        return state, fn

    if variant == "grad":
        params = list(state.tx.params.values())

        def fn(carry, batch):
            for p in params:
                p.grad = None
            logits = model(batch["img1"], batch["img2"], train=True)
            loss_fn(logits, batch["label"],
                    weights=batch["weight"]).backward()
            # no optimizer step; a gradient is the sync point
            return carry, params[0].grad
        return state, fn

    if variant in ("fwd", "eval_fwd"):
        train = variant == "fwd"

        @torch.no_grad()
        def fn(carry, batch):
            logits = model(batch["img1"], batch["img2"], train=train)
            return carry, loss_fn(logits, batch["label"],
                                  weights=batch["weight"])
        return state, fn

    raise ValueError(f"unknown variant {variant!r}")


def time_variant(variant: str, batch: int, patch: int, iters: int,
                 dtype: str, device=None) -> dict:
    """One variant's step at full width (``Config``'s base 64): ms a step
    and examples/s over ``iters`` steps after one, whose seconds are
    ``compile_s``."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.infer.service import resolve_device

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    device = resolve_device(device)
    cfg = Config(dtype=dtype, patch_size=patch, batch_size=batch,
                 remat=variant == "full_remat",
                 lane_pack="lane_pack" in variant,
                 lane_pack_bwd=variant == "full_lane_pack_bwd")
    built = ("full" if variant.startswith("full_lane_pack")
             else "fwd" if variant == "fwd_lane_pack" else variant)
    carry, fn = build_variant(built, cfg, device)
    data = _data(batch, patch, device)
    t0 = time.perf_counter()
    carry, _ = fn(carry, data)
    _sync(device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, _ = fn(carry, data)
    _sync(device)
    step_s = (time.perf_counter() - t0) / iters
    out = {"variant": variant, "patch": patch, "batch": batch,
           "iters": iters, "step_ms": round(step_s * 1000, 2),
           "examples_per_sec": round(batch / step_s, 1),
           "compile_s": round(compile_s, 1), "dtype": dtype,
           "device": str(device)}
    if variant == "no_donate":
        out["note"] = ("eager PyTorch donates no buffers: the same step as "
                       "full")
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    return out


def stage_grad_fn(model, data: dict, stage: int):
    """``fn() -> {name: gradient}`` of the folded prefix up to ``stage``
    (clamped to 10: stage 11's argmax has no gradient): the gradient of
    the sum of every stage's output with respect to the folded weights,
    as ``fabric_tpu``'s ``time_stage_grad`` differentiates it."""
    from fabric_tpu_torch.tools.ablate import build_functional

    stages = build_functional(model, pool_impl="reshape")
    named = dict(model.named_parameters())
    stage = min(stage, 10)

    def fn():
        flags = [p.requires_grad for p in named.values()]
        try:
            with torch.enable_grad():
                for p in named.values():
                    p.requires_grad_(True)
                grads = torch.autograd.grad(
                    stages(data["img1"], data["img2"], stage),
                    list(named.values()), allow_unused=True)
        finally:
            for p, flag in zip(named.values(), flags):
                p.requires_grad_(flag)
        return {k: g for k, g in zip(named, grads) if g is not None}
    return fn


def time_stage_grad(stage: int, batch: int, patch: int, iters: int,
                    dtype_name: str, device=None) -> dict:
    """Time forward + backward of a folded forward prefix."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.models import build_model

    device = resolve_device(device)
    cfg = Config(dtype=dtype_name, patch_size=patch, batch_size=batch)
    fn = stage_grad_fn(build_model(cfg, device), _data(batch, patch, device),
                       stage)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    compile_s = time.perf_counter() - t0
    ms = time_ms(fn, iters, device)
    return {"stage": min(stage, 10), "patch": patch, "batch": batch,
            "iters": iters, "grad_step_ms": round(ms, 2),
            "compile_s": round(compile_s, 1), "dtype": dtype_name}


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the channels-last NCHW view cuDNN takes."""
    return t.permute(0, 3, 1, 2)


def microbench_group_conv(batch: int, patch: int, iters: int,
                          dtype_name: str, device=None) -> dict:
    """The Siamese encoder's 64-channel convs on a 2N batch, against the
    same math as one groups=2 conv on an N batch at 128 channels."""
    from fabric_tpu_torch.infer.service import resolve_device

    device = resolve_device(device)
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    rng = np.random.RandomState(0)
    n, c = batch, 64
    x2n = rng.randn(2 * n, patch, patch, c).astype(np.float32)
    k = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)
    xg = np.concatenate([x2n[:n], x2n[n:]], axis=-1)
    kg = np.concatenate([k, k], axis=-1)  # (3, 3, 64, 128), groups=2

    def put(a):
        return torch.from_numpy(a).to(device, dt)
    x2n, xg = _nchw(put(x2n)), _nchw(put(xg))
    k, kg = (put(w).permute(3, 2, 0, 1).contiguous() for w in (k, kg))
    return {"microbench": "group_conv", "batch": batch, "patch": patch,
            "iters": iters, "dtype": dtype_name,
            "batched_2n_c64_ms": round(time_ms(
                lambda: F.conv2d(x2n, k, padding=1), iters, device), 3),
            "grouped_n_c128_ms": round(time_ms(
                lambda: F.conv2d(xg, kg, padding=1, groups=2), iters,
                device), 3)}


def microbench_space_to_depth(batch: int, patch: int, iters: int,
                              dtype_name: str, cin: int = 64,
                              cout: int = 64, device=None) -> dict:
    """A 3x3 SAME conv direct (``F.conv2d``) against lane-packed
    (``s2d_conv.s2d_conv3x3``: s2d, a 2x2 VALID conv at 4x the channels,
    d2s), on the same inputs; ``max_abs_err`` between the two."""
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.ops import s2d_conv

    device = resolve_device(device)
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, patch, patch, cin) * 0.1).to(
        device, dt)
    w = torch.from_numpy(rng.randn(3, 3, cin, cout) * 0.05).to(device, dt)
    err = (s2d_conv.direct_conv3x3(x, w).float()
           - s2d_conv.s2d_conv3x3(x, w).float()).abs().max().item()
    return {"microbench": "space_to_depth", "batch": batch, "patch": patch,
            "cin": cin, "cout": cout, "iters": iters, "dtype": dtype_name,
            "max_abs_err": err,
            "direct_3x3_ms": round(time_ms(
                lambda: s2d_conv.direct_conv3x3(x, w), iters, device), 3),
            "s2d_2x2_ms": round(time_ms(
                lambda: s2d_conv.s2d_conv3x3(x, w), iters, device), 3)}


def microbench_int8_matmul(m: int, k: int, n: int, iters: int,
                           device=None) -> dict:
    """Time C = A @ B in four forms: the library's bf16 product
    (``torch.matmul``) and int8 product (``torch._int_mm``), the
    yardsticks that stand where ``fabric_tpu`` timed XLA's dot, then the
    hand-written kernel (``ops/int8_matmul.py``) in bf16 and in int8, on
    integers in [-127, 127] from seed 0; ``kernel_int8_exact``: whether
    the kernel's int32 product equals the plain version's."""
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
        ms = time_ms(lambda: fn(a, b), iters, device)
        out[f"{name}_ms"] = round(ms, 4)
        out[f"{name}_tflops"] = round(gop / ms, 1)
    return out


def shifted_conv_s8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A SAME 3x3 int8 conv as the sum of nine shifted (N*H*W, Cin) @
    (Cin, Cout) int8 products (``int8_matmul``), int32 out."""
    from fabric_tpu_torch.ops.int8_matmul import int8_matmul

    n, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for u in range(3):
        for v in range(3):
            xs = xp[:, u:u + h, v:v + wd].reshape(-1, cin)
            y = int8_matmul(xs, w[u, v].contiguous())
            acc = y if acc is None else acc + y
    return acc.reshape(n, h, wd, -1)


def microbench_int8_shift_conv(batch: int, patch: int, iters: int,
                               cin: int = 128, cout: int = 128,
                               device=None) -> dict:
    """A SAME 3x3 int8 conv two ways: "direct" is the raw ``conv3x3_s8``
    kernel (exact int32 sums), "shifted" nine ``int8_matmul`` launches
    summed (:func:`shifted_conv_s8`); ``exact`` whether their int32
    outputs are equal."""
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.ops.conv_s8 import conv3x3_s8, pack_weight

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-127, 128, (batch, patch, patch, cin))
                         .astype(np.int8)).to(device)
    w = torch.from_numpy(rng.randint(-127, 128, (3, 3, cin, cout))
                         .astype(np.int8)).to(device)
    packed = pack_weight(w)

    def direct():
        return conv3x3_s8(x, w, packed)

    exact = bool(torch.equal(direct(), shifted_conv_s8(x, w)))
    gop = 2.0 * 9 * batch * patch * patch * cin * cout / 1e9
    d_ms = time_ms(direct, iters, device)
    s_ms = time_ms(lambda: shifted_conv_s8(x, w), iters, device)
    return {"microbench": "int8_shift_conv", "batch": batch, "patch": patch,
            "cin": cin, "cout": cout, "iters": iters, "exact": exact,
            "gflop": round(gop, 1),
            "direct_conv_ms": round(d_ms, 3),
            "direct_conv_tflops": round(gop / d_ms, 1),
            "shifted_dot_ms": round(s_ms, 3),
            "shifted_dot_tflops": round(gop / s_ms, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default=None, choices=VARIANTS)
    ap.add_argument("--stage", type=int, default=None)
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--microbench",
                    choices=["group_conv", "space_to_depth", "int8_matmul",
                             "int8_shift_conv"], default=None)
    ap.add_argument("--m", type=int, default=131072)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--patch", type=int, default=96)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--cout", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--xla_opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="an XLA compiler option: refused (eager PyTorch "
                         "has none)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.xla_opt:
        ap.error("--xla_opt sets an XLA compiler option; the port runs "
                 "eager PyTorch, which has none")
    d = args.device
    if args.microbench == "int8_matmul":
        rec = microbench_int8_matmul(args.m, args.k, args.n, args.iters, d)
    elif args.microbench == "int8_shift_conv":
        rec = microbench_int8_shift_conv(args.batch, args.patch, args.iters,
                                         args.cin, args.cout, d)
    elif args.microbench == "group_conv":
        rec = microbench_group_conv(args.batch, args.patch, args.iters,
                                    args.dtype, d)
    elif args.microbench == "space_to_depth":
        rec = microbench_space_to_depth(args.batch, args.patch, args.iters,
                                        args.dtype, args.cin, args.cout, d)
    elif args.variant:
        rec = time_variant(args.variant, args.batch, args.patch, args.iters,
                           args.dtype, device=d)
    elif args.stage is not None:
        rec = time_stage_grad(args.stage, args.batch, args.patch,
                              args.iters, args.dtype, d)
    else:
        ap.error("need --variant, --stage or --microbench")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
