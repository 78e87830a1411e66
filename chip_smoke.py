#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fabric_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout (nvcc for the
CUDA ones, Triton for the others) and drives its two paths at full
BiDateNet width (13 bands, base 64, 2 classes, weights drawn from a seed):

- serving: holds each conv and fusion kernel against its plain PyTorch
  version at the serving shapes (the conv kernels on weights packed once,
  as the model passes them) and times each double-conv level both ways,
  fused and as two conv launches (the gate ``double_conv.supports``
  follows those times), then serves bi-date scenes (patch 64,
  batch 256, bf16, BatchNorm folded) through ``ScenePredictor.predict``
  and ``predict_many``, checks the masks against the same forward on the
  plain versions, and shows from the launch counters that the serve went
  through every kernel;
- int8: holds the int8 conv kernel against its plain version at the 18
  fused conv sites of one int8 forward, each in its mode (int8 out, the
  decoder's split form, bf16 out), timed beside the unfused raw launch +
  PyTorch epilogue, and exactly in its raw int32 mode at the 22 separate
  convs; the int8 Siamese fusion (with the encoder's max-pool) exactly at
  the 5 levels of one int8 forward in every output mode; the int8 matrix
  kernel at 131072 x 512 x 512 (int8 and bf16); runs the int8
  microbench, then serves the same scenes through
  ``ScenePredictor(quant="int8")`` (calibration on the first scene, clip
  probes after), checks ``predict_many`` against ``predict``, the mask
  against the same int8 forward on the plain versions of both int8
  kernels, the launch counters and that a forward makes no int32 tensor,
  and profiles one scene of each runner;
- the other tiled modes and the multi-date models: the 2048^2 pair at
  ``infer_overlap`` 32 (bf16 folded), unbanded and banded at
  ``overlap_band_rows`` 8 (masks equal; against the same overlap forward
  on the plain versions, flips only where the averaged probability is
  within 1/32 of 0.5), then at int8 (identical to the int8 forward on
  the plain versions); sixteen 512^2 pairs, bf16 and int8, through
  ``predict_many(pack="auto")`` (equal to ``predict`` pair by pair) and
  unpacked; UNetLSTM (base 64) and UNet3D (base 32) at T = 5 on a 1024^2
  stack through ``predict_multidate`` (the bi-date margin rule against
  the plain versions), four packed 512^2 stacks, and int8 (identical to
  the plain versions); each run's wall time, rate, peak memory and kernel
  launches against the count its tiles make;
- seamless fullconv: the 2048^2 pair through
  ``ScenePredictor(fullconv_band_rows=512)``, bf16 and int8: banded equal
  to one whole-scene forward on the card bit for bit, ``band_batch`` 4
  equal to 1, streamed from an ``np.memmap`` equal to in device memory,
  against the same fullconv forward on the plain versions (the bi-date
  margin rule; int8 identical), launches against 4 band forwards' count,
  each on-path kernel against its plain version at the band shapes
  (timed), at the ``band_batch`` 4 stack and at the widest band; a 1024 x
  8192 pair streamed from a memmap into an ``out=`` memmap, equal to the
  in-device run; UNetLSTM and UNet3D at T = 5 on a 1024^2 stack, bf16 and
  int8, banded = whole, streamed = in device memory; the card's idle share
  of one in-device and one streamed scene;
- multi-GPU serving on the one card: the 2048^2 pair with the scene split
  into H-bands over meshes of n = 2 and 4 shards (``[cuda:0] * n``), grid
  and fullconv (band 512, halo 128), bf16 and int8, each mask bit-equal
  to the single-device mask of its mode and each run's kernel launches
  equal to the single-device run's (they are added to the kernels line's
  counts); a shard's band bytes against the scene's, ms and Mpx/s (the
  shards share the card: neither memory per card nor scaling is
  measured);
- serving bundles and AOT artifacts: the main path's weights in a
  checkpoint, exported as bf16 and int8 bundles (``tools.export``, int8
  calibrated on the card) and served bit-equal to the checkpoint path
  (int8 at the bundle's scales, nothing calibrating); then each bucket's
  forward frozen with ``torch.export`` (the kernels as the
  ``fabric_tpu_torch::`` custom ops) for grid bf16, grid int8, fullconv
  (band 512) at the 2048^2 pair and 4 packed 512^2 pairs, served from
  ``aot_dir`` bit-equal to in-process with equal kernel launches counted
  at run time and every record's ``aot`` true, with export seconds,
  ``.pt2`` MiB, load seconds and the runner's time beside in-process; a
  grid artifact for the card exported by a CPU predictor; the custom
  ops' host cost a call; one ``cli.infer --bundle --aot_dir`` run; and
  each in a fresh process, ``ScenePredictor`` plus the first predict of
  the 2048^2 pair from the checkpoint, the bundle and the bundle with its
  artifact;
- the tools: a reference-layout torch checkpoint of seeded full-width
  weights, bare and with ``module.``, imported on the card
  (``tools.import_torch``) and served bit-equal to the same weights
  through the weight bridge, launches equal; ``tools.ablate``'s stages
  0-11 on the main path's first 256 tiles (stage 11 bit-equal to the
  folded forward and to the served mask, one forward's launches), each
  stage's ms and delta; ``tools.ablate_train``'s variants full, grad, fwd
  and eval_fwd at patch 96, batch 128, bf16 (the step's split, launches
  checked) and its space_to_depth and group_conv microbenches; one train
  step with ``lane_pack`` and with ``lane_pack_bwd`` against the direct
  step (fp32 and bf16 bounds, the packed convs counted) and their step
  times; the int8 shift-conv microbench (the raw int8 conv kernel against
  nine int8 GEMM launches, exact);
- float32 serving, with cuDNN's TF32 on (PyTorch's default) and TF32
  matmuls on (as a caller may set them) for the phase, both put back
  after: the fp32 forms of the conv kernels (rows 1, 2; 3xTF32) at the
  fp32 path's shapes against their plain versions (relative L2 <= 1e-5,
  max |diff| <= 1e-4 of the largest output), timed beside cuDNN's fp32
  conv with TF32 off and the 3xTF32 bound (three TF32 products per
  float32 product at 495 TFLOP/s), each level where the fused kernel fits
  also as two fp32 conv launches (bit-equal; the ``gate f32`` lines), row
  1 at a fullconv band's 18 shapes (the ``fullconv kernel`` fp32 line);
  the int8 conv's float32 modes at the 18 sites and the fusion
  kernel in fp32 at its 5 levels (identical); what the TF32 repair costs
  an fp32 BiDateNet train step (batch 128, patch 96; the ``tf32 repair
  cost`` line: its convs through ``ops/fp32_conv.py`` against plain
  ``F.conv2d`` in TF32); the 2048^2 pair served grid exact (launches
  against the fp32 gate's count, no bf16 launch, flips only within 1e-4
  of the logit scale, predict and runner Mpx/s) and int8 (identical to
  the plain int8 forward), fullconv at band 512 (banded = whole),
  UNetLSTM (base 64) and UNet3D (base 32) at T = 3 on a 512^2 stack, and
  from an fp32 bundle (= the fp32 serve);
- training: writes a synthetic OSCD-layout dataset (four ~1024^2 cities,
  one for validation) and runs ``train.loop.train`` (tversky + SGD, patch
  96, batch 128, bf16) for 2 epochs of 20 steps with validation, scene
  inference of the validation city and periodic checkpoints; the launch
  counters show the eval-BatchNorm and fusion kernels ran, and the patch
  pipeline, the step and a periodic save are timed apart.  Then it holds
  the eval-BatchNorm kernel against its plain version at every shape of
  the eval forward (bf16 and fp32, without and with the conv bias it
  fuses; timed back to back and alone, from a CUDA graph's replay), the
  fused gradient against autograd,
  one fp32 train step on the card against the same step on the CPU, and
  serves the trained checkpoint folded (conv kernels) and unfolded
  (eval-BatchNorm kernel) on the validation city, and runs
  ``tools.validate_int8`` on it (its own gates decide);
- the rest of the training path: the loop's batches from the prefetch
  thread and from N worker processes (N from ``os.cpu_count()``), the
  first 3 hashed and compared, each source timed alone and with the
  train step, and one batch's H2D copy; one train step with and without
  ``remat`` (gradients within a stated bound, BatchNorm statistics
  equal, peak memory), four micro steps at ``grad_accum_steps=2``; a
  short run mirrored to a ``file://`` ``output_store`` and resumed from
  the store URI bit-exactly; and ``cli.evaluate`` on the training run's
  best checkpoint, its dataset given as a ``.tar.gz`` of the validation
  city, which must reproduce the loop's validation metrics for that
  checkpoint;
- data-parallel training on the one card: ``train.loop.train`` in 2
  ranks over gloo (NCCL refuses two ranks on one card), BiDateNet base
  64, patch 96, global batch 128, tversky + SGD, fp32, 3 steps with
  validation and scene inference, against the same run in 1 process:
  loss, parameters and running statistics within the card-vs-CPU step's
  bounds, the ranks equal, rank 0 alone writing; the ranks' rate is
  printed as two ranks sharing one card; then one step over NCCL at world
  size 1 through ``parallel.distributed.maybe_initialize``;
- the spatial and model mesh axes on the one card: ``train.loop.train``
  over gloo ranks, each holding its half of every patch's height (the
  convs' halo rows exchanged over the spatial group), fp32, tversky +
  SGD, validation and rank 0's scene inference: BiDateNet base 64 at
  patch 96, global batch 128, 3 steps, at mesh (1, 2, 1) and (2, 2, 1)
  against data-parallel training's 1-process run, and UNetLSTM base 64
  at T = 5, global batch 32, 2 steps, at (1, 2, 2) against its own; each
  within the same bounds, the ranks equal, rank 0 alone writing; each
  rank's launches of the fusion and eval-BatchNorm kernels (added to the
  kernels line's counts), its peak memory against 1 process's and each
  run's wall time;
- multi-date training: writes a 5-date synthetic dataset of the same
  cities (while the two phases above wait on their ranks) and runs
  ``train.loop.train`` for UNetLSTM (base 64, with ``local_upsample``,
  so that its eval gate conv is the signed conv-kernel launch) and
  UNet3D (base 32) at T = 5 (tversky + SGD, bf16, patch 96, batch 128
  unless the memory reckoning it prints says otherwise, 2 epochs of 10
  steps, validation, scene inference of the validation city,
  a checkpoint, worker loaders sized to ``/dev/shm`` by a printed
  reckoning, and a ``profile_dir`` trace of the first 3 steps, whose top
  device kernels it prints); the launch counters must show the
  eval-BatchNorm kernel in every validation and scene forward (and
  UNetLSTM's signed gate conv); it prints the steady-epoch rate, the
  loop's step percentiles, the device-resident step and the peak memory,
  checks that the loss falls, holds one fp32 step of each family on the
  card against the CPU's (base 16, T = 3) and runs ``cli.evaluate`` on
  each best checkpoint, which must reproduce the loop's metrics.

Prints the card, each check, per-kernel times beside their bound and a
library yardstick, the serving rate and the training rate, a JSON
``kernels`` line, and as its last line ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_TENSOR = 989e12  # FLOP/s, H100 SXM dense (NVIDIA data sheet)
PEAK_INT8_TENSOR = 1979e12  # OP/s, H100 SXM dense int8 (NVIDIA data sheet)
PEAK_ELEMENTWISE = 67e12   # FLOP/s, H100 SXM outside the tensor cores
PEAK_TF32_TENSOR = 495e12  # FLOP/s, H100 SXM dense TF32 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # B/s, H100 SXM HBM3
SEED = 0
SCENE = 2048               # side of the main scene
PATCH, BATCH, BASE = 64, 256, 64
# training phase: patch, batch, epochs x steps, the synthetic cities
T_PATCH, T_BATCH, T_EPOCHS, T_STEPS = 96, 128, 2, 20
T_CITIES = {"alpha": (1024, 1024), "beta": (960, 1088),
            "gamma": (1088, 960), "val": (1024, 1024)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host time of one fn() call, in microseconds: calls enqueued back to
    back on the host clock, the card left to catch up afterwards (a
    kernel shorter than its call never fills the launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of fn() per call without the host's launch cost: the
    replay of a CUDA graph of reps calls, timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float, peak_ops: float) -> tuple[float, float]:
    """(ms if bound by operations, ms if bound by bytes)."""
    return 1e3 * ops / peak_ops, 1e3 * nbytes / PEAK_BYTES


LEVEL_SIDE = {"inc": 1, "down1": 2, "down2": 4, "down3": 8, "down4": 16,
              "up1": 8, "up2": 4, "up3": 2, "up4": 1}


def level_shapes(n_channels: int):
    """(level, N, side, Cin, Cout) of the nine DoubleConv blocks of one
    forward of BATCH tiles (the encoder sees both dates stacked)."""
    from fabric_tpu_torch.weights import block_channels

    return [(level, 2 * BATCH if level == "inc" or level.startswith("down")
             else BATCH, PATCH // LEVEL_SIDE[level], cin, cout)
            for level, (cin, cout) in block_channels(n_channels,
                                                     BASE).items()]


def main_path_calls(n_channels: int):
    """The kernel calls of one forward of BATCH tiles: (kernel, shape,
    level), each DoubleConv block where the gate sends it."""
    from fabric_tpu_torch.ops.double_conv import supports

    calls = []
    for level, n, s, cin, cout in level_shapes(n_channels):
        if supports(s, s, cin, cout, cout):
            calls.append(("double_conv3x3_bias_relu",
                          (n, s, s, cin, cout, cout), level))
        else:
            calls.append(("conv3x3_bias_relu", (n, s, s, cin, cout), level))
            calls.append(("conv3x3_bias_relu", (n, s, s, cout, cout), level))
    for i, c in enumerate((BASE, 2 * BASE, 4 * BASE, 8 * BASE, 8 * BASE)):
        s = PATCH >> i
        calls.append(("fused_mul_relu", (BATCH, s, s, c), f"f{i + 1}"))
    return calls


def gate_calls(n_channels: int):
    """The fused kernel at every level where it fits but the gate sends the
    block to two conv launches: timed both ways, not on the path."""
    from fabric_tpu_torch.ops.double_conv import fits, supports

    return [("double_conv3x3_bias_relu", (n, s, s, cin, cout, cout), level)
            for level, n, s, cin, cout in level_shapes(n_channels)
            if fits(s, s, cin, cout, cout)
            and not supports(s, s, cin, cout, cout)]


def check_kernels(calls, reps: int = 5, device_rng: bool = False):
    """Each kernel against its plain version on the card, and its time
    (``reps`` launches) beside the plain version's, a library call's and
    its bound.  The conv kernels take their weights prepacked, as the main
    path does; each double-conv level is also timed as two
    conv3x3_bias_relu launches, the gate's alternative.  Calls on the main
    path come first; the rest (``gate_calls``) are timed for the gate
    only.  ``device_rng`` draws the inputs on the card (band-sized
    tensors take seconds each on the host)."""
    from fabric_tpu_torch.ops import conv, double_conv, fused

    dev = torch.device("cuda")
    g = torch.Generator(dev if device_rng else "cpu").manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=g.device)
                * scale).to(dev, dtype)

    def lib_conv(x, w, b):  # cuDNN via F.conv2d on a channels-last view
        return torch.relu_(F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1))

    def lib_weight(k):
        return k.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    rows = []
    for name, shape, level in calls:
        two_ms = None
        if name == "fused_mul_relu":
            a, b = randn(*shape, dtype=torch.bfloat16), randn(
                *shape, dtype=torch.bfloat16)
            args = (a, b)
            kern, plain = fused.fused_mul_relu, fused.fused_mul_relu_reference
            lib = lambda: torch.relu(a * b)  # noqa: E731
            numel = a.numel()
            ops, nbytes, peak = 2 * numel, 3 * 2 * numel, PEAK_ELEMENTWISE
            tol = 0.0  # one product and one max, one rounding: exact
        elif name == "conv3x3_bias_relu":
            n, h, w, cin, cout = shape
            x = randn(n, h, w, cin, dtype=torch.bfloat16)
            k, b = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5), randn(
                cout, scale=0.1)
            args = (x, k, b)
            pk = conv.pack_weight(k)
            kern = lambda *a: conv.conv3x3_bias_relu(*a, pk)  # noqa: E731
            plain = conv.conv3x3_bias_relu_reference
            wl, bl = lib_weight(k), b.to(torch.bfloat16)
            lib = lambda: lib_conv(x, wl, bl)  # noqa: E731
            ops = 2 * n * h * w * 9 * cin * cout
            nbytes = 2 * n * h * w * (cin + cout) + 2 * 9 * cin * cout \
                + 4 * cout
            peak, tol = PEAK_BF16_TENSOR, None
        else:
            n, h, w, cin, cmid, cout = shape
            x = randn(n, h, w, cin, dtype=torch.bfloat16)
            w1, b1 = randn(3, 3, cin, cmid, scale=(9 * cin) ** -.5), randn(
                cmid, scale=0.1)
            w2, b2 = randn(3, 3, cmid, cout, scale=(9 * cmid) ** -.5), \
                randn(cout, scale=0.1)
            args = (x, w1, b1, w2, b2)
            p1, p2 = conv.pack_weight(w1), conv.pack_weight(w2)
            kern = lambda *a: double_conv.double_conv3x3_bias_relu(  # noqa
                *a, (p1, p2))
            plain = double_conv.double_conv3x3_bias_relu_reference
            wl1, bl1, wl2, bl2 = (lib_weight(w1), b1.to(torch.bfloat16),
                                  lib_weight(w2), b2.to(torch.bfloat16))
            lib = lambda: lib_conv(lib_conv(  # noqa: E731
                x, wl1, bl1).permute(0, 2, 3, 1), wl2, bl2)
            ops = 2 * n * h * w * 9 * (cin * cmid + cmid * cout)
            nbytes = 2 * n * h * w * (cin + cout) + 2 * 9 * (
                cin * cmid + cmid * cout) + 4 * (cmid + cout)
            peak, tol = PEAK_BF16_TENSOR, None
            two_ms = device_ms(lambda: conv.conv3x3_bias_relu(
                conv.conv3x3_bias_relu(x, w1, b1, p1), w2, b2, p2), reps)
        got = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if tol is None:
            # kernel and plain version round the same fp32 sums (taken in
            # another order) to bf16: one ulp (<= 2^-7 relative) of the
            # largest output for a conv, a few more for the double conv,
            # whose bf16 intermediate may itself differ by one ulp
            tol = (1 if name == "conv3x3_bias_relu" else 4) * 2 ** -7 * scale
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        kms = device_ms(lambda: kern(*args), reps)
        pms = device_ms(lambda: plain(*args), max(reps // 2, 1))
        lms = device_ms(lib, reps)
        t_ops, t_bytes = bound(ops, nbytes, peak)
        rate = (f", {ops / kms / 1e9:.1f} TFLOP/s" if peak ==
                PEAK_BF16_TENSOR else "")
        two = ("" if two_ms is None else
               f", as two conv3x3_bias_relu launches {two_ms:.3f} ms")
        print(f"kernel {name} {level} {shape}: max_abs_err {err:.4g} "
              f"max_rel_err {err / max(scale, 1e-30):.3g} tol {tol:.4g} "
              f"{'ok' if ok else 'MISMATCH'} | {kms:.3f} ms{rate}, plain "
              f"{pms:.3f} ms, library {lms:.3f} ms, bound "
              f"{max(t_ops, t_bytes):.3f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}){two}",
              flush=True)
        if not ok:
            fail(f"{name} {shape} disagrees with its plain version")
        rows.append(dict(name=name, level=level, err=err, ms=kms,
                         plain_ms=pms, library_ms=lms, t_ops=t_ops,
                         t_bytes=t_bytes, two_conv_ms=two_ms))
        del args, got, ref
    return rows


@contextlib.contextmanager
def plain_versions():
    """Run the model on the kernels' plain PyTorch versions (the blocks
    look the ops up on their modules at call time)."""
    from fabric_tpu_torch.ops import bn_relu, conv, double_conv, fused

    saved = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
             fused.fused_mul_relu, bn_relu.bn_relu_inference)
    # the blocks pass prepacked weights, which the plain versions ignore
    conv.conv3x3_bias_relu = lambda x, k, b, packed=None: \
        conv.conv3x3_bias_relu_reference(x, k, b)
    double_conv.double_conv3x3_bias_relu = \
        lambda x, w1, b1, w2, b2, packed=None: \
        double_conv.double_conv3x3_bias_relu_reference(x, w1, b1, w2, b2)
    fused.fused_mul_relu = fused.fused_mul_relu_reference
    bn_relu.bn_relu_inference = bn_relu.bn_relu_inference_reference
    try:
        yield
    finally:
        (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
         fused.fused_mul_relu, bn_relu.bn_relu_inference) = saved


def plain_mask_and_margin(model, d1, d2, dtype=torch.bfloat16):
    """Mask and fp32 logit margin |l1 - l0| of the forward on the plain
    versions, over the same grid and stitch as the predictor (tiles in
    ``dtype``, the compute dtype)."""
    from fabric_tpu_torch.infer.device_tiling import (_gather_tiles,
                                                      _plan_grid, _stitch)

    h, w = d1.shape[:2]
    ys, xs, k, pad, n_chunks = _plan_grid(h, w, PATCH, PATCH, BATCH)
    if pad:
        fail("the main scene should tile into whole chunks")
    t1, t2 = (_gather_tiles(torch.from_numpy(d).cuda().to(dtype), ys, xs,
                            PATCH) for d in (d1, d2))
    masks, margins, first = [], [], None
    with plain_versions(), torch.inference_mode():
        for i in range(n_chunks):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            logits = model(t1[sl], t2[sl])
            first = logits if first is None else first
            masks.append(logits.argmax(-1).to(torch.uint8))
            margins.append((logits[..., 1] - logits[..., 0]).abs())
    with torch.inference_mode():
        kernel_first = model(t1[:BATCH], t2[:BATCH])
    stitch = lambda o: _stitch(o, ys, xs, k, h, w, PATCH)  # noqa: E731
    return (stitch(torch.cat(masks)).cpu().numpy(),
            stitch(torch.cat(margins)).cpu().numpy(), first, kernel_first)


def eval_bn_shapes():
    """(level, x shape) of the 9 BatchNorm levels of one eval forward at
    the training phase's eval batch; each level runs the kernel twice."""
    from fabric_tpu_torch.weights import block_channels

    side = LEVEL_SIDE
    return [(level, (2 * T_BATCH if level == "inc" or level.startswith(
        "down") else T_BATCH, T_PATCH // side[level], T_PATCH // side[level],
        cout)) for level, (_, cout) in block_channels(13, BASE).items()]


def check_bn_kernel():
    """The eval-BatchNorm kernel against its plain version at every shape
    of the eval forward, bf16 and fp32, without and with the conv bias
    (the form the unfolded eval forward runs), with its time back to back
    (CUDA events over launches made by the host: what the eval loop waits
    for) and its device time alone (a CUDA graph's replay), beside its
    byte bound, the plain version's time and F.batch_norm + relu_'s (two
    calls; with the conv bias folded into the mean beforehand).  Returns
    the bf16 conv-bias rows, one per launch of an eval forward."""
    from fabric_tpu_torch.ops import bn_relu

    g = torch.Generator().manual_seed(SEED)
    rows, sums = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for level, shape in eval_bn_shapes():
            c = shape[-1]
            x = torch.randn(*shape, generator=g).cuda().to(dtype)
            scale, bias, mean, cb = (torch.randn(c, generator=g).cuda()
                                     for _ in range(4))
            var = (torch.rand(c, generator=g) + 0.1).cuda()
            xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view
            for conv_bias in (None, cb):
                args = (x, scale, bias, mean, var, 1e-5, conv_bias)
                got = bn_relu.bn_relu_inference(*args)
                torch.cuda.synchronize()
                ref = bn_relu.bn_relu_inference_reference(*args)
                diff = (got.float() - ref.float()).abs()
                err = diff.max().item()
                n_diff = int((diff > 0).sum())
                # element by element, the tolerance the Triton kernel was
                # held to (it fused x*s + t into one FMA): the fp32 values
                # within 2^-22 (|z s| + |t|); bf16 adds one ulp of the
                # output (2^-7 of the larger output, at most)
                z = x.float() if conv_bias is None else (
                    x + conv_bias.to(dtype)).float()
                s, t = bn_relu._scale_shift(scale, bias, mean, var, 1e-5)
                tol = 2.0 ** -22 * (z.abs() * s.abs() + t.abs())
                if dtype == torch.bfloat16:
                    tol += 2.0 ** -7 * torch.maximum(got.float().abs(),
                                                     ref.float().abs())
                worst = (diff / tol.clamp_min(1e-30)).max().item()
                ok = bool((diff <= tol).all()) and bool(
                    torch.isfinite(got.float()).all())
                del diff, tol, z
                kms = device_ms(lambda: bn_relu.bn_relu_inference(*args), 30)
                gms = graph_ms(lambda: bn_relu.bn_relu_inference(*args), 10)
                hus = host_us(lambda: bn_relu.bn_relu_inference(*args), 30)
                pms = device_ms(lambda: bn_relu.bn_relu_inference_reference(
                    *args), 3)
                lmean = mean if conv_bias is None else mean - conv_bias
                lms = device_ms(lambda: torch.relu_(F.batch_norm(
                    xc, lmean, var, scale, bias, training=False, eps=1e-5)),
                    30)
                nv = 4 if conv_bias is None else 5
                nbytes = 2 * x.numel() * x.element_size() + nv * c * 4
                t_ops, t_bytes = bound(3 * x.numel(), nbytes,
                                       PEAK_ELEMENTWISE)
                form = "" if conv_bias is None else " conv_bias"
                print(f"kernel bn_relu_inference{form} {level} "
                      f"{tuple(shape)} {str(dtype)[6:]}: max_abs_err "
                      f"{err:.4g} ({n_diff} of {x.numel()} differ), largest "
                      f"error / per-element tol {worst:.3g} "
                      f"{'ok' if ok else 'MISMATCH'} | back to back "
                      f"{kms:.4f} ms, device alone (graph) {gms:.4f} ms, "
                      f"host {hus:.1f} us a call, "
                      f"plain {pms:.4f} ms, library {lms:.4f} ms "
                      f"(F.batch_norm + relu_, two calls), bound "
                      f"{max(t_ops, t_bytes):.4f} ms (bytes: x read once, y "
                      f"written once, {nv} x C fp32)", flush=True)
                if not ok:
                    fail(f"bn_relu_inference{form} {shape} {dtype} "
                         "disagrees with its plain version")
                key = (str(dtype)[6:], form.strip() or "no conv_bias")
                acc = sums.setdefault(key, [0.0] * 5 + [[]])
                for i, v in enumerate((kms, gms, pms, lms, max(t_ops,
                                                               t_bytes))):
                    acc[i] += 2 * v  # conv1's and conv2's epilogue
                if kms >= lms:
                    acc[5].append(level)
                if dtype == torch.bfloat16 and conv_bias is not None:
                    row = dict(name="bn_relu_inference", err=err, ms=kms,
                               plain_ms=pms, library_ms=lms, t_ops=t_ops,
                               t_bytes=t_bytes, graph_ms=gms)
                    rows += [row, row]
                del args, got, ref
            del x, xc
    for (dt, form), (kms, gms, pms, lms, bms, slower) in sums.items():
        print(f"bn_relu_inference {dt} {form}, summed over the 18 launches "
              f"of one eval forward of {T_BATCH} tiles at patch {T_PATCH}: "
              f"back to back {kms:.3f} ms, device alone (graph) {gms:.3f} "
              f"ms, bound {bms:.3f} ms, plain {pms:.3f} ms, library "
              f"{lms:.3f} ms; levels where the library is as fast or faster "
              f"back to back: {slower or 'none'}", flush=True)
    return rows


def fuse_s8_shapes(n: int = BATCH, h: int = PATCH, w: int = PATCH):
    """(level, (2n, h, w, C)) of the 5 siamese_fuse_s8 launches of one
    int8 forward of n images of h x w (BATCH tiles by default; both dates
    stacked)."""
    return [(f"f{i + 1}", (2 * n, h >> i, w >> i, c))
            for i, c in enumerate((BASE, 2 * BASE, 4 * BASE, 8 * BASE,
                                   8 * BASE))]


def check_fuse_s8_kernel():
    """siamese_fuse_s8 at the 5 levels of one int8 forward of BATCH tiles,
    bit-exact against its plain version (the PyTorch lines the forward ran
    before: int32 products, round, clamp, cast, and the int8 max-pool) in
    every output mode, with and without the pool, at a scale that lands
    on .5 ties and one that clips; the forward's form (int8 out and the
    pool for f1..f4, bf16 out for f5) timed beside its byte bound and the
    plain version.  Returns those rows."""
    from fabric_tpu_torch.ops import fuse_s8

    g = torch.Generator().manual_seed(SEED)
    rows = []
    for i, (level, shape) in enumerate(fuse_s8_shapes()):
        a = torch.randint(-127, 128, shape, generator=g,
                          dtype=torch.int8).cuda()
        m_path = (3.1 / 127) ** 2 / (5.3 / 127) if i < 4 else (4.7 / 127) ** 2
        checked = 0
        for m in (1.0 / 64, m_path):
            for out, pool in ((torch.int8, True), (torch.bfloat16, False),
                              (torch.bfloat16, True), (torch.float32, False)):
                f, p = fuse_s8.siamese_fuse_s8(a, m, out, pool)
                torch.cuda.synchronize()
                rf, rp = fuse_s8.siamese_fuse_s8_reference(a, m, out, pool)
                if not (torch.equal(f, rf) and (p is None) == (not pool)
                        and (not pool or torch.equal(p, rp))):
                    fail(f"siamese_fuse_s8 {level} {shape} m={m} {out} "
                         f"pool={pool} differs from its plain version")
                checked += 1
                del f, p, rf, rp
        # f5 leaves in the serving compute dtype, bf16
        out, pool = (torch.int8, True) if i < 4 else (torch.bfloat16, False)
        args = (a, m_path, out, pool)
        kms = device_ms(lambda: fuse_s8.siamese_fuse_s8(*args), 10)
        gms = graph_ms(lambda: fuse_s8.siamese_fuse_s8(*args), 10)
        pms = device_ms(lambda: fuse_s8.siamese_fuse_s8_reference(*args), 3)
        n2, h, w, c = shape
        nbytes = a.numel() + (n2 // 2) * h * w * c * (
            1 if out == torch.int8 else 2) + (
            n2 * (h // 2) * (w // 2) * c if pool else 0)
        t_ops, t_bytes = bound(3 * (n2 // 2) * h * w * c, nbytes,
                               PEAK_ELEMENTWISE)
        print(f"kernel siamese_fuse_s8 {level} {shape} {str(out)[6:]} out"
              f"{', pool' if pool else ''}: identical to its plain version "
              f"in {checked} forms (int8 + pool, bf16, bf16 + pool, fp32; "
              f"m = 1/64 and {m_path:.6g}) | back to back {kms:.4f} ms, "
              f"device alone (graph) {gms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms (bytes: a read once, f and the "
              f"pool written once)", flush=True)
        rows.append(dict(name="siamese_fuse_s8", err=0.0, ms=kms,
                         plain_ms=pms, library_ms=None, t_ops=t_ops,
                         t_bytes=t_bytes, graph_ms=gms))
        del a
    print(f"siamese_fuse_s8 per {BATCH}-tile int8 forward: "
          f"{sum(r['ms'] for r in rows):.4f} ms back to back, "
          f"{sum(r['graph_ms'] for r in rows):.4f} ms device alone over 5 "
          f"launches, bound "
          f"{sum(max(r['t_ops'], r['t_bytes']) for r in rows):.4f} ms, plain"
          f" (the PyTorch lines it replaced) "
          f"{sum(r['plain_ms'] for r in rows):.4f} ms", flush=True)
    return rows


def check_fused_grad():
    """The fused Function's gradients against autograd of relu(a*b) on
    the card, exactly, at the first fusion's training shape."""
    from fabric_tpu_torch.ops import fused

    g = torch.Generator().manual_seed(SEED)
    a0, b0, go = (torch.randn(T_BATCH, T_PATCH, T_PATCH, BASE,
                              generator=g).cuda().to(torch.bfloat16)
                  for _ in range(3))
    a1, b1 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    fused.FusedMulRelu.apply(a1, b1).backward(go)
    a2, b2 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    torch.relu(a2 * b2).backward(go)
    same = torch.equal(a1.grad, a2.grad) and torch.equal(b1.grad, b2.grad)
    print(f"fused gradient vs autograd of relu(a*b), bf16 "
          f"{tuple(a0.shape)}: {'equal' if same else 'DIFFERENT'}",
          flush=True)
    if not same:
        fail("the fused Function's gradients differ from autograd's")


def train_phase(root: str):
    """Run train.loop.train on a synthetic dataset through the normal entry
    point; returns (cfg, state, history, launches, eval forwards, tracker
    records)."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.data.oscd import patch_grid
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.ops import bn_relu, conv, double_conv, fused
    from fabric_tpu_torch.train.loop import train

    cfg = Config(dataset_dir=os.path.join(root, "data"),
                 weight_dir=os.path.join(root, "weights"),
                 log_dir=os.path.join(root, "logs"), patch_size=T_PATCH,
                 stride=32, batch_size=T_BATCH, epochs=T_EPOCHS,
                 steps_per_epoch=T_STEPS, checkpoint_every=5,
                 learning_rate=0.05, loss_function="tversky",
                 optimizer="sgd", dtype="bfloat16", model_base=BASE,
                 validation_cities=["val"], num_workers=4, seed=SEED)
    t0 = time.perf_counter()
    generate_synthetic_dataset(cfg.dataset_dir, cfg, cities=list(T_CITIES),
                               sizes=list(T_CITIES.values()), seed=SEED)
    print(f"synthetic dataset {T_CITIES} written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, bn_relu.bn_relu_inference)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    state, history = train(cfg)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    n = {c: len(patch_grid(hw, T_PATCH, cfg.stride))
         for c, hw in T_CITIES.items()}
    n_train = sum(v for c, v in n.items() if c != "val")
    steps = T_EPOCHS * min(T_STEPS, -(-n_train // T_BATCH))
    tiles = 1  # the scene grid plus its edge stops
    for side in T_CITIES["val"]:
        tiles *= -(-side // T_PATCH)
    evals = T_EPOCHS * (min(T_STEPS, -(-n["val"] // T_BATCH))
                        + -(-tiles // T_BATCH))
    expected = {"conv3x3_bias_relu": 0, "double_conv3x3_bias_relu": 0,
                "fused_mul_relu": 5 * (steps + evals),
                "bn_relu_inference": 18 * evals}
    print(f"train.loop.train: {wall:.1f} s wall; kernels launched "
          f"{launches} (expected {expected}: {steps} train steps, {evals} "
          f"eval forwards)", flush=True)
    if launches != expected:
        fail("training did not go through the kernels as planned")
    run_dir = os.path.join(cfg.log_dir, os.listdir(cfg.log_dir)[0])
    with open(os.path.join(run_dir, "metrics.jsonl")) as fin:
        records = [json.loads(line) for line in fin]
    return cfg, state, history, launches, evals, records


def card_vs_cpu_step():
    """One fp32 train step (TF32 off) at full width, batch 4 at patch 96,
    on the card and on the CPU from the same weights and batch."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step
    from fabric_tpu_torch.weights import init_variables, variables_of

    cfg = Config(model_base=BASE, patch_size=T_PATCH, batch_size=4,
                 dtype="float32", learning_rate=0.05)
    variables = init_variables(13, 2, BASE,
                               torch.Generator().manual_seed(SEED + 1))
    rng = np.random.RandomState(SEED)
    img1 = rng.randn(4, T_PATCH, T_PATCH, 13).astype(np.float32)
    label = (rng.rand(4, T_PATCH, T_PATCH) < 0.3).astype(np.int32)
    img2 = img1 + 0.3 * rng.randn(*img1.shape).astype(np.float32)
    img2[label == 1] += 1.5
    batch = {"img1": img1, "img2": img2, "label": label,
             "weight": np.ones(4, np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev, fold_bn=False, variables=variables,
                            train=True)
        state = create_state(cfg, model)
        t0 = time.perf_counter()
        _, stats = make_train_step(model, get_loss_fn(cfg))(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        loss = stats["loss"].item()
        out[dev] = (loss, variables_of(model), time.perf_counter() - t0)
    (l_gpu, (p_gpu, s_gpu), t_gpu), (l_cpu, (p_cpu, s_cpu), t_cpu) = (
        out["cuda"], out["cpu"])

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    p0 = dict(leaves(variables[0]))
    pc, pg = dict(leaves(p_cpu)), dict(leaves(p_gpu))
    sc, sg = dict(leaves(s_cpu)), dict(leaves(s_gpu))
    step_max = max(np.abs(pc[k] - p0[k]).max() for k in pc)
    p_err, p_worst = max((np.abs(pg[k] - pc[k]).max(), k) for k in pc)
    s_err = max((np.abs(sg[k] - sc[k]) / (np.abs(sc[k]) + 1e-3)).max()
                for k in sc)
    l_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    # fp32 convolutions and sums in another order on the card (cuDNN, TF32
    # off) than on the CPU, over 19 conv layers forward and backward.
    # Train-mode BatchNorm takes the variance as E[x^2] - E[x]^2, which
    # cancels where the mean is large against the spread, so its
    # statistics, and the gradients through them, keep fewer bits than
    # the loss: the loss within 1e-5 relative, every updated parameter
    # within 1e-2 of the largest update, the BatchNorm running statistics
    # within 1e-3 relative (1e-3 floor)
    ok = (l_err <= 1e-5 and p_err <= 1e-2 * step_max and s_err <= 1e-3)
    print(f"fp32 train step, card vs CPU (full width, batch 4, patch "
          f"{T_PATCH}): loss {l_gpu:.7f} vs {l_cpu:.7f} (rel {l_err:.3g}, "
          f"bound 1e-5); params max diff {p_err:.3g} at {p_worst} (bound "
          f"1e-2 x largest update {step_max:.4g}); BN stats rel diff "
          f"{s_err:.3g} (bound 1e-3); card {t_gpu:.2f} s with first-call "
          f"set-up, CPU {t_cpu:.2f} s: {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail("the train step on the card disagrees with the CPU's")


def cross_check_serving(cfg):
    """The trained checkpoint served folded (ScenePredictor, conv kernels)
    and unfolded (infer_city, eval-BatchNorm kernel) on the validation
    city: masks agree but for near-ties."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.data.oscd import load_city
    from fabric_tpu_torch.infer.device_tiling import (_gather_tiles,
                                                      _plan_grid, _stitch)
    from fabric_tpu_torch.infer.runner import infer_city, scene_dims
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.models import build_model

    city = "val"
    path = ckpt.resolve(cfg.weight_dir)
    d1, d2 = load_city(cfg.dataset_dir, city, cfg,
                       out_shape=scene_dims(cfg.dataset_dir, city))
    folded = ScenePredictor(cfg, checkpoint=path, bucket=512,
                            device="cuda").predict(d1, d2)
    model = build_model(cfg, "cuda", fold_bn=False,
                        variables=ckpt.load_variables(path))
    unfolded = infer_city(model, cfg, city)
    h, w = d1.shape[:2]
    ys, xs, k, _, _ = _plan_grid(h, w, T_PATCH, T_PATCH, T_BATCH)
    t1, t2 = (_gather_tiles(torch.from_numpy(d).cuda().to(torch.bfloat16),
                            ys, xs, T_PATCH) for d in (d1, d2))
    with torch.inference_mode():
        logits = torch.cat([model(t1[i:i + T_BATCH], t2[i:i + T_BATCH])
                            for i in range(0, k, T_BATCH)])
    margin = _stitch((logits[..., 1] - logits[..., 0]).abs(), ys, xs, k, h,
                     w, T_PATCH).cpu().numpy()
    scale = logits.abs().max().item()
    flips = folded != unfolded
    worst = float(margin[flips].max()) if flips.any() else 0.0
    print(f"trained checkpoint {os.path.basename(path)} on the {h}x{w} "
          f"validation city, folded (ScenePredictor) vs unfolded "
          f"(infer_city): agreement {1 - flips.mean():.6f} "
          f"({int(flips.sum())} flips, largest margin at a flip "
          f"{worst:.4g}, bound {scale / 16:.4g}); change share "
          f"{unfolded.mean():.4f}", flush=True)
    if unfolded.shape != (h, w) or worst > scale / 16 or flips.mean() > 1e-3:
        fail("folded and unfolded serving of the trained checkpoint "
             "disagree")
    return model


def loop_split(cfg, state, step):
    """What a loop step holds, timed apart on the host clock over one
    epoch's batches as the loop draws them (the last epoch's seed): the
    patch pipeline alone (batches prefetched to the card, no step), the
    pipeline with the train step and no periodic saves, and one periodic
    save (median of 3, the card idle first).  Returns ms per batch, per
    step and per save."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.data.oscd import full_load, get_train_val_metadata
    from fabric_tpu_torch.data.pipeline import (PatchSampler, batch_iterator,
                                                prefetch_to_device)

    data = full_load(cfg.dataset_dir, cfg,
                     max_workers=cfg.num_workers or None)
    train_md, _ = get_train_val_metadata(
        cfg.dataset_dir, cfg.validation_cities, cfg.patch_size, cfg.stride)

    def ms_per_batch(consume) -> float:
        batches = prefetch_to_device(batch_iterator(
            PatchSampler(data, train_md, cfg.patch_size,
                         augment=cfg.augmentation),
            cfg.batch_size, shuffle=cfg.shuffle_train, pad_mode="wrap",
            seed=cfg.seed + T_EPOCHS - 1, max_batches=cfg.steps_per_epoch),
            "cuda", size=cfg.prefetch)
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for batch in batches:
            consume(batch)
            n += 1
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    pipe_ms = ms_per_batch(lambda b: None)
    nosave_ms = ms_per_batch(lambda b: step(state, b))
    saves = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(state, os.path.join(os.path.dirname(cfg.weight_dir),
                                      "split"), T_EPOCHS - 1, tag="periodic",
                  metadata={"periodic": True, "batches_done": 5},
                  keep_last=cfg.keep_last)
        saves.append(1e3 * (time.perf_counter() - t0))
    return pipe_ms, nosave_ms, statistics.median(saves)


def report_training(cfg, state, history, records, smi, model):
    """Print the training rate and step, eval-forward and epoch times;
    the device-resident step time (one batch kept on the card) beside the
    loop's host-clock step time splits host from device."""
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.train.steps import make_train_step

    epochs = {r["_step"]: r for r in records if "train_examples_per_sec" in r}
    seconds = {r["_step"]: r["epoch_seconds"] for r in records
               if "epoch_seconds" in r}
    last = epochs[T_EPOCHS - 1]
    g = torch.Generator().manual_seed(SEED)
    t1, t2 = (torch.randn(T_BATCH, T_PATCH, T_PATCH, 13, generator=g).cuda()
              for _ in range(2))
    with torch.inference_mode():
        eval_ms = device_ms(lambda: model(t1, t2), 5)
    batch = {"img1": t1, "img2": t2,
             "label": (t1[..., 0] > t2[..., 0]).to(torch.int32),
             "weight": torch.ones(T_BATCH, device=t1.device)}
    step = make_train_step(state.model, get_loss_fn(cfg))
    step_ms = device_ms(lambda: step(state, batch), 5)
    losses = [h["cd_losses"] for h in history["train"]]
    loop_ms = 1e3 * last["train_seconds"] / last["train_steps"]
    epoch_s = [round(seconds[e], 2) for e in sorted(seconds)]
    print(f"training rate ({smi}): {last['train_examples_per_sec']:.1f} "
          f"train examples/s in epoch {T_EPOCHS - 1} (steady state, after "
          f"epoch 0's warm-up; {epochs[0]['train_examples_per_sec']:.1f} in "
          f"epoch 0), patch {T_PATCH}, batch {T_BATCH}, full width, bf16, "
          f"tversky + SGD; {loop_ms:.1f} ms per train step in the loop "
          f"(host clock, pipeline included), {step_ms:.1f} ms with the "
          f"batch resident on the card (CUDA events); {eval_ms:.2f} ms per "
          f"eval forward of {T_BATCH} tiles (CUDA events); epoch seconds "
          f"{epoch_s}", flush=True)
    pipe_ms, nosave_ms, save_ms = loop_split(cfg, state, step)
    n_saves = T_STEPS // cfg.checkpoint_every
    print(f"loop step split (host clock, {smi}): patch pipeline alone "
          f"{pipe_ms:.1f} ms per batch; pipeline + train step, no periodic "
          f"saves {nosave_ms:.1f} ms per step; one periodic save "
          f"{save_ms:.1f} ms (median of 3, card idle first), x {n_saves} "
          f"saves per {T_STEPS} steps = {save_ms * n_saves / T_STEPS:.1f} ms "
          f"per step; the loop {loop_ms:.1f} ms per step", flush=True)
    print(f"train cd_losses per epoch {[round(v, 4) for v in losses]}; "
          f"validation cd_f1scores "
          f"{[round(v['cd_f1scores'], 4) for v in history['val']]}; scene F1 "
          f"{[round(v.get('val_scene_f1', -1), 4) for v in history['val']]}",
          flush=True)
    if history["status"] != "complete" or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        fail("training did not complete with a falling, finite loss")
    return step


def profile_runner(run, args, label: str, top: int = 8) -> None:
    """One scene (``run(*args)``) through a runner under torch.profiler:
    the card's busy time (the kernels' summed device time) against the
    wall clock, and the ``top`` kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    print(f"{label} under torch.profiler: card busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall (idle share {1 - busy_ms / wall_ms:.3f});"
          f" {len(kernels)} kernel names, {sum(e.count for e in kernels)} "
          f"launches, top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
              f"x{e.count}" for e in ranked[:top]), flush=True)


def int8_conv_shapes():
    """(site, (n, h, w, cin, cout)) of the 22 int8 convs of one int8
    forward of BATCH tiles as separate convs: two per encoder block (both
    dates), and per decoder block the skip and upsampled halves of conv1
    and conv2.  The raw (int32) mode is held exactly at these shapes."""
    from fabric_tpu_torch.weights import block_channels

    shapes = []
    for level, (cin, cout) in block_channels(13, BASE).items():
        s = PATCH // LEVEL_SIDE[level]
        if level.startswith("up"):
            shapes += [(f"{level}.conv1.{half}",
                        (BATCH, s, s, cin // 2, cout))
                       for half in ("skip", "up")]
            shapes.append((f"{level}.conv2", (BATCH, s, s, cout, cout)))
        else:
            shapes += [(f"{level}.conv1", (2 * BATCH, s, s, cin, cout)),
                       (f"{level}.conv2", (2 * BATCH, s, s, cout, cout))]
    return shapes


def int8_site_shapes(n: int = BATCH, h: int = PATCH, w: int = PATCH):
    """(site, (n, h, w, cin, cout), mode) of the 18 conv3x3_s8_q launches
    of one int8 forward of n images of h x w (BATCH tiles by default), each
    in the mode the forward runs it in: int8 out in the encoder, the split
    form (two segments of cin channels, int8 out) for a decoder conv1,
    bf16 out for a decoder conv2."""
    from fabric_tpu_torch.weights import block_channels

    shapes = []
    for level, (cin, cout) in block_channels(13, BASE).items():
        sh, sw = h // LEVEL_SIDE[level], w // LEVEL_SIDE[level]
        if level.startswith("up"):
            shapes += [(f"{level}.conv1", (n, sh, sw, cin // 2, cout),
                        "split"),
                       (f"{level}.conv2", (n, sh, sw, cout, cout), "bf16")]
        else:
            shapes += [(f"{level}.conv1", (2 * n, sh, sw, cin, cout),
                        "int8"),
                       (f"{level}.conv2", (2 * n, sh, sw, cout, cout),
                        "int8")]
    return shapes


def compare_site(got, ref, mode):
    """(largest difference in int8 codes or bf16 ulps, elements that
    differ) of a fused conv site against its plain version."""
    if mode == "bf16":
        g, r = got.float(), ref.float()
        # one bf16 ulp of r: 2^(exponent - 7); zeros count as the smallest
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                         - 7)
        d = (g - r).abs() / ulp
    else:
        d = (got.int() - ref.int()).abs().float()
    return d.max().item(), int((d > 0).sum())


def check_int8_kernels():
    """conv3x3_s8 at the 18 launches of one int8 forward, each in the mode
    the forward runs it in, against its plain version on the card (the
    exact conv, then the epilogue in PyTorch), with its time beside its
    bound, the plain version's and the unfused time (the raw int32 launch,
    or two for the split form, then the plain epilogue on the card: what
    the forward ran before); raw at the 22 separate convs, exact; and
    int8_matmul at the microbench's 131072 x 512 x 512 (int8 exact, bf16
    within k 2^-22 |a| @ |b|) beside torch._int_mm and torch.matmul.
    Returns (the fused rows, the matmul row, whether any fused site
    differed within the allowed one code or ulp)."""
    from fabric_tpu_torch.ops import conv_s8
    from fabric_tpu_torch.ops import int8_matmul as im

    g = torch.Generator().manual_seed(SEED)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).cuda()

    raw_ms = raw_bound = 0.0
    for site, (n, h, w, cin, cout) in int8_conv_shapes():
        x, wq = s8(n, h, w, cin), s8(3, 3, cin, cout)
        packed = conv_s8.pack_weight(wq)
        got = conv_s8.conv3x3_s8(x, wq, packed)
        torch.cuda.synchronize()
        ref = conv_s8.conv3x3_s8_reference(x, wq)
        exact = torch.equal(got, ref)
        kms = device_ms(lambda: conv_s8.conv3x3_s8(x, wq, packed), 10)
        t_ops, t_bytes = bound(2 * n * h * w * 9 * cin * cout,
                               n * h * w * (cin + 4 * cout) + 9 * cin * cout,
                               PEAK_INT8_TENSOR)
        raw_ms, raw_bound = raw_ms + kms, raw_bound + max(t_ops, t_bytes)
        print(f"kernel conv3x3_s8 raw {site} {(n, h, w, cin, cout)}: "
              f"{'exact' if exact else 'MISMATCH'} against the float64 conv"
              f" | {kms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: int8 in, "
              f"int32 out)", flush=True)
        if not exact:
            fail(f"conv3x3_s8 raw {site} is not exact against the float64 "
                 "conv")
        del x, wq, packed, got, ref
    print(f"conv3x3_s8 raw (int32 out) at the 22 separate convs of a "
          f"forward: {raw_ms:.3f} ms, bound {raw_bound:.3f} ms", flush=True)

    rows, within = [], False
    for site, (n, h, w, cin, cout), mode in int8_site_shapes():
        split = mode == "split"
        x, wq = s8(n, h, w, cin), s8(3, 3, cin, cout)
        packed = conv_s8.pack_weight(wq)

        def scale(f):  # sums of a few units, some codes clipped
            return ((torch.rand(cout, generator=g) + 0.5) * f / (
                (9 * cin) ** 0.5 * 5400)).cuda()
        k, bias = scale(2.0), torch.randn(cout, generator=g).cuda()
        up = None
        if split:
            wq2 = s8(3, 3, cin, cout)
            up = (s8(n, h, w, cin), wq2, scale(0.7), conv_s8.pack_weight(wq2))
        s_out = None if mode == "bf16" else 3.0 / 127
        args = (x, wq, k, bias, s_out)
        got = conv_s8.conv3x3_s8_q(*args, packed, up)
        torch.cuda.synchronize()
        ref = conv_s8.conv3x3_s8_q_reference(*args, up)
        worst, n_diff = compare_site(got, ref, mode)
        # bit-equal, or within one code or ulp on at most 1e-5 of the
        # elements (the plain version's own rounding on the card)
        ok = worst == 0 or (worst <= 1 and n_diff <= 1e-5 * got.numel())
        within |= worst > 0 and ok
        kms = device_ms(lambda: conv_s8.conv3x3_s8_q(*args, packed, up), 10)
        pms = device_ms(lambda: conv_s8.conv3x3_s8_q_reference(*args, up), 1)
        packs = {id(wq): packed}
        if split:
            packs[id(up[1])] = up[3]
        plain_conv = conv_s8.conv3x3_s8_reference
        conv_s8.conv3x3_s8_reference = lambda x, w: conv_s8.conv3x3_s8(
            x, w, packs[id(w)])
        try:  # the raw kernel, then the plain epilogue
            unfused = conv_s8.conv3x3_s8_q_reference(*args, up)
            torch.cuda.synchronize()
            if not torch.equal(unfused, ref):
                fail(f"conv3x3_s8 {site}: the raw kernel under the plain "
                     "epilogue differs from the plain version")
            ums = device_ms(lambda: conv_s8.conv3x3_s8_q_reference(
                *args, up), 10)
        finally:
            conv_s8.conv3x3_s8_reference = plain_conv
        k_in = cin * (2 if split else 1)
        out_b = 1 if s_out is not None else 2
        ops = 2 * n * h * w * 9 * k_in * cout
        t_ops, t_bytes = bound(ops, n * h * w * (k_in + out_b * cout)
                               + 9 * k_in * cout
                               + 4 * cout * (3 if split else 2),
                               PEAK_INT8_TENSOR)
        p = conv_s8.plan(h, w, cout, mode)
        print(f"kernel conv3x3_s8 {mode} {site} {(n, h, w, cin, cout)}: "
              f"{'identical' if worst == 0 else 'DIFFERENT'} to its plain "
              f"version ({n_diff} of {got.numel()} differ, by at most "
              f"{worst:g} {'ulp' if mode == 'bf16' else 'code'}) | "
              f"{kms:.4f} ms, {ops / kms / 1e9:.1f} TOP/s, bound "
              f"{max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}), plain "
              f"{pms:.3f} ms, unfused (raw launch + plain epilogue) "
              f"{ums:.4f} ms | plan PN {p.pn}, chunk {conv_s8.KB} B, "
              f"{p.images} images of {1 << p.tr}x{1 << p.tw} per 128-pixel "
              f"tile, {p.blocks_per_sm} blocks per SM, {conv_s8.STAGES} "
              f"ring slots, {p.smem} B shared",
              flush=True)
        if not ok:
            fail(f"conv3x3_s8 {mode} {site} disagrees with its plain version")
        rows.append(dict(name="conv3x3_s8", err=worst, ms=kms, plain_ms=pms,
                         unfused_ms=ums, library_ms=None, t_ops=t_ops,
                         t_bytes=t_bytes))
        del x, wq, packed, got, ref, unfused, up, args

    m, k, n = 131072, 512, 512
    a, b = s8(m, k), s8(k, n)
    forms = {}
    for dtype, peak, lib in ((torch.int8, PEAK_INT8_TENSOR, torch._int_mm),
                             (torch.bfloat16, PEAK_BF16_TENSOR,
                              torch.matmul)):
        aa, bb = a.to(dtype), b.to(dtype)
        got = im.int8_matmul(aa, bb)
        torch.cuda.synchronize()
        ref = im.int8_matmul_reference(aa, bb)
        err = (got.double() - ref.double()).abs().max().item()
        # int8: exact.  bf16: products exact in float32 and each side's sum
        # within (k - 1) 2^-24 sum|a b| of the exact one (tensor cores may
        # truncate: k 2^-22); integers <= 127 keep every sum exact here
        tol = 0.0 if dtype == torch.int8 else k * 2.0 ** -22 * (
            aa.float().abs() @ bb.float().abs()).max().item()
        kms = device_ms(lambda: im.int8_matmul(aa, bb), 10)
        pms = device_ms(lambda: im.int8_matmul_reference(aa, bb), 2)
        lms = device_ms(lambda: lib(aa, bb), 10)
        es = aa.element_size()
        t_ops, t_bytes = bound(2 * m * k * n, es * (m * k + k * n)
                               + 4 * m * n, peak)
        print(f"kernel int8_matmul {str(dtype)[6:]} ({m}, {k}) @ ({k}, {n}):"
              f" max_abs_err {err:.4g} tol {tol:.4g} "
              f"{'ok' if err <= tol else 'MISMATCH'} | {kms:.4f} ms, plain "
              f"{pms:.3f} ms, library {lms:.4f} ms ({lib.__name__}), bound "
              f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}), "
              f"{2 * m * k * n / kms / 1e9:.0f} TOP/s", flush=True)
        if err > tol:
            fail(f"int8_matmul {dtype} disagrees with its plain version")
        forms[dtype] = dict(name="int8_matmul", err=err, ms=kms,
                            plain_ms=pms, library_ms=lms, t_ops=t_ops,
                            t_bytes=t_bytes)
        del aa, bb, got, ref
    row = forms[torch.int8]
    row["err"] = max(r["err"] for r in forms.values())
    return rows, row, within


def int8_matmul_path():
    """The int8 matmul's own path: the microbench entry point at its
    default shape, counted; returns the kernel's launches in it."""
    from fabric_tpu_torch.ops import int8_matmul as im
    from fabric_tpu_torch.tools.ablate_train import microbench_int8_matmul

    im.int8_matmul.launches = 0
    out = microbench_int8_matmul(131072, 512, 512, iters=10, device="cuda")
    launches = im.int8_matmul.launches
    print(f"tools.ablate_train --microbench int8_matmul: {json.dumps(out)}; "
          f"int8_matmul launched {launches} times (expected 23: the "
          "exactness check, then a warm-up and 10 timed calls per form)",
          flush=True)
    if launches != 23 or not out["kernel_int8_exact"]:
        fail("the microbench did not run the exact int8 kernel as planned")
    return launches


def int8_serving(cfg, d1, d2, more, bf16_wall, bf16_fwd_ms, within):
    """int8 serving through ScenePredictor(quant="int8") at full width:
    the first predict calibrates, predict_many probes and serves a 2048^2
    and a 1000x1500 pair; the launch counters, predict_many == predict, the
    mask identical to the same int8 forward (same scales) on the plain
    versions of the conv sites (or, where ``within`` says a site differed
    within one code or ulp from its plain version, the same on >= 99.99%
    of the pixels), and the rates beside this run's bf16 ones.  Returns
    the launches of the int8 kernels: conv3x3_s8 (both wrappers of the
    kernel) and siamese_fuse_s8."""
    from fabric_tpu_torch.infer.device_tiling import make_scene_infer
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused

    pred = ScenePredictor(cfg, checkpoint=None, bucket=512, device="cuda",
                          quant="int8")
    counters = (conv_s8.conv3x3_s8_q, conv_s8.conv3x3_s8,
                fuse_s8.siamese_fuse_s8, conv.conv3x3_bias_relu,
                double_conv.double_conv3x3_bias_relu, fused.fused_mul_relu)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    mask = pred.predict(d1, d2)
    first_s = time.perf_counter() - t0
    many = pred.predict_many(more)
    launches = {fn.__name__: fn.launches for fn in counters}
    # int8 forwards of BATCH tiles: 4 + 4 + 2, 18 fused conv sites and 5
    # fusions each and no raw conv; the stats forward (one conv3x3 launch
    # per site, five bf16 fusions) runs for the calibration on the first
    # scene and for the two probes
    expected = {"conv3x3_s8_q": 18 * 10, "conv3x3_s8": 0,
                "siamese_fuse_s8": 5 * 10, "conv3x3_bias_relu": 18 * 3,
                "double_conv3x3_bias_relu": 0, "fused_mul_relu": 5 * 3}
    print(f"int8 serve: kernels launched {launches} (expected {expected}); "
          f"first predict (with calibration) {first_s:.2f} s; worst clip "
          f"ratio of the last probe {max(pred.last_clip_report.values()):.3f}",
          flush=True)
    if launches != expected:
        fail("the int8 serve did not go through the kernels as planned")
    if mask.shape != (SCENE, SCENE) or not set(np.unique(mask)) <= {0, 1}:
        fail(f"bad int8 mask {mask.shape}")
    for m, pair in zip(many, more):
        if not np.array_equal(m, pred.predict(*pair)):
            fail("int8 predict_many differs from predict")
    print("int8 predict_many == [predict(*p) for p in pairs]: ok", flush=True)

    # the same int8 forward (same scales) on the plain versions of both
    # int8 kernels: the exact float64 conv, then the epilogue in PyTorch;
    # the fusion's int32 PyTorch lines and the int8 max-pool
    a1, a2 = (torch.from_numpy(d).cuda() for d in (d1, d2))
    with plain_int8():
        plain = make_scene_infer(pred._forward, PATCH, (SCENE, SCENE),
                                 batch_size=BATCH, dtype=torch.bfloat16)(
                                     a1, a2).cpu().numpy()
    int8_identical(f"{SCENE}^2 int8 mask", mask, plain, within)

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict(d1, d2)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    run = pred._get_runner(SCENE, SCENE)
    fwd_ms = device_ms(lambda: run(a1, a2), 3)
    probes = []
    for _ in range(3):  # the clip probe alone: crops, stats forward, check
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred._int8_probe_check(pred._int8_scene_prologue(
            pred._calibration_crops(d1, d2)), pred._scenes_predicted)
        probes.append(time.perf_counter() - t0)
    profile_runner(run, (a1, a2), f"int8 {SCENE}^2 runner", top=12)
    # what an int8 forward makes in int32: nothing (the conv sums and the
    # fusion's products stay in the kernels' registers)
    tiles = [torch.randn(BATCH, PATCH, PATCH, 13, generator=torch.Generator(
    ).manual_seed(SEED + i)).cuda() for i in range(2)]
    made, addcmul = int32_tensors(pred._forward, *tiles)
    print(f"int32 tensors made by one int8 forward of {BATCH} tiles, by aten "
          f"op: {made} ({sum(made.values())}); addcmul calls: {addcmul}",
          flush=True)
    if made or addcmul:
        fail("the int8 forward makes int32 tensors")
    mpx = SCENE * SCENE / 1e6
    print(f"int8 end to end {SCENE}^2: predict {wall * 1e3:.1f} ms median of "
          f"{[round(w * 1e3, 1) for w in walls]} = {mpx / wall:.2f} Mpx/s "
          f"(clip probe, host pad/upload/read-back included; the probe "
          f"alone {statistics.median(probes) * 1e3:.1f} ms, host clock); "
          f"device-resident runner {fwd_ms:.1f} ms = "
          f"{mpx / fwd_ms * 1e3:.2f} Mpx/s, "
          f"{fwd_ms / (SCENE * SCENE / (PATCH * PATCH) / BATCH):.2f} ms per "
          f"{BATCH}-tile int8 forward; bf16 in this run: predict "
          f"{mpx / bf16_wall:.2f} Mpx/s, runner {mpx / bf16_fwd_ms * 1e3:.2f}"
          f" Mpx/s", flush=True)
    return {"conv3x3_s8": launches["conv3x3_s8_q"] + launches["conv3x3_s8"],
            "siamese_fuse_s8": launches["siamese_fuse_s8"]}


def int32_tensors(forward, x1, x2) -> tuple[dict, int]:
    """({aten op: count} of the ops of one forward that make an int32
    tensor, the number of addcmul calls in it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    made, addcmul = {}, []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name.startswith("addcmul"):
                addcmul.append(name)
            for o in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(o, torch.Tensor) and o.dtype == torch.int32:
                    made[name] = made.get(name, 0) + 1
            return out

    with Count():
        forward(x1, x2)
    return made, len(addcmul)


# the other tiled modes and the multi-date models
OVERLAP, BAND_ROWS = 32, 8     # infer_overlap and overlap_band_rows
FLEET, FLEET_SIDE = 16, 512    # the packing phase's pairs and their side
MD_DATES, MD_SCENE = 5, 1024   # the multi-date phases' dates and side
MD_SMALL, MD_SMALL_SIDE = 4, 512  # the stacks the multi-date phases pack


def zero_counts(counters) -> None:
    for fn in counters:
        fn.launches = 0


def read_counts(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


def timed(fn):
    """(fn(), wall seconds to its end on the card, peak bytes allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def times(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def block_calls(base: int, levels, h: int = PATCH, w: int = PATCH) -> dict:
    """{kernel: launches} of the folded 2-D DoubleConv blocks ``levels``
    in one forward of h x w images (tiles by default), each where the gate
    sends it (the gate reads the image and channel shape only, not the
    batch)."""
    from fabric_tpu_torch.ops.double_conv import supports
    from fabric_tpu_torch.weights import block_channels

    out = {"conv3x3_bias_relu": 0, "double_conv3x3_bias_relu": 0}
    for level, (cin, cout) in block_channels(13, base).items():
        if level in levels:
            sh, sw = h // LEVEL_SIDE[level], w // LEVEL_SIDE[level]
            if supports(sh, sw, cin, cout, cout):
                out["double_conv3x3_bias_relu"] += 1
            else:
                out["conv3x3_bias_relu"] += 2
    return out


@contextlib.contextmanager
def plain_int8():
    """Run the int8 forwards on the int8 conv and fusion kernels' plain
    versions (the ops are looked up on their modules at call time)."""
    from fabric_tpu_torch.ops import conv_s8, fuse_s8

    saved = (conv_s8.conv3x3_s8_q, conv_s8.conv3x3_s8,
             fuse_s8.siamese_fuse_s8)
    conv_s8.conv3x3_s8_q = lambda x, wq, k, b, s_out=None, packed=None, \
        up=None, dtype=torch.bfloat16: conv_s8.conv3x3_s8_q_reference(
            x, wq, k, b, s_out, up, dtype)
    conv_s8.conv3x3_s8 = lambda x, wq, packed=None: \
        conv_s8.conv3x3_s8_reference(x, wq)
    fuse_s8.siamese_fuse_s8 = fuse_s8.siamese_fuse_s8_reference
    try:
        yield
    finally:
        (conv_s8.conv3x3_s8_q, conv_s8.conv3x3_s8,
         fuse_s8.siamese_fuse_s8) = saved


def int8_identical(label: str, mask, plain, within: bool) -> None:
    """The int8 mask against the same int8 forward on the plain versions:
    identical (>= 99.99% where a site of the kernel check differed within
    one code or ulp)."""
    agree = float((mask == plain).mean())
    print(f"{label} vs the same int8 forward on the plain versions on the "
          f"card: {'identical' if agree == 1 else 'DIFFERENT'} "
          f"({int((mask != plain).sum())} pixels differ, agreement "
          f"{agree:.6f}); change share {mask.mean():.4f}", flush=True)
    if agree < (0.9999 if within else 1.0):
        fail(f"{label}: the int8 kernel forward differs from the "
             "plain-version one")


def overlap_average(model, a1, a2):
    """The overlap-averaged class-1 probability (fp32 canvas) of the
    2048^2 scene through ``model``, as the overlap runner computes it."""
    from fabric_tpu_torch.infer import device_tiling as tdt

    stride = PATCH - OVERLAP
    ys = xs = tdt._axis_positions(SCENE, PATCH, stride)
    tiles = tuple(tdt._gather_tiles(a.to(torch.bfloat16), ys, xs, PATCH)
                  for a in (a1, a2))
    with torch.inference_mode():
        probs = tdt._run_chunks(model, tiles, BATCH, True)
    acc, cnt = tdt._overlap_sums(probs, ys, xs, SCENE, SCENE, PATCH, stride)
    return (acc / cnt.clamp(min=1.0)).cpu().numpy()


def overlap_phases(d1, d2, within):
    """Phases 1 and 2 of the tiled modes: the 2048^2 pair at infer_overlap
    32, bf16 folded, unbanded and banded at overlap_band_rows 8 (masks
    equal; against the same overlap forward on the plain versions, flips
    only where the averaged probability is within 1/32 of 0.5, on <= 0.1%
    of the pixels), then at int8 (identical to the int8 forward on the
    plain versions).  Each run's wall time, Mpx/s and peak memory, and its
    kernel launches against the count its tiles make."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer import device_tiling as tdt
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused

    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE, infer_overlap=OVERLAP)
    n_pos = len(tdt._axis_positions(SCENE, PATCH, PATCH - OVERLAP))
    if (n_pos - 1) * (PATCH - OVERLAP) != SCENE - PATCH:
        fail("the overlap grid should need no edge stop")
    forwards = {0: -(-n_pos * n_pos // BATCH),
                BAND_ROWS: sum(-(-min(BAND_ROWS, n_pos - b) * n_pos // BATCH)
                               for b in range(0, n_pos, BAND_ROWS))}
    per_fwd = {**block_calls(BASE, LEVEL_SIDE), "fused_mul_relu": 5}
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, conv_s8.conv3x3_s8_q,
                fuse_s8.siamese_fuse_s8)
    zeros8 = {"conv3x3_s8_q": 0, "siamese_fuse_s8": 0}
    mpx = SCENE * SCENE / 1e6
    masks = {}
    for rows in (0, BAND_ROWS):
        pred = ScenePredictor(cfg, bucket=512, device="cuda",
                              overlap_band_rows=rows)
        pred.predict(d1, d2)  # the runner's first call
        zero_counts(counters)
        masks[rows], wall, peak = timed(lambda: pred.predict(d1, d2))
        launches = read_counts(counters)
        expected = {**times(per_fwd, forwards[rows]), **zeros8}
        label = f"banded ({rows} tile rows)" if rows else "unbanded"
        print(f"overlap {OVERLAP} {label} {SCENE}^2 bf16: predict "
              f"{wall * 1e3:.1f} ms = {mpx / wall:.2f} Mpx/s, peak "
              f"allocated {peak / 2**20:.0f} MiB; {forwards[rows]} forwards"
              f", kernels launched {launches} (expected {expected})",
              flush=True)
        if launches != expected:
            fail(f"overlap {label}: the kernels did not run as planned")
    if not np.array_equal(masks[0], masks[BAND_ROWS]):
        fail("banded overlap differs from unbanded")
    print("banded overlap mask == unbanded: ok", flush=True)

    a1, a2 = (torch.from_numpy(d).cuda() for d in (d1, d2))
    profile_runner(pred._get_runner(SCENE, SCENE), (a1, a2),
                   f"overlap {OVERLAP} banded {SCENE}^2 bf16 runner")
    with plain_versions():
        avg = overlap_average(pred.model, a1, a2)
    flips = masks[0] != (avg > 0.5)
    near = np.abs(avg - 0.5) <= 1 / 32
    print(f"overlap mask vs the plain-version forward on the card: "
          f"{int(flips.sum())} flips ({flips.mean():.2e} of the pixels), "
          f"{int((flips & ~near).sum())} where the averaged probability is "
          f"farther than 1/32 from 0.5; change share {masks[0].mean():.4f}",
          flush=True)
    if (flips & ~near).any() or flips.mean() > 1e-3:
        fail("the overlap mask breaks the margin rule")

    pred8 = ScenePredictor(cfg, bucket=512, device="cuda", quant="int8")
    pred8.predict(d1, d2)  # calibrates on this scene
    zero_counts(counters)
    m8, wall, peak = timed(lambda: pred8.predict(d1, d2))
    launches = read_counts(counters)
    n_fw = forwards[0]
    # and the clip probe's stats forward: a conv3x3 launch per site and
    # the five bf16 fusions
    expected = {"conv3x3_bias_relu": 18, "double_conv3x3_bias_relu": 0,
                "fused_mul_relu": 5, "conv3x3_s8_q": 18 * n_fw,
                "siamese_fuse_s8": 5 * n_fw}
    print(f"overlap {OVERLAP} {SCENE}^2 int8: predict {wall * 1e3:.1f} ms = "
          f"{mpx / wall:.2f} Mpx/s, peak allocated {peak / 2**20:.0f} MiB; "
          f"kernels launched {launches} (expected {expected})", flush=True)
    if launches != expected:
        fail("int8 overlap: the kernels did not run as planned")
    with plain_int8():
        plain = tdt.make_scene_infer(pred8._forward, PATCH, (SCENE, SCENE),
                                     batch_size=BATCH, overlap=OVERLAP)(
                                         a1, a2).cpu().numpy()
    int8_identical(f"int8 overlap {SCENE}^2 mask", m8, plain, within)


def fleet_phase(cfg):
    """Phase 3: sixteen 512^2 pairs, bf16 and int8: predict_many(pack=
    "auto") equals predict pair by pair, bit for bit (the chunks mix the
    scenes' tiles); the packed and the unpacked rate."""
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused

    rng = np.random.RandomState(SEED + 7)
    pairs = [tuple(rng.randn(FLEET_SIDE, FLEET_SIDE, 13).astype(np.float32)
                   for _ in range(2)) for _ in range(FLEET)]
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, conv_s8.conv3x3_s8_q,
                fuse_s8.siamese_fuse_s8)
    packs = FLEET * (FLEET_SIDE // PATCH) ** 2 // BATCH
    mpx = FLEET * FLEET_SIDE ** 2 / 1e6
    for quant in ("none", "int8"):
        pred = ScenePredictor(cfg, bucket=512, device="cuda", quant=quant)
        seq = [pred.predict(*p) for p in pairs]  # int8: calibrates first
        zero_counts(counters)
        packed, wall_p, _ = timed(lambda: pred.predict_many(pairs,
                                                            pack="auto"))
        launches = read_counts(counters)
        if quant == "none":
            expected = {**times({**block_calls(BASE, LEVEL_SIDE),
                                 "fused_mul_relu": 5}, packs),
                        "conv3x3_s8_q": 0, "siamese_fuse_s8": 0}
        else:  # and a clip probe per pair
            expected = {"conv3x3_bias_relu": 18 * FLEET,
                        "double_conv3x3_bias_relu": 0,
                        "fused_mul_relu": 5 * FLEET,
                        "conv3x3_s8_q": 18 * packs,
                        "siamese_fuse_s8": 5 * packs}
        if launches != expected:
            fail(f"packed {quant}: kernels launched {launches}, expected "
                 f"{expected}")
        for a, b in zip(packed, seq, strict=True):
            if not np.array_equal(a, b):
                fail(f"packed {quant} serving differs from predict")
        _, wall_u, _ = timed(lambda: pred.predict_many(pairs))
        run = pred._get_packed_runner(FLEET_SIDE, FLEET_SIDE, FLEET // packs)
        stacks = [torch.from_numpy(np.stack([p[i] for p in pairs[:FLEET //
                                                                 packs]]))
                  .cuda() for i in (0, 1)]
        dev_ms = device_ms(lambda: run(*stacks), 3) * packs
        print(f"fleet of {FLEET} {FLEET_SIDE}^2 pairs, {quant}: "
              f"predict_many(pack='auto') == [predict(*p) for p in pairs]: "
              f"ok; packed {wall_p * 1e3:.1f} ms = {mpx / wall_p:.2f} Mpx/s "
              f"({packs} forwards; launches {launches}; the packed runner "
              f"alone, scenes on the card, {dev_ms:.1f} ms = "
              f"{mpx / dev_ms * 1e3:.2f} Mpx/s), unpacked {wall_u * 1e3:.1f}"
              f" ms = {mpx / wall_u:.2f} Mpx/s ({FLEET} forwards)",
              flush=True)


def plain_multidate(model, a, side: int = MD_SCENE, dtype=torch.bfloat16):
    """Mask, fp32 logit margin |l1 - l0| and logit scale of the forward on
    the plain versions over the grid of the side x side stack (tiles in
    ``dtype``)."""
    from fabric_tpu_torch.infer import device_tiling as tdt

    ys, xs, k, _, _ = tdt._plan_grid(side, side, PATCH, PATCH, BATCH)
    tiles = tdt._multidate_tiles(a.to(dtype), ys, xs, PATCH)
    with plain_versions(), torch.inference_mode():
        logits = torch.cat([model(tiles[i:i + BATCH])
                            for i in range(0, k, BATCH)])

    def stitch(o):
        return tdt._stitch(o, ys, xs, k, side, side, PATCH).cpu().numpy()
    return (stitch(logits.argmax(-1).to(torch.uint8)),
            stitch((logits[..., 1] - logits[..., 0]).abs()),
            logits.abs().max().item())


def multidate_phase(name: str, within):
    """Phases 4 and 5 for one multi-date family at T = 5, full width
    (UNetLSTM base 64, UNet3D base 32), bf16 folded: a 1024^2 stack
    through predict_multidate (launches per forward against the count;
    the mask held to the plain versions by the bi-date margin rule), four
    512^2 stacks packed == one by one, the time per forward; then int8:
    calibrated on the stack, the mask identical to the int8 forward on the
    plain versions, conv3x3_s8 launches per forward."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused
    from fabric_tpu_torch.infer.device_tiling import (
        make_scene_infer_multidate)

    cfg = Config(model=name, patch_size=PATCH, eval_batch_size=BATCH,
                 dtype="bfloat16", num_dates=MD_DATES)
    base = 64 if name == "unet_lstm" else 32
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, conv_s8.conv3x3_s8_q,
                conv_s8.conv3x3_s8, fuse_s8.siamese_fuse_s8)
    rng = np.random.RandomState(SEED + 11)
    stack = rng.randn(MD_DATES, MD_SCENE, MD_SCENE, 13).astype(np.float32)
    smalls = [rng.randn(MD_DATES, MD_SMALL_SIDE, MD_SMALL_SIDE,
                        13).astype(np.float32) for _ in range(MD_SMALL)]
    levels = (LEVEL_SIDE if name == "unet_lstm"
              else [k for k in LEVEL_SIDE if k.startswith("up")])
    per_fwd = block_calls(base, levels)
    none8 = {"conv3x3_s8_q": 0, "conv3x3_s8": 0, "siamese_fuse_s8": 0}
    n_fw = (MD_SCENE // PATCH) ** 2 // BATCH
    mpx = MD_SCENE * MD_SCENE / 1e6
    pred = ScenePredictor(cfg, bucket=512, device="cuda")
    zero_counts(counters)
    mask, wall, peak = timed(lambda: pred.predict_multidate(stack))
    launches = read_counts(counters)
    expected = {**times(per_fwd, n_fw), "fused_mul_relu": 0, **none8}
    print(f"{name} T={MD_DATES} {MD_SCENE}^2 bf16 ("
          f"{sum(p.numel() for p in pred.model.parameters())} parameters, "
          f"BatchNorm folded): predict_multidate "
          f"{wall * 1e3:.1f} ms (first call), peak allocated "
          f"{peak / 2**20:.0f} MiB; kernels launched {launches} (expected "
          f"{expected})", flush=True)
    if launches != expected:
        fail(f"{name}: the kernels did not run as planned")
    a = torch.from_numpy(stack).cuda()
    plain_mask, margin, scale = plain_multidate(pred.model, a)
    flips = mask != plain_mask
    worst = float(margin[flips].max()) if flips.any() else 0.0
    print(f"{name} {MD_SCENE}^2 mask vs the plain-version forward on the "
          f"card: agreement {1 - flips.mean():.6f} ({int(flips.sum())} "
          f"flips, largest plain margin at a flip {worst:.4g}, bound "
          f"{scale / 16:.4g}); change share {mask.mean():.4f}", flush=True)
    if worst > scale / 16 or flips.mean() > 1e-3:
        fail(f"{name}: the kernel forward disagrees with the plain one")
    run = pred._get_runner(MD_SCENE, MD_SCENE)
    fwd_ms = device_ms(lambda: run(a), 3) / n_fw
    profile_runner(run, (a,), f"{name} {MD_SCENE}^2 bf16 runner")
    seq = [pred.predict_multidate(s) for s in smalls]
    zero_counts(counters)
    packed = pred.predict_many_multidate(smalls, pack="auto")
    launches = read_counts(counters)
    small_fw = MD_SMALL * (MD_SMALL_SIDE // PATCH) ** 2 // BATCH
    for x, y in zip(packed, seq, strict=True):
        if not np.array_equal(x, y):
            fail(f"{name}: packed multi-date serving differs from predict")
    if launches != {**times(per_fwd, small_fw), "fused_mul_relu": 0,
                    **none8}:
        fail(f"{name}: packed launches {launches}")
    print(f"{name}: predict_many_multidate(pack='auto') over {MD_SMALL} "
          f"{MD_SMALL_SIDE}^2 stacks == one by one: ok ({small_fw} forward);"
          f" bf16 forward of {BATCH} tiles x {MD_DATES} dates {fwd_ms:.2f} "
          f"ms = "
          f"{BATCH * PATCH * PATCH / fwd_ms / 1e3:.2f} Mpx/s "
          f"(device-resident runner)", flush=True)

    pred8 = ScenePredictor(cfg, bucket=512, device="cuda", quant="int8")
    pred8.predict_multidate(stack)  # calibrates on this stack
    zero_counts(counters)
    m8, wall8, _ = timed(lambda: pred8.predict_multidate(stack))
    launches = read_counts(counters)
    # the clip probe's stats forward: a conv3x3 launch per 2-D site
    probe = 18 if name == "unet_lstm" else 8
    expected = {"conv3x3_bias_relu": probe, "double_conv3x3_bias_relu": 0,
                "fused_mul_relu": 0, "conv3x3_s8_q": 18 * n_fw,
                "conv3x3_s8": (2 * MD_DATES if name == "unet_lstm" else 0)
                * n_fw, "siamese_fuse_s8": 0}
    if launches != expected:
        fail(f"{name} int8: kernels launched {launches}, expected "
             f"{expected}")
    run8 = pred8._get_runner(MD_SCENE, MD_SCENE)
    fwd8_ms = device_ms(lambda: run8(a), 3) / n_fw
    profile_runner(run8, (a,), f"{name} {MD_SCENE}^2 int8 runner", top=12)
    print(f"{name} T={MD_DATES} {MD_SCENE}^2 int8: predict_multidate "
          f"{wall8 * 1e3:.1f} ms; kernels launched {launches} (expected "
          f"{expected}); int8 forward {fwd8_ms:.2f} ms = "
          f"{BATCH * PATCH * PATCH / fwd8_ms / 1e3:.2f} Mpx/s "
          f"(device-resident runner)", flush=True)
    with plain_int8():
        plain8 = make_scene_infer_multidate(
            pred8._forward, PATCH, (MD_SCENE, MD_SCENE), num_dates=MD_DATES,
            batch_size=BATCH)(a).cpu().numpy()
    int8_identical(f"{name} int8 {MD_SCENE}^2 mask", m8, plain8, within)


# seamless fullconv serving
FC_BAND = 512                 # fullconv_band_rows
FC_WIDE = (1024, 8192)        # the wide pair streamed from a memmap


def band_calls(n: int, h: int, w: int):
    """The kernel calls of one bi-date fullconv forward over n context
    windows of h x w: (kernel, shape, level), each DoubleConv block where
    the gate sends it, then the five fusions."""
    from fabric_tpu_torch.ops.double_conv import supports
    from fabric_tpu_torch.weights import block_channels

    calls = []
    for level, (cin, cout) in block_channels(13, BASE).items():
        f = LEVEL_SIDE[level]
        m = n if level.startswith("up") else 2 * n
        sh, sw = h // f, w // f
        if supports(sh, sw, cin, cout, cout):
            calls.append(("double_conv3x3_bias_relu",
                          (m, sh, sw, cin, cout, cout), level))
        else:
            calls.append(("conv3x3_bias_relu", (m, sh, sw, cin, cout), level))
            calls.append(("conv3x3_bias_relu", (m, sh, sw, cout, cout),
                          level))
    for i, c in enumerate((BASE, 2 * BASE, 4 * BASE, 8 * BASE, 8 * BASE)):
        calls.append(("fused_mul_relu", (n, h >> i, w >> i, c), f"f{i + 1}"))
    return calls


def gate_lines(h: int, w: int) -> None:
    """Why each DoubleConv of a band forward runs as two conv launches:
    the fused kernel keeps a whole image's intermediate on the SM, which
    at band widths needs more shared memory than a block has."""
    from fabric_tpu_torch.ops import double_conv
    from fabric_tpu_torch.ops.conv import MAX_SMEM
    from fabric_tpu_torch.weights import block_channels

    for level, (cin, cout) in block_channels(13, BASE).items():
        f = LEVEL_SIDE[level]
        sh, sw = h // f, w // f
        need = double_conv.smem_bytes(sh, sw, cout, cout, True, 3)
        fits = double_conv.fits(sh, sw, cin, cout, cout)
        fused = double_conv.supports(sh, sw, cin, cout, cout)
        print(f"gate {level} at {sh}x{sw} ({cin}->{cout}->{cout}): fused "
              f"kernel {'fits' if fits else 'does not fit'} (its smallest "
              f"block needs {need} B of shared memory, a block may have "
              f"{MAX_SMEM}); "
              f"{'fused' if fused else 'two conv3x3_bias_relu launches'}",
              flush=True)


def check_int8_band(n: int, h: int, w: int, reps: int = 3):
    """conv3x3_s8 at the 18 sites and siamese_fuse_s8 at the 5 levels of
    one int8 fullconv forward over n windows of h x w, each in the form
    the forward runs it in, against its plain version on the card
    (identical, or one code or ulp on at most 1e-5 of the elements), timed
    beside its bound and the plain version.  Returns the rows."""
    from fabric_tpu_torch.ops import conv_s8, fuse_s8

    g = torch.Generator("cuda").manual_seed(SEED)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    rows = []
    for site, (m, sh, sw, cin, cout), mode in int8_site_shapes(n, h, w):
        split = mode == "split"
        x, wq = s8(m, sh, sw, cin), s8(3, 3, cin, cout)
        packed = conv_s8.pack_weight(wq)

        def scale(f):  # sums of a few units, some codes clipped
            return (torch.rand(cout, generator=g, device="cuda") + 0.5) * f \
                / ((9 * cin) ** 0.5 * 5400)
        k = scale(2.0)
        bias = torch.randn(cout, generator=g, device="cuda")
        up = None
        if split:
            wq2 = s8(3, 3, cin, cout)
            up = (s8(m, sh, sw, cin), wq2, scale(0.7),
                  conv_s8.pack_weight(wq2))
        s_out = None if mode == "bf16" else 3.0 / 127
        args = (x, wq, k, bias, s_out)
        got = conv_s8.conv3x3_s8_q(*args, packed, up)
        torch.cuda.synchronize()
        ref = conv_s8.conv3x3_s8_q_reference(*args, up)
        worst, n_diff = compare_site(got, ref, mode)
        ok = worst == 0 or (worst <= 1 and n_diff <= 1e-5 * got.numel())
        kms = device_ms(lambda: conv_s8.conv3x3_s8_q(*args, packed, up), reps)
        pms = device_ms(lambda: conv_s8.conv3x3_s8_q_reference(*args, up), 1)
        k_in = cin * (2 if split else 1)
        ops = 2 * m * sh * sw * 9 * k_in * cout
        t_ops, t_bytes = bound(ops, m * sh * sw * (
            k_in + (1 if s_out is not None else 2) * cout)
            + 9 * k_in * cout + 4 * cout * (3 if split else 2),
            PEAK_INT8_TENSOR)
        print(f"kernel conv3x3_s8 {mode} {site} {(m, sh, sw, cin, cout)}: "
              f"{'identical' if worst == 0 else 'DIFFERENT'} to its plain "
              f"version ({n_diff} of {got.numel()} differ, by at most "
              f"{worst:g}) | {kms:.4f} ms, {ops / kms / 1e9:.1f} TOP/s, "
              f"bound {max(t_ops, t_bytes):.4f} ms, plain {pms:.3f} ms",
              flush=True)
        if not ok:
            fail(f"conv3x3_s8 {mode} {site} at a band shape disagrees with "
                 "its plain version")
        rows.append(dict(name="conv3x3_s8", err=worst, ms=kms, plain_ms=pms,
                         library_ms=None, t_ops=t_ops, t_bytes=t_bytes))
        del x, wq, packed, got, ref, up, args
    for i, (level, shape) in enumerate(fuse_s8_shapes(n, h, w)):
        a = s8(*shape)
        m_path = (3.1 / 127) ** 2 / (5.3 / 127) if i < 4 else (4.7 / 127) ** 2
        out, pool = (torch.int8, True) if i < 4 else (torch.bfloat16, False)
        args = (a, m_path, out, pool)
        f, p = fuse_s8.siamese_fuse_s8(*args)
        torch.cuda.synchronize()
        rf, rp = fuse_s8.siamese_fuse_s8_reference(*args)
        if not (torch.equal(f, rf) and (not pool or torch.equal(p, rp))):
            fail(f"siamese_fuse_s8 {level} {shape} differs from its plain "
                 "version")
        kms = device_ms(lambda: fuse_s8.siamese_fuse_s8(*args), reps)
        pms = device_ms(lambda: fuse_s8.siamese_fuse_s8_reference(*args), 1)
        n2, sh, sw, c = shape
        nbytes = a.numel() + (n2 // 2) * sh * sw * c * (
            1 if out == torch.int8 else 2) + (
            n2 * (sh // 2) * (sw // 2) * c if pool else 0)
        t_ops, t_bytes = bound(3 * (n2 // 2) * sh * sw * c, nbytes,
                               PEAK_ELEMENTWISE)
        print(f"kernel siamese_fuse_s8 {level} {shape}: identical to its "
              f"plain version | {kms:.4f} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms, plain {pms:.4f} ms",
              flush=True)
        rows.append(dict(name="siamese_fuse_s8", err=0.0, ms=kms,
                         plain_ms=pms, library_ms=None, t_ops=t_ops,
                         t_bytes=t_bytes))
        del a, f, p, rf, rp
    return rows


COUNTER_OF = {"conv3x3_s8": "conv3x3_s8_q"}  # a kernel's launch counter


def band_kernel_summary(label: str, rows, launches: dict) -> None:
    """One line per kernel: its time summed over the launches of one band
    forward, beside its bound, the plain version's and the library's,
    and its launches on the fullconv path."""
    for name in dict.fromkeys(r["name"] for r in rows):
        mine = [r for r in rows if r["name"] == name]
        lib = [r["library_ms"] for r in mine if r["library_ms"] is not None]
        print(f"fullconv kernel {name} ({label}, {len(mine)} launches a "
              f"band forward): {sum(r['ms'] for r in mine):.3f} ms, bound "
              f"{sum(max(r['t_ops'], r['t_bytes']) for r in mine):.3f} ms, "
              f"plain {sum(r['plain_ms'] for r in mine):.3f} ms, library "
              f"{(f'{sum(lib):.3f} ms' if lib else 'none')}; launches on "
              f"the fullconv path "
              f"{launches.get(COUNTER_OF.get(name, name), 0)}", flush=True)


def memmaps(root: str, arrays, mode: str = "r"):
    """The arrays written to .npy files under root and read back as
    memmaps (only the rows a band needs are read)."""
    out = []
    for i, a in enumerate(arrays):
        path = os.path.join(root, f"scene{i}.npy")
        m = np.lib.format.open_memmap(path, "w+", a.dtype, a.shape)
        m[:] = a
        m.flush()
        del m
        out.append(np.load(path, mmap_mode=mode))
    return out


def fullconv_phase(d1, d2, grid_ms: float, within):
    """Phase 6: the 2048^2 pair through ScenePredictor(fullconv_band_rows
    = 512), bf16: its launches against 4 band forwards' count (the gate
    sends every DoubleConv at band widths to two conv launches), banded =
    one whole-scene forward on the card bit for bit, band_batch 4 = 1,
    streamed from np.memmap = in device memory, and against the same
    fullconv forward on the plain versions by the bi-date margin rule;
    each on-path kernel against its plain version at the band shapes
    (timed), at the band_batch 4 stack and at the widest band; then int8
    (identical to the plain versions, banded = whole); then a 1024 x 8192
    pair streamed from a memmap into an out= memmap, equal to the
    in-device run.  Wall time, Mpx/s, peak memory, and the card's idle
    share of one in-device and one streamed scene."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer import fullconv
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused

    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    ctx = FC_BAND + 2 * fullconv.halo_for("bidate")
    n_bands = SCENE // FC_BAND
    gate_lines(ctx, SCENE)
    per_band = {**block_calls(BASE, LEVEL_SIDE, ctx, SCENE),
                "fused_mul_relu": 5}
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, conv_s8.conv3x3_s8_q,
                fuse_s8.siamese_fuse_s8)
    zeros8 = {"conv3x3_s8_q": 0, "siamese_fuse_s8": 0}
    mpx = SCENE * SCENE / 1e6
    a1, a2 = (torch.from_numpy(d).cuda() for d in (d1, d2))

    pred = ScenePredictor(cfg, bucket=512, device="cuda",
                          fullconv_band_rows=FC_BAND)
    pred.predict(d1, d2)  # the runner's first call
    zero_counts(counters)
    mask, wall, peak = timed(lambda: pred.predict(d1, d2))
    launches = read_counts(counters)
    expected = {**times(per_band, n_bands), **zeros8}
    run = pred._get_runner(SCENE, SCENE)
    fwd_ms = device_ms(lambda: run(a1, a2), 3)
    print(f"fullconv band {FC_BAND} (context {ctx} rows) {SCENE}^2 bf16: "
          f"predict {wall * 1e3:.1f} ms = {mpx / wall:.2f} Mpx/s, peak "
          f"allocated {peak / 2**20:.0f} MiB; device-resident runner "
          f"{fwd_ms:.1f} ms = {mpx / fwd_ms * 1e3:.2f} Mpx/s (the grid "
          f"runner in this run {grid_ms:.1f} ms = "
          f"{mpx / grid_ms * 1e3:.2f} Mpx/s); {n_bands} band forwards, "
          f"kernels launched {launches} (expected {expected})", flush=True)
    if launches != expected:
        fail("fullconv: the kernels did not run as planned")
    if mask.shape != (SCENE, SCENE) or not set(np.unique(mask)) <= {0, 1}:
        fail(f"fullconv: bad mask {mask.shape}")
    profile_runner(run, (a1, a2), f"fullconv {SCENE}^2 bf16 runner")

    whole, wall_w, peak_w = timed(lambda: fullconv.make_fullconv_scene_infer(
        pred.model, (SCENE, SCENE), band_rows=2 * SCENE)(a1, a2).cpu().numpy())
    bb_run = fullconv.make_fullconv_scene_infer(
        pred.model, (SCENE, SCENE), band_rows=FC_BAND, band_batch=4)
    bb, wall_b, peak_b = timed(lambda: bb_run(a1, a2).cpu().numpy())
    print(f"fullconv {SCENE}^2: banded == one whole-scene forward on the "
          f"card: {np.array_equal(mask, whole)} "
          f"({int((mask != whole).sum())} pixels differ; whole-scene "
          f"forward {wall_w * 1e3:.1f} ms, peak {peak_w / 2**20:.0f} MiB); "
          f"band_batch 4 == 1: {np.array_equal(bb, mask)} ({wall_b * 1e3:.1f}"
          f" ms, peak {peak_b / 2**20:.0f} MiB; device-resident "
          f"{device_ms(lambda: bb_run(a1, a2), 2):.1f} ms); change share "
          f"{mask.mean():.4f}", flush=True)
    if not (np.array_equal(mask, whole) and np.array_equal(bb, mask)):
        fail("fullconv: banded, band-batched and whole-scene masks differ")

    with tempfile.TemporaryDirectory(prefix="fabric_fc_") as root:
        m1, m2 = memmaps(root, (d1, d2))
        pred_s = ScenePredictor(cfg, bucket=512, device="cuda",
                                fullconv_band_rows=FC_BAND,
                                fullconv_stream=True)
        pred_s.predict(m1, m2)
        zero_counts(counters)
        ms, wall_s, peak_s = timed(lambda: pred_s.predict(m1, m2))
        launches_s = read_counts(counters)
        print(f"fullconv streamed {SCENE}^2 bf16 from np.memmap: predict "
              f"{wall_s * 1e3:.1f} ms = {mpx / wall_s:.2f} Mpx/s, peak "
              f"allocated {peak_s / 2**20:.0f} MiB; == in device memory: "
              f"{np.array_equal(ms, mask)}; kernels launched {launches_s}",
              flush=True)
        if not np.array_equal(ms, mask) or launches_s != expected:
            fail("fullconv streamed differs from in device memory")
        profile_runner(pred_s._get_runner(SCENE, SCENE), (m1, m2),
                       f"fullconv streamed {SCENE}^2 bf16 runner")
        del m1, m2

    with plain_versions():
        plain = fullconv.make_fullconv_scene_infer(
            pred.model, (SCENE, SCENE), band_rows=FC_BAND)(
                a1, a2).cpu().numpy()
        with torch.inference_mode():
            logits = pred.model(a1[None].bfloat16(), a2[None].bfloat16())[0]
    margin = (logits[..., 1] - logits[..., 0]).abs().cpu().numpy()
    scale = logits.abs().max().item()
    flips = mask != plain
    worst = float(margin[flips].max()) if flips.any() else 0.0
    print(f"fullconv {SCENE}^2 mask vs the same fullconv forward on the "
          f"plain versions on the card: agreement {1 - flips.mean():.6f} "
          f"({int(flips.sum())} flips, largest plain margin at a flip "
          f"{worst:.4g}, bound {scale / 16:.4g})", flush=True)
    if worst > scale / 16 or flips.mean() > 1e-3:
        fail("fullconv: the kernel forward disagrees with the plain one")
    del logits

    rows = check_kernels(band_calls(1, ctx, SCENE), reps=3, device_rng=True)
    band_kernel_summary(f"bf16, one band {ctx}x{SCENE}", rows, launches)
    for n, w in ((4, SCENE), (1, FC_WIDE[1])):  # held, not timed again
        check_kernels(band_calls(n, ctx, w), reps=1, device_rng=True)

    pred8 = ScenePredictor(cfg, bucket=512, device="cuda", quant="int8",
                           fullconv_band_rows=FC_BAND)
    pred8.predict(d1, d2)  # calibrates on this scene
    zero_counts(counters)
    m8, wall8, peak8 = timed(lambda: pred8.predict(d1, d2))
    launches8 = read_counts(counters)
    # and the clip probe's stats forward: a conv3x3 launch per site and
    # the five bf16 fusions
    expected8 = {"conv3x3_bias_relu": 18, "double_conv3x3_bias_relu": 0,
                 "fused_mul_relu": 5, "conv3x3_s8_q": 18 * n_bands,
                 "siamese_fuse_s8": 5 * n_bands}
    run8 = pred8._get_runner(SCENE, SCENE)
    fwd8_ms = device_ms(lambda: run8(a1, a2), 3)
    whole8 = fullconv.make_fullconv_scene_infer(
        pred8._forward, (SCENE, SCENE), band_rows=2 * SCENE)(
            a1, a2).cpu().numpy()
    print(f"fullconv {SCENE}^2 int8: predict {wall8 * 1e3:.1f} ms = "
          f"{mpx / wall8:.2f} Mpx/s, peak allocated {peak8 / 2**20:.0f} "
          f"MiB; device-resident runner {fwd8_ms:.1f} ms = "
          f"{mpx / fwd8_ms * 1e3:.2f} Mpx/s; kernels launched {launches8} "
          f"(expected {expected8}); banded == whole-scene int8: "
          f"{np.array_equal(m8, whole8)} ({int((m8 != whole8).sum())} "
          f"pixels differ)", flush=True)
    if launches8 != expected8 or not np.array_equal(m8, whole8):
        fail("fullconv int8: launches or banded == whole failed")
    with plain_int8():
        plain8 = fullconv.make_fullconv_scene_infer(
            pred8._forward, (SCENE, SCENE), band_rows=FC_BAND)(
                a1, a2).cpu().numpy()
    int8_identical(f"fullconv int8 {SCENE}^2 mask", m8, plain8, within)
    rows8 = check_int8_band(1, ctx, SCENE)
    band_kernel_summary(f"int8, one band {ctx}x{SCENE}", rows8, launches8)
    del a1, a2

    h, w = FC_WIDE
    rng = np.random.default_rng(SEED + 13)
    wide = [rng.standard_normal((h, w, 13), dtype=np.float32)
            for _ in range(2)]
    with tempfile.TemporaryDirectory(prefix="fabric_fc_") as root:
        w1, w2 = memmaps(root, wide)
        out = np.lib.format.open_memmap(os.path.join(root, "mask.npy"), "w+",
                                        np.uint8, (h, w))
        run_s = pred_s._get_runner(h, w)
        run_s(w1, w2, out=out)  # the runner's first call
        zero_counts(counters)
        _, wall_ws, peak_ws = timed(lambda: run_s(w1, w2, out=out))
        launches_w = read_counts(counters)
        expected_w = {**times({**block_calls(BASE, LEVEL_SIDE, ctx, w),
                               "fused_mul_relu": 5}, h // FC_BAND), **zeros8}
        pred.predict(*wide)  # the runner's first call
        in_dev, wall_wd, peak_wd = timed(lambda: pred.predict(*wide))
        same = np.array_equal(np.asarray(out), in_dev)
        print(f"fullconv streamed {h}x{w} bf16, np.memmap in and out: "
              f"{wall_ws * 1e3:.1f} ms = {h * w / 1e6 / wall_ws:.2f} Mpx/s, "
              f"peak allocated {peak_ws / 2**20:.0f} MiB, kernels launched "
              f"{launches_w} (expected {expected_w}); in device memory "
              f"{wall_wd * 1e3:.1f} ms = {h * w / 1e6 / wall_wd:.2f} Mpx/s, "
              f"peak {peak_wd / 2**20:.0f} MiB; masks equal: {same}; change "
              f"share {in_dev.mean():.4f}", flush=True)
        if not same or launches_w != expected_w:
            fail("fullconv: the wide streamed run differs from in device "
                 "memory or did not run the kernels as planned")
        del w1, w2, out
    return rows, rows8


def fullconv_multidate_phase(name: str, within):
    """Phase 7 for one multi-date family at T = 5, full width (UNetLSTM
    base 64, UNet3D base 32): a 1024^2 stack through ScenePredictor(
    fullconv_band_rows=512), bf16 (launches against 2 band forwards'
    count; banded = one whole-scene forward on the card, bit for bit;
    streamed = in device memory; the bi-date margin rule against the same
    fullconv forward on the plain versions), then int8 (banded = whole,
    identical to the plain versions)."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer import fullconv
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused

    cfg = Config(model=name, patch_size=PATCH, eval_batch_size=BATCH,
                 dtype="bfloat16", num_dates=MD_DATES)
    base = 64 if name == "unet_lstm" else 32
    halo = fullconv.halo_for(name, MD_DATES)  # what the predictor takes
    ctx = FC_BAND + 2 * halo
    n_bands = MD_SCENE // FC_BAND
    levels = (LEVEL_SIDE if name == "unet_lstm"
              else [k for k in LEVEL_SIDE if k.startswith("up")])
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, conv_s8.conv3x3_s8_q,
                conv_s8.conv3x3_s8, fuse_s8.siamese_fuse_s8)
    none8 = {"fused_mul_relu": 0, "conv3x3_s8_q": 0, "conv3x3_s8": 0,
             "siamese_fuse_s8": 0}
    mpx = MD_SCENE * MD_SCENE / 1e6
    # the grid phase's stack (multidate_phase), so the two modes compare
    stack = np.random.RandomState(SEED + 11).randn(
        MD_DATES, MD_SCENE, MD_SCENE, 13).astype(np.float32)
    a = torch.from_numpy(stack).cuda()

    def whole_of(model):  # one window: the whole-scene forward
        return fullconv.make_fullconv_scene_infer_multidate(
            model, (MD_SCENE, MD_SCENE), MD_DATES, band_rows=2 * MD_SCENE)(
                a).cpu().numpy()

    pred = ScenePredictor(cfg, bucket=512, device="cuda",
                          fullconv_band_rows=FC_BAND)
    pred.predict_multidate(stack)  # the runner's first call
    zero_counts(counters)
    mask, wall, peak = timed(lambda: pred.predict_multidate(stack))
    launches = read_counts(counters)
    per_band = block_calls(base, levels, ctx, MD_SCENE)
    if name == "unet_lstm":  # the gate conv, one signed launch a date
        per_band["conv3x3_bias_relu"] += MD_DATES
    expected = {**times(per_band, n_bands), **none8}
    whole = whole_of(pred.model)
    pred_s = ScenePredictor(cfg, bucket=512, device="cuda",
                            fullconv_band_rows=FC_BAND, fullconv_stream=True)
    streamed, wall_s, peak_s = timed(lambda: pred_s.predict_multidate(stack))
    run = pred._get_runner(MD_SCENE, MD_SCENE)
    fwd_ms = device_ms(lambda: run(a), 3)
    print(f"fullconv {name} T={MD_DATES} {MD_SCENE}^2 bf16 band {FC_BAND}, "
          f"halo {halo}: "
          f"predict_multidate {wall * 1e3:.1f} ms = {mpx / wall:.2f} Mpx/s, "
          f"peak allocated {peak / 2**20:.0f} MiB; device-resident runner "
          f"{fwd_ms:.1f} ms = {mpx / fwd_ms * 1e3:.2f} Mpx/s; streamed "
          f"{wall_s * 1e3:.1f} ms, peak {peak_s / 2**20:.0f} MiB; kernels "
          f"launched {launches} (expected {expected}); banded == whole-scene"
          f" forward: {np.array_equal(mask, whole)} "
          f"({int((mask != whole).sum())} pixels differ); streamed == in "
          f"device memory: {np.array_equal(streamed, mask)}; change share "
          f"{mask.mean():.4f}", flush=True)
    if launches != expected:
        fail(f"fullconv {name}: the kernels did not run as planned")
    if not (np.array_equal(mask, whole) and np.array_equal(streamed, mask)):
        fail(f"fullconv {name}: banded, whole-scene and streamed masks "
             "differ")
    profile_runner(run, (a,), f"fullconv {name} {MD_SCENE}^2 bf16 runner")
    with plain_versions():
        plain = fullconv.make_fullconv_scene_infer_multidate(
            pred.model, (MD_SCENE, MD_SCENE), MD_DATES, band_rows=FC_BAND,
            halo=halo)(a).cpu().numpy()
        with torch.inference_mode():
            logits = pred.model(a[None].bfloat16())[0]
    margin = (logits[..., 1] - logits[..., 0]).abs().cpu().numpy()
    scale = logits.abs().max().item()
    flips = mask != plain
    worst = float(margin[flips].max()) if flips.any() else 0.0
    # UNet3D at seed-0 weights has logits of ~0.46 and 0.49% of its pixels
    # within 0.001 of a tie; any two bf16 forwards that sum in other orders
    # flip ~1e-3 of its pixels (on an H100: its grid mode 0.998e-3 and
    # 1.014e-3 on two stacks, fullconv 1.13e-3 and 1.22e-3; the 1e-3 cap
    # sits at its tie density, not at a fault), so its flips are held to a
    # bound 8x tighter than the margin rule's and their share is reported
    # against the rule's 1e-3 cap
    bound_m, cap = (scale / 128, None) if name == "unet3d" else (
        scale / 16, 1e-3)
    print(f"fullconv {name} {MD_SCENE}^2 mask vs the same fullconv forward "
          f"on the plain versions on the card: agreement "
          f"{1 - flips.mean():.6f} ({int(flips.sum())} flips = "
          f"{flips.mean():.3e} of the pixels, cap {cap or 'not applied'}; "
          f"largest plain margin at a flip {worst:.4g}, bound {bound_m:.4g}"
          f"; pixels within 0.001 of a tie {(margin < 1e-3).mean():.3e})",
          flush=True)
    if worst > bound_m or (cap is not None and flips.mean() > cap):
        fail(f"fullconv {name}: the kernel forward disagrees with the plain "
             "one")
    del logits

    pred8 = ScenePredictor(cfg, bucket=512, device="cuda", quant="int8",
                           fullconv_band_rows=FC_BAND)
    pred8.predict_multidate(stack)  # calibrates on this stack
    zero_counts(counters)
    m8, wall8, peak8 = timed(lambda: pred8.predict_multidate(stack))
    launches8 = read_counts(counters)
    probe = 18 if name == "unet_lstm" else 8  # the clip probe's 2-D sites
    expected8 = {"conv3x3_bias_relu": probe, "double_conv3x3_bias_relu": 0,
                 "fused_mul_relu": 0, "conv3x3_s8_q": 18 * n_bands,
                 "conv3x3_s8": (2 * MD_DATES if name == "unet_lstm" else 0)
                 * n_bands, "siamese_fuse_s8": 0}
    whole8 = whole_of(pred8._forward)
    run8 = pred8._get_runner(MD_SCENE, MD_SCENE)
    fwd8_ms = device_ms(lambda: run8(a), 3)
    print(f"fullconv {name} T={MD_DATES} {MD_SCENE}^2 int8: predict_multidate"
          f" {wall8 * 1e3:.1f} ms = {mpx / wall8:.2f} Mpx/s, peak allocated "
          f"{peak8 / 2**20:.0f} MiB; device-resident runner {fwd8_ms:.1f} ms"
          f" = {mpx / fwd8_ms * 1e3:.2f} Mpx/s; kernels launched {launches8}"
          f" (expected {expected8}); banded == whole-scene int8: "
          f"{np.array_equal(m8, whole8)} ({int((m8 != whole8).sum())} "
          f"pixels differ)", flush=True)
    if launches8 != expected8 or not np.array_equal(m8, whole8):
        fail(f"fullconv {name} int8: launches or banded == whole failed")
    with plain_int8():
        plain8 = fullconv.make_fullconv_scene_infer_multidate(
            pred8._forward, (MD_SCENE, MD_SCENE), MD_DATES, band_rows=FC_BAND,
            halo=halo)(a).cpu().numpy()
    int8_identical(f"fullconv {name} int8 {MD_SCENE}^2 mask", m8, plain8,
                   within)


def validate_phase(cfg):
    """tools.validate_int8 on the trained checkpoint: the validation city,
    on whose crops the int8 predictor calibrates, and a training city,
    which it probes against those scales; fails past the tool's gates."""
    from fabric_tpu_torch.tools.validate_int8 import validate

    cfg.resume = cfg.weight_dir
    reports, ok = validate(cfg, cities=["val", "alpha"], device="cuda")
    for rep in reports:
        print(f"validate_int8 on the trained checkpoint: {json.dumps(rep)}",
              flush=True)
    if not ok:
        fail("validate_int8 refuses the int8 serving of the trained "
             "checkpoint (agreement < 0.95 or F1 drop > 0.01)")


def _digest(batch) -> str:
    """sha256 over a batch's keys and bytes, on the host."""
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(batch[k].cpu().numpy().tobytes())
    return h.hexdigest()


def loader_phase(cfg, state, step, smi):
    """The last epoch's batches as the loop draws them, from the prefetch
    thread (num_workers 0) and from N worker processes: the first 3
    batches of each hashed and compared, then ms per batch of the source
    alone (host clock, after the first batch, which carries the workers'
    start) and with the train step, and the H2D copy of one pinned batch
    alone (CUDA events).  Returns {workers: ms alone}."""
    from fabric_tpu_torch.data.oscd import full_load, get_train_val_metadata
    from fabric_tpu_torch.train.loop import EpochBatches

    n_workers = max(1, (os.cpu_count() or 2) - 1)
    shm = shutil.disk_usage("/dev/shm")
    batch_mb = T_BATCH * T_PATCH ** 2 * 13 * 2 * 4 / 1e6
    print(f"loader: os.cpu_count() {os.cpu_count()}, N = {n_workers} "
          f"workers; /dev/shm {shm.total / 1e9:.1f} GB ({shm.free / 1e9:.1f} "
          f"GB free), {batch_mb:.0f} MB of images a batch in flight",
          flush=True)
    data = full_load(cfg.dataset_dir, cfg, max_workers=cfg.num_workers or None)
    train_md, _ = get_train_val_metadata(
        cfg.dataset_dir, cfg.validation_cities, cfg.patch_size, cfg.stride)
    epoch = T_EPOCHS - 1
    digests, alone = {}, {}
    for workers in (0, n_workers):
        c = type(cfg).from_dict({**cfg.to_dict(), "num_workers": workers})
        source = EpochBatches(c, data, train_md, [], "cuda")
        try:
            t0 = time.perf_counter()
            it = source.train(epoch)
            first = [next(it) for _ in range(3)]
            first_s = time.perf_counter() - t0
            it.close()
            digests[workers] = [_digest(b) for b in first]

            def ms_per_batch(consume) -> float:
                it = source.train(epoch)
                consume(next(it))
                torch.cuda.synchronize()
                t0, n = time.perf_counter(), 0
                for batch in it:
                    consume(batch)
                    n += 1
                torch.cuda.synchronize()
                return 1e3 * (time.perf_counter() - t0) / n
            alone[workers] = ms_per_batch(lambda b: None)
            with_step = ms_per_batch(lambda b: step(state, b))
        finally:
            source.close()
        print(f"loader, {workers} workers ({'thread' if not workers else 'processes'}; "
              f"{smi}): first 3 batches in {first_s:.2f} s; source alone "
              f"{alone[workers]:.1f} ms a batch = "
              f"{1e3 * T_BATCH / alone[workers]:.1f} examples/s; with the "
              f"train step {with_step:.1f} ms a step = "
              f"{1e3 * T_BATCH / with_step:.1f} train examples/s", flush=True)
    same = digests[0] == digests[n_workers]
    print(f"loader: first 3 batches, thread vs {n_workers} workers: sha256 "
          f"{'equal' if same else 'DIFFERENT'} ({digests[0][0][:16]}..., "
          f"{digests[0][1][:16]}..., {digests[0][2][:16]}...)", flush=True)
    if not same:
        fail("the worker processes' batches differ from the thread's")
    pinned = {k: v.cpu().pin_memory() for k, v in first[0].items()}
    h2d_ms = device_ms(lambda: {k: v.to("cuda", non_blocking=True)
                                for k, v in pinned.items()}, 5)
    nbytes = sum(v.numel() * v.element_size() for v in pinned.values())
    print(f"loader: H2D copy of one pinned batch ({nbytes / 1e6:.1f} MB) "
          f"{h2d_ms:.2f} ms = {nbytes / h2d_ms / 1e6:.1f} GB/s (CUDA "
          f"events, {smi})", flush=True)
    return alone


def _step_batch(seed: int):
    rng = np.random.RandomState(seed)
    img1 = rng.randn(T_BATCH, T_PATCH, T_PATCH, 13).astype(np.float32)
    label = (rng.rand(T_BATCH, T_PATCH, T_PATCH) < 0.3).astype(np.int32)
    img2 = img1 + 0.3 * rng.randn(*img1.shape).astype(np.float32)
    img2[label == 1] += 1.5
    return {k: torch.from_numpy(v).cuda() for k, v in (
        ("img1", img1), ("img2", img2), ("label", label),
        ("weight", np.ones(T_BATCH, np.float32)))}


def remat_accum_phase(smi):
    """At full width, patch 96, batch 128, bf16: one train forward and
    backward with remat off and on from the same weights and batch
    (gradients, BatchNorm running statistics, peak memory, time), then
    four micro steps of the train step at grad_accum_steps=2 with remat:
    the parameters hold still after micro steps 1 and 3 and move after 2
    and 4; the fused kernel's launches are counted."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.ops import bn_relu, fused
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step
    from fabric_tpu_torch.weights import init_variables

    variables = init_variables(13, 2, BASE,
                               torch.Generator().manual_seed(SEED + 2))
    batch = _step_batch(SEED + 2)
    out = {}
    for remat in (False, True):
        cfg = Config(model_base=BASE, patch_size=T_PATCH,
                     batch_size=T_BATCH, dtype="bfloat16", remat=remat,
                     loss_function="tversky")
        model = build_model(cfg, "cuda", fold_bn=False, variables=variables,
                            train=True)
        loss_fn = get_loss_fn(cfg)

        def fwd_bwd():
            for p in model.parameters():
                p.grad = None
            loss = loss_fn(model(batch["img1"], batch["img2"], train=True),
                           batch["label"])
            loss.backward()
            return loss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        loss = fwd_bwd()
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        stats = {n: b.clone() for n, b in model.named_buffers()}
        ms = device_ms(fwd_bwd, 3)
        out[remat] = (loss.item(), grads, stats, peak_mb, base_mb, ms)
        del model
    (l0, g0, s0, p0, b0, t0), (l1, g1, s1, p1, b1, t1) = (out[False],
                                                          out[True])
    # the biases of the convs before a train-mode BatchNorm have zero
    # gradient analytically: theirs is rounding noise, so each gradient is
    # measured against the larger of its own largest component and a
    # tenth of the model's largest
    top = max(g.abs().max().item() for g in g0.values())
    rels = {k: (g1[k] - g0[k]).abs().max().item()
            / max(g0[k].abs().max().item(), 0.1 * top) for k in g0}
    worst = max(rels, key=rels.get)
    rel = rels[worst]
    stats_equal = all(torch.equal(s0[k], s1[k]) for k in s0)
    # cuDNN's weight-gradient kernels may sum in another order from run
    # to run; bound: each gradient within 2e-2 of its scale above (a few
    # bf16 roundings), the loss equal, the statistics bit-equal
    ok = rel <= 2e-2 and l0 == l1 and stats_equal
    print(f"remat ({smi}): train forward + backward, full width, batch "
          f"{T_BATCH} at patch {T_PATCH}, bf16: loss {l0:.6f} vs {l1:.6f}; "
          f"gradients' largest relative difference {rel:.3g} at {worst} "
          f"(bound 2e-2 of each tensor's scale); BatchNorm running "
          f"statistics {'equal' if stats_equal else 'DIFFERENT'}; peak "
          f"memory {p0:.0f} MiB without, {p1:.0f} MiB with remat (model "
          f"and batch {b0:.0f} MiB; activations {p0 - b0:.0f} vs "
          f"{p1 - b1:.0f} MiB); {t0:.1f} vs {t1:.1f} ms (CUDA events)",
          flush=True)
    if not ok:
        fail("remat changes the train step")

    cfg = Config(model_base=BASE, patch_size=T_PATCH, batch_size=T_BATCH,
                 dtype="bfloat16", remat=True, grad_accum_steps=2,
                 learning_rate=0.05, loss_function="tversky")
    model = build_model(cfg, "cuda", fold_bn=False, variables=variables,
                        train=True)
    state = create_state(cfg, model)
    step = make_train_step(model, get_loss_fn(cfg))
    batches = [batch, _step_batch(SEED + 3)]
    for fn in (fused.fused_mul_relu, bn_relu.bn_relu_inference):
        fn.launches = 0
    moved = []
    for micro in range(4):
        before = [p.detach().clone() for p in model.parameters()]
        step(state, batches[micro % 2])
        moved.append(not all(torch.equal(b, p.detach()) for b, p in
                             zip(before, model.parameters())))
    torch.cuda.synchronize()
    launches = {"fused_mul_relu": fused.fused_mul_relu.launches,
                "bn_relu_inference": bn_relu.bn_relu_inference.launches}
    expected = {"fused_mul_relu": 4 * 5, "bn_relu_inference": 0}
    print(f"grad_accum_steps=2 with remat, 4 micro steps: parameters moved "
          f"{moved} (expected [False, True, False, True]); step "
          f"{state.step}, optimizer updates {state.tx.gradient_step}; "
          f"kernels launched {launches} (expected {expected})", flush=True)
    if moved != [False, True, False, True] or launches != expected \
            or state.tx.gradient_step != 2:
        fail("gradient accumulation did not update every second step")
    return launches


def store_phase(cfg, root):
    """A short run (2 epochs of 3 steps, a periodic save every 2) with
    output_store=file://<root>/store, then a resume from the store URI:
    the restored parameters, statistics and optimizer state equal the
    local checkpoint's bit for bit, and the resumed run trains on."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.loop import train
    from fabric_tpu_torch.train.state import create_state

    store = f"file://{os.path.join(root, 'store')}"
    c = type(cfg).from_dict({
        **cfg.to_dict(), "weight_dir": os.path.join(root, "w_store"),
        "log_dir": os.path.join(root, "l_store"), "epochs": 1,
        "steps_per_epoch": 3, "checkpoint_every": 2, "output_store": store,
        "resume": ""})
    t0 = time.perf_counter()
    state, history = train(c, run_scene_inference=False)
    wall = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(root, "store")))
    local = ckpt.read_payload(ckpt.latest_checkpoint(c.weight_dir))
    r = type(cfg).from_dict({**c.to_dict(), "resume": store,
                             "output_store": "", "epochs": 2,
                             "weight_dir": os.path.join(root, "w_resume")})
    restored = create_state(r, build_model(r, "cuda", fold_bn=False,
                                           train=True))
    restored, epoch, _ = ckpt.resume_if_requested(r, restored)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)
    got = dict(leaves({"params": restored.variables()[0],
                       "batch_stats": restored.variables()[1],
                       "opt_state": restored.opt_state}))
    want = dict(leaves({k: local[k] for k in ("params", "batch_stats",
                                              "opt_state")}))
    same = got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want) and restored.step == local["step"]
    state2, history2 = train(r, run_scene_inference=False)
    print(f"store: {wall:.1f} s run mirrored {len(names)} entries to {store} "
          f"({', '.join(n for n in names if n.endswith('.json'))}); resume "
          f"from the store URI: epoch {epoch}, step {restored.step}, "
          f"{len(got)} leaves {'bit-equal' if same else 'DIFFERENT'} to the "
          f"local checkpoint; the resumed run ended at step {state2.step}",
          flush=True)
    if not (same and "tracker" in names and history["status"] ==
            history2["status"] == "complete" and state2.step == 6):
        fail("the store run or the resume from its URI went wrong")


def evaluate_phase(cfg, root, smi):
    """cli.evaluate's main on the training run's best checkpoint over the
    validation city, the dataset given as a .tar.gz of that city's
    synthetic images and labels (ensure_dataset extracts it; the training
    cities stay out, as evaluate never reads them): its patch metrics and
    scene F1
    equal what the loop recorded with that checkpoint.  Returns the
    kernel launches it made."""
    import tarfile

    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.cli.evaluate import main as evaluate_main
    from fabric_tpu_torch.data.oscd import patch_grid
    from fabric_tpu_torch.ops import bn_relu, fused

    t0 = time.perf_counter()
    archive = os.path.join(root, "cities.tar.gz")

    def val_only(info):  # onera/{images,labels}/<city>/...
        parts = info.name.split("/")
        return None if len(parts) > 2 and parts[2] != "val" else info
    with tarfile.open(archive, "w:gz", compresslevel=1) as tf:
        tf.add(cfg.dataset_dir, arcname="onera", filter=val_only)
    tar_s = time.perf_counter() - t0
    path = ckpt.read_pointer(cfg.weight_dir, "best")
    epoch = int(path.rsplit("_", 1)[1].split(".")[0])
    with open(os.path.join(cfg.weight_dir,
                           f"metadata_epoch_{epoch}.json")) as fin:
        recorded = json.load(fin)["validation_metrics"]
    cfg_path = os.path.join(root, "eval_cfg.json")
    with open(cfg_path, "w") as fout:
        json.dump({**cfg.to_dict(),
                   "dataset_dir": os.path.join(root, "eval_data"),
                   "dataset_name": archive}, fout)
    out = os.path.join(root, "eval.json")
    for fn in (bn_relu.bn_relu_inference, fused.fused_mul_relu):
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        rc = evaluate_main(["--config", cfg_path, "--resume", cfg.weight_dir,
                            "--city", "val", "--output", out])
    wall = time.perf_counter() - t0
    launches = {"bn_relu_inference": bn_relu.bn_relu_inference.launches,
                "fused_mul_relu": fused.fused_mul_relu.launches}
    with open(out) as fin:
        result = json.load(fin)
    n_val = len(patch_grid(T_CITIES["val"], T_PATCH, cfg.stride))
    tiles = 1
    for side in T_CITIES["val"]:
        tiles *= -(-side // T_PATCH)
    forwards = min(T_STEPS, -(-n_val // T_BATCH)) + -(-tiles // T_BATCH)
    expected = {"bn_relu_inference": 18 * forwards,
                "fused_mul_relu": 5 * forwards}
    keys = ("cd_losses", "cd_corrects", "cd_precisions", "cd_recalls",
            "cd_f1scores", "global_precision", "global_recall", "global_f1",
            "global_accuracy")
    diff = {k: abs(result["patch"][k] - recorded[k]) for k in keys}
    same = all(v == 0 for v in diff.values()) and \
        result["scenes"]["val"]["f1"] == recorded["val_scene_f1"]
    print(f"evaluate ({smi}): python -m fabric_tpu_torch.cli.evaluate's "
          f"main on {os.path.basename(path)} over 'val' from a "
          f"{os.path.getsize(archive) / 1e6:.0f} MB .tar.gz (written in "
          f"{tar_s:.1f} s): rc {rc}, {wall:.1f} s wall (extraction, loading, "
          f"{forwards} eval forwards); patch metrics vs the loop's "
          f"validation metrics for that checkpoint: "
          f"{'equal' if same else 'DIFFERENT ' + json.dumps(diff)} (cd_f1scores "
          f"{result['patch']['cd_f1scores']:.6f}, scene F1 "
          f"{result['scenes']['val']['f1']:.6f}); kernels launched "
          f"{launches} (expected {expected})", flush=True)
    if rc != 0 or not same or launches != expected:
        fail("cli.evaluate disagrees with the loop or missed the kernels")
    return launches


# multi-date training phase: dates, steps an epoch, the families' widths
MD_T, MD_STEPS = 5, 10
MD_BASE = {"unet_lstm": 64, "unet3d": 32}
# activations of BiDateNet's train step at batch 128, patch 96, base 64,
# bf16 (256 encoder images; the remat phase's measure on the H100)
BIDATE_ACT_MIB = 12023


def md_memory_reckoning(name: str, smi: str) -> int:
    """The largest power-of-two batch, up to T_BATCH, whose train step
    the card holds: activations scaled from BiDateNet's by encoder images
    (N T against 2 N) and width, against 90% of the free memory."""
    free_mib = torch.cuda.mem_get_info()[0] / 2 ** 20
    per_128 = (BIDATE_ACT_MIB * (T_BATCH * MD_T) / (2 * T_BATCH)
               * MD_BASE[name] / BASE)
    batch = T_BATCH
    while batch > 1 and per_128 * batch / T_BATCH > 0.9 * free_mib:
        batch //= 2
    print(f"multi-date {name} memory ({smi}): the step at batch {T_BATCH} "
          f"encodes {T_BATCH * MD_T} images at base {MD_BASE[name]}; "
          f"reckoned activations {per_128:.0f} MiB (BiDateNet's "
          f"{BIDATE_ACT_MIB} MiB at 256 encoder images x "
          f"{T_BATCH * MD_T / (2 * T_BATCH):.2f} x {MD_BASE[name]}/{BASE}) "
          f"against {free_mib:.0f} MiB free: batch {batch}"
          f"{'' if batch == T_BATCH else ' (batch 128 does not fit)'}",
          flush=True)
    return batch


def md_loader_reckoning(data_bytes: int, batch: int) -> tuple[int, int]:
    """(workers, prefetch) for the multi-date loaders: the most workers
    (up to os.cpu_count() - 1), then the deepest prefetch (2, else 1),
    whose train and validation rings fit /dev/shm beside the shared
    dataset with a 10% margin; fails if none does (the prefetch thread
    would be another loader under the same label)."""
    from fabric_tpu_torch.data import loader

    free = shutil.disk_usage(loader.SHM).free
    slot = loader.ring_bytes(1, 1, batch, T_PATCH, MD_T, 13,
                             True) / loader.ring_slots(1, 1)
    for workers in range(max(1, (os.cpu_count() or 2) - 1), 0, -1):
        for prefetch in (2, 1):
            rings = 2 * loader.ring_bytes(workers, prefetch, batch, T_PATCH,
                                          MD_T, 13, True)
            if data_bytes + rings <= 0.9 * free:
                print(f"multi-date loader: /dev/shm {free / 1e9:.2f} GB "
                      f"free; the shared dataset {data_bytes / 1e9:.2f} GB + "
                      f"train and validation rings of {workers} workers x "
                      f"prefetch {prefetch} + 2 slots ({slot / 1e6:.0f} "
                      f"MB a slot) {rings / 1e9:.2f} GB fit: {workers} "
                      f"workers, prefetch {prefetch}", flush=True)
                return workers, prefetch
    fail(f"multi-date loader: /dev/shm's {free} free bytes hold no worker "
         f"ring beside the {data_bytes}-byte dataset (one worker, prefetch "
         f"1: {2 * loader.ring_bytes(1, 1, batch, T_PATCH, MD_T, 13, True)}"
         f" bytes of rings)")


KERNEL_CLASSES = (  # (class, substrings of a kernel's name), first match
    ("fabric", ("fabric::",)),
    ("conv (cuDNN)", ("xmma", "cudnn", "conv", "implicit_gemm", "wgrad",
                      "dgrad", "fprop")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "cublas")),
    ("reduction", ("reduce_kernel",)),
    ("copy / cast", ("copy", "CatArray")),
    ("elementwise", ("elementwise",)),
)


def trace_top_ops(logdir: str, steps: int, top: int = 8) -> str:
    """What the device did in a loop's profile_dir trace, per traced step:
    kernel time by class (KERNEL_CLASSES, by name) and the ``top``
    PyTorch operations by the kernel time they launched (a kernel's
    "External id" names its launching op); fails if there is no
    non-empty trace or no kernel in it."""
    import glob

    paths = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(paths) != 1 or os.path.getsize(paths[0]) == 0:
        fail(f"profile_dir {logdir} holds no trace: {paths}")
    with open(paths[0]) as fin:
        events = json.load(fin)["traceEvents"]
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op"
             and "External id" in e.get("args", {})}
    by_class: dict = {}
    by_op: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e["name"] for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
        op = op_of.get(e.get("args", {}).get("External id"), "?")
        by_op[op] = by_op.get(op, 0.0) + e["dur"]
    if not by_class:
        fail(f"the trace {paths[0]} holds no device kernel")
    total = sum(by_class.values())

    def ranked(d, n):
        return "; ".join(f"{k} {v / 1e3 / steps:.2f} ms ({v / total:.1%})"
                         for k, v in sorted(d.items(),
                                            key=lambda kv: -kv[1])[:n])
    return (f"trace {os.path.basename(paths[0])} "
            f"({os.path.getsize(paths[0]) / 1e6:.1f} MB): device kernels "
            f"{total / 1e3 / steps:.1f} ms a step over {steps} traced "
            f"steps; by class: {ranked(by_class, len(by_class))}; top "
            f"operations by the kernel time they launched: "
            f"{ranked(by_op, top)}")


def md_eval_vs_plain(cfg, model) -> None:
    """The trained model's eval forward (BatchNorm unfolded: row 4 after
    every conv over the (N T, H, W, C) views, and with local_upsample
    UNetLSTM's gate conv as row 1's signed launch) on the validation
    city's first batch of patches, once on the kernels and once on their
    plain versions: the kernels' launches for one forward, finite logits,
    and the argmax held to the plain forward's by the margin rule (a
    flip only where the plain logit margin is within 1/16 of the logit
    scale, at most 1e-3 of the pixels).  These launches are not the main
    path's: the phase reads its counts before."""
    from fabric_tpu_torch.data.oscd import load_city, patch_grid
    from fabric_tpu_torch.ops import bn_relu, conv, double_conv, fused

    city = load_city(cfg.dataset_dir, "val", cfg, num_dates=MD_T)
    grid = patch_grid(T_CITIES["val"], T_PATCH, cfg.stride)[:cfg.batch_size]
    imgs = torch.from_numpy(np.stack(
        [city[:, i:i + T_PATCH, j:j + T_PATCH] for i, j in grid])).cuda()
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, bn_relu.bn_relu_inference)
    zero_counts(counters)
    with torch.inference_mode():
        got = model(imgs)
        torch.cuda.synchronize()
    launches = read_counts(counters)
    with plain_versions(), torch.inference_mode():
        ref = model(imgs)
    expected = {"conv3x3_bias_relu": MD_T if cfg.local_upsample else 0,
                "double_conv3x3_bias_relu": 0, "fused_mul_relu": 0,
                "bn_relu_inference": 18}
    margin = (ref[..., 1] - ref[..., 0]).abs()
    flips = got.argmax(-1) != ref.argmax(-1)
    worst = margin[flips].max().item() if flips.any() else 0.0
    scale = ref.abs().max().item()
    share = flips.float().mean().item()
    finite = bool(torch.isfinite(got).all())
    print(f"multi-date {cfg.model} eval forward of the trained model on the "
          f"validation city's first {len(grid)} patches ({tuple(imgs.shape)}"
          f", bf16, BatchNorm unfolded), kernels vs their plain versions: "
          f"kernels launched {launches} (expected {expected}); logits max "
          f"abs diff {(got - ref).abs().max().item():.4g} (scale "
          f"{scale:.4g}); argmax agreement {1 - share:.6f} "
          f"({int(flips.sum())} flips, largest plain margin at a flip "
          f"{worst:.4g}, bound {scale / 16:.4g})", flush=True)
    if launches != expected or not finite or worst > scale / 16 \
            or share > 1e-3:
        fail(f"{cfg.model}'s trained eval forward on the kernels disagrees "
             "with the plain versions")


def md_card_vs_cpu_step(name: str) -> None:
    """One fp32 train step (TF32 off) of ``name`` at base 16, T = 3, batch
    4, patch 32, on the card and on the CPU from the same weights and
    batch: card_vs_cpu_step's bounds."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step
    from fabric_tpu_torch.weights import flatten_tree, init_variables

    cfg = Config(model=name, model_base=16, num_dates=3, patch_size=32,
                 batch_size=4, dtype="float32", learning_rate=0.05)
    variables = init_variables(13, 2, 16,
                               torch.Generator().manual_seed(SEED + 4), name)
    rng = np.random.RandomState(SEED + 4)
    imgs = rng.randn(4, 3, 32, 32, 13).astype(np.float32)
    label = (rng.rand(4, 32, 32) < 0.3).astype(np.int32)
    imgs[:, -1][label == 1] += 1.5
    batch = {"imgs": imgs, "label": label, "weight": np.ones(4, np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev, fold_bn=False, variables=variables,
                            train=True)
        state = create_state(cfg, model)
        _, stats = make_train_step(model, get_loss_fn(cfg))(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[dev] = (stats["loss"].item(),) + tuple(
            flatten_tree(t) for t in state.variables())
    (l_gpu, pg, sg), (l_cpu, pc, sc) = out["cuda"], out["cpu"]
    p0 = flatten_tree(variables[0])
    step_max = max(np.abs(pc[k] - p0[k]).max() for k in pc)
    p_err, p_worst = max((np.abs(pg[k] - pc[k]).max(), k) for k in pc)
    s_err = max((np.abs(sg[k] - sc[k]) / (np.abs(sc[k]) + 1e-3)).max()
                for k in sc)
    l_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    ok = l_err <= 1e-5 and p_err <= 1e-2 * step_max and s_err <= 1e-3
    print(f"multi-date {name} fp32 train step, card vs CPU (base 16, T = 3, "
          f"batch 4, patch 32): loss {l_gpu:.7f} vs {l_cpu:.7f} (rel "
          f"{l_err:.3g}, bound 1e-5); params max diff {p_err:.3g} at "
          f"{p_worst} (bound 1e-2 x largest update {step_max:.4g}); BN "
          f"stats rel diff {s_err:.3g} (bound 1e-3): "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"the {name} train step on the card disagrees with the CPU's")


def md_evaluate(cfg, root: str, smi: str) -> None:
    """cli.evaluate's main on the run's best checkpoint over the
    validation city: its patch metrics and scene F1 equal what the loop
    recorded with that checkpoint."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.cli.evaluate import main as evaluate_main

    path = ckpt.read_pointer(cfg.weight_dir, "best")
    epoch = int(path.rsplit("_", 1)[1].split(".")[0])
    with open(os.path.join(cfg.weight_dir,
                           f"metadata_epoch_{epoch}.json")) as fin:
        recorded = json.load(fin)["validation_metrics"]
    cfg_path = os.path.join(root, f"eval_{cfg.model}.json")
    with open(cfg_path, "w") as fout:
        json.dump(cfg.to_dict(), fout)
    out = os.path.join(root, f"eval_{cfg.model}_out.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        rc = evaluate_main(["--config", cfg_path, "--resume", cfg.weight_dir,
                            "--city", "val", "--output", out])
    wall = time.perf_counter() - t0
    with open(out) as fin:
        result = json.load(fin)
    keys = ("cd_losses", "cd_corrects", "cd_precisions", "cd_recalls",
            "cd_f1scores", "global_precision", "global_recall", "global_f1",
            "global_accuracy")
    diff = {k: abs(result["patch"][k] - recorded[k]) for k in keys}
    same = all(v == 0 for v in diff.values()) and \
        result["scenes"]["val"]["f1"] == recorded["val_scene_f1"]
    print(f"multi-date {cfg.model} evaluate ({smi}): cli.evaluate on "
          f"{os.path.basename(path)}: rc {rc}, {wall:.1f} s wall; patch and "
          f"scene metrics vs the loop's for that checkpoint: "
          f"{'equal' if same else 'DIFFERENT ' + json.dumps(diff)} "
          f"(cd_f1scores {result['patch']['cd_f1scores']:.6f}, scene F1 "
          f"{result['scenes']['val']['f1']:.6f})", flush=True)
    if rc != 0 or not same:
        fail(f"cli.evaluate of {cfg.model} disagrees with the loop")


def md_dataset(root: str) -> tuple[str, float]:
    """Write the multi-date phase's 5-date synthetic dataset (T_CITIES,
    MD_T dates) under ``root``: (its directory, the seconds it took)."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset

    data_dir = os.path.join(root, "md_data")
    t0 = time.perf_counter()
    generate_synthetic_dataset(data_dir, Config(), cities=list(T_CITIES),
                               sizes=list(T_CITIES.values()), seed=SEED + 5,
                               num_dates=MD_T)
    return data_dir, time.perf_counter() - t0


def multidate_train_phase(root: str, smi: str, md_data) -> dict:
    """UNetLSTM (base 64, with local_upsample: its eval gate conv is the
    signed row-1 launch) and UNet3D (base 32) at T = 5 through
    train.loop.train on a 5-date synthetic dataset (four ~1024^2 cities,
    one for validation): tversky + SGD, bf16, patch 96, 2 epochs of
    MD_STEPS steps with validation, scene inference of the validation
    city, a checkpoint and a profile_dir trace of the first 3 steps;
    then the trained eval forward on the kernels against their plain
    versions (md_eval_vs_plain).  ``md_data``: the future of
    :func:`md_dataset`, written while the phases before wait on their
    ranks.  Returns {family: launches}."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.data.oscd import patch_grid
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.ops import bn_relu, conv, double_conv, fused
    from fabric_tpu_torch.train.loop import train
    from fabric_tpu_torch.train.steps import make_train_step

    data_dir, data_s = md_data.result()
    data_bytes = sum(MD_T * h * w * 13 * 4 + h * w
                     for h, w in T_CITIES.values())
    print(f"multi-date synthetic dataset, {MD_T} dates, {T_CITIES}, written "
          f"in {data_s:.1f} s while dp_train and sp_train ran "
          f"({data_bytes / 1e9:.2f} GB in memory)", flush=True)
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, bn_relu.bn_relu_inference)
    n_val = len(patch_grid(T_CITIES["val"], T_PATCH, 32))
    tiles = 1
    for side in T_CITIES["val"]:
        tiles *= -(-side // T_PATCH)
    all_launches = {}
    for name in ("unet_lstm", "unet3d"):
        torch.cuda.empty_cache()
        batch = md_memory_reckoning(name, smi)
        workers, prefetch = md_loader_reckoning(data_bytes, batch)
        prof_dir = os.path.join(root, f"profile_{name}")
        cfg = Config(model=name, num_dates=MD_T, model_base=MD_BASE[name],
                     dataset_dir=data_dir,
                     weight_dir=os.path.join(root, f"weights_{name}"),
                     log_dir=os.path.join(root, f"logs_{name}"),
                     patch_size=T_PATCH, stride=32, batch_size=batch,
                     epochs=T_EPOCHS, steps_per_epoch=MD_STEPS,
                     learning_rate=0.05, loss_function="tversky",
                     optimizer="sgd", dtype="bfloat16",
                     validation_cities=["val"], num_workers=workers,
                     prefetch=prefetch, seed=SEED,
                     local_upsample=name == "unet_lstm",
                     profile_dir=prof_dir, profile_steps=3)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        state, history = train(cfg)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        evals = T_EPOCHS * (min(MD_STEPS, -(-n_val // batch))
                            + -(-tiles // batch))
        expected = {"conv3x3_bias_relu":
                    MD_T * evals if cfg.local_upsample else 0,
                    "double_conv3x3_bias_relu": 0, "fused_mul_relu": 0,
                    "bn_relu_inference": 18 * evals}
        print(f"multi-date {name} train.loop.train: {wall:.1f} s wall; "
              f"kernels launched {launches} (expected {expected}: "
              f"{evals} eval forwards, the validation batches and the "
              f"scene's tiles, 18 eval-BatchNorm launches each"
              f"{f' and {MD_T} signed gate convs' if cfg.local_upsample else ''})",
              flush=True)
        if launches != expected:
            fail(f"{name}'s validation and scene passes did not go through "
                 "the kernels as planned")
        all_launches[name] = launches
        md_eval_vs_plain(cfg, state.model)
        print(f"multi-date {name} profile_dir ({smi}): "
              f"{trace_top_ops(prof_dir, cfg.profile_steps)}", flush=True)

        run_dir = os.path.join(cfg.log_dir, os.listdir(cfg.log_dir)[0])
        with open(os.path.join(run_dir, "metrics.jsonl")) as fin:
            records = [json.loads(line) for line in fin]
        epochs = {r["_step"]: r for r in records
                  if "train_examples_per_sec" in r}
        last = epochs[T_EPOCHS - 1]
        g = torch.Generator().manual_seed(SEED)
        imgs = torch.randn(batch, MD_T, T_PATCH, T_PATCH, 13,
                           generator=g).cuda()
        step_batch = {"imgs": imgs,
                      "label": (imgs[:, -1, ..., 0] > imgs[:, 0, ..., 0]).to(
                          torch.int32),
                      "weight": torch.ones(batch, device="cuda")}
        step = make_train_step(state.model, get_loss_fn(cfg))
        step(state, step_batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2 ** 20
        step_ms = device_ms(lambda: step(state, step_batch), 5)
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = [h["cd_losses"] for h in history["train"]]
        print(f"multi-date {name} training ({smi}): "
              f"{last['train_examples_per_sec']:.1f} train examples/s in "
              f"epoch {T_EPOCHS - 1} (steady state; "
              f"{epochs[0]['train_examples_per_sec']:.1f} in epoch 0), T = "
              f"{MD_T}, patch {T_PATCH}, batch {batch}, base "
              f"{MD_BASE[name]}, bf16, tversky + SGD, {workers} loader "
              f"workers; the loop's wait for the loader "
              f"{last['train_feed_wait_s']:.2f} s in the epoch; "
              f"{step_ms:.1f} ms a step with the batch resident "
              f"on the card (CUDA events); peak memory {peak_mib:.0f} MiB "
              f"(model, optimizer and batch {base_mib:.0f} MiB; activations "
              f"{peak_mib - base_mib:.0f} MiB); train cd_losses per epoch "
              f"{[round(v, 4) for v in losses]}; validation cd_f1scores "
              f"{[round(v['cd_f1scores'], 4) for v in history['val']]}; "
              f"scene F1 "
              f"{[round(v.get('val_scene_f1', -1), 4) for v in history['val']]}",
              flush=True)
        if history["status"] != "complete" or not np.isfinite(losses).all() \
                or not losses[-1] < losses[0]:
            fail(f"{name} training did not complete with a falling, finite "
                 "loss")
        del state, step, step_batch, imgs
        md_card_vs_cpu_step(name)
        md_evaluate(cfg, root, smi)
    return all_launches


# multi-GPU on one card: n shards standing in for n cards
SHARDS = (2, 4)                 # the sharded serve's mesh sizes
DP_RANKS, DP_STEPS, DP_BATCH = 2, 3, 128  # dp_train: ranks, steps, batch


def sharded_serve_phase(d1, d2, grid_mask):
    """The 2048^2 pair served with the scene split into H-bands over a
    mesh of n = 2 and 4 shards of the one card (``[cuda:0] * n``): grid
    and fullconv (band 512, halo 128), bf16 and int8, each mask bit-equal
    to the single-device mask of its mode and each run's kernel launches
    equal to the single-device run's; a shard's band bytes against the
    whole scene's, ms and Mpx/s.  Returns the sharded runs' launches."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.infer.sharded_scene import put_scene_sharded
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused
    from fabric_tpu_torch.parallel.mesh import make_mesh

    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu, conv_s8.conv3x3_s8_q,
                conv_s8.conv3x3_s8, fuse_s8.siamese_fuse_s8)
    mpx = SCENE * SCENE / 1e6
    scene_bytes = SCENE * SCENE * 13 * 2  # one date in bf16
    total: dict = {}
    for quant in ("none", "int8"):
        for band in (0, FC_BAND):
            mode = (f"{'fullconv' if band else 'grid'} "
                    f"{'int8' if quant == 'int8' else 'bf16'}")
            one = ScenePredictor(cfg, bucket=512, device="cuda", quant=quant,
                                 fullconv_band_rows=band)
            if quant == "none" and not band:
                want = grid_mask
            else:
                one.predict(d1, d2)  # first call (int8: calibrates)
                want = one.predict(d1, d2)
            zero_counts(counters)
            one.predict(d1, d2)
            want_launches = read_counts(counters)
            for n in SHARDS:
                mesh = make_mesh(n, devices=[torch.device("cuda", 0)] * n)
                pred = ScenePredictor(cfg, bucket=512, device="cuda",
                                      quant=quant, fullconv_band_rows=band,
                                      mesh=mesh, shard_scene=True)
                pred.predict(d1, d2)  # first call (int8: calibrates)
                zero_counts(counters)
                got, wall, peak = timed(lambda: pred.predict(d1, d2))
                launches = read_counts(counters)
                b1, b2 = (put_scene_sharded(d, mesh, torch.bfloat16)
                          for d in (d1, d2))
                run = pred._get_runner(SCENE, SCENE)
                fwd_ms = device_ms(lambda: run(b1, b2), 3)
                shard_bytes = b1[0].numel() * b1[0].element_size()
                same = np.array_equal(got, want)
                print(f"sharded {mode} over {n} shards of one card "
                      f"({pred.serving_mode()}, bucket {pred.bucket}): "
                      f"== single-device mask: {same} "
                      f"({int((got != want).sum())} pixels differ); a "
                      f"shard's band {shard_bytes} B of the scene's "
                      f"{scene_bytes} B a date (1/{scene_bytes // shard_bytes}"
                      f"; on one card the shards share its memory, peak "
                      f"allocated {peak / 2**20:.0f} MiB); predict "
                      f"{wall * 1e3:.1f} ms = {mpx / wall:.2f} Mpx/s, "
                      f"runner on placed bands {fwd_ms:.1f} ms = "
                      f"{mpx / fwd_ms * 1e3:.2f} Mpx/s; kernels launched "
                      f"{launches} (single device {want_launches})",
                      flush=True)
                if not same or launches != want_launches:
                    fail(f"sharded {mode} over {n} shards differs from the "
                         "single-device run")
                if shard_bytes * n != scene_bytes:
                    fail("a shard's band is not 1/n of the scene")
                for k, v in launches.items():
                    k = "conv3x3_s8" if k == "conv3x3_s8_q" else k
                    total[k] = total.get(k, 0) + v
                del b1, b2, pred, run
            del one
    return total


AOT_PACK = 4   # the packed artifact: packs of 4 FLEET_SIDE^2 pairs


def serve_counters():
    """The launch counters of the serving kernels (rows 1-3, 5b, 5c)."""
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv, fuse_s8, fused
    return (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
            fused.fused_mul_relu, conv_s8.conv3x3_s8_q, conv_s8.conv3x3_s8,
            fuse_s8.siamese_fuse_s8)


def counted(fn):
    """(fn(), its kernel launches), the counts zeroed just before."""
    counters = serve_counters()
    zero_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(counters)


def bundle_serve_phase(root: str, d1, d2, grid_mask) -> tuple:
    """The main path's weights (seed 0) in a checkpoint, exported as bf16
    and int8 serving bundles (``tools.export.export_bundle``; int8
    calibrated on the card on its synthetic batches): the 2048^2 pair
    served from the bf16 bundle bit-equal to the checkpoint path and to
    the main serve's mask, and from the int8 bundle (its scales seeding
    the forward, nothing calibrating) bit-equal to the checkpoint path at
    the same scales, with equal launches.  Returns (checkpoint dir,
    {quant: bundle path}, {quant: in-process mask}, launches)."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.tools.export import export_bundle, load_bundle
    from fabric_tpu_torch.train.state import create_state

    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    run = os.path.join(root, "run")
    # build_model draws the seed-0 weights ScenePredictor(checkpoint=None)
    # serves
    ckpt.save(create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                            train=True)), run, epoch=0)
    bundles, masks, total = {}, {}, {}
    for quant in ("none", "int8"):
        bundles[quant] = os.path.join(root, f"bundle_{quant}.npz")
        t0 = time.perf_counter()
        export_bundle(cfg, run, bundles[quant], quant=quant)
        print(f"bundle {quant}: exported in {time.perf_counter() - t0:.2f} s"
              f" ({os.path.getsize(bundles[quant]) / 2**20:.1f} MiB)",
              flush=True)
    _, scales, _ = load_bundle(bundles["int8"])
    for quant in ("none", "int8"):
        from_ckpt = ScenePredictor(cfg, checkpoint=run, bucket=512,
                                   device="cuda", quant=quant)
        if quant == "int8":
            from_ckpt._use_scales(scales)
        served = ScenePredictor(cfg, bundle=bundles[quant], bucket=512,
                                device="cuda")
        for pred in (from_ckpt, served):
            pred.predict(d1, d2)  # the first call builds the runner
        want, want_n = counted(lambda: from_ckpt.predict(d1, d2))
        got, got_n = counted(lambda: served.predict(d1, d2))
        same = np.array_equal(got, want)
        print(f"bundle {quant} serve of the {SCENE}^2 pair: == checkpoint "
              f"path: {same} ({int((got != want).sum())} pixels differ); "
              f"quant {served.quant}, scales the bundle's: "
              f"{served._scales == (scales if quant == 'int8' else None)}; "
              f"launches {got_n} (checkpoint path {want_n})", flush=True)
        if not same or got_n != want_n or served.quant != quant:
            fail(f"the {quant} bundle does not serve as the checkpoint")
        if quant == "none" and not np.array_equal(got, grid_mask):
            fail("the bf16 bundle's mask is not the main serve's")
        if quant == "int8" and served._scales != scales:
            fail("the int8 bundle's scales did not seed its forward")
        masks[quant] = want
        for k, v in got_n.items():
            total[k] = total.get(k, 0) + v
    return run, bundles, masks, total


_COLD_START = r"""
import json, sys, time
import numpy as np
import torch
from fabric_tpu_torch import Config
from fabric_tpu_torch.infer.service import ScenePredictor
root, how = sys.argv[1], sys.argv[2]
d1, d2 = np.load(f"{root}/d1.npy"), np.load(f"{root}/d2.npy")
kw = {"checkpoint": {"checkpoint": f"{root}/run"},
      "bundle": {"bundle": f"{root}/bundle_none.npz"},
      "bundle+aot_dir": {"bundle": f"{root}/bundle_none.npz",
                         "aot_dir": f"{root}/aot_grid_bf16"}}[how]
cfg = Config(patch_size=%(patch)d, eval_batch_size=%(batch)d,
             dtype="bfloat16", model_base=%(base)d)
t0 = time.perf_counter()
pred = ScenePredictor(cfg, bucket=512, device="cuda", **kw)
t1 = time.perf_counter()
mask = pred.predict(d1, d2)
t2 = time.perf_counter()
np.save(f"{root}/cold_mask.npy", mask)
reload_s = None
if pred.aot_dir:  # the artifact's load again, its imports made
    from fabric_tpu_torch.infer import aot
    t3 = time.perf_counter()
    aot.load_aot(pred.aot_dir, *pred._bucket_dims(*d1.shape[:2]),
                 device="cuda")
    reload_s = time.perf_counter() - t3
print(json.dumps({"how": how, "init_s": t1 - t0, "first_predict_s": t2 - t1,
                  "reload_s": reload_s,
                  "aot": sorted(map(list, pred._aot_keys))}))
"""


def cold_starts(root: str, d1, d2, want) -> dict:
    """ScenePredictor(...) plus the first predict of the 2048^2 pair, each
    in a fresh process: from the checkpoint, from the bf16 bundle, from
    the bundle and the grid artifact; every mask the main serve's."""
    np.save(os.path.join(root, "d1.npy"), d1)
    np.save(os.path.join(root, "d2.npy"), d2)
    code = _COLD_START % {"patch": PATCH, "batch": BATCH, "base": BASE}
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    out = {}
    for how in ("checkpoint", "bundle", "bundle+aot_dir"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, root, how],
                              capture_output=True, text=True, env=env,
                              timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode:
            fail(f"cold start from {how} failed:\n{proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        mask = np.load(os.path.join(root, "cold_mask.npy"))
        same = np.array_equal(mask, want)
        out[how] = rec["init_s"] + rec["first_predict_s"]
        print(f"cold start from {how}: ScenePredictor {rec['init_s']:.2f} s"
              f" + first predict {rec['first_predict_s']:.2f} s = "
              f"{out[how]:.2f} s (the process {wall:.1f} s); runners from "
              f"the artifact {rec['aot']}"
              + (f" (its load again in the same process "
                 f"{rec['reload_s']:.2f} s)" if rec["reload_s"] else "")
              + f"; mask == main serve's: {same}", flush=True)
        if not same or (how == "bundle+aot_dir") != bool(rec["aot"]):
            fail(f"cold start from {how} served another mask or runner")
    return out


def aot_serve_phase(root: str, d1, d2, bundles: dict, masks: dict) -> dict:
    """Scene runners exported with ``torch.export`` from the bundles'
    predictors and served from ``aot_dir`` on the card: grid bf16, grid
    int8 and fullconv (band 512) at the 2048^2 pair, and 4 packed 512^2
    pairs; for each the export seconds, the ``.pt2`` MiB and the
    ``torch.export.load`` seconds, masks bit-equal to in-process, the
    kernel launches of a scene equal to in-process (counted at run time),
    every record's ``aot`` true, and the loaded runner's device time
    beside the in-process runner's.  Then a grid artifact for the card
    exported by a CPU predictor, moved to the card when it loads; the
    custom ops' host cost a call against the direct launch; one
    ``cli.infer --bundle --aot_dir`` run; and the cold starts.  Returns
    the artifact runs' launches."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer import aot
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.track import Tracker

    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    rng = np.random.RandomState(SEED + 12)
    fleet = [tuple(rng.randn(FLEET_SIDE, FLEET_SIDE, 13).astype(np.float32)
                   for _ in range(2)) for _ in range(AOT_PACK)]
    specs = (("grid_bf16", dict(bundle=bundles["none"]), 0),
             ("grid_int8", dict(bundle=bundles["int8"]), 0),
             ("fullconv_bf16", dict(bundle=bundles["none"],
                                    fullconv_band_rows=FC_BAND), 0),
             (f"pack{AOT_PACK}_bf16", dict(bundle=bundles["none"]),
              AOT_PACK))
    tracker = Tracker(os.path.join(root, "logs"), run_name="aot")
    total: dict = {}
    for name, kw, pack in specs:
        pred = ScenePredictor(cfg, bucket=512, device="cuda", **kw)
        d = os.path.join(root, f"aot_{name}")
        side = FLEET_SIDE if pack else SCENE
        t0 = time.perf_counter()
        meta = aot.export_aot(pred, d, [(side, side)],
                              packs=(pack,) if pack else ())
        export_s = time.perf_counter() - t0
        bh, bw = pred._bucket_dims(side, side)
        fname = aot._runner_name(bh, bw, pack)
        mib = os.path.getsize(os.path.join(d, fname)) / 2**20
        t0 = time.perf_counter()
        aot.load_aot(d, bh, bw, pack, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        served = ScenePredictor(cfg, bucket=512, device="cuda", aot_dir=d,
                                tracker=tracker, **kw)
        if pack:
            def serve(p):
                return p.predict_many(fleet, pack=pack)
            key = (bh, bw, pack, "packed")
            a1, a2 = (torch.stack([torch.from_numpy(pred._pad(f[i], bh, bw))
                                   for f in fleet]).cuda() for i in (0, 1))

            def runner(p):
                return p._get_packed_runner(bh, bw, pack)
        else:
            def serve(p):
                return p.predict(d1, d2)
            key = (bh, bw)
            a1, a2 = (torch.from_numpy(p._pad(x, bh, bw)).cuda()
                      for p, x in ((pred, d1), (pred, d2)))

            def runner(p):
                return p._get_runner(bh, bw)
        for p in (pred, served):
            serve(p)  # the first call builds or loads the runner
        want, want_n = counted(lambda: serve(pred))
        got, got_n = counted(lambda: serve(served))
        same = all(np.array_equal(g, w) for g, w in
                   zip(got if pack else [got], want if pack else [want]))
        if name == "grid_bf16" or name == "grid_int8":
            same = same and np.array_equal(
                got, masks["none" if name == "grid_bf16" else "int8"])
        in_ms = device_ms(lambda: runner(pred)(a1, a2), 3)
        aot_ms = device_ms(lambda: runner(served)(a1, a2), 3)
        print(f"aot {name}: exported in {export_s:.2f} s, {fname} "
              f"{mib:.1f} MiB, torch.export.load + to card {load_s:.2f} s; "
              f"ops {meta['ops'][fname]}; masks == in-process: {same}; "
              f"launches a {'pack' if pack else 'scene'} {got_n} "
              f"(in-process {want_n}); runner {aot_ms:.2f} ms (in-process "
              f"{in_ms:.2f} ms); from the artifact: "
              f"{key in served._aot_keys}", flush=True)
        if not same or got_n != want_n or key not in served._aot_keys:
            fail(f"the {name} artifact does not serve as in-process")
        for k, v in got_n.items():
            total[k] = total.get(k, 0) + v
        del pred, served, a1, a2
    tracker.close()
    with open(os.path.join(tracker.dir, "metrics.jsonl")) as fin:
        recs = [json.loads(line) for line in fin]
    print(f"aot serve records: {len(recs)}, aot true in "
          f"{sum(r['serve_aot'] is True for r in recs)}", flush=True)
    if not recs or not all(r["serve_aot"] is True for r in recs):
        fail("an artifact scene's record does not say aot")

    # an artifact for the card exported on the CPU: tensors moved at load
    pred = ScenePredictor(cfg, bundle=bundles["none"], bucket=512,
                          device="cuda")
    cpu = ScenePredictor(cfg, bundle=bundles["none"], bucket=512,
                         device="cpu")
    d = os.path.join(root, "aot_from_cpu")
    t0 = time.perf_counter()
    aot.export_aot(cpu, d, [(FLEET_SIDE, FLEET_SIDE)], platforms=("cuda",))
    export_s = time.perf_counter() - t0
    served = ScenePredictor(cfg, bundle=bundles["none"], bucket=512,
                            device="cuda", aot_dir=d)
    pair = fleet[0]
    want, want_n = counted(lambda: pred.predict(*pair))
    got, got_n = counted(lambda: served.predict(*pair))
    same = np.array_equal(got, want)
    print(f"aot for the card exported on the CPU ({FLEET_SIDE}^2 grid, "
          f"{export_s:.2f} s): masks == in-process on the card: {same}; "
          f"launches {got_n} (in-process {want_n})", flush=True)
    if not same or got_n != want_n or not served._aot_keys:
        fail("the CPU-exported artifact does not serve on the card")
    del cpu, served

    # what the custom-op dispatch costs the host a call
    from fabric_tpu_torch.ops import bn_relu, conv
    x = torch.randn(2 * BATCH, 4, 4, 8 * BASE, device="cuda").bfloat16()
    k = torch.randn(3, 3, 8 * BASE, 8 * BASE, device="cuda") * 0.02
    b = torch.zeros(8 * BASE, device="cuda")
    pk = conv.pack_weight(k)
    v = [torch.ones(8 * BASE, device="cuda") for _ in range(4)]
    ops = torch.ops.fabric_tpu_torch
    with torch.inference_mode():
        rows = {
            "conv3x3_bias_relu": (
                lambda: conv.conv3x3_bias_relu(x, k, b, pk),
                lambda: ops.conv3x3_bias_relu(x, k, b, pk)),
            "bn_relu_inference": (
                lambda: bn_relu.bn_relu_inference(x, *v),
                lambda: ops.bn_relu_inference(x, *v, 1e-5, None))}
        for op, (direct, via_op) in rows.items():
            # alternated, the least of 5 each: the host clock spreads
            direct_us = [host_us(direct, 200) for _ in range(5)]
            op_us = [host_us(via_op, 200) for _ in range(5)]
            print(f"host cost a call of {op} at {tuple(x.shape)}, least of "
                  f"5 x 200 calls: direct {min(direct_us):.1f} us (median "
                  f"{statistics.median(direct_us):.1f}), custom op "
                  f"{min(op_us):.1f} us (median "
                  f"{statistics.median(op_us):.1f})", flush=True)

    # cli.infer --bundle --aot_dir on a 512^2 city, from the packed
    # artifact's single-scene runner
    from fabric_tpu_torch.data.image import read_png_gray
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.infer.runner import load_scene
    data = os.path.join(root, "aot_data")
    cfg_c = Config(patch_size=PATCH, eval_batch_size=BATCH,
                   dtype="bfloat16", model_base=BASE, dataset_dir=data,
                   validation_cities=["alpha"])
    generate_synthetic_dataset(data, cfg_c, cities=["alpha"],
                               sizes=[(FLEET_SIDE, FLEET_SIDE)])
    art = os.path.join(root, f"aot_pack{AOT_PACK}_bf16")
    logs = os.path.join(root, "cli_logs")
    cmd = [sys.executable, "-m", "fabric_tpu_torch.cli.infer", "--bundle",
           bundles["none"], "--aot_dir", art, "--dataset_dir", data,
           "--validation_cities", '["alpha"]', "--patch_size", str(PATCH),
           "--eval_batch_size", str(BATCH), "--model_base", str(BASE),
           "--dtype", "bfloat16", "--output_dir", os.path.join(root, "cli"),
           "--log_dir", logs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(
                              os.path.abspath(__file__))))
    if proc.returncode:
        fail(f"cli.infer --bundle --aot_dir failed:\n{proc.stderr[-3000:]}")
    scene = load_scene(cfg_c, "alpha")
    want = pred.predict(scene[0], scene[1])
    got = read_png_gray(os.path.join(root, "cli", "alpha_mask.png")) // 255
    (run_dir,) = os.listdir(logs)
    with open(os.path.join(logs, run_dir, "metrics.jsonl")) as fin:
        (rec,) = [json.loads(line) for line in fin]
    print(f"cli.infer --bundle --aot_dir: {time.perf_counter() - t0:.1f} s;"
          f" mask == in-process: {np.array_equal(got, want)}; record aot "
          f"{rec['serve_aot']}, mode {rec['serve_mode']}", flush=True)
    if not np.array_equal(got, want) or rec["serve_aot"] is not True:
        fail("cli.infer --bundle --aot_dir did not serve the artifact")
    del pred
    cold_starts(root, d1, d2, masks["none"])
    return total


TOOL_ITERS = 5  # timed calls of each tool phase's measurement


def tool_counters():
    """The serving kernels' launch counters and the eval-BatchNorm and
    int8 GEMM kernels'."""
    from fabric_tpu_torch.ops import bn_relu, int8_matmul
    return serve_counters() + (bn_relu.bn_relu_inference,
                               int8_matmul.int8_matmul)


def counted_tools(fn):
    """(fn(), every kernel's launches in it), the counts zeroed just
    before."""
    counters = tool_counters()
    zero_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in read_counts(counters).items() if v}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def seeded_variables():
    """The main path's seed-0 weights, with each BatchNorm's scale, bias
    and running statistics drawn from RandomState(SEED) near their
    defaults, so that every tensor a conversion maps differs from its
    default while the mask stays two-class."""
    from fabric_tpu_torch import weights

    params, stats = weights.init_variables(
        13, 2, BASE, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    for level in weights.LEVELS:
        p, s = params[level], stats[level]
        if "conv1" not in p:
            p, s = p["conv"], s["conv"]
        for bn in ("bn1", "bn2"):
            c = p[bn]["scale"].shape[0]
            p[bn]["scale"] = rng.uniform(0.9, 1.1, c).astype(np.float32)
            p[bn]["bias"] = (rng.randn(c) * 0.01).astype(np.float32)
            s[bn]["mean"] = (rng.randn(c) * 0.01).astype(np.float32)
            s[bn]["var"] = rng.uniform(0.9, 1.1, c).astype(np.float32)
    return params, stats


def reference_state_dict(params, stats) -> dict:
    """The reference PyTorch BiDateNet's state_dict of a variable tree:
    OIHW convs under ``inc.conv.conv.N``, ``downK.mpconv.1.conv.N``,
    ``upK.conv.conv.N`` (N = 0, 3 the convs, 1, 4 their BatchNorms) and
    ``outc.conv``."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(p["kernel"].transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(p["bias"].copy())

    def double(name, p, s):
        for i, (c, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
            conv(f"{name}.{3 * i}", p[c])
            b = f"{name}.{3 * i + 1}"
            sd[f"{b}.weight"] = torch.from_numpy(p[bn]["scale"].copy())
            sd[f"{b}.bias"] = torch.from_numpy(p[bn]["bias"].copy())
            sd[f"{b}.running_mean"] = torch.from_numpy(s[bn]["mean"].copy())
            sd[f"{b}.running_var"] = torch.from_numpy(s[bn]["var"].copy())
            sd[f"{b}.num_batches_tracked"] = torch.tensor(1)

    double("inc.conv.conv", params["inc"], stats["inc"])
    for level in ("down1", "down2", "down3", "down4"):
        double(f"{level}.mpconv.1.conv", params[level]["conv"],
               stats[level]["conv"])
    for level in ("up1", "up2", "up3", "up4"):
        double(f"{level}.conv.conv", params[level]["conv"],
               stats[level]["conv"])
    conv("outc.conv", params["outc"]["conv"])
    return sd


def import_torch_phase(root: str, d1, d2) -> dict:
    """A reference-layout torch checkpoint of seeded full-width weights,
    saved bare and with DataParallel's ``module.`` prefix, imported on the
    card (``tools.import_torch``) and served: the 2048^2 pair's masks
    bit-equal to the same weights written through the weight bridge
    (``weights.py``), with equal launches.  Returns the counted serves'
    launches."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.tools.import_torch import import_checkpoint
    from fabric_tpu_torch.train.state import create_state

    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    params, stats = seeded_variables()
    sd = reference_state_dict(params, stats)
    dirs = {"weights.py": os.path.join(root, "bridge")}
    ckpt.save(create_state(cfg, build_model(
        cfg, "cuda", fold_bn=False, variables=(params, stats), train=True)),
        dirs["weights.py"], epoch=0)
    for prefix in ("", "module."):
        pt = os.path.join(root, f"reference_{prefix or 'bare.'}pt")
        torch.save({prefix + k: v for k, v in sd.items()}, pt)
        name = f"import {prefix or 'bare'}"
        dirs[name] = os.path.join(root, name.replace(" ", "_"))
        t0 = time.perf_counter()
        import_checkpoint(pt, dirs[name], device="cuda")
        print(f"import_torch {name} ({len(sd)} tensors, "
              f"{os.path.getsize(pt) / 2**20:.1f} MiB): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    masks, launches, total = {}, {}, {}
    for name, d in dirs.items():
        pred = ScenePredictor(cfg, checkpoint=d, bucket=512, device="cuda")
        pred.predict(d1, d2)  # the first call builds the runner
        masks[name], launches[name] = counted_tools(
            lambda: pred.predict(d1, d2))
        add_counts(total, launches[name])
        del pred
    want = masks["weights.py"]
    for name in dirs:
        same = np.array_equal(masks[name], want)
        print(f"import_torch serve of the {SCENE}^2 pair from {name}: == "
              f"weight bridge: {same}; launches {launches[name]}; change "
              f"share {masks[name].mean():.4f}", flush=True)
        if not same or launches[name] != launches["weights.py"]:
            fail(f"the checkpoint from {name} does not serve as the weight "
                 "bridge's")
    if want.shape != (SCENE, SCENE) or set(np.unique(want)) != {0, 1}:
        fail(f"the import_torch mask is not a two-class {SCENE}^2 mask")
    return total


def grid_tiles(d, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of PATCH^2 grid tiles of an (H, W, C)
    scene, row-major, as the grid runner cuts them, on the card."""
    t = torch.from_numpy(d[:rows * PATCH]).cuda()
    cols = d.shape[1] // PATCH
    return t.reshape(rows, PATCH, cols, PATCH, -1).permute(
        0, 2, 1, 3, 4).reshape(rows * cols, PATCH, PATCH, -1)


def ablate_phase(model, d1, d2, mask, forward_ms: float,
                 kernels_ms: float, per_forward: dict) -> dict:
    """``tools.ablate``'s stages 0-11 of the main path's folded model on
    its first BATCH tiles of the 2048^2 pair: stage 11's mask bit-equal to
    the model's forward and to the served mask on those tiles, its
    launches one forward's; each stage's ms (TOOL_ITERS calls) and its
    delta.  Returns the phase's launches."""
    from fabric_tpu_torch.tools.ablate import build_functional, time_stage

    names = ("input", "+inc", "+down1", "+down2", "+down3", "+down4",
             "+fusion", "+up1", "+up2", "+up3", "+up4", "+head/argmax")
    rows = BATCH * PATCH // SCENE
    t1, t2 = grid_tiles(d1, rows), grid_tiles(d2, rows)
    served = torch.from_numpy(np.ascontiguousarray(mask[:rows * PATCH])) \
        .reshape(rows, PATCH, SCENE // PATCH, PATCH).permute(0, 2, 1, 3) \
        .reshape(BATCH, PATCH, PATCH).cuda()
    stages = build_functional(model)
    total = {}
    with torch.inference_mode():
        got, n = counted_tools(lambda: stages(t1, t2, 11, return_last=True))
        forward = model(t1, t2).argmax(-1).to(torch.uint8)
        add_counts(total, n)
        print(f"ablate stage 11 on the first {BATCH} tiles: == the folded "
              f"forward: {torch.equal(got, forward)}; == the served mask "
              f"on those tiles: {torch.equal(got, served)}; launches {n} "
              f"(one serving forward: {per_forward})", flush=True)
        if not torch.equal(got, forward) or not torch.equal(got, served):
            fail("ablate's stage 11 is not the serving forward")
        if n != per_forward:
            fail("ablate's stage 11 did not launch one forward's kernels")
        ms = []
        (_, n) = counted_tools(lambda: [ms.append(time_stage(
            stages, t1, t2, s, TOOL_ITERS, torch.device("cuda"))[0])
            for s in range(12)])
        add_counts(total, n)
    for s, name in enumerate(names):
        delta = ms[s] - (ms[s - 1] if s else 0.0)
        print(f"ablate stage {s:2d} {name:13s} {ms[s]:7.3f} ms  delta "
              f"{delta:+7.3f} ms", flush=True)
    print(f"ablate stage 11 (a {BATCH}-tile forward, batch {BATCH}, patch "
          f"{PATCH}): {ms[11]:.3f} ms; the runner's forward "
          f"{forward_ms:.3f} ms; kernels per forward {kernels_ms:.3f} ms",
          flush=True)
    print("ablate_stages " + json.dumps({
        "batch": BATCH, "patch": PATCH, "iters": TOOL_ITERS,
        "ms": [round(m, 4) for m in ms],
        "delta_ms": [round(m - (ms[i - 1] if i else 0.0), 4)
                     for i, m in enumerate(ms)]}), flush=True)
    return total


def ablate_train_phase() -> dict:
    """``tools.ablate_train`` at patch T_PATCH, batch T_BATCH, bf16, full
    width: the variants full, grad, fwd and eval_fwd (each launch count
    checked: the fusion kernel in every forward, the eval-BatchNorm kernel
    in eval_fwd's alone) and the step's split; the space_to_depth and
    group_conv microbenches.  Returns the phase's launches."""
    from fabric_tpu_torch.tools.ablate_train import (
        microbench_group_conv, microbench_space_to_depth, time_variant)

    total, recs = {}, {}
    calls = TOOL_ITERS + 1
    for variant in ("full", "grad", "fwd", "eval_fwd"):
        recs[variant], n = counted_tools(lambda: time_variant(
            variant, T_BATCH, T_PATCH, TOOL_ITERS, "bfloat16",
            device="cuda"))
        add_counts(total, n)
        want = {"fused_mul_relu": 5 * calls}
        if variant == "eval_fwd":
            want["bn_relu_inference"] = 18 * calls
        print(f"ablate_train {json.dumps(recs[variant])}; launches {n}",
              flush=True)
        if n != want:
            fail(f"the {variant} variant launched {n}, expected {want}")
    ms = {v: r["step_ms"] for v, r in recs.items()}
    print(f"ablate_train split of the bf16 step (batch {T_BATCH}, patch "
          f"{T_PATCH}): full {ms['full']:.2f} ms = optimizer + metrics "
          f"(full - grad) {ms['full'] - ms['grad']:.2f} + backward (grad - "
          f"fwd) {ms['grad'] - ms['fwd']:.2f} + train-mode BatchNorm "
          f"(fwd - eval_fwd) {ms['fwd'] - ms['eval_fwd']:.2f} + the eval "
          f"forward and loss {ms['eval_fwd']:.2f}", flush=True)
    s2d = microbench_space_to_depth(T_BATCH, T_PATCH, TOOL_ITERS,
                                    "bfloat16", 64, 64, "cuda")
    group = microbench_group_conv(T_BATCH, T_PATCH, TOOL_ITERS, "bfloat16",
                                  "cuda")
    print(f"ablate_train {json.dumps(s2d)}", flush=True)
    print(f"ablate_train {json.dumps(group)}", flush=True)
    # bf16 outputs of ~0.5 at most: 4 ulps of 2^-8
    if not s2d["max_abs_err"] <= 2.0 ** -6:
        fail("the space-to-depth conv disagrees with the direct conv")
    return total


LANE_PACK_LOSS_RTOL = 1e-3   # bf16 loss, lane_pack against direct
LANE_PACK_NOISE = 1.25       # bf16 gradients: at most this many times as
                             # far from the fp32 step as direct bf16's
LANE_PACK_FP32 = 0.02        # fp32 gradients: relative L2 to direct


def lane_pack_phase() -> dict:
    """One BiDateNet train step (tversky, full width, patch T_PATCH, batch
    T_BATCH, seed-0 weights and batch) with ``lane_pack`` and with
    ``lane_pack_bwd`` against the direct step: in fp32 the gradients
    within LANE_PACK_FP32 relative L2 and the loss within 1e-5; in bf16 the
    loss within LANE_PACK_LOSS_RTOL and the gradients no farther from the
    fp32 direct step than LANE_PACK_NOISE times the bf16 direct step's
    distance (bf16 gradients at initialisation sit far from fp32's either
    way: the bound is relative to that floor).  The packed convs counted
    (4 a forward: inc's and up4's; with lane_pack_bwd the dgrads the gate
    admits too, 2 at base 64).  Then ``time_variant`` of full, full_lane_pack,
    full_lane_pack_bwd and full again.  Returns the phase's launches."""
    from fabric_tpu_torch import Config, weights
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.ops import s2d_conv
    from fabric_tpu_torch.tools.ablate_train import _data, time_variant

    variables = weights.init_variables(
        13, 2, BASE, torch.Generator().manual_seed(SEED))
    data = _data(T_BATCH, T_PATCH, "cuda")
    packed_calls = [0]
    direct_s2d = s2d_conv.s2d_conv3x3

    def counting_s2d(*a, **k):
        packed_calls[0] += 1
        return direct_s2d(*a, **k)

    def step(dtype, mode):
        cfg = Config(model_base=BASE, patch_size=T_PATCH,
                     batch_size=T_BATCH, dtype=dtype,
                     lane_pack=mode != "direct",
                     lane_pack_bwd=mode == "lane_pack_bwd")
        model = build_model(cfg, "cuda", fold_bn=False, variables=variables,
                            train=True)
        packed_calls[0] = 0
        s2d_conv.s2d_conv3x3 = counting_s2d
        try:
            loss = get_loss_fn(cfg)(model(data["img1"], data["img2"],
                                          train=True), data["label"],
                                    weights=data["weight"])
            loss.backward()
        finally:
            s2d_conv.s2d_conv3x3 = direct_s2d
        # the 4 forwards, and with lane_pack_bwd the dgrads of inc.conv2,
        # up4.conv1 and up4.conv2 that the gate admits (at base 64 not
        # up4.conv1's: 128 output channels); inc.conv1's is not needed,
        # its input being the image
        bwd = sum(s2d_conv.supports(T_PATCH, T_PATCH, 0, c)
                  for c in (BASE, 2 * BASE, BASE))
        want = {"direct": 0, "lane_pack": 4, "lane_pack_bwd": 4 + bwd}[mode]
        if packed_calls[0] != want:
            fail(f"{mode} ran {packed_calls[0]} packed convs, expected "
                 f"{want}")
        return loss.item(), {n: p.grad.float() for n, p in
                             model.named_parameters()}

    def dist(a, b):
        num = sum(((a[k] - b[k]) ** 2).sum() for k in b)
        return (num / sum((b[k] ** 2).sum() for k in b)).sqrt().item()

    def run():
        ref = step("float32", "direct")
        bf = step("bfloat16", "direct")
        floor = dist(bf[1], ref[1])
        print(f"lane_pack: direct bf16 step against fp32: loss rel "
              f"{abs(bf[0] - ref[0]) / abs(ref[0]):.3g}, gradients rel L2 "
              f"{floor:.4f} (the bf16 floor)", flush=True)
        for mode in ("lane_pack", "lane_pack_bwd"):
            f32 = step("float32", mode)
            got = step("bfloat16", mode)
            loss32 = abs(f32[0] - ref[0]) / abs(ref[0])
            loss16 = abs(got[0] - bf[0]) / abs(bf[0])
            g32, g16 = dist(f32[1], ref[1]), dist(got[1], ref[1])
            print(f"lane_pack {mode}: fp32 loss rel {loss32:.3g}, "
                  f"gradients rel L2 {g32:.4g} (bound {LANE_PACK_FP32}); "
                  f"bf16 loss rel to direct bf16 {loss16:.3g} (bound "
                  f"{LANE_PACK_LOSS_RTOL}), gradients rel L2 to fp32 "
                  f"{g16:.4f} (bound {LANE_PACK_NOISE} x {floor:.4f})",
                  flush=True)
            if (loss32 > 1e-5 or g32 > LANE_PACK_FP32
                    or loss16 > LANE_PACK_LOSS_RTOL
                    or g16 > LANE_PACK_NOISE * floor):
                fail(f"the {mode} step disagrees with the direct step")
        return [time_variant(v, T_BATCH, T_PATCH, TOOL_ITERS, "bfloat16",
                             device="cuda")
                for v in ("full", "full_lane_pack", "full_lane_pack_bwd",
                          "full")]

    recs, n = counted_tools(run)
    for r in recs:
        print(f"lane_pack {json.dumps(r)}", flush=True)
    print(f"lane_pack step (bf16, batch {T_BATCH}, patch {T_PATCH}): direct "
          f"{recs[0]['step_ms']:.2f}, {recs[3]['step_ms']:.2f} ms; lane_pack "
          f"{recs[1]['step_ms']:.2f} ms; lane_pack_bwd "
          f"{recs[2]['step_ms']:.2f} ms; launches {n}", flush=True)
    return n


def int8_shift_conv_phase() -> dict:
    """``tools.ablate_train --microbench int8_shift_conv`` at batch
    T_BATCH, patch T_PATCH, 128 -> 128 channels: the raw ``conv3x3_s8``
    kernel against nine ``int8_matmul`` launches, exact, with both times
    and the launches checked.  Returns them."""
    from fabric_tpu_torch.tools.ablate_train import (
        microbench_int8_shift_conv)

    rec, n = counted_tools(lambda: microbench_int8_shift_conv(
        T_BATCH, T_PATCH, TOOL_ITERS, 128, 128, "cuda"))
    want = {"conv3x3_s8": TOOL_ITERS + 2, "int8_matmul": 9 * (TOOL_ITERS + 2)}
    print(f"ablate_train {json.dumps(rec)}; launches {n} (expected {want})",
          flush=True)
    if rec["exact"] is not True or n != want:
        fail("the int8 shift conv is not exact or did not run as planned")
    return n


_DP_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as tdist
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.ops import bn_relu, fused, s2d_conv
from fabric_tpu_torch.parallel import distributed
from fabric_tpu_torch.train.loop import train
from fabric_tpu_torch.weights import flatten_tree, variables_of

cfg = Config(**json.loads(os.environ["DP_CFG"]))
rank, world = int(os.environ["DP_RANK"]), int(os.environ["DP_WORLD"])
if world > 1:  # NCCL refuses two ranks on one card: gloo
    tdist.init_process_group("gloo", init_method=os.environ["DP_INIT"],
                             world_size=world, rank=rank)
counters = (fused.fused_mul_relu, bn_relu.bn_relu_inference)
for fn in counters:
    fn.launches = 0
for k in s2d_conv.packed_counts:
    s2d_conv.packed_counts[k] = 0
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
state, history = train(cfg, device="cuda:0", run_scene_inference=True)
wall = time.perf_counter() - t0
launches = {fn.__name__: fn.launches for fn in counters}
params, stats = variables_of(state.model)
np.savez(os.path.join(os.environ["DP_OUT"], f"vars_{rank}.npz"),
         **{"params/" + k: v for k, v in flatten_tree(params).items()},
         **{"stats/" + k: v for k, v in flatten_tree(stats).items()})
with open(os.path.join(os.environ["DP_OUT"], f"history_{rank}.json"),
          "w") as f:
    json.dump({"history": history, "launches": launches, "wall_s": wall,
               "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
               "packed": dict(s2d_conv.packed_counts)}, f)
distributed.shutdown()
"""

_NCCL_WORKER = r"""
import os
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import torch.distributed as tdist
from fabric_tpu_torch.config import Config
from fabric_tpu_torch.losses import get_loss_fn
from fabric_tpu_torch.models import build_model
from fabric_tpu_torch.parallel import distributed
from fabric_tpu_torch.train.state import create_state
from fabric_tpu_torch.train.steps import make_train_step
from fabric_tpu_torch.weights import init_variables, variables_of

cfg = Config(model_base=64, patch_size=96, batch_size=8, dtype="float32",
             loss_function="tversky", learning_rate=0.05)
variables = init_variables(13, 2, 64, torch.Generator().manual_seed(5))
rng = np.random.RandomState(5)
img1 = rng.randn(8, 96, 96, 13).astype(np.float32)
label = (rng.rand(8, 96, 96) < 0.3).astype(np.int32)
img2 = img1 + 0.3 * rng.randn(*img1.shape).astype(np.float32)
img2[label == 1] += 1.5
batch = {"img1": img1, "img2": img2, "label": label,
         "weight": np.ones(8, np.float32)}


def step():
    model = build_model(cfg, "cuda", fold_bn=False, variables=variables,
                        train=True)
    _, stats = make_train_step(model, get_loss_fn(cfg))(
        create_state(cfg, model),
        {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    return stats["loss"].item(), variables_of(model)


loss0, (p0, s0) = step()           # no process group
assert distributed.maybe_initialize()
assert tdist.get_backend() == "nccl" and distributed.world_size() == 1
loss1, (p1, s1) = step()           # the NCCL collectives, world size 1


def flat(t, pre=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from flat(v, pre + k + ".")
        else:
            yield pre + k, v


p0, p1, s0, s1 = (dict(flat(t)) for t in (p0, p1, s0, s1))
pv = dict(flat(variables[0]))
step_max = max(np.abs(p0[k] - pv[k]).max() for k in p0)
p_err = max(np.abs(p1[k] - p0[k]).max() for k in p0)
s_err = max((np.abs(s1[k] - s0[k]) / (np.abs(s0[k]) + 1e-3)).max()
            for k in s0)
l_err = abs(loss1 - loss0) / abs(loss0)
ok = l_err <= 1e-5 and p_err <= 1e-2 * step_max and s_err <= 1e-3
print(f"NCCL_STEP backend nccl, world 1: loss {loss1:.7f} vs {loss0:.7f} "
      f"without a group (rel {l_err:.3g}, bound 1e-5); params max diff "
      f"{p_err:.3g} (bound 1e-2 x largest update {step_max:.4g}); BN stats "
      f"rel diff {s_err:.3g} (bound 1e-3): {'ok' if ok else 'MISMATCH'}")
distributed.shutdown()
raise SystemExit(0 if ok else 1)
"""


def _run_workers(code: str, envs: list, timeout: int) -> list:
    """Run ``code`` in one process per env (from the checkout's root),
    each killed at ``timeout`` seconds; their outputs.  Fails on a
    non-zero exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=here,
        env={**os.environ, "PYTHONPATH": here, **e},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for e in envs]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0].decode())
            except subprocess.TimeoutExpired:
                outs.append("(timed out)")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, text in zip(procs, outs):
        if p.returncode != 0:
            print(text[-6000:], flush=True)
            fail(f"a worker exited with {p.returncode}")
    return outs


def _loop_run(root: str, tag: str, cfg: dict, world: int) -> tuple:
    """train.loop.train of ``cfg`` in ``world`` gloo ranks on the card
    (``_DP_WORKER``, one process without a group for a world of 1):
    (output dir, [(variables, record)] of each rank, the command's wall
    seconds)."""
    out = os.path.join(root, tag)
    os.makedirs(out)
    cfg = dict(cfg, weight_dir=os.path.join(out, "weights"),
               log_dir=os.path.join(out, "logs"))
    init = f"tcp://localhost:{_free_port()}"
    t0 = time.perf_counter()
    _run_workers(_DP_WORKER, [
        {"DP_CFG": json.dumps(cfg), "DP_RANK": str(r),
         "DP_WORLD": str(world), "DP_INIT": init, "DP_OUT": out}
        for r in range(world)], timeout=300)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"history_{r}.json")) as f:
            ranks.append((dict(np.load(os.path.join(out, f"vars_{r}.npz"))),
                          json.load(f)))
    return out, ranks, wall


def _held(single: tuple, ranks: list, init: dict) -> dict:
    """A mesh run's ranks against a 1-process run of the same global
    batches, by card_vs_cpu_step's bounds for the loss and the
    parameters: cuDNN picks its algorithms by shape and the ranks sum in
    another order, so the train loss (the mean of the steps') within 1e-5
    relative, every parameter within 1e-2 of the largest update of the
    steps; the BatchNorm running statistics within 1e-4 of each
    statistic's largest magnitude (a running mean near 0 after 3 steps
    differs by a few 1e-6, which an element-relative bound reads as
    1e-3).  ``init``: the weights train() drew from the seed."""
    v1, h1 = single[0], single[1]["history"]
    va, ha = ranks[0][0], ranks[0][1]["history"]
    params = [k for k in v1 if k.startswith("params/")]
    stats = [k for k in v1 if k.startswith("stats/")]
    step_max = max(np.abs(v1[k] - init[k[len("params/"):]]).max()
                   for k in params)
    p_err = max(np.abs(va[k] - v1[k]).max() for k in params)
    s_err = max(np.abs(va[k] - v1[k]).max() / np.abs(v1[k]).max()
                for k in stats)
    l1, l2 = (h["train"][0]["cd_losses"] for h in (h1, ha))
    l_err = abs(l2 - l1) / abs(l1)
    ranks_equal = all(np.array_equal(r[0][k], va[k]) for r in ranks[1:]
                      for k in va)
    return {"ok": (ranks_equal and l_err <= 1e-5
                   and p_err <= 1e-2 * step_max and s_err <= 1e-4),
            "l1": l1, "l2": l2, "l_err": l_err, "p_err": p_err,
            "s_err": s_err, "step_max": step_max,
            "ranks_equal": ranks_equal,
            "val": [h["val"][0]["cd_losses"] for h in (h1, ha)]}


def _rank0_alone(out: str, single_out: str, ranks: list) -> bool:
    """One tracker run, the 1-process run's checkpoints, and the scene
    inference of the validation city on rank 0 alone."""
    logs = os.listdir(os.path.join(out, "logs"))
    wrote = sorted(os.listdir(os.path.join(out, "weights")))
    return (len(logs) == 1
            and wrote == sorted(os.listdir(os.path.join(single_out,
                                                        "weights")))
            and "val_scene_f1" in ranks[0][1]["history"]["val"][0]
            and all("val_scene_f1" not in r[1]["history"]["val"][0]
                    for r in ranks[1:]))


def _examples_per_s(out: str) -> float:
    run_dir = os.path.join(out, "logs", os.listdir(
        os.path.join(out, "logs"))[0])
    return next(json.loads(x)["train_examples_per_sec"]
                for x in open(os.path.join(run_dir, "metrics.jsonl"))
                if "train_examples_per_sec" in x)


def dp_train_phase(root: str) -> dict:
    """Data-parallel training on the one card: train.loop.train in 2 ranks
    over gloo (NCCL refuses two ranks on one card), full-width BiDateNet,
    patch 96, global batch 128 (64 a rank), tversky + SGD, fp32, 3 steps,
    validation and the validation city's scene inference, against the
    same run in 1 process on the card on the same global batches: loss,
    parameters and running statistics within ``_held``'s bounds, the
    ranks equal; rank 0 alone wrote.  Then one step at world
    size 1 over NCCL through maybe_initialize against the same step
    without a group.  Returns the base config and the first 1-process
    run, which sp_train_phase reuses."""
    from fabric_tpu_torch.weights import flatten_tree, init_variables

    base = dict(dataset_dir=os.path.join(root, "data"), patch_size=T_PATCH,
                stride=32, batch_size=DP_BATCH, eval_batch_size=DP_BATCH,
                epochs=1, steps_per_epoch=DP_STEPS, learning_rate=0.05,
                loss_function="tversky", optimizer="sgd", dtype="float32",
                model_base=BASE, validation_cities=["val"], num_workers=2,
                seed=SEED + 7)
    runs = {tag: _loop_run(root, f"dp_{tag}", base, world)
            for tag, world in (("once", 1), ("ranks", DP_RANKS))}
    init = flatten_tree(init_variables(
        13, 2, BASE, torch.Generator().manual_seed(base["seed"]))[0])
    once = runs["once"][1][0]
    held = _held(once, runs["ranks"][1], init)
    only_rank0 = _rank0_alone(runs["ranks"][0], runs["once"][0],
                              runs["ranks"][1])
    print(f"dp_train: {DP_RANKS} ranks over gloo on one card vs 1 process, "
          f"BiDateNet base {BASE}, patch {T_PATCH}, global batch {DP_BATCH}"
          f", {DP_STEPS} steps fp32: train loss {held['l2']:.7f} vs "
          f"{held['l1']:.7f} (rel {held['l_err']:.3g}, bound 1e-5), val "
          f"loss {held['val'][1]:.7f} vs {held['val'][0]:.7f}; params max "
          f"diff {held['p_err']:.3g} (bound 1e-2 x largest update "
          f"{held['step_max']:.4g}); BN stats max diff {held['s_err']:.3g} "
          f"of the statistic's largest magnitude (bound 1e-4); ranks' "
          f"parameters and statistics equal: "
          f"{held['ranks_equal']}; rank 0 alone wrote (tracker run, "
          f"checkpoints, scene inference on rank 0 only): {only_rank0}; "
          f"{'ok' if held['ok'] and only_rank0 else 'MISMATCH'}",
          flush=True)
    rate = {tag: _examples_per_s(out) for tag, (out, _, _) in runs.items()}
    t_run = {tag: wall for tag, (_, _, wall) in runs.items()}
    print(f"dp_train: two ranks sharing one card: {rate['ranks']:.1f} "
          f"train examples/s of the global batch, 1 process "
          f"{rate['once']:.1f} (the {DP_STEPS}-step epoch, its first step "
          f"included; not a scaling figure); the whole 2-rank command "
          f"{t_run['ranks']:.1f} s, the 1-process one {t_run['once']:.1f} s",
          flush=True)
    if not (held["ok"] and only_rank0):
        fail("data-parallel training differs from the 1-process run")
    out = _run_workers(_NCCL_WORKER, [{
        "FABRIC_COORDINATOR": f"localhost:{_free_port()}",
        "FABRIC_NUM_PROCESSES": "1", "FABRIC_PROCESS_ID": "0"}],
        timeout=240)[0]
    print(next(x for x in out.splitlines() if x.startswith("NCCL_STEP")),
          flush=True)
    return {"base": base, "once": runs["once"], "init": init}


# sp_train: (run, model, mesh, options; a run with options has its own
# 1-process run); UNetLSTM's global batch and 5-date cities; the worlds
# (a mesh run's ranks, or 1 process) that share the card at a time
SP_RUNS = (("a", "bidate", (1, 2, 1), {}), ("b", "bidate", (2, 2, 1), {}),
           ("c", "unet_lstm", (1, 2, 2), {}),
           ("d", "bidate", (1, 2, 1), {"lane_pack": True,
                                       "lane_pack_bwd": True,
                                       "steps_per_epoch": 2}))
SP_MD_BATCH, SP_MD_STEPS = 32, 2
SP_WORLDS_AT_ONCE = 2
SP_MD_CITIES = {"alpha": (384, 384), "val": (288, 288)}


def sp_train_phase(root: str, dp: dict, smi: str) -> dict:
    """The spatial and model mesh axes on the one card: train.loop.train
    over gloo ranks (each holding its data slice's rows and its half of
    each patch's height, the halo exchanges summed over the spatial group)
    at full width, tversky + SGD, fp32, with validation and rank 0's scene
    inference: (a) BiDateNet at mesh (1, 2, 1) and (b) at (2, 2, 1), global
    batch 128, 3 steps, against dp_train's 1-process run of the same
    settings; (c) UNetLSTM base 64, T = 5, at (1, 2, 2), global batch 32,
    2 steps, on a small 5-date dataset, against its own 1-process run;
    (d) BiDateNet with lane_pack and lane_pack_bwd at (1, 2, 1), as (a),
    2 steps, against its own 1-process run with them: level 0 (inc, up4)
    splits into 48-row halves, whose packed convs read a halo of whole
    s2d blocks; every rank, and the 1 process, must have run packed
    forward convs, packed dgrads and packed eval convs (validation's;
    ``s2d_conv.packed_counts``), so that no direct path passes unseen.
    Each held to dp_train's bounds (``_held``), the ranks equal, rank 0
    alone writing.  The runs go SP_WORLDS_AT_ONCE at a time (their
    processes start, import and load data for most of a run's time).
    Prints each rank's launches of rows 3 and 4 (and in (d) its packed
    convs) and peak allocated memory against the 1-process run's, and
    each run's wall time beside another run's; returns the launches
    summed over every rank.  Ranks sharing one card give no scaling
    figure."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.weights import flatten_tree, init_variables

    md_data = os.path.join(root, "sp_md_data")
    generate_synthetic_dataset(md_data, Config(), cities=list(SP_MD_CITIES),
                               sizes=list(SP_MD_CITIES.values()),
                               seed=SEED + 9, num_dates=MD_T)
    md_cfg = dict(dp["base"], dataset_dir=md_data, model="unet_lstm",
                  num_dates=MD_T, batch_size=SP_MD_BATCH,
                  eval_batch_size=SP_MD_BATCH, steps_per_epoch=SP_MD_STEPS)
    md_init = flatten_tree(init_variables(
        13, 2, BASE, torch.Generator().manual_seed(md_cfg["seed"]),
        "unet_lstm")[0])
    jobs = {"md_once": ("sp_md_once", md_cfg, 1)}
    for run, name, (d, s, m), options in SP_RUNS:
        base = dict(dp["base"] if name == "bidate" else md_cfg, **options)
        if options:
            jobs[run + "_once"] = (f"sp_{run}_once", base, 1)
        jobs[run] = (f"sp_{run}", dict(base, mesh_data=d, mesh_spatial=s,
                                       mesh_model=m), d * s * m)
    with concurrent.futures.ThreadPoolExecutor(SP_WORLDS_AT_ONCE) as pool:
        done = dict(zip(jobs, pool.map(lambda job: _loop_run(root, *job),
                                       jobs.values())))
    total = {"fused_mul_relu": 0, "bn_relu_inference": 0}
    failed = []
    for run, name, (d, s, m), options in SP_RUNS:
        single, init = ((dp["once"], dp["init"]) if name == "bidate"
                        else (done["md_once"], md_init))
        if options:
            single = done[run + "_once"]
        cfg = jobs[run][1]
        out, ranks, wall = done[run]
        held = _held(single[1][0], ranks, init)
        only_rank0 = _rank0_alone(out, single[0], ranks)
        one = single[1][0][1]
        counts = [r[1]["launches"] for r in ranks]
        for c in counts:
            for k, v in c.items():
                total[k] += v
        # rows 3 (the Siamese fusion, bi-date only) and 4 (the eval
        # BatchNorm of validation and rank 0's scene inference) on every
        # rank; the ranks past 0 alike
        launched = all(c["bn_relu_inference"] > 0
                       and (name != "bidate" or c["fused_mul_relu"] > 0)
                       and c == counts[-1] for c in counts[1:]) \
            and counts[0]["bn_relu_inference"] > 0
        # with lane_pack, packed forward convs, dgrads and (validation's)
        # eval convs on every rank and in the 1 process
        packed = [r[1]["packed"] for r in ranks]
        packed_ok = not options or all(
            v > 0 for p in packed + [one["packed"]] for v in p.values())
        if options:
            print(f"sp_train ({run}): {options}: packed convs by rank "
                  f"{packed} (1 process: {one['packed']}): "
                  f"{'ok' if packed_ok else 'NONE PACKED'}", flush=True)
        good = held["ok"] and only_rank0 and launched and packed_ok
        print(f"sp_train ({run}): {name} base {BASE}, patch {T_PATCH}, "
              f"mesh {d}x{s}x{m} in {d * s * m} gloo ranks on one card, "
              f"global batch {cfg['batch_size']}, "
              f"{cfg['steps_per_epoch']} steps fp32: train loss "
              f"{held['l2']:.7f} vs {held['l1']:.7f} of 1 process (rel "
              f"{held['l_err']:.3g}, bound 1e-5); params max diff "
              f"{held['p_err']:.3g} (bound 1e-2 x largest update "
              f"{held['step_max']:.4g}); BN stats max diff "
              f"{held['s_err']:.3g} (bound 1e-4); ranks equal: "
              f"{held['ranks_equal']}; rank 0 alone wrote: {only_rank0}; "
              f"launches by rank {counts} (1 process: {one['launches']}); "
              f"peak allocated MiB by rank "
              f"{[round(r[1]['peak_mib']) for r in ranks]} against "
              f"{round(one['peak_mib'])} in 1 process; the command "
              f"{wall:.1f} s (1 process {single[2]:.1f} s; up to "
              f"{SP_WORLDS_AT_ONCE} runs at a time and their ranks sharing "
              f"one card: no scaling figure); {smi}; "
              f"{'ok' if good else 'MISMATCH'}", flush=True)
        if not good:
            failed.append(run)
    if failed:
        fail(f"sp_train runs {failed} differ from their 1-process runs, "
             f"missed a kernel or packed no conv")
    return total


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- float32 serving: the fp32 forms of rows 1, 2 and 5b ---
F32_T, F32_MD_SCENE = 3, 512   # the multi-date models' dates and side
F32_MD_BASE = {"unet_lstm": 64, "unet3d": 32}
F32_KERNELS = {  # name in the kernels line -> its launch counter
    "conv3x3_bias_relu_f32": "conv3x3_bias_relu_f32",
    "double_conv3x3_bias_relu_f32": "double_conv3x3_bias_relu_f32",
    "conv3x3_s8_f32": "conv3x3_s8_q_f32",
}


def f32_counters():
    """The wrappers of rows 1, 2 and 5b: each counts its bf16 form's
    launches on ``launches`` and its fp32 form's on ``launches_f32``."""
    from fabric_tpu_torch.ops import conv, conv_s8, double_conv

    return (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
            conv_s8.conv3x3_s8_q)


def f32_counted(fn):
    """(fn(), the fp32 forms' launches, the bf16 forms' launches), the
    counts zeroed just before."""
    fns = f32_counters()
    zero_counts(fns)
    for f in fns:
        f.launches_f32 = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, {f.__name__ + "_f32": f.launches_f32 for f in fns},
            read_counts(fns))


def f32_calls(n_channels: int):
    """The fp32 conv kernel calls of one forward of BATCH tiles, each
    DoubleConv block where the fp32 gate sends it; then (``gate``) the
    fused kernel at the levels where it fits and the gate does not send
    it, timed for the gate only."""
    from fabric_tpu_torch.ops.double_conv import fits, supports

    calls, gate = [], []
    for level, n, s, cin, cout in level_shapes(n_channels):
        if supports(s, s, cin, cout, cout, torch.float32):
            calls.append(("double_conv3x3_bias_relu_f32",
                          (n, s, s, cin, cout, cout), level))
            continue
        calls.append(("conv3x3_bias_relu_f32", (n, s, s, cin, cout),
                      level))
        calls.append(("conv3x3_bias_relu_f32", (n, s, s, cout, cout),
                      level))
        if fits(s, s, cin, cout, cout, torch.float32):
            gate.append(("double_conv3x3_bias_relu_f32",
                         (n, s, s, cin, cout, cout), level))
    return calls, gate


def f32_band_calls(h: int, w: int):
    """The fp32 conv kernel calls of one bi-date fullconv band forward of
    one h x w context window: each DoubleConv block as two row-1 launches
    (the fused kernel's images are at most 128 pixels)."""
    from fabric_tpu_torch.weights import block_channels

    calls = []
    for level, (cin, cout) in block_channels(13, BASE).items():
        f = LEVEL_SIDE[level]
        m = 1 if level.startswith("up") else 2
        for ci in (cin, cout):
            calls.append(("conv3x3_bias_relu_f32",
                          (m, h // f, w // f, ci, cout), level))
    return calls


def f32_close(got, ref) -> tuple[float, float, bool]:
    """(relative L2, max |diff| over the largest output, ok) of an fp32
    form against its plain version: fp32 sums in another order, TF32 off
    on both sides, so relative L2 <= 1e-5 and max |diff| <= 1e-4 of the
    largest output."""
    d = (got.double() - ref.double())
    rel = d.norm().item() / max(ref.double().norm().item(), 1e-30)
    mx = d.abs().max().item() / max(ref.abs().max().item(), 1e-30)
    return rel, mx, (rel <= 1e-5 and mx <= 1e-4
                     and bool(torch.isfinite(got).all()))


def check_f32_kernels(calls, reps: int = 3):
    """Each fp32 conv form against its plain version on the card at the
    fp32 path's shapes, timed beside the plain version, cuDNN's fp32
    F.conv2d + ReLU with TF32 off (twice for the double conv) and the
    bound of 3xTF32 (three TF32 products per float32 product at 495
    TFLOP/s, or the bytes at 3.35 TB/s); each double-conv level also as
    two fp32 conv launches (bit-equal: the fused kernel sums in the conv
    kernel's order).  Inputs drawn on the card."""
    from fabric_tpu_torch.ops import conv, double_conv, fp32_conv

    g = torch.Generator("cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def lib_conv(x, w, b):  # cuDNN, full fp32, on a channels-last view
        with fp32_conv.no_tf32():
            return torch.relu_(F.conv2d(x.permute(0, 3, 1, 2), w, b,
                                        padding=1))

    def lib_weight(k):
        return k.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    rows = []
    for name, shape, level in calls:
        two_ms, two_equal = None, None
        if name == "conv3x3_bias_relu_f32":
            n, h, w, cin, cout = shape
            x = randn(n, h, w, cin)
            k, b = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5), randn(
                cout, scale=0.1)
            pk = conv.pack_weight_f32(k)
            kern = lambda: conv.conv3x3_bias_relu(x, k, b, pk)  # noqa
            plain = lambda: conv.conv3x3_bias_relu_reference(x, k, b)  # noqa
            wl = lib_weight(k)
            lib = lambda: lib_conv(x, wl, b)  # noqa: E731
            macs = n * h * w * 9 * cin * cout
            nbytes = 4 * (n * h * w * (cin + cout) + 9 * cin * cout + cout)
        else:
            n, h, w, cin, cmid, cout = shape
            x = randn(n, h, w, cin)
            w1, b1 = randn(3, 3, cin, cmid, scale=(9 * cin) ** -.5), randn(
                cmid, scale=0.1)
            w2, b2 = randn(3, 3, cmid, cout, scale=(9 * cmid) ** -.5), \
                randn(cout, scale=0.1)
            p1, p2 = conv.pack_weight_f32(w1), conv.pack_weight_f32(w2)
            kern = lambda: double_conv.double_conv3x3_bias_relu(  # noqa
                x, w1, b1, w2, b2, (p1, p2))
            plain = lambda: double_conv.double_conv3x3_bias_relu_reference(  # noqa
                x, w1, b1, w2, b2)
            wl1, wl2 = lib_weight(w1), lib_weight(w2)
            lib = lambda: lib_conv(lib_conv(  # noqa: E731
                x, wl1, b1).permute(0, 2, 3, 1), wl2, b2)
            two = lambda: conv.conv3x3_bias_relu(  # noqa: E731
                conv.conv3x3_bias_relu(x, w1, b1, p1), w2, b2, p2)
            two_ms = device_ms(two, reps)
            two_equal = torch.equal(kern(), two())
            macs = n * h * w * 9 * (cin * cmid + cmid * cout)
            nbytes = 4 * (n * h * w * (cin + cout) + 9 * (
                cin * cmid + cmid * cout) + cmid + cout)
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        rel, mx, ok = f32_close(got, ref)
        ok = ok and two_equal is not False
        err = (got - ref).abs().max().item()
        kms = device_ms(kern, reps)
        pms = device_ms(plain, 1)
        lms = device_ms(lib, reps)
        t_ops, t_bytes = bound(3 * 2 * macs, nbytes, PEAK_TF32_TENSOR)
        two_txt = ("" if two_ms is None else
                   f", as two fp32 conv launches {two_ms:.3f} ms "
                   f"({'bit-equal' if two_equal else 'DIFFERENT'})")
        print(f"kernel {name} {level} {shape}: rel_l2 {rel:.3g} max_rel "
              f"{mx:.3g} (bounds 1e-5, 1e-4) {'ok' if ok else 'MISMATCH'} "
              f"| {kms:.3f} ms, {2 * macs / kms / 1e9:.1f} TFLOP/s, plain "
              f"{pms:.3f} ms, library {lms:.3f} ms (cuDNN fp32, TF32 off), "
              f"bound {max(t_ops, t_bytes):.3f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}){two_txt}",
              flush=True)
        if not ok:
            fail(f"{name} {shape} disagrees with its plain version")
        rows.append(dict(name=name, level=level, err=err, ms=kms,
                         plain_ms=pms, library_ms=lms, t_ops=t_ops,
                         t_bytes=t_bytes, two_conv_ms=two_ms))
        del x, got, ref
    return rows


def check_s8_f32_kernels(reps: int = 5):
    """The int8 conv's float32 epilogue modes at the 18 sites of one int8
    forward (the site's bf16 mode -> float32 out, int8 -> int8 from the
    fp32 h, split -> split from the fp32 h) against the plain version at
    float32: identical."""
    from fabric_tpu_torch.ops import conv_s8

    g = torch.Generator().manual_seed(SEED + 15)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).cuda()

    rows = []
    for site, (n, h, w, cin, cout), mode in int8_site_shapes():
        split = mode == "split"
        x, wq = s8(n, h, w, cin), s8(3, 3, cin, cout)
        packed = conv_s8.pack_weight(wq)

        def scale(f):
            return ((torch.rand(cout, generator=g) + 0.5) * f / (
                (9 * cin) ** 0.5 * 5400)).cuda()
        k, bias = scale(2.0), torch.randn(cout, generator=g).cuda()
        up = None
        if split:
            wq2 = s8(3, 3, cin, cout)
            up = (s8(n, h, w, cin), wq2, scale(0.7), conv_s8.pack_weight(wq2))
        s_out = None if mode == "bf16" else 3.0 / 127
        args = (x, wq, k, bias, s_out)
        got = conv_s8.conv3x3_s8_q(*args, packed, up, torch.float32)
        torch.cuda.synchronize()
        ref = conv_s8.conv3x3_s8_q_reference(*args, up, torch.float32)
        same = torch.equal(got, ref)
        n_diff = int((got != ref).sum())
        kms = device_ms(lambda: conv_s8.conv3x3_s8_q(
            *args, packed, up, torch.float32), reps)
        pms = device_ms(lambda: conv_s8.conv3x3_s8_q_reference(
            *args, up, torch.float32), 1)
        k_in = cin * (2 if split else 1)
        out_b = 1 if s_out is not None else 4
        ops = 2 * n * h * w * 9 * k_in * cout
        t_ops, t_bytes = bound(ops, n * h * w * (k_in + out_b * cout)
                               + 9 * k_in * cout
                               + 4 * cout * (3 if split else 2),
                               PEAK_INT8_TENSOR)
        form = {"bf16": "float32", "int8": "int8_f32",
                "split": "split_f32"}[mode]
        print(f"kernel conv3x3_s8 {form} {site} {(n, h, w, cin, cout)}: "
              f"{'identical' if same else 'DIFFERENT'} to its plain version "
              f"({n_diff} of {got.numel()} differ) | {kms:.4f} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}), plain "
              f"{pms:.3f} ms", flush=True)
        if not same:
            fail(f"conv3x3_s8 {form} {site} differs from its plain version")
        rows.append(dict(name="conv3x3_s8_f32", err=(
            got.float() - ref.float()).abs().max().item(), ms=kms,
            plain_ms=pms, library_ms=None, t_ops=t_ops, t_bytes=t_bytes))
        del x, wq, packed, got, ref, up, args
    return rows


def check_f32_fused(reps: int = 5) -> None:
    """Row 3 (``ops/fused.py``, Triton) takes float32 as it is: its
    launches at the 5 fusion levels of one fp32 forward against the plain
    version, exactly (one product and one max, one rounding)."""
    from fabric_tpu_torch.ops import fused

    g = torch.Generator("cuda").manual_seed(SEED + 3)
    for i, c in enumerate((BASE, 2 * BASE, 4 * BASE, 8 * BASE, 8 * BASE)):
        s = PATCH >> i
        a, b = (torch.randn(BATCH, s, s, c, generator=g, device="cuda")
                for _ in range(2))
        got = fused.fused_mul_relu(a, b)
        torch.cuda.synchronize()
        same = torch.equal(got, fused.fused_mul_relu_reference(a, b))
        kms = device_ms(lambda: fused.fused_mul_relu(a, b), reps)
        pms = device_ms(lambda: fused.fused_mul_relu_reference(a, b), reps)
        t_ops, t_bytes = bound(2 * a.numel(), 3 * 4 * a.numel(),
                               PEAK_ELEMENTWISE)
        print(f"kernel fused_mul_relu fp32 f{i + 1} {tuple(a.shape)}: "
              f"{'identical' if same else 'DIFFERENT'} to its plain version "
              f"| {kms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'})",
              flush=True)
        if not same:
            fail("fused_mul_relu in fp32 differs from its plain version")


def tf32_repair_cost(smi: str) -> None:
    """What the TF32 repair costs a float32 trainer: one fp32 train step
    of full-width BiDateNet (batch T_BATCH, patch T_PATCH, tversky + SGD)
    under PyTorch's default flags (cuDNN's TF32 on), its convs through
    ``ops/fp32_conv.py`` (full fp32, as the port runs them) and as plain
    ``F.conv2d`` (TF32 under these flags, as before the repair); the same
    weights and batch, CUDA events."""
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.ops import fp32_conv
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step
    from fabric_tpu_torch.weights import init_variables

    cfg = Config(model_base=BASE, patch_size=T_PATCH, batch_size=T_BATCH,
                 dtype="float32", loss_function="tversky", optimizer="sgd")
    variables = init_variables(13, 2, BASE,
                               torch.Generator().manual_seed(SEED + 2))
    batch = _step_batch(SEED + 2)
    repaired = fp32_conv.conv

    def plain(x, weight, bias=None, padding=0, groups=1):
        op = F.conv2d if x.dim() == 4 else F.conv3d
        return op(x, weight, bias, padding=padding, groups=groups)

    ms = {}
    try:
        for label, conv in (("fp32_conv.conv", repaired),
                            ("F.conv2d", plain)):
            fp32_conv.conv = conv
            model = build_model(cfg, "cuda", fold_bn=False,
                                variables=variables, train=True)
            state = create_state(cfg, model)
            step = make_train_step(model, get_loss_fn(cfg))
            ms[label] = device_ms(lambda: step(state, batch), 3)
            del model, state, step
    finally:
        fp32_conv.conv = repaired
    print(f"tf32 repair cost ({smi}): fp32 BiDateNet train step, batch "
          f"{T_BATCH}, patch {T_PATCH}, PyTorch's default flags (cuDNN TF32 "
          f"on): convs through fp32_conv.conv (full fp32) "
          f"{ms['fp32_conv.conv']:.1f} ms, as F.conv2d (TF32) "
          f"{ms['F.conv2d']:.1f} ms: "
          f"{ms['fp32_conv.conv'] / ms['F.conv2d']:.2f}x", flush=True)


def f32_margin_rule(label: str, mask, plain, margin, scale: float) -> None:
    """An fp32 mask against the same forward on the plain versions: a flip
    only where the plain fp32 logit margin is within 1e-4 of the logit
    scale (the two sum in other orders over 19 layers)."""
    flips = mask != plain
    worst = float(margin[flips].max()) if flips.any() else 0.0
    print(f"{label} vs the plain-version forward: {int(flips.sum())} flips, "
          f"largest plain margin at a flip {worst:.4g} (bound "
          f"{1e-4 * scale:.4g}); change share {mask.mean():.4f}", flush=True)
    if worst > 1e-4 * scale or not np.isfinite(margin).all():
        fail(f"{label}: the fp32 kernel forward disagrees with the plain one")


def f32_phase(root: str, d1, d2, smi: str) -> tuple[list, dict]:
    """Float32 serving on the card, with cuDNN's TF32 left on (PyTorch's
    default) for the phase's duration: the fp32 forms of rows 1, 2 and 5b
    against their plain versions at the fp32 path's shapes (timed, with
    bounds and cuDNN's fp32 time); the 2048^2 pair served grid exact
    (launches against the fp32 gate's count, no bf16 launch; the margin
    rule against the plain versions; predict and runner Mpx/s) and int8
    (identical to the plain int8 forward); one fullconv fp32 serve of the
    pair, banded = whole-scene; UNetLSTM and UNet3D at T = 3 on a 512^2
    stack; one fp32 bundle, equal to the checkpoint path.  Returns (the
    kernel rows, the fp32 forms' launches over the phase's serves)."""
    from fabric_tpu_torch import Config
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.infer import fullconv
    from fabric_tpu_torch.infer.device_tiling import make_scene_infer
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.ops import fp32_matmul, fused
    from fabric_tpu_torch.tools.export import export_bundle
    from fabric_tpu_torch.train.state import create_state

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = True  # a caller's TF32 matmuls
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def no_bf16(label, bf16):
        if any(bf16.values()):
            fail(f"{label}: a bf16 kernel ran on the fp32 path: {bf16}")

    try:
        calls, gate_calls = f32_calls(13)
        rows = check_f32_kernels(calls)
        gate_rows = check_f32_kernels(gate_calls)
        for path, group in (("fused", rows), ("two convs", gate_rows)):
            for r in group:
                if r["two_conv_ms"] is None:
                    continue
                faster = r["ms"] <= r["two_conv_ms"]
                print(f"gate f32 {r['level']}: fused {r['ms']:.3f} ms, two "
                      f"3xTF32 conv launches {r['two_conv_ms']:.3f} ms -> "
                      f"{'fused' if faster else 'two convs'} no slower; on "
                      f"the path: {path}", flush=True)
        ctx = FC_BAND + 2 * fullconv.halo_for("bidate")
        band_rows = check_f32_kernels(f32_band_calls(ctx, SCENE), reps=2)
        rows += check_s8_f32_kernels()
        check_f32_fused()
        tf32_repair_cost(smi)
        per = {}
        for r in rows:
            per[r["name"]] = per.get(r["name"], 0) + r["ms"]
        print(f"fp32 kernels per {BATCH}-tile forward: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in per.items()) + f"; bound (rows 1-2)"
            f" {sum(max(r['t_ops'], r['t_bytes']) for r in rows if 'conv3x3_s8' not in r['name']):.3f} ms",
            flush=True)

        # the main fp32 path: the 2048^2 pair, grid, exact
        cfg = Config(patch_size=PATCH, eval_batch_size=BATCH,
                     dtype="float32", model_base=BASE)
        pred = ScenePredictor(cfg, checkpoint=None, bucket=512,
                              device="cuda")
        fused.fused_mul_relu.launches = 0
        (mask, wall, peak), f32, bf16 = f32_counted(
            lambda: timed(lambda: pred.predict(d1, d2)))
        f32["fused_mul_relu"] = fused.fused_mul_relu.launches
        want = {name: 0 for name in F32_KERNELS.values()}
        for name, _, _ in calls:
            want[name] = want.get(name, 0) + 4  # 4 forwards of BATCH tiles
        want["fused_mul_relu"] = 5 * 4  # row 3 in fp32, 5 a forward
        print(f"fp32 serve of the {SCENE}^2 pair: launches {f32} (expected "
              f"{want}), bf16 forms {bf16}; first predict {wall:.2f} s, "
              f"peak {peak / 2**20:.0f} MiB", flush=True)
        no_bf16("fp32 grid serve", bf16)
        if f32 != want:
            fail("the fp32 serve did not go through the fp32 kernels as "
                 "planned")
        del f32["fused_mul_relu"]
        add(f32)
        plain, margin, plain_logits, _ = plain_mask_and_margin(
            pred.model, d1, d2, torch.float32)
        f32_margin_rule(f"fp32 {SCENE}^2 mask", mask, plain, margin,
                        plain_logits.abs().max().item())
        # the control, not held: the float32 products unpinned, so TF32
        # matmuls as the phase's flag asks (the port before the pin)
        pinned, fp32_matmul._pinned = fp32_matmul._pinned, fp32_matmul._product
        try:
            loose = pred.predict(d1, d2)
        finally:
            fp32_matmul._pinned = pinned
        flips = loose != plain
        print(f"fp32 {SCENE}^2 mask with the products unpinned (TF32 "
              f"matmuls) vs the plain-version forward: {int(flips.sum())} "
              f"flips, largest plain margin at a flip "
              f"{float(margin[flips].max()) if flips.any() else 0.0:.4g} "
              f"(the pinned serve's bound "
              f"{1e-4 * plain_logits.abs().max().item():.4g})", flush=True)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            pred.predict(d1, d2)
            walls.append(time.perf_counter() - t0)
        a1, a2 = (torch.from_numpy(d).cuda() for d in (d1, d2))
        run = pred._get_runner(SCENE, SCENE)
        fwd_ms = device_ms(lambda: run(a1, a2), 2)
        mpx = SCENE * SCENE / 1e6
        wall = statistics.median(walls)
        print(f"fp32 end to end {SCENE}^2 ({smi}): predict "
              f"{wall * 1e3:.1f} ms of {[round(w * 1e3, 1) for w in walls]} "
              f"= {mpx / wall:.2f} Mpx/s; device-resident runner "
              f"{fwd_ms:.1f} ms = {mpx / fwd_ms * 1e3:.2f} Mpx/s", flush=True)

        # int8 with the float32 compute dtype
        pred8 = ScenePredictor(cfg, checkpoint=None, bucket=512,
                               device="cuda", quant="int8")
        pred8.predict(d1, d2)  # calibrates on the fp32 conv kernels
        mask8, f32, bf16 = f32_counted(lambda: pred8.predict(d1, d2))
        print(f"fp32 int8 serve of the {SCENE}^2 pair: launches {f32} "
              f"(conv3x3_s8_q_f32 expected {18 * 4}; the clip probe's fp32 "
              f"calibration forward the rest), bf16 forms {bf16}",
              flush=True)
        no_bf16("fp32 int8 serve", bf16)
        if f32["conv3x3_s8_q_f32"] != 18 * 4:
            fail("the fp32 int8 serve did not run the float32 int8 sites")
        add(f32)
        with plain_int8(), torch.inference_mode():
            plain8 = make_scene_infer(pred8._forward, PATCH, (SCENE, SCENE),
                                      batch_size=BATCH,
                                      dtype=torch.float32)(a1, a2)
        int8_identical(f"fp32 int8 {SCENE}^2 mask", mask8,
                       plain8.cpu().numpy(), False)

        # fullconv: banded = whole-scene
        predfc = ScenePredictor(cfg, checkpoint=None, bucket=512,
                                device="cuda", fullconv_band_rows=FC_BAND)
        (mask_fc, wall_fc, peak_fc), f32, bf16 = f32_counted(
            lambda: timed(lambda: predfc.predict(d1, d2)))
        no_bf16("fp32 fullconv serve", bf16)
        add(f32)
        with torch.inference_mode():
            whole = fullconv.make_fullconv_scene_infer(
                predfc._forward, (SCENE, SCENE), band_rows=SCENE,
                dtype=torch.float32)(a1, a2).cpu().numpy()
        same = np.array_equal(mask_fc, whole)
        print(f"fp32 fullconv serve of the {SCENE}^2 pair (band {FC_BAND}): "
              f"banded == whole-scene: {same} ({int((mask_fc != whole).sum())}"
              f" pixels differ); launches {f32}; {wall_fc:.2f} s with its "
              f"first call, peak {peak_fc / 2**20:.0f} MiB", flush=True)
        if not same or not f32["conv3x3_bias_relu_f32"]:
            fail("fp32 fullconv: banded differs from the whole scene")
        band_kernel_summary(f"fp32, one band {ctx}x{SCENE}", band_rows, f32)
        del a1, a2, run

        # the multi-date families at T = F32_T
        rng = np.random.RandomState(SEED + 15)
        stack = rng.randn(F32_T, F32_MD_SCENE, F32_MD_SCENE,
                          13).astype(np.float32)
        for name, base in F32_MD_BASE.items():
            mcfg = Config(model=name, num_dates=F32_T, patch_size=PATCH,
                          eval_batch_size=BATCH, dtype="float32",
                          model_base=base)
            mp = ScenePredictor(mcfg, checkpoint=None, bucket=512,
                                device="cuda")
            mmask, f32, bf16 = f32_counted(lambda: mp.predict_multidate(stack))
            no_bf16(f"fp32 {name}", bf16)
            if not (f32["conv3x3_bias_relu_f32"]
                    or f32["double_conv3x3_bias_relu_f32"]):
                fail(f"fp32 {name}: no fp32 conv kernel ran")
            add(f32)
            pm, margin, scale = plain_multidate(
                mp.model, torch.from_numpy(stack).cuda(), F32_MD_SCENE,
                torch.float32)
            print(f"fp32 {name} (base {base}, T = {F32_T}, "
                  f"{F32_MD_SCENE}^2): launches {f32}", flush=True)
            f32_margin_rule(f"fp32 {name} mask", mmask, pm, margin, scale)

        # one fp32 bundle
        run_dir = os.path.join(root, "f32_run")
        ckpt.save(create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                                train=True)), run_dir,
                  epoch=0)
        path = os.path.join(root, "bundle_f32.npz")
        export_bundle(cfg, run_dir, path, quant="none")
        served = ScenePredictor(cfg, bundle=path, bucket=512, device="cuda")
        got, f32, bf16 = f32_counted(lambda: served.predict(d1, d2))
        no_bf16("fp32 bundle serve", bf16)
        add(f32)
        same = np.array_equal(got, mask)
        print(f"fp32 bundle serve of the {SCENE}^2 pair: == the fp32 "
              f"checkpoint-free serve (the same seed-0 weights): {same}; "
              f"launches {f32}", flush=True)
        if not same:
            fail("the fp32 bundle does not serve as the fp32 model")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    # the kernels line: the fused kernel at the levels where it fits (on
    # the path or not, as the gate decides)
    return rows + [r for r in gate_rows if r["two_conv_ms"] is not None], \
        total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fabric_tpu_torch import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    from fabric_tpu_torch.ops import _build, conv, double_conv, fused

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{kind} x{count}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {', '.join(logs)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "serialized" in line:
                print(f"  {name}: {line.strip()}")

    calls = main_path_calls(13)
    rows = check_kernels(calls)
    gate_rows = check_kernels(gate_calls(13))
    for r in rows + gate_rows:
        if r["two_conv_ms"] is not None:
            print(f"gate {r['level']}: fused {r['ms']:.3f} ms, two conv "
                  f"launches {r['two_conv_ms']:.3f} ms -> "
                  f"{'fused' if r['ms'] < r['two_conv_ms'] else 'two convs'} "
                  f"faster; on the path: "
                  f"{'fused' if r in rows else 'two convs'}", flush=True)

    # --- the main path: full-width serving through the kernels ---
    cfg = Config(patch_size=PATCH, eval_batch_size=BATCH, dtype="bfloat16",
                 model_base=BASE)
    pred = ScenePredictor(cfg, checkpoint=None, bucket=512, device="cuda")
    rng = np.random.RandomState(SEED)
    d1, d2 = (rng.randn(SCENE, SCENE, 13).astype(np.float32)
              for _ in range(2))
    more = [tuple(rng.randn(h, w, 13).astype(np.float32) for _ in range(2))
            for h, w in ((SCENE, SCENE), (1000, 1500))]
    counters = (conv.conv3x3_bias_relu, double_conv.double_conv3x3_bias_relu,
                fused.fused_mul_relu)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    mask = pred.predict(d1, d2)
    first_s = time.perf_counter() - t0
    many = pred.predict_many(more)
    launches = {fn.__name__: fn.launches for fn in counters}
    # forwards of BATCH tiles: 2048^2 -> 4, 2048^2 -> 4, 1000x1500 in the
    # 1024x1536 bucket -> 384 tiles -> 2
    n_forwards = 4 + 4 + 2
    expected = {}
    for name, _, _ in calls:
        expected[name] = expected.get(name, 0) + n_forwards
    print(f"kernels launched by the serve: {launches} (expected "
          f"{expected}); first predict {first_s:.2f} s", flush=True)
    if launches != expected:
        fail("the serve did not go through the kernels as planned")

    # --- what came out ---
    if mask.shape != (SCENE, SCENE) or mask.dtype != np.uint8 \
            or not set(np.unique(mask)) <= {0, 1}:
        fail(f"bad mask {mask.shape} {mask.dtype}")
    if [m.shape for m in many] != [(SCENE, SCENE), (1000, 1500)]:
        fail(f"bad predict_many shapes {[m.shape for m in many]}")
    for m, pair in zip(many, more):
        if not np.array_equal(m, pred.predict(*pair)):
            fail("predict_many differs from predict")
    print("predict_many == [predict(*p) for p in pairs]: ok", flush=True)

    plain_mask, margin, plain_logits, kernel_logits = plain_mask_and_margin(
        pred.model, d1, d2)
    logit_err = (kernel_logits - plain_logits).abs().max().item()
    logit_scale = plain_logits.abs().max().item()
    flips = mask != plain_mask
    # bf16 kernel and plain forwards round in other orders over 19 layers;
    # a flip is allowed only where the plain margin is within 1/16 of the
    # logit scale, and on at most 0.1% of the pixels
    flip_bound = logit_scale / 16
    worst = float(margin[flips].max()) if flips.any() else 0.0
    print(f"2048^2 mask vs plain-version forward on the card: agreement "
          f"{1 - flips.mean():.6f} ({int(flips.sum())} flips, largest plain "
          f"margin at a flip {worst:.4g}, bound {flip_bound:.4g}); logits of "
          f"the first {BATCH} tiles: max_abs_err {logit_err:.4g} at scale "
          f"{logit_scale:.4g}; change share {mask.mean():.4f}", flush=True)
    if worst > flip_bound or flips.mean() > 1e-3 or not np.isfinite(
            margin).all():
        fail("the kernel forward disagrees with the plain-version forward")

    # --- end-to-end rate ---
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict(d1, d2)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    a1, a2 = (torch.from_numpy(d).cuda() for d in (d1, d2))
    run = pred._get_runner(SCENE, SCENE)
    fwd_ms = device_ms(lambda: run(a1, a2), 3)
    mpx = SCENE * SCENE / 1e6
    per_forward_ms = {}
    for row in rows:
        per_forward_ms[row["name"]] = (per_forward_ms.get(row["name"], 0)
                                       + row["ms"])
    print(f"end to end {SCENE}^2: predict {wall * 1e3:.1f} ms median of "
          f"{[round(w * 1e3, 1) for w in walls]} = {mpx / wall:.2f} Mpx/s "
          f"(host pad/upload/read-back included); device-resident runner "
          f"{fwd_ms:.1f} ms = {mpx / fwd_ms * 1e3:.2f} Mpx/s; kernels per "
          f"{BATCH}-tile forward "
          f"{sum(per_forward_ms.values()):.2f} ms of "
          f"{fwd_ms / (SCENE * SCENE / (PATCH * PATCH) / BATCH):.2f} ms",
          flush=True)

    profile_runner(run, (a1, a2), f"bf16 {SCENE}^2 runner")

    # --- int8: the kernels, the microbench path, the int8 serve ---
    s8_rows, mm_row, within = check_int8_kernels()
    fuse_rows = check_fuse_s8_kernel()
    launches["int8_matmul"] = int8_matmul_path()
    launches.update(int8_serving(cfg, d1, d2, more, wall, fwd_ms, within))
    print(f"conv3x3_s8 per {BATCH}-tile int8 forward: "
          f"{sum(r['ms'] for r in s8_rows):.3f} ms over {len(s8_rows)} "
          f"fused launches, bound "
          f"{sum(max(r['t_ops'], r['t_bytes']) for r in s8_rows):.3f} ms; "
          f"unfused (raw launches + plain epilogue) "
          f"{sum(r['unfused_ms'] for r in s8_rows):.3f} ms", flush=True)
    rows += s8_rows + [mm_row] + fuse_rows

    # --- the other tiled modes, the multi-date models ---
    t0 = time.perf_counter()
    overlap_phases(d1, d2, within)
    fleet_phase(cfg)
    for name in ("unet_lstm", "unet3d"):
        multidate_phase(name, within)
    print(f"tiled modes and multi-date phases: {time.perf_counter() - t0:.1f}"
          f" s", flush=True)

    # --- seamless fullconv, bi-date and multi-date ---
    t0 = time.perf_counter()
    fullconv_phase(d1, d2, fwd_ms, within)
    for name in ("unet_lstm", "unet3d"):
        fullconv_multidate_phase(name, within)
    print(f"fullconv phases: {time.perf_counter() - t0:.1f} s", flush=True)

    # --- multi-GPU serving, n shards on the one card ---
    t0 = time.perf_counter()
    for name, n in sharded_serve_phase(d1, d2, mask).items():
        launches[name] += n
    print(f"sharded_serve phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- serving bundles and AOT artifacts ---
    with tempfile.TemporaryDirectory(prefix="fabric_smoke_aot_") as root:
        t0 = time.perf_counter()
        _, bundles, served_masks, n = bundle_serve_phase(root, d1, d2, mask)
        print(f"bundle_serve phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        for k, v in aot_serve_phase(root, d1, d2, bundles,
                                    served_masks).items():
            n[k] = n.get(k, 0) + v
        print(f"aot_serve phase: {time.perf_counter() - t0:.1f} s",
              flush=True)

    # --- the tools: import_torch, ablate, ablate_train, lane_pack ---
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fabric_smoke_tools_") as root:
        add_counts(n, import_torch_phase(root, d1, d2))
    per_forward = {k: v // n_forwards for k, v in expected.items()}
    add_counts(n, ablate_phase(pred.model, d1, d2, mask,
                               fwd_ms * BATCH * PATCH * PATCH
                               / (SCENE * SCENE),
                               sum(per_forward_ms.values()), per_forward))
    add_counts(n, ablate_train_phase())
    add_counts(n, lane_pack_phase())
    add_counts(n, int8_shift_conv_phase())
    print(f"tool phases: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, v in n.items():  # both int8 conv modes count for row 5b
        key = "conv3x3_s8" if name == "conv3x3_s8_q" else name
        launches[key] = launches.get(key, 0) + v

    # --- float32 serving, with cuDNN's TF32 on for the phase ---
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fabric_smoke_f32_") as root:
        f32_rows, f32_launches = f32_phase(root, d1, d2, smi)
    print(f"f32 phase: {time.perf_counter() - t0:.1f} s", flush=True)
    rows += f32_rows
    for name, counter in F32_KERNELS.items():
        launches[name] = f32_launches.get(counter, 0)

    # --- the training path, then its kernel and cross checks ---
    with tempfile.TemporaryDirectory(prefix="fabric_smoke_") as root:
        cfg_t, state, history, t_launches, evals, records = train_phase(
            root)
        bn_rows = check_bn_kernel()
        check_fused_grad()
        card_vs_cpu_step()
        model = cross_check_serving(cfg_t)
        step = report_training(cfg_t, state, history, records, smi, model)
        validate_phase(cfg_t)
        loader_phase(cfg_t, state, step, smi)
        remat_accum_phase(smi)
        store_phase(cfg_t, root)
        evaluate_phase(cfg_t, root, smi)
        # the multi-date dataset is written while dp_train and sp_train
        # wait on their ranks' processes
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            md_data = pool.submit(md_dataset, root)
            t0 = time.perf_counter()
            dp = dp_train_phase(root)
            print(f"dp_train phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            sp_launches = sp_train_phase(root, dp, smi)
            print(f"sp_train phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            multidate_train_phase(root, smi, md_data)
        print(f"multi-date training phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
    rows += bn_rows
    launches["bn_relu_inference"] = (launches.get("bn_relu_inference", 0)
                                     + t_launches["bn_relu_inference"])
    add_counts(launches, sp_launches)

    sources = {
        "conv3x3_bias_relu": ("cuda",
                              "fabric_tpu_torch/csrc/conv3x3_bias_relu.cu",
                              "fabric_tpu/ops/pallas_conv.py:91"),
        "double_conv3x3_bias_relu": (
            "cuda", "fabric_tpu_torch/csrc/double_conv3x3_bias_relu.cu",
            "fabric_tpu/ops/pallas_double_conv.py:190"),
        "fused_mul_relu": ("triton", "fabric_tpu_torch/ops/fused.py",
                           "fabric_tpu/ops/pallas_fused.py:53"),
        "bn_relu_inference": ("cuda", "fabric_tpu_torch/csrc/bn_relu.cu",
                              "fabric_tpu/ops/pallas_fused.py:77"),
        "int8_matmul": ("cuda", "fabric_tpu_torch/csrc/int8_matmul.cu",
                        "fabric_tpu/tools/ablate_train.py:373"),
        # replaces XLA's s8 conv conv_raw, the serving use of kernel 5
        "conv3x3_s8": ("cuda", "fabric_tpu_torch/csrc/conv3x3_s8.cu",
                       "fabric_tpu/infer/quant.py:176"),
        # replaces XLA's fusion of fuse_q / f5 and the int8 pool
        "siamese_fuse_s8": ("cuda", "fabric_tpu_torch/csrc/siamese_s8.cu",
                            "fabric_tpu/infer/quant.py:336"),
        # the float32 forms of rows 1, 2 and 5b
        "conv3x3_bias_relu_f32": (
            "cuda", "fabric_tpu_torch/csrc/conv3x3_bias_relu_f32.cu",
            "fabric_tpu/ops/pallas_conv.py:91"),
        "double_conv3x3_bias_relu_f32": (
            "cuda", "fabric_tpu_torch/csrc/double_conv3x3_bias_relu_f32.cu",
            "fabric_tpu/ops/pallas_double_conv.py:190"),
        "conv3x3_s8_f32": ("cuda", "fabric_tpu_torch/csrc/conv3x3_s8.cu",
                           "fabric_tpu/infer/quant.py:176"),
    }
    kernels = []
    for name, (route, source, replaces) in sources.items():
        mine = [r for r in rows if r["name"] == name]
        t_ops = sum(max(r["t_ops"], r["t_bytes"]) for r in mine
                    if r["t_ops"] >= r["t_bytes"])
        t_bytes = sum(max(r["t_ops"], r["t_bytes"]) for r in mine
                      if r["t_ops"] < r["t_bytes"])
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (None if mine[0]["library_ms"] is None
                           else sum(r["library_ms"] for r in mine)),
        })
    print("per-kernel ms, plain_ms, bound_ms and library_ms are summed over "
          f"the kernel's launches in one forward: {BATCH} serving tiles at "
          f"patch {PATCH} for the conv and fusion kernels (launches: the "
          f"serve, the sharded serve, the bundle and AOT serves and the "
          f"tool phases; fused_mul_relu also every sp_train rank's), "
          f"{T_BATCH} eval tiles at patch {T_PATCH} in bf16 "
          f"for bn_relu_inference (its conv-bias form; launches: the "
          f"training run, {evals} eval forwards, ablate_train's "
          f"eval_fwd and every sp_train rank's), one int8 forward of "
          f"{BATCH} tiles "
          "for conv3x3_s8 (its 18 fused sites; launches: the int8 serves "
          "and the int8 shift-conv microbench's raw launches; no "
          "PyTorch call computes an int8 conv) and siamese_fuse_s8 (its 5 "
          "levels; launches: the int8 serves; no single PyTorch call "
          "computes it), the int8 form at 131072 x 512 x 512 for "
          "int8_matmul (library: torch._int_mm; launches: its microbench "
          "and the shift-conv microbench); the *_f32 forms over one fp32 "
          f"forward of {BATCH} tiles (rows 1-2: bound of 3xTF32, three TF32 "
          "products per float32 product at 495 TFLOP/s, library cuDNN's "
          "fp32 conv + ReLU with TF32 off; launches: the fp32 phase's "
          "serves; double_conv3x3_bias_relu_f32 timed at the levels where "
          "its cluster fits, which its gate leaves to two conv launches)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def run() -> int:
    """main(), then the loaders' forkserver and resource tracker stopped
    and waited for, so that no process outlives the script."""
    try:
        return main()
    finally:
        if "fabric_tpu_torch.data.loader" in sys.modules:
            sys.modules["fabric_tpu_torch.data.loader"].stop_worker_server()


if __name__ == "__main__":
    sys.exit(run())
