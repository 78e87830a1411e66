"""Scene serving: a closed loop of aligned scene pairs through
``ScenePredictor.predict_many`` with ``window`` scenes in flight.

Set-up builds the predictor, loads the seeded weights into it (the
program folds BatchNorm), makes a pool of distinct scene pairs from the
seed and serves ``warmup_scenes`` of them (every runner built, every
kernel compiled).  The window is one ``predict_many`` call over a
generator that hands out the pool's pairs in turn until ``--seconds``
have passed; each scene is timed from the moment the predictor takes it
(its dispatch) to the moment its mask is on the host (the predictor's
per-scene record, which this driver receives as its tracker).  After the
window a sample of the served masks, drawn from the seed with the last
scene in it, is judged against the plain reference (``reference/``).

Workload keys: ``scene`` [H, W], ``pool``, ``window``, ``bucket``,
``patch``, ``tile_batch``, ``warmup_scenes``, ``trace_seconds`` (the
traced run's window), ``runner_repeats``, ``check_scenes``,
``reference_block`` (tiles a reference forward), ``limits``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import data as bench_data
from benchmark.harness import device as bench_device
from benchmark.harness import manifest, trace
from benchmark.harness.phases import Phases
from benchmark.harness import weights as bench_weights
from benchmark.reference import compare, precision
from benchmark.reference.nets import Net


class _Clock:
    """The predictor's tracker: the host clock at each scene's record,
    which the predictor writes once the scene's mask is on the host."""

    def __init__(self):
        self.done: list[float] = []

    def log_metrics(self, rec, step=None, prefix=""):
        self.done.append(time.perf_counter())


def _program(ctx, params, stats, clock):
    from fabric_tpu_torch import weights as program_weights
    from fabric_tpu_torch.config import Config
    from fabric_tpu_torch.infer.service import ScenePredictor
    wl, cj = ctx.workload, ctx.config
    cfg = Config(model=cj["model"], model_base=cj["model_base"],
                 dtype=cj["dtype"], patch_size=wl["patch"],
                 batch_size=wl["tile_batch"],
                 eval_batch_size=wl["tile_batch"])
    if cfg.n_channels != cj["n_channels"]:
        raise ValueError("the program's band list is not the config's")
    pred = ScenePredictor(cfg, bucket=wl["bucket"], device=ctx.device,
                          tracker=clock)
    program_weights.load_variables(pred.model, bench_weights.to_host(params),
                                   bench_weights.to_host(stats))
    return cfg, pred


def _inputs(ctx, phase=lambda name: None):
    wl, cj = ctx.workload, ctx.config
    dev = torch.device(ctx.device)
    params, stats = bench_weights.make(cj, ctx.seed, dev)
    phase("weights")
    h, w = wl["scene"]
    pool = bench_data.scene_pool(ctx.seed, wl["pool"], h, w,
                                 cj["n_channels"], dev)
    phase("scene pool")
    return params, stats, pool


def run(ctx) -> dict:
    wl = ctx.workload
    dev = torch.device(ctx.device)
    phase = Phases(ctx.t0)
    params, stats, pool = _inputs(ctx, phase)
    clock = _Clock()
    cfg, pred = _program(ctx, params, stats, clock)
    phase("predictor")
    n_pool = len(pool)
    pred.predict_many((pool[i % n_pool] for i in range(wl["warmup_scenes"])),
                      window=wl["window"])
    bench_device.sync(dev)
    phase("warmup")

    seconds = min(ctx.seconds, wl["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    sent: list[tuple[float, int]] = []
    clock.done.clear()
    prof = trace.profiler() if ctx.trace else None
    if prof is not None:
        prof.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds

    def scenes():
        i = 0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                return
            sent.append((now, i % n_pool))
            yield pool[i % n_pool]
            i += 1

    with trace.window():
        masks = pred.predict_many(scenes(), window=wl["window"])
    t_end = time.perf_counter()
    if prof is not None:
        prof.stop()
    peak = bench_device.memory_peak(dev)

    h, w = wl["scene"]
    lat = [d - s for (s, _), d in zip(sent, clock.done)]
    pixels = sum(m.shape[0] * m.shape[1] for m in masks)
    out = {"attempted": len(sent),
           "failed": len(sent) - len(masks)
           + sum(m.shape != (h, w) for m in masks),
           "memory_peak_bytes": peak, "count": 1,
           **bench_device.describe(dev)}
    out["end_to_end"] = {
        "setup_s": t_start - ctx.t0,
        "serve_mpx_s": pixels / 1e6 / (t_end - t_start),
        "scene_p95_ms": 1e3 * float(np.percentile(lat, 95)) if lat
        else float("nan")}
    # scenes returned in each second of the window
    out["host"] = {"scenes_per_s": np.bincount(
        [int(t - t_start) for t in clock.done],
        minlength=int(seconds) + 1).tolist()}
    if prof is not None:
        out["trace"] = trace.reduce(prof)
        out["counts"] = {"pixels": pixels, "scenes": len(masks),
                         "tiles": pixels // (wl["patch"] ** 2)}
        out["timings"] = _runner_timing(ctx, cfg, pred, pool[0])
    del pred
    bench_device.release(dev)
    out["checks"] = judge(ctx, params, stats, pool, masks,
                          [p for _, p in sent])
    return out


def _runner_timing(ctx, cfg, pred, pair) -> dict:
    """The device-resident runner (the scene already on the card), timed
    with CUDA events over ``runner_repeats`` runs."""
    from fabric_tpu_torch.infer.device_tiling import make_scene_infer
    wl = ctx.workload
    h, w = wl["scene"]
    dev = torch.device(ctx.device)
    run = make_scene_infer(pred.model, cfg.patch_size, (h, w),
                           batch_size=cfg.eval_batch_size, dtype=pred.dtype)
    a1, a2 = (torch.from_numpy(d).to(dev) for d in pair)
    for _ in range(2):
        run(a1, a2)
    ms = bench_device.timed_ms(dev, lambda: run(a1, a2),
                               wl["runner_repeats"])
    return {"runner_ms": ms, "runner_mpx_s": h * w / 1e6 / (ms / 1e3)}


def _reference(ctx, params, stats, q=None) -> Net:
    bench_device.reference_mode()
    kw = {} if q is None else {"q": q}
    return Net(manifest.model(ctx.config["model"]), params, stats,
               train=False, **kw)


def judge(ctx, params, stats, pool, masks, pool_ids) -> dict:
    """{"mask_gap": (the widest gap over a sample of the served masks,
    its limit)}."""
    wl = ctx.workload
    dev = torch.device(ctx.device)
    n = len(masks)
    if n == 0:
        return {"mask_gap": (float("inf"), wl["limits"]["mask_gap"])}
    rng = np.random.default_rng(abs(int(ctx.seed)))
    pick = set(rng.choice(n, min(wl["check_scenes"], n), replace=False)
               .tolist()) | {n - 1}
    net = _reference(ctx, params, stats)
    gap = 0.0
    for pid in sorted({pool_ids[i] for i in pick}):
        d1, d2 = (torch.from_numpy(d).to(dev) for d in pool[pid])
        ref = compare.tiled_logits(net, d1, d2, wl["patch"],
                                   wl["reference_block"])
        for i in sorted(i for i in pick if pool_ids[i] == pid):
            gap = max(gap, compare.widest_gap(
                ref, torch.from_numpy(np.ascontiguousarray(masks[i]))
                .to(dev)))
    return {"mask_gap": (gap, wl["limits"]["mask_gap"])}


def control(ctx) -> dict:
    """The control's reading: the reference rounded to fp8 put in the
    program's place, its classes judged as the served masks are, on the
    whole pool."""
    wl = ctx.workload
    dev = torch.device(ctx.device)
    params, stats, pool = _inputs(ctx)
    net = _reference(ctx, params, stats)
    low = _reference(ctx, params, stats, q=precision.fp8)
    gap = 0.0
    for d1, d2 in pool:
        d1, d2 = (torch.from_numpy(d).to(dev) for d in (d1, d2))
        ref = compare.tiled_logits(net, d1, d2, wl["patch"],
                                   wl["reference_block"])
        served = compare.tiled_logits(low, d1, d2, wl["patch"],
                                      wl["reference_block"]).argmax(-1)
        gap = max(gap, compare.widest_gap(ref, served))
    return {"mask_gap": gap}
