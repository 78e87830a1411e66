"""Training: the training loop's own step and feed over synthetic cities,
in the steady epoch, for ``--seconds``; with ``ranks`` > 1 one process a
card in a data-parallel NCCL group.

Set-up makes the cities (the dataset, in host memory as the loop loads
it) and the weights from the seed, builds the model with the loop's
model factory, its state and its step (``train/state.py``, ``train/steps.py``)
and the loop's batches (``train.loop.EpochBatches``: ``num_workers``
worker processes), and drives that one state through its first
``check_steps`` steps (kept for the ``correct`` check) and warms up
until the loader keeps up (``_warm_up``).  The window then runs the same step on the same feed until ``--seconds`` have passed (across epochs when one ends; the
ranks agree each step on stopping, as the loop agrees on preemption),
and waits for the card.  The rate is every example of the window (the
global batch a step) over the window.  The loop's validation pass,
scene inference and checkpoints are not in the window.

The window's host side goes under ``host``: the warm-up's steps, the
seconds spent waiting for the loader's next batch, the steps begun in
each second, and (one card) one step on a batch on the card by CUDA
events.

After the window the reference (``reference/``) derives the first
steps' global batches again from the dataset, checks the program's batch
rows against them, and trains from the same weights in float32.

Workload keys: ``patch``, ``stride``, ``batch`` (global), ``ranks``,
``num_workers``, ``prefetch``, ``learning_rate``, ``loss``,
``tversky_alpha``, ``tversky_beta``, ``cities`` [count, H, W],
``check_steps``, ``warmup_steps``, ``steady_steps``, ``steady_wait_ms``,
``warmup_max_steps``, ``trace_seconds``, ``step_repeats``,
``rate_metric`` (the end-to-end metric the rate is reported as),
``limits``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.harness import data as bench_data
from benchmark.harness import device as bench_device
from benchmark.harness import manifest, ranks, trace
from benchmark.harness.phases import Phases
from benchmark.harness import weights as bench_weights
from benchmark.reference import batches as ref_batches
from benchmark.reference import compare, precision
from benchmark.reference.nets import Net, tversky


def _config(ctx):
    from fabric_tpu_torch.config import Config
    wl, cj = ctx.workload, ctx.config
    cfg = Config(model=cj["model"], model_base=cj["model_base"],
                 num_dates=cj.get("num_dates", 2), dtype=cj["dtype"],
                 patch_size=wl["patch"], stride=wl["stride"],
                 batch_size=wl["batch"], eval_batch_size=wl["batch"],
                 num_workers=wl["num_workers"], prefetch=wl["prefetch"],
                 seed=int(ctx.seed) % (2 ** 31),
                 learning_rate=wl["learning_rate"],
                 loss_function=wl["loss"],
                 tversky_alpha=wl["tversky_alpha"],
                 tversky_beta=wl["tversky_beta"], optimizer="sgd",
                 augmentation=True, validation_cities=[],
                 handle_preemption=False)
    if cfg.n_channels != cj["n_channels"]:
        raise ValueError("the program's band list is not the config's")
    return cfg


def _dataset(ctx, dev):
    n, h, w = ctx.workload["cities"]
    cj = ctx.config
    return bench_data.cities(ctx.seed, n, h, w, cj["n_channels"],
                             cj.get("num_dates", 2), dev)


class _Feed:
    """The loop's training batches, epoch after epoch."""

    def __init__(self, batches):
        self.batches, self.epoch = batches, 0
        self.it = batches.train(0)

    def __next__(self):
        while True:
            try:
                return next(self.it)
            except StopIteration:
                self.epoch += 1
                self.it = self.batches.train(self.epoch)


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def run(ctx) -> dict:
    world = ctx.workload["ranks"]
    procs = []
    if world > 1 and ctx.rank == 0:
        ctx.port = ranks.free_port()
        procs = ranks.spawn(ctx.argv, world, ctx.port)
    try:
        out = _run_rank(ctx, world)
    finally:
        codes = ranks.wait(procs)
    if any(codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    return out


def _run_rank(ctx, world: int) -> dict:
    from fabric_tpu_torch.data import loader as program_loader
    from fabric_tpu_torch.data.oscd import metadata_from_dataset
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.parallel import distributed
    from fabric_tpu_torch.train import loop
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_train_step

    wl, cj = ctx.workload, ctx.config
    phase = Phases(ctx.t0) if ctx.rank == 0 else (lambda name: None)
    if world > 1:
        os.environ.update(ranks.environment(ctx.rank, world, ctx.port))
        distributed.maybe_initialize(ctx.device)
        phase("process group")
    dev = torch.device(ctx.device, ctx.rank) if ctx.device == "cuda" \
        else torch.device(ctx.device)
    cfg = _config(ctx)
    loop.set_mesh(cfg)
    dataset = _dataset(ctx, dev)
    train_md, _ = metadata_from_dataset(dataset, [], cfg.patch_size,
                                        cfg.stride)
    phase("dataset")
    params, stats = bench_weights.make(cj, ctx.seed, dev)
    model = build_model(cfg, dev, variables=(bench_weights.to_host(params),
                                             bench_weights.to_host(stats)),
                        fold_bn=False, train=True)
    distributed.broadcast_module(model)
    state = create_state(cfg, model)
    step = make_train_step(model, get_loss_fn(cfg))
    phase("model")
    batches = loop.EpochBatches(cfg, dataset, train_md, [], dev)
    phase("shared dataset")
    try:
        return _measure(ctx, world, dev, cfg, dataset, params, state, step,
                        batches, distributed, phase)
    finally:
        batches.close()
        if distributed.active():
            distributed.shutdown()
        program_loader.stop_worker_server()


def _warm_up(wl: dict, feed, step, state, world: int, distributed):
    """Steps until the loader keeps up: ``warmup_steps`` at least (more
    than the batches it holds ready, which it filled while the set-up
    ran), then until ``steady_steps`` steps in a row found their batch
    ready (the feed returned within ``steady_wait_ms``);
    ``warmup_max_steps`` at the most.  The ranks go on while any of them
    has not.  In some runs the workers keep up with the card only some
    seconds after the first batch, and a window that opened before then
    would wait for them."""
    n, run = 0, 0
    while True:
        more = n < wl["warmup_max_steps"] and (
            n < wl["warmup_steps"] or run < wl["steady_steps"])
        if world > 1:
            more = distributed.any_rank(more)
        if not more:
            break
        t = time.perf_counter()
        batch = next(feed)
        ready = time.perf_counter() - t < wl["steady_wait_ms"] / 1e3
        run = run + 1 if ready else 0
        state, _ = step(state, batch)
        n += 1
    return state, n


def _measure(ctx, world, dev, cfg, dataset, params, state, step, batches,
             distributed, phase) -> dict:
    wl = ctx.workload
    feed = _Feed(batches)
    p0 = _params(state.model)
    first, losses, p1 = [], [], None
    for s in range(wl["check_steps"]):
        batch = next(feed)
        if s == 0:
            phase("first batch")
        first.append({k: v.clone() for k, v in batch.items()})
        state, st = step(state, batch)
        losses.append(st["loss"])
        if s == 0:
            p1 = _params(state.model)
    pk = _params(state.model)
    phase("checked steps")
    state, warm = _warm_up(wl, feed, step, state, world, distributed)
    bench_device.sync(dev)
    phase("warmup")
    if world > 1:  # the host group that agrees on stopping, made now
        distributed.any_rank(False)
        distributed.all_reduce_(torch.zeros(1, device=dev))
        bench_device.sync(dev)

    seconds = min(ctx.seconds, wl["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    prof = trace.profiler() if ctx.trace else None
    if prof is not None:
        prof.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    n, window_losses, fed, waited = 0, [], [], 0.0
    with trace.window():
        while True:
            now = time.perf_counter()
            stop = now >= deadline
            if world > 1:
                stop = distributed.any_rank(stop)
            if stop:
                break
            batch = next(feed)
            fed.append(time.perf_counter())
            waited += fed[-1] - now
            state, st = step(state, batch)
            window_losses.append(st["loss"])
            n += 1
        bench_device.sync(dev)
    t_end = time.perf_counter()
    if prof is not None:
        prof.stop()
    peak = bench_device.memory_peak(dev)
    lost = int((~torch.isfinite(torch.stack(window_losses))).sum()) \
        if window_losses else 0
    out = {"attempted": n, "failed": lost, "count": world,
           **bench_device.describe(dev)}
    out["end_to_end"] = {
        "setup_s": t_start - ctx.t0,
        wl["rate_metric"]: n * cfg.batch_size / (t_end - t_start)}
    # the host's side of the window: the wait for the loader's batches
    # (the host clock around the feed), steps begun in each second
    per_s = np.bincount([int(t - t_start) for t in fed],
                        minlength=int(seconds) + 1).tolist()
    out["host"] = {"feed_wait_s": waited, "steps_per_s": per_s,
                   "warmup_steps": warm}
    if world == 1 and dev.type == "cuda":
        out["host"]["device_step_ms"] = bench_device.timed_ms(
            dev, lambda: step(state, batch), wl["step_repeats"])
    if prof is not None:
        red = trace.reduce(prof)
        if world > 1:  # busy and window seconds averaged over the cards
            both = torch.tensor([red["busy_s"], red["window_s"]],
                                dtype=torch.float64, device=dev)
            distributed.all_reduce_(both)
            red["busy_s"], red["window_s"] = (both / world).tolist()
        out["trace"] = red
        out["counts"] = {"examples": n * cfg.batch_size, "steps": n,
                         "patch": cfg.patch_size}
        out["timings"] = {k: out["host"][k] for k in ("device_step_ms",)
                          if k in out["host"]}
    if world > 1:
        top = torch.tensor([peak], dtype=torch.float64, device=dev)
        torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)
        peak = int(top.item())
    out["memory_peak_bytes"] = peak
    if ctx.rank != 0:
        return out
    prog = {"losses": [float(v) for v in torch.stack(losses).cpu()],
            "p0": p0, "p1": p1, "pk": pk, "first": first}
    del state, step
    bench_device.release(dev)
    out["notes"] = {}
    out["checks"] = judge(ctx, cfg, dataset, params, prog, world, dev,
                          out["notes"])
    return out


def reference_steps(ctx, cfg, dataset, params, dev, q=None):
    """The reference's losses, first gradient and parameters after the
    check steps, on the global batches it derives itself."""
    wl, cj = ctx.workload, ctx.config
    bench_device.reference_mode()
    model = manifest.model(cj["model"])
    patches = ref_batches.train_patches(dataset, [], cfg.patch_size,
                                        cfg.stride)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in bench_weights.flatten(params).items()}
    tree: dict = {}
    for k, v in leaves.items():
        bench_weights.put(tree, tuple(k.split(".")), v)
    kw = {} if q is None else {"q": q}
    net = Net(model, tree, train=True, remat=True, **kw)
    losses, grad, batches = [], None, []
    for s in range(wl["check_steps"]):
        b = ref_batches.batch(dataset, patches, cfg.patch_size,
                              cfg.batch_size, cfg.seed, s, model.MULTI_DATE)
        batches.append(b)
        t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        loss = tversky(net(t), t["label"], t["weight"], cfg.tversky_alpha,
                       cfg.tversky_beta)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if s == 0:
                grad = {k: g.clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                leaves[k] -= cfg.learning_rate * g
        del loss, grads, t
    final = {k: v.detach() for k, v in leaves.items()}
    return losses, grad, final, batches


def readings(ref, prog, p0, notes: dict | None = None) -> dict:
    """{"loss_gap", "grad_gap", "change_gap", and the median leaf's
    "grad_gap_median", "change_gap_median"} of a (losses, first gradient,
    final params) run against the reference's; ``notes`` gets the three
    worst leaves of each leaf gap (and ``judge`` the readings that the
    cell's limits leave out)."""
    r_loss, r_grad, r_final = ref
    o_loss, o_grad, o_final = prog
    rg = compare.leaf_norms(r_grad)
    counted = compare.counted_leaves(rg)
    og = compare.leaf_norms(o_grad)
    rc = compare.leaf_norms({k: r_final[k] - p0[k] for k in counted})
    oc = compare.leaf_norms({k: o_final[k] - p0[k] for k in counted})
    out = {"loss_gap": compare.loss_gap(o_loss, r_loss)}
    for name, o, r in (("grad_gap", og, rg), ("change_gap", oc, rc)):
        gaps = compare.leaf_gaps(o, r, counted)
        if notes is not None:
            notes[name] = sorted(gaps, key=gaps.get)[-3:]
        out[name] = max(gaps.values())
        out[name + "_median"] = float(np.median(list(gaps.values())))
    return out


def judge(ctx, cfg, dataset, params, prog, world, dev, notes: dict) -> dict:
    wl = ctx.workload
    lim = wl["limits"]
    ref_loss, ref_grad, ref_final, ref_b = reference_steps(
        ctx, cfg, dataset, params, dev)
    # rank 0's rows of each global batch, as the program's feed gave them
    rows = cfg.batch_size // world
    mismatch = 0
    for got, want in zip(prog["first"], ref_b):
        for k, v in got.items():
            w = torch.from_numpy(want[k][:rows]).to(dev)
            mismatch += int((v != w).sum()) if v.shape == w.shape \
                else v.numel()
    p0 = prog["p0"]
    lr = cfg.learning_rate
    o_grad = {k: (p0[k] - prog["p1"][k]) / lr for k in p0}
    r = readings((ref_loss, ref_grad, ref_final),
                 (prog["losses"], o_grad, prog["pk"]), p0, notes)
    notes["uncompared"] = {k: v for k, v in r.items() if k not in lim}
    return {"batch_mismatch": (mismatch, lim["batch_mismatch"]),
            **{k: (v, lim[k]) for k, v in r.items() if k in lim}}


def control(ctx) -> dict:
    """The control's readings: the reference rounded to fp8 put in the
    program's place, against the float32 reference, on the same
    batches."""
    dev = torch.device(ctx.device, 0) if ctx.device == "cuda" \
        else torch.device(ctx.device)
    cfg = _config(ctx)
    dataset = _dataset(ctx, dev)
    params, _ = bench_weights.make(ctx.config, ctx.seed, dev)
    ref = reference_steps(ctx, cfg, dataset, params, dev)[:3]
    low = reference_steps(ctx, cfg, dataset, params, dev,
                          q=precision.fp8)[:3]
    p0 = {k: v.detach() for k, v in bench_weights.flatten(params).items()}
    return readings(ref, low, p0)
