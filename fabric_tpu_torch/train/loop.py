"""The training loop: epochs of train and validation, whole-scene
inference of the validation cities, best-metric and periodic checkpoints
with exact resume (counterpart of ``fabric_tpu/train/loop.py``, one
process on one device), for BiDateNet and the multi-date models
(UNetLSTM, UNet3D: batches of ``cfg.num_dates`` dates as ``imgs``).

Per epoch: train steps over shuffled, augmented, wrap-padded batches; a
validation pass over mask-padded batches (running-average BatchNorm, on
the ``bn_relu_inference`` kernel on the card); the change mask of each
validation city with its scene precision/recall/F1; a checkpoint when any
of the validation precision, recall or F1 improved.  Per-step stats stay
on the device and come to the host once per epoch, or at a periodic save.
A periodic save (``checkpoint_every``) carries the epoch's progress and
stat rows so far, so a resumed run finishes the epoch bit-identically; a
SIGTERM (or ``guard.request()``) forces that save at the next step and
unwinds with ``history["status"] == "preempted"``; a non-finite loss
halts the run at the next host sync, before it can overwrite a finite
periodic checkpoint.  The epoch's ``train_`` record carries its
``examples_per_sec``, ``seconds``, ``steps`` and ``feed_wait_s`` (the
seconds its steps waited for their batches: the epoch's share of the
loader's ``loader.wait_s`` counter, ``utils/profiling.count``), and with
``cfg.profile_dir`` the first ``cfg.profile_steps`` train steps are traced
there (``torch.profiler``, the card's kernels included; the loader's
``loader.*`` spans with them).

Training on several cards runs one process per card in a
``torch.distributed`` group (``parallel/distributed.maybe_initialize``,
as ``cli.train`` calls it), with the config's (data, spatial, model)
mesh laid over the processes (``parallel/distributed.set_mesh``;
``cfg.mesh_data`` -1 takes the processes the other axes leave; a mesh of
another size raises, as ``fabric_tpu`` raises for missing devices).
Every rank derives the same global batch order and materialises the
``batch_size / D`` rows of its data slice (an indivisible batch raises,
as ``fabric_tpu``'s multi-process pipeline does) and, on a spatial axis
of S, its S-th of each patch's height, as ``fabric_tpu``'s
``batch_shardings`` place a batch over ("data", "spatial"); the ranks of
the ``model`` axis hold replicas, since ``fabric_tpu`` places nothing
over it.  The BatchNorm statistics, the loss and the confusion counts are
the global batch's, the forward's halo exchanges are
``parallel/spatial.py``'s, and the update takes the mean of the ranks'
gradients, so the run computes what one process computes on the same
global batches.  The parameters and buffers are broadcast from rank 0
after the start or a resume.  Only rank 0 writes (the tracker; the
others get a ``NullTracker``), checkpoints, mirrors to the store, traces
and runs the scene inference of the validation cities (no collective
runs there, so the other ranks go on to the next epoch); the validation
previews gather their rows over the spatial group first.  The ranks
agree on a preemption request every step (a host all-reduce), so that
all of them unwind at the same step.  ``compat_reference``'s sequential
augmentation stream and ragged last batch need one data slice, as in
``fabric_tpu``: several data ranks keep the keyed augmentation and whole
batches.

The batches come from ``cfg.num_workers`` worker processes
(``data/loader.py``), or with 0 from one prefetch thread; both give the
same batches.  ``compat_reference`` keeps the thread: it draws the
augmentation from one ``random.Random(cfg.seed)`` stream across epochs
(fast-forwarded past the finished epochs on resume) and trains the
epoch's short final batch as it is, as the reference's DataLoader does.
With ``cfg.output_store`` every save, and at the end the tracker
directory, is mirrored to the store (``store.py``), and ``cfg.resume``
may name a store URI.

The loop takes every option of ``fabric_tpu``'s.  On a mesh's spatial
axis ``lane_pack`` packs the convs of a split level from halo rows, as
it packs them in one process (``models/blocks.py``).
"""

from __future__ import annotations

import logging
import os
import random
import time

import numpy as np
import torch

from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.data.download import dataset_provenance, ensure_dataset
from fabric_tpu_torch.data.image import read_png_gray, scale, stretch_8bit
from fabric_tpu_torch.data.loader import BatchLoader, share_dataset
from fabric_tpu_torch.data.oscd import (full_load, get_train_val_metadata,
                                        load_label, metadata_from_dataset)
from fabric_tpu_torch.data.pipeline import (PatchSampler, batch_iterator,
                                            epoch_train_rows,
                                            prefetch_to_device,
                                            replay_aug_draws)
from fabric_tpu_torch.infer.runner import infer_city
from fabric_tpu_torch.infer.service import resolve_device
from fabric_tpu_torch.losses import get_loss_fn
from fabric_tpu_torch.metrics import MetricAccumulator, prf1_from_counts
from fabric_tpu_torch.models import MULTI_DATE, build_model
from fabric_tpu_torch.parallel import distributed, spatial
from fabric_tpu_torch.parallel.mesh import indexed_device
from fabric_tpu_torch.store import open_store
from fabric_tpu_torch.track import NullTracker, Tracker
from fabric_tpu_torch.train.preemption import (PreemptionGuard,
                                               TrainingPreempted)
from fabric_tpu_torch.train.state import create_state
from fabric_tpu_torch.train.steps import make_eval_step, make_train_step
from fabric_tpu_torch.utils import profiling

log = logging.getLogger("fabric_tpu_torch")

_STAT_KEYS = ("loss", "tp", "fp", "fn", "tn")
_COUNT_KEYS = ("tp", "fp", "fn", "tn")


def set_mesh(cfg) -> None:
    """Lay ``cfg``'s (data, spatial, model) mesh over the process group,
    one process a device (``mesh_data`` -1 takes the processes that the
    other axes leave); a ValueError for a mesh of another size."""
    world = distributed.world_size()
    s, m = cfg.mesh_spatial, cfg.mesh_model
    d = max(world // (s * m), 1) if cfg.mesh_data == -1 else cfg.mesh_data
    if d * s * m != world:
        raise ValueError(f"mesh {d}x{s}x{m} needs {d * s * m} devices, "
                         f"have {world} (the mesh spans the processes, one "
                         f"card each)")
    distributed.set_mesh(d, s, m)


class _ProfileCapture:
    """Trace the first ``nsteps`` train steps into ``logdir``; the trace
    stops once the card has finished them, or at the end of a shorter
    first epoch (:meth:`stop`)."""

    def __init__(self, logdir: str, nsteps: int, cuda: bool):
        self._prof = profiling.start_trace(logdir, cuda)
        self._left = max(nsteps, 1)
        log.info("profiler trace started -> %s (%d steps)", logdir, nsteps)

    def on_step(self, state, stats=None) -> None:
        if self._prof is None:
            return
        self._left -= 1
        if self._left <= 0:
            self.stop(state)

    def stop(self, state=None) -> None:
        """Wait for the steps' device work (``state``'s), then stop and
        write the trace."""
        if self._prof is None:
            return
        if state is not None:
            profiling.sync(state.model)
        self._prof.stop()
        self._prof = None


def improved(mean_val: dict, best: dict) -> bool:
    """Checkpoint when any of precision, recall or F1 improved."""
    return any(mean_val[k] > best[k]
               for k in ("cd_precisions", "cd_recalls", "cd_f1scores"))


def _host_rows(rows: list[dict]) -> np.ndarray:
    """(steps, 5) float64 [loss, tp, fp, fn, tn]: one transfer per key."""
    return np.stack([torch.stack([r[k] for r in rows]).cpu().double().numpy()
                     for k in _STAT_KEYS], axis=1)


def _check_finite(losses: np.ndarray, tracker, where: str) -> None:
    if not np.all(np.isfinite(losses)):
        bad = int(np.argmax(~np.isfinite(losses)))
        tracker.set_status("diverged")
        raise FloatingPointError(
            f"non-finite training loss at batch {bad + 1} {where} "
            f"(loss={losses[bad]})")


def _epoch(step_fn, state, batches, accumulator, train: bool,
           on_first_batch=None, on_step=None, tracker=None,
           log_every: int = 0, prefix: str = "") -> int:
    """One pass over ``batches``; returns the number of steps.  Per-step
    stats stay on the device and are read once at the end, except with
    ``log_every`` > 0, which reads every step to stream running means."""
    stream = tracker is not None and log_every > 0
    rows: list[dict] = []
    n = 0
    for i, batch in enumerate(batches):
        if train:
            state, stats = step_fn(state, batch)
        else:
            stats = step_fn(state, batch)
        n += 1
        if i == 0 and on_first_batch is not None:
            on_first_batch(batch, stats)
        if stream:
            loss = float(stats["loss"])
            if train:
                _check_finite(np.array([loss]), tracker, "(streamed)")
            accumulator.update(loss, {k: int(stats[k]) for k in _COUNT_KEYS})
            if (i + 1) % log_every == 0:
                tracker.log_metrics(accumulator.means(), prefix=prefix,
                                    step=state.step if train else i + 1)
        else:
            rows.append({k: stats[k] for k in _STAT_KEYS})
        if on_step is not None:
            on_step(state, stats)
    if rows:
        host = _host_rows(rows)
        if train:
            _check_finite(host[:, 0], tracker, f"of {len(rows)} this epoch")
        for row in host:
            accumulator.update(float(row[0]),
                               dict(zip(_COUNT_KEYS, (int(v) for v in
                                                      row[1:]))))
    return n


def _denorm_rgb(img: np.ndarray) -> np.ndarray:
    """RGB preview of a normalised 13-band patch (bands 3, 2, 1)."""
    return scale(np.asarray(img)[..., 1:4][..., ::-1]).astype(np.uint8)


def _log_val_patches(tracker, epoch: int, batch, stats) -> None:
    """Comparison figures of every 10th sample of the first val batch (a
    multi-date batch shows its first and last dates as the pair).  Every
    rank calls it: the samples' rows are gathered over the spatial group
    (a collective), and the primary alone logs."""
    if "imgs" in batch:
        first, last = batch["imgs"][:, 0], batch["imgs"][:, -1]
    else:
        first, last = batch["img1"], batch["img2"]
    first, last, label, preds = (spatial.gather_rows(t[::10]) for t in (
        first, last, batch["label"], stats["preds"]))
    if not distributed.is_primary():
        return
    imgs1, imgs2, labels, preds = (t.cpu().numpy() for t in (
        first, last, label, preds))
    for i in range(imgs1.shape[0]):
        tracker.log_figure(f"epoch_{epoch}_cd_sample_{10 * i}",
                           _denorm_rgb(imgs1[i]), _denorm_rgb(imgs2[i]),
                           labels[i], preds[i])


def _log_scene_figure(tracker, cfg, city: str, epoch: int,
                      mask: np.ndarray) -> None:
    """2x2 scene figure (pair previews, groundtruth, prediction); skipped
    when the previews are absent or unreadable."""
    pair = os.path.join(cfg.dataset_dir, "images", city, "pair")
    p1, p2 = (os.path.join(pair, f"img{i}.png") for i in (1, 2))
    if not (os.path.exists(p1) and os.path.exists(p2)):
        return
    lo = cfg.stretch_8bit.get("lower", 2)
    hi = cfg.stretch_8bit.get("higher", 98)
    try:
        img1, img2 = (stretch_8bit(read_png_gray(p).astype(np.float32), lo,
                                   hi) for p in (p1, p2))
        gt = load_label(cfg.dataset_dir, city) * 255
    except OSError as e:
        log.warning("scene figure skipped for %s: %s", city, e)
        return
    tracker.log_figure(f"{city}_epoch_{epoch}_figure", img1, img2, gt,
                       mask * 255)


class EpochBatches:
    """The train and validation batches of each epoch, on ``device``: from
    ``cfg.num_workers`` worker processes (``data/loader.py``), started at
    the first epoch that asks and kept for the run, or with 0 workers, or
    under ``compat_reference`` in one process, from the prefetch thread.
    On a mesh each rank's batches are its data slice's rows of the global
    batch, and of each patch its spatial slice's rows.

    Under ``compat_reference`` in one process the training batches draw
    their augmentation from one ``random.Random(cfg.seed)`` stream,
    fast-forwarded past ``start_epoch`` finished epochs, and the epoch's
    last batch is short when the samples do not fill it.  A multi-date model's batches
    carry all of the dataset's dates as ``imgs``."""

    def __init__(self, cfg, data: dict, train_md: list, val_md: list,
                 device, start_epoch: int = 0):
        self.cfg, self.train_md, self.val_md = cfg, train_md, val_md
        self.device = device
        self.multi_date = cfg.model in MULTI_DATE
        d, s, _ = distributed.coords()
        shape = distributed.mesh_shape()
        # (data index, data count, spatial index, spatial count)
        self.rank = (d, shape["data"], s, shape["spatial"])
        single = self.rank[1] == 1
        self.ragged = cfg.compat_reference and single
        self.compat_aug = None
        if cfg.compat_reference and cfg.augmentation and not single:
            log.warning("compat_reference augmentation stream is "
                        "single-process only; multi-process run keeps the "
                        "keyed per-row augmentation RNG")
        elif cfg.compat_reference and cfg.augmentation:
            self.compat_aug = random.Random(cfg.seed)
            replay_aug_draws(self.compat_aug, start_epoch * epoch_train_rows(
                len(train_md), cfg.batch_size, cfg.steps_per_epoch,
                ragged_tail=True))
        # the workers take the keyed augmentation and whole batches, which
        # compat_reference keeps only in a single process
        self.workers = 0 if self.ragged else cfg.num_workers
        if self.ragged and cfg.num_workers:
            log.info("compat_reference: batches from one thread, not %d "
                     "worker processes (the augmentation is one sequential "
                     "stream, the final batch ragged)", cfg.num_workers)
        self.data = share_dataset(data) if self.workers else data
        self._loaders: dict[str, BatchLoader] = {}

    def _loader(self, name: str, md: list, augment: bool, batch_size: int,
                shuffle: bool, pad_mode: str) -> BatchLoader:
        if name not in self._loaders:
            self._loaders[name] = BatchLoader(
                self.data, md, self.cfg.patch_size, augment, batch_size,
                shuffle=shuffle, pad_mode=pad_mode,
                num_workers=self.workers, device=self.device,
                prefetch=self.cfg.prefetch, multi_date=self.multi_date,
                **self._slices())
        return self._loaders[name]

    def _slices(self) -> dict:
        d, dn, s, sn = self.rank
        return dict(process_index=d, process_count=dn, spatial_index=s,
                    spatial_count=sn)

    def train(self, epoch: int, skip: int = 0):
        """Epoch ``epoch``'s shuffled, augmented, wrap-padded batches from
        batch ``skip``."""
        cfg = self.cfg
        if self.workers:
            return self._loader(
                "train", self.train_md, cfg.augmentation, cfg.batch_size,
                cfg.shuffle_train, "wrap").epoch(
                seed=cfg.seed + epoch, max_batches=cfg.steps_per_epoch,
                skip_batches=skip)
        sampler = PatchSampler(self.data, self.train_md, cfg.patch_size,
                               augment=cfg.augmentation,
                               compat_aug_stream=self.compat_aug,
                               multi_date=self.multi_date)
        return prefetch_to_device(
            batch_iterator(sampler, cfg.batch_size, shuffle=cfg.shuffle_train,
                           pad_mode="wrap", seed=cfg.seed + epoch,
                           max_batches=cfg.steps_per_epoch,
                           skip_batches=skip, ragged_tail=self.ragged,
                           **self._slices()),
            self.device, size=cfg.prefetch)

    def val(self):
        """The validation patches in order, mask-padded."""
        cfg = self.cfg
        if self.workers:
            return self._loader("val", self.val_md, False,
                                cfg.eval_batch_size, False, "mask").epoch(
                max_batches=cfg.steps_per_epoch)
        return prefetch_to_device(
            batch_iterator(PatchSampler(self.data, self.val_md,
                                        cfg.patch_size, augment=False,
                                        multi_date=self.multi_date),
                           cfg.eval_batch_size, shuffle=False,
                           pad_mode="mask", max_batches=cfg.steps_per_epoch,
                           **self._slices()),
            self.device, size=cfg.prefetch)

    def close(self) -> None:
        """Stop the worker processes."""
        for loader in self._loaders.values():
            loader.close()


def train(cfg, dataset: dict | None = None, tracker=None,
          run_scene_inference: bool = True,
          metadata: tuple[list, list] | None = None,
          preemption_guard: PreemptionGuard | None = None, device=None):
    """Run the training loop on ``device`` (None means the card: in a
    process group, the rank's own) from fresh weights drawn from
    ``cfg.seed`` or from ``cfg.resume``; returns (state, history).

    ``dataset`` is an in-memory dataset dict (else ``cfg.dataset_dir`` is
    loaded, fetched by rank 0 if need be); ``metadata`` the (train, val)
    patch lists; ``preemption_guard`` a pre-built guard (else one is
    installed on SIGTERM when ``cfg.handle_preemption``)."""
    set_mesh(cfg)
    device = indexed_device(resolve_device(device))
    if dataset is None:
        cfg.dataset_dir = ensure_dataset(cfg)
    owned_tracker = tracker is None
    if owned_tracker:
        tracker = (Tracker(cfg.log_dir, project=cfg.project_name)
                   if distributed.is_primary() else NullTracker())
    try:
        return _train(cfg, dataset, tracker, run_scene_inference, metadata,
                      preemption_guard, device)
    finally:
        if owned_tracker:
            tracker.close()


def _train(cfg, dataset, tracker, run_scene_inference, metadata,
           preemption_guard, device):
    params = cfg.to_dict()
    if dataset is None:  # an in-memory dataset has no identity on disk
        params["dataset_provenance"] = dataset_provenance(cfg,
                                                          cfg.dataset_dir)
    tracker.log_params(params)

    log.info("loading dataset from %s", cfg.dataset_dir)
    data = dataset if dataset is not None else full_load(
        cfg.dataset_dir, cfg, max_workers=cfg.num_workers or None)
    if metadata is not None:
        train_md, val_md = metadata
    elif dataset is not None:
        train_md, val_md = metadata_from_dataset(
            dataset, cfg.validation_cities, cfg.patch_size, cfg.stride)
    else:
        train_md, val_md = get_train_val_metadata(
            cfg.dataset_dir, cfg.validation_cities, cfg.patch_size,
            cfg.stride)
    log.info("train samples: %d  val samples: %d", len(train_md), len(val_md))

    model = build_model(cfg, device,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        fold_bn=False, train=True)
    loss_fn = get_loss_fn(cfg)
    state = create_state(cfg, model)
    state, resumed_epoch, resumed_meta = ckpt.resume_if_requested(cfg, state)
    if resumed_epoch >= 0:
        log.info("resumed from epoch %d (step %d)", resumed_epoch, state.step)
    distributed.broadcast_module(model)  # every rank starts from rank 0's

    best = {"cd_f1scores": -1.0, "cd_recalls": -1.0, "cd_precisions": -1.0}
    # seed the best metrics from the resumed save, so a regression after
    # the resume is not checkpointed as a new best
    for source in ("validation_metrics", "best_metrics"):
        for k, v in (resumed_meta.get(source) or {}).items():
            if k in best:
                best[k] = float(v)
    history = {"train": [], "val": []}
    start_epoch, resume_skip, resume_rows = resumed_epoch + 1, 0, []
    if resumed_meta.get("periodic") and resumed_meta.get("batches_done"):
        # mid-epoch resume: finish the saved epoch from its next batch and
        # replay its stat rows so far
        start_epoch = resumed_epoch
        resume_skip = int(resumed_meta["batches_done"])
        resume_rows = [[float(v) for v in row]
                       for row in resumed_meta.get("train_rows") or []]
        log.info("mid-epoch resume: completing epoch %d from batch %d",
                 start_epoch, resume_skip)

    store = open_store(cfg.output_store) if distributed.is_primary() \
        else None
    if store is not None:
        log.info("mirroring checkpoints and tracker output to %s",
                 cfg.output_store)
    guard, owned_guard = preemption_guard, False
    if guard is None and cfg.handle_preemption:
        guard = PreemptionGuard()
        owned_guard = guard.install()
    batches = EpochBatches(cfg, data, train_md, val_md, device, start_epoch)
    del data  # with workers, the shared copy is the one kept
    profiler = None
    if cfg.profile_dir and distributed.is_primary():
        profiler = _ProfileCapture(cfg.profile_dir, cfg.profile_steps,
                                   device.type == "cuda")
    try:
        _run_epochs(cfg, state, batches, tracker, device,
                    make_train_step(model, loss_fn),
                    make_eval_step(model, loss_fn), best, history,
                    start_epoch, resume_skip, resume_rows, guard,
                    run_scene_inference, store, profiler)
    except TrainingPreempted:
        tracker.set_status("preempted")
        history["status"] = "preempted"
        log.warning("training preempted: resume with resume=%s to complete "
                    "the run exactly", cfg.weight_dir)
        _store_epilogue(store, tracker)
        return state, history
    finally:
        if profiler is not None:  # a run that ended before its last step
            profiler.stop()
        batches.close()
        if owned_guard:
            guard.uninstall()
    tracker.set_status("complete")
    history["status"] = "complete"
    _store_epilogue(store, tracker)
    return state, history


def _store_epilogue(store, tracker) -> None:
    """Mirror the tracker directory and wait for the queued uploads
    (bounded, so a wedged store cannot hang the exit)."""
    if store is None:
        return
    tdir = getattr(tracker, "dir", None)  # a NullTracker writes nothing
    if tdir and os.path.isdir(tdir):
        store.upload_dir(tdir, rel=os.path.join(
            "tracker", os.path.basename(os.path.normpath(tdir))))
    failed = store.flush()
    if failed:
        log.warning("%d artifact uploads failed this run (local copies "
                    "are intact)", failed)


def _save(cfg, state, epoch, store, **kw) -> None:
    """ckpt.save into cfg.weight_dir, mirrored to ``store``; rank 0's
    alone."""
    if not distributed.is_primary():
        return
    path = ckpt.save(state, cfg.weight_dir, epoch, keep_last=cfg.keep_last,
                     **kw)
    if store is not None:
        store.upload_checkpoint(cfg.weight_dir, path)


def _periodic_saver(cfg, tracker, guard, best, epoch, rows, store):
    """The per-step callback that writes periodic (and preemption) saves
    carrying the epoch's progress and stat rows."""
    def on_step(s, stats):
        rows.append(stats)
        preempt = guard is not None and distributed.any_rank(guard.requested)
        if not (preempt or (cfg.checkpoint_every > 0
                            and s.step % cfg.checkpoint_every == 0)):
            return
        rows[:] = [r if isinstance(r, list) else
                   [float(r[k]) for k in _STAT_KEYS] for r in rows]
        _check_finite(np.asarray([r[0] for r in rows]), tracker,
                      f"of epoch {epoch}; caught at the periodic-checkpoint "
                      "sync, the last finite periodic checkpoint is kept")
        _save(cfg, s, epoch, store, tag="periodic",
              metadata={"periodic": True, "batches_done": len(rows),
                        "train_rows": rows, "best_metrics": dict(best)})
        if preempt:
            raise TrainingPreempted(s)
    return on_step


def _run_epochs(cfg, state, batches, tracker, device, train_step,
                eval_step, best, history, start_epoch, resume_skip,
                resume_rows, guard, run_scene_inference, store,
                profiler=None):
    primary = distributed.is_primary()
    for epoch in range(start_epoch, cfg.epochs):
        if guard is not None and distributed.any_rank(guard.requested):
            # the request landed between epochs: save the epoch boundary
            # as a zero-progress periodic save of the previous epoch (not
            # while a mid-epoch resume is pending: the checkpoint it came
            # from is the right resume point)
            if epoch > 0 and not resume_skip:
                _save(cfg, state, epoch - 1, store, tag="periodic",
                      metadata={"periodic": True, "batches_done": 0,
                                "best_metrics": dict(best)})
            raise TrainingPreempted(state)
        t0 = time.time()
        train_acc, val_acc = MetricAccumulator(), MetricAccumulator()
        skip, replay = resume_skip, resume_rows
        resume_skip, resume_rows = 0, []
        for row in replay:
            train_acc.update(row[0], dict(zip(_COUNT_KEYS, row[1:])))

        callbacks = []
        if cfg.checkpoint_every > 0 or guard is not None:
            callbacks.append(_periodic_saver(cfg, tracker, guard, best,
                                             epoch, list(replay), store))
        if profiler is not None:
            callbacks.append(profiler.on_step)

        def on_step(s, stats):
            for callback in callbacks:
                callback(s, stats)
        waited = profiling.counters().get("loader.wait_s", 0.0)
        steps = _epoch(train_step, state, batches.train(epoch, skip),
                       train_acc, train=True,
                       on_step=on_step if callbacks else None,
                       tracker=tracker, log_every=cfg.log_every,
                       prefix="batch_train_")
        waited = profiling.counters().get("loader.wait_s", 0.0) - waited
        if profiler is not None:  # stops even on a short first epoch
            profiler.stop(state)
            profiler = None
        train_seconds = time.time() - t0
        mean_train = train_acc.means()
        if steps:
            # the epoch's wall clock ends with the stats' host transfer,
            # a sync
            perf = {"examples_per_sec": steps * cfg.batch_size
                    / train_seconds, "seconds": train_seconds,
                    "steps": steps, "feed_wait_s": waited}
            tracker.log_metrics(perf, step=epoch, prefix="train_")
        tracker.log_metrics(mean_train, step=epoch, prefix="train_")
        log.info("epoch %d train %s", epoch,
                 {k: round(v, 4) for k, v in mean_train.items()})

        _epoch(eval_step, state, batches.val(), val_acc, train=False,
               on_first_batch=lambda b, s: _log_val_patches(tracker, epoch,
                                                            b, s),
               tracker=tracker, log_every=cfg.log_every,
               prefix="batch_validate_")
        mean_val = val_acc.means()
        mean_val.update(val_acc.global_prf1())
        tracker.log_metrics(mean_val, step=epoch, prefix="validate_")
        log.info("epoch %d val %s", epoch,
                 {k: round(v, 4) for k, v in mean_val.items()
                  if k.startswith("cd_")})

        # rank 0's alone: it only writes, and runs no collective
        if run_scene_inference and primary:
            for city in cfg.validation_cities:
                try:
                    mask = infer_city(state.model, cfg, city, device=device)
                    label = load_label(cfg.dataset_dir, city)
                except OSError as e:  # scene files missing or unreadable
                    log.warning("scene inference skipped for %s: %s", city, e)
                    continue
                tracker.log_image(f"{city}_epoch_{epoch}", mask * 255)
                _log_scene_figure(tracker, cfg, city, epoch, mask)
                if label.shape == mask.shape:
                    p, r, f1 = prf1_from_counts({
                        "tp": int(np.sum((mask == 1) & (label == 1))),
                        "fp": int(np.sum((mask == 1) & (label == 0))),
                        "fn": int(np.sum((mask == 0) & (label == 1)))})
                    tracker.log_metrics({f"{city}_scene_precision": p,
                                         f"{city}_scene_recall": r,
                                         f"{city}_scene_f1": f1}, step=epoch)
                    mean_val[f"{city}_scene_f1"] = f1

        if improved(mean_val, best):
            meta = dict(cfg.to_dict())
            meta["validation_metrics"] = mean_val
            _save(cfg, state, epoch, store, metadata=meta)
            best.update({k: mean_val[k] for k in best})
            log.info("epoch %d: new best, checkpointed", epoch)

        history["train"].append(mean_train)
        history["val"].append(mean_val)
        tracker.log_metrics({"epoch": epoch,
                             "epoch_seconds": time.time() - t0}, step=epoch)
        tracker.set_status("running")
