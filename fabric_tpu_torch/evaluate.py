"""Standalone evaluation of a checkpoint: patch-level validation metrics
and whole-scene F1 (counterpart of ``fabric_tpu/evaluate.py``).

    python -m fabric_tpu_torch.cli.evaluate --config metadata.json \
        --resume <dir>

It runs what the training loop's validation runs, on the same model
(``cfg.model``: BiDateNet, or UNetLSTM / UNet3D over ``cfg.num_dates``
dates; eval BatchNorm, unfolded, the ``bn_relu_inference`` kernel on the
card):
the mask-padded fixed-shape eval batches through the loop's own
``_epoch``, the reference's mean of per-batch figures beside the global
confusion-matrix ones, and each city's scene through
``infer/runner.infer_city``.  So its numbers are the ones the loop
reported for the same weights.  In a process group the config's (data,
spatial, model) mesh is laid over the ranks, as the loop lays it: each
rank evaluates its data slice's rows of every global batch, on a spatial
axis its rows of each patch (``parallel/spatial.py``), and the confusion
counts and the loss are summed over the ranks of a model replica (an
``eval_batch_size`` that does not divide over the data axis raises, as
``fabric_tpu``'s multi-process pipeline does); the scenes are evaluated
on every rank, as ``fabric_tpu`` replicates them per process, so every
rank returns the same result.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger("fabric_tpu_torch")


def evaluate(cfg, dataset: dict | None = None,
             cities: list[str] | None = None,
             run_scene_inference: bool = True, state=None, device=None):
    """Evaluate a checkpoint (``cfg.resume``) on validation patches and
    scenes, on ``device`` (None means the card).

    ``dataset`` is an in-memory ``{city: {images, labels}}`` dict (else
    ``cfg.dataset_dir`` is loaded, fetched from ``cfg.dataset_name`` if
    need be); ``cities`` overrides ``cfg.validation_cities``; ``state``
    supplies restored weights (no checkpoint is read).  Returns::

        {"patch": {cd_losses, cd_corrects, cd_precisions, cd_recalls,
                   cd_f1scores, global_precision, global_recall, global_f1,
                   global_accuracy, num_batches, num_samples},
         "scenes": {city: {precision, recall, f1, change_pct}}}

    Scenes are evaluated only for an on-disk dataset."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.data.download import ensure_dataset
    from fabric_tpu_torch.data.oscd import (full_load,
                                            get_train_val_metadata,
                                            load_label,
                                            metadata_from_dataset)
    from fabric_tpu_torch.infer.runner import infer_city
    from fabric_tpu_torch.infer.service import resolve_device
    from fabric_tpu_torch.losses import get_loss_fn
    from fabric_tpu_torch.metrics import MetricAccumulator, prf1_from_counts
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.parallel.mesh import indexed_device
    from fabric_tpu_torch.train.loop import EpochBatches, _epoch, set_mesh
    from fabric_tpu_torch.train.state import create_state
    from fabric_tpu_torch.train.steps import make_eval_step

    set_mesh(cfg)
    device = indexed_device(resolve_device(device))
    cities = list(cities or cfg.validation_cities)
    if dataset is None:
        cfg.dataset_dir = ensure_dataset(cfg)
    if state is None:
        model = build_model(cfg, device,
                            generator=torch.Generator().manual_seed(cfg.seed),
                            fold_bn=False, train=True)
        state = create_state(cfg, model)
        state, epoch, _ = ckpt.resume_if_requested(cfg, state)
        if epoch >= 0:
            log.info("evaluating checkpoint from epoch %d (step %d)", epoch,
                     state.step)

    data = dataset if dataset is not None else full_load(
        cfg.dataset_dir, cfg, max_workers=cfg.num_workers or None)
    if dataset is not None:
        _, val_md = metadata_from_dataset(data, cities, cfg.patch_size,
                                          cfg.stride)
    else:
        _, val_md = get_train_val_metadata(cfg.dataset_dir, cities,
                                           cfg.patch_size, cfg.stride)
    log.info("val samples: %d over %s", len(val_md), cities)

    batches = EpochBatches(cfg, data, [], val_md, device)
    del data
    acc = MetricAccumulator()
    try:
        _epoch(make_eval_step(state.model, get_loss_fn(cfg)), state,
               batches.val(), acc, train=False)
    finally:
        batches.close()
    patch = acc.means()
    patch.update(acc.global_prf1())
    patch["num_batches"] = len(acc)
    patch["num_samples"] = len(val_md)

    scenes: dict[str, dict[str, float]] = {}
    if run_scene_inference and dataset is None:
        for city in cities:
            mask = infer_city(state.model, cfg, city, device=device)
            label = load_label(cfg.dataset_dir, city)
            row = {"change_pct": 100.0 * float(mask.mean())}
            if label.shape == mask.shape:
                p, r, f1 = prf1_from_counts({
                    "tp": int(np.sum((mask == 1) & (label == 1))),
                    "fp": int(np.sum((mask == 1) & (label == 0))),
                    "fn": int(np.sum((mask == 0) & (label == 1)))})
                row.update({"precision": p, "recall": r, "f1": f1})
            scenes[city] = row
    return {"patch": patch, "scenes": scenes}
