"""ScenePredictor: whole-scene bi-date change-map serving (counterpart of
``fabric_tpu/infer/service.py``, grid mode, exact or int8).

Loads a checkpoint once (or initialises weights from a seed), folds
BatchNorm on the host, and serves scene pairs of any size: each scene is
edge-padded up to the next multiple of ``bucket``, run through the grid
tiler of ``infer/device_tiling.py`` on the device, and the mask is cropped
back.  One runner is built per bucket and reused.  The folded forward runs
on the port's hand-written kernels; with ``fold_bn=False`` the eval-BN
forward runs, on the eval-BatchNorm kernel; with ``quant="int8"`` the
post-training-quantized forward of ``infer/quant.py`` runs, on the int8
conv kernel, calibrated on the first scene and probed for clipping on
every later one.

Serving modes of ``fabric_tpu`` that this port does not have yet raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import logging
import time
from collections import deque

import numpy as np
import torch

from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.infer import quant as q
from fabric_tpu_torch.infer.device_tiling import make_scene_infer
from fabric_tpu_torch.models import build_model, compute_dtype

log = logging.getLogger("fabric_tpu_torch")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device) -> torch.device:
    """``device``, or the card when None; raises when CUDA is asked for and
    missing (there is no silent move to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to fabric_tpu_torch "
                               f"yet: ROADMAP.md queue 1 item {item}")


class ScenePredictor:
    """Checkpoint-backed whole-scene change-map server.

    Args:
      cfg: Config (model, patch, eval batch, dtype, overlap).
      checkpoint: a ``fabric_tpu`` checkpoint file, or a directory (its
        best-metric save, else the latest); None draws fresh weights from
        a generator seeded 0 (benchmarks, smoke runs).
      bucket: scene dims are edge-padded up to multiples of this (0 =
        exact shapes, one runner per distinct shape).
      fold_bn: fold BatchNorm into the conv weights (the conv kernels);
        False keeps eval BatchNorm: ``F.conv2d`` convs with the
        ``bn_relu_inference`` kernel as their epilogue.
      device: where the model runs; None means the card.
      quant: None / "none" serves exactly; "int8" serves the int8 forward
        (needs ``fold_bn``), calibrated with :meth:`calibrate` or, failing
        that, on the first scene.
      recalibrate_every: int8: re-derive the scales from every Nth scene
        (0 = calibrate once).  A recalibration rebuilds the int8 forward
        and drops the runners, so every later scene serves the new scales.
      clip_warn_ratio: int8: before each scene that does not calibrate,
        probe its activation ranges on the corner and centre crops against
        the scales and warn when a site's absmax exceeds this multiple of
        its covered range (``last_clip_report``); 0 turns the probe off.
      tracker: a ``fabric_tpu_torch.track.Tracker``: every served scene
        writes a ``serve_``-prefixed record (dims, bucket, new runner or
        cached, wall ms, Mpx/s, mode, quant and, for int8, the worst clip
        site and ratio).
      mesh, shard_scene, overlap_band_rows, fullconv_band_rows,
      fullconv_stream, aot_dir, bundle: ``fabric_tpu`` serving modes that
        are not ported yet; anything but their default raises.
    """

    def __init__(self, cfg, checkpoint: str | None = None, bucket: int = 512,
                 fold_bn: bool = True, device=None, *, quant=None, mesh=None,
                 shard_scene: bool = False, recalibrate_every: int = 0,
                 clip_warn_ratio: float = 1.0, overlap_band_rows: int = 0,
                 fullconv_band_rows: int = 0, fullconv_stream: bool = False,
                 aot_dir=None, bundle=None, tracker=None):
        if quant not in (None, "none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        if mesh is not None or shard_scene:
            raise _not_ported("mesh / shard_scene serving", "10 (multi-GPU)")
        if overlap_band_rows:
            raise _not_ported("overlap_band_rows", "6 (other tiled modes)")
        if fullconv_band_rows or fullconv_stream:
            raise _not_ported("fullconv serving", "9 (seamless fullconv)")
        if aot_dir is not None or bundle is not None:
            raise _not_ported("aot_dir / bundle serving",
                              "11 (frozen artifacts and bundles)")
        if cfg.model != "bidate":
            raise _not_ported(f"model {cfg.model!r}", "8 (multi-date models)")
        self.quant = quant or "none"
        if self.quant == "int8" and not fold_bn:
            raise ValueError("quant='int8' requires fold_bn=True (the "
                             "quantized forward runs on BN-folded weights)")
        self.cfg = cfg
        self.bucket = bucket
        self.tracker = tracker
        self.recalibrate_every = recalibrate_every
        self.clip_warn_ratio = clip_warn_ratio
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        if (self.device.type == "cuda" and fold_bn
                and self.dtype != torch.bfloat16):
            raise NotImplementedError("the conv kernels compute in bfloat16; "
                                      "serve folded with cfg.dtype="
                                      "'bfloat16'")
        variables = None
        if checkpoint:
            variables = ckpt.load_variables(ckpt.resolve(checkpoint))
        self.model = build_model(cfg, self.device, fold_bn=fold_bn,
                                 variables=variables)
        # what the runners call: the model, or the int8 forward once the
        # scales exist
        self._forward = self.model
        self._runners: dict[tuple[int, int], object] = {}
        self._scales: dict | None = None
        self._stats_fwd = None
        self._scenes_predicted = 0
        self.last_clip_report: dict | None = None

    # --- int8: calibration and the per-scene clip probe ---

    def _stats_forward(self):
        if self._stats_fwd is None:
            self._stats_fwd = q.make_stats_forward(
                q.folded_params(self.model), self.dtype)
        return self._stats_fwd

    def calibrate(self, batches) -> None:
        """Calibrate the int8 activation scales on (d1, d2) NHWC batch
        pairs (e.g. patches cropped from held-out scenes) and serve the
        int8 forward with them from now on (the runners are rebuilt)."""
        folded = q.folded_params(self.model)
        scales = q.calibrate(folded, batches, self.dtype,
                             stats_forward=self._stats_forward())
        self._forward = q.make_int8_apply(folded, scales, self.dtype)
        self._scales = dict(scales)
        self._runners.clear()
        # a scene served right after a calibration ran no probe: the last
        # report (against the old scales) is not its own
        self.last_clip_report = None

    def _calibration_crops(self, d1, d2) -> tuple[np.ndarray, np.ndarray]:
        """Corner and centre patch crops of a scene pair, edge-padded up to
        a full patch if the scene is smaller (int8 calibration and the
        per-scene clip probe)."""
        p = self.cfg.patch_size
        h0, w0 = d1.shape[:2]
        e1, e2 = d1, d2
        if h0 < p or w0 < p:  # (np.pad copies the whole scene even if not)
            pads = [(0, max(p - h0, 0)), (0, max(p - w0, 0)), (0, 0)]
            e1, e2 = (np.pad(x, pads, mode="edge") for x in (d1, d2))
        crops1, crops2 = [], []
        for (y, x) in self._crop_anchors(h0, w0):
            crops1.append(e1[y:y + p, x:x + p])
            crops2.append(e2[y:y + p, x:x + p])
        return (np.stack(crops1).astype(np.float32),
                np.stack(crops2).astype(np.float32))

    def _crop_anchors(self, h0: int, w0: int) -> set:
        p = self.cfg.patch_size
        return {(0, 0),
                (max(h0 - p, 0), max(w0 - p, 0)),
                (max((h0 - p) // 2, 0), max((w0 - p) // 2, 0))}

    def _int8_scene_prologue(self, crops):
        """First-scene or cadence-due calibration (synchronous: it rebuilds
        the int8 forward), otherwise dispatch the clip probe on ``crops``
        without waiting for it.  Returns the pending probe for
        :meth:`_int8_probe_check`, or None when this scene calibrated or
        probing is off."""
        due = (self._scales is None
               or (self.recalibrate_every > 0
                   and self._scenes_predicted > 0
                   and self._scenes_predicted % self.recalibrate_every
                   == 0))
        if due:
            self.calibrate([crops])
            log.info("int8 calibration on scene %d (%d crops)",
                     self._scenes_predicted, crops[0].shape[0])
            return None
        if not self.clip_warn_ratio:
            return None
        args = [torch.from_numpy(c) for c in crops]
        if self.device.type == "cuda":
            args = [t.pin_memory() for t in args]
        _, stats = self._stats_forward()(
            *(t.to(self.device, non_blocking=True) for t in args))
        names, vals = q.stack_stats(stats)
        if self.device.type != "cuda":
            return names, vals, None
        # copy the absmaxes out now, ahead of the scene's own launches, so
        # the check waits on the probe alone
        host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return names, host, done

    def _int8_probe_check(self, probe, scene_idx: int) -> dict | None:
        """Complete a pending clip probe: the overflow report {site:
        absmax / (127 * scale)}, kept in ``last_clip_report``, with a
        warning past ``clip_warn_ratio``."""
        if probe is None:
            return None
        names, vals, done = probe
        if done is not None:
            done.synchronize()
        report = {k: v / (127.0 * self._scales[k])
                  for k, v in zip(names, vals.tolist()) if k in self._scales}
        self.last_clip_report = report
        site = max(report, key=report.get)
        if report[site] > self.clip_warn_ratio:
            log.warning(
                "int8 activation clipping on scene %d: site %s absmax is "
                "%.2fx the calibrated range (worst of %d sites); predictions "
                "may degrade there: recalibrate (ScenePredictor.calibrate / "
                "recalibrate_every) or raise the calibration headroom",
                scene_idx, site, report[site], len(report))
        return report

    # --- serving ---

    _CLIP_UNSET = object()  # the caller did not track this scene's probe

    def _record_scene(self, scene_id, dims, runner_key, new_runner, wall_s,
                      pipelined: bool = False,
                      clip_report=_CLIP_UNSET) -> None:
        """Stream one served scene's ``serve_*`` record through the tracker
        (nothing without one)."""
        if self.tracker is None:
            return
        h, w = dims
        rec = {
            "scene": scene_id,
            "height": h, "width": w,
            "bucket_h": runner_key[0], "bucket_w": runner_key[1],
            "compiled": bool(new_runner),
            "wall_ms": round(wall_s * 1000.0, 2),
            "mpx_per_sec": round(h * w / wall_s / 1e6, 3),
            "mode": "grid",
            "quant": self.quant,
            "aot": False,
        }
        if pipelined:
            # predict_many keeps several scenes in flight: this scene's
            # wall clock overlaps its neighbours' compute
            rec["pipelined"] = True
        if self.quant == "int8":
            # a scene that (re)calibrated ran no probe and carries no clip
            # fields; predict passes nothing and uses the probe just run
            report = (self.last_clip_report
                      if clip_report is ScenePredictor._CLIP_UNSET
                      else clip_report)
            if report:
                site = max(report, key=report.get)
                rec["clip_worst_site"] = site
                rec["clip_worst_ratio"] = round(report[site], 3)
        self.tracker.log_metrics(rec, step=self._scenes_predicted,
                                 prefix="serve_")

    def _bucket_dims(self, h: int, w: int) -> tuple[int, int]:
        """Padded (H, W) for this scene under the bucket policy."""
        patch = self.cfg.patch_size
        if self.bucket:
            return (max(_round_up(h, self.bucket), patch),
                    max(_round_up(w, self.bucket), patch))
        return max(h, patch), max(w, patch)

    def _get_runner(self, h: int, w: int):
        key = (h, w)
        if key not in self._runners:
            self._runners[key] = make_scene_infer(
                self._forward, self.cfg.patch_size, key,
                batch_size=self.cfg.eval_batch_size,
                overlap=self.cfg.infer_overlap, dtype=self.dtype)
        return self._runners[key]

    def _dispatch(self, d1: np.ndarray, d2: np.ndarray):
        """Pad, upload and start one scene without waiting for it: returns
        ``(mask, h, w, host_buffers)`` with ``mask`` the (bucket-sized)
        device tensor, possibly still being computed."""
        h, w = d1.shape[:2]
        ph, pw = self._bucket_dims(h, w)
        if (ph, pw) != (h, w):
            pads = [(0, ph - h), (0, pw - w), (0, 0)]
            d1 = np.pad(d1, pads, mode="edge")
            d2 = np.pad(d2, pads, mode="edge")
        run = self._get_runner(ph, pw)
        hosts = [torch.from_numpy(np.ascontiguousarray(d)) for d in (d1, d2)]
        if self.device.type == "cuda":
            # page-locked copies, so the uploads below are asynchronous
            hosts = [t.pin_memory() for t in hosts]
        a1, a2 = (t.to(self.device, non_blocking=True) for t in hosts)
        return run(a1, a2), h, w, hosts

    def predict(self, d1: np.ndarray, d2: np.ndarray,
                scene_id: str | None = None) -> np.ndarray:
        """(H, W, C) scene pair -> (H, W) uint8 change mask."""
        t0 = time.perf_counter()
        if self.quant == "int8":
            probe = self._int8_scene_prologue(self._calibration_crops(d1, d2))
            self._int8_probe_check(probe, self._scenes_predicted)
        self._scenes_predicted += 1
        key = self._bucket_dims(*d1.shape[:2])
        new_runner = key not in self._runners
        mask, h, w, _ = self._dispatch(d1, d2)
        out = mask.cpu().numpy()[:h, :w]
        self._record_scene(scene_id, (h, w), key, new_runner,
                           time.perf_counter() - t0)
        return out

    def predict_many(self, pairs, window: int = 2, scene_ids=None,
                     pack: int = 0) -> list[np.ndarray]:
        """Serve a sequence of ``(d1, d2)`` pairs with up to ``window``
        scenes in flight: scene n+1's padding, upload and launches are
        queued while the card computes scene n, and only the read-back of
        the oldest scene waits.  Equal to ``[predict(*p) for p in pairs]``.
        int8 scenes pipeline too: the clip probe is dispatched ahead of the
        scene and checked right after the scene's own dispatch (before the
        next scene's), so it waits on the probe's few crops alone; only a
        calibration synchronises.  ``scene_ids`` label the tracker
        records; ``pack`` (fleet packing) is not ported yet."""
        if pack:
            raise _not_ported("predict_many(pack=...)",
                              "6 (fleet packing)")
        results: list[np.ndarray] = []
        pending: deque = deque()

        def drain():
            mask, h, w, _, key, new_runner, sid, t0, report = \
                pending.popleft()
            results.append(mask.cpu().numpy()[:h, :w])
            self._record_scene(sid, (h, w), key, new_runner,
                               time.perf_counter() - t0, pipelined=True,
                               clip_report=report)

        for i, (d1, d2) in enumerate(pairs):
            sid = scene_ids[i] if scene_ids else None
            t0 = time.perf_counter()
            probe = None
            if self.quant == "int8":
                probe = self._int8_scene_prologue(
                    self._calibration_crops(d1, d2))
            idx = self._scenes_predicted
            self._scenes_predicted += 1
            key = self._bucket_dims(*d1.shape[:2])
            new_runner = key not in self._runners
            dispatched = self._dispatch(d1, d2)
            report = self._int8_probe_check(probe, idx)
            pending.append((*dispatched, key, new_runner, sid, t0, report))
            while len(pending) > max(window, 1):
                drain()
        while pending:
            drain()
        return results

    def predict_city(self, city: str) -> np.ndarray:
        """The mask of a dataset city (``cfg.dataset_dir``), at the dims of
        its bands as the reference takes them."""
        from fabric_tpu_torch.data.oscd import load_city
        from fabric_tpu_torch.infer.runner import scene_dims
        dims = scene_dims(self.cfg.dataset_dir, city)
        stacked = load_city(self.cfg.dataset_dir, city, self.cfg,
                            out_shape=dims)
        return self.predict(stacked[0], stacked[1], scene_id=city)
