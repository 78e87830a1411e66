"""ScenePredictor: whole-scene change-map serving (counterpart of
``fabric_tpu/infer/service.py``: the tiled modes and seamless fullconv,
exact or int8, for the bi-date model and the multi-date ones).

Loads a checkpoint once (or initialises weights from a seed) and folds
BatchNorm on the host, or loads a serving bundle's folded weights
(``tools/export.py``), and serves scenes of any size: each scene is
edge-padded up to the next multiple of ``bucket``, run through a tiler of
``infer/device_tiling.py`` on the device, and the mask is cropped back.
One runner is built per bucket and reused.  The tiled modes are grid
(``cfg.infer_overlap`` 0), overlap (overlap-averaged probabilities) and
banded overlap (``overlap_band_rows``: the same in bands of tile rows, for
bounded memory); in grid mode ``predict_many(pack=...)`` packs several
same-bucket scenes into one chunked forward.  ``fullconv_band_rows``
replaces tiling: the network runs over halo-extended bands of the scene
(``infer/fullconv.py``), in device memory or, with ``fullconv_stream``,
streamed band by band from host arrays.  With a ``mesh``
(``parallel/mesh.py``) each tile batch is split over the devices of its
data axis, the model replicated over its ``spatial`` and ``model`` axes
(as ``fabric_tpu``'s tile shardings name "data" alone), and with
``shard_scene`` the scene itself is split into H-bands over them,
grid (``infer/sharded_scene.py``) or fullconv
(``fullconv.make_sharded_fullconv_infer``).  The folded forward runs on
the port's hand-written kernels; with ``fold_bn=False`` the eval-BN
forward runs, on the eval-BatchNorm kernel; with ``quant="int8"`` the
post-training-quantized forward of ``infer/quant.py`` runs, on the int8
kernels, calibrated on the first scene and probed for clipping on every
later one.  A multi-date model (``cfg.model`` "unet_lstm" or "unet3d")
serves (T, H, W, C) date stacks through :meth:`predict_multidate` and
:meth:`predict_many_multidate`.

With ``aot_dir`` a covered bucket's runner calls the forward frozen in an
ahead-of-time artifact (``infer/aot.py``: ``torch.export`` programs that
call the kernels as custom ops), checked at start against this
predictor's configuration and weights; a bucket the artifact lacks falls
back to the in-process forward, on the same kernels.

While a ``torch.profiler`` traces the process, each scene's (or pack's)
dispatch is a ``serve.dispatch`` span (``utils/profiling.span``, the
scene's index as its id) over its ``serve.pad``, ``serve.stage`` (the copy
into the page-locked buffer, with its ``bytes``), ``serve.upload`` and
``serve.launch`` (the runner's enqueue of the forward) spans.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque

import numpy as np
import torch

from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch import weights
from fabric_tpu_torch.infer import aot
from fabric_tpu_torch.infer import fullconv
from fabric_tpu_torch.infer import quant as q
from fabric_tpu_torch.infer.device_tiling import (make_banded_overlap_infer,
                                                  make_packed_scene_infer,
                                                  make_scene_infer,
                                                  make_scene_infer_multidate)
from fabric_tpu_torch.infer.sharded_scene import (make_sharded_scene_infer,
                                                  put_scene_sharded,
                                                  replicas)
from fabric_tpu_torch.models import MULTI_DATE, build_model, compute_dtype
from fabric_tpu_torch.utils import profiling

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


class ScenePredictor:
    """Checkpoint-backed whole-scene change-map server.

    Args:
      cfg: Config (model, patch, eval batch, dtype, overlap, num_dates).
      checkpoint: a ``fabric_tpu`` checkpoint file, or a directory (its
        best-metric save, else the latest); None (and no ``bundle``) draws
        fresh weights from a generator seeded 0 (benchmarks, smoke runs).
      bucket: scene dims are edge-padded up to multiples of this (0 =
        exact shapes, one runner per distinct shape).
      fold_bn: fold BatchNorm into the conv weights (the conv kernels);
        False keeps eval BatchNorm: ``F.conv2d`` convs with the
        ``bn_relu_inference`` kernel as their epilogue.
      device: where the model runs; None means the card.
      quant: "none" serves exactly; "int8" serves the int8 forward (needs
        ``fold_bn``), calibrated with :meth:`calibrate` or, failing that,
        on the first scene; None follows a bundle's mode (exact without
        one).
      recalibrate_every: int8: re-derive the scales from every Nth scene
        (0 = calibrate once).  A recalibration rebuilds the int8 forward
        and drops the runners, so every later scene serves the new scales.
      clip_warn_ratio: int8: before each scene that does not calibrate,
        probe its activation ranges on the corner and centre crops against
        the scales and warn when a site's absmax exceeds this multiple of
        its covered range (``last_clip_report``); 0 turns the probe off.
      overlap_band_rows: overlap mode (``cfg.infer_overlap`` > 0), bi-date:
        accumulate the probabilities in bands of this many tile rows, so
        that one band's tiles are live at a time instead of the scene's
        (``make_banded_overlap_infer``); the masks are the unbanded ones.
        0 = unbanded.
      fullconv_band_rows: seamless fullconv serving instead of tiling: the
        network runs over halo-extended bands of this many pixel rows (a
        multiple of 16), every pixel predicted once with its full
        receptive field and no seams (``infer/fullconv.py``; the halo
        covers the model's receptive field, ``fullconv.halo_for``).  The
        model is built with the shift-invariant local upsample (masks differ
        slightly from the tiled modes unless the checkpoint was trained
        with ``cfg.local_upsample``).  Needs ``fold_bn``, no overlap and no
        ``overlap_band_rows``; exact and int8, bi-date and multi-date.
        0 = off.
      fullconv_stream: with ``fullconv_band_rows``: stream each band from
        the host arrays (ndarray or ``np.memmap``) instead of placing the
        scene on the card, whose footprint is then one band whatever the
        scene's size; the mask is the in-device-memory runner's on the
        bucket-padded scene.
      tracker: a ``fabric_tpu_torch.track.Tracker``: every served scene
        writes a ``serve_``-prefixed record (dims, bucket, new runner or
        cached, wall ms, Mpx/s, serving mode, quant, the pack size of a
        packed scene and, for int8, the worst clip site and ratio).
      mesh: a ``parallel.mesh.Mesh``: split each tile batch over its data
        axis's devices (a model replica on each; the grid and overlap
        modes, bi-date and multi-date), or with ``shard_scene`` the scene;
        its ``spatial`` and ``model`` axes hold replicas.
      shard_scene: with a mesh, serve each scene as H-bands over its data
        axis (memory per device ~1/n): grid mode (buckets aligned to ``n
        * patch``), or with ``fullconv_band_rows`` seamless sharded
        fullconv (halos copied between the devices; buckets aligned to
        ``n * 256``); bi-date only.
      bundle: a serving bundle (``tools/export.py``, of either package)
        instead of ``checkpoint``: its folded weights load as they are
        (``model_base`` from its meta; ``n_channels`` and the model family
        must match ``cfg``), and an int8 bundle's scales seed the int8
        forward, with no calibration at serving time.
      aot_dir: serve from an ahead-of-time artifact (``infer/aot.py``
        ``export_aot``): a covered bucket's runner calls the loaded
        program, masks bit-identical to the in-process runner's; a
        missing bucket falls back to the in-process runner with a
        warning.  Refused at
        start when the artifact was frozen for another platform, model,
        quant, dtype, bucket, dates, fullconv band rows or other weights;
        int8 artifacts pin their scales (seeded from ``aot_meta.json``;
        ``recalibrate_every`` must be 0 and :meth:`calibrate` is refused).
        Single-device modes only (not streamed, not with a mesh).
    """

    def __init__(self, cfg, checkpoint: str | None = None, bucket: int = 512,
                 fold_bn: bool = True, device=None, *, quant=None, mesh=None,
                 shard_scene: bool = False, recalibrate_every: int = 0,
                 clip_warn_ratio: float = 1.0, overlap_band_rows: int = 0,
                 fullconv_band_rows: int = 0, fullconv_stream: bool = False,
                 aot_dir=None, bundle=None, tracker=None):
        if quant not in (None, "none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        folded = scales = None
        if bundle is not None:
            folded, scales, cfg, quant = self._read_bundle(bundle, cfg,
                                                           quant, fold_bn)
        self.multi_date = cfg.model in MULTI_DATE
        if fullconv_stream:
            if not fullconv_band_rows:
                raise ValueError("fullconv_stream streams the fullconv "
                                 "bands from host memory: set "
                                 "fullconv_band_rows too")
            if shard_scene:
                raise ValueError("fullconv_stream streams bands from the "
                                 "host to ONE device (use shard_scene for "
                                 "mesh-distributed scenes)")
        if fullconv_band_rows:
            if ((mesh is not None and not shard_scene) or overlap_band_rows
                    or cfg.infer_overlap or not fold_bn):
                raise ValueError("fullconv_band_rows serves BatchNorm-folded "
                                 "models with grid and overlap tiling off "
                                 "(it replaces tiling); exact and int8 both "
                                 "compose with it, the multi-date models "
                                 "serve through it, and shard_scene=True "
                                 "distributes the bands over the mesh")
            if shard_scene and self.multi_date:
                raise ValueError("sharded fullconv serves the bidate model "
                                 "only")
        if overlap_band_rows:
            if not cfg.infer_overlap:
                raise ValueError("overlap_band_rows requires "
                                 "cfg.infer_overlap > 0 (grid-mode tiles "
                                 "are disjoint: no banding needed)")
            if shard_scene or self.multi_date or mesh is not None:
                raise ValueError("overlap_band_rows supports the "
                                 "single-device bi-date model only")
        if shard_scene:
            # the scene lives H-banded over the mesh: buckets align with
            # the bands
            if self.multi_date:
                raise ValueError("shard_scene currently supports the "
                                 "bidate model only")
            if mesh is None:
                raise ValueError("shard_scene requires a mesh")
            if cfg.infer_overlap:
                raise ValueError("shard_scene supports grid and fullconv "
                                 "modes only (tiled overlap stitching "
                                 "needs its own halo machinery)")
            # sharded fullconv: a shard's band must be 16-aligned and >=
            # 2*halo (the clamped edge windows); 256 covers the halo 128
            align = mesh.shape["data"] * (256 if fullconv_band_rows
                                          else cfg.patch_size)
            bucket = max(_round_up(bucket or align, align), align)
        self.mesh = mesh
        self.shard_scene = shard_scene
        self.overlap_band_rows = overlap_band_rows
        self.fullconv_band_rows = fullconv_band_rows
        self.fullconv_stream = fullconv_stream
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
        variables = None
        if checkpoint and folded is None:
            variables = ckpt.load_variables(ckpt.resolve(checkpoint))
        # folded serving upsamples align-corners, except in fullconv
        self.model = build_model(
            cfg, self.device, fold_bn=fold_bn, variables=variables,
            folded=folded,
            local_upsample=bool(fullconv_band_rows) if fold_bn else None)
        # what the runners call: the model, or the int8 forward once the
        # scales exist; with a mesh, its replica on each device
        self._forward = self.model
        self._replicas = None
        self._runners: dict[tuple, object] = {}
        self._aot_keys: set = set()  # runner keys served from aot_dir
        self._scales: dict | None = None
        self._stats_fwd = None
        self._scenes_predicted = 0
        self.last_clip_report: dict | None = None
        if self.quant == "int8" and scales:
            self._use_scales(scales)
        self._init_aot(aot_dir)

    @staticmethod
    def _read_bundle(path: str, cfg, quant, fold_bn: bool):
        """(folded params, int8 scales or None, cfg with the bundle's
        ``model_base``, quant: None follows the bundle) of a serving
        bundle, checked against ``cfg``."""
        from fabric_tpu_torch.tools.export import load_bundle
        folded, scales, meta = load_bundle(path)
        if meta["n_channels"] != cfg.n_channels:
            raise ValueError(f"bundle n_channels {meta['n_channels']} != "
                             f"config {cfg.n_channels}")
        model = meta.get("model", "bidate")
        if model != cfg.model:
            raise ValueError(f"bundle was exported from a {model!r} model; "
                             f"config says {cfg.model!r}")
        if meta.get("n_classes", cfg.n_classes) != cfg.n_classes:
            raise ValueError(f"bundle n_classes {meta['n_classes']} != "
                             f"config {cfg.n_classes}")
        if not fold_bn:
            raise ValueError("a bundle holds BatchNorm-folded weights: "
                             "serve it with fold_bn=True")
        cfg = dataclasses.replace(cfg, model_base=meta.get("model_base", 0))
        log.info("loaded serving bundle %s (model=%s quant=%s)", path, model,
                 meta.get("quant", "none"))
        return (folded, scales, cfg,
                quant if quant is not None else meta.get("quant", "none"))

    def variables(self) -> dict:
        """The served weights as ``fabric_tpu``'s variables tree:
        ``{"params": folded, "batch_stats": {}}``, or unfolded the params
        and the BatchNorm statistics (what ``aot.params_fingerprint``
        hashes)."""
        if self.model.fold_bn:
            return {"params": q.folded_params(self.model), "batch_stats": {}}
        params, stats = weights.variables_of(self.model)
        return {"params": params, "batch_stats": stats}

    def _init_aot(self, aot_dir) -> None:
        """Check an AOT artifact against this predictor (platform, serving
        configuration, weights) and seed an int8 artifact's pinned
        scales."""
        self.aot_dir = aot_dir
        if not aot_dir:
            return
        if self.fullconv_stream or self.shard_scene or self.mesh is not None:
            raise ValueError(
                "aot_dir serves the single-device modes; streamed and "
                "sharded runners do per-band host work and stay in-process "
                "(the modes export_aot refuses)")
        meta = aot.read_meta(aot_dir)
        here = self.device.type
        if meta.get("platforms") and here not in meta["platforms"]:
            raise ValueError(
                f"AOT artifact {aot_dir} was exported for platforms "
                f"{meta['platforms']} but this predictor serves on {here!r}:"
                f" re-export it with platforms=({here!r},) (tools/export.py "
                f"--aot_platform {here})")
        mine = {"model": self.cfg.model, "quant": self.quant,
                "fullconv_band_rows": self.fullconv_band_rows,
                "dtype": ("bfloat16" if self.dtype == torch.bfloat16
                          else "float32"),
                "bucket": self.bucket,
                "num_dates": self.cfg.num_dates if self.multi_date else 0}
        for field, value in mine.items():
            if field in meta and meta[field] != value:
                raise ValueError(
                    f"AOT artifact {aot_dir} was frozen with {field}="
                    f"{meta[field]!r}; this predictor uses {value!r}: its "
                    f"masks would diverge from the artifact's")
        # the programs hold the export-time weights: other weights would
        # serve the frozen ones on covered buckets and the live ones on
        # fallback buckets
        frozen = meta.get("weights_sha256")
        if frozen:
            digest = aot.params_fingerprint(self.variables())
            if digest != frozen:
                raise ValueError(
                    f"AOT artifact {aot_dir} was exported from different "
                    f"weights (artifact sha256 {frozen[:12]}..., these "
                    f"{digest[:12]}...): re-export it from the weights "
                    f"being served (tools/export.py --aot_dir)")
        else:
            log.warning("AOT artifact %s records no weights fingerprint; "
                        "cannot check that it matches these weights",
                        aot_dir)
        if self.quant == "int8":
            if self.recalibrate_every > 0:
                raise ValueError(
                    "AOT int8 artifacts pin the calibration scales frozen "
                    "at export; recalibrate_every > 0 would move the "
                    "in-process scales away from them")
            if not meta.get("int8_scales"):
                raise ValueError(f"AOT artifact {aot_dir} is int8 but "
                                 f"records no pinned scales (re-export it "
                                 f"with infer/aot.export_aot)")
            self._use_scales(meta["int8_scales"])

    # --- int8: calibration and the per-scene clip probe ---

    def _stats_forward(self):
        if self._stats_fwd is None:
            self._stats_fwd = q.make_stats_forward(
                q.folded_params(self.model), self.dtype,
                local_upsample=self.model.local_upsample,
                model=self.cfg.model)
        return self._stats_fwd

    def calibrate(self, batches) -> None:
        """Calibrate the int8 activation scales on (d1, d2) NHWC batch
        pairs, or for a multi-date model on (N, T, H, W, C) stacks (e.g.
        patches cropped from held-out scenes), and serve the int8 forward
        with them from now on (the runners are rebuilt).  Refused when
        serving an AOT artifact, whose scales are pinned."""
        if self.aot_dir:
            raise ValueError(
                "this predictor serves an AOT artifact whose int8 scales "
                "are pinned (aot_meta.json); recalibrating would move the "
                "in-process math away from it: export a new artifact "
                "instead (infer/aot.export_aot)")
        scales = q.calibrate(q.folded_params(self.model), batches,
                             self.dtype, stats_forward=self._stats_forward(),
                             model=self.cfg.model)
        self._use_scales(scales)
        # a scene served right after a calibration ran no probe: the last
        # report (against the old scales) is not its own
        self.last_clip_report = None

    def _use_scales(self, scales: dict) -> None:
        """Serve the int8 forward at ``scales`` from now on (the runners
        are rebuilt)."""
        self._forward = q.make_int8_apply(
            q.folded_params(self.model), scales, self.dtype,
            local_upsample=self.model.local_upsample, model=self.cfg.model)
        self._scales = dict(scales)
        self._replicas = None
        self._runners.clear()
        self._aot_keys.clear()

    def _calibration_crops(self, d1, d2) -> tuple[np.ndarray, np.ndarray]:
        """Corner and centre patch crops of a scene pair, edge-padded up to
        a full patch if the scene is smaller (int8 calibration and the
        per-scene clip probe)."""
        return tuple(self._crops(d[None])[:, 0] for d in (d1, d2))

    def _calibration_crops_multidate(self, scenes) -> np.ndarray:
        """(N, T, patch, patch, C) corner and centre crops of a (T, H, W, C)
        date stack (the multi-date form of :meth:`_calibration_crops`)."""
        return self._crops(scenes)

    def _crops(self, scenes) -> np.ndarray:
        p = self.cfg.patch_size
        h0, w0 = scenes.shape[1:3]
        scenes = self._pad(scenes, max(h0, p), max(w0, p))
        crops = [scenes[:, y:y + p, x:x + p]
                 for (y, x) in self._crop_anchors(h0, w0)]
        return np.stack(crops).astype(np.float32)

    def _crop_anchors(self, h0: int, w0: int) -> set:
        p = self.cfg.patch_size
        return {(0, 0),
                (max(h0 - p, 0), max(w0 - p, 0)),
                (max((h0 - p) // 2, 0), max((w0 - p) // 2, 0))}

    def _int8_scene_prologue(self, crops):
        """First-scene or cadence-due calibration (synchronous: it rebuilds
        the int8 forward), otherwise dispatch the clip probe on ``crops``
        (what :meth:`calibrate` takes: a (d1, d2) pair, or an (N, T, p, p,
        C) stack) without waiting for it.  Returns the pending probe for
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
                     self._scenes_predicted,
                     (crops[0] if isinstance(crops, tuple)
                      else crops).shape[0])
            return None
        if not self.clip_warn_ratio:
            return None
        args = [torch.from_numpy(c) for c in
                (crops if isinstance(crops, tuple) else (crops,))]
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

    def serving_mode(self) -> str:
        """The configured serving mode: "fullconv_stream",
        "sharded_fullconv", "fullconv", "sharded_grid", "banded_overlap",
        "overlap" or "grid"."""
        if self.fullconv_band_rows:
            if self.fullconv_stream:
                return "fullconv_stream"
            return "sharded_fullconv" if self.shard_scene else "fullconv"
        if self.shard_scene:
            return "sharded_grid"
        if self.overlap_band_rows:
            return "banded_overlap"
        if self.cfg.infer_overlap:
            return "overlap"
        return "grid"

    _CLIP_UNSET = object()  # the caller did not track this scene's probe

    def _record_scene(self, scene_id, dims, runner_key, new_runner, wall_s,
                      pipelined: bool = False, clip_report=_CLIP_UNSET,
                      packed: int = 0) -> None:
        """Stream one served scene's ``serve_*`` record through the tracker
        (nothing without one); ``runner_key`` is the key of the runner that
        served it (its ``aot`` field: whether that came from the
        artifact)."""
        if self.tracker is None:
            return
        h, w = dims
        rec = {
            "scene": scene_id,
            "height": h, "width": w,
            "bucket_h": runner_key[0], "bucket_w": runner_key[1],
            "compiled": bool(new_runner),
            "wall_ms": round(wall_s * 1000.0, 2),
            "mode": self.serving_mode(),
            "quant": self.quant,
            "aot": runner_key in self._aot_keys,
        }
        if pipelined:
            # several scenes are in flight: this scene's wall clock
            # overlaps its neighbours' compute, so it gives no rate
            rec["pipelined"] = True
        else:
            rec["mpx_per_sec"] = round(h * w / wall_s / 1e6, 3)
        if packed:
            # fleet-packed: this scene shared its forward with up to
            # packed - 1 others (wall_ms covers the pack)
            rec["packed"] = packed
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

    def _runner_key(self, h: int, w: int) -> tuple[int, int]:
        """The runner key of an (h, w) scene: its bucket dims, or in
        streamed fullconv its own dims (the runner pads virtually)."""
        if self.fullconv_stream:
            return h, w
        return self._bucket_dims(h, w)

    def _bucket_dims(self, h: int, w: int) -> tuple[int, int]:
        """Padded (H, W) for this scene under the bucket policy."""
        patch = self.cfg.patch_size
        if self.bucket:
            return (max(_round_up(h, self.bucket), patch),
                    max(_round_up(w, self.bucket), patch))
        return max(h, patch), max(w, patch)

    def _mesh_forward(self):
        """The forward, or with a mesh its replicas (made once per
        forward)."""
        if self.mesh is None:
            return self._forward
        if self._replicas is None:
            self._replicas = replicas(self._forward, self.mesh.devices)
        return self._replicas

    def _load_aot(self, key: tuple):
        """The artifact's forward for a runner key, None (with a warning)
        where the artifact lacks it or without ``aot_dir``."""
        if not self.aot_dir:
            return None
        h, w = key[:2]
        pack = key[2] if len(key) > 2 else 0
        forward = aot.load_aot(self.aot_dir, h, w, pack=pack,
                               device=self.device)
        if forward is None:
            log.warning("no AOT artifact for bucket %dx%d%s in %s; falling "
                        "back to the in-process runner", h, w,
                        f" pack {pack}" if pack else "", self.aot_dir)
            return None
        forward.local_upsample = self.model.local_upsample
        self._aot_keys.add(key)
        return forward

    def _get_runner(self, h: int, w: int):
        key = (h, w)
        if key not in self._runners:
            self._runners[key] = self._in_process_runner(
                h, w, forward=self._load_aot(key))
        return self._runners[key]

    def _in_process_runner(self, h: int, w: int, forward=None):
        """The runner of this predictor's mode for an (h, w) bucket, built
        here around ``forward`` (an artifact's program), or None: the
        predictor's forward (with a mesh, its replicas)."""
        key = (h, w)
        cfg = self.cfg
        common = dict(batch_size=cfg.eval_batch_size, dtype=self.dtype)
        if forward is None:
            forward, fwd = self._forward, self._mesh_forward()
        else:
            fwd = forward
        band = dict(band_rows=self.fullconv_band_rows, dtype=self.dtype,
                    halo=fullconv.halo_for(cfg.model, cfg.num_dates))
        if self.fullconv_stream:
            # bands sliced from the host scene, padded virtually to
            # the bucket: the mask of the in-device-memory runner
            stream = dict(band, padded_shape=self._bucket_dims(h, w),
                          device=self.device)
            run = (fullconv.make_fullconv_scene_infer_multidate_streamed(
                forward, key, cfg.num_dates, **stream)
                if self.multi_date else
                fullconv.make_fullconv_scene_infer_streamed(
                    forward, key, **stream))
        elif self.shard_scene and self.fullconv_band_rows:
            run = fullconv.make_sharded_fullconv_infer(
                fwd, key, self.mesh, **band)
        elif self.shard_scene:
            run = make_sharded_scene_infer(fwd, cfg.patch_size, key,
                                           self.mesh, **common)
        elif self.fullconv_band_rows:
            run = (fullconv.make_fullconv_scene_infer_multidate(
                forward, key, cfg.num_dates, **band)
                if self.multi_date else
                fullconv.make_fullconv_scene_infer(forward, key,
                                                   **band))
        elif self.multi_date:
            run = make_scene_infer_multidate(
                fwd, cfg.patch_size, key,
                num_dates=cfg.num_dates, overlap=cfg.infer_overlap,
                mesh=self.mesh, **common)
        elif self.overlap_band_rows:
            run = make_banded_overlap_infer(
                forward, cfg.patch_size, key,
                overlap=cfg.infer_overlap,
                band_tile_rows=self.overlap_band_rows, **common)
        else:
            run = make_scene_infer(fwd, cfg.patch_size, key,
                                   overlap=cfg.infer_overlap,
                                   mesh=self.mesh, **common)
        return run

    def _upload(self, slots, n: int | None = None):
        """Host arrays to the device: ``(device tensor, host buffer)``.
        The arrays of ``slots`` are copied once into one host buffer (on the
        card page-locked, so the upload is asynchronous; the buffer must
        live until the copy is done), stacked on a new first axis of ``n``
        slots with zeros in the slots no array fills, or with ``n`` None
        the single array of ``slots`` as it is."""
        arrays = [np.asarray(a) for a in slots]
        with profiling.span("serve.stage",
                            bytes=sum(a.nbytes for a in arrays)):
            first = torch.from_numpy(arrays[0])
            shape = first.shape if n is None else (n,) + tuple(first.shape)
            host = torch.empty(shape, dtype=first.dtype,
                               pin_memory=self.device.type == "cuda")
            view = host.unsqueeze(0) if n is None else host
            for j, a in enumerate(arrays):
                view[j].copy_(torch.from_numpy(a))
            view[len(arrays):].zero_()
        with profiling.span("serve.upload"):
            return host.to(self.device, non_blocking=True), host

    def _pad(self, a: np.ndarray, ph: int, pw: int) -> np.ndarray:
        """Edge-pad the (H, W) axes of an (H, W, C) or (T, H, W, C) array
        up to (ph, pw)."""
        h, w = a.shape[-3:-1]
        if (ph, pw) == (h, w):
            return a
        with profiling.span("serve.pad"):
            return np.pad(a, [(0, 0)] * (a.ndim - 3)
                          + [(0, ph - h), (0, pw - w), (0, 0)], mode="edge")

    @staticmethod
    def _launch(run, *args):
        """The runner's call on uploaded scenes: the host's enqueue of the
        forward."""
        with profiling.span("serve.launch"):
            return run(*args)

    def _dispatch(self, d1: np.ndarray, d2: np.ndarray):
        """Pad, upload and start one scene pair without waiting for it:
        returns ``(mask, h, w, host_buffers)`` with ``mask`` the
        (bucket-sized) device tensor, possibly still being computed."""
        h, w = d1.shape[:2]
        if self.fullconv_stream:  # the runner slices the host arrays
            return (torch.from_numpy(self._get_runner(h, w)(d1, d2)), h, w,
                    None)
        ph, pw = self._bucket_dims(h, w)
        run = self._get_runner(ph, pw)
        if self.shard_scene:
            # each band is cast on the host and uploaded to its shard's
            # device: no device holds the whole scene
            a1, a2 = (put_scene_sharded(self._pad(d, ph, pw), self.mesh,
                                        self.dtype) for d in (d1, d2))
            return self._launch(run, a1, a2), h, w, None
        (a1, h1), (a2, h2) = (self._upload([self._pad(d, ph, pw)])
                              for d in (d1, d2))
        return self._launch(run, a1, a2), h, w, (h1, h2)

    def _dispatch_multidate(self, scenes: np.ndarray):
        """The multi-date form of :meth:`_dispatch`, for a (T, H, W, C)
        date stack."""
        h, w = scenes.shape[1:3]
        if self.fullconv_stream:
            return torch.from_numpy(self._get_runner(h, w)(scenes)), h, w, \
                None
        ph, pw = self._bucket_dims(h, w)
        run = self._get_runner(ph, pw)
        a, host = self._upload([self._pad(scenes, ph, pw)])
        return self._launch(run, a), h, w, host

    def _check_bidate(self, call: str) -> None:
        if self.multi_date:
            raise ValueError(f"{call} serves bi-date pairs; this predictor "
                             f"serves the multi-date model {self.cfg.model!r}"
                             f": use {call}_multidate with (T, H, W, C) "
                             f"stacks")

    def _check_multidate(self, call: str) -> None:
        if not self.multi_date:
            raise ValueError(f"{call} requires a multi-date model "
                             f"(cfg.model unet_lstm or unet3d); use "
                             f"{call.removesuffix('_multidate')} for "
                             f"bi-date pairs")

    def _predict_one(self, crops, dims, dispatch, scene_id) -> np.ndarray:
        t0 = time.perf_counter()
        if self.quant == "int8":
            probe = self._int8_scene_prologue(crops())
            self._int8_probe_check(probe, self._scenes_predicted)
        idx = self._scenes_predicted
        self._scenes_predicted += 1
        key = self._runner_key(*dims)
        new_runner = key not in self._runners
        with profiling.span("serve.dispatch", id=idx):
            mask, h, w, _ = dispatch()
        out = mask.cpu().numpy()[:h, :w]
        self._record_scene(scene_id, (h, w), key, new_runner,
                           time.perf_counter() - t0)
        return out

    def predict(self, d1: np.ndarray, d2: np.ndarray,
                scene_id: str | None = None) -> np.ndarray:
        """(H, W, C) scene pair -> (H, W) uint8 change mask."""
        self._check_bidate("predict")
        return self._predict_one(lambda: self._calibration_crops(d1, d2),
                                 d1.shape[:2], lambda: self._dispatch(d1, d2),
                                 scene_id)

    def predict_multidate(self, scenes: np.ndarray,
                          scene_id: str | None = None) -> np.ndarray:
        """(T, H, W, C) date stack -> (H, W) uint8 change mask (the
        UNetLSTM and UNet3D serving path)."""
        self._check_multidate("predict_multidate")
        return self._predict_one(
            lambda: self._calibration_crops_multidate(scenes),
            scenes.shape[1:3], lambda: self._dispatch_multidate(scenes),
            scene_id)

    def _predict_pipelined(self, items, window: int, dispatch, dims_of,
                           crops_of, scene_ids=None) -> list[np.ndarray]:
        """Serve ``items`` with up to ``window`` scenes in flight: scene
        n+1's padding, upload and launches are queued while the card
        computes scene n, and only the read-back of the oldest scene
        waits.  int8 scenes pipeline too: the clip probe is dispatched
        ahead of the scene and checked right after the scene's own
        dispatch (before the next scene's), so it waits on the probe's few
        crops alone; only a calibration synchronises."""
        results: list[np.ndarray] = []
        pending: deque = deque()

        def drain():
            mask, h, w, _, key, new_runner, sid, t0, report = \
                pending.popleft()
            results.append(mask.cpu().numpy()[:h, :w])
            self._record_scene(sid, (h, w), key, new_runner,
                               time.perf_counter() - t0, pipelined=True,
                               clip_report=report)

        for i, item in enumerate(items):
            sid = scene_ids[i] if scene_ids else None
            t0 = time.perf_counter()
            probe = None
            if self.quant == "int8":
                probe = self._int8_scene_prologue(crops_of(item))
            idx = self._scenes_predicted
            self._scenes_predicted += 1
            key = self._runner_key(*dims_of(item))
            new_runner = key not in self._runners
            with profiling.span("serve.dispatch", id=idx):
                dispatched = dispatch(item)
            report = self._int8_probe_check(probe, idx)
            pending.append((*dispatched, key, new_runner, sid, t0, report))
            while len(pending) > max(window, 1):
                drain()
        while pending:
            drain()
        return results

    def _get_packed_runner(self, ph: int, pw: int, pack: int):
        key = (ph, pw, pack, "packed")
        if key not in self._runners:
            self._runners[key] = self._in_process_packed_runner(
                ph, pw, pack, forward=self._load_aot(key))
        return self._runners[key]

    def _in_process_packed_runner(self, ph: int, pw: int, pack: int,
                                  forward=None):
        """The fleet-packed runner of ``pack`` (ph, pw) scenes, built here
        around ``forward`` (an artifact's program), or None: the
        predictor's forward."""
        return make_packed_scene_infer(
            self._forward if forward is None else forward,
            self.cfg.patch_size, (ph, pw), pack,
            batch_size=self.cfg.eval_batch_size, dtype=self.dtype,
            num_dates=self.cfg.num_dates if self.multi_date else 0)

    def _pack_for(self, pack, bkey: tuple[int, int]) -> int:
        """``pack``, or for "auto" the first pack that fills the tile batch
        of this bucket: eval_batch_size // tiles per scene (at least 1)."""
        if pack != "auto":
            return pack
        p = self.cfg.patch_size
        k = -(-bkey[0] // p) * -(-bkey[1] // p)  # tiles per scene
        return max(1, self.cfg.eval_batch_size // k)

    def _predict_packed(self, items, pack, window: int, scene_ids,
                        multidate: bool) -> list[np.ndarray]:
        """Fleet-packed serving: group the scenes by bucket, run ``pack``
        of a bucket per call so that their tiles share the chunks, and keep
        up to ``window`` packs in flight.  A partial pack's free slots
        take zero scenes, whose masks are dropped.  ``items`` may be a lazy
        iterator: a scene is taken when its pack has room, so the host
        holds the open packs and the packs in flight, not the fleet.  Each
        scene's mask equals :meth:`predict`'s (each kernel computes an
        image on its own; the chunk size is the same).  With
        ``recalibrate_every`` > 0 every scene of a pack serves with the
        scales of the pack's dispatch."""
        if self.serving_mode() != "grid":
            raise ValueError(
                f"pack= serves the grid tiling mode only (this predictor "
                f"is configured for {self.serving_mode()!r}); fullconv "
                f"and overlap scenes do not tile into packable batches")
        if pack != "auto" and (not isinstance(pack, int) or pack < 1):
            raise ValueError(f"pack must be >= 1 or 'auto', got {pack!r}")
        results: dict[int, np.ndarray] = {}
        groups: dict[tuple[int, int], list] = {}
        packs: dict[tuple[int, int], int] = {}
        pending: deque = deque()

        def flush(bkey):
            entries = groups.pop(bkey)
            pk = packs[bkey]
            new_runner = (*bkey, pk, "packed") not in self._runners
            run = self._get_packed_runner(*bkey, pk)
            with profiling.span("serve.dispatch", id=entries[0]["n"]):
                scenes = [pad(e["item"], bkey) for e in entries]
                uploads = ([self._upload(scenes, pk)] if multidate else
                           [self._upload([s[i] for s in scenes], pk)
                            for i in (0, 1)])
                masks = self._launch(run, *(a for a, _ in uploads))
            pending.append((masks, uploads, entries, bkey, new_runner))
            while len(pending) > max(window, 1):
                drain()

        def pad(item, bkey):
            return (self._pad(item, *bkey) if multidate else
                    tuple(self._pad(d, *bkey) for d in item))

        def drain():
            masks, _, entries, bkey, new_runner = pending.popleft()
            host = masks.cpu().numpy()
            for slot, e in enumerate(entries):
                results[e["idx"]] = host[slot, :e["h"], :e["w"]]
                self._record_scene(e["sid"], (e["h"], e["w"]),
                                   (*bkey, packs[bkey], "packed"),
                                   new_runner and slot == 0,
                                   time.perf_counter() - e["t0"],
                                   pipelined=True, clip_report=e["report"],
                                   packed=packs[bkey])

        for i, item in enumerate(items):
            sid = scene_ids[i] if scene_ids else None
            t0 = time.perf_counter()
            report = None
            if self.quant == "int8":
                crops = (self._calibration_crops_multidate(item) if multidate
                         else self._calibration_crops(*item))
                # a calibration rebuilds the runners, so it comes before
                # this scene joins a pack
                report = self._int8_probe_check(
                    self._int8_scene_prologue(crops), self._scenes_predicted)
            n = self._scenes_predicted
            self._scenes_predicted += 1
            h, w = item.shape[1:3] if multidate else item[0].shape[:2]
            bkey = self._bucket_dims(h, w)
            packs.setdefault(bkey, self._pack_for(pack, bkey))
            groups.setdefault(bkey, []).append(
                {"idx": i, "n": n, "item": item, "h": h, "w": w, "sid": sid,
                 "t0": t0, "report": report})
            if len(groups[bkey]) == packs[bkey]:
                flush(bkey)
        for bkey in list(groups):
            flush(bkey)
        while pending:
            drain()
        return [results[i] for i in range(len(results))]

    def predict_many(self, pairs, window: int = 2, scene_ids=None,
                     pack=0) -> list[np.ndarray]:
        """Serve a sequence of ``(d1, d2)`` pairs (any iterable, consumed
        lazily), equal to ``[predict(*p) for p in pairs]``, with up to
        ``window`` scenes (or packs) in flight.  ``scene_ids`` label the
        tracker records.  ``pack`` (grid mode): run N same-bucket scenes
        per call, their tiles sharing the chunks; "auto" picks per bucket
        the first pack that fills the tile batch; 0 serves scene by
        scene."""
        self._check_bidate("predict_many")
        if pack:
            return self._predict_packed(pairs, pack, window, scene_ids,
                                        multidate=False)
        return self._predict_pipelined(
            pairs, window, dispatch=lambda p: self._dispatch(*p),
            dims_of=lambda p: p[0].shape[:2],
            crops_of=lambda p: self._calibration_crops(*p),
            scene_ids=scene_ids)

    def predict_many_multidate(self, stacks, window: int = 2, scene_ids=None,
                               pack=0) -> list[np.ndarray]:
        """The multi-date form of :meth:`predict_many`, over (T, H, W, C)
        date stacks: equal to ``[predict_multidate(s) for s in stacks]``."""
        self._check_multidate("predict_many_multidate")
        if pack:
            return self._predict_packed(stacks, pack, window, scene_ids,
                                        multidate=True)
        return self._predict_pipelined(
            stacks, window, dispatch=self._dispatch_multidate,
            dims_of=lambda s: s.shape[1:3],
            crops_of=self._calibration_crops_multidate, scene_ids=scene_ids)

    def predict_city(self, city: str) -> np.ndarray:
        """The mask of a dataset city (``cfg.dataset_dir``), at the dims of
        its bands as the reference takes them."""
        from fabric_tpu_torch.infer.runner import load_scene
        stacked = load_scene(self.cfg, city)
        if self.multi_date:
            return self.predict_multidate(stacked, scene_id=city)
        return self.predict(stacked[0], stacked[1], scene_id=city)
