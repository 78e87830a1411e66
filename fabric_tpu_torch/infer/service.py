"""ScenePredictor: whole-scene bi-date change-map serving (counterpart of
``fabric_tpu/infer/service.py``, exact grid mode).

Loads a checkpoint once (or initialises weights from a seed), folds
BatchNorm on the host, and serves scene pairs of any size: each scene is
edge-padded up to the next multiple of ``bucket``, run through the grid
tiler of ``infer/device_tiling.py`` on the device, and the mask is cropped
back.  One runner is built per bucket and reused.  The folded forward runs
on the port's hand-written kernels; with ``fold_bn=False`` the eval-BN
forward runs, on the eval-BatchNorm kernel.

Serving modes of ``fabric_tpu`` that this port does not have yet raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from fabric_tpu_torch import checkpoint as ckpt
from fabric_tpu_torch.infer.device_tiling import make_scene_infer
from fabric_tpu_torch.models import build_model, compute_dtype


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
      quant, mesh, shard_scene, overlap_band_rows, fullconv_band_rows,
      fullconv_stream, aot_dir, bundle, tracker: ``fabric_tpu`` serving
        modes that are not ported yet; anything but their default raises.
    """

    def __init__(self, cfg, checkpoint: str | None = None, bucket: int = 512,
                 fold_bn: bool = True, device=None, *, quant=None, mesh=None,
                 shard_scene: bool = False, overlap_band_rows: int = 0,
                 fullconv_band_rows: int = 0, fullconv_stream: bool = False,
                 aot_dir=None, bundle=None, tracker=None):
        if quant not in (None, "none"):
            raise _not_ported(f"quant={quant!r}", "7 (int8 serving)")
        if mesh is not None or shard_scene:
            raise _not_ported("mesh / shard_scene serving", "10 (multi-GPU)")
        if overlap_band_rows:
            raise _not_ported("overlap_band_rows", "6 (other tiled modes)")
        if fullconv_band_rows or fullconv_stream:
            raise _not_ported("fullconv serving", "9 (seamless fullconv)")
        if aot_dir is not None or bundle is not None:
            raise _not_ported("aot_dir / bundle serving",
                              "11 (frozen artifacts and bundles)")
        if tracker is not None:
            raise _not_ported("serve_* tracker records",
                              "4 (serving front, tracker records)")
        if cfg.model != "bidate":
            raise _not_ported(f"model {cfg.model!r}", "8 (multi-date models)")
        self.cfg = cfg
        self.bucket = bucket
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
        self._runners: dict[tuple[int, int], object] = {}

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
                self.model, self.cfg.patch_size, key,
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

    def predict(self, d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
        """(H, W, C) scene pair -> (H, W) uint8 change mask."""
        mask, h, w, _ = self._dispatch(d1, d2)
        return mask.cpu().numpy()[:h, :w]

    def predict_many(self, pairs, window: int = 2,
                     pack: int = 0) -> list[np.ndarray]:
        """Serve a sequence of ``(d1, d2)`` pairs with up to ``window``
        scenes in flight: scene n+1's padding, upload and launches are
        queued while the card computes scene n, and only the read-back of
        the oldest scene waits.  Equal to ``[predict(*p) for p in pairs]``.
        ``pack`` (fleet packing) is not ported yet."""
        if pack:
            raise _not_ported("predict_many(pack=...)",
                              "6 (fleet packing)")
        results: list[np.ndarray] = []
        pending: deque = deque()
        for d1, d2 in pairs:
            pending.append(self._dispatch(d1, d2))
            while len(pending) > max(window, 1):
                mask, h, w, _ = pending.popleft()
                results.append(mask.cpu().numpy()[:h, :w])
        while pending:
            mask, h, w, _ = pending.popleft()
            results.append(mask.cpu().numpy()[:h, :w])
        return results
