"""``python -m fabric_tpu_torch.cli.infer --config <json> --resume <ckpt>
[--city X ...] [--quant int8] [--overlap_band_rows N] [--pack N|auto]
[--fullconv_band_rows N [--fullconv_stream]] [--shard_scene]
[--bundle <npz> [--aot_dir <dir>]] [--device cpu]``

Whole-scene inference of dataset cities (counterpart of
``fabric_tpu/cli/infer.py``), for the bi-date model or a multi-date one
(``--model unet_lstm|unet3d``, ``--num_dates T``): loads a checkpoint (for
a directory, its best-metric save, else the latest), predicts each
requested city (default: ``validation_cities``) and writes
``<output_dir>/<city>_mask.png``.  ``--bundle`` serves a serving bundle
(``tools/export.py``) instead of a checkpoint (``--resume`` is then not
needed), ``--aot_dir`` the runners frozen into an ahead-of-time artifact
(``infer/aot.py``).  Without ``--quant``, ``--pack``,
``--overlap_band_rows``, ``--fullconv_band_rows``, ``--bundle`` or
``--aot_dir`` it runs the reference path (``infer/runner.infer_city`` on
the unfolded eval forward, grid or ``--infer_overlap``); with any of them it serves through ``ScenePredictor``
(BatchNorm folded; ``--quant int8`` calibrated on the first city;
``--overlap_band_rows`` accumulating overlap-mode probabilities in bands
of N tile rows; ``--pack`` packing N same-bucket cities, or "auto" as many
as fill the tile batch, into one forward, the cities loaded lazily as the
packs fill; ``--fullconv_band_rows`` running the network over
halo-extended bands of N pixel rows instead of tiles, with
``--fullconv_stream`` streamed band by band from host memory;
``--shard_scene`` splitting each scene into H-bands over the mesh of
``--mesh_data`` devices, grid or with ``--fullconv_band_rows`` seamless
fullconv).  The serving path builds the mesh as ``fabric_tpu`` does
(``parallel/mesh.make_mesh_from_config``: the visible cards, or with
``--device cpu`` as many CPU "devices" as ``--mesh_data`` x
``--mesh_spatial`` x ``--mesh_model``); without ``--shard_scene`` it
splits each tile batch over its data axis, and its spatial and model
axes hold replicas.  Unless
``--no_tracker``, every scene writes a ``serve_*`` record to
``<log_dir>/<run>/metrics.jsonl``.  On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--city", action="append", default=None)
    extra.add_argument("--output_dir", type=str, default=".")
    extra.add_argument("--quant", choices=["none", "int8"], default=None,
                       help="int8 = post-training-quantized serving, "
                            "calibrated once on the first city")
    extra.add_argument("--bucket", type=int, default=512,
                       help="the serving path (int8, --pack, "
                            "--overlap_band_rows, --fullconv_band_rows, "
                            "--bundle, --aot_dir): scene dims pad up to "
                            "multiples of this")
    extra.add_argument("--overlap_band_rows", type=int, default=0,
                       help="overlap mode (--infer_overlap > 0), bi-date: "
                            "accumulate in bands of N tile rows (bounded "
                            "memory on large scenes; the same masks)")
    extra.add_argument("--pack", default=0,
                       type=lambda v: v if v == "auto" else int(v),
                       help="grid mode: run N same-bucket cities per "
                            "forward (their tiles share the chunks; the "
                            "masks are the unpacked ones); 'auto' packs, "
                            "per bucket, as many as fill the tile batch")
    extra.add_argument("--fullconv_band_rows", type=int, default=0,
                       help="seamless fullconv serving: run the network "
                            "over halo-extended bands of N pixel rows (a "
                            "multiple of 16) instead of tiles; 0 = off")
    extra.add_argument("--fullconv_stream", action="store_true",
                       help="with --fullconv_band_rows: stream each band "
                            "from host memory instead of placing the "
                            "scene on the card (the card holds one band)")
    extra.add_argument("--device", default=None, help="cuda (default) or cpu")
    extra.add_argument("--no_tracker", action="store_true",
                       help="write no serve_* records")
    extra.add_argument("--bundle", default=None,
                       help="serve this serving bundle (tools/export.py) "
                            "instead of --resume")
    extra.add_argument("--aot_dir", default=None,
                       help="serve the runners frozen into this AOT "
                            "artifact (infer/aot.py); buckets it lacks run "
                            "in process")
    extra.add_argument("--shard_scene", action="store_true",
                       help="serve each scene as H-bands over the mesh's "
                            "data axis (memory per device ~1/N): grid, or "
                            "seamless sharded fullconv with "
                            "--fullconv_band_rows")
    own, rest = extra.parse_known_args(sys.argv[1:] if argv is None else argv)

    from fabric_tpu_torch.config import load_config
    from fabric_tpu_torch.data.download import ensure_dataset
    from fabric_tpu_torch.track import Tracker

    cfg = load_config(argv=rest)
    if not cfg.resume and not own.bundle:
        print("error: --resume <checkpoint> is required (or --bundle for "
              "the serving path)", file=sys.stderr)
        return 2
    cfg.dataset_dir = ensure_dataset(cfg)
    tracker = None
    if not own.no_tracker:
        tracker = Tracker(cfg.log_dir, project="serve")
        logging.info("serving metrics -> %s/metrics.jsonl", tracker.dir)
    try:
        _serve(own, cfg, tracker)
    except BaseException:
        if tracker is not None:
            tracker.set_status("failed")
            tracker.close()
        raise
    if tracker is not None:
        tracker.set_status("succeeded")
        tracker.close()
    return 0


def _serve(own, cfg, tracker) -> None:
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.data.image import write_png
    from fabric_tpu_torch.infer.runner import infer_city, load_scene
    from fabric_tpu_torch.infer.service import ScenePredictor, resolve_device
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.parallel.mesh import make_mesh_from_config

    if (own.quant == "int8" or own.overlap_band_rows > 0 or own.pack
            or own.fullconv_band_rows > 0 or own.fullconv_stream
            or own.shard_scene or own.bundle or own.aot_dir):
        mesh = None
        if not (own.overlap_band_rows or own.pack or own.aot_dir
                or (own.fullconv_band_rows and not own.shard_scene)):
            on_card = resolve_device(own.device).type == "cuda"
            mesh = make_mesh_from_config(
                cfg, None if on_card else
                ["cpu"] * (max(cfg.mesh_data, 1) * cfg.mesh_spatial
                           * cfg.mesh_model))
        pred = ScenePredictor(cfg, checkpoint=cfg.resume or None,
                              bundle=own.bundle, bucket=own.bucket,
                              device=own.device, quant=own.quant,
                              mesh=mesh, shard_scene=own.shard_scene,
                              overlap_band_rows=own.overlap_band_rows,
                              fullconv_band_rows=own.fullconv_band_rows,
                              fullconv_stream=own.fullconv_stream,
                              aot_dir=own.aot_dir, tracker=tracker)
        predict_city = pred.predict_city
    else:
        path = ckpt.resolve(cfg.resume)
        logging.info("using checkpoint %s", path)
        device = resolve_device(own.device)
        model = build_model(cfg, device, fold_bn=False,
                            variables=ckpt.load_variables(path))

        def predict_city(city):
            t0 = time.perf_counter()
            mask = infer_city(model, cfg, city, device=device)
            if tracker is not None:
                wall = time.perf_counter() - t0
                h, w = mask.shape[:2]
                tracker.log_metrics(
                    {"scene": city, "height": h, "width": w,
                     "wall_ms": round(wall * 1000.0, 2),
                     "mpx_per_sec": round(h * w / wall / 1e6, 3),
                     "mode": "reference_grid", "quant": "none"},
                    prefix="serve_")
            return mask

    os.makedirs(own.output_dir, exist_ok=True)
    cities = list(own.city or cfg.validation_cities)
    if own.pack:
        # a city is loaded when its pack has room: the host holds the open
        # packs and the packs in flight, not every city
        scenes = (load_scene(cfg, city) for city in cities)
        if pred.multi_date:
            masks = pred.predict_many_multidate(scenes, pack=own.pack,
                                                scene_ids=cities)
        else:
            masks = pred.predict_many(((s[0], s[1]) for s in scenes),
                                      pack=own.pack, scene_ids=cities)
        results = zip(cities, masks)
    else:
        results = ((city, predict_city(city)) for city in cities)
    for city, mask in results:
        out = os.path.join(own.output_dir, f"{city}_mask.png")
        write_png(out, mask * 255)
        logging.info("wrote %s (%dx%d, %.2f%% change)", out, mask.shape[0],
                     mask.shape[1], 100.0 * mask.mean())


if __name__ == "__main__":
    raise SystemExit(main())
