"""Validate int8 serving against exact serving on held-out scenes
(counterpart of ``fabric_tpu/tools/validate_int8.py``).

For each city it predicts the whole scene with the exact predictor and the
int8 predictor (same weights, same tiling) and reports the change-class F1
of both against the label, their difference and the pixel agreement of the
two masks: one JSON line per city and a summary line.  The exit code is 1
when a city's int8 F1 falls more than ``--max_f1_drop`` (default 0.01)
below the exact one, or its agreement below ``--min_agreement`` (default
0.95), so the tool can gate a deployment.

    python -m fabric_tpu_torch.tools.validate_int8 --config metadata.json \
        --resume ./outputs | --bundle model_bundle.npz [--city X ...] \
        [--max_f1_drop 0.01] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _scene_f1(mask: np.ndarray, label: np.ndarray) -> float:
    from fabric_tpu_torch.metrics import prf1_from_counts
    tp = int(np.sum((mask == 1) & (label == 1)))
    fp = int(np.sum((mask == 1) & (label == 0)))
    fn = int(np.sum((mask == 0) & (label == 1)))
    return prf1_from_counts({"tp": tp, "fp": fp, "fn": fn})[2]


def validate(cfg, cities=None, max_f1_drop: float = 0.01,
             bundle: str | None = None, min_agreement: float = 0.95,
             device=None) -> tuple[list[dict], bool]:
    """-> (per-city reports, ok), both predictors from ``bundle`` when
    given, else from ``cfg.resume``.  ``ok`` is False if a city's int8 F1
    drops more than ``max_f1_drop`` below the exact one, or its mask
    agreement falls below ``min_agreement`` (which also gates cities whose
    label does not match the scene dims)."""
    from fabric_tpu_torch.data.oscd import load_label
    from fabric_tpu_torch.infer.service import ScenePredictor

    cities = cities or cfg.validation_cities
    # a bundle carries the folded weights (and an int8 bundle its scales),
    # so both predictors can come from it
    source = dict(bundle=bundle) if bundle else dict(checkpoint=cfg.resume)
    exact = ScenePredictor(cfg, quant="none", device=device, **source)
    q = ScenePredictor(cfg, quant="int8", device=device, **source)
    reports, ok = [], True
    for city in cities:
        m_ref = exact.predict_city(city)
        m_q = q.predict_city(city)
        agree = float((m_ref == m_q).mean())
        rep = {"city": city, "mask_agreement": round(agree, 5)}
        if q.last_clip_report:
            # this city's activation ranges against the calibration scene's
            rep["clip_overflow_ratio"] = round(
                max(q.last_clip_report.values()), 4)
        fail = agree < min_agreement
        label = load_label(cfg.dataset_dir, city)
        if label.shape == m_ref.shape:
            f1_ref, f1_q = _scene_f1(m_ref, label), _scene_f1(m_q, label)
            rep.update({"f1_bf16": round(f1_ref, 5),
                        "f1_int8": round(f1_q, 5),
                        "f1_delta": round(f1_q - f1_ref, 5)})
            fail = fail or (f1_ref - f1_q > max_f1_drop)
        else:
            rep["note"] = ("label shape mismatch; gated on mask agreement "
                           "only")
        rep["verdict"] = "FAIL" if fail else "ok"
        ok = ok and not fail
        reports.append(rep)
    return reports, ok


def main(argv=None) -> int:
    from fabric_tpu_torch.config import load_config
    from fabric_tpu_torch.data.download import ensure_dataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 add_help=False)
    ap.add_argument("--city", action="append", default=None)
    ap.add_argument("--max_f1_drop", type=float, default=0.01)
    ap.add_argument("--min_agreement", type=float, default=0.95)
    ap.add_argument("--bundle", type=str, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    own, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(argv=rest)
    if not cfg.resume and not own.bundle:
        ap.error("--resume or --bundle is required")
    cfg.dataset_dir = ensure_dataset(cfg)
    reports, ok = validate(cfg, own.city, own.max_f1_drop, own.bundle,
                           min_agreement=own.min_agreement,
                           device=own.device)
    for r in reports:
        print(json.dumps(r))
    print(json.dumps({"summary": "ok" if ok else "FAIL",
                      "cities": len(reports),
                      "max_f1_drop": own.max_f1_drop,
                      "min_agreement": own.min_agreement}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
