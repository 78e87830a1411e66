"""Experiment tracking to local files (a copy of ``fabric_tpu/track.py``).

One run directory under ``log_dir``: metrics stream to ``metrics.jsonl``,
images to PNG files, comparison figures through matplotlib when it is
installed, params and status to JSON.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np

from fabric_tpu_torch.data.image import scale, write_png


class Tracker:
    def __init__(self, log_dir: str, run_name: str | None = None,
                 project: str | None = None):
        run_name = run_name or time.strftime(
            f"{project or 'run'}_%Y%m%d_%H%M%S")
        self.dir = os.path.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._metrics_file = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self.set_status("started")

    def log_params(self, params: dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "params.json"), "w") as fout:
            json.dump(params, fout, indent=2, default=str)

    def log_metrics(self, metrics: dict[str, Any], step: int | None = None,
                    prefix: str = "") -> None:
        rec = {f"{prefix}{k}": _jsonable(v) for k, v in metrics.items()}
        rec["_time"] = time.time()
        if step is not None:
            rec["_step"] = step
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()

    def log_image(self, name: str, array: np.ndarray,
                  rescale: bool = False) -> str:
        arr = np.asarray(array)
        if rescale:
            arr = scale(arr)
        path = os.path.join(self.dir, f"{name}.png")
        write_png(path, arr)
        return path

    def log_figure(self, name: str, img1, img2, groundtruth,
                   prediction) -> str | None:
        """2x2 comparison figure (date 1, date 2, groundtruth,
        prediction); skipped without matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        fig, axarr = plt.subplots(2, 2)
        for ax, (title, img) in zip(
                axarr.flat,
                [("Date 1", img1), ("Date 2", img2),
                 ("Groundtruth", groundtruth), ("Prediction", prediction)]):
            ax.set_title(title)
            ax.imshow(np.asarray(img))
            ax.set_xticks([])
            ax.set_yticks([])
        path = os.path.join(self.dir, f"{name}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def set_status(self, status: str) -> None:
        with open(os.path.join(self.dir, "status.json"), "w") as fout:
            json.dump({"status": status, "time": time.time()}, fout)

    def close(self) -> None:
        self._metrics_file.close()


class NullTracker:
    """A Tracker that writes nothing."""

    dir = None

    def log_params(self, params: dict[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: dict[str, Any], step: int | None = None,
                    prefix: str = "") -> None:
        pass

    def log_image(self, name: str, array, rescale: bool = False) -> None:
        pass

    def log_figure(self, name: str, img1, img2, groundtruth,
                   prediction) -> None:
        pass

    def set_status(self, status: str) -> None:
        pass

    def close(self) -> None:
        pass


def _jsonable(v: Any):
    if hasattr(v, "item"):
        try:
            return v.item()
        except (TypeError, ValueError, RuntimeError):
            pass
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v
