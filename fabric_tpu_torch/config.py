"""Run configuration: the dataclass, JSON loading and CLI overrides.

A copy of ``fabric_tpu/config.py``: every field with the same name,
default and ``__post_init__``, the same precedence (dataclass defaults <
JSON file < ``overrides`` < CLI arguments), the same per-type CLI parsing
(``--augmentation yes`` is True, ``--learning_rate 0.01`` a float, lists
and dicts JSON literals), and unknown keys ignored, so one JSON config file
drives both packages.  Fields of ``fabric_tpu`` modes that the port has
not taken over yet are carried all the same; the code that would read them
raises ``NotImplementedError`` when they are set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

import numpy as np

# Per-band normalisation statistics of OSCD/Onera (dataset statistics, as
# in fabric_tpu's config).
DEFAULT_BAND_IDS = [
    "B01", "B02", "B03", "B04", "B05", "B06", "B07", "B08", "B8A",
    "B09", "B10", "B11", "B12",
]
DEFAULT_BAND_MEANS = {
    "B01": 1617.5661643050978, "B02": 1422.3719453248793,
    "B03": 1359.3729378266555, "B04": 1414.6782051630655,
    "B05": 1557.9375814996074, "B06": 1986.2235117016169,
    "B07": 2210.5037144727444, "B08": 2118.5600261598356,
    "B09": 711.83906025521844, "B10": 15.75398180230429,
    "B11": 2133.9020389587163, "B12": 1584.2672746823432,
    "B8A": 2344.7920358515848,
}
DEFAULT_BAND_STDS = {
    "B01": 319.11895245135725, "B02": 456.24958899714318,
    "B03": 590.13027145320575, "B04": 849.36709395436458,
    "B05": 811.31234423936974, "B06": 813.54673546588663,
    "B07": 891.84688914609933, "B08": 901.61466840470621,
    "B09": 370.95321479704359, "B10": 9.2311736178846093,
    "B11": 1116.5923795237484, "B12": 985.12262217902412,
    "B8A": 954.76957663021938,
}


@dataclasses.dataclass
class Config:
    """All run configuration (field names as in ``fabric_tpu.config``)."""

    # dataset statistics / ingestion
    band_ids: list = dataclasses.field(
        default_factory=lambda: list(DEFAULT_BAND_IDS))
    band_means: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_BAND_MEANS))
    band_stds: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_BAND_STDS))
    stretch_8bit: dict = dataclasses.field(
        default_factory=lambda: {"lower": 2, "higher": 98})
    patch_size: int = 90
    stride: int = 180
    augmentation: bool = True
    # host / loader (num_gpus is accepted and ignored, as in fabric_tpu)
    num_gpus: int = 1
    num_workers: int = 2
    # optimisation
    epochs: int = 1
    batch_size: int = 32
    learning_rate: float = 0.001
    # bce | wbce | focal | dice | jaccard | tversky
    loss_function: str = "tversky"
    tversky_alpha: float = 0.1
    tversky_beta: float = 0.9
    focal_gamma: float = 2.0
    bce_pos_weight: float = 1.0
    # experiment / paths
    project_name: str = "ChangeDetection"
    dataset_name: str = "onera_w_mask.tar.gz"
    validation_cities: list = dataclasses.field(
        default_factory=lambda: ["cupertino", "rennes"])
    dataset_dir: str = "./onera/"
    weight_dir: str = "./outputs/"
    log_dir: str = "./log/"
    # model, numerics, optimiser and run control
    model: str = "bidate"     # bidate | unet_lstm | unet3d
    model_base: int = 0       # encoder width; 0 = architecture default (64)
    num_dates: int = 2
    dtype: str = "bfloat16"   # compute dtype; params stay float32
    sync_batchnorm: bool = False
    seed: int = 0
    optimizer: str = "sgd"    # sgd | adam | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    lr_schedule: str = "constant"  # constant | cosine | linear
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    grad_accum_steps: int = 1
    mesh_data: int = -1
    mesh_spatial: int = 1
    mesh_model: int = 1
    resume: str = ""          # checkpoint file or directory ("" = fresh)
    output_store: str = ""
    checkpoint_every: int = 0  # periodic saves every N steps (0 = off)
    keep_last: int = 3
    handle_preemption: bool = True
    prefetch: int = 2         # batches prepared ahead of the device
    use_pallas: bool = False
    remat: bool = False
    lane_pack: bool = False
    lane_pack_bwd: bool = False
    local_upsample: bool = False
    compat_reference_losses: bool = False
    per_date_batchnorm: bool = False
    compat_reference: bool = False
    eval_batch_size: int = 0  # 0 = use batch_size
    log_every: int = 0
    infer_overlap: int = 0    # overlap (px) for overlap-averaged stitching
    steps_per_epoch: int = 0  # 0 = full pass; >0 caps batches per epoch
    shuffle_train: bool = True
    profile_dir: str = ""
    profile_steps: int = 5

    def __post_init__(self) -> None:
        if self.eval_batch_size == 0:
            self.eval_batch_size = self.batch_size
        if self.compat_reference:
            self.compat_reference_losses = True
            self.per_date_batchnorm = True
        if isinstance(self.stretch_8bit, (list, tuple)):
            self.stretch_8bit = {"lower": self.stretch_8bit[0],
                                 "higher": self.stretch_8bit[1]}

    @property
    def n_channels(self) -> int:
        return len(self.band_ids)

    @property
    def n_classes(self) -> int:
        return 2

    def band_stats_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(means, stds) as float32 arrays ordered by band_ids."""
        means = np.array([self.band_means[b] for b in self.band_ids],
                         np.float32)
        stds = np.array([self.band_stds[b] for b in self.band_ids],
                        np.float32)
        return means, stds

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


# field type name -> argparse type; lists and dicts take JSON literals
_ARG_TYPES = {"int": int, "float": float, "bool": _parse_bool, "str": str}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="fabric_tpu_torch: change-detection training and serving")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file (fabric_tpu compatible)")
    for f in dataclasses.fields(Config):
        parser.add_argument("--" + f.name,
                            type=_ARG_TYPES.get(f.type, json.loads),
                            default=None)
    return parser


def load_config(argv: list[str] | None = None,
                json_path: str | None = None,
                overrides: dict[str, Any] | None = None) -> Config:
    """Build a Config from (lowest to highest precedence): dataclass
    defaults < JSON file < ``overrides`` dict < CLI args.  Unknown JSON keys
    are ignored."""
    args = build_parser().parse_args(argv if argv is not None else [])
    path = args.config or json_path
    merged: dict[str, Any] = {}
    if path:
        with open(path) as fin:
            merged.update(json.load(fin))
    if overrides:
        merged.update(overrides)
    names = {f.name for f in dataclasses.fields(Config)}
    merged.update({k: v for k, v in vars(args).items()
                   if k in names and v is not None})
    return Config.from_dict(merged)
