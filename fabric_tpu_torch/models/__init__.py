"""Model factory (counterpart of ``fabric_tpu/models/__init__.py``)."""

from __future__ import annotations

import logging

import torch

from fabric_tpu_torch import weights
from fabric_tpu_torch.models.bidate import BiDateNet  # noqa: F401
from fabric_tpu_torch.models.blocks import (  # noqa: F401
    DoubleConv, Down, OutConv, Up)
from fabric_tpu_torch.models.unet3d import UNet3D  # noqa: F401
from fabric_tpu_torch.models.unet_lstm import (  # noqa: F401
    ConvLSTMCell, UNetLSTM)

MULTI_DATE = ("unet_lstm", "unet3d")


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def build_model(cfg, device, generator: torch.Generator | None = None,
                fold_bn: bool = True, variables: tuple | None = None,
                train: bool = False,
                local_upsample: bool | None = None,
                folded: dict | None = None) -> torch.nn.Module:
    """The ``cfg.model`` network (BiDateNet, base 64 by default; UNetLSTM,
    base 64; UNet3D, base 32) on ``device``.

    Weights come from ``variables`` (a ``fabric_tpu`` (params,
    batch_stats) tree, e.g. from a checkpoint) or, when it is None, from
    fresh initialisation drawn with ``generator`` (a CPU
    ``torch.Generator``; a new one seeded 0 when None).  For serving
    (``train=False``) the model is in eval mode without gradients, with
    BatchNorm folded into the convs when ``fold_bn``.  With ``train`` it
    keeps BatchNorm (``fold_bn`` must be False) and its parameters take
    gradients.  ``cfg.per_date_batchnorm`` (per-date batch statistics)
    and ``cfg.remat`` (rematerialised stages) reach BiDateNet only: a
    multi-date model trains without them, as in ``fabric_tpu``
    (``fabric_tpu/models/__init__.py:21-46``).  ``local_upsample`` (None:
    ``cfg.local_upsample``) gives the decoder the shift-invariant
    upsample that fullconv serving needs; it adds no parameter.
    ``folded`` (instead of ``variables``): an already BatchNorm-folded
    params tree, a serving bundle's, loaded as it is into the folded
    model (``fold_bn`` must be True).
    ``cfg.lane_pack`` / ``cfg.lane_pack_bwd`` (space-to-depth convs,
    ``ops/s2d_conv.py``) reach BiDateNet only, as in ``fabric_tpu``; a
    folded model serves on the conv kernels whatever they say.
    ``cfg.sync_batchnorm`` is never read: in data-parallel training the
    batch statistics are the global batch's whatever it says
    (``models/blocks.BatchNorm``), and it logs ``fabric_tpu``'s warning."""
    if cfg.model not in ("bidate",) + MULTI_DATE:
        raise ValueError(f"unknown model: {cfg.model!r}")
    if getattr(cfg, "sync_batchnorm", False):
        logging.getLogger("fabric_tpu_torch").warning(
            "sync_batchnorm=True is a no-op under jit SPMD: BN batch "
            "statistics are already computed over the global batch")
    if train and fold_bn:
        raise ValueError("a model built for training keeps BatchNorm: pass "
                         "fold_bn=False")
    base = cfg.model_base or (32 if cfg.model == "unet3d" else 64)
    if folded is not None and (variables is not None or not fold_bn):
        raise ValueError("folded weights build a folded model, without "
                         "variables")
    if variables is None and folded is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        variables = weights.init_variables(cfg.n_channels, cfg.n_classes,
                                           base, generator, cfg.model)
    dtype = compute_dtype(cfg)
    if local_upsample is None:
        local_upsample = cfg.local_upsample
    if cfg.model == "bidate":
        model = BiDateNet(cfg.n_channels, cfg.n_classes, base,
                          fold_bn=fold_bn, dtype=dtype,
                          joint_date_batchnorm=not cfg.per_date_batchnorm,
                          remat=cfg.remat, local_upsample=local_upsample,
                          lane_pack=cfg.lane_pack,
                          lane_pack_bwd=cfg.lane_pack_bwd)
    else:
        net = UNetLSTM if cfg.model == "unet_lstm" else UNet3D
        model = net(cfg.n_channels, cfg.n_classes, base, fold_bn=fold_bn,
                    dtype=dtype, local_upsample=local_upsample)
    if folded is not None:
        weights.load_folded(model, folded)
    else:
        weights.load_variables(model, *variables)
    model.requires_grad_(train)
    model = model.to(device).train(train)
    for m in model.modules():  # pack the serving kernels' weights once
        if isinstance(m, DoubleConv) and m.fold_bn:
            m.packed_kernels(dtype)
        elif isinstance(m, ConvLSTMCell) and m.exact_crops and not train:
            m.signed_gates(dtype)
    return model
