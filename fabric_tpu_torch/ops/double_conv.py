"""Fused DoubleConv: two 3x3 conv + bias + ReLU with the intermediate kept
on the SM (inference, BatchNorm folded).

Counterpart of ``fabric_tpu/ops/pallas_double_conv.py:
double_conv3x3_bias_relu``, in x's dtype as there.  On a CUDA tensor
:func:`double_conv3x3_bias_relu` launches the kernel of x's dtype:
``csrc/double_conv3x3_bias_relu.cu`` (bf16) or
``csrc/double_conv3x3_bias_relu_f32.cu`` (float32, 3xTF32; counted on
``double_conv3x3_bias_relu.launches_f32``): in bf16 G whole images per
block with the G x (H+2) x (W+2) x Cmid intermediate in its shared memory,
in float32 G whole images per cluster of blocks, each holding a slice of
the intermediate's channels (see their headers); on a CPU tensor it
computes :func:`double_conv3x3_bias_relu_reference`.  :func:`plan` and
:func:`plan_f32` lay a block out within the shared-memory budget
(:func:`fits`); :func:`supports`, the callers' gate, adds where the fused
kernel beat two :func:`~fabric_tpu_torch.ops.conv.conv3x3_bias_relu`
launches on the H100.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fabric_tpu_torch.ops import _build
from fabric_tpu_torch.ops.conv import (KB, KC, K_STEP_F32, MAX_SMEM,
                                       _round_up, check_operands,
                                       check_packed,
                                       conv3x3_bias_relu_reference, n_tile,
                                       pack_weight, pack_weight_f32,
                                       patch_bytes, tile_geometry)


class Plan(NamedTuple):
    """A block of the fused kernel: M chunks of geometry (tw, tr, ni)
    (log2s), ``group`` = 2**ni images per block, the two warpgroups on
    separate N tiles (``split_n``, 64-pixel chunks) or separate rows
    (128-pixel chunks), ``stages`` ring slots, ``smem`` bytes."""
    tw: int
    tr: int
    ni: int
    group: int
    split_n: bool
    stages: int
    smem: int


def smem_bytes(h: int, w: int, cmid: int, cout: int, split_n: bool,
               stages: int) -> int:
    """Shared memory one block needs (fabric_double_conv_smem_bytes in the
    CUDA source): the weight ring, two staged input patches, the
    intermediate of the block's images with its zero frame (channels
    rounded up to 16 plus 8 of bank padding) and the ring's barriers."""
    geo = tile_geometry(h, w, 64 if split_n else 128)
    stage = max(n_tile(cmid), n_tile(cout)) * KC * 2 * (2 if split_n else 1)
    inter = _round_up((1 << geo[2]) * (h + 2) * (w + 2)
                      * (_round_up(cmid, 16) + 8) * 2, 128)
    return stages * stage + 2 * patch_bytes(geo) + inter + 16 * stages


def plan(h: int, w: int, cin: int, cmid: int, cout: int) -> Plan | None:
    """The block layout for this DoubleConv, or None where none fits 227
    KB: 128-pixel chunks if they fit, else 64-pixel ones (fewer images per
    block); 4 ring slots if they fit, else 3."""
    if min(h, w, cin, cmid, cout) <= 0:
        return None
    for split_n in (False, True):
        tw, tr, ni = tile_geometry(h, w, 64 if split_n else 128)
        for stages in (4, 3):
            smem = smem_bytes(h, w, cmid, cout, split_n, stages)
            if smem <= MAX_SMEM:
                return Plan(tw, tr, ni, 1 << ni, split_n, stages, smem)
    return None


class PlanF32(NamedTuple):
    """A cluster of the float32 fused kernel: ``group`` whole images in an
    M chunk of geometry (tw, tr, ni) (log2s; several chunks where an
    image is taller or wider than one), ``cluster`` blocks, each holding
    ``tiles1`` of conv1's N tiles of ``pn1`` channels (that slice of the
    intermediate), ``stages`` ring slots, ``smem`` bytes a block."""
    tw: int
    tr: int
    ni: int
    group: int
    tiles1: int
    cluster: int
    pn1: int
    pn2: int
    stages: int
    smem: int


MAX_CLUSTER = 8  # blocks of a cluster the H100 schedules portably


def smem_bytes_f32(h: int, w: int, cmid: int, cout: int, group: int,
                   tiles1: int, stages: int) -> int:
    """Shared memory one float32 block needs
    (fabric_double_conv_f32_smem_bytes in the CUDA source): the ring
    (``stages`` slots of a hi and a lo block of the wider conv's N tile x
    16 fp32 channels), two staged patches of the chunk geometry, the
    block's slice of the intermediate (``group`` images x H x W x (tiles1
    * pn1 + 4) floats, rounded to 128 bytes) and the ring's barriers."""
    geo = tile_geometry(h, w)
    pn1 = n_tile(cmid)
    stage = 2 * max(pn1, n_tile(cout)) * KB
    inter = _round_up(group * h * w * (tiles1 * pn1 + 4) * 4, 128)
    return stages * stage + 2 * patch_bytes(geo) + inter + 16 * stages


def plan_f32(h: int, w: int, cin: int, cmid: int,
             cout: int) -> PlanF32 | None:
    """The float32 cluster layout, or None where none fits 227 KB a block:
    images of at most 128 pixels (the conv kernel's M chunk), at most 8
    blocks a cluster.  The most conv1 N tiles a block (the fewest blocks a
    cluster) whose block holds a whole chunk's images with 3 or 4 ring
    slots (on the H100, 2 tiles a block beat 1 by 4-32% at down3, down4
    and up1, and 4 did not fit a chunk), else one tile a block with the
    most images of a chunk and the most ring slots, 4 to 2, that fit."""
    if min(h, w, cin, cmid, cout) <= 0 or h * w > 128:
        return None
    pn1, pn2 = n_tile(cmid), n_tile(cout)
    n_t1 = -(-cmid // pn1)
    tw, tr, ni = tile_geometry(h, w)

    def plan(tiles1, groups, stage_counts):
        cluster = -(-n_t1 // tiles1)
        if cluster > MAX_CLUSTER:
            return None
        for group in groups:
            for stages in stage_counts:
                smem = smem_bytes_f32(h, w, cmid, cout, group, tiles1,
                                      stages)
                if smem <= MAX_SMEM:
                    return PlanF32(tw, tr, ni, group, tiles1, cluster, pn1,
                                   pn2, stages, smem)
        return None
    for t in range(n_t1, 1, -1):
        p = plan(t, (1 << ni,), (4, 3))
        if p is not None:
            return p
    return plan(1, range(1 << ni, 0, -1), (4, 3, 2))


def fits(h: int, w: int, cin: int, cmid: int, cout: int,
         dtype: torch.dtype = torch.bfloat16) -> bool:
    """Can the fused kernel of ``dtype`` run this block at all (shared
    memory)?"""
    if dtype == torch.float32:
        return plan_f32(h, w, cin, cmid, cout) is not None
    return plan(h, w, cin, cmid, cout) is not None


# (H, W, Cin, Cmid, Cout) of the DoubleConv blocks where the fused float32
# kernel was no slower than two float32 conv launches on the H100 (the
# ``gate f32`` lines of chip_smoke.py): none.  At the levels of a 256-tile
# forward at patch 64 where its cluster fits (down3, down4, up1) it took
# 1.10-1.27x as long: the intermediate's round trip it saves is ~1% of
# the two convs' time, less than what its serial conv1 -> conv2 chain
# and the cluster's staging cost.
F32_FUSED_SHAPES: frozenset = frozenset()


def supports(h: int, w: int, cin: int, cmid: int, cout: int,
             dtype: torch.dtype = torch.bfloat16) -> bool:
    """The callers' gate.  bf16: the fused kernel where it fits and both
    convs are wider than 64 channels.  On the H100 (chip_smoke.py, both
    ways at each level of a 256-tile forward at patch 64) it beat two conv
    launches at down2-4 and up2 and tied at up1 (128-512 channels), and
    lost at up3 (64 channels: wgmma N = 64 with one block per SM, where
    the separate convs run three).  float32: the shapes in
    F32_FUSED_SHAPES, where the fused 3xTF32 kernel was no slower than two
    float32 conv launches on the H100, and only where its cluster fits
    (:func:`plan_f32`); none so far, so the float32 DoubleConvs run as two
    conv launches."""
    if dtype == torch.float32:
        return ((h, w, cin, cmid, cout) in F32_FUSED_SHAPES
                and plan_f32(h, w, cin, cmid, cout) is not None)
    return fits(h, w, cin, cmid, cout) and min(cmid, cout) > 64


def double_conv3x3_bias_relu_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version: two fp32 convs, the intermediate rounded to
    x's dtype between them, as the kernel keeps it.  For float32 x nothing
    is rounded but the fp32 sums: no bf16 step anywhere."""
    return conv3x3_bias_relu_reference(
        conv3x3_bias_relu_reference(x, w1, b1), w2, b2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("double_conv3x3_bias_relu")
    fn = lib.fabric_double_conv3x3_bias_relu
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("double_conv3x3_bias_relu_f32")
    fn = lib.fabric_double_conv3x3_bias_relu_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_f32(x, w1, b1, w2, b2, w1pk, w2pk) -> torch.Tensor:
    """Launch csrc/double_conv3x3_bias_relu_f32.cu on validated operands
    (counted)."""
    n, h, w, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    p = plan_f32(h, w, cin, cmid, cout)
    if p is None:
        raise ValueError(
            f"double_conv3x3_bias_relu: a float32 cluster of {h}x{w} images "
            f"with {cmid} intermediate channels does not fit {MAX_SMEM} "
            f"bytes of shared memory a block; run it as two "
            f"conv3x3_bias_relu launches")
    if w1pk is None or w2pk is None:
        w1pk, w2pk = pack_weight_f32(w1), pack_weight_f32(w2)
    check_packed(w1pk, w1, torch.float32)
    check_packed(w2pk, w2, torch.float32)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    y = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    lib = _lib_f32()
    with _build.on_device(x.get_device()):
        err = lib.fabric_double_conv3x3_bias_relu_f32(
            x.data_ptr(), w1pk.data_ptr(), b1f.data_ptr(), w2pk.data_ptr(),
            b2f.data_ptr(), y.data_ptr(), n, h, w, cin, cmid, cout,
            _round_up(cin, K_STEP_F32), _round_up(cmid, K_STEP_F32), p.pn1,
            p.pn2, p.tw, p.tr, p.ni, p.group, p.tiles1, p.cluster, p.stages,
            _build.raw_stream(x.get_device()))
    _build.check(lib, err, "double_conv3x3_bias_relu_f32")
    double_conv3x3_bias_relu.launches_f32 += 1
    return y


def _launch(x, w1, b1, w2, b2, w1pk, w2pk) -> torch.Tensor:
    """Validate and launch the kernel of x's dtype (counted):
    csrc/double_conv3x3_bias_relu.cu or its float32 form."""
    check_operands(x, [w1, w2], [b1, b2])
    if x.dtype == torch.float32:
        return _launch_f32(x, w1, b1, w2, b2, w1pk, w2pk)
    n, h, w, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    p = plan(h, w, cin, cmid, cout)
    if p is None:
        raise ValueError(
            f"double_conv3x3_bias_relu: a block of {h}x{w} images with "
            f"{cmid} intermediate channels does not fit {MAX_SMEM} bytes of "
            f"shared memory; run it as two conv3x3_bias_relu launches")
    if w1pk is None or w2pk is None:
        w1pk, w2pk = pack_weight(w1), pack_weight(w2)
    check_packed(w1pk, w1)
    check_packed(w2pk, w2)
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    with _build.on_device(x.get_device()):
        err = lib.fabric_double_conv3x3_bias_relu(
            x.data_ptr(), w1pk.data_ptr(), b1f.data_ptr(), w2pk.data_ptr(),
            b2f.data_ptr(), y.data_ptr(), n, h, w, cin, cmid, cout,
            _round_up(cin, 16), n_tile(cmid), n_tile(cout), p.tw, p.tr, p.ni,
            p.group, int(p.split_n), p.stages,
            _build.raw_stream(x.get_device()))
    _build.check(lib, err, "double_conv3x3_bias_relu")
    double_conv3x3_bias_relu.launches += 1
    return y


@torch.library.custom_op("fabric_tpu_torch::double_conv3x3_bias_relu",
                         mutates_args=(), device_types="cuda")
def double_conv3x3_bias_relu_op(x: torch.Tensor, w1: torch.Tensor,
                                b1: torch.Tensor, w2: torch.Tensor,
                                b2: torch.Tensor,
                                w1_packed: torch.Tensor | None,
                                w2_packed: torch.Tensor | None
                                ) -> torch.Tensor:
    """The kernel as a custom op (what an exported program calls): the
    launch on CUDA, the plain version on the CPU."""
    return _launch(x, w1, b1, w2, b2, w1_packed, w2_packed)


@double_conv3x3_bias_relu_op.register_kernel("cpu")
def _(x, w1, b1, w2, b2, w1_packed, w2_packed):
    return double_conv3x3_bias_relu_reference(x, w1, b1, w2, b2)


@double_conv3x3_bias_relu_op.register_fake
def _(x, w1, b1, w2, b2, w1_packed, w2_packed):
    return x.new_empty(tuple(x.shape[:3]) + (w2.shape[3],))


def double_conv3x3_bias_relu(x: torch.Tensor, w1: torch.Tensor,
                             b1: torch.Tensor, w2: torch.Tensor,
                             b2: torch.Tensor,
                             packed: tuple | None = None) -> torch.Tensor:
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2), SAME padding, in
    x's dtype (bf16 or float32 on the card).  x: (N, H, W, Cin); w1: (3,
    3, Cin, Cmid); w2: (3, 3, Cmid, Cout); ``packed``: ``(pack_weight(w1,
    x.dtype), pack_weight(w2, x.dtype))``, made here when None.  On the
    card, raises where :func:`fits` fails for x's dtype.  Under
    ``torch.export`` the call is the custom op."""
    w1pk, w2pk = packed if packed is not None else (None, None)
    if torch.compiler.is_exporting():
        return double_conv3x3_bias_relu_op(x, w1, b1, w2, b2, w1pk, w2pk)
    if x.device.type == "cpu":
        return double_conv3x3_bias_relu_reference(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2, w1pk, w2pk)


double_conv3x3_bias_relu.launches = 0      # the bf16 kernel's
double_conv3x3_bias_relu.launches_f32 = 0  # the float32 kernel's
