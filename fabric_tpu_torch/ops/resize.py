"""The decoder's 2x upsamples and ``pad_to_match`` for NHWC tensors.

Counterpart of ``fabric_tpu/ops/resize.py``.  The align-corners resize is
two matmuls with (out, in) interpolation matrices, as there, with the same
rounding in a bf16 forward: each matrix is cast to the activation's dtype,
and each matmul's output is rounded to that dtype (``resize.py:49-57``).
A float32 resize's two matmuls run in full float32 on the card whatever the
caller's TF32 setting (``ops/fp32_matmul.py``).  The shift-invariant
local upsample (:func:`upsample2x_local`), which the
fullconv serving mode needs, interleaves each input with the midpoint of
its next neighbour.  These are plain PyTorch ops; ``fabric_tpu`` left them
to XLA, outside any Pallas kernel.

A rank that holds rows of a height-split image (``parallel/spatial.py``)
computes its rows of either upsample from its rows and one row of halo:
:func:`upsample2x_align_corners_rows` takes the rank's rows of the
*global* image's interpolation matrix (a matrix built from the rank's
own height would be another resize), and every output row of a shard
reads input rows within one row of the shard (the source row of output
o is o (h-1)/(2h-1), within half a row of o/2);
:func:`upsample2x_local` takes the next shard's first row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import fp32_matmul


@functools.lru_cache(maxsize=128)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) align-corners linear interpolation matrix."""
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == 1 or out_size == 1:
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    m[rows, lo] += 1.0 - frac
    m[rows, hi] += frac
    return m


@functools.lru_cache(maxsize=128)
def _interp_tensor(out_size: int, in_size: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """:func:`_interp_matrix` on ``device``, copied there once: a copy
    from pageable host memory to the card waits for the card, which would
    stall the host at every upsample.  Made outside inference mode, so a
    training forward may save it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(out_size, in_size)).to(
            device, dtype)


def _interp(out_size: int, in_size: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The cached :func:`_interp_tensor`, except while ``torch.export``
    traces: a tensor made there is the trace's, and must not outlive it in
    the cache (the program holds the matrix as a constant instead)."""
    if torch.compiler.is_exporting():
        return torch.from_numpy(_interp_matrix(out_size, in_size)).to(
            device, dtype)
    return _interp_tensor(out_size, in_size, device, dtype)


def resize_align_corners(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize of an (N, H, W, C) tensor."""
    _, h, w, _ = x.shape
    wh = _interp(out_h, h, x.device, x.dtype)
    ww = _interp(out_w, w, x.device, x.dtype)
    y = fp32_matmul.einsum("nhwc,Hh->nHwc", x, wh)
    return fp32_matmul.einsum("nhwc,Ww->nhWc", y, ww).contiguous()


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear align-corners upsample (the reference decoder's op)."""
    return resize_align_corners(x, 2 * x.shape[1], 2 * x.shape[2])


@functools.lru_cache(maxsize=128)
def _band_tensor(height: int, first: int, rows: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows [2 first, 2 (first + rows)) of the (2 height, height)
    align-corners matrix, over the input rows [first - 1, first + rows +
    1) (a zero column for a row past the image's edge), on ``device``
    once (as :func:`_interp_tensor`)."""
    m = np.zeros((2 * height, height + 2), np.float32)
    m[:, 1:-1] = _interp_matrix(2 * height, height)
    m = np.ascontiguousarray(
        m[2 * first:2 * (first + rows), first:first + rows + 2])
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device, dtype)


def upsample2x_align_corners_rows(x: torch.Tensor, first: int,
                                  height: int) -> torch.Tensor:
    """Rows [2 first, 2 (first + h)) of the 2x align-corners upsample of a
    ``height``-row (N, height, W, C) image, from ``x``: its rows [first -
    1, first + h + 1) (N, h + 2, W, C), zeros past the image's edges.  The
    same products and roundings as :func:`upsample2x_align_corners`."""
    wh = _band_tensor(height, first, x.shape[1] - 2, x.device, x.dtype)
    ww = _interp(2 * x.shape[2], x.shape[2], x.device, x.dtype)
    y = fp32_matmul.einsum("nhwc,Hh->nHwc", x, wh)
    return fp32_matmul.einsum("nhwc,Ww->nhWc", y, ww).contiguous()


def _up1d_local(x: torch.Tensor, axis: int,
                after: torch.Tensor | None = None) -> torch.Tensor:
    """Shift-invariant 2x upsample along ``axis``: even outputs copy the
    inputs, odd outputs are the midpoints ``(x[i] + x[i+1]) * 0.5`` taken
    in float32 and rounded once to x's dtype; the last one reads
    ``after``, the row past x's end (default: clamped to the edge, x[-1]
    twice)."""
    n = x.shape[axis]
    if after is None:
        after = x.narrow(axis, n - 1, 1)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), after], dim=axis)
    mid = ((x.float() + nxt.float()) * 0.5).to(x.dtype)
    shape = list(x.shape)
    shape[axis] *= 2
    return torch.stack([x, mid], dim=axis + 1).reshape(shape)


def upsample2x_local(x: torch.Tensor,
                     after: torch.Tensor | None = None) -> torch.Tensor:
    """Shift-invariant bilinear 2x upsample of an (N, H, W, C) or (H, W, C)
    tensor: ``out[2i] = x[i]``, ``out[2i+1] = (x[i] + x[i+1]) / 2`` along
    each spatial axis, edge-clamped at the far end; ``after`` is the row
    that follows x's last in H (a height-split image's next shard's first
    row; default: the edge clamp).  Unlike the align-corners grid it
    commutes with crops at even offsets, which lets ``infer/fullconv.py``
    run the network over halo-extended scene bands and reproduce a
    whole-scene forward exactly.  Differentiable."""
    return _up1d_local(_up1d_local(x, x.dim() - 3, after), x.dim() - 2)


def pad_to_match(x: torch.Tensor, target_h: int,
                 target_w: int) -> torch.Tensor:
    """Zero-pad NHWC spatial dims to a target, split like torch ``F.pad`` in
    the reference Up block: ``diff//2`` before, ``diff - diff//2`` after."""
    dh = target_h - x.shape[1]
    dw = target_w - x.shape[2]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
