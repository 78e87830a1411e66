"""On-device whole-scene inference: tile, predict, stitch (counterpart of
``fabric_tpu/infer/device_tiling.py``).

The scene is uploaded once; tiles are cut, run through the model in
chunks of ``batch_size`` (the last zero-padded), and stitched back, all on
the scene's device.  Tile positions are the reference grid: a stride grid
with a last row, column and corner anchored at the far edge.

- Grid mode (overlap 0, stride = patch): argmax per tile, pasted with the
  reference's overwrite precedence (grid, then the right column band, the
  bottom row band, and the corner).
- Overlap mode (stride = patch - overlap): the softmax class-1
  probability of each tile's float32 logits, summed on an fp32 canvas
  coset by coset (:func:`_coset_overlap_add`, in ``fabric_tpu``'s order,
  so the sums round the same), divided by the covering count and
  thresholded at 0.5.  :func:`make_banded_overlap_infer` does the same in
  bands of tile rows, with one band's tiles live at a time.
- Fleet packing (:func:`make_packed_scene_infer`): grid mode over several
  same-size scenes whose tiles share the chunks; every kernel computes
  each image on its own, so each scene's mask equals its own run's.

With a ``mesh`` (``parallel/mesh.py``), the grid and overlap runners
split each tile batch over the mesh's data axis, each slice run by the
model's replica on its device (``fabric_tpu``'s ``mesh`` argument); the
scene stays whole on its device (``infer/sharded_scene.py`` splits the
scene itself).

The bi-date runners take ``model(t1, t2)``, the multi-date ones
``model(tiles)`` with (N, T, patch, patch, C) tiles; both return float32
logits (N, patch, patch, classes).
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_positions(size: int, patch: int, stride: int) -> np.ndarray:
    """Reference-style positions: stride grid + final edge-anchored stop."""
    pos = list(range(0, size - patch + 1, stride))
    if pos[-1] != size - patch:
        pos.append(size - patch)
    return np.asarray(pos, np.int32)


def _plan_grid(h: int, w: int, patch: int, stride: int, batch_size: int):
    """Tile-grid plan: positions, tile count, zero-tile padding, chunks."""
    ys = _axis_positions(h, patch, stride)
    xs = _axis_positions(w, patch, stride)
    k = len(ys) * len(xs)
    pad = (-k) % batch_size
    return ys, xs, k, pad, (k + pad) // batch_size


def _is_grid_with_edge(positions: np.ndarray, patch: int) -> bool:
    """True when the positions are the patch grid except (at most) an
    edge-anchored last stop: grid mode on any scene."""
    return all(int(p) == i * patch for i, p in enumerate(positions[:-1]))


def _edges(ys: np.ndarray, xs: np.ndarray, patch: int):
    """Whether each axis ends in an edge-anchored stop off the grid."""
    return (int(ys[-1]) != (len(ys) - 1) * patch,
            int(xs[-1]) != (len(xs) - 1) * patch)


def _gather_tiles(scene: torch.Tensor, ys: np.ndarray, xs: np.ndarray,
                  patch: int) -> torch.Tensor:
    """(K, patch, patch, C) tiles, in row-major position order, from an
    (H, W, C) scene.  On the grid (at most one edge stop per axis) the
    tile stack is four static blocks (grid, right column, bottom row,
    corner), each a reshape/permute; overlapping positions take the
    general gather, rows then columns."""
    c = scene.shape[-1]
    ny, nx = len(ys), len(xs)
    if not (_is_grid_with_edge(ys, patch) and _is_grid_with_edge(xs, patch)):
        offs = np.arange(patch)
        rows = torch.as_tensor((ys[:, None] + offs).reshape(-1),
                               device=scene.device)
        cols = torch.as_tensor((xs[:, None] + offs).reshape(-1),
                               device=scene.device)
        t = scene.index_select(0, rows).index_select(1, cols)
        return t.reshape(ny, patch, nx, patch, c).permute(
            0, 2, 1, 3, 4).reshape(-1, patch, patch, c)
    y_edge, x_edge = _edges(ys, xs, patch)
    ny_reg, nx_reg = ny - y_edge, nx - x_edge
    y0, x0 = int(ys[-1]), int(xs[-1])

    def block(sub, a, b):  # (a*p, b*p, C) -> (a, b, p, p, C)
        return sub.reshape(a, patch, b, patch, c).permute(0, 2, 1, 3, 4)

    top = block(scene[:ny_reg * patch, :nx_reg * patch], ny_reg, nx_reg)
    if x_edge:
        right = block(scene[:ny_reg * patch, x0:x0 + patch], ny_reg, 1)
        top = torch.cat([top, right], dim=1)
    if y_edge:
        bot = block(scene[y0:y0 + patch, :nx_reg * patch], 1, nx_reg)
        if x_edge:
            corner = block(scene[y0:y0 + patch, x0:x0 + patch], 1, 1)
            bot = torch.cat([bot, corner], dim=1)
        top = torch.cat([top, bot], dim=0)
    return top.reshape(-1, patch, patch, c)


def _coset_overlap_add(tiles: torch.Tensor, ys: np.ndarray, xs: np.ndarray,
                       h: int, w: int, patch: int,
                       stride: int) -> torch.Tensor:
    """Sum (len(ys), len(xs), patch, patch) float32 tiles at their
    positions onto an (h, w) canvas.  Tiles whose positions are congruent
    mod m = ceil(patch / stride) grid steps never overlap, so each such
    coset (and each edge stop, alone) is one strip added to the canvas:
    at most (m + 1)^2 adds a pixel.  The cosets go in ``fabric_tpu``'s
    order (rows' groups outer, regular cosets before the edge stop), so
    every pixel's fp32 sum is taken in the same order; a strip adds only
    where it lies (``fabric_tpu`` adds zeros elsewhere, which changes no
    sum of non-negative terms)."""
    m = -(-patch // stride)  # grid steps between non-overlapping positions
    d = m * stride

    def groups(pos: np.ndarray) -> list[np.ndarray]:
        reg = [i for i, p in enumerate(pos) if p == i * stride]
        out = [np.asarray(reg[r::m]) for r in range(min(m, len(reg)))]
        out.extend(np.asarray([i]) for i in range(len(pos)) if i not in reg)
        return [g for g in out if len(g)]

    acc = torch.zeros((h, w), dtype=torch.float32, device=tiles.device)
    for gy in groups(ys):
        for gx in groups(xs):
            sub = tiles[torch.as_tensor(gy, device=tiles.device)][
                :, torch.as_tensor(gx, device=tiles.device)]
            a, b = len(gy), len(gx)
            y0, x0 = int(ys[gy[0]]), int(xs[gx[0]])
            # successive positions in a coset differ by d: each tile padded
            # to (d, d) and unfolded is a contiguous strip from (y0, x0)
            strip = torch.nn.functional.pad(sub, (0, d - patch, 0, d - patch))
            strip = strip.permute(0, 2, 1, 3).reshape(a * d, b * d)
            sh, sw = min(a * d, h - y0), min(b * d, w - x0)
            acc[y0:y0 + sh, x0:x0 + sw] += strip[:sh, :sw]
    return acc


def _overlap_sums(probs: torch.Tensor, ys, xs, h: int, w: int, patch: int,
                  stride: int):
    """(probability sum, covering count) canvases of the first
    len(ys) * len(xs) tile probabilities."""
    grid2d = probs[:len(ys) * len(xs)].float().reshape(len(ys), len(xs),
                                                       patch, patch)
    return (_coset_overlap_add(grid2d, ys, xs, h, w, patch, stride),
            _coset_overlap_add(torch.ones_like(grid2d), ys, xs, h, w, patch,
                               stride))


def _threshold(acc: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    return (acc / torch.clamp(cnt, min=1.0) > 0.5).to(torch.uint8)


def _stitch(outs: torch.Tensor, ys: np.ndarray, xs: np.ndarray, k: int,
            h: int, w: int, patch: int, stride: int | None = None,
            overlap: int = 0) -> torch.Tensor:
    """Stitch the first k (patch, patch) tile outputs onto an (h, w)
    canvas: overlap-averaged probabilities thresholded at 0.5, or argmax
    masks pasted with the reference's overwrite precedence."""
    if overlap:
        return _threshold(*_overlap_sums(outs[:k], ys, xs, h, w, patch,
                                         stride))
    ny, nx = len(ys), len(xs)
    y_edge, x_edge = _edges(ys, xs, patch)
    ny_reg, nx_reg = ny - y_edge, nx - x_edge
    grid2d = outs[:k].reshape(ny, nx, patch, patch)
    canvas = torch.zeros((h, w), dtype=outs.dtype, device=outs.device)
    canvas[:ny_reg * patch, :nx_reg * patch] = grid2d[
        :ny_reg, :nx_reg].permute(0, 2, 1, 3).reshape(ny_reg * patch,
                                                      nx_reg * patch)
    if x_edge:
        x0 = int(xs[-1])
        canvas[:ny_reg * patch, x0:x0 + patch] = grid2d[
            :ny_reg, nx - 1].reshape(ny_reg * patch, patch)
    if y_edge:
        y0 = int(ys[-1])
        canvas[y0:y0 + patch, :nx_reg * patch] = grid2d[
            ny - 1, :nx_reg].permute(1, 0, 2).reshape(patch, nx_reg * patch)
    if y_edge and x_edge:
        canvas[int(ys[-1]):, int(xs[-1]):] = grid2d[ny - 1, nx - 1]
    return canvas


def _run_chunks(model, tiles: tuple, batch_size: int, probs: bool,
                shards: list | None = None) -> torch.Tensor:
    """``model(*chunk)`` over the tile stacks in ``tiles`` (each (K, ...)),
    zero-padded to whole chunks of ``batch_size``: (K + pad, patch, patch)
    class-1 probabilities (float32) or argmax masks (uint8).  ``shards``
    [(device, forward)] splits each chunk into equal slices, slice j run
    by forward j on device j (all launched before the chunk's results are
    gathered on the tiles' device)."""
    k = tiles[0].shape[0]
    pad = (-k) % batch_size
    if pad:
        tiles = tuple(torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                      for t in tiles)
    first = tiles[0]
    outs = torch.empty((k + pad,) + first.shape[-3:-1],
                       dtype=torch.float32 if probs else torch.uint8,
                       device=first.device)

    def reduce(logits):
        return (torch.softmax(logits, dim=-1)[..., 1] if probs
                else logits.argmax(-1))

    shards = shards or [(first.device, model)]
    part = batch_size // len(shards)
    for i in range(0, k + pad, batch_size):
        res = [reduce(fwd(*(t[i + j * part:i + (j + 1) * part].to(
            dev, non_blocking=True) for t in tiles)))
            for j, (dev, fwd) in enumerate(shards)]
        for j, r in enumerate(res):
            outs[i + j * part:i + (j + 1) * part] = r
    return outs
    # slice j of every chunk: its rows, copied to device j up front (a copy
    # waits for the work already queued on its source card), run there,
    # and gathered back once every slice is launched
    part = batch_size // len(shards)
    rows = torch.arange(k + pad, device=first.device).reshape(
        -1, len(shards), part)
    res = []
    for j, (dev, fwd) in enumerate(shards):
        idx = rows[:, j].reshape(-1)
        res.append((idx, [t.index_select(0, idx).to(dev, non_blocking=True)
                          for t in tiles], dev, fwd))
    done = []
    for idx, sub, dev, fwd in res:
        out_j = torch.empty((len(idx),) + first.shape[-3:-1],
                            dtype=outs.dtype, device=dev)
        for i in range(0, len(idx), part):
            out_j[i:i + part] = reduce(fwd(*(t[i:i + part] for t in sub)))
        done.append((idx, out_j))
    for idx, out_j in done:
        outs[idx] = out_j.to(first.device)
    return outs


def _mesh_shards(model, mesh, batch_size: int) -> list | None:
    """[(device, replica)] of the mesh's data axis (None without a mesh);
    the tile batch must divide over it."""
    if mesh is None:
        return None
    from fabric_tpu_torch.infer.sharded_scene import replicas
    devices = mesh.data_devices()
    if batch_size % len(devices):
        raise ValueError(f"batch_size {batch_size} must divide over the "
                         f"{len(devices)}-device data axis")
    reps = replicas(model, devices)
    return [(d, reps[d]) for d in devices]


def _multidate_tiles(scenes: torch.Tensor, ys, xs, patch: int):
    """(K, T, patch, patch, C) tiles of a (T, H, W, C) date stack."""
    return torch.stack([_gather_tiles(s, ys, xs, patch) for s in scenes],
                       dim=1)


def make_scene_infer(model, patch: int, scene_shape: tuple[int, int],
                     batch_size: int = 32, overlap: int = 0,
                     dtype: torch.dtype = torch.bfloat16, mesh=None):
    """Build ``run(scene1, scene2) -> (H, W) uint8 mask`` for (H, W, C)
    scenes on the model's device.  overlap 0: reference grid + overwrite
    stitching of argmax predictions; overlap > 0: stride patch - overlap,
    probability average over the covering tiles, threshold 0.5.
    ``mesh`` (``parallel/mesh.py``): each tile batch is split over the
    data axis's devices, each slice run by the model's replica there
    (``batch_size`` must divide over it); the scene stays whole on its
    device."""
    h, w = scene_shape
    stride = patch - overlap if overlap else patch
    ys, xs, k, _, _ = _plan_grid(h, w, patch, stride, batch_size)
    shards = _mesh_shards(model, mesh, batch_size)

    @torch.inference_mode()
    def run(scene1: torch.Tensor, scene2: torch.Tensor) -> torch.Tensor:
        tiles = tuple(_gather_tiles(s.to(dtype), ys, xs, patch)
                      for s in (scene1, scene2))
        outs = _run_chunks(model, tiles, batch_size, bool(overlap), shards)
        return _stitch(outs, ys, xs, k, h, w, patch, stride, overlap)

    return run


def make_scene_infer_multidate(model, patch: int,
                               scene_shape: tuple[int, int], num_dates: int,
                               batch_size: int = 32, overlap: int = 0,
                               dtype: torch.dtype = torch.bfloat16,
                               mesh=None):
    """Build ``run(scenes) -> (H, W) uint8 mask`` for a (num_dates, H, W,
    C) date stack: :func:`make_scene_infer`'s grid, chunks, stitching and
    ``mesh`` split, each chunk a (N, T, patch, patch, C) stack fed to
    ``model``."""
    h, w = scene_shape
    stride = patch - overlap if overlap else patch
    ys, xs, k, _, _ = _plan_grid(h, w, patch, stride, batch_size)
    shards = _mesh_shards(model, mesh, batch_size)

    @torch.inference_mode()
    def run(scenes: torch.Tensor) -> torch.Tensor:
        if scenes.shape[0] != num_dates:
            raise ValueError(f"expected a ({num_dates}, H, W, C) date "
                             f"stack, got shape {tuple(scenes.shape)}")
        tiles = _multidate_tiles(scenes.to(dtype), ys, xs, patch)
        outs = _run_chunks(model, (tiles,), batch_size, bool(overlap),
                           shards)
        return _stitch(outs, ys, xs, k, h, w, patch, stride, overlap)

    return run


def make_banded_overlap_infer(model, patch: int,
                              scene_shape: tuple[int, int],
                              batch_size: int = 32, overlap: int = 16,
                              band_tile_rows: int = 16,
                              dtype: torch.dtype = torch.bfloat16):
    """Overlap-averaged bi-date inference in bands of ``band_tile_rows``
    tile rows, for scenes whose full tile set does not fit in memory: per
    band, cut its tiles from the band's slab of the scene, run them in
    chunks, and add the band's coset sums of probabilities and counts into
    the (H, W) canvases at its offset.  Only one band's tiles are live.
    The bands are the regular tile rows in groups of ``band_tile_rows``,
    then the edge-anchored stop row (if any) as a band of its own; the
    mask is the unbanded overlap mode's."""
    h, w = scene_shape
    if overlap <= 0:
        raise ValueError("banded mode is for overlap stitching; grid mode "
                         "tiles are disjoint: use make_scene_infer")
    stride = patch - overlap
    ys = _axis_positions(h, patch, stride)
    xs = _axis_positions(w, patch, stride)
    n_reg = len(ys) - (1 if int(ys[-1]) != (len(ys) - 1) * stride else 0)
    bands: list[tuple[int, np.ndarray]] = []
    for b0 in range(0, n_reg, band_tile_rows):
        rows = min(band_tile_rows, n_reg - b0)
        bands.append((b0 * stride, np.arange(rows, dtype=np.int32) * stride))
    if n_reg != len(ys):
        bands.append((int(ys[-1]), np.zeros(1, np.int32)))

    @torch.inference_mode()
    def run(scene1: torch.Tensor, scene2: torch.Tensor) -> torch.Tensor:
        s1, s2 = scene1.to(dtype), scene2.to(dtype)
        acc = torch.zeros((h, w), dtype=torch.float32, device=s1.device)
        cnt = torch.zeros_like(acc)
        for y0, rel_ys in bands:
            sh = int(rel_ys[-1]) + patch
            tiles = tuple(_gather_tiles(s[y0:y0 + sh], rel_ys, xs, patch)
                          for s in (s1, s2))
            probs = _run_chunks(model, tiles, batch_size, True)
            band_acc, band_cnt = _overlap_sums(probs, rel_ys, xs, sh, w,
                                               patch, stride)
            acc[y0:y0 + sh] += band_acc
            cnt[y0:y0 + sh] += band_cnt
        return _threshold(acc, cnt)

    return run


def make_packed_scene_infer(model, patch: int,
                            scene_shape: tuple[int, int], pack: int,
                            batch_size: int = 32,
                            dtype: torch.dtype = torch.bfloat16,
                            num_dates: int = 0):
    """Fleet-packed grid-mode inference: ``pack`` same-size scenes per
    call, their tiles concatenated into one chunked forward, each scene's
    tiles stitched back on their own.  Small scenes alone leave the tile
    batch short (a 512^2 scene has 64 tiles of 64^2); packed, the chunks
    are full.  Returns ``run(s1, s2) -> (pack, H, W)`` with s1, s2 of
    shape (pack, H, W, C) (bi-date, ``num_dates`` 0), or ``run(scenes) ->
    (pack, H, W)`` with scenes of shape (pack, T, H, W, C)."""
    h, w = scene_shape
    ys, xs, k, _, _ = _plan_grid(h, w, patch, patch, batch_size)

    def finish(tiles: tuple) -> torch.Tensor:
        outs = _run_chunks(model, tiles, batch_size, False)
        return torch.stack([_stitch(outs[i * k:(i + 1) * k], ys, xs, k, h,
                                    w, patch) for i in range(pack)])

    if num_dates:
        @torch.inference_mode()
        def run_multidate(scenes: torch.Tensor) -> torch.Tensor:
            if tuple(scenes.shape[:2]) != (pack, num_dates):
                raise ValueError(f"expected ({pack}, {num_dates}, H, W, C) "
                                 f"stacks, got {tuple(scenes.shape)}")
            return finish((torch.cat([
                _multidate_tiles(s.to(dtype), ys, xs, patch)
                for s in scenes]),))

        return run_multidate

    @torch.inference_mode()
    def run(scenes1: torch.Tensor, scenes2: torch.Tensor) -> torch.Tensor:
        return finish(tuple(
            torch.cat([_gather_tiles(s.to(dtype), ys, xs, patch)
                       for s in scenes]) for scenes in (scenes1, scenes2)))

    return run
