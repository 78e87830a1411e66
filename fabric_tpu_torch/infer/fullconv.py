"""Seamless whole-scene inference: the U-Net run fully convolutionally over
halo-extended horizontal bands of the scene (counterpart of
``fabric_tpu/infer/fullconv.py``, its sharded form
:func:`make_sharded_fullconv_infer` included).

The tiled modes predict each pixel from one 64-px tile of context and
leave seams; the network itself is fully convolutional, so it can run on
the whole scene instead.  The scene is processed in bands of
``band_rows`` pixel rows, each extended by a ``halo`` of context rows on
both sides and cropped back after the forward.  Every op of the network
is translation invariant for shifts that are multiples of its total
stride (16 = 4 max-pools): SAME convs, pooling grids aligned by 16-aligned
band starts, and the shift-invariant decoder upsample
(``ops/resize.upsample2x_local``; the align-corners grid of the tiled
modes depends on absolute position, so a model built without
``local_upsample`` is refused).  With a halo that covers the receptive
field the banded mask is exactly a single whole-scene forward's: the
bi-date net's and UNet3D's radius is 109 px (:func:`receptive_field_radius`;
the default halo 128 leaves a stride to spare), UNetLSTM's 109 + 16 T (its
ConvLSTM adds a 3x3 conv at stride 16 per date), so :func:`halo_for`
gives it 128 + 16 T (``fabric_tpu`` keeps 128 for every model, which at T
>= 2 leaves rows of a band short of context).

The plan is ``fabric_tpu``'s: the scene edge-padded to stride alignment;
context windows ``ctx_h = min(hp, band_rows + 2 * halo)`` rows tall,
clamped into ``[0, hp - ctx_h]``; the uniform bands, then a tail band;
``band_batch`` B runs B uniform bands as one (B, ctx_h, W, C) forward
(groups of B, then the remainder); the mask is ``softmax(fp32)[..., 1] >
0.5``.  The runners close over the model (a ``BiDateNet``, ``UNetLSTM``
or ``UNet3D`` built with ``local_upsample``, or an int8 forward of
``infer/quant.py`` made with it): ``run(scene1, scene2)`` and
``run(scenes)`` take tensors on the model's device; the streamed forms
take host arrays (``np.ndarray`` or ``np.memmap``) and never hold the
scene on the card.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STRIDE = 16  # total U-Net downsampling factor (4 max-pools)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _check(model, band_rows: int, halo: int) -> None:
    if band_rows % STRIDE or halo % STRIDE:
        raise ValueError(f"band_rows and halo must be multiples of "
                         f"{STRIDE} (got {band_rows}, {halo})")
    if getattr(model, "local_upsample", True) is False:
        raise ValueError("fullconv banding requires the shift-invariant "
                         "decoder upsample: build the model with "
                         "local_upsample=True (align-corners upsampling "
                         "is position-dependent and does not commute "
                         "with scene crops)")


def receptive_field_radius(model=None, base: int = 4) -> int:
    """Measured receptive-field radius (px) of the bi-date U-Net: perturb
    one input pixel of a 384^2 pair and return how far the eval-mode
    output changes.  Depth-determined, so ``base`` can be tiny; ``model``
    defaults to a float32 ``BiDateNet`` on the CPU with ``local_upsample``
    and weights drawn from a generator seeded 0."""
    from fabric_tpu_torch import weights
    from fabric_tpu_torch.models.bidate import BiDateNet

    if model is None:
        model = BiDateNet(base=base, dtype=torch.float32,
                          local_upsample=True)
        weights.load_variables(model, *weights.init_variables(
            13, 2, base, torch.Generator().manual_seed(0)))
        model.eval()
    h = w = 384
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, h, w, 13).astype(np.float32)).to(next(model.parameters()).device)
    xp = x.clone()
    xp[0, h // 2, w // 2] += 10.0
    with torch.inference_mode():
        changed = (model(xp, xp) != model(x, x)).any(-1)[0].cpu().numpy()
    rows = np.where(changed.any(axis=1))[0]
    cols = np.where(changed.any(axis=0))[0]
    return int(max(abs(rows - h // 2).max(), abs(cols - w // 2).max()))


def halo_for(model: str, num_dates: int = 2) -> int:
    """The halo that covers ``model``'s receptive field with a stride to
    spare: 128 for "bidate" and "unet3d" (radius 109), 128 + 16 T for
    "unet_lstm" (radius 109 + 16 T)."""
    return 128 + (STRIDE * num_dates if model == "unet_lstm" else 0)


def _bands(hp: int, band_rows: int, halo: int) -> tuple[int, list]:
    """(ctx_h, [(y0, rows)]): the context height and the bands of an
    hp-row padded scene, the uniform ones then the tail; one band of hp
    rows where the scene fits one window."""
    ctx_h = min(hp, band_rows + 2 * halo)
    if ctx_h == hp:
        return ctx_h, [(0, hp)]
    n_uniform, tail = divmod(hp, band_rows)
    bands = [(i * band_rows, band_rows) for i in range(n_uniform)]
    if tail:
        bands.append((n_uniform * band_rows, tail))
    return ctx_h, bands


def _window(y0: int, halo: int, hp: int, ctx_h: int) -> int:
    """First row of a band's context window, clamped into the scene."""
    return min(max(y0 - halo, 0), hp - ctx_h)


def _mask(logits: torch.Tensor) -> torch.Tensor:
    """uint8 change mask: softmax of the float32 logits, class 1 > 0.5."""
    return (torch.softmax(logits.float(), dim=-1)[..., 1] > 0.5).to(
        torch.uint8)


def _edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Edge-pad the (H, W) axes of an (..., H, W, C) tensor to (hp, wp)."""
    h, w = x.shape[-3:-1]
    if (h, w) == (hp, wp):
        return x
    rows = torch.arange(hp, device=x.device).clamp_(max=h - 1)
    cols = torch.arange(wp, device=x.device).clamp_(max=w - 1)
    return x.index_select(-3, rows).index_select(-2, cols)


def _run_bands(forward, scenes, groups, ctx_h: int, halo: int, hp: int,
               wp: int) -> torch.Tensor:
    """The (hp, wp) mask of padded scenes (each (hp, wp, C), or (T, hp,
    wp, C) for a date stack) on the device: per group of bands one
    forward over their stacked context windows, each band's kept rows
    pasted at its offset."""
    axis = scenes[0].dim() - 3  # the row axis
    canvas = torch.empty((hp, wp), dtype=torch.uint8,
                         device=scenes[0].device)
    for group in groups:
        starts = [_window(y0, halo, hp, ctx_h) for y0, _ in group]
        ctxs = [torch.stack([s.narrow(axis, cs, ctx_h) for cs in starts])
                for s in scenes]
        m = _mask(forward(*ctxs))
        for i, ((y0, rows), cs) in enumerate(zip(group, starts)):
            canvas[y0:y0 + rows] = m[i, y0 - cs:y0 - cs + rows]
    return canvas


def make_fullconv_scene_infer(model, scene_shape: tuple[int, int],
                              band_rows: int = 1024, halo: int = 128,
                              dtype: torch.dtype = torch.bfloat16,
                              band_batch: int = 1):
    """Build ``run(scene1, scene2) -> (H, W) uint8`` for (H, W, C) scenes
    on the model's device: the seamless change mask, equal to one
    whole-scene forward.  ``band_rows`` and ``halo`` are multiples of 16.
    ``band_batch`` B gathers B consecutive bands into one batched forward
    (activation memory grows with B * (band_rows + 2 * halo) rows); the
    windows and crops are those of the sequential bands and every kernel
    computes each image on its own, so the mask is the same for every
    B."""
    _check(model, band_rows, halo)
    if band_batch < 1:
        raise ValueError(f"band_batch must be >= 1 (got {band_batch})")
    h, w = scene_shape
    hp, wp = _round_up(h, STRIDE), _round_up(w, STRIDE)
    ctx_h, bands = _bands(hp, band_rows, halo)
    uniform = [b for b in bands if b[1] == band_rows] if len(bands) > 1 \
        else []
    groups = [uniform[i:i + band_batch]
              for i in range(0, len(uniform), band_batch)]
    groups += [[b] for b in bands[len(uniform):]]

    @torch.inference_mode()
    def run(scene1: torch.Tensor, scene2: torch.Tensor) -> torch.Tensor:
        scenes = [_edge_pad(s.to(dtype), hp, wp) for s in (scene1, scene2)]
        return _run_bands(model, scenes, groups, ctx_h, halo, hp,
                          wp)[:h, :w]

    return run


def make_sharded_fullconv_infer(model, scene_shape: tuple[int, int], mesh,
                                band_rows: int = 1024, halo: int = 128,
                                dtype: torch.dtype = torch.bfloat16):
    """Seamless inference with the scene H-sharded over ``mesh``'s data
    axis (``fabric_tpu``'s ``make_sharded_fullconv_infer``): each of the n
    shards owns ``big = h / n`` rows on its device and runs the banding
    over them, in sub-bands of ``min(band_rows, big)`` rows, with the
    model's replica there (``infer/sharded_scene.replicas``).

    Unlike the grid shards, a band needs context from its neighbours:
    shard i's buffer holds scene rows ``[i*big - 2*halo, (i+1)*big +
    2*halo)``, its neighbours' ``2*halo`` edge rows copied from their
    devices (``Tensor.to(device, non_blocking=True)``: a peer copy between
    cards), zero rows outside ``[0, h)`` as ``fabric_tpu``'s ``ppermute``
    fills them.  Twice the halo, because a context window is clamped into
    the scene as on one device (``fabric_tpu``'s clamp to ``h - ctx_h``),
    and the edge shards' windows shift inward by up to ``2*halo``; the
    zero rows are never inside a window.  So every kept row sees the
    context of a whole-scene forward and the mask is the single-device
    fullconv mask.

    Needs ``h % n == 0`` and ``big`` a multiple of 16 and at least
    ``2*halo`` (``ScenePredictor`` aligns its buckets to ``n * 256``).
    With n = 1 it is :func:`make_fullconv_scene_infer` on the mesh's
    device.  ``run(scene1, scene2) -> (H, W) uint8`` (a host tensor) takes
    ``put_scene_sharded`` band lists or whole (H, W, C) arrays."""
    from fabric_tpu_torch.infer.sharded_scene import (as_bands, gather_bands,
                                                      replicas)

    h, w = scene_shape
    n = mesh.shape["data"]
    devices = mesh.data_devices()
    if n == 1:
        inner = make_fullconv_scene_infer(
            replicas(model, devices)[devices[0]], scene_shape,
            band_rows=band_rows, halo=halo, dtype=dtype)

        def run_one(scene1, scene2) -> torch.Tensor:
            b1, b2 = (as_bands(s, mesh, dtype)[0] for s in (scene1, scene2))
            return inner(b1, b2).cpu()

        return run_one
    _check(next(iter(model.values())) if isinstance(model, dict) else model,
           band_rows, halo)
    if h % n:
        raise ValueError(f"H={h} must divide over the {n}-device data "
                         "axis; pad the scene (ScenePredictor buckets do)")
    big = h // n
    if big % STRIDE:
        raise ValueError(f"per-device band H/n={big} must be a multiple "
                         f"of {STRIDE}")
    if big < 2 * halo:
        raise ValueError(f"per-device band H/n={big} must be >= 2*halo="
                         f"{2 * halo} (edge devices' clamped context "
                         "windows reach that deep into the neighbor)")
    wp = _round_up(w, STRIDE)
    br = min(band_rows, big)
    n_sub, tail = divmod(big, br)
    subs = [(j * br, br) for j in range(n_sub)] + (
        [(n_sub * br, tail)] if tail else [])
    reps = replicas(model, devices)

    def extended(bands: list, i: int) -> torch.Tensor:
        """Shard i's rows with 2*halo rows of each neighbour (zeros past
        the scene's edges), on its device."""
        dev, s = devices[i], bands[i]
        zeros = s.new_zeros((2 * halo,) + tuple(s.shape[1:]))
        above = bands[i - 1][-2 * halo:].to(dev, non_blocking=True) \
            if i > 0 else zeros
        below = bands[i + 1][:2 * halo].to(dev, non_blocking=True) \
            if i < n - 1 else zeros
        return torch.cat([above, s, below])

    @torch.inference_mode()
    def run(scene1, scene2) -> torch.Tensor:
        padded = [[_edge_pad(b, big, wp) for b in as_bands(s, mesh, dtype)]
                  for s in (scene1, scene2)]
        # every halo copy is queued before any forward: a copy waits for
        # the work already queued on its source card
        ext = [[extended(p, i) for p in padded] for i in range(n)]
        outs = []
        for i, dev in enumerate(devices):
            e1, e2 = ext[i]
            canvas = torch.empty((big, wp), dtype=torch.uint8, device=dev)
            for r0, rows in subs:
                ctx_h = rows + 2 * halo
                y0 = i * big + r0                     # first kept row
                cs = min(max(y0 - halo, 0), h - ctx_h)  # window start
                lcs = cs - (i * big - 2 * halo)       # in the buffer
                m = _mask(reps[dev](e1[None, lcs:lcs + ctx_h],
                                    e2[None, lcs:lcs + ctx_h]))
                canvas[r0:r0 + rows] = m[0, y0 - cs:y0 - cs + rows]
            outs.append(canvas[:, :w])
        return gather_bands(outs)

    return run


def make_fullconv_scene_infer_multidate(model, scene_shape: tuple[int, int],
                                        num_dates: int,
                                        band_rows: int = 1024,
                                        halo: int = 128,
                                        dtype: torch.dtype = torch.bfloat16):
    """Build ``run(scenes) -> (H, W) uint8`` for a (num_dates, H, W, C)
    date stack on the model's device, through UNetLSTM or UNet3D: their
    ConvLSTM gates and 3-D convs are SAME convs and the temporal collapse
    is pointwise, so with a halo that covers the receptive field
    (:func:`halo_for`; UNetLSTM's grows with T) the banded mask equals the
    whole-scene forward's as for the bi-date model."""
    _check(model, band_rows, halo)
    h, w = scene_shape
    hp, wp = _round_up(h, STRIDE), _round_up(w, STRIDE)
    ctx_h, bands = _bands(hp, band_rows, halo)
    groups = [[b] for b in bands]

    @torch.inference_mode()
    def run(scenes: torch.Tensor) -> torch.Tensor:
        if scenes.shape[0] != num_dates:
            raise ValueError(f"expected a ({num_dates}, H, W, C) date "
                             f"stack, got shape {tuple(scenes.shape)}")
        return _run_bands(model, [_edge_pad(scenes.to(dtype), hp, wp)],
                          groups, ctx_h, halo, hp, wp)[:h, :w]

    return run


def _host_window(scene: np.ndarray, cs: int, n: int, w: int,
                 out: torch.Tensor) -> None:
    """Rows [cs, cs + n) of the edge-padded host ``scene`` ((H, W, C), or
    (T, H, W, C)) into ``out`` (its (..., n, wp, C) window): only these
    rows are read, so a memmap's other rows stay on disk; rows past the
    scene repeat its last row and columns past w its last column."""
    axis = scene.ndim - 3
    h = scene.shape[axis]
    if cs + n <= h:
        src = scene[(slice(None),) * axis + (slice(cs, cs + n),)]
    else:
        src = np.take(scene, np.minimum(np.arange(cs, cs + n), h - 1),
                      axis=axis)
    dst = out.numpy()
    dst[..., :w, :] = src
    if dst.shape[-2] > w:
        dst[..., w:, :] = dst[..., w - 1:w, :]


def _streamed(model, scene_shape, band_rows: int, halo: int, dtype,
              max_in_flight: int, padded_shape, device, n_scenes: int):
    """The streamed runner ``run(*scenes, out=None)`` of both families
    (two (H, W, C) scenes, or one (T, H, W, C) stack)."""
    from fabric_tpu_torch.infer.service import resolve_device

    _check(model, band_rows, halo)
    if max_in_flight < 1:
        raise ValueError(f"max_in_flight must be >= 1 (got "
                         f"{max_in_flight})")
    h, w = scene_shape
    if padded_shape is None:
        padded_shape = (h, w)
    elif padded_shape[0] < h or padded_shape[1] < w:
        raise ValueError(f"padded_shape {padded_shape} must cover "
                         f"({h}, {w})")
    hp, wp = (_round_up(v, STRIDE) for v in padded_shape)
    ctx_h, bands = _bands(hp, band_rows, halo)
    # bands wholly in the virtual pad keep no rows: skipped, not computed
    bands = [(y0, rows) for y0, rows in bands if y0 < h]
    device = resolve_device(device)
    on_card = device.type == "cuda"
    slots = max_in_flight + 1

    def run(*scenes, out=None) -> np.ndarray:
        if len(scenes) != n_scenes or any(
                s.shape[s.ndim - 3:s.ndim - 1] != (h, w) for s in scenes):
            raise ValueError(f"expected {n_scenes} host scene(s) of "
                             f"{h}x{w} pixels, got "
                             f"{[tuple(s.shape) for s in scenes]}")
        canvas = np.empty((h, w), np.uint8) if out is None else out
        if canvas.shape[:2] != (h, w):
            raise ValueError(f"out must be (h, w)=({h}, {w}), got "
                             f"{canvas.shape}")
        # per slot, each scene's window in host memory (page-locked on
        # the card) and, on the card, its copy there; the slots rotate
        host = [[torch.empty(s.shape[:-3] + (ctx_h, wp, s.shape[-1]),
                             dtype=torch.from_numpy(
                                 np.empty(0, s.dtype)).dtype,
                             pin_memory=on_card) for s in scenes]
                for _ in range(slots)]
        if on_card:
            dev = [[torch.empty_like(b, device=device) for b in bufs]
                   for bufs in host]
            copied = [torch.cuda.Event() for _ in range(slots)]
            consumed = [torch.cuda.Event() for _ in range(slots)]
            side = torch.cuda.Stream(device)
            compute = torch.cuda.current_stream(device)

        def prepare(i: int) -> int:
            """Slice band i's windows into its slot (on a worker thread,
            one band ahead of the card); its window's first row."""
            cs = _window(bands[i][0], halo, hp, ctx_h)
            if on_card:  # the slot's last upload has left it
                copied[i % slots].synchronize()
            for s, buf in zip(scenes, host[i % slots]):
                _host_window(s, cs, ctx_h, w, buf)
            return cs

        pending: deque = deque()

        def drain() -> None:
            y0, rows, m, done = pending.popleft()
            if done is not None:
                done.synchronize()
            keep = min(rows, h - y0)
            canvas[y0:y0 + keep] = m.numpy()[:keep, :w]

        with ThreadPoolExecutor(max_workers=1) as pool, \
                torch.inference_mode():
            nxt = pool.submit(prepare, 0)
            for i, (y0, rows) in enumerate(bands):
                cs = nxt.result()
                if i + 1 < len(bands):
                    nxt = pool.submit(prepare, i + 1)
                k = i % slots
                if not on_card:
                    m = _mask(model(*(b.to(dtype)[None] for b in host[k])))
                    pending.append((y0, rows, m[0, y0 - cs:y0 - cs + rows],
                                    None))
                else:
                    # the upload runs on a side stream, after the last
                    # forward that read the slot; the forward waits for it
                    with torch.cuda.stream(side):
                        side.wait_event(consumed[k])
                        for d, b in zip(dev[k], host[k]):
                            d.copy_(b, non_blocking=True)
                        copied[k].record(side)
                    compute.wait_event(copied[k])
                    m = _mask(model(*(d.to(dtype)[None] for d in dev[k])))
                    consumed[k].record(compute)
                    back = torch.empty((rows, wp), dtype=torch.uint8,
                                       pin_memory=True)
                    back.copy_(m[0, y0 - cs:y0 - cs + rows],
                               non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(compute)
                    pending.append((y0, rows, back, done))
                if len(pending) > max_in_flight:
                    drain()
            while pending:
                drain()
        return canvas

    return run


def make_fullconv_scene_infer_streamed(model, scene_shape: tuple[int, int],
                                       band_rows: int = 1024,
                                       halo: int = 128,
                                       dtype: torch.dtype = torch.bfloat16,
                                       max_in_flight: int = 2,
                                       padded_shape: tuple[int, int]
                                       | None = None, device=None):
    """Host-streamed :func:`make_fullconv_scene_infer`: the scene never
    resides on the card.  Each band's context windows are sliced out of
    the host arrays (plain ndarrays or ``np.memmap``: only the window's
    rows are read) on a worker thread, one band ahead, into page-locked
    buffers; uploaded on a side CUDA stream, ordered with events against
    the forwards; and the kept rows come back into a host canvas.  At
    most ``max_in_flight`` bands are on the card, so its footprint is
    about one band's activations whatever the scene's size.

    ``padded_shape``: edge-pad the scene virtually to these dims (rounded
    up to 16) before banding, without a padded copy; the bucket dims make
    the mask the in-HBM runner's on the bucket-padded scene (as
    ``ScenePredictor`` uses it).  Bands wholly in the pad are skipped.
    The windows and crops are the in-HBM path's, so the mask is the same.

    Returns ``run(scene1, scene2, out=None) -> (H, W) uint8`` (numpy);
    ``out`` (e.g. a ``np.memmap``) receives the mask.  ``device``: where
    the model runs (None: the card)."""
    return _streamed(model, scene_shape, band_rows, halo, dtype,
                     max_in_flight, padded_shape, device, 2)


def make_fullconv_scene_infer_multidate_streamed(
        model, scene_shape: tuple[int, int], num_dates: int,
        band_rows: int = 1024, halo: int = 128,
        dtype: torch.dtype = torch.bfloat16, max_in_flight: int = 2,
        padded_shape: tuple[int, int] | None = None, device=None):
    """The multi-date form of :func:`make_fullconv_scene_infer_streamed`:
    ``run(scenes, out=None) -> (H, W) uint8`` over a host (num_dates, H,
    W, C) date stack, with the same exactness and ``padded_shape``."""
    run = _streamed(model, scene_shape, band_rows, halo, dtype,
                    max_in_flight, padded_shape, device, 1)

    def run_multidate(scenes, out=None) -> np.ndarray:
        if scenes.shape[0] != num_dates:
            raise ValueError(f"expected a ({num_dates}, H, W, C) date "
                             f"stack, got shape {tuple(scenes.shape)}")
        return run(scenes, out=out)

    return run_multidate
