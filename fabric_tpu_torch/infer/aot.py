"""Ahead-of-time serving artifacts: the scene runners' forwards frozen
with ``torch.export`` (counterpart of ``fabric_tpu/infer/aot.py``, whose
artifacts are StableHLO from ``jax.export``).

- ``export_runners(predictor, shapes, platforms)`` traces, once per scene
  bucket, the forward that the bucket's runner calls into an
  ``ExportedProgram``: one chunk's (or band's) forward, at the shape the
  runner feeds it, the weights (and the conv kernels' packed weights,
  made before the trace) held as the program's parameters and constants.
  The port's kernels appear in the graph as the custom ops
  ``fabric_tpu_torch::*`` (``ops/``), which dispatch by device: the
  Hopper kernel on CUDA, its plain version on the CPU.  The bucket's
  tiling, chunking and stitching stay in-process code around the loaded
  program (``fabric_tpu``'s artifact holds the whole runner, which
  ``torch.export`` would unroll into one forward per chunk: 121 at a
  10980^2 scene's 11264^2 bucket, each a copy of the forward's graph to
  store, load and rebuild).
- ``export_aot(predictor, directory, shapes)`` exports and writes
  ``runner_HxW[_packN].pt2`` files with an ``aot_meta.json`` recording the
  serving configuration they were frozen from (model family, quant mode,
  dtype, bucket, dates, fullconv band rows, platforms, the weights'
  sha256, the pinned int8 scales) and each file's count of kernel ops.
  ``save_aot`` / ``load_aot`` are the raw layers.
- ``ScenePredictor(..., aot_dir=...)`` serves from it: a covered bucket's
  runner calls the loaded program, with nothing traced or packed at
  serving time; a missing bucket falls back to the in-process runner (the
  same kernels) with a warning.

Masks are bit-identical to the in-process path: the program runs the
same ops in the same order.  ``load_aot`` refuses a graph whose kernel
ops differ from the meta's record, or a file the meta records none for
(an artifact whose kernels were traced into plain aten ops would serve
the plain versions on the card).  int8 artifacts pin the calibration
scales: export refuses a predictor without scales or one that would
recalibrate.  Scope, as in ``fabric_tpu``: grid, overlap, banded overlap
and in-device-memory fullconv, bi-date and multi-date, exact and int8,
plus the fleet-packed grid runners; streamed and sharded runners do host
or cross-device work per band and stay in-process.

An artifact for the card can be exported on a host without one: the
program then holds its tensors on the CPU, and ``load_aot`` moves them to
the card (``torch.export.passes.move_to_device_pass``) before serving.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from collections import Counter

import numpy as np
import torch

log = logging.getLogger("fabric_tpu_torch")

_META = "aot_meta.json"
OPS = "fabric_tpu_torch"  # the custom ops' namespace
PLATFORMS = ("cuda", "cpu")


def _runner_name(h: int, w: int, pack: int = 0) -> str:
    if pack:
        return f"runner_{h}x{w}_pack{pack}.pt2"
    return f"runner_{h}x{w}.pt2"


def _register_ops() -> None:
    """Import the kernel modules, which register the custom ops a loaded
    program calls."""
    from fabric_tpu_torch.ops import (bn_relu, conv, conv_s8,  # noqa: F401
                                      double_conv, fp32_matmul, fuse_s8,
                                      fused)


class _Forward(torch.nn.Module):
    """A serving forward as a module for ``torch.export``: the model (when
    it is a module, a submodule, so that its weights are the program's
    parameters) or the int8 forward, called on a chunk's inputs."""

    def __init__(self, forward):
        super().__init__()
        if isinstance(forward, torch.nn.Module):
            self.model = forward
        self.forward_fn = forward

    def forward(self, *inputs):
        return self.forward_fn(*inputs)


def kernel_ops(program) -> dict[str, int]:
    """{op name: count} of the kernels' ``fabric_tpu_torch::`` ops in an
    exported program's graph (not ``fp32_product``, a float32 product's
    precision pin, ``ops/fp32_matmul.py``)."""
    counts: Counter = Counter()
    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            target = node.target
            if (node.op == "call_function"
                    and isinstance(target, torch._ops.OpOverload)
                    and target.namespace == OPS
                    and target._opname != "fp32_product"):
                counts[target._opname] += 1
    return dict(sorted(counts.items()))


def forward_inputs(build, n_classes: int) -> tuple:
    """The (shape, dtype) of each input a runner passes its forward, found
    by running ``build(stand_in)`` (the runner built around a stand-in
    forward) once on "meta" tensors, which compute nothing.  Every in-scope
    runner calls its forward with one signature (zero-padded chunks, bands
    of one context height); raises otherwise."""
    seen = set()

    def stand_in(*inputs):
        seen.add(tuple((tuple(x.shape), x.dtype) for x in inputs))
        n, (h, w) = inputs[0].shape[0], inputs[0].shape[-3:-1]
        return torch.zeros((n, h, w, n_classes), device="meta")

    stand_in.local_upsample = True  # the fullconv runners' check
    run, scenes = build(stand_in)
    run(*(torch.empty(shape, device="meta") for shape in scenes))
    if len(seen) != 1:
        raise ValueError(f"the runner calls its forward with {len(seen)} "
                         f"input signatures; an artifact holds one")
    return seen.pop()


def export_forward(forward, inputs, device):
    """``torch.export`` of ``forward`` on zero inputs of ``inputs``' (shape,
    dtype) on ``device``; raises unless its graph calls the kernel ops."""
    args = tuple(torch.zeros(shape, dtype=dtype, device=device)
                 for shape, dtype in inputs)
    program = torch.export.export(_Forward(forward), args, strict=False)
    program.example_inputs = None  # zeros, not worth storing
    if not kernel_ops(program):
        raise RuntimeError("the exported forward calls none of the port's "
                           "kernel ops: its kernels were traced as plain "
                           "PyTorch")
    return program


def _scene_shapes(predictor, h: int, w: int, pack: int = 0) -> list:
    """The shapes of the scene inputs of a predictor's (h, w) runner."""
    c = predictor.cfg.n_channels
    shape = (h, w, c)
    if predictor.multi_date:
        shape = (predictor.cfg.num_dates,) + shape
    if pack:
        shape = (pack,) + shape
    return [shape] if predictor.multi_date else [shape, shape]


def export_scene_runner(predictor, scene_shape):
    """``torch.export`` of the forward that a predictor's runner of the
    bucket ``scene_shape`` calls, chunk by chunk (or band by band): the
    artifact of that bucket.  ``ScenePredictor(aot_dir=...)`` builds the
    bucket's tiling and stitching around the loaded program, so the
    program stays one forward whatever the bucket's chunk count."""
    h, w = scene_shape
    inputs = forward_inputs(
        lambda fwd: (predictor._in_process_runner(h, w, forward=fwd),
                     _scene_shapes(predictor, h, w)),
        predictor.cfg.n_classes)
    return export_forward(predictor._forward, inputs, predictor.device)


def export_packed_runner(predictor, scene_shape, pack: int):
    """The artifact of a fleet-packed bucket: ``torch.export`` of the
    forward its runner of ``pack`` scenes calls."""
    h, w = scene_shape
    inputs = forward_inputs(
        lambda fwd: (predictor._in_process_packed_runner(h, w, pack,
                                                         forward=fwd),
                     _scene_shapes(predictor, h, w, pack)),
        predictor.cfg.n_classes)
    return export_forward(predictor._forward, inputs, predictor.device)


def _on_device(program, device: torch.device):
    """The program with its tensors on ``device`` (moved where they are
    not: an artifact exported on another host)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tensors = list(program.state_dict.values()) + [
        v for v in program.constants.values() if isinstance(v, torch.Tensor)]
    if all(t.device == device for t in tensors):
        return program
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(program, str(device))


def load_serialized_runner(data, device=None, ops: dict | None = None):
    """An exported forward (the bytes or path of a ``.pt2``) -> a
    ``(*inputs) -> logits`` callable on ``device`` (None means the card,
    raising without one).  Raises unless the graph's kernel ops are
    ``ops`` (when given) and there is at least one."""
    from fabric_tpu_torch.infer.service import resolve_device
    device = resolve_device(device)
    _register_ops()
    program = torch.export.load(io.BytesIO(data) if isinstance(data, bytes)
                                else data)
    found = kernel_ops(program)
    if not found or (ops is not None and found != ops):
        raise ValueError(
            f"the artifact's graph holds kernel ops {found}, not the "
            f"{ops} it was exported with: its kernels would not run as "
            f"the port's (re-export it with infer/aot.export_aot)")
    module = _on_device(program, device).module()

    @torch.inference_mode()
    def forward(*inputs):
        return module(*inputs)

    return forward


def save_aot(directory: str, runners: dict, meta: dict) -> None:
    """Write ``runner_HxW[_packN].pt2`` files and the meta sidecar, which
    records each file's kernel ops.  Keys are ``(h, w)`` buckets or ``(h,
    w, pack)`` fleet-packed buckets; values exported programs."""
    os.makedirs(directory, exist_ok=True)
    meta = dict(meta)
    meta["ops"] = {}
    for key, program in runners.items():
        name = _runner_name(*key)
        path = os.path.join(directory, name)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.export.save(program, tmp)
        os.replace(tmp, path)
        meta["ops"][name] = kernel_ops(program)
    meta["shapes"] = sorted([list(k) for k in runners if len(k) == 2])
    packed = sorted([list(k) for k in runners if len(k) == 3])
    if packed:
        meta["packed_shapes"] = packed
    with open(os.path.join(directory, _META), "w") as fout:
        json.dump(meta, fout, indent=1)


def load_aot(directory: str, h: int, w: int, pack: int = 0, device=None):
    """The frozen forward of bucket (h, w) (``pack`` > 0: of the
    fleet-packed bucket) on ``device`` (None means the card, raising
    without one); None when the artifact has none.  Raises when the meta
    records no kernel ops for the file or the graph's differ."""
    name = _runner_name(h, w, pack)
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return None
    ops = read_meta(directory).get("ops", {}).get(name)
    if not ops:
        raise ValueError(f"{path}: the artifact's meta records no kernel "
                         f"ops for it (exported before the kernels were "
                         f"custom ops?); re-export it with "
                         f"infer/aot.export_aot")
    log.info("serving %dx%d%s from AOT artifact %s", h, w,
             f" (pack {pack})" if pack else "", path)
    return load_serialized_runner(path, device, ops)


def _check_exportable(predictor, packs) -> None:
    if predictor.fullconv_stream or predictor.shard_scene \
            or predictor.mesh is not None:
        raise ValueError(
            "AOT export covers the single-device serving modes; streamed "
            "and sharded runners do per-band host work and stay in-process")
    if predictor.quant == "int8":
        # the scales are constants of the frozen math: a predictor whose
        # scales could still move cannot be frozen
        if predictor._scales is None:
            raise ValueError(
                "int8 AOT export needs calibrated activation scales: call "
                "predictor.calibrate(...) (or serve from a calibrated "
                "bundle) before exporting")
        if predictor.recalibrate_every > 0:
            raise ValueError(
                "int8 AOT artifacts pin the calibration scales at export; "
                "recalibrate_every > 0 would diverge from them: export "
                "from a predictor with recalibrate_every=0")
    if packs and predictor.serving_mode() != "grid":
        raise ValueError(
            f"packs= exports fleet-packed runners, which serve the grid "
            f"tiling mode only (this predictor is configured for "
            f"{predictor.serving_mode()!r})")


def export_runners(predictor, scene_shapes, platforms=None,
                   packs=()) -> dict:
    """Export a predictor's artifact for each scene shape (pre-bucket dims;
    keyed by the padded bucket dims, as the predictor looks them up) and,
    for each of ``packs``, its fleet-packed artifact (grid mode only).
    ``platforms``: where the artifact serves, "cuda" and/or "cpu" (None:
    the predictor's device); a program to serve on a platform other than
    the predictor's holds its tensors on the CPU.  Returns {(H, W):
    program} plus {(H, W, pack): program}."""
    platforms = tuple(platforms or (predictor.device.type,))
    bad = sorted(set(platforms) - set(PLATFORMS))
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{list(platforms)}")
    _check_exportable(predictor, packs)
    to_cpu = (predictor.device.type != "cpu"
              and list(platforms) != [predictor.device.type])

    def finish(program):
        if to_cpu:
            from torch.export.passes import move_to_device_pass
            program = move_to_device_pass(program, "cpu")
        return program

    out = {}
    for h, w in scene_shapes:
        ph, pw = predictor._bucket_dims(h, w)
        if (ph, pw) in out:
            continue
        out[(ph, pw)] = finish(export_scene_runner(predictor, (ph, pw)))
        log.info("exported the %dx%d bucket's forward (platforms %s)", ph,
                 pw, list(platforms))
        for pack in packs:
            out[(ph, pw, pack)] = finish(
                export_packed_runner(predictor, (ph, pw), pack))
            log.info("exported the %dx%d pack-%d bucket's forward", ph, pw,
                     pack)
    return out


def export_aot(predictor, directory: str, scene_shapes, platforms=None,
               packs=()) -> dict:
    """Export and write a predictor's artifact: its runners for every scene
    shape (and ``packs``), and an ``aot_meta.json`` recording the serving
    configuration they were frozen from, and for int8 the pinned scales,
    which a serving process seeds its own from.  ``platforms``: as
    :func:`export_runners`.  Returns the meta."""
    platforms = tuple(platforms or (predictor.device.type,))
    runners = export_runners(predictor, scene_shapes, platforms, packs=packs)
    meta = {
        "format_version": 1,
        "model": predictor.cfg.model,
        "quant": predictor.quant,
        "dtype": ("bfloat16" if predictor.dtype == torch.bfloat16
                  else "float32"),
        "bucket": predictor.bucket,
        "num_dates": (predictor.cfg.num_dates if predictor.multi_date
                      else 0),
        "fullconv_band_rows": predictor.fullconv_band_rows,
        "platforms": list(platforms),
        "weights_sha256": params_fingerprint(predictor.variables()),
    }
    if predictor.quant == "int8":
        meta["int8_scales"] = {k: float(v)
                               for k, v in predictor._scales.items()}
    save_aot(directory, runners, meta)
    return read_meta(directory)


def read_meta(directory: str) -> dict:
    with open(os.path.join(directory, _META)) as fin:
        return json.load(fin)


def _leaves(tree, path: str = ""):
    """(path, leaf) of a nested dict in ``jax.tree_util``'s order (keys
    sorted), each path written as ``jax.tree_util.keystr`` writes it:
    ``['params']['inc']['conv1']['kernel']``."""
    for key in sorted(tree):
        sub = f"{path}[{key!r}]"
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], sub)
        else:
            yield sub, tree[key]


def params_fingerprint(variables: dict) -> str:
    """sha256 over every leaf (path, dtype, shape, bytes) of a variables
    tree (``{"params": ..., "batch_stats": ...}`` in ``fabric_tpu``'s
    layout): the digest ``fabric_tpu.infer.aot.params_fingerprint`` gives
    for the same weights.  It identifies the weights an artifact was
    frozen from: the program holds them, so serving other weights through
    it would serve the frozen ones on covered buckets and the live ones on
    fallback buckets."""
    h = hashlib.sha256()
    for path, leaf in _leaves(variables):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()
