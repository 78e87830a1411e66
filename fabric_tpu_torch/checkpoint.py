"""Checkpoints in ``fabric_tpu``'s format, without JAX or flax.

``fabric_tpu/checkpoint.py`` writes ``<tag>_epoch_<N>.msgpack`` files with
flax's serializer: a msgpack map whose array leaves are msgpack ext type 1
(numpy scalars ext type 3), each holding a msgpack'd ``(shape, dtype name,
C-order bytes)`` triple.  The map holds ``params``, ``batch_stats``,
``opt_state`` (optax's state tree for the configured optimizer, as
``train/state.py`` lays it out), ``step`` and ``meta_json``, the metadata
that travels in the same atomic write as the weights (``batches_done`` for
mid-epoch resume).  A JSON sidecar mirrors the metadata, and
``latest.json`` / ``best.json`` pointers name the newest and the
best-metric file.  This module writes the same files (:func:`save`,
:func:`prune`) and reads them (:func:`restore`, :func:`resume_if_requested`,
and :func:`load_variables` for serving), so a checkpoint of either package
restores in the other.  ``msgpack`` is imported only where it is used.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def sidecar_name(tag: str, epoch: int) -> str:
    """The metadata sidecar of one save: ``metadata_epoch_N.json`` for
    best-metric saves, ``metadata_<tag>_epoch_N.json`` for the others."""
    return (f"metadata_epoch_{epoch}.json" if tag == "checkpoint"
            else f"metadata_{tag}_epoch_{epoch}.json")


def _ext_pack(x):
    import msgpack

    def pack(a):
        return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")),
                             use_bin_type=True)
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, pack(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, pack(np.asarray(x)))
    raise TypeError(f"cannot serialise {type(x).__name__}")


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fout:
        fout.write(data)
    os.replace(tmp, path)


def save(state, directory: str, epoch: int, metadata: dict | None = None,
         tag: str = "checkpoint", keep_last: int = 0) -> str:
    """Write ``<dir>/<tag>_epoch_<N>.msgpack`` and its JSON sidecar, point
    ``latest`` (and for best-metric saves, ``tag="checkpoint"``, also
    ``best``) at it, and with ``keep_last`` > 0 prune the tag's older
    saves.  Each file is written to a temporary name and renamed."""
    import msgpack

    os.makedirs(directory, exist_ok=True)
    meta = dict(metadata or {})
    meta.update({"epoch": epoch, "step": int(state.step)})
    params, batch_stats = state.variables()
    payload = {"params": params, "batch_stats": batch_stats,
               "opt_state": state.opt_state, "step": int(state.step),
               "meta_json": json.dumps(meta, default=float)}
    path = os.path.join(directory, f"{tag}_epoch_{epoch}.msgpack")
    _write_atomic(path, msgpack.packb(payload, default=_ext_pack,
                                      strict_types=True))
    _write_atomic(os.path.join(directory, sidecar_name(tag, epoch)),
                  json.dumps(meta, indent=2, default=float).encode())
    _write_pointer(directory, "latest", path, epoch, tag)
    if tag == "checkpoint":
        _write_pointer(directory, "best", path, epoch, tag)
    if keep_last > 0:
        prune(directory, keep_last, tag)
    return path


def _write_pointer(directory: str, name: str, path: str, epoch: int,
                   tag: str) -> None:
    _write_atomic(os.path.join(directory, f"{name}.json"), json.dumps(
        {"file": os.path.basename(path), "epoch": epoch,
         "tag": tag}).encode())


def _saves(directory: str, tag: str) -> list[tuple[tuple, str]]:
    """((epoch, mtime), file name) of a tag's saves, oldest first."""
    pat = re.compile(rf"{re.escape(tag)}_epoch_(\d+)\.msgpack$")
    found = []
    for name in os.listdir(directory):
        m = pat.match(name)
        if m:
            path = os.path.join(directory, name)
            found.append(((int(m.group(1)), os.path.getmtime(path)), name))
    return sorted(found)


def prune(directory: str, keep_last: int, tag: str) -> list[str]:
    """Delete all but the newest ``keep_last`` saves of one tag (and their
    sidecars), never one that ``latest`` or ``best`` points at; returns
    the deleted paths."""
    protected = {os.path.basename(p) for p in
                 (read_pointer(directory, n) for n in ("latest", "best")) if p}
    deleted = []
    for (epoch, _), name in _saves(directory, tag)[:-keep_last]:
        if name in protected:
            continue
        path = os.path.join(directory, name)
        os.remove(path)
        deleted.append(path)
        sidecar = os.path.join(directory, sidecar_name(tag, epoch))
        if os.path.exists(sidecar):
            os.remove(sidecar)
    return deleted


def read_pointer(directory: str, name: str) -> str | None:
    """Resolve a ``latest``/``best`` pointer file to a checkpoint path."""
    ptr = os.path.join(directory, f"{name}.json")
    if not os.path.exists(ptr):
        return None
    try:
        with open(ptr) as fin:
            rec = json.load(fin)
        path = os.path.join(directory, rec["file"])
    except (ValueError, KeyError, TypeError):
        return None
    return path if os.path.exists(path) else None


def latest_checkpoint(directory: str, tag: str | None = None) -> str | None:
    """Most recent checkpoint path in a directory, or None: the ``latest``
    pointer when ``tag`` is None and it resolves, else the highest epoch
    (ties by file mtime) of ``tag`` or of both ``checkpoint`` and
    ``periodic`` saves."""
    if not os.path.isdir(directory):
        return None
    if tag is None:
        pointed = read_pointer(directory, "latest")
        if pointed is not None:
            return pointed
    found = sorted(s for t in ([tag] if tag else ["checkpoint", "periodic"])
                   for s in _saves(directory, t))
    return os.path.join(directory, found[-1][1]) if found else None


def resolve(checkpoint: str) -> str:
    """A checkpoint file, or for a directory the file serving wants: the
    best-metric save, else the latest.  Raises FileNotFoundError."""
    path = checkpoint
    if os.path.isdir(checkpoint):
        path = (read_pointer(checkpoint, "best")
                or latest_checkpoint(checkpoint))
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found at {checkpoint!r}")
    return path


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
        arr = arr.reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]
    return msgpack.ExtType(code, data)


def read_payload(path: str) -> dict:
    """The decoded map of a ``.msgpack`` checkpoint (numpy leaves)."""
    import msgpack

    with open(path, "rb") as fin:
        payload = msgpack.unpackb(fin.read(), ext_hook=_ext_hook, raw=False)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path!r} is not a fabric_tpu checkpoint")
    return payload


def load_variables(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) numpy trees of a ``.msgpack`` checkpoint."""
    payload = read_payload(path)
    return payload["params"], payload.get("batch_stats", {})


def restore(state, path: str):
    """Load a checkpoint file into ``state`` (a TrainState of the same
    model and optimizer config) in place; raises ValueError on a mismatch.
    Returns the state and the checkpoint's metadata."""
    payload = read_payload(path)
    if "opt_state" not in payload:
        raise ValueError(f"{path!r} holds no optimizer state")
    state.tx.load_state_tree(payload["opt_state"])
    from fabric_tpu_torch.weights import load_variables as load_into
    load_into(state.model, payload["params"], payload.get("batch_stats", {}))
    state.step = int(payload["step"])
    meta = payload.get("meta_json") or ""
    return state, (json.loads(meta) if meta else {})


def resume_if_requested(cfg, state):
    """Honour ``cfg.resume``: "" -> fresh; a file -> load it; a directory
    -> load its latest save; a store URI (``file://``, ``gs://``) of
    either -> fetch it into ``<weight_dir>/.resume_cache`` first
    (``store.fetch_resume``; ``.resume_cache/p<rank>`` in a process group
    of several).  Returns (state, resumed epoch, metadata);
    the epoch is -1 and the metadata {} when nothing was loaded."""
    target = getattr(cfg, "resume", "")
    if not target:
        return state, -1, {}
    from fabric_tpu_torch.parallel import distributed
    from fabric_tpu_torch.store import fetch_resume
    cache = os.path.join(cfg.weight_dir, ".resume_cache")
    if distributed.world_size() > 1:  # each rank fetches its own copy
        cache = os.path.join(cache, f"p{distributed.rank()}")
    target = fetch_resume(target, cache)
    path = target
    if os.path.isdir(target):
        path = latest_checkpoint(target)
        if path is None:
            return state, -1, {}
    m = re.search(r"(?:^|/)[a-z]+_epoch_(\d+)\.msgpack$", path)
    state, meta = restore(state, path)
    return state, (int(m.group(1)) if m else -1), meta
