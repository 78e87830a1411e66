"""Remote artifact store: checkpoint and tracker egress, resume ingress
(the port's own copy of ``fabric_tpu/store.py``).

The reference uploads every best checkpoint and its metadata to a remote
outputs store and pulls its dataset from one.  Local checkpoint writes
are atomic, but a run on a preemptible machine whose disk vanishes would
lose them; this module mirrors them out:

- ``ArtifactStore(uri)`` dispatches on scheme: ``gs://`` shells out to
  ``gsutil``/``gcloud storage`` where one is on PATH and raises where
  neither is (the tests drive the same machinery through ``file://``
  stores), ``file://`` / bare paths copy through the filesystem.
- **Uploads are primary-only, asynchronous, and failure-tolerant**: a
  single worker thread drains a queue so training never blocks on the
  network, and any failed transfer logs a warning instead of killing the
  run (the local copy is still the source of truth; the reference's
  in-loop upload could raise mid-epoch).
- **Ingress**: ``fetch_resume`` materializes a remote checkpoint file or
  directory locally so ``cfg.resume`` accepts a store URI, and
  ``data/download.fetch`` takes ``gs://`` dataset sources.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import threading
from urllib.parse import urlparse

log = logging.getLogger("fabric_tpu_torch")

_GS_CANDIDATES = (("gsutil",), ("gcloud", "storage"))


def _gs_tool() -> tuple[str, ...] | None:
    """The available GCS CLI as an argv prefix, or None."""
    for cand in _GS_CANDIDATES:
        if shutil.which(cand[0]):
            return cand
    return None


def _is_remote(uri: str) -> bool:
    return uri.startswith(("gs://", "file://"))


class ArtifactStore:
    """Mirror local artifacts to a store URI (``gs://bucket/prefix``,
    ``file:///abs/path``, or a bare directory path).

    ``blocking=True`` makes :meth:`upload` synchronous (tests, final
    flush-critical paths); the default queues transfers on one worker
    thread and :meth:`flush` waits for the queue to drain.
    """

    def __init__(self, uri: str, blocking: bool = False):
        self.uri = uri.rstrip("/")
        scheme = urlparse(self.uri).scheme
        if scheme == "gs":
            self._tool = _gs_tool()
            if self._tool is None:
                raise RuntimeError(
                    f"output store {uri!r} needs gsutil or gcloud on PATH; "
                    f"neither found")
            self._local_root = None
        elif scheme in ("file", ""):
            self._local_root = (self.uri[len("file://"):]
                                if scheme == "file" else self.uri)
            self._tool = None
        else:
            raise ValueError(f"unsupported store scheme {scheme!r} in "
                             f"{uri!r} (gs://, file://, or a local path)")
        self.blocking = blocking
        self._lock = threading.Lock()
        self._failed = 0
        self._seq = 0
        self._swept: set[str] = set()
        self._queue: "object | None" = None
        self._worker: threading.Thread | None = None

    # -- egress ---------------------------------------------------------

    def upload(self, local_path: str, rel: str | None = None) -> None:
        """Mirror one file to ``<store>/<rel>`` (default: its basename).
        Asynchronous unless ``blocking`` — one worker thread drains the
        queue in submission order (pointer files land after the
        checkpoint they reference); failures log, never raise."""
        rel = rel or os.path.basename(local_path)
        if self.blocking:
            self._transfer(local_path, rel)
            return
        if self._queue is None:
            import queue
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        # snapshot via hardlink (same filesystem, no data copy) so the
        # queued transfer survives the source being pruned (checkpoint
        # retention deletes old saves that may still be in the queue) or
        # atomically replaced (pointer files) before the worker gets to
        # it — the snapshot pins the content as of enqueue time.  Names
        # carry pid + instance id so a restarted run (or a second store
        # in this process) can't collide with leftovers, and dead-pid
        # orphans from a crashed run are swept on first touch so they
        # don't pin pruned checkpoint payloads forever
        spool = None
        try:
            sdir = self._spool_dir(local_path)
            with self._lock:
                self._seq += 1
                seq = self._seq
            spool = os.path.join(
                sdir, f"{os.getpid()}_{id(self):x}_{seq}_"
                      f"{os.path.basename(local_path)}")
            os.link(local_path, spool)
        except OSError:
            spool = None  # read-only dir / exotic fs: upload live path
        self._queue.put((spool or local_path, rel, spool))

    def _spool_dir(self, local_path: str) -> str:
        """The snapshot dir beside ``local_path`` (same filesystem, so
        hardlinks work); on first touch, sweep orphans left by crashed or
        preempted runs (their pid no longer exists)."""
        sdir = os.path.join(
            os.path.dirname(os.path.abspath(local_path)), ".upload_spool")
        os.makedirs(sdir, exist_ok=True)
        if sdir not in self._swept:
            self._swept.add(sdir)
            for name in os.listdir(sdir):
                pid = name.split("_", 1)[0]
                if pid.isdigit() and os.path.exists(f"/proc/{pid}"):
                    continue  # a live process still owns this snapshot
                try:
                    os.unlink(os.path.join(sdir, name))
                except OSError:
                    pass
        return sdir

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            src, rel, spool = item
            self._transfer(src, rel)
            if spool is not None:
                try:
                    os.unlink(spool)
                except OSError:
                    pass
            self._queue.task_done()

    def upload_dir(self, local_dir: str, rel: str = "") -> None:
        """Mirror a directory tree (each file via :meth:`upload`)."""
        for dirpath, dirnames, filenames in os.walk(local_dir):
            if ".upload_spool" in dirnames:  # our own snapshots
                dirnames.remove(".upload_spool")
            dirnames.sort()
            for fname in sorted(filenames):
                p = os.path.join(dirpath, fname)
                r = os.path.relpath(p, local_dir)
                self.upload(p, os.path.join(rel, r) if rel else r)

    def upload_checkpoint(self, directory: str, path: str) -> None:
        """Mirror one checkpoint save: the msgpack, its metadata sidecar,
        and the latest/best pointers (checkpoint.save's full footprint)."""
        import re

        from fabric_tpu_torch.checkpoint import sidecar_name
        self.upload(path)
        m = re.search(r"([a-z]+)_epoch_(\d+)\.msgpack$", path)
        if m:
            sidecar = os.path.join(
                directory, sidecar_name(m.group(1), int(m.group(2))))
            if os.path.exists(sidecar):
                self.upload(sidecar)
        for name in ("latest.json", "best.json"):
            p = os.path.join(directory, name)
            if os.path.exists(p):
                self.upload(p)

    def _transfer(self, local_path: str, rel: str) -> None:
        try:
            if self._tool is not None:
                subprocess.run(
                    [*self._tool, "cp", local_path, f"{self.uri}/{rel}"],
                    check=True, capture_output=True, timeout=600)
            else:
                dest = os.path.join(self._local_root, rel)
                os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
                tmp = f"{dest}.tmp.{os.getpid()}"
                shutil.copy2(local_path, tmp)
                os.replace(tmp, dest)
        except Exception as e:  # noqa: BLE001 — egress must never kill a run
            with self._lock:
                self._failed += 1
            log.warning("artifact upload %s -> %s/%s failed: %s "
                        "(training continues; the local copy is intact)",
                        local_path, self.uri, rel, e)

    def flush(self, timeout_s: float = 600.0) -> int:
        """Wait for queued uploads; returns the failed-transfer count."""
        if self._queue is not None:
            # join with a deadline: a wedged remote must not hang exit
            done = threading.Event()
            threading.Thread(target=lambda: (self._queue.join(),
                                             done.set()),
                             daemon=True).start()
            if not done.wait(timeout_s):
                log.warning("artifact store flush timed out after %.0fs "
                            "with transfers still queued", timeout_s)
        return self._failed

    # -- ingress --------------------------------------------------------

    def download(self, rel: str, local_path: str) -> str:
        """Fetch ``<store>/<rel>`` to ``local_path`` (blocking; raises)."""
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        if self._tool is not None:
            subprocess.run(
                [*self._tool, "cp", f"{self.uri}/{rel}", local_path],
                check=True, capture_output=True, timeout=600)
        else:
            shutil.copy2(os.path.join(self._local_root, rel), local_path)
        return local_path

    def download_dir(self, rel: str, local_dir: str) -> str:
        """Fetch a store subtree (blocking; raises)."""
        os.makedirs(local_dir, exist_ok=True)
        if self._tool is not None:
            prefix = f"{self.uri}/{rel}" if rel else self.uri
            # '/*' for BOTH tools: a bare 'cp -r gs://b/run1 dest' nests
            # the source directory under dest (dest/run1/...), which
            # breaks resume's pointer resolution against dest itself
            subprocess.run(
                [*self._tool, "cp", "-r", f"{prefix}/*", local_dir],
                check=True, capture_output=True, timeout=1800)
        else:
            src = os.path.join(self._local_root, rel) if rel else \
                self._local_root
            shutil.copytree(src, local_dir, dirs_exist_ok=True)
        return local_dir


def open_store(uri: str, blocking: bool = False) -> ArtifactStore | None:
    """ArtifactStore for a configured URI; None when unset ('')."""
    return ArtifactStore(uri, blocking=blocking) if uri else None


def fetch_resume(resume: str, cache_dir: str) -> str:
    """Materialize a remote ``cfg.resume`` target locally.

    ``gs://.../checkpoint_epoch_3.msgpack`` (a file) downloads that file;
    ``gs://.../run1`` (a directory/prefix) mirrors the subtree so the
    normal latest-pointer resolution (checkpoint.latest_checkpoint) runs
    against it.  Local paths pass through untouched.
    """
    if not _is_remote(resume):
        return resume
    parsed = urlparse(resume)
    base, rel = resume.rsplit("/", 1)
    store = ArtifactStore(base, blocking=True)
    if resume.endswith(".msgpack"):
        local = os.path.join(cache_dir, rel)
        store.download(rel, local)
        log.info("fetched resume checkpoint %s -> %s", resume, local)
        return local
    # directory: mirror it (includes pointers + sidecars)
    dir_store = ArtifactStore(resume, blocking=True)
    local = os.path.join(cache_dir, rel or os.path.basename(parsed.path)
                         or "resume")
    dir_store.download_dir("", local)
    log.info("fetched resume directory %s -> %s", resume, local)
    return local
