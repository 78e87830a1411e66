"""Dataset acquisition: archives and URIs -> an on-disk dataset directory
(the port's own copy of ``fabric_tpu/data/download.py``).

The reference pulls a dataset tarball from a store and untars it into the
working directory.  This does the same, safely:

- local archive paths and ``file://``, ``http(s)://`` (urllib) and
  ``gs://`` (``gsutil``/``gcloud``, through ``fabric_tpu_torch.store``)
  URIs;
- idempotent: an already-acquired dataset (flat or nested layout) and an
  already-downloaded archive are never fetched again;
- atomic: extraction happens into a temporary directory that is renamed
  into place, so an interrupted run never leaves what looks like a
  complete dataset;
- multi-process: only rank 0 acquires; the other ranks wait for the
  dataset to appear.
"""

from __future__ import annotations

import logging
import os
import shutil
import tarfile
import tempfile
import time
from urllib.parse import urlparse

log = logging.getLogger("fabric_tpu_torch")

_ARCHIVE_EXTS = (".tar.gz", ".tgz", ".tar")
_RANK_WAIT_S = 1800.0  # how long a rank waits for rank 0's dataset


def resolve_layout(root: str) -> str | None:
    """Return the directory holding labels/ under ``root`` (root itself or
    exactly one real subdirectory), or None if absent."""
    if not os.path.isdir(root):
        return None
    if os.path.isdir(os.path.join(root, "labels")):
        return root
    candidates = [e for e in os.listdir(root)
                  if not e.startswith((".", "_"))
                  and os.path.isdir(os.path.join(root, e, "labels"))]
    if len(candidates) == 1:
        return os.path.join(root, candidates[0])
    return None


def fetch(uri: str, dest_dir: str) -> str:
    """Fetch ``uri`` (local path / file:// / http(s)://) into ``dest_dir``;
    returns the local file path.  Already-present files are not re-fetched."""
    os.makedirs(dest_dir, exist_ok=True)
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    if os.path.exists(uri):
        return uri
    if uri.startswith(("http://", "https://")):
        name = os.path.basename(urlparse(uri).path) or "dataset.tar.gz"
        local = os.path.join(dest_dir, name)
        if os.path.exists(local):
            log.info("using cached download %s", local)
            return local
        import urllib.request
        log.info("downloading %s", uri)
        start = time.time()
        tmp = local + ".part"
        urllib.request.urlretrieve(uri, tmp)  # noqa: S310
        os.replace(tmp, local)
        log.info("download took %.1fs", time.time() - start)
        return local
    if uri.startswith("gs://"):
        # GCS dataset source: gsutil/gcloud through the store machinery,
        # cached like http
        name = os.path.basename(uri.rstrip("/")) or "dataset.tar.gz"
        local = os.path.join(dest_dir, name)
        if os.path.exists(local):
            log.info("using cached download %s", local)
            return local
        from fabric_tpu_torch.store import ArtifactStore
        base, rel = uri.rsplit("/", 1)
        log.info("downloading %s", uri)
        start = time.time()
        tmp = local + ".part"
        ArtifactStore(base, blocking=True).download(rel, tmp)
        os.replace(tmp, local)
        log.info("download took %.1fs", time.time() - start)
        return local
    raise FileNotFoundError(f"dataset source not found: {uri}")


def extract(archive: str, dest_dir: str) -> str:
    """Atomically extract a tar archive into ``dest_dir`` (tmp + rename)."""
    parent = os.path.dirname(os.path.abspath(dest_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".extract_", dir=parent)
    try:
        log.info("extracting %s -> %s", archive, dest_dir)
        with tarfile.open(archive) as tf:
            tf.extractall(tmp, filter="data")
        if os.path.isdir(dest_dir):  # lost a race; keep the winner
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, dest_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dest_dir


def dataset_provenance(cfg, resolved_dir: str) -> dict:
    """Dataset identity for the experiment record (the reference logs the
    tarball's name and hash).

    Returns {dataset_dir, dataset_name, archive_sha256?, fingerprint}:
    the archive's content hash when the source archive is still present,
    plus a cheap structural fingerprint (sha256 over the sorted relative
    paths + sizes of every file under labels/ and images/) that catches
    dataset drift without re-reading gigabytes of imagery."""
    import hashlib
    prov: dict = {"dataset_dir": os.path.abspath(resolved_dir),
                  "dataset_name": getattr(cfg, "dataset_name", "")}
    name = prov["dataset_name"]
    if name and os.path.isfile(name) and name.endswith(_ARCHIVE_EXTS):
        h = hashlib.sha256()
        with open(name, "rb") as fin:
            for chunk in iter(lambda: fin.read(1 << 20), b""):
                h.update(chunk)
        prov["archive_sha256"] = h.hexdigest()
    listing = hashlib.sha256()
    n_files = 0
    for sub in ("labels", "images"):
        root = os.path.join(resolved_dir, sub)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for fname in sorted(filenames):
                p = os.path.join(dirpath, fname)
                rel = os.path.relpath(p, resolved_dir)
                listing.update(f"{rel}:{os.path.getsize(p)}\n".encode())
                n_files += 1
    prov["fingerprint"] = listing.hexdigest()
    prov["n_files"] = n_files
    return prov


def ensure_dataset(cfg) -> str:
    """Make sure ``cfg.dataset_dir`` holds a dataset, fetching and
    extracting ``cfg.dataset_name`` if it does not.  Returns the directory
    that holds labels/ (an archive may nest it one level down).  In a
    process group only rank 0 acquires; the others poll for the dataset
    for up to ``_RANK_WAIT_S`` seconds."""
    from fabric_tpu_torch.parallel.distributed import is_primary
    ddir = cfg.dataset_dir
    resolved = resolve_layout(ddir)
    if resolved:
        return resolved
    if not is_primary():
        deadline = time.time() + _RANK_WAIT_S
        while time.time() < deadline:
            resolved = resolve_layout(ddir)
            if resolved:
                return resolved
            time.sleep(5.0)
        raise TimeoutError(f"rank 0 never produced a dataset at {ddir!r}")
    name = getattr(cfg, "dataset_name", "")
    if not name:
        raise FileNotFoundError(f"dataset_dir {ddir!r} missing and no "
                                "dataset_name configured")
    src = fetch(name, os.path.dirname(ddir.rstrip("/")) or ".")
    if src.endswith(_ARCHIVE_EXTS):
        extract(src, ddir)
    elif os.path.isdir(src):
        if os.path.abspath(src) != os.path.abspath(ddir):
            shutil.copytree(src, ddir, dirs_exist_ok=True)
    else:
        raise ValueError(f"don't know how to ingest dataset source {src!r}")
    resolved = resolve_layout(ddir)
    if resolved is None:
        raise FileNotFoundError(
            f"could not locate labels/ inside acquired dataset at {ddir!r} "
            f"(from {name!r}): unexpected archive layout")
    return resolved
