"""The port's artifact store (fabric_tpu_torch/store.py), the tests of
tests/test_store.py on it: file:// stores for upload-after-save
mirroring, tolerated upload failures, resume from a store URI, and the
gs:// paths gated where gsutil and gcloud are absent.  Beside them, the
port's loop mirrors every save and resumes from the store bit-exactly."""

import json
import os

import numpy as np
import pytest

import torch

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.store import ArtifactStore, fetch_resume, open_store

torch.set_num_threads(1)


def test_file_store_roundtrip(tmp_path):
    store = ArtifactStore(f"file://{tmp_path}/remote")
    src = tmp_path / "a.txt"
    src.write_text("payload")
    store.upload(str(src))
    store.upload(str(src), rel="nested/dir/b.txt")
    assert store.flush() == 0
    assert (tmp_path / "remote" / "a.txt").read_text() == "payload"
    assert (tmp_path / "remote" / "nested" / "dir" / "b.txt").exists()
    # ingress
    out = tmp_path / "back.txt"
    store.download("a.txt", str(out))
    assert out.read_text() == "payload"


def test_store_dir_mirror_and_download(tmp_path):
    local = tmp_path / "tree"
    (local / "sub").mkdir(parents=True)
    (local / "x.json").write_text("{}")
    (local / "sub" / "y.bin").write_bytes(b"\x00\x01")
    store = ArtifactStore(str(tmp_path / "remote"), blocking=True)
    store.upload_dir(str(local), rel="run1")
    assert (tmp_path / "remote" / "run1" / "sub" / "y.bin").exists()
    back = tmp_path / "back"
    store.download_dir("run1", str(back))
    assert (back / "x.json").read_text() == "{}"


def test_upload_failure_is_tolerated(tmp_path, caplog):
    import logging
    store = ArtifactStore(str(tmp_path / "remote"))
    with caplog.at_level(logging.WARNING, logger="fabric_tpu_torch"):
        store.upload(str(tmp_path / "does-not-exist.bin"))
        failed = store.flush()
    assert failed == 1
    assert any("upload" in r.message and "failed" in r.message
               for r in caplog.records)


def test_open_store_empty_uri_is_none():
    assert open_store("") is None
    with pytest.raises(ValueError):
        open_store("s3://bucket/prefix")


def test_upload_checkpoint_mirrors_save_footprint(tmp_path):
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.state import create_state
    cfg = Config(patch_size=16, dtype="float32", model_base=8)
    state = create_state(cfg, build_model(cfg, "cpu", fold_bn=False,
                                          train=True))
    wdir = tmp_path / "w"
    path = ckpt.save(state, str(wdir), 0, metadata={"m": 1})
    store = ArtifactStore(str(tmp_path / "remote"), blocking=True)
    store.upload_checkpoint(str(wdir), path)
    remote = tmp_path / "remote"
    for name in ("checkpoint_epoch_0.msgpack", "metadata_epoch_0.json",
                 "latest.json", "best.json"):
        assert (remote / name).exists(), name


def test_train_mirrors_to_store_and_resumes_from_uri(tmp_path):
    """Train with output_store=file://..., lose the local weights, resume
    from the store URI: the restored state equals the local checkpoint's
    bit for bit, and the resumed run trains only the epoch after it."""
    from fabric_tpu_torch import checkpoint as ckpt
    from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
    from fabric_tpu_torch.models import build_model
    from fabric_tpu_torch.train.loop import train
    from fabric_tpu_torch.train.state import create_state

    cfg = Config(
        dataset_dir=str(tmp_path / "data"),
        weight_dir=str(tmp_path / "weights"),
        log_dir=str(tmp_path / "logs"),
        output_store=f"file://{tmp_path}/remote",
        patch_size=16, stride=16, batch_size=8, epochs=1, model_base=8,
        steps_per_epoch=2, learning_rate=0.05, dtype="float32",
        checkpoint_every=1, keep_last=1, validation_cities=["beta"],
        num_workers=0, prefetch=1, seed=0)
    generate_synthetic_dataset(cfg.dataset_dir, cfg, seed=3)
    state, history = train(cfg, run_scene_inference=False, device="cpu")
    assert history["status"] == "complete"
    remote = tmp_path / "remote"
    names = os.listdir(remote)
    # every save mirrored: pruned periodic saves too, with their sidecars
    assert {"checkpoint_epoch_0.msgpack", "metadata_epoch_0.json",
            "periodic_epoch_0.msgpack", "metadata_periodic_epoch_0.json",
            "latest.json", "best.json"} <= set(names), names
    assert not os.listdir(tmp_path / "weights" / ".upload_spool")
    tracked = list((remote / "tracker").rglob("metrics.jsonl"))
    assert tracked, names
    local = ckpt.read_payload(ckpt.latest_checkpoint(cfg.weight_dir))

    import shutil
    shutil.rmtree(cfg.weight_dir)
    cfg2 = Config.from_dict({**cfg.to_dict(), "epochs": 2,
                             "resume": f"file://{tmp_path}/remote",
                             "output_store": ""})
    restored = create_state(cfg2, build_model(cfg2, "cpu", fold_bn=False,
                                              train=True))
    restored, epoch, _ = ckpt.resume_if_requested(cfg2, restored)
    assert epoch == 0 and restored.step == local["step"] == 2
    for got, want in zip(restored.variables(),
                         (local["params"], local["batch_stats"])):
        fg, fw = _flat(got), _flat(want)
        assert fg.keys() == fw.keys()
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    state2, history2 = train(cfg2, run_scene_inference=False, device="cpu")
    assert len(history2["train"]) == 1  # only the epoch after the resume
    assert state2.step == 4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_fetch_resume_single_file(tmp_path):
    src = tmp_path / "remote"
    src.mkdir()
    (src / "checkpoint_epoch_2.msgpack").write_bytes(b"abc")
    local = fetch_resume(f"file://{src}/checkpoint_epoch_2.msgpack",
                         str(tmp_path / "cache"))
    assert local.endswith("checkpoint_epoch_2.msgpack")
    assert open(local, "rb").read() == b"abc"
    # local paths pass through untouched
    assert fetch_resume("/some/local/path", "/c") == "/some/local/path"


def test_gs_fetch_is_gated(tmp_path, monkeypatch):
    """Without gsutil/gcloud on PATH, a gs:// source raises the
    informative construction error (not a deep subprocess failure)."""
    import fabric_tpu_torch.store as store_mod
    monkeypatch.setattr(store_mod.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="gsutil or gcloud"):
        ArtifactStore("gs://bucket/prefix")
    from fabric_tpu_torch.data.download import fetch
    with pytest.raises(RuntimeError, match="gsutil or gcloud"):
        fetch("gs://bucket/data.tar.gz", str(tmp_path))


def test_async_upload_survives_source_prune(tmp_path, monkeypatch):
    """Checkpoint retention may delete an old save while its upload is
    still queued: the enqueue-time hardlink snapshot lets the transfer
    complete with the enqueue-time content."""
    import threading

    import fabric_tpu_torch.store as store_mod

    gate = threading.Event()
    orig = store_mod.ArtifactStore._transfer

    def slow(self, src, rel):
        gate.wait(10)  # hold the worker until the source is pruned
        return orig(self, src, rel)

    monkeypatch.setattr(store_mod.ArtifactStore, "_transfer", slow)
    wdir = tmp_path / "w"
    wdir.mkdir()
    f = wdir / "checkpoint_epoch_0.msgpack"
    f.write_bytes(b"payload-at-enqueue")
    st = ArtifactStore(str(tmp_path / "remote"))
    st.upload(str(f))
    f.unlink()  # retention prunes before the worker gets to it
    gate.set()
    assert st.flush() == 0  # no failed transfers
    dest = tmp_path / "remote" / "checkpoint_epoch_0.msgpack"
    assert dest.read_bytes() == b"payload-at-enqueue"
    assert not list((wdir / ".upload_spool").iterdir())  # snapshot freed


def test_download_dir_copies_contents_not_the_directory(tmp_path,
                                                        monkeypatch):
    """Both GCS tools copy the prefix's contents ('prefix/*') into the
    destination: a bare 'cp -r gs://b/run1 dest' nests dest/run1/... and
    breaks resume's pointer resolution against dest."""
    import fabric_tpu_torch.store as store_mod

    calls = []

    def fake_run(argv, **kwargs):
        calls.append(list(argv))

    monkeypatch.setattr(store_mod.shutil, "which", lambda name: name)
    monkeypatch.setattr(store_mod.subprocess, "run", fake_run)
    for tool in (("gsutil",), ("gcloud", "storage")):
        monkeypatch.setattr(store_mod, "_GS_CANDIDATES", (tool,))
        st = ArtifactStore("gs://bucket/run42")
        st.download_dir("", str(tmp_path / "local"))
        st.download_dir("sub", str(tmp_path / "local2"))
    assert calls[0][-2] == "gs://bucket/run42/*"
    assert calls[1][-2] == "gs://bucket/run42/sub/*"
    assert calls[2][-2] == "gs://bucket/run42/*"
    assert calls[3][-2] == "gs://bucket/run42/sub/*"


def test_spool_orphans_from_dead_runs_are_swept(tmp_path):
    """Snapshots left by a crashed or preempted run (dead pid) are
    deleted on first spool use so they cannot pin pruned checkpoint
    payloads, and the pid+instance naming cannot collide with them."""
    wdir = tmp_path / "w"
    wdir.mkdir()
    sdir = wdir / ".upload_spool"
    sdir.mkdir()
    orphan = sdir / "99999999_aa_1_checkpoint_epoch_0.msgpack"
    orphan.write_bytes(b"orphan payload")  # pid 99999999 > pid_max: dead
    f = wdir / "latest.json"
    f.write_bytes(b"live")
    st = ArtifactStore(str(tmp_path / "remote"))
    st.upload(str(f))
    assert st.flush() == 0
    assert not orphan.exists()          # swept on first touch
    assert list(sdir.iterdir()) == []   # own snapshot freed after transfer
    assert (tmp_path / "remote" / "latest.json").read_bytes() == b"live"
