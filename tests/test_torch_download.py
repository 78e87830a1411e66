"""The port's dataset acquisition (fabric_tpu_torch/data/download.py), the
tests of tests/test_download.py on it, with archives built in tmp_path:
an existing directory, an archive extracted flat or nested, local and
file:// sources; ensure_dataset's layout and dataset_provenance equal
fabric_tpu's for the same archive and directory; the loop trains from an
archive dataset_name."""

import os
import tarfile

import pytest
import torch

from fabric_tpu.config import Config as JaxConfig
from fabric_tpu.data import download as jax_download

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.download import (dataset_provenance,
                                            ensure_dataset, extract, fetch)
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset

torch.set_num_threads(1)


def _make_archive(tmp_path, nested=False, cities=("alpha",),
                  sizes=((40, 40),)):
    src = tmp_path / "src"
    generate_synthetic_dataset(str(src), Config(dataset_dir=str(src)),
                               cities=list(cities), sizes=list(sizes))
    archive = str(tmp_path / ("nested.tar.gz" if nested
                              else "onera_w_mask.tar.gz"))
    with tarfile.open(archive, "w:gz") as tf:
        if nested:
            tf.add(str(src), arcname="onera")
        else:
            tf.add(str(src / "images"), arcname="images")
            tf.add(str(src / "labels"), arcname="labels")
    return archive


def test_ensure_dataset_existing_dir(tmp_path):
    cfg = Config(dataset_dir=str(tmp_path))
    generate_synthetic_dataset(str(tmp_path), cfg, cities=["a"],
                               sizes=[(40, 40)])
    assert ensure_dataset(cfg) == str(tmp_path)


@pytest.mark.parametrize("nested", [False, True])
def test_ensure_dataset_extracts_archive_like_fabric_tpu(tmp_path, nested):
    """The same archive extracted by each package: the same resolved
    layout (flat, or one level down for a nested archive), and the same
    provenance record, archive hash and fingerprint included."""
    archive = _make_archive(tmp_path, nested=nested)
    ours = ensure_dataset(Config(dataset_dir=str(tmp_path / "ours"),
                                 dataset_name=archive))
    theirs = jax_download.ensure_dataset(JaxConfig(
        dataset_dir=str(tmp_path / "theirs"), dataset_name=archive))
    assert os.path.isdir(os.path.join(ours, "labels", "alpha"))
    assert os.path.relpath(ours, tmp_path / "ours") == os.path.relpath(
        theirs, tmp_path / "theirs") == ("onera" if nested else ".")
    prov = dataset_provenance(Config(dataset_name=archive), ours)
    want = jax_download.dataset_provenance(JaxConfig(dataset_name=archive),
                                           ours)
    assert prov == want
    assert len(prov["archive_sha256"]) == 64 and prov["n_files"] > 0
    # the extraction is atomic: nothing is left beside it
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".extract_")]


def test_fetch_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        fetch("/does/not/exist.tar.gz", str(tmp_path))


def test_fetch_file_uri(tmp_path):
    archive = _make_archive(tmp_path)
    assert fetch("file://" + archive, str(tmp_path)) == archive


def test_extract_keeps_a_dataset_already_there(tmp_path):
    """A second extraction into an existing directory keeps the first
    (a lost race) and leaves no temporary directory."""
    archive = _make_archive(tmp_path)
    dest = str(tmp_path / "data")
    extract(archive, dest)
    marker = os.path.join(dest, "marker")
    open(marker, "w").close()
    assert extract(archive, dest) == dest and os.path.exists(marker)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".extract_")]


def test_dataset_provenance_tracks_drift(tmp_path):
    """Touching one label changes the fingerprint, in both packages."""
    archive = _make_archive(tmp_path)
    cfg = Config(dataset_dir=str(tmp_path / "data"), dataset_name=archive)
    resolved = ensure_dataset(cfg)
    prov = dataset_provenance(cfg, resolved)
    lab = os.path.join(resolved, "labels", "alpha", "cm", "cm.png")
    with open(lab, "ab") as f:
        f.write(b"\0")
    after = dataset_provenance(cfg, resolved)
    assert after["fingerprint"] != prov["fingerprint"]
    assert after == jax_download.dataset_provenance(
        JaxConfig(dataset_name=archive), resolved)


def test_missing_dataset_without_a_name_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no dataset_name"):
        ensure_dataset(Config(dataset_dir=str(tmp_path / "none"),
                              dataset_name=""))


def test_loop_trains_from_an_archive(tmp_path):
    """loop.train with dataset_dir absent and dataset_name an archive:
    the archive is extracted, trained on, and its provenance recorded
    with the run's params."""
    import json
    from fabric_tpu_torch.train.loop import train
    archive = _make_archive(tmp_path, cities=("alpha", "beta"),
                            sizes=((48, 48), (32, 32)))
    cfg = Config(dataset_dir=str(tmp_path / "data"), dataset_name=archive,
                 weight_dir=str(tmp_path / "w"), log_dir=str(tmp_path / "l"),
                 patch_size=16, stride=16, batch_size=4, epochs=1,
                 model_base=8, dtype="float32", validation_cities=["beta"],
                 num_workers=0, steps_per_epoch=1)
    state, history = train(cfg, run_scene_inference=False, device="cpu")
    assert history["status"] == "complete" and state.step == 1
    assert cfg.dataset_dir == str(tmp_path / "data")
    run = next((tmp_path / "l").iterdir())
    params = json.loads((run / "params.json").read_text())
    assert params["dataset_provenance"]["archive_sha256"] == \
        dataset_provenance(cfg, cfg.dataset_dir)["archive_sha256"]
