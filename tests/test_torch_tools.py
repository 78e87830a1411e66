"""The port's host-only tools (band_stats, make_labels, get_data) against
fabric_tpu's on the same inputs: band statistics equal in float64, masks
and PNGs equal, and every file the planner writes equal byte for byte."""

import json
import os

import numpy as np
import pytest

from fabric_tpu.tools import band_stats as jax_band_stats
from fabric_tpu.tools import get_data as jax_get_data
from fabric_tpu.tools import make_labels as jax_make_labels

from fabric_tpu_torch.config import Config
from fabric_tpu_torch.data.image import read_png_gray
from fabric_tpu_torch.data.synthetic import generate_synthetic_dataset
from fabric_tpu_torch.tools import band_stats, get_data, make_labels


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two 2-date cities and one 3-date city (band_stats reads every date
    on disk)."""
    root = str(tmp_path_factory.mktemp("tools") / "data")
    generate_synthetic_dataset(root, Config(), cities=["alpha", "beta"],
                               sizes=[(40, 56), (32, 24)], seed=3)
    generate_synthetic_dataset(root + "3", Config(), cities=["gamma"],
                               sizes=[(24, 40)], seed=4, num_dates=3)
    for kind in ("images", "labels"):
        os.rename(os.path.join(root + "3", kind, "gamma"),
                  os.path.join(root, kind, "gamma"))
    return root


def test_band_stats_equal_fabric_tpu(dataset, tmp_path, capsys):
    from fabric_tpu_torch.data import oscd
    assert [oscd.num_dates_on_disk(dataset, c)
            for c in oscd.list_cities(dataset)] == [2, 2, 3]
    bands = Config().band_ids
    got = band_stats.compute_band_stats(dataset, bands)
    want = jax_band_stats.compute_band_stats(dataset, bands)
    assert got == want
    assert list(got["band_means"]) == bands
    assert all(v > 0 for v in got["band_stds"].values())
    out = tmp_path / "stats.json"
    assert band_stats.main(["--dataset_dir", dataset,
                            "--output", str(out)]) == 0
    assert json.loads(out.read_text()) == want
    assert band_stats.main(["--dataset_dir", dataset]) == 0
    assert jax_band_stats.main(["--dataset_dir", dataset]) == 0
    printed = capsys.readouterr().out
    half = len(printed) // 2
    assert printed[:half] == printed[half:] == out.read_text() + "\n"


GEOMETRIES = {
    "rectangle": {"type": "Polygon",
                  "coordinates": [[[3, 4], [20, 4], [20, 15], [3, 15]]]},
    "multipolygon": {"type": "MultiPolygon", "coordinates": [
        [[[1.5, 1.5], [8.2, 2.7], [5.1, 9.9]]],
        [[[22, 18], [30, 20.5], [27.3, 29], [19.6, 26.4]]]]},
    # the hole is not cut (both packages fill the exterior ring only)
    "ring_with_hole": {"type": "Feature", "geometry": {
        "type": "Polygon", "coordinates": [
            [[2, 2], [28, 2], [28, 24], [2, 24]],
            [[10, 8], [18, 8], [18, 16], [10, 16]]]}},
    "clipped_by_border": {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [
            [[-6.5, 20], [12, -5.2], [40, 12.7], [25, 41]]]}}]},
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_make_labels_masks_equal_fabric_tpu(name, tmp_path):
    gj = GEOMETRIES[name]
    got = make_labels.rasterize_geojson(gj, 30, 33)
    want = jax_make_labels.rasterize_geojson(gj, 30, 33)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    path = tmp_path / "in.json"
    path.write_text(json.dumps(gj))
    outs = []
    for main, tag in ((make_labels.main, "port"), (jax_make_labels.main,
                                                   "jax")):
        out = str(tmp_path / tag / "cm" / "cm.png")
        assert main(["--geojson", str(path), "--height", "30", "--width",
                     "33", "--output", out]) == 0
        outs.append(out)
    np.testing.assert_array_equal(read_png_gray(outs[0]), got * 255)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()


CITIES = ["Lisbon", "Nowhere", "Dubai"]
GEOCODE = {"Lisbon": [38.7223, -9.1393], "Dubai": [25.2048, 55.2708]}
METADATA = {
    "Lisbon": {"29SMC": [
        ["gs://gcp-public-data-sentinel-2/tiles/29/S/MC/"
         "S2A_MSIL1C_20180912T112111_N0206_R037_T29SMC_20180912T132710.SAFE",
         "2018-09-12T11:21:11"],
        ["gs://gcp-public-data-sentinel-2/tiles/29/S/MC/"
         "S2B_MSIL1C_20160402T112122_N0201_R037_T29SMC_20160402T112512.SAFE",
         "2016-04-02T11:21:22"],
        ["gs://gcp-public-data-sentinel-2/tiles/29/S/MC/"
         "S2A_MSIL1C_20170505T112111_N0205_R037_T29SMC_20170505T112512.SAFE",
         "2017-05-05T11:21:11"]],
        "29SNC": []},
    "Dubai": {"40RCN": [
        ["gs://gcp-public-data-sentinel-2/tiles/40/R/CN/"
         "S2A_MSIL1C_20151231T065222_N0201_R020_T40RCN_20151231T065220.SAFE",
         "2015-12-31T06:52:22"],
        ["gs://gcp-public-data-sentinel-2/tiles/40/R/CN/"
         "S2B_MSIL1C_20190105T065229_N0207_R020_T40RCN_20190105T084905.SAFE",
         "2019-01-05T06:52:29"]]},
    "Abu Dhabi": {"40RCN": [
        ["gs://gcp-public-data-sentinel-2/tiles/40/R/CN/"
         "S2A_MSIL1C_20151231T065222_N0201_R020_T40RCN_20151231T065220.SAFE",
         "2015-12-31T06:52:22"],
        ["gs://gcp-public-data-sentinel-2/tiles/40/R/CN/"
         "S2B_MSIL1C_20190105T065229_N0207_R020_T40RCN_20190105T084905.SAFE",
         "2019-01-05T06:52:29"]]},
}


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fin:
            out[name] = fin.read()
    return out


def test_get_data_writes_fabric_tpus_files(tmp_path):
    """The queries and plan steps through both CLIs: the same files with
    the same bytes (SQL, MISSING.txt, the pairs JSON, the gsutil script
    and both CSVs)."""
    cities = tmp_path / "cities.txt"
    cities.write_text("\n".join(CITIES) + "\n\n")
    geocode = tmp_path / "geocode.json"
    geocode.write_text(json.dumps(GEOCODE))
    meta = tmp_path / "scenes.json"
    meta.write_text(json.dumps(METADATA))
    written = []
    for main, tag in ((get_data.main, "port"), (jax_get_data.main, "jax")):
        out = str(tmp_path / tag)
        assert main(["queries", "--cities", str(cities), "--geocode",
                     str(geocode), "--out_dir", out]) == 0
        assert main(["plan", "--metadata", str(meta), "--out_dir", out]) == 0
        written.append(_files(out))
    assert written[0] == written[1]
    assert sorted(written[0]) == [
        "MISSING.txt", "distinct_pairs.csv", "download_tiles.sh",
        "inference_analysis.csv", "inference_metadata.json",
        "scene_queries.sql", "tile_queries.sql"]
    assert written[0]["MISSING.txt"] == b"Nowhere\n"
    # the shared tile's pair is downloaded once
    assert written[0]["download_tiles.sh"].count(b"gsutil") == 4
