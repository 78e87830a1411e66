"""Sentinel-2 scene acquisition planner (counterpart of
``fabric_tpu/tools/get_data.py``): city list -> BigQuery SQL -> change
pairs -> gsutil download scripts.

Find each city's MGRS tiles in the public BigQuery
``cloud_storage_geo_index.sentinel_2_index`` table, pick low-cloud scenes,
and take the first and last sensing date of each tile as the
change-detection pair.  This module only *writes* the SQL, the gsutil
script and the pair CSVs: it does no network I/O, so it runs anywhere;
paste the SQL into BigQuery (or pipe it to ``bq query``) and run the
``.sh``.  Geocoding is an input, a ``{city: [lat, lon]}`` JSON table from
any geocoder.

Usage:
  python -m fabric_tpu_torch.tools.get_data queries --cities cities.txt \
      --geocode geocode.json --out_dir plan/
  python -m fabric_tpu_torch.tools.get_data plan --metadata scenes.json \
      --out_dir plan/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Iterable

TABLE = "bigquery-public-data.cloud_storage_geo_index.sentinel_2_index"


def tile_query(lat: float, lon: float) -> str:
    """SQL listing the MGRS tiles whose footprint contains (lat, lon)
    (get_data.ipynb cell 7 semantics)."""
    return (f"SELECT mgrs_tile FROM `{TABLE}` "
            f"WHERE north_lat > {lat} AND south_lat < {lat} "
            f"AND west_lon < {lon} AND east_lon > {lon} "
            f"GROUP BY mgrs_tile")


def scene_query(mgrs_tile: str, max_cloud: float = 1.0,
                min_size_bytes: int = 500_000_000) -> str:
    """SQL listing low-cloud, full-size scenes for one tile (cell 8
    semantics: cloud_cover < 1.0%, total_size > 500 MB)."""
    return (f"SELECT base_url, sensing_time FROM `{TABLE}` "
            f'WHERE cloud_cover < "{max_cloud}" '
            f'AND mgrs_tile="{mgrs_tile}" '
            f"AND total_size > {min_size_bytes}")


def select_change_pairs(metadata: dict) -> dict:
    """{city: {tile: [[base_url, sensing_time], ...]}} → earliest/latest
    scene per tile (cell 11: sort by sensing_time, take first and last).
    Tiles with no qualifying scenes are dropped."""
    out: dict = {}
    for city, tiles in metadata.items():
        picked = {}
        for tile_id, scenes in tiles.items():
            if not scenes:
                continue
            ordered = sorted(scenes, key=lambda s: s[1])
            picked[tile_id] = [ordered[0][0], ordered[-1][0]]
        out[city] = picked
    return out


def gsutil_script(pairs: dict) -> str:
    """Deduplicated ``gsutil -m cp -r <url> .`` download script for every
    scene referenced by any pair (cell 13 semantics)."""
    lines, seen = [], set()
    for city in pairs:
        for tile_id, (first, last) in pairs[city].items():
            for url in (first, last):
                if url not in seen:
                    seen.add(url)
                    lines.append(f"gsutil -m cp -r {url} . \n")
    return "".join(lines)


def _safe_name(url: str) -> str:
    return url.rstrip("/").split("/")[-1]


def _sensing_stamp(url: str) -> str:
    """Sensing timestamp from a SAFE product name (field 3 of the
    underscore-split name, e.g. S2A_MSIL1C_20180115T..._..._T32ULC_...)."""
    parts = _safe_name(url).split("_")
    return parts[2] if len(parts) > 2 else _safe_name(url)


def distinct_pairs(pairs: dict) -> list:
    """Unique (first_url, last_url, tile_id) triples across cities
    (cell 14)."""
    out, seen = [], set()
    for city in pairs:
        for tile_id, (first, last) in pairs[city].items():
            key = f"{first}_{last}"
            if key not in seen:
                seen.add(key)
                out.append([first, last, tile_id])
    return out


def pairs_csv_rows(pairs_list: list) -> list:
    """[date1, safe1, date2, safe2, tile] rows (cell 16)."""
    rows = []
    for first, last, tile_id in pairs_list:
        rows.append([_sensing_stamp(first), _safe_name(first),
                     _sensing_stamp(last), _safe_name(last), tile_id])
    return rows


def analysis_csv_rows(pairs: dict) -> list:
    """[city, tile, day1, day2] rows, dates truncated to the day
    (cell 17)."""
    plist = distinct_pairs(pairs)
    tile_days = {tile: (_sensing_stamp(first).split("T")[0],
                        _sensing_stamp(last).split("T")[0])
                 for first, last, tile in plist}
    rows = []
    for city in pairs:
        for tile_id in pairs[city]:
            d1, d2 = tile_days[tile_id]
            rows.append([city, tile_id, d1, d2])
    return rows


def write_queries(cities: Iterable[str], geocode: dict, out_dir: str) -> dict:
    """Emit tile-lookup SQL for every geocodable city; returns
    {city: sql}.  Cities missing from the geocode table are skipped with a
    note in MISSING.txt."""
    os.makedirs(out_dir, exist_ok=True)
    queries, missing = {}, []
    for city in cities:
        if city not in geocode:
            missing.append(city)
            continue
        lat, lon = geocode[city]
        queries[city] = tile_query(float(lat), float(lon))
    with open(os.path.join(out_dir, "tile_queries.sql"), "w") as fout:
        for city, sql in queries.items():
            fout.write(f"-- {city}\n{sql};\n")
    if missing:
        with open(os.path.join(out_dir, "MISSING.txt"), "w") as fout:
            fout.write("\n".join(missing) + "\n")
    return queries


def write_plan(metadata: dict, out_dir: str) -> dict:
    """Emit the full acquisition plan from queried scene metadata:
    inference_metadata.json, download .sh, scene SQL, and the two CSVs."""
    os.makedirs(out_dir, exist_ok=True)
    pairs = select_change_pairs(metadata)
    with open(os.path.join(out_dir, "inference_metadata.json"), "w") as fout:
        json.dump(pairs, fout, indent=2)
    with open(os.path.join(out_dir, "download_tiles.sh"), "w") as fout:
        fout.write(gsutil_script(pairs))
    with open(os.path.join(out_dir, "scene_queries.sql"), "w") as fout:
        tiles = sorted({t for tiles in metadata.values() for t in tiles})
        for t in tiles:
            fout.write(scene_query(t) + ";\n")
    plist = distinct_pairs(pairs)
    with open(os.path.join(out_dir, "distinct_pairs.csv"), "w",
              newline="") as fout:
        csv.writer(fout).writerows(pairs_csv_rows(plist))
    with open(os.path.join(out_dir, "inference_analysis.csv"), "w",
              newline="") as fout:
        csv.writer(fout).writerows(analysis_csv_rows(pairs))
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    q = sub.add_parser("queries", help="city list -> tile-lookup SQL")
    q.add_argument("--cities", required=True,
                   help="text file, one city per line")
    q.add_argument("--geocode", required=True,
                   help="JSON {city: [lat, lon]}")
    q.add_argument("--out_dir", required=True)
    p = sub.add_parser("plan", help="scene metadata -> pairs + scripts")
    p.add_argument("--metadata", required=True,
                   help="JSON {city: {tile: [[base_url, sensing_time]...]}}")
    p.add_argument("--out_dir", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "queries":
        with open(args.cities) as fin:
            cities = [c.strip() for c in fin if c.strip()]
        with open(args.geocode) as fin:
            geocode = json.load(fin)
        queries = write_queries(cities, geocode, args.out_dir)
        print(f"wrote {len(queries)} tile queries to {args.out_dir}")
    else:
        with open(args.metadata) as fin:
            metadata = json.load(fin)
        pairs = write_plan(metadata, args.out_dir)
        n = sum(len(v) for v in pairs.values())
        print(f"planned {n} tile pairs across {len(pairs)} cities "
              f"-> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
