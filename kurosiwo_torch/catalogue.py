"""Offline catalogue builder; the port's own copy of ``kurosiwo_tpu/catalogue.py``
(the same arguments and outputs): filters the Kuro Siwo grid catalogue and
writes the compressed-pickle grid index the loaders read.

    python -m kurosiwo_torch.catalogue --catalogue_path CATALOGUE.gpkg \
        [--yaml catalogue.yaml] [-pv "[lo,hi]"] [-pw ...] [-pf ...] [-pW ...] \
        [--info] [--out grid_dict.gz]

The reference's counterpart is its ``catalogue/catalogue.py`` (608 lines on
geopandas). What it reproduces:
  * reads the catalogue GeoPackage with sqlite3 (a .gpkg IS a SQLite
    database; only attribute columns are needed for filtering, so no
    geopandas or GDAL);
  * range filters on coverage / permanent-water / flood / total-water
    percentages (-pv/-pw/-pf/-pW, template "[lo,hi]");
  * the per-grid product model: the naming convention
    {MS|SL|MK}{rank}_{IVH|IVV|MNA|MLU|DEM}_{actid}_{aoiid}_{date}.tif with
    the nodata and dtype conventions IVH/IVV float32 nodata 0.0, MNA uint8
    0, MLU uint8 3 (catalogue.py:61-136);
  * the path layout <actid>/<aoiid:02d>/<grid-uuid-hex> for AOI grids and
    <actid>/00/<hex[:2]>/<hex> outside AOIs (catalogue.py:163-178);
  * climate-zone metadata joined from catalogue.yaml (activation/AOI ->
    cl_zone/cl_name);
  * writes grid_dict[hex] = {path, info, clz, clz_name} as a gzip pickle,
    which ``kurosiwo_torch.data.index`` reads.
Host-only: sqlite3 and yaml, no torch.
"""

from __future__ import annotations

import argparse
import gzip
import json
import pickle
import sqlite3
from pathlib import Path

PRODUCT_NODATA = {"IVH": 0.0, "IVV": 0.0, "MNA": 0, "MLU": 3}
PRODUCT_DTYPE = {"IVH": "float32", "IVV": "float32", "MNA": "uint8", "MLU": "uint8"}


def product_type(master: bool, rank: int) -> str:
    return ("MS" if master else "SL") if rank else "MK"


def grid_rel_path(actid, aoiid, grid_hex: str) -> str:
    """catalogue.py:163-178 path convention."""
    if aoiid is not None:
        return f"{actid}/{int(aoiid):02d}/{grid_hex}"
    return f"{actid}/00/{grid_hex[:2]}/{grid_hex}"


def _feature_table(con: sqlite3.Connection) -> str:
    row = con.execute(
        "SELECT table_name FROM gpkg_contents WHERE data_type='features' LIMIT 1"
    ).fetchone()
    if row is None:
        raise ValueError("no feature table in GeoPackage")
    return row[0]


def read_catalogue(gpkg_path: str | Path) -> list[dict]:
    """Attribute rows of the catalogue feature table (geometry EXCLUDED from
    the SELECT — the polygon WKB blobs are hundreds of bytes per row and the
    builder never reads them; ~700k rows make that real I/O)."""
    con = sqlite3.connect(str(gpkg_path))
    con.row_factory = sqlite3.Row
    try:
        table = _feature_table(con)
        try:
            geom = {
                r[0]
                for r in con.execute(
                    "SELECT column_name FROM gpkg_geometry_columns WHERE table_name=?", (table,)
                )
            }
        except sqlite3.OperationalError:  # minimal fixtures without the gpkg metadata table
            geom = set()
        cols = [r[1] for r in con.execute(f'PRAGMA table_info("{table}")') if r[1] not in geom]
        col_sql = ", ".join(f'"{c}"' for c in cols)
        rows = [dict(r) for r in con.execute(f'SELECT {col_sql} FROM "{table}"')]
    finally:
        con.close()
    return rows


def load_aoi_metadata(yaml_path: str | Path | None) -> dict:
    """catalogue.yaml -> {act_id: {"aois": {aoi_id: {cl_zone, cl_name}}}}.

    The real catalogue.yaml (reference catalogue/catalogue.py:33-50) uses a
    custom `!join` tag (path assembly) and stores Floods as a LIST of
    {act_id, aois: [{aoi_id: '01', cl_zone}]}; cl_name is joined from the
    CL_ZONES table. Both are handled here; a pre-normalized mapping (tests)
    passes through unchanged."""
    if yaml_path is None or not Path(yaml_path).exists():
        return {}
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor(
        "!join", lambda loader, node: "".join(str(x) for x in loader.construct_sequence(node))
    )
    with open(yaml_path) as f:
        cfg = yaml.load(f, Loader=_Loader)
    if not isinstance(cfg, dict):
        return {}
    floods = cfg.get("Floods", cfg)
    if isinstance(floods, dict):  # already normalized (test fixtures)
        return floods
    zones = {z.get("cl_zone"): z.get("cl_name") for z in cfg.get("CL_ZONES", [])}
    out: dict = {}
    for f_ in floods or []:
        aois = {}
        for a in f_.get("aois", []) or []:
            cz = a.get("cl_zone")
            # normalize to the zero-padded form build_grid_dict looks up with
            # (f"{int(aoiid):02d}"): YAML parses an unquoted 01 as int 1, and
            # str(1) != "01" would silently default the grid's climate zone
            aid = a.get("aoi_id")
            try:
                key = f"{int(aid):02d}"
            except (TypeError, ValueError):
                key = str(aid)
            aois[key] = {"cl_zone": cz, "cl_name": zones.get(cz)}
        out[str(f_.get("act_id"))] = {"aois": aois}
    return out


def _grid_hex(grid_id) -> str:
    if isinstance(grid_id, (bytes, bytearray)):
        return bytes(grid_id).hex()
    s = str(grid_id).replace("-", "")
    return s


def filter_rows(
    rows: list[dict],
    pcovered=None,
    ppermwater=None,
    pflooded=None,
    pwater=None,
) -> list[dict]:
    """Range filtering parity (catalogue.py:300-337); only valid grids."""
    def between(v, rng):
        return v is not None and rng[0] <= v <= rng[1]

    out = []
    for r in rows:
        if not r.get("gvalid", True):
            continue
        if pcovered and not between(r.get("pcovered"), pcovered):
            continue
        if ppermwater and not between(r.get("pwater"), ppermwater):
            continue
        if pflooded and not between(r.get("pflood"), pflooded):
            continue
        if pwater:
            pw, pf = r.get("pwater"), r.get("pflood")
            # NULL propagates like pandas NaN: (pwater+pflood).between() is
            # False for missing stats (reference catalogue.py:312) — coercing
            # to 0 would KEEP rows the reference drops
            total = None if (pw is None or pf is None) else pw + pf
            if not between(total, pwater):
                continue
        out.append(r)
    out.sort(key=lambda r: (r.get("actid") or 0, r.get("aoiid") or 0, str(r.get("grid_id")),
                            r.get("master") or 0, r.get("crank") or 0))
    return out


def build_grid_dict(rows: list[dict], aoi_meta: dict) -> dict:
    """grid_dict[hex] = {path, info, clz, clz_name} (catalogue.py:470-509)."""
    grid_dict: dict = {}
    for r in rows:
        # one entry per grid: keyed by master record
        if not r.get("master", True):
            continue
        gh = _grid_hex(r["grid_id"])
        actid, aoiid = r.get("actid"), r.get("aoiid")
        # non-AOI grids (aoiid NULL -> 999999) are excluded from the grid
        # dict like the reference (catalogue.py:129-130 rewrites None to
        # 999999, :479-480 skips those paths) — their tiles are not part of
        # the distributed corpus
        if aoiid is None or int(aoiid) == 999999:
            continue
        meta = {}
        try:
            meta = aoi_meta[str(actid)]["aois"][f"{int(aoiid):02d}"]
        except (KeyError, TypeError, ValueError):
            meta = {"cl_zone": None, "cl_name": None}
        info = {
            "actid": actid,
            "aoiid": aoiid if aoiid is not None else 999999,
            "pcovered": r.get("pcovered"),
            "pwater": r.get("pwater"),
            "pflood": r.get("pflood"),
            "crank": r.get("crank"),
        }
        grid_dict[gh] = {
            "path": grid_rel_path(actid, aoiid, gh),
            "info": info,
            "clz": meta.get("cl_zone") or 1,
            "clz_name": meta.get("cl_name"),
        }
    return grid_dict


def write_grid_dict(grid_dict: dict, out_path: str | Path):
    with gzip.open(out_path, "wb") as f:
        pickle.dump(grid_dict, f)


def _parse_range(text):
    if text is None:
        return None
    v = json.loads(text)
    # ValueError, not assert: user CLI input must stay validated under -O
    if not (isinstance(v, list) and len(v) == 2 and 0 <= v[0] <= 100 and 0 <= v[1] <= 100):
        raise ValueError("Range value error, use template e.g: [0,100]")
    return v


def main(argv=None):
    p = argparse.ArgumentParser(description="Kuro Siwo catalogue builder")
    p.add_argument("--catalogue_path", required=True, help="catalogue .gpkg")
    p.add_argument("--yaml", default=None, help="catalogue.yaml activation metadata")
    p.add_argument("-pv", "--pcovered", default=None, help='coverage %% range "[lo,hi]"')
    p.add_argument("-pw", "--ppermwater", default=None, help='permanent water %% range')
    p.add_argument("-pf", "--pflooded", default=None, help='flood %% range')
    p.add_argument("-pW", "--pwater", default=None, help='total water %% range')
    p.add_argument("--info", action="store_true", help="print stats only")
    p.add_argument("--out", default="grid_dict.gz", help="output gzip pickle")
    args = p.parse_args(argv)

    rows = read_catalogue(args.catalogue_path)
    rows = filter_rows(
        rows,
        _parse_range(args.pcovered),
        _parse_range(args.ppermwater),
        _parse_range(args.pflooded),
        _parse_range(args.pwater),
    )
    actids = sorted({r.get("actid") for r in rows})
    stats = {
        "records": len(rows),
        "activations": len(actids),
        "actids": actids,
        "grids": len({str(r.get("grid_id")) for r in rows}),
    }
    print("Stats for query:")
    print(json.dumps(stats, default=str))
    if args.info:
        return
    grid_dict = build_grid_dict(rows, load_aoi_metadata(args.yaml))
    write_grid_dict(grid_dict, args.out)
    print(f"Wrote {len(grid_dict)} grids to {args.out}")


if __name__ == "__main__":
    main()
