"""The port's catalogue builder (kurosiwo_torch/catalogue.py) against the JAX
package's ``catalogue.main`` on a test-written GeoPackage (a sqlite file
with the gpkg metadata tables, a geometry column the builder must not read,
NULL statistics, an invalid grid, a non-AOI grid and a master/slave pair)
and a catalogue.yaml in the reference's list form with its ``!join`` tag:
the same arguments give the same printed statistics and the same
``grid_dict`` pickle, key for key; the module runs as
``python -m kurosiwo_torch.catalogue``."""

import gzip
import pickle
import sqlite3
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest

from kurosiwo_torch import catalogue as tcat
from kurosiwo_torch.data.index import load_grid_index
from kurosiwo_tpu import catalogue as jcat

REPO = Path(__file__).resolve().parent.parent

YAML = """\
root: !join [/data/, kurosiwo]
CL_ZONES:
  - {cl_zone: 1, cl_name: Tropical}
  - {cl_zone: 2, cl_name: Arid}
  - {cl_zone: 3, cl_name: Temperate}
Floods:
  - act_id: 130
    aois: [{aoi_id: 01, cl_zone: 2}, {aoi_id: '02', cl_zone: 3}]
  - act_id: 470
    aois: [{aoi_id: 1, cl_zone: 1}]
"""


@pytest.fixture(scope="module")
def gpkg(tmp_path_factory):
    root = tmp_path_factory.mktemp("catalogue")
    path = root / "catalogue.gpkg"
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE gpkg_contents (table_name TEXT, data_type TEXT)")
    con.execute("INSERT INTO gpkg_contents VALUES ('grids', 'features')")
    con.execute("CREATE TABLE gpkg_geometry_columns (table_name TEXT, column_name TEXT)")
    con.execute("INSERT INTO gpkg_geometry_columns VALUES ('grids', 'geom')")
    con.execute("CREATE TABLE grids (grid_id TEXT, gvalid INT, pcovered REAL, pwater REAL,"
                " pflood REAL, actid INT, aoiid INT, master INT, crank INT, geom BLOB)")
    rs = np.random.RandomState(0)
    rows = []
    for i in range(40):
        act = (130, 470)[i % 2]
        pw = None if i % 11 == 5 else float(rs.uniform(0, 20))
        rows.append((uuid.UUID(int=i).hex, 1, float(rs.uniform(0, 100)), pw,
                     float(rs.uniform(0, 20)), act, 1 + i % 2, 1, 1 + i % 3, b"\x00" * 64))
        if i % 7 == 0:  # the grid's slave product: no entry of its own
            rows.append((uuid.UUID(int=i).hex, 1, 50.0, 5.0, 5.0, act, 1 + i % 2, 0, 2, b""))
    rows.append((uuid.UUID(int=999).hex, 0, 50.0, 5.0, 5.0, 130, 1, 1, 1, b""))  # invalid
    rows.append((uuid.UUID(int=998).hex, 1, 50.0, 5.0, 5.0, 130, None, 1, 1, b""))  # no AOI
    con.executemany("INSERT INTO grids VALUES (?,?,?,?,?,?,?,?,?,?)", rows)
    con.commit()
    con.close()
    yaml_path = root / "catalogue.yaml"
    yaml_path.write_text(YAML)
    return path, yaml_path


FILTERS = {
    "all": [],
    "coverage": ["-pv", "[40,100]"],
    "water": ["-pw", "[0,10]", "-pf", "[2,18]"],
    "total water": ["-pW", "[5,30]"],
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_grid_dict_equals_jax_catalogue_main(gpkg, tmp_path, capsys, name):
    path, yaml_path = gpkg
    outs = {}
    for tag, main in (("jax", jcat.main), ("torch", tcat.main)):
        out = tmp_path / f"{tag}.gz"
        main(["--catalogue_path", str(path), "--yaml", str(yaml_path), "--out", str(out),
              *FILTERS[name]])
        printed = capsys.readouterr().out.replace(str(out), "OUT")
        with gzip.open(out, "rb") as f:
            outs[tag] = (printed, pickle.load(f))
    assert outs["torch"] == outs["jax"]
    grid_dict = outs["torch"][1]
    assert grid_dict and load_grid_index(tmp_path / "torch.gz") == grid_dict
    # 130's AOI 01 joins its zone; 470's AOI 02 is not in the yaml
    assert {v["clz_name"] for v in grid_dict.values()} == {"Arid", None}


def test_info_prints_the_statistics_alone(gpkg, tmp_path, capsys):
    path, _ = gpkg
    for main in (jcat.main, tcat.main):
        main(["--catalogue_path", str(path), "--info", "--out", str(tmp_path / "x.gz")])
    jax_out, torch_out = capsys.readouterr().out.split("Stats for query:")[1:]
    assert jax_out == torch_out
    assert not (tmp_path / "x.gz").exists()


def test_bad_range_raises_as_jax():
    for mod in (jcat, tcat):
        with pytest.raises(ValueError, match="Range value error"):
            mod._parse_range("[0,200]")


def test_module_runs_as_a_command(gpkg, tmp_path):
    path, yaml_path = gpkg
    out = tmp_path / "cmd.gz"
    proc = subprocess.run([sys.executable, "-m", "kurosiwo_torch.catalogue", "--catalogue_path",
                           str(path), "--yaml", str(yaml_path), "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"to {out}" in proc.stdout and load_grid_index(out)
