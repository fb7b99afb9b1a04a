"""Grid files of the PyTorch port (cice_tpu_torch/io/grids.py and the
fixture writers of io/fixtures.py) against the JAX package's readers on the
same files: the POP netCDF grid, the MOM supergrid and its ocean mask, and
`load_grid_files` for every format. No JAX step compiles.

The fixture's POP binary grid is written in its other forms by the port:
the POP netCDF file holds the same cm values, so the grid it gives equals
the pop_bin grid bit for bit; the MOM supergrid holds each edge as two
halves in metres (exact) and the corners and angles in degrees, so its
latitudes, longitudes and angles come back within 4 ulp of each field's
largest value and everything else exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core import grid as jgrid  # noqa: E402
from cice_tpu.io import grids as jgrids  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.core import grid as tgrid  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402
from cice_tpu_torch.io import grids as tgrids  # noqa: E402

NX, NY = 24, 20
#: fields that pass through degrees in the MOM supergrid
VIA_DEGREES = ("ULAT", "ULON", "TLAT", "TLON", "ANGLE", "ANGLET")
ULP_TOL = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gridfiles"))
    b = tfix.ensure_displaced_pole_grid(NX, NY, root)
    forms = tfix.write_grid_forms(b["grid"], b["kmt"], NX, NY,
                                  os.path.join(root, "grids", "dp"))
    return dict(b, **forms)


def _over(fmt, grid_file, kmt_file="", **kw):
    return {"grid.nx_global": NX, "grid.ny_global": NY,
            "grid.grid_format": fmt, "grid.grid_type": "displaced_pole",
            "grid.grid_file": grid_file, "grid.kmt_file": kmt_file,
            "grid.ew_boundary_type": "cyclic", "dtype": "float64", **kw}


def _pair(over):
    t = tgrids.load_grid_files(Config().with_overrides(**over),
                               device="cpu")
    j = jgrids.load_grid_files(JConfig().with_overrides(**over))
    return t, j


def _assert_equal_to_jax(tg, jg):
    assert tg.shape == jg.shape and tg.bc.ew == jg.bc.ew and \
        tg.bc.ns == jg.bc.ns
    for k in tgrid.GRID_FIELDS:
        np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                      np.asarray(getattr(jg, k)), err_msg=k)


def test_readers_equal_the_jax_package(files):
    for fn in ("read_pop_grid_nc", "read_mom_supergrid"):
        path = files["pop_nc" if fn == "read_pop_grid_nc" else "mom"]
        t, j = getattr(tgrids, fn)(path), getattr(jgrids, fn)(path)
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{fn} {k}")
    np.testing.assert_array_equal(tgrids.read_ocean_mask_nc(files["mask"]),
                                  jgrids.read_ocean_mask_nc(files["mask"]))


@pytest.mark.parametrize("fmt", ["pop_nc", "nc", "mom", "mom_nc", "pop_bin"])
def test_load_grid_files_equals_the_jax_package(files, fmt):
    if fmt.startswith("mom"):
        over = _over(fmt, files["mom"], files["mask"])
    elif fmt == "pop_bin":
        over = _over(fmt, files["grid"], files["kmt"])
    else:
        over = _over(fmt, files["pop_nc"])
    _assert_equal_to_jax(*_pair(over))


def test_pop_nc_is_pop_bin_and_mom_within_ulps(files):
    cfg = lambda o: Config().with_overrides(**o)
    pb = tgrid.make_grid(cfg(_over("pop_bin", files["grid"],
                                   files["kmt"])), "cpu")
    pn = tgrid.make_grid(cfg(_over("pop_nc", files["pop_nc"])), "cpu")
    mo = tgrid.make_grid(cfg(_over("mom", files["mom"], files["mask"])),
                         "cpu")
    eps = np.finfo(np.float64).eps
    for k in tgrid.GRID_FIELDS:
        a, b, c = (getattr(g, k) for g in (pb, pn, mo))
        assert torch.equal(a, b), k
        if k in VIA_DEGREES:
            tol = ULP_TOL * eps * float(a.abs().max())
            assert float((a - c).abs().max()) <= tol, k
        else:
            assert torch.equal(a, c), k
    assert float((pb.TLAT - mo.TLAT).abs().max()) > 0   # degrees round


def test_a_kmt_variable_wins_and_kmt_file_serves_otherwise(files, tmp_path):
    """popgrid_nc reads kmt from the grid file when it holds one; without
    it the kmt_file (binary) is read, and without either every cell is
    ocean: as the JAX package."""
    d = tgrids.read_pop_grid_binary(files["grid"], NX, NY)
    bare = str(tmp_path / "bare.nc")
    tfix._write_nc(bare, {"nj": NY, "ni": NX}, {
        k.lower(): (("nj", "ni"), d[k])
        for k in ("ULAT", "ULON", "HTN", "HTE", "ANGLE")})
    for kmt_file in (files["kmt"], ""):
        t, j = _pair(_over("pop_nc", bare, kmt_file))
        _assert_equal_to_jax(t, j)
        assert (float(t.hm.mean()) == 1.0) is (not kmt_file)


def test_tripole_boundary_from_the_config(tmp_path):
    """A tx1-format tripole grid in POP netCDF form with
    ns_boundary_type='tripole' (as tx1pop reads tx1): the fold's boundary
    conditions, equal to the JAX package's grid."""
    arrs = tfix.make_tripole_arrays(16, 12)
    g, k = str(tmp_path / "t.bin"), str(tmp_path / "tk.bin")
    tfix.write_pop_grid_binary(g, arrs)
    tfix.write_kmt_binary(k, arrs["kmt"])
    forms = tfix.write_grid_forms(g, k, 16, 12, str(tmp_path / "tx"))
    over = {"grid.nx_global": 16, "grid.ny_global": 12,
            "grid.grid_format": "pop_nc", "grid.grid_type": "tripole",
            "grid.grid_file": forms["pop_nc"],
            "grid.ew_boundary_type": "cyclic",
            "grid.ns_boundary_type": "tripole", "dtype": "float64"}
    tg = tgrid.make_grid(Config().with_overrides(**over), "cpu")
    jg = jgrid.make_grid(JConfig().with_overrides(**over))
    assert tg.bc.tripole and tg.bc.ns == "tripole"
    _assert_equal_to_jax(tg, jg)


def test_the_mask_reader_names_what_it_lacks(tmp_path):
    p = str(tmp_path / "nomask.nc")
    tfix._write_nc(p, {"ny": 2, "nx": 3},
                   {"depth": (("ny", "nx"), np.ones((2, 3)))})
    with pytest.raises(ValueError, match="no mask/wet/kmt"):
        tgrids.read_ocean_mask_nc(p)


def test_grid_forms_are_written_once(files):
    before = {k: os.path.getmtime(files[k])
              for k in ("pop_nc", "mom", "mask")}
    again = tfix.write_grid_forms(files["grid"], files["kmt"], NX, NY,
                                  files["pop_nc"][:-len("_grid.nc")])
    assert {k: os.path.getmtime(again[k]) for k in before} == before


def test_ice_cov_fixture(tmp_path):
    lat = np.linspace(-80.0, 85.0, 30)[:, None] * np.ones((1, 8))
    p = tfix.write_ice_cov_npz(str(tmp_path), lat, seed=3)
    with np.load(p) as z:
        cov = z["ice_cov"]
    assert cov.shape == (12, 30, 8) and cov.min() >= 0.0 and cov.max() <= 1.0
    assert (cov[:, -1] > 0.5).all() and (cov[:, 15] == 0.0).all()
    tfix.write_ice_cov_npz(str(tmp_path / "b"), lat, seed=3)
    with np.load(str(tmp_path / "b" / "ice_cov.npz")) as z:
        np.testing.assert_array_equal(z["ice_cov"], cov)
