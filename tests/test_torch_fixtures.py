"""PyTorch port vs JAX package: the baseline fixture writers
(cice_tpu_torch.io.fixtures) at small sizes, a 24x20 displaced-pole and a
16x12 tripole grid. Both packages compute the fixtures with the same NumPy
expressions, so arrays, binaries and files must be equal exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from scipy.io import netcdf_file  # noqa: E402

from cice_tpu.io import fixtures as jfix  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402

SMALL = {"gx3": (24, 20), "gx1": (32, 24), "tx1": (16, 12)}


def _arrays_equal(a, b, what):
    assert set(a) == set(b), what
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what}: {k}")


def _read(path):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".nc"):
        with netcdf_file(path, "r", mmap=False) as f:
            return {k: np.array(v[:]) for k, v in f.variables.items()}
    with open(path, "rb") as f:
        return {"bytes": np.frombuffer(f.read(), np.uint8)}


@pytest.mark.parametrize("kind,nx,ny", [("displaced_pole", 24, 20),
                                        ("tripole", 16, 12)])
def test_grid_arrays_equal_jax(kind, nx, ny):
    make = f"make_{kind}_arrays"
    _arrays_equal(getattr(tfix, make)(nx, ny), getattr(jfix, make)(nx, ny),
                  kind)


def test_tripole_seam_mask_is_fold_symmetric():
    kmt = tfix.make_tripole_arrays(16, 12)["kmt"]
    np.testing.assert_array_equal(kmt[-1], kmt[-1][::-1])
    assert kmt[0].sum() == 0.0


@pytest.mark.parametrize("kind,nx,ny", [("displaced_pole", 24, 20),
                                        ("tripole", 16, 12)])
def test_forcing_writers_equal_jax(tmp_path, kind, nx, ny):
    arrs = getattr(tfix, f"make_{kind}_arrays")(nx, ny)
    lat, lon = np.rad2deg(arrs["TLAT"]), np.rad2deg(arrs["TLON"])
    _arrays_equal(tfix._analytic_atm(lat, lon, 100.0, 7.5),
                  jfix._analytic_atm(lat, lon, 100.0, 7.5), "analytic atm")
    for name, kw in (("write_ncar_npz", {"year": 2007}),
                     ("write_jra55_nc", {"nrec": 9, "rec0": 3}),
                     ("write_ocean_clim_npz", {})):
        a = getattr(tfix, name)(str(tmp_path / "t"), lat, lon, **kw)
        b = getattr(jfix, name)(str(tmp_path / "j"), lat, lon, **kw)
        assert os.path.basename(a) == os.path.basename(b)
        _arrays_equal(_read(a), _read(b), name)


def test_ensure_baseline_fixtures_writes_the_jax_layout(tmp_path,
                                                        monkeypatch):
    """The whole set (grids, kmt, NCAR, ocean climatology, the gx1 JRA55
    file) at small sizes: the same files, the same contents, and a second
    call that writes nothing."""
    monkeypatch.setattr(tfix, "GRID_DIMS", SMALL)
    monkeypatch.setattr(jfix, "GRID_DIMS", SMALL)
    got = tfix.ensure_baseline_fixtures(str(tmp_path / "t"))
    ref = jfix.ensure_baseline_fixtures(str(tmp_path / "j"))
    assert set(got) == set(ref) == set(SMALL)
    for name in SMALL:
        files_t = sorted(os.listdir(got[name]["forcing"]))
        assert files_t == sorted(os.listdir(ref[name]["forcing"]))
        for fn in files_t:
            if not fn.startswith("."):
                _arrays_equal(_read(os.path.join(got[name]["forcing"], fn)),
                              _read(os.path.join(ref[name]["forcing"], fn)),
                              f"{name}/{fn}")
        for key in ("grid", "kmt"):
            _arrays_equal(_read(got[name][key]), _read(ref[name][key]),
                          f"{name} {key}")
    assert "JRA55_2005.nc" in os.listdir(got["gx1"]["forcing"])
    stamp = os.path.getmtime(got["tx1"]["grid"])
    tfix.ensure_baseline_fixtures(str(tmp_path / "t"))
    assert os.path.getmtime(got["tx1"]["grid"]) == stamp


def test_fixture_root_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("CICE_TPU_TORCH_FIXTURES", str(tmp_path))
    monkeypatch.setenv("CICE_TPU_FIXTURES", str(tmp_path / "jax"))
    assert tfix.fixtures_root() == str(tmp_path)
