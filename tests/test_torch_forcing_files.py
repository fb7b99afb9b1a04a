"""PyTorch port vs JAX package: the forcing-file readers and datasets
(cice_tpu_torch.io.forcing_files) and every file atmosphere and ocean of
cice_tpu_torch.model.forcing.get_forcing, on files written here with numpy
from a seed.

Records, interpolation weights and interpolated fields are exact: the
readers return the same float64 arrays and the port interpolates with two
separate float64 operations, as NumPy does. The forcing fields after
`prepare_forcing` / `file_ocn` hold at f64 rtol 1e-12 of each field's
largest value (the same expressions; math-library differences of an ulp).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from scipy.io import netcdf_file  # noqa: E402

from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.io import forcing_files as jff  # noqa: E402
from cice_tpu.model import forcing as jforcing  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.io import forcing_files as tff  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model import forcing as tforcing  # noqa: E402

NX, NY = 24, 20
RTOL = 1e-12
SHAPE = (NY, NX)


def _rand(rng, n, lo, hi):
    return rng.uniform(lo, hi, (n,) + SHAPE)


def _atm_fields(rng, n):
    return dict(Tair=_rand(rng, n, 240.0, 280.0), Qa=_rand(rng, n, 1e-4, 4e-3),
                uatm=_rand(rng, n, -8.0, 8.0), vatm=_rand(rng, n, -8.0, 8.0),
                fsw=_rand(rng, n, 0.0, 300.0), flw=_rand(rng, n, 150.0, 320.0),
                cldf=_rand(rng, n, 0.0, 1.0), fsnow=_rand(rng, n, 0.0, 2e-5))


def _write_nc(path, arrays, scale=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with netcdf_file(path, "w") as f:
        n = next(iter(arrays.values())).shape[0]
        f.createDimension("time", n)
        f.createDimension("nj", SHAPE[0])
        f.createDimension("ni", SHAPE[1])
        for k, a in arrays.items():
            v = f.createVariable(k, "f", ("time", "nj", "ni"))
            if scale and k in scale:
                v.scale_factor, v.add_offset = scale[k]
                a = (a - scale[k][1]) / scale[k][0]
            v[:] = a.astype(np.float32)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Every dataset layout get_forcing reads, at 24x20: NCAR monthly npz,
    a JRA55 3-hourly netCDF, a monthly climatology, HadGEM netCDF with a
    wind stress, oned/ISPOL point series, the ocean climatology and HYCOM
    daily netCDF, for 2005 and (ncar) 2006."""
    d = str(tmp_path_factory.mktemp("forcing"))
    rng = np.random.default_rng(42)
    for year in (2005, 2006):
        np.savez_compressed(os.path.join(d, f"ncar_bulk_{year}.npz"), **{
            k: v.astype(np.float32) for k, v in _atm_fields(rng, 12).items()
            if k != "flw"})
    a = _atm_fields(rng, 24)
    _write_nc(os.path.join(d, "JRA55_2005.nc"), dict(
        airtmp=a["Tair"], spchmd=a["Qa"], wndewd=a["uatm"],
        wndnwd=a["vatm"], glbrad=a["fsw"], dlwsfc=a["flw"],
        ttlpcp=a["fsnow"]), scale={"airtmp": (0.01, 250.0)})
    np.savez_compressed(os.path.join(d, "monthly_clim.npz"), **{
        k: v.astype(np.float32) for k, v in _atm_fields(rng, 12).items()
        if k in ("Tair", "Qa", "uatm", "vatm", "cldf", "fsnow")})
    a = _atm_fields(rng, 12)
    _write_nc(os.path.join(d, "MONTHLY", "hadgem_2005.nc"), dict(
        airtmp=a["Tair"], spchmd=a["Qa"], taux=_rand(rng, 12, -0.2, 0.2),
        tauy=_rand(rng, 12, -0.2, 0.2), u10=a["uatm"], v10=a["vatm"],
        swdn=a["fsw"], lwdn=a["flw"], snowfall=a["fsnow"],
        rainfall=a["fsnow"]))
    for name, n in (("oned_forcing", 8760), ("ispol_forcing", 1460)):
        t = np.arange(n)
        np.savez(os.path.join(d, f"{name}.npz"),
                 Tair=250.0 + 20.0 * np.sin(t / 500.0), Qa=1e-3 + 0 * t,
                 uatm=5.0 * np.cos(t / 50.0), vatm=2.0 + 0 * t,
                 fsw=np.maximum(300.0 * np.sin(t / 12.0), 0.0),
                 flw=250.0 + 0 * t, fsnow=1e-6 * (t % 7))
    np.savez_compressed(os.path.join(d, "ocean_clim.npz"), **{
        "sst": _rand(rng, 12, -2.0, 5.0), "sss": _rand(rng, 12, 30.0, 35.0),
        "uocn": _rand(rng, 12, -0.1, 0.1), "vocn": _rand(rng, 12, -0.1, 0.1),
        "qdp": _rand(rng, 12, -5.0, 0.0), "hmix": _rand(rng, 12, 2.0, 40.0)})
    _write_nc(os.path.join(d, "hycom_ocn_2005.nc"), dict(
        sst=_rand(rng, 365, -2.0, 5.0), sss=_rand(rng, 365, 30.0, 35.0),
        uvel=_rand(rng, 365, -0.1, 0.1), vvel=_rand(rng, 365, -0.1, 0.1)))
    return d


# ---------------------------------------------------------------------------
# readers and interpolation
# ---------------------------------------------------------------------------

def _read(path, var, nrec, shape, total=None):
    """One record through a reader of its own (the JAX package's
    read_field_record reopens the file per call)."""
    reader = tff.RecordReader()
    try:
        return reader.read(path, var, nrec, shape, total)
    finally:
        reader.close()


def test_records_npz_nc_bin_equal_jax(data_dir, tmp_path):
    for path, var, nrec in (
            (os.path.join(data_dir, "ncar_bulk_2005.npz"), "Tair", 7),
            (os.path.join(data_dir, "JRA55_2005.nc"), "airtmp", 13),
            (os.path.join(data_dir, "JRA55_2005.nc"), "ttlpcp", 0)):
        got = _read(path, var, nrec, SHAPE)
        ref = jff.read_field_record(path, var, nrec, SHAPE)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref, err_msg=f"{path} {var}")
    # field-major big-endian f64 direct-access records
    rec = np.random.default_rng(1).standard_normal((3, 5) + SHAPE)
    binp = str(tmp_path / "forcing.bin")
    rec.astype(">f8").tofile(binp)
    for fidx in range(3):
        for nrec in (0, 4):
            got = _read(binp, str(fidx), nrec, SHAPE, 5)
            ref = jff.read_field_record(binp, str(fidx), nrec, SHAPE, 5)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, rec[fidx, nrec])


def test_record_beyond_the_file_raises(data_dir):
    path = os.path.join(data_dir, "JRA55_2005.nc")
    with pytest.raises(ValueError, match="beyond the 24 records"):
        _read(path, "airtmp", 24, SHAPE)


def test_interp_coeff_brackets_like_jax():
    for secint in (3.0 * 3600.0, tff.MONTH, 86400.0):
        for t in np.linspace(-secint, 3.5 * secint, 23):
            for slot in (0, 1, 2, 3):
                assert tff.interp_coeff(float(t), slot, secint, 60.0) == \
                    jff.interp_coeff(float(t), slot, secint, 60.0)


def _at_times(tds, jds, times):
    for year, sec in times:
        got, ref = tds.at_time(year, sec), jds.at_time(year, sec)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == torch.float64
            np.testing.assert_array_equal(got[k].numpy(), ref[k],
                                          err_msg=f"{k} {year} {sec}")


def test_monthly_dataset_wraps_years_and_cycles(data_dir):
    """NCAR monthly records across the year boundary, with a two-year
    forcing cycle (2005, 2006) run from 2005 into 2008."""
    tds = tff.ncar_dataset(data_dir, SHAPE, 2005, ycycle=2)
    jds = jff.ncar_dataset(data_dir, SHAPE, 2005, ycycle=2)
    times = [(y, s) for y in (2005, 2006, 2007, 2008)
             for s in (0.0, 0.3 * tff.MONTH, 5.5 * tff.MONTH,
                       11.7 * tff.MONTH)]
    _at_times(tds, jds, times)
    # each bracketing record is read once per pass of the bracket
    assert tds.records_read <= 2 * len(times)


def test_gregorian_leap_years_address_more_records(tmp_path):
    """A 3-hourly stream on the gregorian calendar has 2928 records in a
    leap year: records near the end of 2008 and across into 2009."""
    rng = np.random.default_rng(5)
    d = str(tmp_path)
    for year, n in ((2008, 2928), (2009, 2920)):
        np.savez(os.path.join(d, f"ncar_bulk_{year}.npz"),
                 **{k: rng.random((n, 2, 3)) for k in
                    ("Tair", "Qa", "uatm", "vatm", "fsw", "cldf", "fsnow")})
    kw = dict(fields=dict(Tair="Tair", fsnow="fsnow"), secint=10800.0,
              data_dir=d, fyear_init=2008, ycycle=2, shape=(2, 3),
              path_pattern="{dir}/ncar_bulk_{year:04d}.npz",
              calendar_type="gregorian")
    tds, jds = tff.ForcingDataset(**kw), jff.ForcingDataset(**kw)
    assert tds.n_per_year(2008) == 2928 and tds.n_per_year(2009) == 2920
    times = [(2008, 365.9 * 86400.0), (2008, 0.0), (2009, 1000.0),
             (2009, 364.99 * 86400.0), (2010, 3600.0)]
    _at_times(tds, jds, times)


def test_point_series(data_dir):
    for t_make, j_make in ((tff.oned_dataset, jff.oned_dataset),
                           (tff.ispol_dataset, jff.ispol_dataset)):
        tds, jds = t_make(data_dir, SHAPE), j_make(data_dir, SHAPE)
        _at_times(tds, jds, [(2005, s) for s in
                             (0.0, 1800.0, 86400.0 * 200.3, 86400.0 * 364.9)])


# ---------------------------------------------------------------------------
# every file atmosphere and ocean through get_forcing
# ---------------------------------------------------------------------------

def _cfg_pair(**over):
    t = tconfig.gx1pop_step(NX, NY).with_overrides(dtype="float64", **over)
    g = t.grid
    j = JConfig().with_overrides(**{
        "grid.nx_global": NX, "grid.ny_global": NY,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": g.grid_file, "grid.kmt_file": g.kmt_file,
        "grid.ew_boundary_type": "cyclic", "dtype": "float64", **over})
    return t, j


def _forcing_close(tfc, jfc, what):
    for f in dataclasses.fields(jfc):
        ref = np.asarray(getattr(jfc, f.name))
        if not ref.size:
            continue
        got = getattr(tfc, f.name).numpy()
        scale = max(float(np.abs(ref).max()), 1e-300)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"{what}: {f.name}")


@pytest.mark.parametrize("atm,ocn,extra", [
    ("ncar", "clim", {}),
    ("jra55", "ncar", {"forcing.precip_units": "mm_per_day"}),
    ("monthly", "hycom", {"forcing.precip_units": "mm_per_month",
                          "forcing.rotate_wind": False}),
    ("hadgem", "clim", {}),
    ("oned", "default", {}),
    ("ISPOL", "box2001", {"setup.calendar_type": "gregorian"})])
def test_file_forcing_matches_jax(data_dir, atm, ocn, extra):
    tcfg, jcfg = _cfg_pair(**{
        "forcing.atm_data_type": atm, "forcing.atm_data_dir": data_dir,
        "forcing.ocn_data_type": ocn, "forcing.ocn_data_dir": data_dir,
        **extra})
    jm = JModel(jcfg)
    tm = tdriver.Model(tcfg, device="cpu")
    assert float(np.abs(np.asarray(jm.grid.ANGLET)).max()) > 0.1
    days = (1.2, 2.0, 2.9) if atm == "jra55" else (1.0, 45.3, 200.7, 364.2)
    for yday in days:
        sec = (yday - 1.0) * 86400.0
        got = tforcing.get_forcing(tcfg, tm.grid, sec, yday, tm.state.aice,
                                   tm.forcing, year=2005, sec_of_year=sec,
                                   datasets=tm.datasets)
        ref = jforcing.get_forcing(jcfg, jm.grid, sec, yday, jm.state.aice,
                                   jm.forcing, year=2005, sec_of_year=sec)
        _forcing_close(got, ref, f"{atm}/{ocn} day {yday}")
    if atm == "hadgem":
        assert float(np.abs(got.strax.numpy()).max()) > 0.0
    if ocn in ("clim", "ncar", "hycom"):
        assert float(got.hmix.min()) >= 5.0


def test_each_model_keeps_its_own_datasets(tmp_path):
    """Two Models with two Configs and two forcing directories: each reads
    its own files (the JAX package's datasets are keyed by id(cfg), which
    a later Config can reuse)."""
    dirs = []
    for k, T in enumerate((250.0, 265.0)):
        d = str(tmp_path / f"d{k}")
        os.makedirs(d)
        fields = _atm_fields(np.random.default_rng(k), 12)
        fields["Tair"] = np.full((12,) + SHAPE, T)
        np.savez(os.path.join(d, "ncar_bulk_2005.npz"), **fields)
        dirs.append(d)
    temps = []
    for d in dirs:
        cfg, _ = _cfg_pair(**{"forcing.atm_data_type": "ncar",
                              "forcing.atm_data_dir": d})
        m = tdriver.Model(cfg, device="cpu")
        m.forcing = m._forcing()
        temps.append(float(m.forcing.Tair.max()))
        assert list(m.datasets) == ["ncar"]
        assert m.datasets["ncar"].data_dir == d
        del m, cfg
    assert temps == [250.0, 265.0]
