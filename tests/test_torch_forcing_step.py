"""PyTorch port vs JAX package: two full coupled steps (`Model.step`) under
file forcing, on the 48x40 displaced-pole POP grid of tests/
test_torch_step.py, with forcing files written here by the port's fixture
writers: NCAR bulk monthly + the ocean climatology, and JRA55 3-hourly +
the ocean climatology (from day 2, as the gx1pop option set, so that no
record before the file's first is read), each in f64 and in f32.

Both packages step through their Model, which reads the files, so the
calendar, record addressing and interpolation are held as well as the
step. Tolerances are tests/test_torch_step.py's (`_compare`, RTOL, FLOORS)
except for the pond leaves, which file forcing fills (test_torch_step's
midwinter case holds only their rounding residue):
  * the level ponds' hpnd at the ice edge: where the pond area fraction is
    1e-9..1e-5, the JAX package alone moves apnd by 2.5e-7 and hpnd by
    6e-4 under a 1e-15 relative change of vicen in the ncar configuration
    (tests/test_torch_baseline_sensitivity.py, slow tier), so hpnd is
    compared through the pond volume per ice area, apnd * hpnd;
  * every pond leaf has an absolute floor (POND_FLOORS, else FLOORS) that
    lies under 1 % of the reference's largest value of that leaf at that
    step, or above that largest value, where the whole leaf is the
    rounding residue of a first step. Each floor is asserted so.
Measured port-vs-JAX differences over the four cases: apnd 2.7e-7 (f64) /
1.3e-4 (f32) of a largest 0.027-0.047; pond volume 2.2e-11 / 3.2e-7 of
5.9e-4-1.8e-3 m; dpnd_flushn 5.9e-18 / 1.6e-13 kg/m2/s of 6.7e-9-3.4e-8.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from test_torch_step import (FLOORS, NX, NY, RTOL, _cfgs,  # noqa: E402
                             _compare)

# (f64, f32) absolute floors of pond leaves where FLOORS' are too loose
# for filled ponds; "volume" is apnd * hpnd
POND_FLOORS = {"apnd": (1e-6, 2.5e-4), "volume": (1e-10, 1e-7),
               "dpnd_flushn": (1e-15, 1e-12), "fpond": (1e-12, 1e-8),
               "dpnd_ridge": (1e-15, 5e-12)}
POND_LEAVES = {"apnd", "volume", "apond", "apeff", "apeffn", "albpnd",
               "fpond", "dpnd_initial", "dpnd_initialn", "dpnd_flushn",
               "dpnd_ridge", "dpnd_melt"}


@pytest.fixture(scope="module")
def forcing_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("forcing48x40"))
    arrs = tfix.make_displaced_pole_arrays(NX, NY)
    lat, lon = np.rad2deg(arrs["TLAT"]), np.rad2deg(arrs["TLON"])
    tfix.write_ncar_npz(d, lat, lon)
    tfix.write_ocean_clim_npz(d, lat, lon)
    tfix.write_jra55_nc(d, lat, lon, nrec=24)
    return d


def _pond_floor(leaf, ref, what, f32):
    """The leaf's floor, asserted under 1 % of the reference's largest
    value, or above it (the leaf is all residue)."""
    floor = POND_FLOORS.get(leaf, FLOORS.get(leaf, (0.0, 0.0)))[f32]
    top = float(np.abs(ref).max())
    print(f"{what}: {leaf} floor {floor:.1e}, reference max {top:.3e}")
    assert floor <= 1e-2 * top or top <= floor, (what, leaf, floor, top)
    return floor


def _compare_file_run(got, ref, what, dtype):
    f32 = dtype == "float32"
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    g = {k: v for k, v in g.items() if np.asarray(v).size}
    r = {k: v for k, v in r.items() if np.asarray(v).size}
    if "trcrn.hpnd" in r:
        for t in (g, r):
            t["trcrn.volume"] = np.asarray(t.pop("trcrn.hpnd")) * \
                np.asarray(t["trcrn.apnd"])
    for k in [k for k in r if k.split(".")[-1] in POND_LEAVES]:
        leaf = k.split(".")[-1]
        a, b = np.asarray(g.pop(k)), np.asarray(r.pop(k))
        atol = max(RTOL[dtype] * float(np.abs(b).max()),
                   _pond_floor(leaf, b, what, f32))
        np.testing.assert_allclose(a, b, rtol=RTOL[dtype], atol=atol,
                                   err_msg=f"{what}: {k}")
    _compare(g, r, what, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("atm", ["ncar", "jra55"])
def test_two_coupled_steps_with_file_forcing_match_jax(forcing_dir, atm,
                                                        dtype):
    over = {"forcing.atm_data_type": atm,
            "forcing.atm_data_dir": forcing_dir,
            "forcing.ocn_data_type": "clim",
            "forcing.ocn_data_dir": forcing_dir}
    if atm == "jra55":
        over["setup.day_init"] = 2
    tcfg, jcfg = _cfgs(dtype, **over)
    jm, tm = JModel(jcfg), tdriver.Model(tcfg, device="cpu")
    for step in range(2):
        jm.step()
        tm.step()
        for what, a, b in (("forcing", tm.forcing, jm.forcing),
                           ("state", convert.state_to_numpy(tm.state),
                            jm.state),
                           ("flux", convert.fluxout_to_numpy(tm.flux),
                            jm.flux)):
            _compare_file_run(a, b, f"{atm} {dtype} step {step + 1} {what}",
                              dtype)
    assert sorted(tm.datasets) == [atm, "ocn"]
    ds = tm.datasets[atm]
    assert os.path.dirname(ds._file_for(2005)) == forcing_dir
    # the two bracketing records, read once each
    assert ds.records_read == 2
    assert float(np.abs(np.asarray(jm.state.uvel)).max()) > 1e-3
