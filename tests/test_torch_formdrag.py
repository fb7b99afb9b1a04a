"""PyTorch port vs JAX package: form drag (cice_tpu_torch/columns/
formdrag.py against cice_tpu/columns/formdrag.py) and the atmospheric
boundary layer's momentum coefficient from it, on the same numpy inputs
made from a seed (24x16 cells, CPU): ridged and level ice, ponds, floe
sizes, open water and the caps. Its other two users, step_therm1's Cdn and
the ocean drag at U points through dyn_prep, are held in the whole steps
of tests/test_torch_column_steps.py.

Tolerances: f64, 1e-12 of each field's largest value (no iteration; the
boundary layer's 5 stability passes with it, 1e-10 as tests/
test_torch_thermo.py); f32, 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import atmo as jatmo  # noqa: E402
from cice_tpu.columns import formdrag as jfd  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import atmo as tatmo  # noqa: E402
from cice_tpu_torch.columns import formdrag as tfd  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NY, NX = 5, 16, 24
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _aggregate(rng, dtype):
    shp = (NY, NX)
    aice = np.where(rng.random(shp) > 0.15, rng.random(shp), 0.0)
    kw = dict(aice=aice, vice=aice * 4.0 * rng.random(shp),
              vsno=aice * 0.5 * rng.random(shp),
              alvl=np.where(rng.random(shp) > 0.3, rng.random(shp), 1.0),
              vlvl=rng.random(shp), apnd=0.4 * rng.random(shp),
              hpnd=1.5 * rng.random(shp),
              lfloe=8.0 + 500.0 * rng.random(shp))
    return {k: v.astype(dtype) for k, v in kw.items()}


def _close_tree(got, ref, what, rtol):
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys(), what
    for k in r:
        a, b = np.asarray(g[k]), np.asarray(r[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("parts", ["all", "bare"])
def test_neutral_drag_coeffs_match_jax(dtype, parts):
    kw = _aggregate(np.random.default_rng(80), dtype)
    if parts == "bare":      # no level-ice, pond or FSD information
        kw = {k: kw[k] for k in ("aice", "vice", "vsno")}
    with jax.disable_jit():
        ref = jfd.neutral_drag_coeffs(**{k: jnp.asarray(v)
                                         for k, v in kw.items()})
    got = tfd.neutral_drag_coeffs(**{k: torch.as_tensor(v)
                                     for k, v in kw.items()})
    _close_tree(got, ref, f"formdrag {parts} {dtype}", RTOL[dtype])
    ca, cw = np.asarray(ref.Cdn_atm), np.asarray(ref.Cdn_ocn)
    water = kw["aice"] == 0.0
    assert water.any() and (ca[water] == ca.dtype.type(jfd.CSA)).all()
    if parts == "all":
        assert float(np.asarray(ref.Cdn_atm_rdg).max()) > 0.0
        assert float(np.asarray(ref.Cdn_atm_pond).max()) > 0.0
        assert ca.max() <= jfd.CAMAX and cw.max() <= jfd.CWMAX


def test_drag_from_state_matches_jax():
    """The aggregate of a full state (alvl, vlvl, apnd, hpnd and the FSD's
    mean floe length), in f64."""
    rng = np.random.default_rng(81)
    over = {"tracers.tr_fsd": True, "domain.nfsd": 12,
            "grid.nx_global": NX, "grid.ny_global": NY}
    jcfg, tcfg = JConfig().with_overrides(**over), \
        TConfig().with_overrides(**over)
    shp = (NCAT, NY, NX)
    aicen = 0.19 * rng.random(shp) * (rng.random(shp) > 0.2)
    fsd = rng.random((NCAT, 12, NY, NX))
    fsd /= fsd.sum(1, keepdims=True)
    trcrn = dict(alvl=rng.random(shp), vlvl=rng.random(shp),
                 apnd=0.5 * rng.random(shp), hpnd=0.3 * rng.random(shp),
                 fsd=fsd)
    vicen = aicen * 3.0 * rng.random(shp)
    vsnon = aicen * 0.3 * rng.random(shp)

    class S:                       # the fields drag_from_state reads
        def __init__(self, A, tr):
            self.aicen, self.vicen, self.vsnon = A(aicen), A(vicen), A(vsnon)
            self.trcrn = {k: A(v) for k, v in tr.items()}
            self.aice, self.vice = self.aicen.sum(0), self.vicen.sum(0)
            self.vsno = self.vsnon.sum(0)
    with jax.disable_jit():
        ref = jfd.drag_from_state(S(jnp.asarray, trcrn), jcfg)
    got = tfd.drag_from_state(S(torch.as_tensor, trcrn), tcfg)
    _close_tree(got, ref, "drag_from_state", RTOL["float64"])
    lf = np.asarray(ref.lfloe)                # the FSD's mean floe length
    assert lf.min() >= 8.0 and (lf != 300.0).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_boundary_layer_with_form_drag_matches_jax(dtype):
    rng = np.random.default_rng(82)
    shp = (NCAT, NY, NX)
    r = lambda lo, hi, s=(NY, NX): (lo + (hi - lo) * rng.random(s)).astype(
        dtype)
    uatm, vatm = r(-10.0, 10.0), r(-10.0, 10.0)
    args = (r(-30.0, 0.0, shp), r(245.0, 275.0), uatm, vatm,
            np.hypot(uatm, vatm), np.full((NY, NX), 10.0, dtype),
            r(4e-4, 3e-3), r(1.25, 1.4))
    Cdn = r(5e-4, 0.02)
    for conv in (0.0, 1e-4):
        ref = jax.jit(lambda c, *a: jatmo.atmo_boundary_layer(
            *a, natmiter=5, Cdn_atm=c, atmiter_conv=conv))(
                jnp.asarray(Cdn), *map(jnp.asarray, args))
        got = tatmo.atmo_boundary_layer(*map(torch.as_tensor, args),
                                        natmiter=5,
                                        Cdn_atm=torch.as_tensor(Cdn),
                                        atmiter_conv=conv)
        _close_tree(got, ref, f"atmo formdrag {dtype}",
                    1e-10 if dtype == "float64" else 2e-5)
