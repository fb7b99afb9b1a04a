"""PyTorch port vs JAX package: the transports other than the exact remap
(cice_tpu_torch.dynamics.transport and .remap): first-order upwind, van
Leer MUSCL and remap_q, on the B grid (corner velocities) and the C grid
(face velocities), each a whole state step through the registry's
state_to_work / work_to_state packing; and `advection='none'`.

The state is tests/test_torch_remap.py's seeded two-category blob with
every tracer filled. Tolerances: f64 at rtol 1e-10 of each field's largest
value (a few dense stencils, only rounding differs); f32 at the JAX
package's engine-vs-engine 2e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.dynamics import transport as jtr  # noqa: E402
from cice_tpu.model.state import tracer_registry as jreg  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.dynamics import transport as ttr  # noqa: E402
from cice_tpu_torch.model.state import tracer_registry as treg  # noqa: E402
from cice_tpu_torch.model.step import check_ported  # noqa: E402

from test_torch_remap import _close, _np, _setup  # noqa: E402

SCHEMES = {"upwind": (jtr.transport_upwind, ttr.transport_upwind),
           "vanleer": (jtr.transport_vanleer, ttr.transport_vanleer),
           "remap_q": (jtr.transport_remap, ttr.transport_remap)}


def with_faces(st, ts, dtype, seed=1):
    """The same states with seeded face velocities uvelE, vvelN (C grid)."""
    ny, nx = np.shape(st.aice)
    rng = np.random.default_rng(seed)
    umax = 0.3 * 30.0e3 / 3600.0
    uE = (umax * (0.5 + rng.random((ny, nx)))).astype(dtype)
    vN = (0.5 * umax * rng.standard_normal((ny, nx))).astype(dtype)
    st = st.replace(uvelE=jnp.asarray(uE), vvelN=jnp.asarray(vN))
    ts = ts.replace(uvelE=torch.as_tensor(uE), vvelN=torch.as_tensor(vN))
    return st, ts


def _both(scheme, grid_ice, dtype, ew="cyclic"):
    cfg, jg, tg, st, ts, Tf = _setup(dtype, ew=ew, seed=4)
    if grid_ice == "C":
        st, ts = with_faces(st, ts, dtype)
    jfn, tfn = SCHEMES[scheme]
    jnew = jax.jit(lambda s: jfn(jg, s, jreg(cfg), jnp.asarray(Tf), 3600.0,
                                 grid_ice=grid_ice))(st)
    tnew = tfn(tg, ts, treg(tconfig.Config()), torch.as_tensor(Tf), 3600.0,
               grid_ice=grid_ice)
    return _np(st), _np(jnew), convert.state_to_numpy(tnew)


def _compare(j, t, rtol):
    for k in ("aicen", "vicen", "vsnon"):
        _close(t[k], j[k], rtol, k)
    for k in j["trcrn"]:
        _close(t["trcrn"][k], j["trcrn"][k], rtol, k)


@pytest.mark.parametrize("grid_ice", ["B", "C"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_transport_matches_jax_f64(scheme, grid_ice):
    before, j, t = _both(scheme, grid_ice, "float64")
    _compare(j, t, 1e-10)
    assert np.abs(j["aicen"] - before["aicen"]).max() > 1e-3   # ice moved


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_transport_matches_jax_closed_f32(scheme):
    _, j, t = _both(scheme, "B", "float32", ew="closed")
    assert t["aicen"].dtype == np.float32
    _compare(j, t, 2e-3)


def test_advection_none_moves_nothing_and_unknown_names_are_refused():
    """'none' runs no transport (the JAX package runs upwind for it, and
    for any name it does not know)."""
    from cice_tpu_torch.model import step as tstep
    from cice_tpu_torch.model.driver import Model
    base = tconfig.box2001_config(12, 12).with_overrides(**{
        "dtype": "float64", "dynamics.ndte": 5, "dynamics.kridge": -1,
        "forcing.calc_strair": False})
    m = Model(base.with_overrides(**{"dynamics.advection": "none"}),
              device="cpu")
    ref = Model(base.with_overrides(**{"dynamics.ktransport": -1}),
                device="cpu")
    for mm in (m, ref):
        mm.state = mm.state.replace(aicen=mm.state.aicen * 0 + 0.1,
                                    vicen=mm.state.vicen * 0 + 0.2)
    fc = m.forcing
    wind = (fc.strax + 0.1, fc.stray + 0.05)
    a, _, _ = tstep.step_dyn_transport(m.static, m.grid, m.state, fc, *wind,
                                       3600.0)
    b, _, _ = tstep.step_dyn_transport(ref.static, ref.grid, ref.state, fc,
                                       *wind, 3600.0)
    assert float(a.uvel.abs().max()) > 0.0
    for k in ("aicen", "vicen", "vsnon"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    with pytest.raises(ValueError, match="advection"):
        check_ported(base.with_overrides(**{"dynamics.advection": "lax"}))


# ---------------------------------------------------------------------------
# whole coupled steps (slow tier: each compiles the JAX model_step once)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_box2001_steps_match_jax_slow(dtype):
    """Three steps of box2001_config (80x80, upwind). The ice packs against
    the walls (aice 1), where the EVP is ill-conditioned: the JAX package's
    own envelope grows from 1e-14 to 1e-7 of the largest velocity over
    the three steps in f64, so leaves are held within 50 times it
    (steps_against_jax)."""
    from cice_tpu import config as jconfig
    from test_torch_evp_c import steps_against_jax
    steps_against_jax(tconfig.box2001_config().with_overrides(dtype=dtype),
                      jconfig.box2001_config().with_overrides(dtype=dtype),
                      dtype, steps=3, envelope=True)


#: absolute floors for the midwinter pond tracers under van Leer: the pond
#: fraction is residue there (its largest value ~4e-6), and its ratio
#: recovery at vanishing ice weights moves it by 2.7e-3 of that maximum
#: under a 1e-15 change of vicen in the JAX package itself
POND_RESIDUE = {"apnd": 1e-5, "hpnd": 1e-5, "ipnd": 1e-5}


@pytest.mark.slow
@pytest.mark.parametrize("advection", ["upwind", "vanleer", "remap_q"])
def test_two_steps_of_each_transport_match_jax_slow(advection):
    from test_torch_evp_c import two_steps_against_jax
    two_steps_against_jax("float64", {"dynamics.advection": advection},
                          floors=POND_RESIDUE)
