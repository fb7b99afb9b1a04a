"""PyTorch port vs JAX package: the exact remap on C and CD grids
(cice_tpu_torch.dynamics.remap_exact): the Bentsen edge-area adjustment of
`pentagon_cell_moments` through `edge_moments`, and whole
`horizontal_remap_exact` steps from face velocities through the plain
path, the one-pass transport's wrapper (K2) and the flux-only wrapper (K3),
whose CPU paths are their plain versions.

Tolerances: f64 at rtol 1e-10 of each field's largest value (the same
expressions; rounding only); f32 at the JAX package's 2e-3.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.dynamics import remap_exact as jrx  # noqa: E402
from cice_tpu.model.state import tracer_registry as jreg  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.dynamics import remap_exact as trx  # noqa: E402
from cice_tpu_torch.kernels import remap as tkremap  # noqa: E402
from cice_tpu_torch.model.state import tracer_registry as treg  # noqa: E402

from test_torch_remap import _close, _np, _setup  # noqa: E402
from test_torch_transport import with_faces  # noqa: E402


def _displacements(ny, nx, seed=2):
    rng = np.random.default_rng(seed)
    dxs = 0.3 * rng.standard_normal((ny, nx))
    dys = 0.3 * rng.standard_normal((ny, nx))
    ea_e = 0.2 * rng.standard_normal((ny, nx))
    ea_n = 0.2 * rng.standard_normal((ny, nx))
    # still corners: DR and DL share their x, so DM cannot move (the safe
    # denominator of the adjustment is taken there)
    dxs[:3] = 0.0
    dys[:3] = 0.0
    return dxs, dys, ea_e, ea_n


def test_edge_moments_with_edge_areas_match_jax_f64():
    _, jg, tg, _, _, _ = _setup("float64")
    ny, nx = np.shape(jg.hm)
    dxs, dys, ea_e, ea_n = _displacements(ny, nx)
    # physical edge areas: scaled areas times the face areas
    ea_e = ea_e * np.asarray(jg.earea)
    ea_n = ea_n * np.asarray(jg.narea)
    J, T = jnp.asarray, torch.as_tensor
    ref = jrx.edge_moments(jg, J(dxs), J(dys), J(ea_e), J(ea_n))
    got = trx.edge_moments(tg, T(dxs), T(dys), T(ea_e), T(ea_n))
    plain = trx.edge_moments(tg, T(dxs), T(dys))
    for name, a, b, c in zip(("mom_n", "mom_e"), got, ref, plain):
        assert bool(torch.isfinite(a).all()), name
        _close(a, b, 1e-10, name)
        assert float((a - c).abs().max()) > 1e-3     # the areas moved DM


@functools.lru_cache(maxsize=None)
def _jax_remap(grid_ice, dtype):
    """(initial state, new state, diag) of the JAX package, once per grid
    and dtype: the reference does not depend on the port's engine."""
    cfg, jg, _, st, ts, Tf = _setup(dtype, seed=6)
    st, _ = with_faces(st, ts, dtype)
    jnew, jdiag = jax.jit(lambda s: jrx.horizontal_remap_exact(
        jg, s, jreg(cfg), jnp.asarray(Tf), 3600.0, grid_ice=grid_ice,
        l_dp_midpt=True, conserv_check=True))(st)
    return _np(st), _np(jnew), jdiag


def _remap_both(grid_ice, dtype, flux_kernel):
    _, _, tg, st, ts, Tf = _setup(dtype, seed=6)
    _, ts = with_faces(st, ts, dtype)
    kw = dict(grid_ice=grid_ice, l_dp_midpt=True, conserv_check=True)
    before_np, jnew, jdiag = _jax_remap(grid_ice, dtype)
    before = (tkremap.launches, tkremap.flux_launches)
    tnew, tdiag = trx.horizontal_remap_exact(
        tg, ts, treg(tconfig.Config()), torch.as_tensor(Tf), 3600.0,
        flux_kernel=flux_kernel, **kw)
    # CPU tensors never reach a kernel
    assert (tkremap.launches, tkremap.flux_launches) == before
    return before_np, jnew, jdiag, convert.state_to_numpy(tnew), tdiag


@pytest.mark.parametrize("flux_kernel", ["xla", "fused_full",
                                         "fused_pallas"])
@pytest.mark.parametrize("grid_ice", ["C", "CD"])
def test_horizontal_remap_exact_on_face_velocities_f64(grid_ice,
                                                       flux_kernel):
    before, j, jd, t, td = _remap_both(grid_ice, "float64", flux_kernel)
    for k in ("aicen", "vicen", "vsnon"):
        _close(t[k], j[k], 1e-10, k)
    for k in j["trcrn"]:
        _close(t["trcrn"][k], j["trcrn"][k], 1e-10, k)
    assert np.abs(j["aicen"] - before["aicen"]).max() > 1e-3
    for k in ("oob", "neg_mass"):
        assert bool(td[k]) == bool(jd[k]), k
    assert float(td["cons_err_area"]) < 1e-12


def test_horizontal_remap_exact_on_face_velocities_f32():
    _, j, _, t, td = _remap_both("C", "float32", "fused_full")
    assert t["aicen"].dtype == np.float32
    for k in ("aicen", "vicen", "vsnon"):
        _close(t[k], j[k], 2e-3, k)
    for k in j["trcrn"]:
        _close(t["trcrn"][k], j["trcrn"][k], 2e-3, k)
    assert float(td["cons_err_area"]) < 1e-5
