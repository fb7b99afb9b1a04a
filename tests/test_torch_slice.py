"""PyTorch port vs JAX package: the first port slice end to end — two
`step_dyn_transport` steps (B-grid EVP + exact remap, ridging off) of the
`gx1pop_dyn` configuration on a small displaced-pole POP grid (48x40,
ndte=40), from the driver's initial state.

The JAX side runs `step_dyn_horiz(evp_algorithm='standard_2d')` +
`horizontal_remap_exact(flux_kernel='xla')`: its fused kernels are f32-only
and need a TPU or the interpreter. The port runs both 'fused_pallas' and
'standard_2d'; on CPU tensors both reach the plain versions.

Tolerance: f64, rtol 1e-8 against each field's largest value. Both
packages evaluate the same expressions in the same order except for
reductions (category sums, the moment translation einsum), whose ~1e-16
differences the 2 x 40 EVP subcycles amplify by a few orders at most.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cice_tpu import constants as jcst  # noqa: E402
from cice_tpu.config import Config  # noqa: E402
from cice_tpu.dynamics.remap_exact import horizontal_remap_exact  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu.model.forcing import get_forcing as jget_forcing  # noqa: E402
from cice_tpu.model.step import step_dyn_horiz as jstep_dyn  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model.step import resolve_remap_kernel  # noqa: E402

NX, NY, NDTE, STEPS = 48, 40, 40, 2
RTOL = 1e-8


def _cfgs(evp_algorithm):
    tcfg = tconfig.gx1pop_dyn(NX, NY).with_overrides(**{
        "dynamics.ndte": NDTE, "dynamics.evp_algorithm": evp_algorithm,
        "setup.conserv_check": True, "dtype": "float64"})
    g = tcfg.grid
    jcfg = Config().with_overrides(**{
        "grid.nx_global": NX, "grid.ny_global": NY,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": g.grid_file, "grid.kmt_file": g.kmt_file,
        "grid.ew_boundary_type": "cyclic", "dynamics.ndte": NDTE,
        "dynamics.coriolis": "latitude", "dynamics.kridge": -1,
        "forcing.calc_strair": False, "setup.conserv_check": True,
        "dtype": "float64"})
    return tcfg, jcfg


def _state_np(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = ({k: np.asarray(x) for k, x in v.items()}
                       if isinstance(v, dict) else np.asarray(v))
    return out


def _close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                               err_msg=name)


def _compare_states(t, j, what):
    for k in ("aicen", "vicen", "vsnon", "uvel", "vvel", "stressp",
              "stressm", "stress12", "iceUmask", "sst"):
        _close(t[k], j[k], f"{what}: {k}")
    assert t["trcrn"].keys() == j["trcrn"].keys()
    for k in j["trcrn"]:
        _close(t["trcrn"][k], j["trcrn"][k], f"{what}: trcrn[{k}]")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX reference: initial state, then per step (state, dyn)."""
    _, jcfg = _cfgs("standard_2d")
    m = JModel(jcfg)
    dt = jcfg.setup.dt
    dyn_fn = jax.jit(lambda s, fc: jstep_dyn(m.static, m.grid, s, fc,
                                             fc.strax, fc.stray, dt))
    remap_fn = jax.jit(lambda s, Tf: horizontal_remap_exact(
        m.grid, s, m.static.registry, Tf, dt,
        l_dp_midpt=jcfg.dynamics.l_dp_midpt, conserv_check=True,
        flux_kernel="xla"))
    init = _state_np(m.state)
    st, fc, out = m.state, m.forcing, []
    for step in range(STEPS):
        t = step * dt
        fc = jget_forcing(jcfg, m.grid, t, 1.0 + t / jcst.secday, st.aice,
                          fc)
        st, dyn = dyn_fn(st, fc)
        st, td = remap_fn(st, fc.Tf)
        out.append((_state_np(st), {k: np.asarray(v)
                                    for k, v in dyn.items()},
                    {k: np.asarray(v) for k, v in td.items()}))
    return init, out


@pytest.mark.parametrize("evp_algorithm", ["fused_pallas", "standard_2d"])
def test_two_steps_match_jax_f64(jax_run, evp_algorithm):
    init, ref = jax_run
    tcfg, _ = _cfgs(evp_algorithm)
    m = tdriver.Model(tcfg, device="cpu")
    assert resolve_remap_kernel(tcfg, m.grid, torch.float64) == "xla"
    _compare_states(convert.state_to_numpy(m.state), init, "initial")
    for step, (jst, jdyn, jtd) in enumerate(ref):
        m.run_dynamics(1)
        _compare_states(convert.state_to_numpy(m.state), jst,
                        f"step {step + 1}")
        for k in ("divu", "shear", "Delta", "strength", "strocnx",
                  "strintx", "taubx"):
            _close(m.dyn_diags[k].numpy(), jdyn[k], f"step {step + 1}: {k}")
        for k in ("oob", "neg_mass"):
            assert not bool(m.tchecks[k]) and not bool(jtd[k]), k
        assert float(m.tchecks["cons_err_area"]) < 1e-12
    assert float(np.abs(ref[-1][0]["uvel"]).max()) > 1e-3   # ice moves


def test_model_cuda_without_gpu_raises(monkeypatch):
    """No silent CPU fallback: a CUDA model without a card is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, _ = _cfgs("fused_pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdriver.Model(tcfg, device="cuda")
