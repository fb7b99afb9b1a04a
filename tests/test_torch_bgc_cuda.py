"""The biogeochemistry of the PyTorch port on the card: aerosols with modal
optics, the skeletal layer with high-frequency coupling, and the brine
height with the vertical z tracers, through Model.step with the CUDA
kernels K1 and K2. Every test needs a CUDA device: marked `cuda`, they
skip on a machine without one. On the GPU machine run them with

    python -m pytest --noconftest tests/test_torch_bgc_cuda.py -q

- One 48x40 coupled step (f32) of `modal`, of `bgcskl` with
  `forcing.highfreq`, and of `bgcz` on the card against the same step on
  the CPU: 2e-3 of each leaf's largest value (tests/test_torch_step.py's
  f32 bar), the ponds compared through their volumes with the floor 1e-4 m
  as tests/test_torch_columns_cuda.py does.
- K1, K2 and K3 against their plain versions on the bgcz state after two
  steps (NT=266, 226 entries of type 3): max abs error exactly 0.0 (the
  kernels are built with -fmad=false).
- The stacked z-tracer step on the card against the CPU: f64 to 1e-12 and
  f32 to 1e-4 of each field's largest value (tests/
  test_torch_zbgc_vertical.py's bars; the card's exp and the division by
  a CPU scalar, a multiply by its reciprocal there, differ in the last
  bits).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu_torch.cli.main import OPTION_SETS  # noqa: E402
from cice_tpu_torch.columns import zbgc_vertical as tz  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.dynamics.evp import evp_solve  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402
from cice_tpu_torch.kernels import remap as kremap  # noqa: E402
from cice_tpu_torch.measure import (evp_state_problem, flux_case,  # noqa: E402
                                    transport_state_problem)
from cice_tpu_torch.model.driver import Model  # noqa: E402
from test_torch_columns_cuda import (POND_FLOOR, RTOL_F32, _cfg,  # noqa: E402
                                     _leaves)

pytestmark = pytest.mark.cuda

SETS = {"modal": dict(OPTION_SETS["modal"]),
        "bgcskl_highfreq": {**OPTION_SETS["bgcskl"],
                            "forcing.highfreq": True},
        "bgcz": dict(OPTION_SETS["bgcz"])}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested against JAX on CPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(SETS))
def test_one_step_on_the_card_against_the_cpu(cuda, name):
    out = {}
    for dev in ("cpu", cuda):
        m = Model(_cfg(SETS[name]), device=dev)
        kevp.launches = kremap.launches = 0
        m.step()
        if dev == cuda:
            torch.cuda.synchronize()
            assert kevp.launches == 1 and kremap.launches == 1
        out[str(dev)] = _leaves(m)
    cpu, card = out["cpu"], out[str(cuda)]
    assert cpu.keys() == card.keys()
    for k, ref in cpu.items():
        got = card[k]
        if ref.dtype == np.bool_:
            np.testing.assert_array_equal(got, ref, err_msg=k)
            continue
        assert np.isfinite(got).all(), k
        scale = float(np.abs(ref).max())
        floor = POND_FLOOR if k.endswith("_volume") else 0.0
        np.testing.assert_allclose(got, ref, rtol=RTOL_F32,
                                   atol=max(RTOL_F32 * scale, floor),
                                   err_msg=f"{name}: {k}")


def test_k1_k2_and_k3_on_the_bgcz_state_bit_for_bit(cuda):
    m = Model(_cfg(SETS["bgcz"]), device=cuda)
    m.run(2)
    dt = m.cfg.setup.dt
    args, kw = evp_state_problem(m.static, m.grid, m.state, m.forcing,
                                 m.flux.strairx, m.flux.strairy, dt)
    ref = evp_solve(*args, **kw)
    got = kevp.evp_solve_fused(*args, **kw)
    targs, moving = transport_state_problem(m.static, m.grid, m.state, dt)
    table = targs[-1]
    ref2 = kremap.transport_plain(*targs)
    got2 = kremap.transport_fused(*targs)
    fargs, tstack = flux_case(*targs)
    ref3 = kremap.tracer_fluxes_plain(*fargs)
    got3 = kremap.tracer_fluxes_fused(*fargs, tstack=tstack)
    torch.cuda.synchronize()
    assert len(table) == 266 and sum(t.ttype == 3 for t in table) == 226
    assert moving > 1e-4
    for g, r in zip((*got, *got2, *got3), (*ref, *ref2, *ref3)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) == 0.0


def _step_inputs(rng, dtype, names, ncat=5, nilyr=7, nb=7, ny=10, nx=12):
    """tests/test_torch_zbgc_vertical.py's inputs, the enthalpies from the
    port's mushy liquidus (the GPU machine has no JAX)."""
    from cice_tpu_torch.columns.mushy import enthalpy_mush
    shp = (ncat, ny, nx)
    aicen = np.where(rng.random(shp) < 0.2, 0.0, 0.05 + 0.3 * rng.random(shp))
    lay = (ncat, nilyr, ny, nx)
    S = 0.5 + 12.0 * rng.random(lay)
    T = -15.0 * rng.random(lay) ** 2 - 0.05
    q = enthalpy_mush(torch.as_tensor(T), torch.as_tensor(S)).numpy()
    a = dict(aicen=aicen, vicen=aicen * (0.1 + 2.5 * rng.random(shp)),
             vsnon=aicen * 0.4 * rng.random(shp),
             fbri=np.where(aicen > 0, 0.3 + 0.9 * rng.random(shp), 0.0),
             qice=q, sice=S, darcy_V=1e-7 * (rng.random(shp) - 0.5),
             fswthru=60.0 * rng.random(shp),
             Tbot=-1.8 + 0.2 * rng.random((ny, nx)),
             meltt=0.01 * rng.random(shp), meltb=0.01 * rng.random(shp),
             congel=0.01 * rng.random(shp),
             frazil=0.02 * rng.random((ny, nx)),
             melts=0.02 * rng.random(shp))
    blay = (ncat, nb, ny, nx)
    cast = lambda d: {k: v.astype(dtype) for k, v in d.items()}
    return (cast(a), cast({n: 20.0 * rng.random(blay) ** 2 for n in names}),
            cast({n: rng.random(blay) for n in names}),
            cast({n: 0.5 * rng.random(shp) for n in names}),
            cast({n: np.full((ny, nx), 1e-9) for n in names
                  if n.startswith("zaero")}))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stacked_step_zbgc_on_the_card_against_the_cpu(cuda, dtype):
    zcfg = Config().with_overrides(**{
        **OPTION_SETS["bgcz"], "zbgc.tr_zaero": True, "zbgc.n_zaero": 3,
        "zbgc.tr_bgc_hum": True}).zbgc
    names = tz.z_tracer_names(zcfg)
    a, trc, frac, snow, dep = _step_inputs(np.random.default_rng(73), dtype,
                                           names)
    res = {}
    for dev in ("cpu", cuda):
        t = lambda x: torch.as_tensor(x, device=dev)
        conv = lambda d: {k: t(v) for k, v in d.items()}
        res[str(dev)] = tz.step_zbgc(
            zcfg, 3600.0, **conv(a), trc=conv(trc), frac=conv(frac),
            snow=conv(snow), zaero_dep=conv(dep))
    rtol = {"float64": 1e-12, "float32": 1e-4}[dtype]
    cpu, card = res["cpu"], res[str(cuda)]
    for part in ("trc", "frac", "flux_ocn", "diags", "snow"):
        for k, r in getattr(cpu, part).items():
            g = getattr(card, part)[k].cpu().numpy()
            r = r.numpy()
            scale = max(float(np.abs(r).max()), 1e-300)
            np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale,
                                       err_msg=f"{part}: {k}")
