"""The column options of the PyTorch port on the card: mushy
thermodynamics, delta-Eddington shortwave, snow physics, the floe size
distribution with wave spectra, form drag and topographic ponds, through
Model.step with the CUDA kernels K1 and K2. Every test needs a CUDA
device: marked `cuda`, they skip on a machine without one. On the GPU
machine run them with

    python -m pytest --noconftest tests/test_torch_columns_cuda.py -q

- One 48x40 coupled step (f32) of `mushy,dedd` and of the composite of
  `snwgrain`, `fsd12`, `fdrag` and `pondtopo` on the card against the same
  step on the CPU: 2e-3 of each leaf's largest value (tests/
  test_torch_step.py's f32 bar). The ponds hold midwinter rounding residue
  (apnd ~ 1e-4 in f32), and the topographic lid is carried with that
  residue as its weight, so the ponds are compared through their volumes
  apnd*hpnd and apnd*ipnd, each with the absolute floor 1e-4 m. The FSD's
  fracture marks are knife edges (tests/test_torch_fsd.py): at most 1 % of
  the cells may differ there.
- K1 and K2 against their plain versions on the mushy and dEdd state after
  two steps: max abs error exactly 0.0 (the kernels are built with
  -fmad=false).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.dynamics.evp import evp_solve  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402
from cice_tpu_torch.kernels import remap as kremap  # noqa: E402
from cice_tpu_torch.measure import (evp_state_problem,  # noqa: E402
                                    transport_state_problem)
from cice_tpu_torch.model.driver import Model  # noqa: E402

pytestmark = pytest.mark.cuda

NX, NY, NDTE = 48, 40, 40
RTOL_F32 = 2e-3
POND_FLOOR = 1e-4
MUSHY_DEDD = {"thermo.ktherm": 2, "thermo.tfrz_option": "mushy",
              "shortwave.shortwave": "dEdd"}
COMPOSITE = {"tracers.tr_snow": True, "snow.snwgrain": True,
             "snow.snwredist": "bulk", "tracers.tr_fsd": True,
             "domain.nfsd": 12, "forcing.wave_spec_type": "profile",
             "forcing.formdrag": True, "tracers.tr_pond_lvl": False,
             "tracers.tr_pond_topo": True}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested against JAX on CPU)")
    return torch.device("cuda")


def _cfg(over):
    return tconfig.gx1pop_step(NX, NY, remap_kernel="auto").with_overrides(
        **{"dynamics.ndte": NDTE, **over})


def _leaves(m):
    st = convert.tree_to_numpy(convert.state_to_numpy(m.state))
    tr = {k[len("trcrn."):]: v for k, v in st.items()
          if k.startswith("trcrn.")}
    if "apnd" in tr:
        st["pond_volume"] = tr["apnd"] * tr["hpnd"]
        st["lid_volume"] = tr["apnd"] * tr["ipnd"]
        for k in ("apnd", "hpnd", "ipnd"):
            del st[f"trcrn.{k}"]
    return st


@pytest.mark.parametrize("over", [MUSHY_DEDD, COMPOSITE],
                         ids=["mushy_dedd", "composite"])
def test_one_step_on_the_card_against_the_cpu(cuda, over):
    out = {}
    for dev in ("cpu", cuda):
        m = Model(_cfg(over), device=dev)
        kevp.launches = kremap.launches = 0
        m.step()
        if dev == cuda:
            torch.cuda.synchronize()
            assert kevp.launches == 1 and kremap.launches == 1
        out[str(dev)] = _leaves(m)
    cpu, card = out["cpu"], out[str(cuda)]
    assert cpu.keys() == card.keys()
    worst = {}
    for k, ref in cpu.items():
        got = card[k]
        if ref.dtype == np.bool_:
            np.testing.assert_array_equal(got, ref, err_msg=k)
            continue
        assert np.isfinite(got).all(), k
        scale = float(np.abs(ref).max())
        floor = POND_FLOOR if k.endswith("_volume") else 0.0
        worst[k] = float(np.abs(got - ref).max()) / max(scale, 1e-30)
        if k == "trcrn.fsd":
            # a flipped fracture mark moves a sixth of a bin's area in its
            # cell: count the cells, as tests/test_torch_fsd.py does
            off = (np.abs(got - ref) > RTOL_F32 * scale).any(axis=(0, 1))
            print(f"FSD: {int(off.sum())} of {off.size} cells differ")
            assert off.mean() <= 0.01
            continue
        np.testing.assert_allclose(got, ref, rtol=RTOL_F32,
                                   atol=max(RTOL_F32 * scale, floor),
                                   err_msg=k)
    print("card against CPU, max |diff| / max |CPU| per leaf:", worst)


def test_k1_and_k2_on_the_mushy_dedd_state_bit_for_bit(cuda):
    m = Model(_cfg(MUSHY_DEDD), device=cuda)
    m.run(2)
    dt = m.cfg.setup.dt
    args, kw = evp_state_problem(m.static, m.grid, m.state, m.forcing,
                                 m.flux.strairx, m.flux.strairy, dt)
    ref = evp_solve(*args, **kw)
    got = kevp.evp_solve_fused(*args, **kw)
    targs, moving = transport_state_problem(m.static, m.grid, m.state, dt)
    ref2 = kremap.transport_plain(*targs)
    got2 = kremap.transport_fused(*targs)
    torch.cuda.synchronize()
    assert float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max()) > 1e-3
    assert moving > 1e-4
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) == 0.0
    for g, r in zip(got2, ref2):
        assert float((g - r).abs().max()) == 0.0
    # the mushy salinity and dEdd-driven tracers are in K2's chunks
    names = {t.name for t in targs[-1]}
    assert {"sice", "qice", "apnd", "hpnd", "ipnd"} <= names
