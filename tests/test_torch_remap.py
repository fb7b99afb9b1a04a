"""PyTorch port vs JAX package: exact incremental remapping
(cice_tpu_torch.dynamics.remap_exact) stage by stage in f64, and the
wrappers of the one-pass and the flux-only transport kernels
(cice_tpu_torch.kernels.remap), whose CPU paths are the plain versions,
against the JAX Pallas kernels run by the interpreter.

Tolerances: f64 stages repeat the JAX expressions, so they agree to 1e-10
relative to each field's largest value (reduction order only). The f32
kernel comparison uses the JAX package's own engine-vs-engine bar
(tests/test_remap_pallas.py:131-143): area rtol 1e-5, tracers rtol 5e-4
with atol 5e-5 of each field's scale; conservation of area 1e-5 and of
tracer content 1e-4. The flux-only kernel is held to the JAX package's gate
for it (tests/test_remap_pallas.py:47-67): rtol 2e-5, atol 2e-6 of each
output's largest value.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.config import Config  # noqa: E402
from cice_tpu.core.grid import rectgrid as jrectgrid  # noqa: E402
from cice_tpu.core.halo import BC as JBC  # noqa: E402
from cice_tpu.dynamics import remap_exact as jrx  # noqa: E402
from cice_tpu.kernels.remap_pallas import tracer_fluxes_fused as jflux  # noqa: E402
from cice_tpu.kernels.remap_pallas import transport_fused as jfused  # noqa: E402
from cice_tpu.model.state import tracer_registry as jreg  # noqa: E402
from cice_tpu.model.state import zeros_state as jzeros  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.core.halo import BC as TBC  # noqa: E402
from cice_tpu_torch.dynamics import remap_exact as trx  # noqa: E402
from cice_tpu_torch.kernels import remap as tkremap  # noqa: E402
from cice_tpu_torch.model.state import tracer_registry as treg  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402


def _np(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, dict):
            out[f.name] = {k: np.asarray(x) for k, x in v.items()}
        elif f.name not in ("bc", "nx_global", "ny_global"):
            out[f.name] = np.asarray(v)
    return out


def _setup(dtype, nx=32, ny=24, ew="cyclic", kmt="default", seed=0,
           cfl=0.3):
    """A two-category blob of ice with every tracer filled, and a velocity
    field moving ~cfl cells per step, made with numpy from a seed."""
    jdt = jnp.dtype(dtype)
    cfg = Config().with_overrides(**{"grid.nx_global": nx,
                                     "grid.ny_global": ny})
    jg = jrectgrid(nx, ny, kmt_type=kmt, dtype=jdt, bc=JBC(ew, "open"))
    tg = convert.grid_from_numpy(_np(jg), TBC(ew, "open"), "cpu")
    st = jzeros(cfg, jg)
    rng = np.random.default_rng(seed)
    ncat = cfg.domain.ncat
    jj, ii = np.mgrid[0:ny, 0:nx]
    blob = np.exp(-(((ii - nx / 2) / 6.0) ** 2 + ((jj - ny / 2) / 5.0) ** 2))
    tm = np.asarray(jg.hm)
    aicen = np.zeros((ncat, ny, nx))
    aicen[1] = 0.6 * blob * tm
    aicen[2] = 0.3 * blob * tm
    aicen[4] = 0.05 * tm * (rng.random((ny, nx)) > 0.5)
    vicen = aicen * (1.0 + 0.3 * rng.random((ncat, ny, nx)))
    vsnon = aicen * 0.1 * rng.random((ncat, ny, nx))
    shape = lambda k: np.shape(st.trcrn[k])
    fill = dict(Tsfcn=lambda s: -5.0 - 3.0 * rng.random(s),
                qice=lambda s: -2.0e8 * (1 + 0.2 * rng.random(s)),
                sice=lambda s: 5.0 * (1 + 0.1 * rng.random(s)),
                qsno=lambda s: -1.0e8 * (1 + 0.1 * rng.random(s)),
                iage=lambda s: 3.0e7 * rng.random(s))
    trcrn = {k: (fill[k](shape(k)) if k in fill else rng.random(shape(k)))
             for k in st.trcrn}
    dx_m = float(np.asarray(jg.dxU)[0, 0])
    umax = cfl * dx_m / 3600.0
    u = umax * np.cos(2 * np.pi * jj / ny + 0.3) * (0.5 + rng.random((ny, nx)))
    v = umax * np.sin(2 * np.pi * ii / nx + 0.1)
    cast = lambda a: jnp.asarray(np.asarray(a, dtype))
    st = st.replace(aicen=cast(aicen), vicen=cast(vicen), vsnon=cast(vsnon),
                    trcrn={k: cast(x) for k, x in trcrn.items()},
                    uvel=cast(u), vvel=cast(v))
    ts = convert.state_from_numpy(_np(st), "cpu")
    Tf = np.full((ny, nx), -1.8, dtype)
    return cfg, jg, tg, st, ts, Tf


def _close(got, ref, rtol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


@pytest.mark.parametrize("ew", ["cyclic", "closed"])
def test_stages_match_jax_f64(ew):
    cfg, jg, tg, st, ts, _ = _setup("float64", ew=ew)
    jr, tr = jreg(cfg), treg(tconfig.Config().with_overrides(
        **{"grid.nx_global": 32, "grid.ny_global": 24}))
    jt, tt = jrx.build_flat_table(jr), trx.build_flat_table(tr)
    jam, jtrm = jrx.state_to_tracers(st, jr, jt)
    tam, ttrm = trx.state_to_tracers(ts, tr, tt)
    _close(tam, jam, 0.0, "am")
    _close(ttrm, jtrm, 0.0, "trm")

    jcf = jrx.construct_fields(jg, jam, jtrm, jt, jg.hm)
    tcf = trx.construct_fields(tg, tam, ttrm, tt, tg.hm)
    for name, a, b in zip(("mc", "mx", "my", "tc", "tx", "ty"), tcf, jcf):
        _close(a, b, 1e-10, name)

    for midpt in (False, True):
        jd = jrx.departure_points_scaled(jg, st.uvel, st.vvel, 3600.0, midpt)
        td = trx.departure_points_scaled(tg, ts.uvel, ts.vvel, 3600.0, midpt)
        for name, a, b in zip(("dxs", "dys", "oob"), td, jd):
            _close(a, b, 1e-12, name)
    jmom = jrx.edge_moments(jg, jd[0], jd[1])
    tmom = trx.edge_moments(tg, td[0], td[1])
    for name, a, b in zip(("mom_n", "mom_e"), tmom, jmom):
        _close(a, b, 1e-10, name)

    jfl = jrx.remap_fluxes(jg, jd[0], jd[1], *jcf[:6], jt)
    tfl = trx.remap_fluxes(tg, td[0], td[1], *tcf[:6], tt)
    for name, a, b in zip(("mflxe", "mflxn", "mtflxe", "mtflxn"), tfl, jfl):
        _close(a, b, 1e-10, name)

    jup = jrx.update_fields(jg, jam, jtrm, *jfl, jt)
    tup = trx.update_fields(tg, tam, ttrm, *tfl, tt)
    for name, a, b in zip(("am", "trm", "neg"), tup, jup):
        _close(a, b, 1e-10, name)

    for name, a, b in zip(("asum", "prods"), trx.global_sums(tg, tam, ttrm, tt),
                          jrx.global_sums(jg, jam, jtrm, jt)):
        _close(a, b, 1e-12, name)
    for name, a, b in zip(("tmin", "tmax"),
                          trx.monotonicity_bounds(tg, tam, ttrm, tt),
                          jrx.monotonicity_bounds(jg, jam, jtrm, jt)):
        _close(a, b, 0.0, name)


def test_horizontal_remap_exact_matches_jax_f64():
    cfg, jg, tg, st, ts, Tf = _setup("float64", seed=3)
    kw = dict(l_dp_midpt=True, conserv_check=True, monotonicity_check=True)
    jnew, jdiag = jax.jit(lambda s: jrx.horizontal_remap_exact(
        jg, s, jreg(cfg), jnp.asarray(Tf), 3600.0, **kw))(st)
    tnew, tdiag = trx.horizontal_remap_exact(
        tg, ts, treg(tconfig.Config()), torch.as_tensor(Tf), 3600.0, **kw)
    j, t = _np(jnew), convert.state_to_numpy(tnew)
    for k in ("aicen", "vicen", "vsnon"):
        _close(t[k], j[k], 1e-10, k)
    for k in j["trcrn"]:
        _close(t["trcrn"][k], j["trcrn"][k], 1e-10, k)
    for k in ("oob", "neg_mass", "mono_violation"):
        assert bool(tdiag[k]) == bool(jdiag[k]), k
    assert float(tdiag["cons_err_area"]) < 1e-12
    assert float(tdiag["cons_err_tracer"]) < 1e-10


def _small_tables():
    """A 6-tracer registry with every chain type (alvl -> apnd -> hpnd,
    hs -> qsno) in both packages: the interpreted Pallas kernel's compile
    time grows with the table, and this one keeps it near 20 s."""
    from cice_tpu.model import state as js
    from cice_tpu_torch.model import state as ts
    tabs = []
    for m in (js, ts):
        reg = (m.TracerSpec("alvl", m.DEP_AICE, hi=1.0),
               m.TracerSpec("apnd", m.DEP_AICE, parent="alvl", hi=1.0),
               m.TracerSpec("hpnd", m.DEP_AICE, parent="apnd"),
               m.TracerSpec("qsno", m.DEP_VSNO, 1, lo=-5e8, hi=0.0))
        tabs.append((jrx if m is js else trx).build_flat_table(reg))
    assert [f.ttype for f in tabs[1]] == [1, 1, 1, 2, 2, 3]
    return tabs


def test_fused_wrapper_cpu_matches_jax_pallas_interpret():
    """The K2 wrapper on CPU tensors (its plain version) against the JAX
    Pallas transport kernel run by the interpreter, on the same am, trm
    and edge moments (masked 16x16 grid, E-W cyclic)."""
    jt, tt = _small_tables()
    cfg, jg, tg, st, ts, Tf = _setup("float32", nx=16, ny=16, seed=1)
    rng = np.random.default_rng(4)
    ncat, ny, nx = 2, 16, 16
    aicen = np.asarray(st.aicen)[1:3]
    am = np.concatenate([np.clip(1.0 - aicen.sum(0), 0, 1)[None], aicen])
    trm = np.stack([1.0 + rng.random((ncat, ny, nx)),         # hi
                    0.3 * rng.random((ncat, ny, nx)),         # hs
                    rng.random((ncat, ny, nx)),               # alvl
                    rng.random((ncat, ny, nx)),               # apnd
                    1.1e8 - 1e8 * rng.random((ncat, ny, nx)),  # qsno + off
                    0.5 * rng.random((ncat, ny, nx))], axis=1)  # hpnd
    am, trm = am.astype(np.float32), trm.astype(np.float32)
    dxs, dys, _ = jrx.departure_points_scaled(jg, st.uvel, st.vvel, 3600.0,
                                              True)
    mom_n, mom_e = (np.array(m) for m in jrx.edge_moments(jg, dxs, dys))
    ref_am, ref_trm = jax.jit(lambda: jfused(
        jg, jnp.asarray(mom_n), jnp.asarray(mom_e), jnp.asarray(am),
        jnp.asarray(trm), jt, interpret=True))()
    T = torch.as_tensor
    before = tkremap.launches
    got_am, got_trm = tkremap.transport_fused(tg, T(mom_n), T(mom_e), T(am),
                                              T(trm), tt)
    assert tkremap.launches == before   # CPU tensors never reach the kernel
    np.testing.assert_allclose(got_am.numpy(), np.asarray(ref_am),
                               rtol=1e-5, atol=1e-7)
    got_trm, ref_trm = got_trm.numpy(), np.asarray(ref_trm)
    for n in range(ref_trm.shape[1]):
        r = ref_trm[:, n]
        scale = float(np.abs(r).max()) or 1.0
        np.testing.assert_allclose(got_trm[:, n], r, rtol=5e-4,
                                   atol=5e-5 * scale, err_msg=f"tracer {n}")


def test_pick_tile_fits_shared_memory():
    """The tile follows the layout the wrapper passes to the kernel: the
    default table's, and layouts with ever more kept values per cell."""
    table = trx.build_flat_table(treg(tconfig.Config()))
    layout = tkremap.pack_schedule(table,
                                   tkremap.build_schedule(table)).layout
    assert len(table) == 25 and tkremap.pick_tile(layout) == (32, 8)
    tiles = []
    for nslots in (1, 25, 100, 300, 1000):
        lay = layout._replace(n=27 * nslots + 8, nslots=nslots)
        tx, ty = tkremap.pick_tile(lay)
        assert tkremap.smem_bytes(tx, ty, lay) <= tkremap.MAX_SMEM
        tiles.append(tx * ty)
    assert tiles == sorted(tiles, reverse=True) and tiles[-1] < tiles[0]
    with pytest.raises(ValueError):
        tkremap.pick_tile(layout._replace(n=27 * 5000 + 8, nslots=5000))


def test_transport_plain_conserves_f32():
    cfg, jg, tg, st, ts, Tf = _setup("float32", seed=2)
    tnew, diag = trx.horizontal_remap_exact(
        tg, ts, treg(tconfig.Config()), torch.as_tensor(Tf), 3600.0,
        l_dp_midpt=True, conserv_check=True)
    assert float(diag["cons_err_area"]) < 1e-5
    assert float(diag["cons_err_tracer"]) < 1e-4
    assert not bool(diag["oob"]) and not bool(diag["neg_mass"])
    assert torch.isfinite(tnew.aicen).all()


def test_knife_edge_chain_no_amplification():
    """Port of tests/test_remap_exact.py::test_knife_edge_chain_no_
    amplification: a knife-edge snow weight chain (hs ~ 1e-7 m per area)
    must not amplify its snow enthalpy through repeated remap steps; the
    registry rails bound every tracer."""
    from cice_tpu_torch.model.state import _QSNO_LO
    cfg, jg, tg, st, ts, Tf = _setup("float64", nx=32, ny=32, kmt="none",
                                     seed=5)
    an = ts.aicen
    mask = an > 0
    trcrn = dict(ts.trcrn)
    vs = torch.where(mask, an * 1e-7, 0.0)
    trcrn["qsno"] = torch.where(mask[:, None], -2.5e8, 0.0).expand_as(
        trcrn["qsno"]).clone()
    dt = 3600.0
    dx_m = float(tg.dxU[0, 0])
    umax = 0.3 * dx_m / dt
    jj, ii = np.mgrid[0:32, 0:32]
    u = torch.as_tensor(umax * np.cos(2 * np.pi * jj / 32 + 0.3))
    v = torch.as_tensor(umax * np.sin(2 * np.pi * ii / 32 + 0.1))
    state = ts.replace(vsnon=vs, trcrn=trcrn, uvel=u, vvel=v)
    reg = treg(tconfig.Config())
    for _ in range(8):
        state, _ = trx.horizontal_remap_exact(tg, state, reg,
                                              torch.as_tensor(Tf), dt,
                                              l_dp_midpt=True)
    q = state.trcrn["qsno"].numpy()
    assert np.isfinite(q).all()
    assert q.min() >= _QSNO_LO - 1.0
    assert q.max() <= 1e-6
    t = state.trcrn["Tsfcn"].numpy()
    assert t.min() >= -100.0 - 1e-6 and t.max() <= 1e-6


FLUX_NAMES = ("mflxe", "mflxn", "mtflxe", "mtflxn")


def _flux_inputs(dtype, ew, ns, seed):
    """Random reconstructed fields, tracers with every chain type (the
    6-tracer tables) and edge moments of a moving velocity field on a
    16x16 grid with the given boundaries, as numpy."""
    jt, tt = _small_tables()
    ncat, ny, nx = 2, 16, 16
    jdt = jnp.dtype(dtype)
    jg = jrectgrid(nx, ny, kmt_type="default", dtype=jdt, bc=JBC(ew, ns))
    tg = convert.grid_from_numpy(_np(jg), TBC(ew, ns), "cpu")
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.random(s).astype(dtype)
    f = dict(mc=r(ncat + 1, ny, nx), mx=0.1 * (r(ncat + 1, ny, nx) - 0.5),
             my=0.1 * (r(ncat + 1, ny, nx) - 0.5),
             tc=1.0 + r(ncat, len(jt), ny, nx),
             tx=0.2 * (r(ncat, len(jt), ny, nx) - 0.5),
             ty=0.2 * (r(ncat, len(jt), ny, nx) - 0.5))
    dx_m = float(np.asarray(jg.dxU)[0, 0])
    u = 0.3 * dx_m / 3600.0 * (2.0 * r(ny, nx) - 1.0)
    v = 0.3 * dx_m / 3600.0 * (2.0 * r(ny, nx) - 1.0)
    dxs, dys, _ = jrx.departure_points_scaled(jg, jnp.asarray(u),
                                              jnp.asarray(v), 3600.0, True)
    return jg, tg, jt, tt, f, dxs, dys


BOUNDARIES = [("cyclic", "open"), ("open", "open"), ("closed", "closed")]


@pytest.mark.parametrize("ew,ns", BOUNDARIES)
def test_tracer_fluxes_plain_matches_jax_f64(ew, ns):
    """The flux-only kernel's plain version against the JAX package's plain
    `remap_fluxes` in f64: same expressions, reduction order only."""
    jg, tg, jt, tt, f, dxs, dys = _flux_inputs("float64", ew, ns, 11)
    order = ("mc", "mx", "my", "tc", "tx", "ty")
    ref = jrx.remap_fluxes(jg, dxs, dys, *(jnp.asarray(f[k]) for k in order),
                           jt)
    mom_n, mom_e = (torch.as_tensor(np.array(m))
                    for m in jrx.edge_moments(jg, dxs, dys))
    got = tkremap.tracer_fluxes_plain(
        tg, mom_n, mom_e, *(torch.as_tensor(f[k]) for k in order), tt)
    for name, a, b in zip(FLUX_NAMES, got, ref):
        _close(a, b, 1e-12, name)


@pytest.mark.parametrize("ew,ns", BOUNDARIES)
def test_tracer_fluxes_wrapper_cpu_matches_jax_pallas_interpret(ew, ns):
    """The K3 wrapper on CPU tensors (its plain version) against the JAX
    Pallas flux kernel run by the interpreter, in f32."""
    jg, tg, jt, tt, f, dxs, dys = _flux_inputs("float32", ew, ns, 12)
    order = ("mc", "mx", "my", "tc", "tx", "ty")
    jmom = jrx.edge_moments(jg, dxs, dys)
    ref = jax.jit(lambda: jflux(
        jg, *jmom, *(jnp.asarray(f[k]) for k in order), jt,
        interpret=True))()
    T = torch.as_tensor
    before = tkremap.flux_launches
    tstack = torch.cat([T(f["tc"]), T(f["tx"]), T(f["ty"])], dim=1)
    got = tkremap.tracer_fluxes_fused(
        tg, T(np.array(jmom[0])), T(np.array(jmom[1])),
        *(T(f[k]) for k in order), tt, tstack=tstack)
    assert tkremap.flux_launches == before   # CPU tensors: the plain version
    for name, a, b in zip(FLUX_NAMES, got, ref):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5,
                                   atol=2e-6 * scale, err_msg=name)


def test_fused_pallas_route_equals_plain_route_on_cpu():
    """horizontal_remap_exact(flux_kernel='fused_pallas') on CPU tensors
    runs construct -> K3's plain version -> update: the 'xla' result."""
    cfg, jg, tg, st, ts, Tf = _setup("float32", seed=6)
    reg = treg(tconfig.Config())
    kw = dict(l_dp_midpt=True, conserv_check=True)
    a, da = trx.horizontal_remap_exact(tg, ts, reg, torch.as_tensor(Tf),
                                       3600.0, flux_kernel="xla", **kw)
    b, db = trx.horizontal_remap_exact(tg, ts, reg, torch.as_tensor(Tf),
                                       3600.0, flux_kernel="fused_pallas",
                                       **kw)
    ta, tb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for k in ("aicen", "vicen", "vsnon"):
        np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)
    for k in ta["trcrn"]:
        np.testing.assert_array_equal(tb["trcrn"][k], ta["trcrn"][k],
                                      err_msg=k)
    for k in da:
        assert float(da[k]) == float(db[k]), k


@pytest.mark.parametrize("case", ["tripole", "y_cyclic", "float64"])
def test_tracer_fluxes_ineligible_on_cuda_raise(monkeypatch, case):
    """On a CUDA device the flux-only kernel never falls back: tripole and
    y-cyclic boundaries and f64 raise. The device check is patched, so no
    card is needed; the raise comes before anything is built."""
    monkeypatch.setattr(tkremap, "_on_cuda", lambda t: True)
    dtype = "float64" if case == "float64" else "float32"
    jg, tg, jt, tt, f, dxs, dys = _flux_inputs(dtype, "cyclic", "open", 13)
    if case == "tripole":
        tg = dataclasses.replace(tg, bc=TBC("cyclic", "tripole"))
    elif case == "y_cyclic":
        tg = dataclasses.replace(tg, bc=TBC("cyclic", "cyclic"))
    mom = torch.zeros((6, 10, 16, 16), dtype=getattr(torch, dtype))
    args = [torch.as_tensor(f[k])
            for k in ("mc", "mx", "my", "tc", "tx", "ty")]
    exc = ValueError if case == "float64" else NotImplementedError
    with pytest.raises(exc, match="flux-only transport kernel"):
        tkremap.tracer_fluxes_fused(tg, mom, mom, *args, tt)


def test_tracer_fluxes_bound_counts_planes():
    """The byte bound counts every plane it reads once: at the gx1 shapes
    with the default tracers, 495 planes read (the 2 type-3 tracers' tc
    alone) and 262 written."""
    table = trx.build_flat_table(treg(tconfig.Config()))
    nbytes, flops = tkremap.tracer_fluxes_bound_bytes_flops(table, 5, 384,
                                                            320)
    assert len(table) == 25
    assert sum(f.ttype == 3 for f in table) == 2
    assert nbytes == 4 * 384 * 320 * (355 + 18 + 120 + 2 + 2 * (125 + 6))
    assert flops > 0


def test_unported_engines_raise():
    cfg, jg, tg, st, ts, Tf = _setup("float32", nx=8, ny=8)
    reg = treg(tconfig.Config())
    with pytest.raises(ValueError, match="flux_kernel"):
        trx.horizontal_remap_exact(tg, ts, reg, torch.as_tensor(Tf), 60.0,
                                   flux_kernel="fused")
    with pytest.raises(NotImplementedError, match="C/CD"):
        trx.horizontal_remap_exact(tg, ts, reg, torch.as_tensor(Tf), 60.0,
                                   grid_ice="C")
