"""therm1's BL99 temperature solve and its CUDA kernel K4
(cice_tpu_torch/kernels/bl99.py, csrc/bl99_column.cu) on the CPU: what can
be held without a card. K4 itself equals the plain version bit for bit in
tests/test_torch_kernels_cuda.py, on the card.

- The route: CPU tensors and ktherm=2 take the plain version; on CUDA
  tensors (here a stubbed check) no mesh takes `whole`, a mesh `per_pass`.
- The per-pass loop with a stand-in for the library that scripts each
  pass's largest change: it stops where the plain version does, reads the
  host once a pass, counts its launches; `whole` reads nothing.
- The build: K4 is one of the fixed sources, compiled to SASS only, and a
  library already built loads without starting nvcc.
- The wrapper's orders of inputs, outputs, constants and shapes equal the
  CUDA source's.
- The plain solve on a 1x2 mesh's tiles equals the whole grid's, through
  the rank job the card's test runs on K4's per-pass route.
"""

import ctypes
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu_torch import constants as cst  # noqa: E402
from cice_tpu_torch.columns import atmo  # noqa: E402
from cice_tpu_torch.columns import thermo_vertical as tv  # noqa: E402
from cice_tpu_torch.kernels import _build  # noqa: E402
from cice_tpu_torch.kernels import bl99, launch_counts  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.utils import timers  # noqa: E402

NCAT, NY, NX = 3, 8, 32   # a 1x2 tile: 384 values, whole vector loops
SOURCE = os.path.join(_build.CSRC, "bl99_column.cu")


def _args(nilyr=7, nslyr=1, seed=0, dtype=torch.float32):
    """Arguments of `temperature_changes` on a small (NCAT, NY, NX) state:
    cold and warm surfaces, columns with and without snow."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    shp = (NCAT, NY, NX)
    salin = [float(x) for x in tv.bl99_salinity(nilyr)]
    Tm = [float(x) for x in tv.melting_temps(np.asarray(salin))]
    hin = 0.2 + 2.5 * rng.random(shp)
    hsn = np.where(rng.random(shp) < 0.3, 0.0, 0.4 * rng.random(shp))
    Ti = [-20.0 * rng.random(shp) - 0.5 for _ in range(nilyr)]
    qice = [T(tv.enthalpy_ice(T(t), m)) for t, m in zip(Ti, Tm)]
    qsno = [T(tv.enthalpy_snow(T(-10.0 * rng.random(shp))))
            for _ in range(nslyr)]
    plane = lambda lo, hi: T(lo + (hi - lo) * rng.random((NY, NX)))
    kw = dict(Tsf=T(-25.0 * rng.random(shp)), qsno=qsno, qice=qice,
              salin=salin, Tm=Tm, hilyr=T(hin / nilyr), hslyr=T(hsn / nslyr),
              Tbot=plane(-1.9, -1.7), fswsfc=T(200.0 * rng.random(shp)),
              Iswabs=[T(5.0 * rng.random(shp)) for _ in range(nilyr)],
              shcoef=T(1.0 + 2.0 * rng.random(shp)),
              lhcoef=T(3.0 + 4.0 * rng.random(shp)),
              potT=plane(240.0, 275.0), Qa=plane(1e-4, 3e-3),
              rhoa=plane(1.2, 1.4), flw=plane(150.0, 320.0))
    return 3600.0, nilyr, nslyr, kw


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on_card,ktherm,mesh,route", [
    (False, 1, None, None), (False, 1, "mesh", None), (False, 2, None, None),
    (True, 1, None, "whole"), (True, 1, "mesh", "per_pass"),
    (True, 2, None, None), (True, 2, "mesh", None)])
def test_route_follows_the_device_the_algorithm_and_the_mesh(
        monkeypatch, on_card, ktherm, mesh, route):
    monkeypatch.setattr(bl99, "_on_cuda", lambda t: on_card)
    assert bl99.choose_route(torch.zeros(2), ktherm, mesh) == route


@pytest.mark.parametrize("on_card,ktherm,mesh,want", [
    (False, 1, None, "plain"), (False, 2, None, "plain"),
    (True, 1, None, "whole"), (True, 1, "mesh", "per_pass"),
    (True, 2, None, "plain")])
def test_temperature_changes_runs_the_route(monkeypatch, on_card, ktherm,
                                            mesh, want):
    """`temperature_changes` hands the kernel its arguments and the route,
    or runs the plain version (both stubbed here)."""
    calls = []
    monkeypatch.setattr(bl99, "_on_cuda", lambda t: on_card)
    monkeypatch.setattr(tv, "temperature_changes_plain",
                        lambda *a, **k: calls.append(("plain", k)) or "p")
    monkeypatch.setattr(bl99, "temperature_changes_cuda",
                        lambda *a, route, **k:
                        calls.append((route, k)) or ("k", "q", "i", "n"))
    dt, nilyr, nslyr, kw = _args()
    got = tv.temperature_changes(dt, nilyr, nslyr, ktherm=ktherm, mesh=mesh,
                                 conduct="MU71", nit=7, **kw)
    assert [c[0] for c in calls] == [want]
    assert calls[0][1]["mesh"] == mesh and calls[0][1]["nit"] == 7
    assert calls[0][1]["conduct"] == "MU71"
    assert got == ("p" if want == "plain" else ("k", "q", "i"))


@pytest.mark.parametrize("nslyr,nilyr", [(1, 4), (2, 7), (1, 8)])
def test_a_shape_not_built_raises_before_any_launch(monkeypatch, nslyr,
                                                    nilyr):
    monkeypatch.setattr(bl99, "_on_cuda", lambda t: True)
    monkeypatch.setattr(bl99, "_lib", lambda: pytest.fail("no launch"))
    before = launch_counts()
    dt, _, _, kw = _args(nilyr, nslyr)
    with pytest.raises(ValueError, match="not built"):
        tv.temperature_changes(dt, nilyr, nslyr, **kw)
    assert launch_counts() == before


def test_layer_numbers_as_tensors_raise(monkeypatch):
    """ktherm=1 takes salin and Tm as numbers (the kernel's constants);
    tensors there raise on the card rather than being read."""
    monkeypatch.setattr(bl99, "_on_cuda", lambda t: True)
    monkeypatch.setattr(bl99, "_lib", lambda: pytest.fail("no launch"))
    dt, nilyr, nslyr, kw = _args()
    kw["salin"] = [torch.tensor(s) for s in kw["salin"]]
    with pytest.raises(ValueError, match="as numbers"):
        tv.temperature_changes(dt, nilyr, nslyr, **kw)


# ---------------------------------------------------------------------------
# the pass loop, with a stand-in for the library
# ---------------------------------------------------------------------------

class _FakeLib:
    """The library's entry on CPU memory: a launch that runs a pass writes
    the next of `errs` into the pass's slot (as the dtype's bits), one
    that runs the epilogue writes the pass count; every launch is logged
    as (first pass, pass limit, cooperative, blocks)."""

    def __init__(self, errs, dtype):
        self.errs, self.dtype, self.log = list(errs), dtype, []

    def bl99_solve(self, f64, nslyr, nilyr, ptrs, cs, out, consts, N, P,
                   p0, nit, coop, cond, ws, blocks, stream):
        self.log.append((p0, nit, coop, blocks))
        if coop:
            return 0
        if p0 < nit:
            e = self.errs[min(p0, len(self.errs) - 1)]
            b = np.array([e], np.float64 if f64 else np.float32).tobytes()
            ctypes.memmove(ws + 8 * (2 + p0), b, len(b))
        else:
            ctypes.memmove(ws + 8, np.int32(p0).tobytes(), 4)
        return 0


def _fake(monkeypatch, errs, dtype):
    lib = _FakeLib(errs, dtype)
    monkeypatch.setattr(bl99, "_lib", lambda: lib)
    monkeypatch.setattr(bl99, "_stream", lambda dev: None)
    return lib


@pytest.mark.parametrize("errs,nit,passes", [
    ([1.0, 2e-3, 4e-4], 20, 3),        # converged on the third pass
    ([1e-9], 20, 1),                     # converged on the first
    ([5e-4], 20, 1),                     # not above TSF_ERRMAX: stops
    ([1.0], 4, 4),                       # runs out of passes
    ([1.0, math.nan], 20, 2),            # NaN stops the solve, as max does
    ([1.0], 0, 0)])                      # no pass: the epilogue alone
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_per_pass_route_stops_where_the_plain_loop_does(monkeypatch, errs,
                                                        nit, passes, dtype):
    lib = _fake(monkeypatch, errs, dtype)
    dt, nilyr, nslyr, kw = _args(dtype=dtype)
    reads = timers.sync_counts().get("picard", 0)
    launches = launch_counts().get("bl99_per_pass", 0)
    ts, qsno_new, qice_new, npass = bl99.temperature_changes_cuda(
        dt, nilyr, nslyr, nit=nit, route="per_pass", **kw)
    blocks = -(-NCAT * NY * NX // bl99.THREADS)
    assert lib.log == [(p, p + 1, 0, blocks) for p in range(passes)] + \
        [(passes, passes, 0, blocks)]
    assert int(npass) == passes and npass.dtype == torch.int32
    assert timers.sync_counts().get("picard", 0) - reads == passes
    assert launch_counts()["bl99_per_pass"] - launches == passes + 1
    assert ts.Tsf.shape == (NCAT, NY, NX) and ts.Tsf.dtype == dtype
    assert len(ts.Tice) == nilyr and len(qice_new) == nilyr
    assert len(ts.Tsno) == nslyr and len(qsno_new) == nslyr


@pytest.mark.parametrize("sms,per_sm,blocks", [(132, 2, 12), (2, 3, 6),
                                               (1, 1, 1)])
def test_whole_route_is_one_launch_and_no_host_read(monkeypatch, sms,
                                                    per_sm, blocks):
    """One launch whatever the passes, with no more blocks than can be
    resident or than the columns fill; nothing read on the host."""
    lib = _fake(monkeypatch, [1.0], torch.float32)
    monkeypatch.setattr(bl99, "device_info", lambda *a: dict(
        sm_count=sms, blocks_per_sm=per_sm, registers=64, threads=64))
    dt, nilyr, nslyr, kw = _args()
    reads = timers.sync_counts().get("picard", 0)
    launches = launch_counts().get("bl99_whole", 0)
    bl99.temperature_changes_cuda(dt, nilyr, nslyr, nit=20, route="whole",
                                  **kw)
    assert lib.log == [(0, 20, 1, blocks)]
    assert timers.sync_counts().get("picard", 0) == reads
    assert launch_counts()["bl99_whole"] - launches == 1


def test_inputs_go_to_the_kernel_where_they_lie(monkeypatch):
    """Per-category planes by their category stride, one plane for all
    categories with stride 0, a layer's view of a stacked tensor without a
    copy; an input that does not lie as planes is copied whole."""
    seen = {}

    def spy(tensors, shape):
        keep, ptrs, strides = real(tensors, shape)
        seen.update(tensors=tensors, keep=keep, strides=strides)
        return keep, ptrs, strides
    real = bl99._plane_views
    monkeypatch.setattr(bl99, "_plane_views", spy)
    _fake(monkeypatch, [0.0], torch.float32)
    dt, nilyr, nslyr, kw = _args()
    stacked = torch.stack(kw["Iswabs"], dim=1)          # (ncat, nilyr, ...)
    kw["Iswabs"] = [stacked[:, k] for k in range(nilyr)]
    kw["Tbot"] = kw["Tbot"].t().contiguous().t()        # a transposed plane
    bl99.temperature_changes_cuda(dt, nilyr, nslyr, route="per_pass", **kw)
    names = list(bl99.INPUTS) + ["qsno"] * nslyr + ["qice"] * nilyr + \
        ["Iswabs"] * nilyr
    s = dict(zip(names, seen["strides"]))
    assert s["Tsf"] == NY * NX and s["potT"] == 0 and s["qice"] == NY * NX
    assert seen["strides"][-nilyr:] == [nilyr * NY * NX] * nilyr
    k = names.index("Iswabs")
    assert seen["keep"][k].data_ptr() == kw["Iswabs"][0].data_ptr()
    tb = seen["keep"][names.index("Tbot")]
    assert tb.is_contiguous() and torch.equal(tb[0], kw["Tbot"])


def test_a_call_imports_nothing_more(tmp_path):
    """Set-up: a process's first call of the wrapper loads no module
    beyond the library (torch.broadcast_shapes, for one, imports sympy:
    ~4 s on the card's host)."""
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "sys.path[:0] = [%r, %r]\n"
        "import test_torch_bl99 as tb\n"
        "from cice_tpu_torch.kernels import bl99\n"
        "lib = tb._FakeLib([1.0, 0.0], torch.float32)\n"
        "bl99._lib, bl99._stream = (lambda: lib), (lambda dev: None)\n"
        "dt, nilyr, nslyr, kw = tb._args()\n"
        "before = set(sys.modules)\n"
        "bl99.temperature_changes_cuda(dt, nilyr, nslyr, route='per_pass',"
        " **kw)\n"
        "print(sorted(set(sys.modules) - before))\n") % (
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_step_therm1_inputs_reach_the_kernel_without_a_copy(monkeypatch):
    """The arguments a model step hands the solve (the per-layer shortwave
    as views of one stacked tensor, the forcing as planes) go to the
    kernel where they lie."""
    from cice_tpu_torch import config as tconfig
    from cice_tpu_torch.measure import therm1_problem
    from cice_tpu_torch.model.driver import Model
    dt, nilyr, nslyr, kw = therm1_problem(Model(
        tconfig.gx1pop_step(24, 20), device="cpu"))
    seen = {}
    real = bl99._plane_views

    def spy(tensors, shape):
        seen["in"], seen["out"] = tensors, real(tensors, shape)
        return seen["out"]
    monkeypatch.setattr(bl99, "_plane_views", spy)
    _fake(monkeypatch, [0.0], torch.float32)
    ts = bl99.temperature_changes_cuda(dt, nilyr, nslyr, route="per_pass",
                                       **kw)[0]
    keep, _, strides = seen["out"]
    assert [v.data_ptr() for v in keep] == [t.data_ptr() for t in seen["in"]]
    ncat = ts.Tsf.shape[0]
    assert ts.Tsf.shape == (ncat, 20, 24) and 0 in strides
    assert strides[-nilyr:] == [nilyr * 20 * 24] * nilyr


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_k4_is_a_fixed_source_built_to_sass_only():
    assert "bl99_column" in _build.SOURCES
    assert os.path.isfile(SOURCE)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "code=sm_90a" in flags and "code=compute" not in flags
    assert "-fmad=false" in flags


def test_a_built_library_loads_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CICE_TPU_TORCH_BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    path = _build._lib_path("bl99_column")
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, "wb") as f:
        f.write(b"built")

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc started for a library already built")
    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda p: loaded.append(p) or "lib")
    assert _build.load("bl99_column") == "lib"
    assert _build.load("bl99_column") == "lib"
    assert loaded == [path]


def test_a_first_load_builds_every_missing_source_at_once(monkeypatch,
                                                         tmp_path):
    """A library not built yet: every source not built yet gets its nvcc
    process, all started before any is waited for; one already built is
    left alone."""
    monkeypatch.setenv("CICE_TPU_TORCH_BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    with open(_build._lib_path("evp_fused"), "wb") as f:
        f.write(b"built")
    events = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            events.append(("start", os.path.basename(cmd[-1])))

        def communicate(self):
            events.append(("wait", None))
            open(self.out, "wb").close()
            return b"", None
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda p: p)
    assert _build.load("bl99_column") == _build._lib_path("bl99_column")
    want = [n + ".cu" for n in _build.SOURCES if n != "evp_fused"]
    assert [e for e in events if e[0] == "start"] == \
        [("start", n) for n in want]
    assert events.index(("wait", None)) == len(want)
    for n in _build.SOURCES:
        assert os.path.exists(_build._lib_path(n))


def test_an_edited_source_is_a_new_library(monkeypatch):
    """The library's name hashes the source and the flags."""
    a = _build._lib_path("bl99_column")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._lib_path("bl99_column") != a


# ---------------------------------------------------------------------------
# the wrapper and the source agree
# ---------------------------------------------------------------------------

def _enum(first, last):
    with open(SOURCE) as f:
        src = f.read()
    body = re.search(r"enum\s*\{([^}]*\b" + first + r"\b[^}]*)\}", src,
                     re.S).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    return names[:names.index(last)] if last else names


def test_inputs_and_outputs_in_the_sources_order():
    ins = _enum("I_TSF", "I_LAYERS")
    assert [n[2:].lower() for n in ins] == [n.lower() for n in bl99.INPUTS]
    outs = _enum("O_TSF", "O_LAYERS")
    assert [n[2:].lower() for n in outs] == \
        [n.lower().replace("keff_top", "keff") for n in bl99.OUTPUTS]


@pytest.mark.parametrize("conduct", ["bubbly", "MU71"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_fill_the_sources_table(conduct, dtype):
    nk, nlk = len(_enum("K_DT", "N_K")), len(_enum("L_TM", "N_LK"))
    _, nilyr, nslyr, kw = _args()
    c = bl99.kernel_consts(dtype, 3600.0, nslyr, tuple(kw["salin"]),
                           tuple(kw["Tm"]), conduct, tv.TSF_ERRMAX)
    assert len(c) == nk + nlk * nilyr
    f = np.float32 if dtype == torch.float32 else np.float64
    assert all(float(f(v)) == v for v in c)
    k = dict(zip(_enum("K_DT", "N_K"), c[:nk]))
    # tensor / scalar on the card: a multiply by the reciprocal rounded in
    # the dtype, which is not the scalar's reciprocal rounded once
    assert k["K_RRHOI"] == float(f(1.0) / f(cst.rhoi))
    assert k["K_ERRMAX"] == float(f(tv.TSF_ERRMAX))
    assert k["K_KC0"] == float(f(cst.kice if conduct == "MU71" else 2.11))


@pytest.mark.parametrize("module,name,key", [
    (tv, "T_MIN", "K_TMIN"), (tv, "T_COND_MAX", "K_TS_MAX"),
    (tv, "BUBBLY_K0", "K_KC0"), (tv, "BUBBLY_KT", "K_KC1"),
    (tv, "TT_MIN", "K_TIN_MIN"), (tv, "DENOM_MIN", "K_TINY"),
    (atmo, "RHOA_MIN", "K_RHOA_MIN"), (atmo, "TSFK_MIN", "K_TSFK_MIN")])
def test_constants_are_read_from_the_plain_versions_names(
        monkeypatch, module, name, key):
    """The kernel's constants follow the plain version's own names, so a
    value changed there reaches the kernel too."""
    nk = len(_enum("K_DT", "N_K"))
    _, nilyr, nslyr, kw = _args()
    args = (torch.float64, 3600.0, nslyr, tuple(kw["salin"]),
            tuple(kw["Tm"]), "bubbly", tv.TSF_ERRMAX)
    monkeypatch.setattr(module, name, 0.5 + getattr(module, name))
    bl99.kernel_consts.cache_clear()
    try:
        k = dict(zip(_enum("K_DT", "N_K"), bl99.kernel_consts(*args)[:nk]))
    finally:
        bl99.kernel_consts.cache_clear()
    assert k[key] == getattr(module, name)


def test_built_shapes_are_the_sources():
    with open(SOURCE) as f:
        src = f.read()
    line = re.search(r"#define BL99_SHAPES\(X\)(.*)", src).group(1)
    got = tuple((int(a), int(b))
                for a, b in re.findall(r"X\((\d+),\s*(\d+)\)", line))
    assert got == bl99.SHAPES


def test_print_all_and_the_run_line_show_launches(capsys, monkeypatch):
    monkeypatch.setattr(bl99, "whole_launches", bl99.whole_launches + 1)
    txt = timers.Timers().init_standard().print_all()
    assert "launches (hand-written kernels, by route):" in txt
    assert "bl99_whole" in txt
    from cice_tpu_torch.cli import main as tcli
    rc = tcli.main(["run", "--steps", "1", "--device", "cpu", "--set",
                    "grid.nx_global=8", "--set", "grid.ny_global=6",
                    "--set", "dynamics.ndte=2", "--set", "thermo.nit=2"])
    out = capsys.readouterr().out
    assert rc == 0 and '"launches": {' in out and "bl99_whole" in out


# ---------------------------------------------------------------------------
# across ranks: the rank job of the card's per-pass test, on the CPU
# ---------------------------------------------------------------------------

def test_plain_solve_on_a_1x2_mesh_equals_the_whole_grid(tmp_path):
    import test_torch_rank_jobs as rj
    dt, nilyr, nslyr, kw = _args(seed=3)
    problem = rj.bl99_problem(dt, nilyr, nslyr, dict(kw, nit=20),
                              str(tmp_path / "bl99.pkl"))
    ref = rj.bl99_whole(problem)
    (r,) = spawn.launch([(rj.bl99_tiles, dict(problem=problem,
                                              shape=(1, 2)), 2)],
                        2, str(tmp_path), timeout=120.0)
    assert len({x["digest"] for x in r}) == 1
    assert len(r[0]["out"]) == len(ref)
    for a, b in zip(r[0]["out"], ref):
        np.testing.assert_array_equal(a, b)
    assert [x["stats"]["picard"] for x in r] == [r[0]["stats"]["picard"]] * 2
    assert r[0]["stats"]["picard"] >= 2
    assert all(not x["stats"]["launches"] for x in r)
