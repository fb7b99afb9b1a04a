"""The reference against itself and against the program at a small grid
on the CPU, and the comparison's arithmetic."""

import math

import pytest
import torch

from icebench import catalog, harness
from icebench import inputs as inp
from icebench.inputs import seeded_caps
from icebench.leaves import fill, leaves
from icebench.reference.compare import leaf_gaps, worst

ReferenceModel = catalog.reference(catalog.config("om025"))


def _run(tmp_path, name, nx=24, ny=20):
    config = harness._shrunk(catalog.config(name), (nx, ny))
    made = inp.make_all(config["inputs"], 3, str(tmp_path / "cache"),
                        str(tmp_path))
    return config, inp.resolve({**config["run"],
                                **catalog.traffic("hourly")["run"]}, made)


def _steps(ref, st, n):
    cal = ref.calendar(0)
    for _ in range(n):
        st, cal = ref.step(st, cal)
    return leaves(st)


@pytest.mark.parametrize("name", ["om025"])
def test_reference_repeats_itself(tmp_path, name):
    config, run = _run(tmp_path, name)
    ref = ReferenceModel(run, "cpu", "float32")
    s0 = seeded_caps.make_state(ref, config["initial_state"], 9)
    a = _steps(ref, s0, 2)
    b = _steps(ReferenceModel(run, "cpu", "float32"), s0, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(bool(torch.isfinite(v.double()).all()) for v in a.values())
    assert not torch.equal(a["vicen"], leaves(s0)["vicen"])


def test_program_equals_the_float32_reference_on_the_cpu(tmp_path):
    """The frozen copy is the program's plain path: on the CPU (no
    kernels) the two give the same bits."""
    from icebench.system import Program
    config, run = _run(tmp_path, "om025")
    ref = ReferenceModel(run, "cpu", "float32")
    s0 = seeded_caps.make_state(ref, config["initial_state"], 9)
    p = Program({**run, "setup.history_dir": str(tmp_path / "h") + "/"},
                "cpu", True, leaves(s0))
    for _ in range(2):
        p.step()
    got = p.leaves()
    want = _steps(ref, s0, 2)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("override", [
    {"thermo.ktherm": 2}, {"shortwave.shortwave": "dEdd"},
    {"dynamics.kdyn": 3}, {"grid.grid_ice": "C"},
    {"tracers.tr_brine": True, "zbgc.z_tracers": True},
    {"forcing.atm_data_type": "ncar"}])
def test_reference_refuses_what_it_does_not_carry(tmp_path, override):
    _, run = _run(tmp_path, "om025")
    with pytest.raises(ValueError, match="the reference carries only"):
        ReferenceModel({**run, **override}, "cpu", "float32")


def test_gaps_in_envelope_units():
    r64 = {"a": torch.tensor([1.0, 2.0], dtype=torch.float64),
           "z": torch.zeros(2, dtype=torch.float64)}
    r32 = {"a": torch.tensor([1.0, 2.001]), "z": torch.zeros(2)}
    p = {"a": torch.tensor([1.0, 2.003]), "z": torch.zeros(2)}
    g = leaf_gaps(p, r32, r64)
    assert g["a"] == pytest.approx(3.0, rel=1e-3)
    assert g["z"] == 0.0
    assert worst(g)[1] == "a"
    assert leaf_gaps({"a": p["a"]}, r32, r64)["z"] == math.inf
    nan = {"a": torch.tensor([float("nan"), 2.0]), "z": torch.zeros(2)}
    assert leaf_gaps(nan, r32, r64)["a"] == math.inf
    # a leaf that float32 gives exactly: the floor of 2**-24 of its norm
    same = {"a": r64["a"].float(), "z": torch.zeros(2)}
    g = leaf_gaps({"a": torch.tensor([1.0, 2.0 + 2 ** -21]),
                   "z": torch.zeros(2)}, same, r64)
    assert 1.0 < g["a"] < 10.0


@pytest.mark.parametrize("bad", [math.inf, -math.inf, math.nan])
@pytest.mark.parametrize("side", ["float32", "float64"])
def test_a_reference_that_is_not_finite_reads_inf(side, bad):
    """A non-finite reference judges nothing: in r32 it would widen the
    envelope to inf and read a program off by half as 0."""
    r64 = {"a": torch.tensor([1.0, 2.0], dtype=torch.float64),
           "b": torch.tensor([3.0, 4.0], dtype=torch.float64)}
    r32 = {k: v.float() for k, v in r64.items()}
    p = {"a": torch.tensor([1.5, 3.0]), "b": r32["b"].clone()}
    (r32 if side == "float32" else r64)["a"][1] = bad
    g = leaf_gaps(p, r32, r64)
    assert g["a"] == math.inf
    assert g["b"] == 0.0
    assert worst(g) == (math.inf, "a")


def test_check_names_the_reference_at_fault():
    """`check.gaps` logs a leaf that reads inf for its float32 reference
    as the reference's fault, naming the leaf and the precision."""
    import dataclasses
    from icebench import check

    @dataclasses.dataclass
    class S:
        a: torch.Tensor

    class Ref:      # float64 steps to [1, 2]; float32 to [1, inf]
        def __init__(self, run, device, dtype):
            self.dtype = getattr(torch, dtype)

        def zeros(self):
            return S(torch.zeros(2, dtype=self.dtype))

        def calendar(self, n=0):
            return n

        def step(self, st, cal):
            a = [1.0, math.inf if self.dtype == torch.float32 else 2.0]
            return S(torch.tensor(a, dtype=self.dtype)), cal + 1

    p = {"a": torch.tensor([1.0, 2.0])}
    said = []
    out = check.gaps(Ref, {}, "cpu", p, 1, p, p, 5, p, log=said.append)
    assert out == {"start_gap": (math.inf, "a"),
                   "window_gap": (math.inf, "a")}
    assert len(said) == 2
    for line in said:
        assert "leaf a" in line and "the reference's fault" in line
        assert "float32 reference holds 1 non-finite" in line
        assert "float64" not in line


def test_a_configuration_must_name_a_reference_that_is_there():
    cfg = catalog.config("om025")
    assert catalog.reference(cfg) is ReferenceModel
    no_key = {k: v for k, v in cfg.items() if k != "reference"}
    with pytest.raises(ValueError, match="'om025' names no reference"):
        catalog.reference(no_key)
    for name in ("absent", "../ice", "ice/model"):
        with pytest.raises(ValueError, match=f"'om025' names the "
                           f"reference '{name}'"):
            catalog.reference({**cfg, "reference": name})


def test_fill_keeps_dtype_and_copies():
    from icebench.reference.ice.model.state import State
    import dataclasses
    z = {f.name: torch.zeros(2) for f in dataclasses.fields(State)
         if f.name != "trcrn"}
    st = State(trcrn={"qice": torch.zeros(2)}, **z)
    named = {k: torch.ones(2, dtype=torch.float64) for k in leaves(st)}
    out = fill(st, named)
    assert out.aicen.dtype == torch.float32
    named["aicen"][0] = 5.0
    assert float(out.aicen[0]) == 1.0
