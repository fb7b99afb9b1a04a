"""The port against the benchmark's frozen reference of the z-tracer
configuration (`icebench/reference/gx1bgcz`, a plain-PyTorch copy that
imports nothing of the port): three float32 `Model.step`s of
gx1pop,evp1d,bgcz (NT 266) under the seeded NCAR monthly forcing, from
the seeded initial state at 24x20 on the CPU, held against the reference
stepped in float32 and float64 by the benchmark's comparison
(`icebench/reference/compare.leaf_gaps`: each leaf's distance to the
float64 reference in units of the float32 reference's own distance).

Every leaf must read at most 1.5: the port's plain path reads 1.0 against
its own frozen copy (the same operations in the same order give the same
bits), so 1.5 leaves room for nothing but a last-bit difference in a
leaf whose float32 envelope is at its floor."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from icebench import catalog, harness  # noqa: E402
from icebench import inputs as inp  # noqa: E402
from icebench.inputs import seeded_caps  # noqa: E402
from icebench.leaves import fill, leaves  # noqa: E402
from icebench.reference.compare import leaf_gaps  # noqa: E402

SIZE = (24, 20)
STEPS = 3
LIMIT = 1.5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gx1bgcz")
    os.environ.setdefault("CICE_TPU_TORCH_FIXTURES", str(tmp / "fixtures"))
    config = harness._shrunk(catalog.config("gx1bgcz"), SIZE)
    made = inp.make_all(config["inputs"], 2 ** 32 + 21, str(tmp / "cache"),
                        str(tmp))
    run = inp.resolve({**config["run"], **catalog.traffic("hourly")["run"]},
                      made)
    ref_cls = catalog.reference(config)
    refs = {d: ref_cls(run, "cpu", d) for d in ("float32", "float64")}
    s0 = leaves(seeded_caps.make_state(refs["float32"],
                                       config["initial_state"], 7))

    from cice_tpu_torch.config import Config
    from cice_tpu_torch.model.driver import Model
    cfg = Config().with_overrides(**{
        **run, "setup.history_dir": str(tmp / "history") + "/"})
    model = Model(cfg, device="cpu")
    model.state = fill(model.state, s0)
    for _ in range(STEPS):
        model.step()
    out = {"program": leaves(model.state), "nt": refs["float32"]
           .tracer_count()}
    for d, ref in refs.items():
        st, cal = fill(ref.zeros(), s0), ref.calendar(0)
        for _ in range(STEPS):
            st, cal = ref.step(st, cal)
        out[d] = leaves(st)
    for ds in model.datasets.values():
        ds.close()
    return out


def test_the_configuration_carries_every_z_tracer(runs):
    assert runs["nt"] == 266
    assert set(runs["program"]) == set(runs["float64"])
    assert sum(k.startswith("trcrn.bgc_") for k in runs["program"]) == 48


def test_port_steps_within_the_reference_envelope(runs):
    gaps = leaf_gaps(runs["program"], runs["float32"], runs["float64"])
    bad = {k: v for k, v in gaps.items() if not v <= LIMIT}
    assert not bad, bad
    moved = [k for k in ("trcrn.bgc_Nit", "trcrn.bgc_N", "trcrn.fbri")
             if not torch.equal(runs["program"][k], runs["float64"][k])]
    assert moved          # the float32 program is not the float64 reference
