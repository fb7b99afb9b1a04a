"""The frozen roofline counts against the program's own at the time the
benchmark was defined (chip_smoke.py's gx1 figures: K1 6.98 GFLOP a
solve, K2 189.7 MB a pass at NT 25) and the tracer counts of the two
configurations."""

import json

import pytest

from icebench import catalog, yardstick


def test_k1_counts_at_gx1():
    nbytes, flops = yardstick.k1_bytes_flops(384, 320, 120)
    assert round(flops / 1e9, 2) == 6.98
    assert yardstick.bound_ms(nbytes, flops) == pytest.approx(
        flops / 67e12 * 1e3)


def test_k2_counts_at_gx1():
    nbytes, flops = yardstick.k2_bytes_flops(25, 5, 384, 320)
    assert round(nbytes / 1e6, 1) == 189.7
    assert yardstick.bound_ms(nbytes, flops) == pytest.approx(
        nbytes / 3.35e12 * 1e3)


def test_frozen_counts_equal_the_programs():
    from cice_tpu_torch.kernels import evp as kevp
    from cice_tpu_torch.kernels import remap as kremap
    from icebench.reference.ice.config import Config
    from icebench.reference.ice.dynamics.remap_exact import build_flat_table
    from icebench.reference.ice.model.state import tracer_registry
    assert yardstick.k1_bytes_flops(384, 320, 120) == \
        kevp.bound_bytes_flops(384, 320, 120)
    table = build_flat_table(tracer_registry(Config()))
    nb, _ = kremap.bound_bytes_flops(table, 5, 384, 320)
    assert yardstick.k2_bytes_flops(len(table), 5, 384, 320)[0] == nb
    # the least operations are at most what any state's moments give
    _, least = kremap.bound_bytes_flops(table, 5, 384, 320, 0.0, 0.0)
    assert yardstick.k2_bytes_flops(len(table), 5, 384, 320)[1] <= least


@pytest.mark.parametrize("name,nt", [("om025", 25)])
def test_tracer_counts(name, nt):
    from icebench.reference.ice.config import Config
    from icebench.reference.ice.dynamics.remap_exact import build_flat_table
    from icebench.reference.ice.model.state import tracer_registry
    run = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in catalog.config(name)["run"].items()
           if "{" not in json.dumps(v)}
    cfg = Config().with_overrides(**run)
    assert len(build_flat_table(tracer_registry(cfg))) == nt
