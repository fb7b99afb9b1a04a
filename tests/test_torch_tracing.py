"""The port's tracing (cice_tpu_torch/utils/timers.py `span`, `sync_counts`;
core/reductions.py `host_read`, `host_wait`): every blocking read a step
makes is counted at a named site, a profiled step computes the same bits
as one that is not, and no profiler range is built while none runs.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.measure import count_host_reads  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.utils import timers as ttimers  # noqa: E402

DIAG = {"setup.diagfreq": 1, "setup.conserv_check": True}


def _syncs_of(fn):
    """({site: reads}, conversions counted from outside) of `fn()`."""
    before = ttimers.sync_counts()
    n = count_host_reads(fn)
    after = ttimers.sync_counts()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}, n


@pytest.mark.parametrize("over", [{}, DIAG], ids=["plain", "diagnostic"])
def test_every_host_read_of_a_step_has_a_site(over):
    m = Model(tconfig.gx1pop_step(48, 40).with_overrides(**over),
              device="cpu")
    sites, n = _syncs_of(m.step)
    assert sum(sites.values()) == n
    assert {"picard", "rebin", "ridge"} <= set(sites)
    assert sites["rebin"] == 24
    assert ("diag" in sites) == bool(over)
    assert "step_end" not in sites          # counted on a CUDA device only
    assert "syncs" in m.timers.print_all()


def _two_steps(profiled):
    m = Model(tconfig.gx1pop_step(24, 20), device="cpu")
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
        if profiled else contextlib.nullcontext())
    with prof:
        m.run(2)
    return m.state


def test_profiling_leaves_the_state_bit_for_bit():
    plain, traced = _two_steps(False), _two_steps(True)
    for name, a in plain.__dict__.items():
        b = traced.__dict__[name]
        pairs = ([(a[k], b[k]) for k in a] if isinstance(a, dict)
                 else [(a, b)])
        for x, y in pairs:
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name


def test_no_range_is_built_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    m = Model(tconfig.gx1pop_step(12, 10), device="cpu")
    m.step()
    assert ttimers.span("ice:x") is ttimers.span("sync:y")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function built"):
            m.step()
