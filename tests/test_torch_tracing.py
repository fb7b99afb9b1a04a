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


class _NestingTimer:
    """A `model_step` timer that records, for each phase, the phases open
    around it and the host reads counted while it ran."""

    def __init__(self):
        self.open, self.seen = [], []

    @contextlib.contextmanager
    def __call__(self, name):
        before = ttimers.sync_counts()
        self.open.append(name)
        try:
            yield
        finally:
            self.open.pop()
            after = ttimers.sync_counts()
            reads = {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)}
            self.seen.append((name, tuple(self.open), reads))


@pytest.mark.parametrize("opts", ["bgcz", "none"])
def test_z_tracers_run_in_a_phase_of_their_own(opts):
    """Under z_tracers the brine height and the z tracers run in the phase
    'zbgc' inside 'therm1' (and the profiler's range "ice:zbgc" inside
    "ice:therm1"), which reads the host nowhere; without z tracers no
    such phase opens and the step's host reads are what they were."""
    from cice_tpu_torch.cli.main import OPTION_SETS
    over = OPTION_SETS["bgcz"] if opts == "bgcz" else {}
    m = Model(tconfig.gx1pop_step(12, 10).with_overrides(**over),
              device="cpu")
    timer = _NestingTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sites, n = _syncs_of(lambda: m.step(timer=timer))
    assert sum(sites.values()) == n
    assert sites["rebin"] == 24 and "picard" in sites
    zb = [(outer, reads) for name, outer, reads in timer.seen
          if name == "zbgc"]
    ranges = {e.name: e for e in prof.events()
              if e.name in ("ice:therm1", "ice:zbgc")}
    if opts == "none":
        assert not zb and "ice:zbgc" not in ranges
        return
    assert zb == [(("therm1",), {})]
    t1, z = ranges["ice:therm1"].time_range, ranges["ice:zbgc"].time_range
    assert t1.start <= z.start and z.end <= t1.end
