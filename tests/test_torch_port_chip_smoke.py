"""``chip_smoke.traced``'s rule for a whole trace, on the CPU.

On the card the profiler drops the earliest device records of a trace in a
process that has run for minutes (``chip_trace_probe.py``). ``traced``
fences the call with device spins and takes the trace again, behind a longer
fence where the first fence's records are gone and behind the same one where
only the last fence's are, until a spin precedes the call's first record and
another follows its last, and starts each later trace behind the fence the
last whole one needed. Here a fake profiler drops a given number of the earliest records
of each trace. ``chip_smoke.device_records`` reads a trace's device events
by name as ``prof.key_averages()`` groups them, straight from the kineto
events: held to ``key_averages`` on a real CPU trace, its host events
standing in for the device's, and timed against it.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import sys
from pathlib import Path
from types import SimpleNamespace

import time

import pytest
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


@pytest.fixture
def fake_profiler(monkeypatch):
    """Returns (calls, set_drops): ``calls`` counts the traced function's
    runs; ``set_drops(seq)`` makes the i-th trace drop its first seq[i]
    device records."""
    timeline, drops, calls = [], [], []

    class Profile:
        def __init__(self, activities):
            self.activities = activities

        def __enter__(self):
            timeline.clear()
            return self

        def __exit__(self, *exc):
            kept = timeline[drops.pop(0):]
            events = [SimpleNamespace(start_ns=lambda i=i: 1000 * i, name=lambda n=n: n,
                                      device_type=lambda: DeviceType.CUDA)
                      for i, n in enumerate(kept)][::-1]  # order must come from start_ns
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(chip_smoke, "FENCE_FIRST", [0])  # a young process
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: timeline.append(
        "at::cuda::(anonymous namespace)::spin_kernel(long)"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def fn():
        calls.append(1)
        timeline.extend(["attention_kernel", "gemm"])

    return fn, calls, drops


def test_a_trace_that_kept_a_spin_before_the_call_counts(fake_profiler):
    fn, calls, drops = fake_profiler
    drops.extend([chip_smoke.FENCE_SPINS[0] - 1])
    _, _, spins = chip_smoke.traced(fn)
    assert spins == chip_smoke.FENCE_SPINS[0] and len(calls) == 1


@pytest.mark.parametrize("dropped", ["fence", "fence_and_call"])
def test_a_trace_that_lost_its_first_fence_is_taken_again_behind_a_longer_one(
        fake_profiler, dropped):
    fn, calls, drops = fake_profiler
    first = chip_smoke.FENCE_SPINS[0]
    # the whole first fence, or it and the call's records: then only the last
    # fence's spin is left, which must not pass for a whole trace
    drops.extend([first + (2 if dropped == "fence_and_call" else 0), 0])
    _, _, spins = chip_smoke.traced(fn)
    assert spins == chip_smoke.FENCE_SPINS[1] and len(calls) == 2


def test_no_whole_trace_behind_the_longest_fence_fails(fake_profiler):
    fn, calls, drops = fake_profiler
    drops.extend(s + 2 for s in chip_smoke.FENCE_SPINS)
    with pytest.raises(AssertionError, match="no whole trace"):
        chip_smoke.traced(fn)
    assert len(calls) == len(chip_smoke.FENCE_SPINS)


def test_a_trace_that_lost_its_last_fence_is_taken_again(fake_profiler, monkeypatch):
    fn, calls, drops = fake_profiler
    drops.extend([0, 0])
    spins_seen = []
    real_fence = chip_smoke.fence

    def fence(spins=1):
        spins_seen.append(spins)
        # the first trace's closing fence leaves no record
        if len(spins_seen) != 2:
            real_fence(spins)
    monkeypatch.setattr(chip_smoke, "fence", fence)
    _, _, spins = chip_smoke.traced(fn)
    # behind the same fence: a longer first one does not bring back an end
    assert spins == chip_smoke.FENCE_SPINS[0] and len(calls) == 2
    assert chip_smoke.FENCE_FIRST == [0]  # and later traces start there


def test_a_trace_that_keeps_losing_its_end_fails_after_as_many_attempts(fake_profiler,
                                                                      monkeypatch):
    fn, calls, drops = fake_profiler
    drops.extend([0] * len(chip_smoke.FENCE_SPINS))
    real_fence = chip_smoke.fence
    # every closing fence (one spin) leaves no record
    monkeypatch.setattr(chip_smoke, "fence", lambda spins=1: spins > 1 and real_fence(spins))
    with pytest.raises(AssertionError, match="no whole trace"):
        chip_smoke.traced(fn)
    assert len(calls) == len(chip_smoke.FENCE_SPINS)


def test_a_later_trace_starts_behind_the_fence_the_last_whole_one_needed(fake_profiler):
    fn, calls, drops = fake_profiler
    first = chip_smoke.FENCE_SPINS[0]
    drops.extend([first + 2, 0])  # the first trace needs the second fence
    assert chip_smoke.traced(fn)[2] == chip_smoke.FENCE_SPINS[1] and len(calls) == 2
    drops.extend([0])  # the next one starts there: one call, no failed attempt
    assert chip_smoke.traced(fn)[2] == chip_smoke.FENCE_SPINS[1] and len(calls) == 3
    # and still goes on to a longer fence where that one is not enough
    drops.extend([chip_smoke.FENCE_SPINS[1] + 2, 0])
    assert chip_smoke.traced(fn)[2] == chip_smoke.FENCE_SPINS[2] and len(calls) == 5


def test_device_records_group_a_trace_as_key_averages_does(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3000):
            x.add_(1)
            x.mul_(1)
    # the trace's host events stand in for a device's
    monkeypatch.setattr(torch.autograd, "DeviceType", SimpleNamespace(CUDA=DeviceType.CPU))
    t = time.perf_counter()
    got = {r.key: (r.count, r.self_device_time_total) for r in chip_smoke.device_records(prof)}
    read_s = time.perf_counter() - t
    monkeypatch.undo()
    t = time.perf_counter()
    want = {e.key: (e.count, e.cpu_time_total) for e in prof.key_averages()}
    averages_s = time.perf_counter() - t
    assert got.keys() == want.keys() and {"aten::add_", "aten::mul_"} <= set(got)
    for key, (count, us) in want.items():
        assert got[key][0] == count and got[key][1] == pytest.approx(us, rel=1e-6, abs=1e-3)
    assert read_s < averages_s
