"""``chip_smoke.traced``'s rule for a whole trace, on the CPU.

On the card the profiler drops the earliest device records of a trace in a
process that has run for minutes (``chip_trace_probe.py``). ``traced``
fences the call with device spins and takes the trace again behind a longer
fence until a spin precedes the call's first record and another follows
its last. Here a fake profiler drops a given number of the earliest records
of each trace.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import sys
from pathlib import Path
from types import SimpleNamespace

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
    assert spins == chip_smoke.FENCE_SPINS[1] and len(calls) == 2
