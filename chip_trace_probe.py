#!/usr/bin/env python3
"""Which ViT-attention kernels a ``torch.profiler`` trace of the CLIPort eval
step holds, on one NVIDIA GPU.

    python3 chip_trace_probe.py [--reps 8]

Sets up ``chip_smoke.py``'s CLIPort eval step: ExtendedDINOSAUR + TextOCVP_T5
at full width with random weights from the seed, B=16, 1 seed frame, 9
predictions, over 16 synthetic color-cache episodes (``write_cliport_fixture``).
Every ViT-attention call of the step goes through a hook that counts it and
records a CUDA event pair around it. Then ``eval_step`` runs under
``torch.profiler`` ``--reps`` times in each of these settings:

- ``smoke``: host and device activities, one device spin of about 12 ms
  and a synchronize first (``chip_smoke.fence(1)``);
- ``device_only``: device activities only;
- ``sync_each``: as ``smoke``, with a synchronize after every ViT-attention
  launch;
- ``two_steps``: as ``smoke``, two eval steps in one trace;
- ``vit_only``: as ``smoke``, the ViT encode of the 16 seed frames alone;
- ``long_prologue``: as ``smoke``, with ten times the device spin before
  the step.

For each trace it prints one JSON line: the launches the hook counted, the
ViT-attention device records among kineto's raw events
(``prof.profiler.kineto_results.events()``) and in ``key_averages``, the
device kernels of the trace before the first ViT-attention record, between
each two, and after the last (in a complete trace the gaps between records
are equal: one ViT block's kernels), each record's start on the trace's
clock, and each launch's device time from its CUDA events; and the first
device records of the trace, the spins before the step included, with
their start on the trace's clock. Prints the card's name and power limit
first. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs

VIT_KERNEL = cs.VIT_ATTENTION_KERNEL
SETTINGS = ("smoke", "device_only", "sync_each", "two_steps", "vit_only", "long_prologue")
LONG_PROLOGUE_SPINS = 10  # the prologue's device spin 10 times over, about 125 ms


class Hook:
    """Wraps ``nn.vit.vit_attention``: counts the calls, brackets each with a
    CUDA event pair, and synchronizes after each when ``sync`` is set."""

    def __init__(self, fn):
        self.fn, self.sync, self.events = fn, False, []

    def __call__(self, q, k, v, scale):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(q, k, v, scale)
        end.record()
        self.events.append((start, end))
        if self.sync:
            torch.cuda.synchronize()
        return out


def raw_device_records(prof):
    """(name, start_ns, duration_ns) of every device record kineto kept, in
    start order."""
    from torch.autograd import DeviceType

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    recs = [(e.name(), e.start_ns() - t0, e.duration_ns()) for e in result.events()
            if e.device_type() == DeviceType.CUDA]
    return sorted(recs, key=lambda r: r[1])


def trace(step, hook, setting, sync=False, devices_only=False, spins=1):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hook.events.clear()
    hook.sync = sync
    activities = [ProfilerActivity.CUDA] if devices_only else [ProfilerActivity.CPU,
                                                               ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        cs.fence(spins)
        step()
        torch.cuda.synchronize()
    hook.sync = False
    every = raw_device_records(prof)
    recs = [r for r in every if cs.FENCE_KERNEL not in r[0]]
    where = [i for i, r in enumerate(recs) if VIT_KERNEL in r[0]]
    gaps = [b - a - 1 for a, b in zip([-1] + where, where + [len(recs)])]
    averaged = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and VIT_KERNEL in e.key)
    event_ms = [s.elapsed_time(e) for s, e in hook.events]
    first = hook.events[0][0] if hook.events else None
    return {"setting": setting, "launched": len(hook.events), "raw_records": len(where),
            "key_averages": averaged, "device_records": len(recs), "gaps": gaps,
            "record_start_us": [recs[i][1] / 1e3 for i in where],
            "record_us": [recs[i][2] / 1e3 for i in where],
            "launch_event_ms": event_ms,
            "launch_start_ms_after_first": [first.elapsed_time(s) for s, _ in hook.events]
            if first else [],
            "prologue_records": sum(cs.FENCE_KERNEL in r[0] for r in every),
            "first_records": [(name[:40], start / 1e3, dur / 1e3) for name, start, dur in every[:18]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=8, help="traces a setting")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_trace_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    from textocvp_tpu_torch.nn import vit
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = cs.PATHS[1]
    params, pred_params = cs.full_width_params(path)
    with tempfile.TemporaryDirectory(prefix="chip_trace_probe_") as tmp:
        cs.CLIP_EPISODES = (("test", cs.CLIP_EVAL_BATCH),)
        data_root = cs.write_cliport_fixture(Path(tmp) / "CLIPort")
        for p in (params, pred_params):
            p["dataset"]["root"] = str(data_root)
        exp_path = cs.write_experiment(Path(tmp), params, pred_params)
        ev = PredictorEvaluator(exp_path, cs.PRED_NAME, "random", "random", num_seed=1,
                                num_preds=path.num_preds, batch_size=cs.CLIP_EVAL_BATCH)
        ev.load_data()
        ev.load_models()
        videos, info = next(iter(ev.test_loader))
        hook = Hook(vit.vit_attention)
        vit.vit_attention = hook
        ev.eval_step(videos, info)
        torch.cuda.synchronize()
        v, _ = ev.to_device(videos, info)

        def encode():
            with torch.inference_mode():
                ev.model.decompose(v[:, :1], generator=ev.generator)

        steps = {"smoke": lambda: ev.eval_step(videos, info),
                 "long_prologue": lambda: ev.eval_step(videos, info),
                 "device_only": lambda: ev.eval_step(videos, info),
                 "sync_each": lambda: ev.eval_step(videos, info),
                 "two_steps": lambda: (ev.eval_step(videos, info), ev.eval_step(videos, info)),
                 "vit_only": encode}
        for _ in range(args.reps):
            for setting in SETTINGS:
                t = time.perf_counter()
                row = trace(steps[setting], hook, setting, sync=setting == "sync_each",
                            devices_only=setting == "device_only",
                            spins=LONG_PROLOGUE_SPINS if setting == "long_prologue" else 1)
                row["seconds"] = time.perf_counter() - t
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
