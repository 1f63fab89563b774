#!/usr/bin/env python3
"""What ``tpu.remat`` does to the 02 and 04 steps' gradients and memory, on
one NVIDIA GPU.

    python3 chip_remat_probe.py

Two parts, on ``chip_smoke.py``'s synthetic fixtures and experiments at full
width with random weights from the seed:

- ``remat_floor``: one CATER 02 step (SAVi, B=64, T=8) and one CATER 04 step
  (TextOCVP_T5 through that SAVi after one epoch of the 02 CLI, B=64, c=1,
  p=9) on one batch and one noise draw, each backward twice without and
  twice with remat: the largest gradient difference over the largest leaf,
  and the leaf it is in, between the two plain runs, the two remat runs and
  each remat and plain pair; the card's run-to-run floor beside what remat
  changes.
- ``clip_memory``: one CLIPort 02 microbatch of 8 episodes (``accum_steps``
  8), without and with remat: the GB allocated before it, the forward's
  peak, the GB the forward keeps for the backward and the backward's peak;
  for the plain forward also a CUDA memory history
  (``torch.cuda.memory._record_memory_history``): the allocations live at
  its peak, summed by the line of ``textocvp_tpu_torch`` that made them, the
  largest first.

Prints the card's name and power limit first, then one JSON line a part.
Exits 2 without a CUDA device.
"""

from __future__ import annotations

import gc
import json
import sys
import tempfile
from collections import Counter
from pathlib import Path

import torch

import chip_smoke as cs

MICROBATCH = cs.CLIP_TRAIN_BATCH // cs.CLIP_ACCUM


def with_remat(path: Path, knob: bool) -> Path:
    from textocvp_tpu_torch.core.experiment import Experiment

    exp = Experiment(path)
    params = exp.params
    params["tpu"] = {"remat": knob}
    exp.save_params(params)
    return path


def grads_of(trainer, videos, noise, text) -> dict:
    trainer.optimizer.zero_grad()
    trainer.backward(videos, noise, **text)
    return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
            if p.grad is not None}


def remat_floor(tmp: Path) -> dict:
    from textocvp_tpu_torch.cli import train_decomp
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    data_root = cs.write_cater_fixture(tmp / "CATER_train", (("train", cs.TRAIN_BATCH),
                                                             ("test", cs.TRAIN_BATCH)))
    train_exp = cs.train_experiment(tmp / "train", data_root)
    cs.run_cli(train_decomp.main, ["-d", str(train_exp)])
    decomp = cs.train_experiment(tmp / "remat_02", data_root)
    out = {}
    for step in ("02", "04"):
        grads = {}
        for knob in (False, True):
            if step == "02":
                tr = DecompTrainer(with_remat(decomp, knob))
            else:
                tr = PredictorTrainer(with_remat(cs.pred_experiment(train_exp, f"remat_{knob}"),
                                                 knob), "checkpoint_epoch_final")
            tr.setup_model()
            tr.load_data()
            videos, info = next(iter(tr.train_loader))
            if step == "04":
                videos, text = tr.batch_to_device(videos, info)
            else:
                videos, text = tr.to_device(videos), {}
            noise = tr._noise(videos.shape[0], torch.Generator().manual_seed(cs.SEED + 6))
            for rep in range(2):
                grads[knob, rep] = grads_of(tr, videos, noise, text)
            del tr, videos, noise, text
            gc.collect()
            torch.cuda.empty_cache()
        top = max(g.abs().max().item() for g in grads[False, 0].values())

        def rel(a, b):
            diff, leaf = max(((a[n] - b[n]).abs().max().item(), n) for n in a)
            return {"diff_over_max": diff / top, "leaf": leaf}

        out[step] = {"plain_vs_plain": rel(grads[False, 0], grads[False, 1]),
                     "remat_vs_remat": rel(grads[True, 0], grads[True, 1]),
                     "remat_vs_plain": [rel(grads[True, r], grads[False, q])
                                        for r in range(2) for q in range(2)]}
    return out


def live_at_peak(snapshot, top=8) -> dict:
    """The allocations live at the peak of a memory history, in GB, summed
    by the first ``textocvp_tpu_torch`` line of their stacks."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for event in snapshot["device_traces"][0]:
        if event["action"] == "alloc":
            live[event["addr"]] = event
            cur += event["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif event["action"] == "free_completed" and event["addr"] in live:
            cur -= live.pop(event["addr"])["size"]
    by_line, largest = Counter(), Counter()
    for event in at_peak.values():
        frames = [f for f in event.get("frames", []) if "textocvp_tpu_torch" in f["filename"]]
        where = (f"{frames[0]['filename'].split('textocvp_tpu_torch/')[-1]}:{frames[0]['line']}"
                 if frames else "outside the port")
        by_line[where] += event["size"] / 2**30
        largest[where] = max(largest[where], event["size"] / 2**30)
    return {"peak_gb": peak / 2**30,
            "by_line": [{"line": k, "gb": v, "largest_gb": largest[k]}
                        for k, v in by_line.most_common(top)]}


def clip_memory(tmp: Path) -> dict:
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    data_root = cs.write_cliport_fixture(tmp / "CLIPort")
    out = {}
    for knob in (False, True):
        tr = DecompTrainer(with_remat(cs.clip_experiment(tmp / f"clip_{knob}", data_root), knob))
        tr.setup_model()
        tr.load_data()
        batch = tr.to_device(next(iter(tr.train_loader))[0][:MICROBATCH])
        noise = tr._noise(MICROBATCH, torch.Generator().manual_seed(cs.SEED + 6))
        tr.forward_loss(batch, noise)[0].backward()  # warm up
        tr.optimizer.zero_grad()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if not knob:
            torch.cuda.memory._record_memory_history(max_entries=400000, stacks="python")
        loss = tr.forward_loss(batch, noise)[0]
        torch.cuda.synchronize()
        row = {"before_gb": before / 2**30,
               "forward_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
               "kept_after_forward_gb": (torch.cuda.memory_allocated() - before) / 2**30}
        if not knob:
            row["forward_history"] = live_at_peak(torch.cuda.memory._snapshot())
            torch.cuda.memory._record_memory_history(enabled=None)
        torch.cuda.reset_peak_memory_stats()
        loss.backward()
        torch.cuda.synchronize()
        row["backward_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out["remat" if knob else "plain"] = row
        del tr, batch, noise, loss
        gc.collect()
        torch.cuda.empty_cache()
    return {"microbatch": MICROBATCH, **out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_remat_probe: torch.cuda.is_available() is false; this script needs a CUDA "
              "device", file=sys.stderr)
        return 2
    cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_remat_probe_") as tmp:
        print(json.dumps({"part": "remat_floor", **remat_floor(Path(tmp) / "floor")}),
              flush=True)
        print(json.dumps({"part": "clip_memory", **clip_memory(Path(tmp) / "clip")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
