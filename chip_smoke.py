#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``textocvp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at the full width of CATER SAVi +
TextOCVP_T5 (8 slots x 128, T5-small, 8 predictor layers, 64x64 frames,
19 predicted frames) with random weights drawn from a seed, and checks it.
Phases, one JSON line each:

1. device   the card's name and power limit (``nvidia-smi``);
2. build    compile the CUDA slot-attention kernel from ``csrc/``;
3. kernels  the kernel against its plain PyTorch version at N=4096, D=128,
            S=8, MLP 256, B in (8, 64), 1 and 3 iterations: max abs error,
            time from CUDA events, the plain version's time, the bound;
4. parity   the predict stage (seed encode + 19-step rollout) on the card and
            on the CPU at B=2 with the same weights and initial slots, TF32
            off, each step's error held to that step's largest slot; and
            the decode of two frames on both;
5. service  a ``PredictionService`` (batch 8, 24 tokens) over a temporary
            experiment of ``.pt`` checkpoints: warmup, three requests (8 rows
            float32, 3 rows uint8, 8 rows), five more 8-row requests for the
            steady time, and one request split into its two stages;
6. http     ``/healthz``, one ``/predict`` and ``/stats`` on 127.0.0.1;
7. profile  one more request under ``torch.profiler``: device busy time
            against wall time, the kernels that take the most time, and the
            slot-attention kernel's attend and update launches.

Phases 5 and 6 are the main path: the kernel launch counter is set to 0
before them and read after. Then one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and the last line is not printed. Without a CUDA device the script
exits 2 before doing anything.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SEED = 14
N, D, S, MLP_HIDDEN = 4096, 128, 8, 256
NUM_PREDS, BATCH, MAX_TOKENS = 19, 8, 24
PRED_OUT_SCALE = 0.02
ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
CAPTIONS = ["the cone is sliding to (1, -2)", "the snitch is picked up and placed to (3, 3)",
            "the cone is rotating", "the snitch is containing the cone",
            "the cone is picked up and placed to (-1, 1)", "the snitch is sliding to (2, 2)",
            "the cone is sliding to (-3, -3)", "the snitch is rotating and sliding"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


def phase_build(sak):
    t = time.perf_counter()
    sak.load_library()
    seconds = time.perf_counter() - t
    emit({"phase": "build", "seconds": seconds, "source": str(sak.SOURCE.relative_to(ROOT))})


def slot_attention_bound_ms(b, n, d, s, h, iters):
    """Least time on the card: K and V read once, slots in and out, attn out,
    weights read once; operations of every iteration at the float32 rate."""
    weights = 3 * d + d * d + 2 * (3 * d * d + 3 * d) + 2 * d + h * d + h + d * h + d
    nbytes = 4 * (2 * b * n * d + 2 * b * s * d + b * s * n + weights)
    per_iter = (4 * b * s * n * d + 8 * b * s * n                       # q.k, a.v, softmax
                + 2 * b * s * (d * d + 6 * d * d + 2 * d * h) + 20 * b * s * d)  # q, GRU, MLP
    flops = iters * per_iter
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(sak):
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.ops.slot_attention import SlotAttention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    mod = random_init_(SlotAttention(D, D, S, MLP_HIDDEN), gen).cuda()
    params = {k: p.detach() for k, p in mod.iteration_params().items()}
    scale = D ** -0.5
    rows = []
    for b in (8, 64):
        k = torch.randn((b, N, D), generator=gen).cuda()
        v = torch.randn((b, N, D), generator=gen).cuda()
        slots = torch.randn((b, S, D), generator=gen).cuda()
        for iters in (1, 3):
            launches = sak.slot_attention_cuda.launches
            out, attn = sak.slot_attention_cuda(k, v, slots, params, iters, scale)
            ref, ref_attn = sak.slot_attention_plain(k, v, slots, params, iters, scale)
            torch.cuda.synchronize()
            err_slots = (out - ref).abs().max().item()
            err_attn = (attn - ref_attn).abs().max().item()
            check(bool(torch.isfinite(out).all()), "kernel slots not finite")
            # float32 on both sides, sums in other orders: 1e-4 absolute on
            # slots of order 1 and on attention weights in [0, 1]
            check(err_slots <= 1e-4 and err_attn <= 1e-4,
                  f"kernel vs plain at B={b} iters={iters}: slots {err_slots}, attn {err_attn}")
            ms = cuda_ms(lambda: sak.slot_attention_cuda(k, v, slots, params, iters, scale))
            plain_ms = cuda_ms(lambda: sak.slot_attention_plain(k, v, slots, params, iters, scale))
            bound_ms, bound_by = slot_attention_bound_ms(b, N, D, S, MLP_HIDDEN, iters)
            rows.append({"B": b, "iters": iters, "max_abs_err_slots": err_slots,
                         "max_abs_err_attn": err_attn, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
                         "launches": sak.slot_attention_cuda.launches - launches})
    emit({"phase": "kernels", "kernel": "slot_attention", "N": N, "D": D, "S": S,
          "mlp": MLP_HIDDEN, "tolerance_abs": 1e-4, "shapes": rows})
    return rows


def full_width_params():
    from textocvp_tpu_torch.core.config import add_predictor_params, build_exp_params

    params = build_exp_params("SAVi", "CATER_Easy")
    pred_params = add_predictor_params(params, "TextOCVP_T5")
    pred_params["prediction_params"]["num_preds"] = NUM_PREDS
    return params, pred_params


def random_models(params, pred_params, gen):
    from textocvp_tpu_torch.models import setup_model, setup_predictor
    from textocvp_tpu_torch.models.factory import random_init_

    model = random_init_(setup_model(params), gen).eval().requires_grad_(False)
    predictor = random_init_(setup_predictor(pred_params), gen).eval().requires_grad_(False)
    # With Xavier draws alone each rollout step adds a change larger than the
    # slots it started from: they grow about 1.7x a step, to 1e5 by step 19,
    # and every decoded pixel saturates. A trained predictor changes the slots
    # a little per step; so does this one with its output projection scaled
    # by 0.02 (slots of order 1 to 10 over the 19 steps).
    predictor.predictor.mlp_out.weight.mul_(PRED_OUT_SCALE)
    return model, predictor


def phase_parity(params, pred_params):
    import copy

    from textocvp_tpu_torch.data.tokenizers import HashFallbackT5Tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 1)
    model, predictor = random_models(params, pred_params, gen)
    b = 2
    video = torch.rand((b, 1, 64, 64, 3), generator=gen)
    init = model.slot_initializer(b, gen)
    tok = HashFallbackT5Tokenizer()(CAPTIONS[:b])
    pad = ((0, 0), (0, MAX_TOKENS - tok["caption_tokens"].shape[1]))
    ids = torch.from_numpy(np.pad(tok["caption_tokens"], pad))
    mask = torch.from_numpy(np.pad(tok["attn_masks"], pad))

    def predict(dev, m, p):
        with torch.inference_mode():
            hist = m.decompose(video.to(dev), initial_slots=init.to(dev))["slot_history"]
            return p(hist, ids.to(dev), mask.to(dev), num_preds=NUM_PREDS)

    ref = predict("cpu", model, predictor)
    cmodel, cpred = copy.deepcopy(model).cuda(), copy.deepcopy(predictor).cuda()
    out = predict("cuda", cmodel, cpred).cpu()
    check(bool(torch.isfinite(out).all()), "card pred_slots not finite")
    # 19 autoregressive steps through 8 layers in float32 on two devices, sums
    # in other orders: each step's error within 1e-4 of that step's largest
    # slot value
    step_err = (out - ref).abs().amax(dim=(0, 2, 3))
    step_ref = ref.abs().amax(dim=(0, 2, 3))
    ratios = (step_err / step_ref).tolist()
    check(max(ratios) <= 1e-4, f"pred_slots card vs CPU, error / max|ref| per step: {ratios}")

    frames = ref[:, 0]  # the same slots into both decoders
    with torch.inference_mode():
        dref = model.decode(frames)["recons_imgs"]
        dout = cmodel.decode(frames.cuda())["recons_imgs"].cpu()
    derr = (dout - dref).abs().max().item()
    check(derr <= 1e-4, f"decode card vs CPU: {derr} > 1e-4")
    emit({"phase": "parity", "B": b, "pred_slots_shape": list(out.shape),
          "pred_slots_max_abs_err": step_err.max().item(),
          "pred_slots_max_abs_ref_per_step": step_ref.tolist(),
          "pred_slots_err_ratio_per_step": ratios, "pred_slots_ratio_tolerance": 1e-4,
          "decode_frames": b, "decode_max_abs_err": derr, "decode_tolerance": 1e-4,
          "tf32": False})


def write_experiment(root: Path, params, pred_params):
    from textocvp_tpu_torch.core.experiment import Experiment

    gen = torch.Generator().manual_seed(SEED)
    model, predictor = random_models(params, pred_params, gen)
    parent = Experiment(root / "exp")
    parent.save_params(params)
    pred = Experiment(root / "exp" / "predictors" / "textocvp_t5")
    pred.save_params(pred_params)
    parent.models_dir.mkdir(parents=True, exist_ok=True)
    pred.models_dir.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), parent.checkpoint_path("random"))
    torch.save(predictor.state_dict(), pred.checkpoint_path("random"))
    return parent.exp_path


def phase_service(sak, exp_path):
    from textocvp_tpu_torch.serve import PredictionService

    t0 = time.perf_counter()
    service = PredictionService(exp_path, "textocvp_t5", "random", "random",
                                batch_size=BATCH, max_tokens=MAX_TOKENS, device="cuda")
    load_s = time.perf_counter() - t0
    check(service.num_preds == NUM_PREDS, "num_preds")
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0, 1, (BATCH, 1, 64, 64, 3)).astype(np.float32)
    captions = CAPTIONS[:BATCH]

    unsaturated = []

    def call(frames, captions):
        before = sak.slot_attention_cuda.launches
        t = time.perf_counter()
        out = service.predict(frames, captions)
        ms = 1e3 * (time.perf_counter() - t)
        check(sak.slot_attention_cuda.launches == before + 1, "one kernel launch per request")
        b = frames.shape[0]
        check(out.shape == (b, NUM_PREDS, 64, 64, 3), f"output shape {out.shape}")
        check(bool(np.isfinite(out).all()) and out.min() >= 0 and out.max() <= 1,
              "output finite and in [0, 1]")
        # the clip to [0, 1] says little if every pixel sits at 0 or 1
        inside = float(((out > 0) & (out < 1)).mean())
        check(inside >= 0.05, f"share of output values strictly inside (0, 1): {inside}")
        unsaturated.append(inside)
        return out, ms

    t = time.perf_counter()
    service.warmup()
    warmup_ms = 1e3 * (time.perf_counter() - t)
    _, ms_f32 = call(video, captions)
    _, ms_u8 = call(np.round(video[:3] * 255).astype(np.uint8), captions[:3])
    _, ms_8 = call(video, captions)
    steady = [call(video, captions)[1] for _ in range(5)]

    # stage split of one full request, host clock with synchronize
    text = service._tokenize(captions)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred_slots = service._predict_stage(video, text)
    torch.cuda.synchronize()
    t_pred = time.perf_counter()
    service._decode_stage(pred_slots)
    torch.cuda.synchronize()
    t_dec = time.perf_counter()
    emit({"phase": "service", "batch": BATCH, "num_preds": NUM_PREDS, "load_s": load_s,
          "warmup_ms": warmup_ms, "request_ms": {"8_float32": ms_f32, "3_uint8": ms_u8,
                                                  "8_float32_again": ms_8},
          "steady_8_row_ms": steady,
          "stage_ms": {"predict": 1e3 * (t_pred - t), "decode": 1e3 * (t_dec - t_pred)},
          "unsaturated_share": unsaturated,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "tokenizer_fallback": bool(service.tokenizer.is_fallback)})
    return service


def phase_http(service, video_rows):
    from textocvp_tpu_torch.serve import serve

    httpd = serve(service, host="127.0.0.1", port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["num_preds"] == NUM_PREDS, f"healthz {health}")
        buf = io.BytesIO()
        np.savez(buf, frames=video_rows, captions=np.array(CAPTIONS[:BATCH]))
        req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                     headers={"Content-Type": "application/npz"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            pred = np.load(io.BytesIO(r.read()))["pred_frames"]
        ms = 1e3 * (time.perf_counter() - t)
        check(pred.dtype == np.uint8 and pred.shape == (BATCH, NUM_PREDS, 64, 64, 3),
              f"pred_frames {pred.dtype} {pred.shape}")
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        check(stats["requests"] == 1 and stats["errors"] == 0, f"stats {stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread stopped")
    emit({"phase": "http", "pred_frames_shape": list(pred.shape), "dtype": str(pred.dtype),
          "round_trip_ms": ms, "stats": stats})


def phase_profile(service, video):
    """One full request under torch.profiler: device busy time (the sum of
    kernel and copy times on the one stream) against the request's wall time,
    the kernels that take the most device time, and the slot-attention
    kernel's own launches inside the request. Off the main path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    captions = CAPTIONS[:BATCH]
    service.predict(video, captions)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        service.predict(video, captions)
        wall_ms = 1e3 * (time.perf_counter() - t)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    slot_attention = [e for e in dev if "attend_kernel" in e.key or "update_kernel" in e.key]
    emit({"phase": "profile", "request_wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
          "device_ops": sum(e.count for e in dev),
          "slot_attention": [{"name": e.key[:60], "count": e.count,
                              "ms": e.self_device_time_total / 1e3} for e in slot_attention],
          "top": [{"name": e.key[:90], "count": e.count,
                   "ms": e.self_device_time_total / 1e3} for e in top]})



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA device",
              file=sys.stderr)
        return 2
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak

    name = phase_device()
    phase_build(sak)
    rows = phase_kernels(sak)
    params, pred_params = full_width_params()
    phase_parity(params, pred_params)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        exp_path = write_experiment(Path(tmp), params, pred_params)
        sak.slot_attention_cuda.launches = 0  # the main path starts here
        service = phase_service(sak, exp_path)
        video = np.random.default_rng(SEED + 2).uniform(0, 1, (BATCH, 1, 64, 64, 3))
        phase_http(service, video.astype(np.float32))
        launches = sak.slot_attention_cuda.launches  # and ends here
        phase_profile(service, video.astype(np.float32))
    check(launches == 1 + 3 + 5 + 1 + 1, f"kernel launches on the main path: {launches}")

    main_row = next(r for r in rows if r["B"] == BATCH and r["iters"] == 3)
    emit({"kernels": [{
        "name": "slot_attention",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/slot_attention.cu",
        "replaces": "textocvp_tpu/ops/pallas/slot_attention_kernel.py:37",
        "launches": launches,
        "max_abs_err": max(main_row["max_abs_err_slots"], main_row["max_abs_err_attn"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
