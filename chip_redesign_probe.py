#!/usr/bin/env python3
"""The bf16 ViT attention, the int8 conv and conv5's bf16 variant, redesigned
on wgmma and TMA, against the designs they replace and their yardsticks, on
one NVIDIA GPU.

    mkdir -p scratch_chip/parent
    git archive PARENT textocvp_tpu_torch/csrc | tar -x -C scratch_chip/parent
    python3 chip_redesign_probe.py [--parent scratch_chip/parent] \
        [--part attention|conv|conv5_bf16]

Builds this tree's kernels (``ops/build.py``) and prints their ``ptxas -v``
lines and the tensor-core instructions of each kernel function in their
SASS. With ``--parent`` (a tree holding the earlier
``textocvp_tpu_torch/csrc/vit_attention.cu``, ``conv_int8.cu`` and
``conv5.cu``) it also builds the parts' earlier sources with the port's
flags (``build.build_copy``).

Checks, one JSON line each:

- the bf16 attention at n = 1, 63, 64, 65, 127, 128, 129, 577 tokens and
  15 frame-heads against ``vit_attention_plain`` in float32 on the same bf16
  inputs, within one bf16 step (2**-8) of the largest value;
- the int8 conv against ``conv_int8_plain``, bit for bit, at SAVi's tail,
  the CNN head's first layers, frames smaller than the halo, pixel counts
  off the tile and Cin / Cout of 64 to 1024, with and without the ReLU;
- conv5's bf16 variant against ``conv5_plain`` in float32 on the same bf16
  inputs, within one bf16 step (2**-8) of the largest value, at SAVi's 64 x
  64, frames smaller than the halo, padded rows ending inside a tile, tile
  counts the persistent grid does not divide and frames wider than the
  halo's room (strips), with and without the ReLU (and the parent's kernel
  on the same inputs).

Times (CUDA events), at the main paths' shapes, in turns: parent, this
tree, this tree, parent. The attention at B = 8 and 16 (12 heads, 577
tokens, dh 64) beside ``F.scaled_dot_product_attention`` in bf16; the int8
conv at SAVi's tail (N = 1216 and 9728 maps of 64 x 64, 64 -> 64, k = 5)
beside conv5's bf16 kernel on the same shape, and at the CNN head's four
layers for 72 and 144 frames; conv5's bf16 variant at N = 1216 and 9728,
with and without the ReLU, beside cuDNN in bf16 (channels-last
``F.conv2d`` with the bias and the ReLU) and the int8 conv on the same
shape. Each row carries its bound (``chip_smoke``'s formulas). Prints the
card's name and power limit first, then one JSON line a check or a time;
exits 1 if a check failed.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

FAILED = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, row):
    row["ok"] = bool(ok)
    if not ok:
        FAILED.append(row)
    emit(row)


def parent_lib(parent: Path, part: str):
    """The parent's library of ``part`` (attention, conv or conv5_bf16), built and bound."""
    from textocvp_tpu_torch.ops import build

    csrc = parent / "textocvp_tpu_torch" / "csrc"
    if part == "attention":
        va = build.build_copy("parent_vit_attention", (csrc / "vit_attention.cu").read_text())
        va.va_bf16_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        va.va_bf16_forward.restype = ctypes.c_int
        return va
    if part == "conv":
        ci = build.build_copy("parent_conv_int8", (csrc / "conv_int8.cu").read_text())
        ci.conv_int8_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        ci.conv_int8_forward.restype = ctypes.c_int
        return ci
    c5 = build.build_copy("parent_conv5", (csrc / "conv5.cu").read_text())
    c5.conv5_bf16_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    c5.conv5_bf16_forward.restype = ctypes.c_int
    return c5


def parent_attention(lib, q, k, v, scale):
    out = torch.empty_like(q)
    b, h, n, _ = q.shape
    err = lib.va_bf16_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n,
                              scale, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def parent_conv(lib, x_q, w_q, a_scale, w_scale, bias, relu):
    n, h, w, cin = x_q.shape
    k, cout = w_q.shape[0], w_q.shape[3]
    w_k = w_q.permute(0, 1, 3, 2).contiguous()
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=x_q.device)
    err = lib.conv_int8_forward(x_q.data_ptr(), w_k.data_ptr(), a_scale.data_ptr(),
                                w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, w,
                                cin, cout, k, int(relu), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def phase_build():
    from textocvp_tpu_torch.ops import build

    build.build_all()
    for stem in ("vit_attention", "conv_int8", "conv5"):
        sass = build.sass(stem)
        # the warpgroup fences and waits ptxas placed around the wgmma, a kernel
        per_function, function = {}, None
        for line in sass.splitlines():
            head = re.match(r"\s*Function\s*:\s*(\S+)", line)
            if head:
                function = head.group(1)
                per_function[function] = {}
            elif function:
                for op in re.findall(r"\b(WARPGROUP\.\w+|WARPSYNC|BAR\.\w+)", line):
                    per_function[function][op] = per_function[function].get(op, 0) + 1
        emit({"build": stem, "ptxas": build.ptxas_report(stem).splitlines(),
              "tensor_core_sass": build.tensor_core_counts(sass), "sync_sass": per_function})


def attention_edges():
    from textocvp_tpu_torch.ops import vit_attention as va

    gen = torch.Generator().manual_seed(cs.SEED + 40)
    for n in (1, 63, 64, 65, 127, 128, 129, 577):
        q, k, v = (torch.randn((3, 5, n, 64), generator=gen).cuda().to(torch.bfloat16)
                   for _ in range(3))
        out = va.vit_attention_bf16_cuda(q, k, v, 0.125)
        ref = va.vit_attention_plain(q.float(), k.float(), v.float(), 0.125)
        torch.cuda.synchronize()
        steps = cs.bf16_steps(out, ref)
        check(bool(torch.isfinite(out).all()) and steps <= 1,
              {"check": "attention_bf16", "shape": [3, 5, n, 64], "bf16_steps": steps})


def conv_edges():
    from textocvp_tpu_torch.ops import conv_int8 as ci

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 41)
    shapes = [(3, 64, 64, 5, 64, 64), (2, 24, 24, 3, 768, 1024), (1, 48, 48, 3, 1024, 512),
              (2, 17, 70, 5, 64, 64), (1, 1, 1, 3, 64, 64), (5, 3, 130, 3, 128, 192),
              (2, 5, 7, 5, 128, 128), (3, 2, 3, 3, 64, 1024), (1, 9, 200, 3, 768, 64),
              (2, 96, 96, 3, 512, 256), (1, 192, 192, 3, 256, 128)]
    for n, h, w, k, cin, cout in shapes:
        args = (torch.randint(-127, 128, (n, h, w, cin), dtype=torch.int8, device="cuda",
                              generator=gen),
                torch.randint(-127, 128, (k, k, cin, cout), dtype=torch.int8, device="cuda",
                              generator=gen),
                torch.tensor(0.013, device="cuda"),
                1e-4 + 1e-3 * torch.rand(cout, device="cuda", generator=gen),
                torch.randn(cout, device="cuda", generator=gen))
        for relu in (True, False):
            out = ci.conv_int8_cuda(*args, relu=relu)
            ref = ci.conv_int8_plain(*args, relu=relu)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), {"check": "conv_int8", "shape": [n, h, w, k, cin, cout],
                                          "relu": relu,
                                          "max_abs_err": (out - ref).abs().max().item()})


def parent_conv5_bf16(lib, x, w, b, relu):
    """The parent's conv5 bf16 kernel (HWIO bf16 weights, as its entry point took them)."""
    out = torch.empty_like(x)
    n, h, wd, _ = x.shape
    err = lib.conv5_bf16_forward(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, h,
                                 wd, int(relu), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


# (N, H, W): the gpu test's shapes, then the wgmma design's edges: a tile
# count the persistent grid does not divide (133 x 9 tiles), padded rows
# ending inside a warpgroup's half, frames wider than the halo's room
# (strips of 75 and 40 columns), the widest single strip (79)
CONV5_BF16_EDGES = [(2, 64, 64), (3, 17, 70), (1, 1, 1), (4, 5, 130), (2, 15, 63), (1, 33, 129),
                    (70, 16, 16), (133, 64, 64), (2, 20, 30), (1, 9, 300), (1, 2, 520),
                    (3, 7, 79), (2, 6, 80), (1, 64, 64)]


def conv5_bf16_edges(parent):
    from textocvp_tpu_torch.ops import conv5 as c5

    gen = torch.Generator().manual_seed(cs.SEED + 42)
    for n, h, w in CONV5_BF16_EDGES:
        x = torch.randn((n, h, w, 64), generator=gen).cuda().to(torch.bfloat16)
        wt = (torch.randn((5, 5, 64, 64), generator=gen) / 40).cuda().to(torch.bfloat16)
        b = (0.1 * torch.randn((64,), generator=gen)).cuda()
        for relu in (True, False):
            out = c5.conv5_bf16_cuda(x, wt, b, relu)
            ref = c5.conv5_plain(x.float(), wt.float(), b, relu)
            torch.cuda.synchronize()
            row = {"check": "conv5_bf16", "shape": [n, h, w], "relu": relu,
                   "plan": c5.bf16_plan(h, w), "bf16_steps": cs.bf16_steps(out, ref),
                   "finite": bool(torch.isfinite(out).all())}
            if parent:
                row["parent_bf16_steps"] = cs.bf16_steps(parent_conv5_bf16(parent, x, wt, b, relu),
                                                         ref)
            check(row["finite"] and row["bf16_steps"] <= 1, row)


def conv5_bf16_times(parent):
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import conv_int8 as ci

    gen = torch.Generator().manual_seed(cs.SEED + 12)
    xgen = torch.Generator("cuda").manual_seed(cs.SEED + 12)
    c, res = cs.CONV5_CH, cs.CONV5_RES
    w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda().to(torch.bfloat16)
    b = (0.1 * torch.randn((c,), generator=gen)).cuda()
    w_oihw, b16 = w.permute(3, 2, 0, 1).contiguous(), b.to(torch.bfloat16)
    for n, reps in ((cs.BATCH * 19 * 8, 10), (cs.EVAL_BATCH * cs.EVAL_PREDS * 8, 3)):
        x = torch.randn((n, res, res, c), device="cuda", generator=xgen).mul_(0.5)
        x = x.to(torch.bfloat16)
        idx = [*range(min(n, 256)), n - 1]
        for relu in (True, False):
            ref = c5.conv5_plain(x[idx].float(), w.float(), b, relu)
            row = {"time": "conv5_bf16", "N": n, "relu": relu,
                   "bf16_steps": cs.bf16_steps(c5.conv5_bf16_cuda(x, w, b, relu)[idx], ref)}
            if parent:
                row["parent_bf16_steps"] = cs.bf16_steps(
                    parent_conv5_bf16(parent, x, w, b, relu)[idx], ref)
            del ref
            torch.cuda.empty_cache()
            row.update(in_turns(parent and (lambda: parent_conv5_bf16(parent, x, w, b, relu)),
                                lambda: c5.conv5_bf16_cuda(x, w, b, relu), reps=reps, warmup=1))
            act = F.relu_ if relu else (lambda y: y)
            row["library_ms"] = cs.cuda_ms(lambda: act(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b16,
                                                                padding=2)), reps=reps, warmup=1)
            torch.cuda.empty_cache()
            if relu:  # the int8 conv on the same shape (quantized here, outside the timing)
                x_q = ci.quantize_activation(x, torch.tensor(0.02, device="cuda")).contiguous()
                w_q, w_scale = ci.quantize_weight(w, (0, 1, 2))
                args = (x_q, w_q.contiguous(), torch.tensor(0.02, device="cuda"),
                        w_scale.contiguous(), b)
                row["conv_int8_ms"] = cs.cuda_ms(lambda: ci.conv_int8_cuda(*args, relu=True),
                                                 reps=reps, warmup=1)
                del x_q, w_q, args
                torch.cuda.empty_cache()
            row["bound_ms"], row["bound_by"] = cs.conv5_bf16_bounds(n, res, res, c)
            check(row["bf16_steps"] <= 1, row)
        del x
        torch.cuda.empty_cache()


def in_turns(parent_fn, fn, **kw):
    """ms of parent, this, this, parent (CUDA events); parent None: this twice."""
    order = [parent_fn, fn, fn, parent_fn] if parent_fn else [fn, fn]
    ms = [cs.cuda_ms(f, **kw) for f in order]
    if parent_fn:
        return {"parent_ms": [ms[0], ms[3]], "ms": [ms[1], ms[2]]}
    return {"ms": ms}


def attention_times(parent):
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import vit_attention as va

    scale = cs.VIT_DH ** -0.5
    gen = torch.Generator().manual_seed(cs.SEED + 13)
    for b in (cs.BATCH, cs.CLIP_EVAL_BATCH):
        q, k, v = (torch.randn((b, cs.VIT_HEADS, cs.VIT_TOKENS, cs.VIT_DH), generator=gen)
                   .cuda().to(torch.bfloat16) for _ in range(3))
        ref = va.vit_attention_plain(q.float(), k.float(), v.float(), scale)
        row = {"time": "attention_bf16", "B": b, "bf16_steps": cs.bf16_steps(
            va.vit_attention_bf16_cuda(q, k, v, scale), ref)}
        if parent:
            row["parent_bf16_steps"] = cs.bf16_steps(parent_attention(parent, q, k, v, scale), ref)
        row.update(in_turns(parent and (lambda: parent_attention(parent, q, k, v, scale)),
                            lambda: va.vit_attention_bf16_cuda(q, k, v, scale), hold=True))
        row["library_ms"] = cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                              scale=scale),
                                       hold=True)
        row["bound_ms"], row["bound_by"] = cs.bound(
            2 * 4 * b * cs.VIT_HEADS * cs.VIT_TOKENS * cs.VIT_DH,
            4 * b * cs.VIT_HEADS * cs.VIT_TOKENS ** 2 * cs.VIT_DH, cs.BF16_FLOP_PER_S)
        emit(row)


def conv_times(parent):
    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import conv_int8 as ci

    gen = torch.Generator("cuda").manual_seed(cs.SEED + 30)
    cases = [("savi_request", cs.BATCH * cs.EVAL_PREDS * 8, cs.CONV5_RES, 5, 64, 64, 10),
             ("savi_eval", cs.EVAL_BATCH * cs.EVAL_PREDS * 8, cs.CONV5_RES, 5, 64, 64, 3)]
    for b, frames in cs.CLIP_DECODE_FRAMES.items():
        cases += [(f"clipport_b{b}_cnn{i}", frames, grid, 3, cin, cout, 5)
                  for i, (grid, cin, cout) in enumerate(cs.cnn_head_layers())]
    for name, n, res, k, cin, cout, reps in cases:
        x_q = torch.randint(-127, 128, (n, res, res, cin), dtype=torch.int8, device="cuda",
                            generator=gen)
        w_q = torch.randint(-127, 128, (k, k, cin, cout), dtype=torch.int8, device="cuda",
                            generator=gen)
        args = (x_q, w_q, torch.tensor(0.02, device="cuda"),
                1e-4 + 1e-3 * torch.rand(cout, device="cuda", generator=gen),
                torch.randn(cout, device="cuda", generator=gen))
        idx = [*range(min(n, 32)), n - 1]  # the frames checked against the plain version
        out = ci.conv_int8_cuda(*args, relu=True)
        ref = ci.conv_int8_plain(x_q[idx], *args[1:], relu=True)
        row = {"time": "conv_int8", "case": name, "N": n, "H": res, "k": k, "Cin": cin,
               "Cout": cout, "exact": torch.equal(out[idx], ref)}
        del out, ref
        if parent:
            out = parent_conv(parent, *args, relu=True)
            ref = ci.conv_int8_plain(x_q[idx], *args[1:], relu=True)
            row["parent_exact"] = torch.equal(out[idx], ref)
            del out, ref
        torch.cuda.empty_cache()
        row.update(in_turns(parent and (lambda: parent_conv(parent, *args, relu=True)),
                            lambda: ci.conv_int8_cuda(*args, relu=True), reps=reps, warmup=1))
        torch.cuda.empty_cache()
        if k == 5:  # the bf16 decode's conv on the same shape
            xb = (x_q.float() * 0.02).to(torch.bfloat16)
            wb = (w_q.float() * 1e-3).to(torch.bfloat16)
            row["conv5_bf16_ms"] = cs.cuda_ms(lambda: c5.conv5_bf16_cuda(xb, wb, args[4], True),
                                              reps=reps, warmup=1)
            del xb, wb
        row["bound_ms"], row["bound_by"] = cs.conv_int8_bounds(n, res, res, k, cin, cout)
        check(row["exact"], row)
        del x_q, w_q, args
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a tree with the earlier textocvp_tpu_torch/csrc sources")
    ap.add_argument("--part", choices=("attention", "conv", "conv5_bf16", "all"), default="all",
                    help="one kernel's checks and times (a fault of one then spares the others)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_redesign_probe: needs a CUDA device", file=sys.stderr)
        return 2
    emit({"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    parts = ("attention", "conv", "conv5_bf16") if args.part == "all" else (args.part,)
    parent = {part: parent_lib(args.parent, part) if args.parent else None for part in parts}
    if "attention" in parts:
        attention_edges()
        attention_times(parent["attention"])
    if "conv" in parts:
        conv_edges()
        conv_times(parent["conv"])
    if "conv5_bf16" in parts:
        conv5_bf16_edges(parent["conv5_bf16"])
        conv5_bf16_times(parent["conv5_bf16"])
    emit({"failed": len(FAILED)})
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
