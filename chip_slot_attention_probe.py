#!/usr/bin/env python3
"""Two measurements of the port's slot-attention kernel on one NVIDIA GPU.

    python3 chip_slot_attention_probe.py

Both build edited copies of ``textocvp_tpu_torch/csrc/slot_attention.cu``
(``build.build_copy``, under ``textocvp_tpu_torch/_build/``); the port's own
library is untouched. At the shapes of ``chip_smoke.py``'s kernels phase
(CATER N=4096, S=8, MLP 256 at B=8 and B=64; CLIPort N=576, S=10, MLP 512 at
B=8):

1. clusters: the shipped kernel (clusters of 8 CTAs) against a copy with
   clusters of 16 (a non-portable size, allowed on the kernel before the
   launch). Each is held against ``slot_attention_plain`` (1e-4 absolute on
   slots and attention) at 1 and 3 iterations and timed as ``chip_smoke.py``
   times it (``cuda_ms`` with the card held while the host enqueues), in
   turns 8, 16, 16, 8. Also prints each library's ``ptxas -v`` lines and how
   many of its clusters the card runs at once
   (``cudaOccupancyMaxActiveClusters``).
2. phases: a copy in which thread 0 of every CTA of the first cluster reads
   ``clock64()`` at each ``cluster.sync`` and sums, over the K/V tiles of each
   iteration, the cycles spent waiting for a tile (``cp.async`` wait and the
   barrier after it), in the dot products and the sum of their parts, in the
   softmax, and in a . v with the barrier that ends the tile. 3 iterations;
   rank 0's cycles a phase.

Prints the card's name and power limit first, then one JSON line a
measurement and shape. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import cuda_ms

SEED = 14
D = 128
SHAPES = ((8, 4096, 8, 256), (64, 4096, 8, 256), (8, 576, 10, 512))  # (B, N, S, MLP)
PHASE_ITERS = 3
EVENTS = 32
PHASES = ("tiles", "sums+sync", "updates+sync", "gru+sync", "mlp_hidden+sync",
          "mlp_out+sync", "queries+sync")
TILE_PARTS = ("wait", "dots", "softmax", "a_v")
MARK = "if (blockIdx.y == 0 && threadIdx.x == 0 && ev < 32) g_ev[rank][ev++] = clock64();"


def _edit(text: str, subs) -> str:
    """``text`` with each (old, new) replaced; each old must occur once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"not found once in the kernel source: {old!r}")
        text = text.replace(old, new)
    return text


def clusters_of_16(text: str) -> str:
    """The kernel source with clusters of 16 CTAs."""
    return _edit(text, [
        ("constexpr int C = 8;", "constexpr int C = 16;"),
        ("static_assert(D % C == 0 && C <= 8,", "static_assert(D % C == 0 && C <= 16,"),
        ("    int clusters = 0;\n",
         "    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
         "    if (err != cudaSuccess) return err;\n    int clusters = 0;\n"),
    ])


def with_clocks(text: str) -> str:
    """The kernel source with the clock reads and ``sa_read_clocks`` added."""
    text = _edit(text, [
        ("namespace cg = cooperative_groups;",
         "namespace cg = cooperative_groups;\n"
         "__device__ long long g_ev[16][32];\n__device__ long long g_tile[16][4][4];\n"
         'extern "C" int sa_read_clocks(long long* ev, long long* tile) {\n'
         "  int e = (int)cudaMemcpyFromSymbol(ev, g_ev, sizeof(g_ev));\n"
         "  return e ? e : (int)cudaMemcpyFromSymbol(tile, g_tile, sizeof(g_tile));\n}"),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  int ev = 0;\n  "
         + MARK + "\n"),
        ("    for (int t = 0; t < ntiles; ++t) {",
         "    long long tw = 0, td = 0, ts = 0, tp = 0, c3 = 0;\n"
         "    for (int t = 0; t < ntiles; ++t) {"),
        ("      if (t + 1 < ntiles) {",
         "      long long c0 = clock64();\n      if (t > 0) tp += c0 - c3;\n"
         "      if (t + 1 < ntiles) {"),
        ("      const float* ks = region",
         "      long long c1 = clock64(); tw += c1 - c0;\n      const float* ks = region"),
        ("      if (tid < len) {",
         "      long long c2 = clock64(); td += c2 - c1;\n      if (tid < len) {"),
        ("#pragma unroll 2\n", "      c3 = clock64(); ts += c3 - c2;\n#pragma unroll 2\n"),
        ("#pragma unroll\n    for (int s = 0; s < S; ++s)\n      reinterpret_cast<float4*>(region",
         "    if (ntiles > 0) tp += clock64() - c3;\n"
         "    if (blockIdx.y == 0 && tid == 0 && it < 4) { g_tile[rank][it][0] = tw; "
         "g_tile[rank][it][1] = td; g_tile[rank][it][2] = ts; g_tile[rank][it][3] = tp; }\n"
         "    " + MARK + "\n"
         "#pragma unroll\n    for (int s = 0; s < S; ++s)\n      reinterpret_cast<float4*>(region"),
    ])
    lines = []
    for line in text.splitlines():
        lines.append(line)
        if line.strip().startswith("cluster.sync();"):
            lines.append("  " + MARK)
    return "\n".join(lines) + "\n"


def _case(b, n, s, mlp):
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.ops.slot_attention import SlotAttention

    gen = torch.Generator().manual_seed(SEED)
    mod = random_init_(SlotAttention(D, D, s, mlp), gen).cuda()
    params = {name: p.detach() for name, p in mod.iteration_params().items()}
    k, v = (torch.randn((b, n, D), generator=gen).cuda() for _ in range(2))
    slots = torch.randn((b, s, D), generator=gen).cuda()
    out = torch.empty_like(slots)
    attn = torch.empty((b, s, n), device="cuda")
    return k, v, slots, params, out, attn


def _ptxas(lib) -> str:
    report = Path(lib._name).with_suffix(".ptxas.txt").read_text()
    return "\n".join(l for l in report.splitlines() if "ptxas" in l or "stack frame" in l)


def clusters(sak, build):
    source = (build.CSRC / "slot_attention.cu").read_text()
    libs = {8: sak.load_library(), 16: sak.bind(build.build_copy(
        "slot_attention_clusters16", clusters_of_16(source)))}
    for c, lib in libs.items():
        assert lib.sa_cluster_size() == c, (c, lib.sa_cluster_size())
        print(f"clusters of {c}\n{_ptxas(lib)}", flush=True)
        print(json.dumps({"probe": "clusters", "cluster_size": c, "active_clusters": {
            f"S={s},mlp={mlp}": lib.sa_active_clusters(s, mlp) for _, _, s, mlp in SHAPES}}),
            flush=True)
    for b, n, s, mlp in SHAPES:
        k, v, slots, params, out, attn = _case(b, n, s, mlp)
        for iters in (1, 3):
            ref, ref_attn = sak.slot_attention_plain(k, v, slots, params, iters, D ** -0.5)
            errs = {}
            for c, lib in libs.items():
                sak.launch(lib, k, v, slots, params, iters, D ** -0.5, 1e-8, out, attn)
                torch.cuda.synchronize()
                errs[c] = max((out - ref).abs().max().item(), (attn - ref_attn).abs().max().item())
                if errs[c] > 1e-4:
                    raise AssertionError(f"clusters of {c} at {(b, n, s, mlp, iters)}: {errs[c]}")
            ms = {c: [] for c in libs}
            for c in (8, 16, 16, 8):
                ms[c].append(cuda_ms(lambda lib=libs[c]: sak.launch(
                    lib, k, v, slots, params, iters, D ** -0.5, 1e-8, out, attn), hold=True))
            print(json.dumps({"probe": "clusters", "B": b, "N": n, "S": s, "mlp": mlp,
                              "iters": iters, "max_abs_err": errs, "ms": ms,
                              "ms_mean": {c: sum(t) / len(t) for c, t in ms.items()}}), flush=True)


def phases(sak, build):
    import ctypes

    source = (build.CSRC / "slot_attention.cu").read_text()
    lib = sak.bind(build.build_copy("slot_attention_clocks", with_clocks(source)))
    lib.sa_read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for b, n, s, mlp in SHAPES:
        k, v, slots, params, out, attn = _case(b, n, s, mlp)
        ms = cuda_ms(lambda: sak.launch(lib, k, v, slots, params, PHASE_ITERS, D ** -0.5, 1e-8,
                                        out, attn), hold=True)
        ev = (ctypes.c_longlong * (16 * EVENTS))()
        tile = (ctypes.c_longlong * (16 * 16))()
        err = lib.sa_read_clocks(ctypes.addressof(ev), ctypes.addressof(tile))
        if err:
            raise RuntimeError(f"reading the clocks failed: cudaError {err}")
        t = [ev[i] for i in range(EVENTS)]  # rank 0
        names = ["cluster_up", "first_queries"] + [
            f"it{it}:{ph}" for it in range(PHASE_ITERS) for ph in PHASES][:EVENTS - 1]
        cycles = {name: t[i + 1] - t[i] for i, name in enumerate(names) if t[i + 1] > 0}
        per_tile_part = {f"it{it}": dict(zip(TILE_PARTS, (tile[it * 4 + j] for j in range(4))))
                         for it in range(PHASE_ITERS)}
        print(json.dumps({"probe": "phases", "B": b, "N": n, "S": s, "mlp": mlp,
                          "iters": PHASE_ITERS, "ms": ms, "total_cycles": max(t) - t[0],
                          "rank0_cycles": cycles, "rank0_tile_loop_cycles": per_tile_part}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from textocvp_tpu_torch.ops import build
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        clusters(sak, build)
        phases(sak, build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
