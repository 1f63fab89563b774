"""``tpu.compute_dtype: "bfloat16"`` in the PyTorch port's 03
(``DecompEvaluator``) on the CPU: a tiny SAVi experiment (``Learned`` slots)
evaluated in bf16 and in float32 by both packages, the port's framewise
metrics held to the JAX package's with ``tests/torch_bf16.py``'s rule, and
its reconstructions bfloat16.

The JAX evaluator shards its steps over the host's devices, and an
interpret-mode Pallas call cannot be partitioned, so it runs its XLA slot
attention here (which refines in bf16 where the port, following the Pallas
arm, casts to float32): the rule then holds the port to the arm it does not
follow.
"""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import copy

import numpy as np
import torch
from test_torch_port_decomp_eval import (
    CATER_FRAMES,
    jax_results,
    port_evaluator,
    write_experiment,
)
from test_torch_port_evaluator import RES, _tiny_params, write_cater_npy
from torch_bf16 import check_bf16

DTYPES = ("bfloat16", "float32")


def test_03_bf16_matches_jax(tmp_path, monkeypatch):
    params, _ = _tiny_params(write_cater_npy(tmp_path / "CATER"))
    params["dataset"]["num_frames"] = CATER_FRAMES
    exps = {"float32": write_experiment(tmp_path / "exp", params, "savi", RES, 52)}
    bf16 = {**copy.deepcopy(params), "tpu": {"compute_dtype": "bfloat16"}}
    exps["bfloat16"] = write_experiment(tmp_path / "exp_bf16", bf16, "savi", RES, 52)
    refs = {dt: jax_results(exps[dt], monkeypatch) for dt in DTYPES}
    outs = {}
    for dt in DTYPES:
        ev = port_evaluator(exps[dt])
        if dt == "bfloat16":
            assert ev.model.compute_dtype == torch.bfloat16
            videos, _ = next(iter(ev.test_loader))
            with torch.no_grad():
                assert ev.reconstruct(ev.to_device(videos)).dtype == torch.bfloat16
        outs[dt] = ev.evaluate()
    for m in ("psnr", "ssim", "lpips"):
        assert len(outs["bfloat16"][m]["framewise"]) == CATER_FRAMES
        check_bf16(*(np.array(d[m]["framewise"]) for d in (outs["bfloat16"], outs["float32"],
                                                            refs["bfloat16"], refs["float32"])),
                   m, dtype_checked=False)
