"""
Slot-attention refinement: the CUDA kernel of ``csrc/slot_attention.cu`` and
its plain PyTorch version.

The kernel replaces the JAX package's Pallas TPU kernel
(``textocvp_tpu/ops/pallas/slot_attention_kernel.py::_slot_attention_kernel``);
the plain version is the counterpart of its XLA twin ``_xla_iterations``. The
source file says what bounds the kernel on an H100 and how its design answers.

* :func:`slot_attention_iterations` dispatches on the tensor's device: a CPU
  tensor runs :func:`slot_attention_plain`, a CUDA tensor launches the kernel
  through :func:`slot_attention_cuda` or raises. There is no fallback.
* The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
  with a plain C interface (``textocvp_tpu_torch/_build/``, at first use) and
  bound through ``ctypes``.
* Forward only: outputs carry no autograd history.

``params`` is the dict of :meth:`SlotAttention.iteration_params`: LayerNorm
weights and biases (eps 1e-3), ``q_w`` (D, D), the ``torch.nn.GRUCell``
weights (gate order r, z, n) and the MLP weights, all in torch's (out, in)
layout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "slot_attention.cu"
BUILD_DIR = _PKG / "_build"
LN_EPS = 1e-3

_PARAM_ORDER = ("norm_slot_w", "norm_slot_b", "q_w", "q_b",
                "gru_w_ih", "gru_b_ih", "gru_w_hh", "gru_b_hh",
                "norm_mlp_w", "norm_mlp_b", "mlp_w0", "mlp_b0", "mlp_w1", "mlp_b1")


def slot_attention_plain(k, v, slots, params: dict, num_iters: int, scale: float,
                         eps: float = 1e-8):
    """k, v (B, N, D); slots (B, S, D) -> (slots, attn (B, S, N)), attn being
    the last iteration's attention after +eps and before the renorm."""
    p = params
    d = slots.shape[-1]
    attn_out = None
    for _ in range(num_iters):
        prev = slots
        q = F.linear(F.layer_norm(slots, (d,), p["norm_slot_w"], p["norm_slot_b"], LN_EPS),
                     p["q_w"], p["q_b"])
        dots = torch.einsum("bsd,bnd->bsn", q, k) * scale
        attn = torch.softmax(dots, dim=1) + eps  # slots compete for each location
        attn_out = attn
        updates = torch.einsum("bsn,bnd->bsd", attn / attn.sum(-1, keepdim=True), v)
        i_r, i_z, i_n = F.linear(updates, p["gru_w_ih"], p["gru_b_ih"]).chunk(3, -1)
        h_r, h_z, h_n = F.linear(prev, p["gru_w_hh"], p["gru_b_hh"]).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        slots = (1.0 - z) * n + z * prev
        h = F.relu(F.linear(
            F.layer_norm(slots, (d,), p["norm_mlp_w"], p["norm_mlp_b"], LN_EPS),
            p["mlp_w0"], p["mlp_b0"]))
        slots = slots + F.linear(h, p["mlp_w1"], p["mlp_b1"])
    return slots, attn_out


# ----------------------------------------------------------------------------- build

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the slot-attention kernel "
                           "is built from source at first use")
    return found


def load_library():
    """Build (once per source version) and load the kernel's shared library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
        so = BUILD_DIR / f"libslot_attention_{digest}.so"
        if not so.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.sa_forward.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 5
                                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.sa_forward.restype = ctypes.c_int
        for fn in (lib.sa_chunk_size, lib.sa_width, lib.sa_max_slots):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


# ---------------------------------------------------------------------------- launch


def _check(k, v, slots, params, num_iters, lib):
    if not k.is_cuda:
        raise ValueError(f"k must lie on a CUDA device, got {k.device}")
    tensors = {"k": k, "v": v, "slots": slots, **{n: params[n] for n in _PARAM_ORDER}}
    for name, t in tensors.items():
        if t.device != k.device:
            raise ValueError(f"{name} must lie on {k.device} with k, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.dim() != 3 or v.shape != k.shape or slots.dim() != 3:
        raise ValueError(f"want k, v (B, N, D) and slots (B, S, D); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(slots.shape)}")
    b, _, d = k.shape
    s = slots.shape[1]
    if slots.shape[0] != b or slots.shape[2] != d:
        raise ValueError(f"slots {tuple(slots.shape)} do not match k {tuple(k.shape)}")
    if d != lib.sa_width():
        raise ValueError(f"the kernel takes D = {lib.sa_width()}, got {d}")
    if not 1 <= s <= lib.sa_max_slots():
        raise ValueError(f"the kernel takes 1..{lib.sa_max_slots()} slots, got {s}")
    h = params["mlp_w0"].shape[0]
    if h % 4:
        raise ValueError(f"MLP hidden width {h} must be a multiple of 4")
    want = {"norm_slot_w": (d,), "norm_slot_b": (d,), "q_w": (d, d), "q_b": (d,),
            "gru_w_ih": (3 * d, d), "gru_b_ih": (3 * d,), "gru_w_hh": (3 * d, d),
            "gru_b_hh": (3 * d,), "norm_mlp_w": (d,), "norm_mlp_b": (d,),
            "mlp_w0": (h, d), "mlp_b0": (h,), "mlp_w1": (d, h), "mlp_b1": (d,)}
    for name, shape in want.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(params[name].shape)}, want {shape}")
    if num_iters < 1:
        raise ValueError(f"num_iters must be >= 1, got {num_iters}")


def slot_attention_cuda(k, v, slots, params: dict, num_iters: int, scale: float,
                        eps: float = 1e-8):
    """Launch the CUDA kernel on the current stream; raises on what it does not take."""
    lib = load_library()
    _check(k, v, slots, params, num_iters, lib)
    b, n, d = k.shape
    s = slots.shape[1]
    chunks = -(-n // lib.sa_chunk_size())
    out = torch.empty_like(slots)
    attn = torch.empty((b, s, n), device=k.device, dtype=torch.float32)
    q = torch.empty_like(slots)
    part_acc = torch.empty((b, chunks, s, d), device=k.device, dtype=torch.float32)
    part_sum = torch.empty((b, chunks, s), device=k.device, dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (k, v, slots, out, attn, q, part_acc, part_sum)]
    ptrs += [params[name].data_ptr() for name in _PARAM_ORDER]
    stream = torch.cuda.current_stream(k.device).cuda_stream
    with torch.cuda.device(k.device):
        err = lib.sa_forward(*ptrs, b, n, s, params["mlp_w0"].shape[0], num_iters,
                             float(scale), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"slot-attention kernel launch failed: cudaError {err}")
    slot_attention_cuda.launches += 1
    return out, attn


slot_attention_cuda.launches = 0


def slot_attention_iterations(k, v, slots, params: dict, num_iters: int, scale: float,
                              eps: float = 1e-8):
    """The plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if k.device.type == "cpu":
        return slot_attention_plain(k, v, slots, params, num_iters, scale, eps)
    with torch.no_grad():
        params = {name: params[name].detach() for name in _PARAM_ORDER}
        return slot_attention_cuda(k.detach(), v.detach(), slots.detach(), params,
                                   num_iters, scale, eps)
