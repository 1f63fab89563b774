"""
Build of the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, bound through ``ctypes`` by the
module that launches it. All sources are built together, one ``nvcc`` each,
started at once, at the first load of any of them. The libraries land in
``textocvp_tpu_torch/_build/`` under a name keyed by a hash of every source
and of the compiler flags, so an edit to any source rebuilds them all and a
stale library is never loaded. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
                           "built from source at first use")
    return found


def library_paths() -> dict[str, Path]:
    """{source stem: the shared library built from it at this version}."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    return {src.stem: BUILD_DIR / f"lib{src.stem}_{digest}.so" for src in sources()}


def build_all(timeout: float = 900) -> list[str]:
    """Compile every source whose library is missing, all at once; returns
    the stems that were built. Raises with ``nvcc``'s errors if one fails."""
    paths = library_paths()
    todo = {stem: so for stem, so in paths.items() if not so.is_file()}
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem, so in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, so)
    errors = []
    for stem, (proc, tmp, so) in procs.items():
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"nvcc on {stem}.cu timed out after {timeout} s")
            continue
        if proc.returncode != 0:
            errors.append(f"nvcc on {stem}.cu failed ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return sorted(todo)


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built (with all the others) if missing."""
    with _lock:
        if stem not in _libs:
            build_all()
            _libs[stem] = ctypes.CDLL(str(library_paths()[stem]))
        return _libs[stem]
