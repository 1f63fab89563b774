"""
Build of the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, bound through ``ctypes`` by the
module that launches it; ``csrc/*.cuh`` are headers the sources include
(``-I csrc``). All sources are built together, one ``nvcc`` each, started at
once, at the first load of any of them. The libraries land in
``textocvp_tpu_torch/_build/`` under a name keyed by a hash of every source,
every header and the compiler flags, so an edit to any of them rebuilds them
all and a stale library is never loaded. Beside each library ``nvcc`` leaves
its ``-Xptxas -v`` report (registers, shared memory, spills of each kernel),
read by :func:`ptxas_report`; :func:`tensor_core_by_function` counts the
tensor-core instructions of each kernel function in a built library's
machine code. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# SASS of the tensor cores: mma.sync (HMMA; IMMA for int8) and warpgroup wgmma
# (HGMMA; IGMMA for int8)
TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA")
_TENSOR_CORE_SASS = re.compile(r"\b(HMMA|HGMMA|IMMA|IGMMA)\b")
_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list[Path]:
    """The sources compiled, one library each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include."""
    return sorted(CSRC.glob("*.cuh"))


def _cuda_tool(name: str) -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / name).is_file():
            return str(Path(cand) / "bin" / name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME): the port's CUDA kernels are "
                           "built from source at first use")
    return found


def library_paths() -> dict[str, Path]:
    """{source stem: the shared library built from it at this version}."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    return {src.stem: BUILD_DIR / f"lib{src.stem}_{digest}.so" for src in sources()}


def _start(src: Path, so: Path):
    """An ``nvcc`` of ``src`` into a temporary file beside ``so``, started."""
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp


def _finish(src: Path, proc, tmp: Path, so: Path, timeout: float):
    """Wait for a started ``nvcc``; move its library into place and keep its
    ``ptxas`` report beside it. Returns an error message, or None."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return f"nvcc on {src.name} timed out after {timeout} s"
    if proc.returncode != 0:
        return f"nvcc on {src.name} failed ({proc.returncode}):\n{err}"
    so.with_suffix(".ptxas.txt").write_text(err)
    os.replace(tmp, so)
    return None


def build_all(timeout: float = 900) -> list[str]:
    """Compile every source whose library is missing, all at once; returns
    the stems that were built. Raises with ``nvcc``'s errors if one fails."""
    paths = library_paths()
    todo = {stem: so for stem, so in paths.items() if not so.is_file()}
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [(CSRC / f"{stem}.cu", so) for stem, so in todo.items()]
    procs = [(src, *_start(src, so), so) for src, so in srcs]  # all started, then waited for
    errors = [e for src, proc, tmp, so in procs if (e := _finish(src, proc, tmp, so, timeout))]
    if errors:
        raise RuntimeError("\n".join(errors))
    return sorted(todo)


def build_copy(name: str, text: str, timeout: float = 900) -> ctypes.CDLL:
    """``text``, an edited copy of a source, written to ``_build/<name>.cu``,
    built with the port's flags and loaded: for a probe that measures an edit
    of a kernel without shipping it. Its ``ptxas`` report lies beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}.cu"
    src.write_text(text)
    so = BUILD_DIR / f"lib{name}.so"
    err = _finish(src, *_start(src, so), so, timeout)
    if err is not None:
        raise RuntimeError(err)
    return ctypes.CDLL(str(so))


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built (with all the others) if missing."""
    with _lock:
        if stem not in _libs:
            build_all()
            _libs[stem] = ctypes.CDLL(str(library_paths()[stem]))
        return _libs[stem]


def ptxas_report(stem: str) -> str:
    """``ptxas -v``'s lines for the built library of ``csrc/<stem>.cu``: each
    kernel's registers, shared memory, stack frame and spills."""
    path = library_paths()[stem].with_suffix(".ptxas.txt")
    return "\n".join(line for line in path.read_text().splitlines()
                     if "ptxas" in line or "stack frame" in line)


def tensor_core_counts(sass: str) -> dict[str, dict[str, int]]:
    """{kernel function: {instruction: count}} of the tensor-core instructions
    (:data:`TENSOR_CORE_OPS`) in ``cuobjdump -sass`` text, by the ``Function :``
    headers (mangled names) that the text holds."""
    counts: dict[str, dict[str, int]] = {}
    function = None
    for line in sass.splitlines():
        head = _SASS_FUNCTION.match(line)
        if head:
            function = head.group(1)
            counts.setdefault(function, dict.fromkeys(TENSOR_CORE_OPS, 0))
        elif function is not None:
            for op in _TENSOR_CORE_SASS.findall(line):
                counts[function][op] += 1
    return counts


def sass(stem: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<stem>.cu``."""
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(library_paths()[stem])],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def tensor_core_by_function(stem: str) -> dict[str, dict[str, int]]:
    """:func:`tensor_core_counts` of the built library of ``csrc/<stem>.cu``."""
    return tensor_core_counts(sass(stem))


def tensor_core_instructions(stem: str) -> int:
    """How many tensor-core instructions (:data:`TENSOR_CORE_OPS`) ``cuobjdump -sass``
    shows in the built library of ``csrc/<stem>.cu``."""
    return sum(sum(ops.values()) for ops in tensor_core_by_function(stem).values())
