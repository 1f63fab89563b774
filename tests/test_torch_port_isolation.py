"""The PyTorch port stands alone: no module of ``textocvp_tpu_torch`` and
nothing in ``chip_smoke.py``, ``chip_slot_attention_probe.py``,
``chip_trace_probe.py``, ``chip_remat_probe.py``, ``chip_int8_rows_probe.py``
or the multi-process tests'
worker ``tests/torch_dist_worker.py`` imports JAX, flax, optax or the JAX
package."""

import torch_cpu_threads  # noqa: F401  (two torch threads a worker)
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "textocvp_tpu")
SOURCES = sorted((ROOT / "textocvp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_slot_attention_probe.py", ROOT / "chip_trace_probe.py",
    ROOT / "chip_remat_probe.py", ROOT / "chip_int8_rows_probe.py",
    ROOT / "tests" / "torch_dist_worker.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Import every module of the port in a fresh interpreter whose import
    system refuses jax, flax, optax and textocvp_tpu."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "textocvp_tpu_torch").rglob("*.py"))
    code = f"""
import sys
BLOCKED = {FORBIDDEN!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
import importlib
for mod in {modules!r}:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok", len({modules!r}))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.startswith("ok")
