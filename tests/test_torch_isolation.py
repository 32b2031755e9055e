"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_port_imports_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.runtime, repro_torch.launch.serve\n"
        "import repro_torch.kernels, repro_torch.weights, repro_torch.core\n"
        "import runpy\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and not node.args[0].value.startswith(".")):
            yield node.lineno, node.args[0].value.split(".")[0]


@pytest.mark.parametrize("src,found", [
    ("import jax.numpy as jnp", ["jax"]),
    ("from jax import lax", ["jax"]),
    ("from repro.core import PartitionedLog", ["repro"]),
    ("def f():\n    import repro.models", ["repro"]),
    ("importlib.import_module('repro.configs')", ["repro"]),
    ("import repro_torch.core\nfrom . import kernels", []),
    ("'src/repro/kernels/rmsnorm/kernel.py:33'", []),
])
def test_scan_finds_imports_and_only_imports(src, found):
    got = [name for _, name in _imported_roots(ast.parse(src))
           if name in FORBIDDEN]
    assert got == found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_nothing_of_jax(path):
    """Static scan of every import statement (and import_module call):
    mentions in text, such as the file:line of the TPU kernel a CUDA kernel
    replaces, are not imports."""
    bad = [(line, name) for line, name in
           _imported_roots(ast.parse(path.read_text()))
           if name in FORBIDDEN]
    assert bad == [], f"{path}: imports {bad}"
