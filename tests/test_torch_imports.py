"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and the
package imports in a process where ``jax`` cannot be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert path.exists(), f"{path} is missing"
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "class _NoJax:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _NoJax())\n"
        "import repro_torch\n"
        "from repro_torch import fit, ClusterIndex, ClusterService\n"
        "import repro_torch.kernels.ops, repro_torch.core.tc, repro_torch.prng\n"
        "import repro_torch.models.registry, repro_torch.models.convert\n"
        "import repro_torch.serve.engine, repro_torch.serve.kv_compression\n"
        "import repro_torch.kernels.flash_attention, repro_torch.launch.serve\n"
        "import repro_torch.core.streaming, repro_torch.data.pipeline\n"
        "from repro_torch.serve import (AsyncClusterService, IndexStore,\n"
        "    OnlineFitter, RefreshDriver, RefreshPolicy)\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
