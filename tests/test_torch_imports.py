"""The port stands alone: no module of ``src/repro_torch`` and neither
``chip_smoke.py`` nor ``chip_ab.py`` imports ``jax`` or the JAX package
``repro``, and the package imports in a process where ``jax`` cannot be
imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
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
        "import repro_torch.models.moe, repro_torch.models.mamba2\n"
        "import repro_torch.models.encdec, repro_torch.models.frontends\n"
        "import repro_torch.configs.phi_3_vision_4_2b, repro_torch.configs.gemma2_2b\n"
        "from repro_torch.configs import get_config\n"
        "import repro_torch.configs.jamba_v0_1_52b, repro_torch.configs.mamba2_370m\n"
        "import repro_torch.serve.engine, repro_torch.serve.kv_compression\n"
        "import repro_torch.kernels.flash_attention, repro_torch.launch.serve\n"
        "import repro_torch.core.streaming, repro_torch.data.pipeline\n"
        "import repro_torch.train, repro_torch.launch.train, repro_torch.utils.tree\n"
        "import repro_torch.data.instance_selection, repro_torch.train.compression\n"
        "import repro_torch.tune, repro_torch.tune.__main__, repro_torch.tune.autotune\n"
        "import repro_torch.core.distributed, repro_torch.core._collectives\n"
        "import repro_torch.launch.mesh\n"
        "from repro_torch.launch.mesh import batch_specs\n"
        "from repro_torch.train import zero_opt_specs, mesh_opt_specs\n"
        "from repro_torch.launch.mesh import data_axis\n"
        "from repro_torch.launch.mesh import (MeshShape, make_plan,\n"
        "    make_production_mesh, model_axis)\n"
        "from repro_torch.models.tensor_parallel import (shard_model,\n"
        "    shard_params, gather_params, init_sharded, entry_names)\n"
        "from repro_torch.train.optimizer import gather_shards, gather_whole\n"
        "from repro_torch.train.compression import (compressed_psum,\n"
        "    psum_with_error_feedback, tree_compressed_psum)\n"
        "from repro_torch.launch.train import (check_fits, state_bytes_per_rank,\n"
        "    init_bytes_per_rank)\n"
        "from repro_torch import make_data_mesh, ihtc, ihtc_sharded\n"
        "from repro_torch.core import ring_knn, tc_sharded, kmeans_sharded\n"
        "from repro_torch.data import stream_to_mesh\n"
        "from repro_torch.serve import (AsyncClusterService, IndexStore,\n"
        "    OnlineFitter, RefreshDriver, RefreshPolicy)\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
