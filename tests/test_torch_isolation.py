"""The PyTorch port stands alone: importing every module of ``repro_torch``
(and everything ``chip_smoke.py`` imports) loads neither JAX nor the JAX
package."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import ast, importlib, pkgutil, sys
sys.path.insert(0, "src")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 56  # every module was walked
    assert {
        "repro_torch.kernels.flash_attention.ops", "repro_torch.models.dual_encoder",
        "repro_torch.models.cross_encoder", "repro_torch.launch.profile_serve",
        "repro_torch.core.advanced", "repro_torch.launch.table1", "repro_torch.models.moe",
        "repro_torch.runtime.compat", "repro_torch.serving.dist_decode", "repro_torch.core.retrieval",
        "repro_torch.runtime.sharding", "repro_torch.launch.mesh",
    } <= walked


def test_port_sources_have_no_jax_or_reference_imports():
    import re

    pat = re.compile(r"^\s*(import|from) (jax|repro)\b", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits
