"""What the benchmark may import: nothing of JAX, of the JAX package
``repro`` (compared by whole top-level name: ``repro_torch`` is the port)
or of ``benchmarks/``; and its reference nothing of the program."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_no_reference_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _top_level_imports(path) <= {"__future__", "hashlib", "math", "numpy", "torch", "reference"}


def test_whole_names_are_compared():
    pytest.importorskip("torch")  # the harness and the program import it
    sys.path.insert(0, str(BENCH))
    from fedbench.cell import FORBIDDEN as HARNESS_FORBIDDEN, forbidden_modules

    assert set(HARNESS_FORBIDDEN) == FORBIDDEN
    probe = ("import sys; sys.path[:0] = [%r, %r]; import repro_torch.serving.engine, fedbench.cell as c; "
             "print(c.forbidden_modules())" % (str(BENCH), str(BENCH.parent / "src")))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    fake = "repro" not in sys.modules
    if fake:
        sys.modules["repro"] = types.ModuleType("repro")
    try:
        assert "repro" in forbidden_modules()
    finally:
        if fake:
            del sys.modules["repro"]
