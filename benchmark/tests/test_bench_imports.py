"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "genomic_pca_tpu"}
FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "genomic_pca_tpu_torch" not in names
    assert not {n for n in names if n == "benchmark"} - {"benchmark"}


def test_prefix_is_not_a_match():
    sys.path.insert(0, str(harness.ROOT))
    from benchmark import run

    assert "genomic_pca_tpu" in run.FORBIDDEN
    assert not {"genomic_pca_tpu_torch"} & set(run.FORBIDDEN)


def test_fresh_interpreter_loads_no_jax():
    """Import every module of the benchmark and run a tiny cell with JAX
    blocked, then find no forbidden top-level module loaded."""
    code = f"""
import sys, importlib, tempfile
from pathlib import Path
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(harness.ROOT)!r})
from benchmark import harness, run
from benchmark.tests import tiny
for p in {[str(p) for p in FILES if "tests" not in p.parts]!r}:
    harness.load_module(Path(p))
import benchmark.control, benchmark.generate, benchmark.window_trace, benchmark.roofline
root = tiny.tiny_root(Path(tempfile.mkdtemp()))
res = harness.run_cell(tiny.spec_of(root), "kgp3_chr22-rfit", 5, 0.2, False, "cpu",
                       tempfile.mkdtemp(), 0.0, root=root)
for name in {sorted(FORBIDDEN)!r}:
    del sys.modules[name]
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
