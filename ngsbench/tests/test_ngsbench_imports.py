"""No file of the benchmark imports JAX or the JAX package, the reference
imports nothing of the program, and a run refuses to report when either
was loaded. Names are compared whole, by the part before the first dot:
the port's name begins with the JAX package's."""

import ast
import sys
import types
from pathlib import Path

from ngsbench import harness

PKG = Path(harness.__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "neuralgaussiansplatting_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & JAX, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((PKG / "reference").rglob("*.py")):
        names = top_level_imports(f)
        assert "neuralgaussiansplatting_torch" not in names, f
        assert names <= {"__future__", "math", "typing", "torch",
                         "ngsbench"}, (f, names)
    # and the reference's own imports reach only the reference
    for f in sorted((PKG / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("ngsbench"):
                assert node.module.startswith("ngsbench.reference"), f


def test_run_names_loaded_jax_modules(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "neuralgaussiansplatting_torch_x",
                        types.ModuleType("neuralgaussiansplatting_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jnp"))
    monkeypatch.setitem(sys.modules, "neuralgaussiansplatting_tpu.ops",
                        types.ModuleType("ops"))
    assert harness.forbidden_modules() == ["jax",
                                           "neuralgaussiansplatting_tpu"]
