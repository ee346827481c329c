"""Nothing the benchmark runs imports JAX or the JAX package, the
reference imports nothing of the program, and no file reads the JAX
package's benchmark or smoke scripts. Top-level module names are
compared whole: accl_tpu_torch begins with accl_tpu and is the program."""

import ast
import sys
import types
from pathlib import Path

import pytest

from cardbench import harness

PKG = Path(harness.__file__).resolve().parent
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "accl_tpu"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "math", "numpy", "torch"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_reads_the_jax_benchmarks(path):
    text = path.read_text()
    for name in ("bench.py", "chip_smoke", "BENCH_", "MULTICHIP_"):
        assert name not in text


def test_runtime_check_compares_top_level_names_whole(monkeypatch):
    assert "accl_tpu" not in harness.forbidden_modules()
    import accl_tpu_torch  # noqa: F401  (the program is allowed)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "accl_tpu.ops",
                        types.ModuleType("accl_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["accl_tpu", "jaxlib"]
