"""The PyTorch/CUDA port stands alone: no module of accl_tpu_torch/, nor
chip_smoke.py, imports JAX, the JAX package, the bf16 extension package
or jsonschema (absent on the card's machine: the port validates traces
itself), and the facade never falls back to the CPU on its own.

The scan reads the source (AST), not sys.modules: this container's
interpreter start-up imports jax, so a module-table check would see it
anyway."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "accl_tpu", "ml_dtypes", "jsonschema")


def _port_sources():
    files = sorted((ROOT / "accl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_nothing_of_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_covers_the_emulator_resilience_and_scheduler():
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for mod in ("device/emu_device.py", "resilience/__init__.py",
                "resilience/deadline.py", "resilience/manager.py",
                "scheduler/__init__.py", "scheduler/errors.py",
                "scheduler/tenant.py", "scheduler/qos.py",
                "scheduler/scheduler.py"):
        assert f"accl_tpu_torch/{mod}" in scanned, mod


def test_scan_covers_the_multi_host_backend_and_its_runner():
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for mod in ("device/dcn_device.py", "device/dcn_transport.py",
                "sequencer/hierarchical.py", "tools/__init__.py",
                "tools/run_dcn.py"):
        assert f"accl_tpu_torch/{mod}" in scanned, mod


def test_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom jax import numpy\n"
                     "import importlib\nimportlib.import_module('ml_dtypes')\n")
    assert _imported_roots(probe) & set(FORBIDDEN) == {"jax", "ml_dtypes"}


def test_accl_without_cuda_and_without_cpu_request_raises(monkeypatch):
    from accl_tpu_torch import ACCL

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ACCL(world=2)
    # an explicit CPU request is honoured
    assert ACCL(world=2, torch_device="cpu").world == 2


def test_ring_kernel_wrapper_uses_plain_version_only_on_cpu():
    from accl_tpu_torch.ops import ring_allreduce as ra

    x = torch.arange(2 * 300, dtype=torch.float32).reshape(2, 300)
    before = (ra.ring_allreduce_bidir.launches, ra.ring_allreduce.launches)
    assert torch.equal(ra.ring_allreduce_bidir(x, 2),
                       ra.ring_allreduce_bidir_ref(x, 2))
    assert torch.equal(ra.ring_allreduce(x, 2), ra.ring_allreduce_ref(x, 2))
    # the plain version is no launch
    assert (ra.ring_allreduce_bidir.launches,
            ra.ring_allreduce.launches) == before
    with pytest.raises(ValueError, match="slot"):
        ra.ring_allreduce_bidir(x, 2, slot=2)
    with pytest.raises(ValueError, match="stacked"):
        ra.ring_allreduce_bidir(x, 3)
