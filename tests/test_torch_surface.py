"""The port's public names against the JAX package's.

Every public name of accl_tpu, its sequencer, telemetry, models and
parallel subpackages, the synthesis module, the analysis package and
modules (the model, parallel, synthesis and analysis modules' own
names, not those they import: the lifting entry points of protocol and
semantics and the interference certifier among them), the resilience
and scheduler packages and modules, the native emulator's module (its
own names: it takes torch dtypes where the reference imports
from_numpy_dtype), the two-tier schedules and the multi-host device's
module, the ACCL facade, its SequenceProgram and the devices (TPUDevice
against GPUDevice, the two DCNDevices) that the port lacks must
be a known gap, listed with the ROADMAP item that brings it; a gap that
closes must leave the list (it is empty: every name is ported). nop()
runs through both facades to the same request.
"""

import importlib
import types

import pytest

# (where, name) -> the ROADMAP queue-1 item that brings it to the port
KNOWN_GAPS: dict[tuple[str, str], str] = {}


def _public(obj) -> set[str]:
    return {n for n in dir(obj) if not n.startswith("_")
            and not isinstance(getattr(obj, n, None), types.ModuleType)}


def _defined_in(module) -> set[str]:
    """A module's public names less the classes and functions it imports
    from another module (the reference's jax.sharding names,
    ring_attention)."""
    def own(obj):
        return not callable(obj) or obj.__module__ == module.__name__

    return {n for n in _public(module) if own(getattr(module, n))}


def _pairs():
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu.accl import SequenceProgram as RefProgram
    from accl_tpu.device.dcn_device import DCNDevice as RefDCN
    from accl_tpu.device.tpu_device import TPUDevice
    from accl_tpu_torch.accl import ACCL, SequenceProgram
    from accl_tpu_torch.device.dcn_device import DCNDevice
    from accl_tpu_torch.device.gpu_device import GPUDevice

    yield "package", importlib.import_module("accl_tpu"), \
        importlib.import_module("accl_tpu_torch")
    for sub in ("sequencer", "telemetry", "telemetry.tracer",
                "telemetry.export", "telemetry.metrics",
                "telemetry.recorder", "telemetry.native",
                "telemetry.feedback", "models", "models.transformer",
                "models.moe", "models.serve", "parallel", "parallel.mesh",
                "parallel.ring_attention", "parallel.ulysses",
                "parallel.pipeline", "sequencer.synthesis",
                "analysis.protocol", "analysis.modelcheck",
                "analysis.slots", "analysis.semantics", "analysis.hopdag",
                "analysis.linter", "analysis.interference", "analysis",
                "resilience", "resilience.deadline", "resilience.manager",
                "scheduler", "scheduler.errors", "scheduler.tenant",
                "scheduler.qos", "scheduler.scheduler",
                "device.emu_device", "sequencer.hierarchical",
                "device.dcn_device"):
        yield sub, importlib.import_module(f"accl_tpu.{sub}"), \
            importlib.import_module(f"accl_tpu_torch.{sub}")
    yield "ACCL", RefACCL, ACCL
    yield "SequenceProgram", RefProgram, SequenceProgram
    yield "device", TPUDevice, GPUDevice
    yield "DCNDevice", RefDCN, DCNDevice


@pytest.mark.parametrize("where", [p[0] for p in _pairs()])
def test_port_has_every_public_name_but_the_known_gaps(where):
    ref, port = next((r, p) for w, r, p in _pairs() if w == where)
    names = (_defined_in if where.startswith(
        ("models.", "parallel.", "sequencer.", "analysis.", "device."))
        else _public)
    missing = names(ref) - _public(port)
    if where == "package":  # the reference's lazy facade names
        missing |= {n for n in ("ACCL", "SequenceRecorder")
                    if not hasattr(port, n)}
    known = {n for (w, n) in KNOWN_GAPS if w == where}
    assert missing == known, (
        f"{where}: missing {sorted(missing - known)}, "
        f"no longer missing {sorted(known - missing)}")


def test_repaired_names_are_the_reference_objects_counterparts():
    import accl_tpu
    import accl_tpu_torch
    from accl_tpu_torch import sequencer

    assert accl_tpu_torch.SequencePlan is sequencer.SequencePlan
    assert accl_tpu_torch.SequenceRecorder.__name__ == "SequenceRecorder"
    got = accl_tpu_torch.generate_ranks(3, start_port=6000)
    want = accl_tpu.generate_ranks(3, start_port=6000)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    # select_wire is held against the reference in test_torch_plan.py
    from accl_tpu_torch.sequencer import plan

    assert sequencer.select_wire is plan.select_wire


def test_nop_through_both_facades(mesh8):
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu_torch import ACCL

    want = RefACCL(mesh8).nop()
    port = ACCL(world=8, torch_device="cpu")
    got = port.nop()
    assert (type(got).__name__, got.function_name, got.retcode,
            got.status.name) == (type(want).__name__, want.function_name,
                                 want.retcode, want.status.name)
    assert got.test() and want.test()
    assert port.cclo.read(0x1FFC) == 0  # RETCODE register written
