"""Per-call deadlines from the calibrated timing model.

Counterpart of accl_tpu/resilience/deadline.py. In place of one fixed
receive timeout for every call, a deadline is derived per call:

    deadline(call) = predicted(call) * (1 + tolerance(op)) + floor_s

`predicted` is ``timing.predict`` under a calibrated link for the plan the
shared selection rules resolve; `tolerance` is the drift sentinel's band
(``telemetry.metrics.DriftSentinel``) around a reference median relative
residual: ``max(ref * band_factor, ref + band_floor)``; `floor_s` keeps a
microsecond prediction from arming a microsecond deadline. A call past its
deadline is out of the model, the sentinel's claim made per call.

A miss is a structured :class:`DeadlineMissed` verdict (op, count,
predicted against elapsed, the sticky retcode if there is one, the
suspect) with the flight recorder's post-mortem attached
(``recorder.on_deadline_miss`` freezes the span rings on a host-side
verdict, so a silent hang leaves an artifact too).

:class:`NativeDeadlineGuard` applies the policy to the native emulator's
ranks (device/emu_device.py): it sets a rank's in-call receive deadline
(the set_timeout config word) to the derived value and bounds the host's
wait the same way, so a wedged peer surfaces as a typed
:class:`DeadlineMissedError` within one widened prediction.

The link is the caller's: the emulator tier's shipped fit
(``feedback.default_link``) suits the native ranks; a GPUDevice call wants
a fit of the card's own spans, or a LinkParams measured on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from ..constants import (
    CfgFunc,
    Operation,
    TuningParams,
    error_code_to_string,
)
from ..descriptor import CallOptions
from ..telemetry.export import median as _median
# the sentinel's band constants are the one source of band semantics
from ..telemetry.metrics import (
    DEFAULT_SENTINEL_BAND_FACTOR,
    DEFAULT_SENTINEL_BAND_FLOOR,
)

# the reference residual before any is armed: the model may be off by its
# own magnitude (relative error 1.0), deliberately loose
DEFAULT_UNARMED_REFERENCE = 1.0
# an absolute floor under every deadline (host scheduling noise)
DEFAULT_DEADLINE_FLOOR_S = 0.05


@dataclasses.dataclass(frozen=True)
class DeadlineMissed:
    """Structured verdict for one missed per-call deadline."""

    op: str
    count: int
    predicted_s: float
    deadline_s: float
    elapsed_s: float
    rank: int | None = None
    retcode: int = 0
    suspect_rank: int | None = None
    attribution: str = ""
    post_mortem: dict | None = None

    def verdict(self) -> dict[str, Any]:
        """JSON-ready rendering."""
        out: dict[str, Any] = {
            "kind": "deadline_missed",
            "op": self.op,
            "count": self.count,
            "predicted_s": self.predicted_s,
            "deadline_s": self.deadline_s,
            "elapsed_s": self.elapsed_s,
        }
        if self.rank is not None:
            out["rank"] = self.rank
        if self.retcode:
            out["retcode"] = self.retcode
            out["retcode_str"] = error_code_to_string(self.retcode)
        if self.suspect_rank is not None:
            out["suspect_rank"] = self.suspect_rank
            out["attribution"] = self.attribution
        out["post_mortem_spans"] = (len(self.post_mortem.get("spans", []))
                                    if self.post_mortem else 0)
        return out

    def __str__(self) -> str:
        sus = (f"; suspect r{self.suspect_rank} ({self.attribution})"
               if self.suspect_rank is not None else "")
        rc = (f"; sticky {error_code_to_string(self.retcode)}"
              if self.retcode else "")
        return (f"DeadlineMissed: {self.op} count={self.count} elapsed "
                f"{self.elapsed_s * 1e3:.1f} ms > deadline "
                f"{self.deadline_s * 1e3:.1f} ms (predicted "
                f"{self.predicted_s * 1e3:.1f} ms){rc}{sus}")


class DeadlineMissedError(RuntimeError):
    """Typed raise carrying the structured verdict (guarded waits)."""

    def __init__(self, miss: DeadlineMissed):
        self.miss = miss
        super().__init__(str(miss))


class DeadlinePolicy:
    """Derive per-call deadlines from a calibrated link and a residual
    tolerance band (module docstring for the formula).

    ``link`` is a ``timing.LinkParams``. ``aggregate`` selects the
    serialized-host cost shape (the emulator tier's calibration regime,
    the default) over the critical path. Deadlines are cached per
    (op, count, elem_bytes): the armed hot path is a dict hit.
    """

    def __init__(self, link: Any, world: int, *,
                 rx_buf_bytes: int = 4096,
                 max_eager_size: int = 4096,
                 tuning: TuningParams | None = None,
                 aggregate: bool = True,
                 band_factor: float = DEFAULT_SENTINEL_BAND_FACTOR,
                 band_floor: float = DEFAULT_SENTINEL_BAND_FLOOR,
                 floor_s: float = DEFAULT_DEADLINE_FLOOR_S):
        if link is None:
            raise ValueError(
                "DeadlinePolicy needs a calibrated LinkParams: without one "
                "a derived deadline would be a constant in disguise "
                "(calibrate_from_trace / default_link)")
        self.link = link
        self.world = int(world)
        self.rx_buf_bytes = int(rx_buf_bytes)
        self.max_eager_size = int(max_eager_size)
        self.tuning = tuning if tuning is not None else TuningParams.default()
        self.aggregate = bool(aggregate)
        self.band_factor = float(band_factor)
        self.band_floor = float(band_floor)
        self.floor_s = float(floor_s)
        self._reference: dict[str, float] = {}
        self._cache: dict[tuple, tuple[float, float]] = {}

    # -- tolerance band (the sentinel's semantics) -------------------------

    def arm_reference(self, op: str | Operation,
                      median_rel_err: float) -> None:
        """Pin an op's reference residual: the calibration's median
        |pred - meas| / meas in the current regime."""
        self._reference[self._op_name(op)] = float(median_rel_err)
        self._cache.clear()

    def arm_from_residuals(self, op: str | Operation,
                           residuals: list[float]) -> float:
        """Arm from measured residual samples (their median)."""
        ref = float(_median(list(residuals)))
        self.arm_reference(op, ref)
        return ref

    def tolerance(self, op: str | Operation) -> float:
        """Relative tolerance above the prediction: the sentinel's
        ``max(ref * band_factor, ref + band_floor)`` around the armed
        reference (DEFAULT_UNARMED_REFERENCE while none is armed)."""
        ref = self._reference.get(self._op_name(op),
                                  DEFAULT_UNARMED_REFERENCE)
        return max(ref * self.band_factor, ref + self.band_floor)

    @staticmethod
    def _op_name(op: str | Operation) -> str:
        return op.name if isinstance(op, Operation) else str(op)

    @staticmethod
    def _op_enum(op: str | Operation) -> Operation:
        return op if isinstance(op, Operation) else Operation[str(op)]

    # -- prediction + deadline ---------------------------------------------

    def _predict_deadline(self, op: Operation, count: int,
                          elem_bytes: int) -> tuple[float, float]:
        key = (op, int(count), int(elem_bytes))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        from ..sequencer.plan import select_algorithm
        from ..sequencer.timing import predict

        plan = select_algorithm(
            op, int(count), int(elem_bytes), self.world,
            max_eager_size=self.max_eager_size,
            eager_rx_buf_size=self.rx_buf_bytes,
            tuning=self.tuning)
        pred = predict(self.link, op, plan, int(count), int(elem_bytes),
                       self.world, rx_buf_bytes=self.rx_buf_bytes,
                       aggregate=self.aggregate)
        dl = pred * (1.0 + self.tolerance(op)) + self.floor_s
        self._cache[key] = (pred, dl)
        return pred, dl

    def predict_and_deadline(self, op: str | Operation, count: int,
                             elem_bytes: int = 4) -> tuple[float, float]:
        """(predicted_s, deadline_s) in one cached lookup: the armed hot
        path's single call."""
        return self._predict_deadline(self._op_enum(op), count,
                                      elem_bytes)

    def predict_s(self, op: str | Operation, count: int,
                  elem_bytes: int = 4) -> float:
        return self._predict_deadline(self._op_enum(op), count,
                                      elem_bytes)[0]

    def deadline_s(self, op: str | Operation, count: int,
                   elem_bytes: int = 4) -> float:
        return self._predict_deadline(self._op_enum(op), count,
                                      elem_bytes)[1]

    def deadline_ms(self, op: str | Operation, count: int,
                    elem_bytes: int = 4) -> int:
        return max(int(self.deadline_s(op, count, elem_bytes) * 1e3), 1)

    # -- the miss verdict --------------------------------------------------

    def check(self, op: str | Operation, count: int, elem_bytes: int,
              elapsed_s: float, *, rank: int | None = None,
              retcode: int = 0, suspect_rank: int | None = None,
              attribution: str = "") -> DeadlineMissed | None:
        """Post-hoc check of one completed (or failed) call: the verdict
        when ``elapsed_s`` exceeded the deadline or a retcode is set
        (post-mortem frozen and attached), else None."""
        pred, dl = self._predict_deadline(self._op_enum(op), count,
                                          elem_bytes)
        if elapsed_s <= dl and not retcode:
            return None
        return self.build_miss(op, count, pred, dl, elapsed_s, rank=rank,
                               retcode=retcode, suspect_rank=suspect_rank,
                               attribution=attribution)

    def build_miss(self, op: str | Operation, count: int,
                   predicted_s: float, deadline_s: float,
                   elapsed_s: float, *, rank: int | None = None,
                   retcode: int = 0, suspect_rank: int | None = None,
                   attribution: str = "") -> DeadlineMissed:
        """Assemble the verdict and fire the flight recorder's host-side
        dump (a silent hang leaves an artifact with no sticky retcode)."""
        from ..telemetry import recorder

        name = self._op_name(op)
        post = recorder.on_deadline_miss(
            name, rank=rank, count=count, predicted_s=predicted_s,
            deadline_s=deadline_s, elapsed_s=elapsed_s,
            suspect_rank=suspect_rank, retcode=retcode)
        return DeadlineMissed(
            op=name, count=int(count), predicted_s=predicted_s,
            deadline_s=deadline_s, elapsed_s=elapsed_s, rank=rank,
            retcode=int(retcode), suspect_rank=suspect_rank,
            attribution=attribution, post_mortem=post)


class NativeDeadlineGuard:
    """Derived deadlines on native EmuRank calls.

    ``arm(rank, op, count)`` sets the rank's in-call receive deadline (the
    set_timeout config word) to the policy's value, so the runtime times a
    stalled call out itself. ``wait(rank, handle, ...)`` bounds the host's
    wait the same way (HOST_WAIT_SLACK times the deadline) and turns both
    shapes of failure, the native sticky RECEIVE_TIMEOUT and a host-side
    overrun, into a typed :class:`DeadlineMissedError`. A call that
    completes past its deadline gives a verdict (reported to the manager)
    without raising: the data arrived and the model was wrong, the drift
    sentinel's business rather than recovery's.
    """

    # the native in-call deadline fires first; the host bound is the
    # backstop for a sequencer that cannot reach its own timeout check
    HOST_WAIT_SLACK = 3.0

    def __init__(self, policy: DeadlinePolicy, manager: Any = None):
        self.policy = policy
        self.manager = manager

    def arm(self, emu_rank: Any, op: str | Operation, count: int,
            elem_bytes: int = 4) -> int:
        """Set the rank's native receive deadline from the model; returns
        the milliseconds applied."""
        ms = self.policy.deadline_ms(op, count, elem_bytes)
        emu_rank.call(CallOptions(scenario=Operation.config,
                                  function=int(CfgFunc.set_timeout),
                                  count=ms))
        return ms

    def _notify(self, miss: DeadlineMissed) -> DeadlineMissed:
        if self.manager is not None:
            self.manager.record_miss(miss)
        return miss

    def wait(self, emu_rank: Any, handle: int, op: str | Operation,
             count: int, elem_bytes: int = 4) -> DeadlineMissed | None:
        """Complete one started native call within its deadline: None on
        a success in time, the verdict (no raise) on a late success, and
        :class:`DeadlineMissedError` on a wedged or timed-out call."""
        from ..constants import ACCLError, ErrorCode

        pol = self.policy
        pred, dl = pol.predict_and_deadline(op, count, elem_bytes)
        t0 = time.perf_counter()
        try:
            emu_rank.wait(handle,
                          timeout_ms=max(int(dl * 1e3 * self.HOST_WAIT_SLACK),
                                         1))
        except TimeoutError:
            elapsed = time.perf_counter() - t0
            miss = pol.build_miss(op, count, pred, dl, elapsed,
                                  rank=emu_rank.rank)
            raise DeadlineMissedError(self._notify(miss)) from None
        except ACCLError as e:
            elapsed = time.perf_counter() - t0
            if e.retcode & int(ErrorCode.RECEIVE_TIMEOUT_ERROR):
                miss = pol.build_miss(
                    op, count, pred, dl, elapsed, rank=emu_rank.rank,
                    retcode=e.retcode)
                raise DeadlineMissedError(self._notify(miss)) from None
            raise  # a sticky error other than a timeout is no deadline event
        elapsed = time.perf_counter() - t0
        if elapsed <= dl:
            return None
        miss = pol.build_miss(op, count, pred, dl, elapsed,
                              rank=emu_rank.rank)
        self._notify(miss)
        return miss

    def run(self, emu_rank: Any, opts: CallOptions, *, op0=None, op1=None,
            res=None, elem_bytes: int = 4) -> DeadlineMissed | None:
        """Start one descriptor and wait for it within its deadline."""
        h = emu_rank.start(opts, op0=op0, op1=op1, res=res)
        return self.wait(emu_rank, h, opts.scenario, opts.count,
                         elem_bytes)
