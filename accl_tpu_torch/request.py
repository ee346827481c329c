"""Asynchronous request handles.

Counterpart of accl_tpu/request.py. A request owns its status, the call's
sticky return code and its duration. On the card a launch returns before
the work is done, so a GPURequest's completion is a CUDA event recorded
after the call's kernels on the current stream, and its duration is the
elapsed time of an event pair around them. On the CPU PyTorch runs
eagerly: the work is done when the request is made, and the duration is
the host clock's. A call sequence's request (SequenceRequest) is timed
by the event pair around its graph replay. A recv issued before its send
parks as a ParkedRecvRequest until the send arrives or the device's
timeout lapses.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

from .constants import ACCLError, ErrorCode, OperationStatus


class BaseRequest:
    """One in-flight collective call."""

    _next_id = iter(range(1, 1 << 62))

    def __init__(self, function_name: str = "call"):
        self.request_id = next(self._next_id)
        self.function_name = function_name
        self.status = OperationStatus.QUEUED
        self.retcode = 0
        self.duration_ns = 0
        self._done = threading.Event()
        # facade rider (ACCL._complete / ACCL.wait): buffers whose
        # device->host sync was deferred to wait()
        self._accl_sync_out: list = []

    def running(self):
        self.status = OperationStatus.EXECUTING
        self._start_time = time.perf_counter_ns()

    def complete(self, retcode: int = 0):
        self.retcode = retcode
        self.duration_ns = time.perf_counter_ns() - getattr(
            self, "_start_time", time.perf_counter_ns()
        )
        self.status = OperationStatus.COMPLETED
        self._done.set()
        if retcode:
            from .errors import notify_sticky_retcode

            notify_sticky_retcode(self.function_name, int(retcode))

    def wait(self, timeout: float | None = None) -> bool:
        """Block until completion; returns False on timeout."""
        return self._done.wait(timeout)

    def test(self) -> bool:
        """Non-blocking completion probe."""
        return self.status == OperationStatus.COMPLETED

    def check(self):
        """Raise if the call returned a sticky error word."""
        if self.retcode:
            raise ACCLError(self.function_name, self.retcode)

    def get_duration_ns(self) -> int:
        return self.duration_ns


class GPURequest(BaseRequest):
    """Request for one launched call. `events` is the (start, end) CUDA
    event pair recorded around the call's kernels, or None for a call
    that ran on the CPU (complete on return)."""

    def __init__(self, function_name: str, outputs: list[torch.Tensor],
                 events: tuple[torch.cuda.Event, torch.cuda.Event] | None,
                 on_complete: Callable[["GPURequest"], Any] | None = None):
        super().__init__(function_name)
        self.outputs = outputs
        self._events = events
        self._on_complete = on_complete
        # set by the device after plan selection: the resolved Plan, and
        # when the tracer is active its timing.predict estimate, or the
        # thunk that computes it when the facade reads it (the facade
        # reads it only where something consumes it: the ring is
        # collecting, or the call is synchronous and feeds the drift
        # sentinel)
        self.plan: Any = None
        self._predicted: float | None = None
        self._predict: Callable[[], float | None] | None = None
        self.running()

    @property
    def predicted_s(self) -> float | None:
        if self._predict is not None:
            self._predicted, self._predict = self._predict(), None
        return self._predicted

    @predicted_s.setter
    def predicted_s(self, value: float | None) -> None:
        self._predicted, self._predict = value, None

    def wait(self, timeout: float | None = None) -> bool:
        if self.status == OperationStatus.COMPLETED:
            return True
        try:
            if self._events is not None:
                start, end = self._events
                if timeout is not None:
                    deadline = time.monotonic() + timeout
                    while not end.query():
                        if time.monotonic() >= deadline:
                            return False
                        time.sleep(0.0001)
                end.synchronize()
            self.complete(0)
            if self._events is not None:
                self.duration_ns = int(start.elapsed_time(end) * 1e6)
        except RuntimeError as e:
            # surface device failures through the sticky-error-word
            # contract; the original exception still propagates
            self.complete(_classify_runtime_error(e))
            raise
        if self._on_complete is not None:
            self._on_complete(self)
        return True

    def test(self) -> bool:
        if self.status == OperationStatus.COMPLETED:
            return True
        if self._events is None or self._events[1].query():
            self.wait()
            return True
        return False


class SequenceRequest(GPURequest):
    """Request for one dispatch of a prepared call sequence: one graph
    replay covering a recorded batch of descriptors on the card (its
    duration is the CUDA event pair around the replay), the eager body on
    the CPU (the host clock). `plans` and `num_steps` expose what the one
    dispatch covered."""

    def __init__(self, outputs, plans, events, on_complete=None):
        super().__init__("sequence", outputs, events,
                         on_complete=on_complete)
        self.plans = list(plans)
        self.num_steps = len(self.plans)
        # content hash of the recorded batch (the compile and lint cache
        # key), set by the device on every dispatch
        self.signature: str | None = None
        # certificate id of the pairwise-clean set this program was
        # admitted into by ACCL.certify_concurrent, if any
        self.interference_cert: str | None = None
        # exactly one dispatch happened for the whole batch
        self.num_dispatches = 1


class ParkedRecvRequest(BaseRequest):
    """A recv issued before its matching send: parks until the send
    arrives (then mirrors the launched pair's GPURequest) or the device's
    configured timeout lapses (then completes with RECEIVE_TIMEOUT_ERROR).
    The reference's counterpart is the firmware retry queue re-running an
    unmatched recv until its housekeeping timeout.

    The outcome is decided exactly once: pairing (the sending thread) and
    timeout (any waiting or testing thread) race through `claim()`, so a
    send arriving at the deadline is never reported as a timeout after its
    transfer ran, and the other way round."""

    def __init__(self, options, timeout_s: float):
        super().__init__("recv")
        self.options = options
        self.running()
        self._deadline = time.monotonic() + timeout_s
        self._inner: BaseRequest | None = None
        self._paired = threading.Event()
        self._claim_lock = threading.Lock()
        self._claimed = False
        # the device's parking sequence number (arrival order)
        self._park_seq = 0
        # set by the device: drops this request from its parking map
        self._unpark: Callable[[], None] = lambda: None

    def claim(self) -> bool:
        """Atomically claim the right to decide this request's outcome."""
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def resolve(self, inner: BaseRequest):
        """Called by the device, after a successful claim, when the
        matching send arrives: `inner` is the launched pair's request."""
        self._inner = inner
        self._paired.set()

    def _timeout_fire(self) -> bool:
        self._unpark()
        self.complete(int(ErrorCode.RECEIVE_TIMEOUT_ERROR))
        return True

    def wait(self, timeout: float | None = None) -> bool:
        if self.status == OperationStatus.COMPLETED:
            return True
        caller_deadline = (None if timeout is None
                           else time.monotonic() + timeout)
        while True:
            # another thread (test(), a reset) may decide the outcome
            if self.status == OperationStatus.COMPLETED:
                return True
            now = time.monotonic()
            if caller_deadline is not None and now >= caller_deadline:
                return False
            if self._paired.is_set():
                remain = (None if caller_deadline is None
                          else max(caller_deadline - time.monotonic(), 0))
                if not self._inner.wait(remain):
                    return False
                self.complete(self._inner.retcode)
                return True
            if now >= self._deadline:
                if self.claim():
                    return self._timeout_fire()
                # claimed elsewhere: a send is pairing (resolve sets
                # _paired) or another thread fired the timeout (status
                # COMPLETED); poll for whichever
                self._paired.wait(0.05)
                continue
            limit = self._deadline - now
            if caller_deadline is not None:
                limit = min(limit, caller_deadline - now)
            self._paired.wait(max(limit, 0))

    def test(self) -> bool:
        if self.status == OperationStatus.COMPLETED:
            return True
        if self._paired.is_set():
            if self._inner.test():
                self.complete(self._inner.retcode)
                return True
            return False
        if time.monotonic() >= self._deadline and self.claim():
            return self._timeout_fire()
        return False


def _classify_runtime_error(e: Exception) -> int:
    """Map a device/runtime exception onto the closest sticky error bits."""
    msg = str(e).lower()
    if "out of memory" in msg:
        return int(ErrorCode.DMA_SIZE_ERROR)
    if "timeout" in msg or "timed out" in msg:
        return int(ErrorCode.DMA_TIMEOUT_ERROR
                   | ErrorCode.RECEIVE_TIMEOUT_ERROR)
    return int(ErrorCode.DMA_INTERNAL_ERROR)
