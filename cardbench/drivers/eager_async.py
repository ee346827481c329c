"""A step of eager calls: every message dispatched with
`ACCL.allreduce(..., from_device=True, to_device=True, run_async=True)`
in issue order, then each request completed with `ACCL.wait`, in the same
order. This is how DDP drives a bucketed gradient sync: buckets go out as
they fill and the optimizer waits for all of them.
"""

from __future__ import annotations


class Driver:
    replays = 0

    def __init__(self, accl, sends, recvs, counts, traffic, wire, span, *,
                 config, seed, shrink, weights):
        # the operands and counts carry all of an allreduce step: the
        # configuration, seed, shrink and weights are not read here
        from accl_tpu_torch import ReduceFunction

        self.accl = accl
        self.calls = list(zip(sends, recvs, counts))
        self.wire = wire
        self.span = span
        self.sum = ReduceFunction.SUM

    def prepare(self) -> None:
        pass

    def step(self) -> None:
        accl, span = self.accl, self.span
        reqs = []
        for send, recv, n in self.calls:
            with span("dispatch"):
                reqs.append(accl.allreduce(
                    send, recv, n, self.sum, from_device=True,
                    to_device=True, run_async=True,
                    compress_dtype=self.wire))
        for req in reqs:
            with span("wait"):
                accl.wait(req)

    def replay_ns(self) -> list[int]:
        return []
