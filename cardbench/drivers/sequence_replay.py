"""A step as one replay of a recorded call sequence: the step's
messages are recorded once with `ACCL.sequence()` (one send and one
receive buffer each), `compile()`d at set-up (plan resolution, the lint
gate and, on the card, the CUDA-graph capture), and each step is one
`SequenceProgram.run(from_device=True, to_device=True, run_async=True)`
completed with `ACCL.wait`. This is how a decode loop replays a token
step's collectives.
"""

from __future__ import annotations


class Driver:
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
        self.program = None
        self.replays = 0
        self._replay_ns: list[int] = []

    def prepare(self) -> None:
        rec = self.accl.sequence()
        for send, recv, n in self.calls:
            rec.allreduce(send, recv, n, self.sum, compress_dtype=self.wire)
        self.program = rec.compile()

    def step(self) -> None:
        with self.span("replay"):
            req = self.program.run(from_device=True, to_device=True,
                                   run_async=True)
        with self.span("wait"):
            self.accl.wait(req)
        self.replays += 1
        self._replay_ns.append(req.get_duration_ns())

    def replay_ns(self) -> list[int]:
        """Device ns of each replay since the last call (the program's
        CUDA event pair around the graph launch)."""
        out, self._replay_ns = self._replay_ns, []
        return out
