"""The files-only alltoall test cell's generator: each step scales every
operand by its rank's weight into a buffer of its own, then
replays one recorded sequence of `ACCL.alltoall` calls over those
buffers, completed with `ACCL.wait`."""

import torch


class Driver:
    def __init__(self, accl, sends, recvs, counts, traffic, wire, span, *,
                 config, seed, shrink, weights):
        world = config["deployment"]["world"]
        self.accl, self.wire, self.span = accl, wire, span
        self.scale = weights["scale"]
        self.scaled = [accl.create_buffer(n, torch.float32) for n in counts]
        self.calls = [(send, mid, recv, n // world) for send, mid, recv, n
                      in zip(sends, self.scaled, recvs, counts)]
        self.program = None
        self.replays = 0

    def prepare(self) -> None:
        rec = self.accl.sequence()
        for _, mid, recv, count in self.calls:
            rec.alltoall(mid, recv, count, compress_dtype=self.wire)
        self.program = rec.compile()

    def step(self) -> None:
        for send, mid, _, _ in self.calls:
            mid.device = torch.mul(send.device, self.scale)
        with self.span("replay"):
            req = self.program.run(from_device=True, to_device=True,
                                   run_async=True)
        with self.span("wait"):
            self.accl.wait(req)
        self.replays += 1

    def replay_ns(self) -> list[int]:
        return []
