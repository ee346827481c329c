"""A token step of DeepSeek-V3's MoE layers as one replay of a recorded
call sequence (accl_tpu_torch.models.moe.V3MoEStep): each layer's input
is a step operand, its result a step result; per layer the router and
shared expert ride a copy's consumer, the held experts the dispatch's
(a slot-driven scatter alltoallv), then the combine (a gate-weighted
gather alltoallv) and a SUM combine. The sequence is compiled at
set-up; a step is one dispatch completed with `V3MoEStep.wait`, which,
while the program's tracer collects, reads the routing counters back
after completion.

The layers share their intermediate buffers (one set holds the worst
case of the exchange, 0.94 GB at full width). The hazard pass reads that
sharing as WAR and WAW hazards between steps that no data dependency
orders, about 40 warnings a compile, where one CUDA stream runs them in
order; so the program is recorded with lint off.
"""

from __future__ import annotations


class Driver:
    def __init__(self, accl, sends, recvs, counts, traffic, wire, span, *,
                 config, seed, shrink, weights):
        from accl_tpu_torch.models import moe

        dep = config["deployment"]
        hidden = config["hidden_size"] // shrink
        cfg = moe.V3MoEConfig.from_hf(
            dict(config, hidden_size=hidden), held_first=dep["held_first"],
            held=dep["held_experts"], tokens=counts[0] // hidden)
        self.layers = [{k: v[i] for k, v in weights.items()}
                       for i in range(len(counts))]
        self.accl, self.cfg, self.wire, self.span = accl, cfg, wire, span
        self.sends, self.recvs = sends, recvs
        self.calls = list(zip(sends, recvs, counts))
        self.step_ = None
        self.replays = 0
        self._replay_ns: list[int] = []

    def prepare(self) -> None:
        from accl_tpu_torch.models import moe

        self.step_ = moe.V3MoEStep(self.accl, self.cfg, self.layers,
                                   self.sends, self.recvs,
                                   compress_dtype=self.wire, lint="off")

    def step(self) -> None:
        with self.span("replay"):
            req = self.step_.run()
        with self.span("wait"):
            self.step_.wait(req)
        self.replays += 1
        self._replay_ns.append(req.get_duration_ns())

    def replay_ns(self) -> list[int]:
        """Device ns of each replay since the last call."""
        out, self._replay_ns = self._replay_ns, []
        return out
