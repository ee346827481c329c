"""The detect -> exclude -> re-plan -> re-certify -> install loop.

Counterpart of accl_tpu/resilience/manager.py. :class:`ResilienceManager`
holds the membership and the installed recovery plan:

  1. detect: deadline-miss verdicts arrive (``record_miss``); a retry
     budget with backoff separates a straggler from a dead peer, so the
     membership change is paid only when retries keep missing;
  2. exclude: the suspect leaves the live set (named by the verdict, or
     by silence: the one live rank that did not report a wave every other
     survivor reported);
  3. re-plan: a recovery schedule over the survivors, a committed
     synthesized library entry where one covers the cell (power-of-two
     worlds), else the ring of plan.select_algorithm (any world);
  4. re-certify: the candidate's hop-DAG (regenerated from the library
     spec, or lifted from the port's own schedule body by
     ``semantics.lift_call``) goes through hopdag.validate_order,
     ``semantics.certify`` against its collective, the protocol
     simulation and the interleaving model checker. A plan with any
     diagnostic is never installed (:class:`UncertifiedRecoveryError`);
  5. install: the plan is published under the lock with a new
     generation; executors read ``current_plan``/``generation`` between
     dispatches, so calls in flight finish on the old membership.

Wire-health deltas (``observe_wire_health``/``assess_miss``) tell a lossy
link, which the transport repairs (:class:`IntegrityFault`, no
reconfiguration), from a dark one, which alone walks the path above.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

from ..constants import DataType, Operation, ReduceFunction, TuningParams
from ..descriptor import CallOptions
from .deadline import DeadlineMissed, DeadlinePolicy


@dataclasses.dataclass(frozen=True)
class IntegrityFault:
    """Verdict for a LOSSY link: the suspect's frames arrive damaged (the
    observers' CRC drops, retransmits and nack round trips climb), so the
    transport's reliability layer is absorbing the fault and a
    reconfiguration would be the wrong answer. Recorded in place of a
    dead-rank miss; only a dark wire walks the exclude -> replan path."""

    op: str
    count: int
    suspect_rank: int | None
    crc_drops: int = 0
    dup_drops: int = 0
    retransmits: int = 0
    retx_misses: int = 0
    nack_round_trips: int = 0
    elapsed_s: float = 0.0
    post_mortem: dict | None = None

    def verdict(self) -> dict[str, Any]:
        """JSON-ready rendering."""
        out: dict[str, Any] = {
            "kind": "integrity_fault",
            "op": self.op,
            "count": self.count,
            "crc_drops": self.crc_drops,
            "dup_drops": self.dup_drops,
            "retransmits": self.retransmits,
            "retx_misses": self.retx_misses,
            "nack_round_trips": self.nack_round_trips,
            "elapsed_s": self.elapsed_s,
        }
        if self.suspect_rank is not None:
            out["suspect_rank"] = self.suspect_rank
        out["post_mortem_spans"] = (len(self.post_mortem.get("spans", []))
                                    if self.post_mortem else 0)
        return out

    def __str__(self) -> str:
        sus = (f" suspect r{self.suspect_rank};"
               if self.suspect_rank is not None else "")
        return (f"IntegrityFault: {self.op} count={self.count};{sus} "
                f"lossy link absorbed below the resilience layer "
                f"(crc_drops={self.crc_drops} dup_drops={self.dup_drops} "
                f"retransmits={self.retransmits} "
                f"nack_rtt={self.nack_round_trips}) — no reconfiguration")


class UncertifiedRecoveryError(RuntimeError):
    """A candidate recovery plan failed re-certification and was not
    installed."""

    def __init__(self, message: str, diagnostics: tuple = ()):
        self.diagnostics = tuple(diagnostics)
        lines = [message]
        lines += [f"  {d}" for d in self.diagnostics]
        super().__init__("\n".join(lines))


@dataclasses.dataclass(frozen=True)
class RetryBudget:
    """How long a suspect stays a straggler before it counts as dead:
    ``max_retries`` re-attempts, each after an exponential backoff."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0

    def delay_s(self, attempt: int) -> float:
        return self.backoff_base_s * self.backoff_factor ** max(attempt, 0)


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """One certified recovery schedule over a survivor world.

    ``survivors`` are global rank ids (the recovery communicator's
    members), ``world`` their count, ``plan`` the Plan resolved for the
    survivor world (``synth_key`` set when a library entry serves it), and
    ``certificate`` the proofs that ran clean; ``replan`` is the only
    constructor that fills one."""

    op: str
    survivors: tuple[int, ...]
    world: int
    count: int
    source: str  # "synthesized" | "ring"
    plan: Any
    synth_key: str = ""
    certificate: dict = dataclasses.field(default_factory=dict)
    generation: int = 0


class ResilienceManager:
    """Membership and recovery-plan state machine (module docstring).
    Thread-safe: verdicts arrive from whichever thread waited, and
    installs take the lock the readers take."""

    def __init__(self, world: int, *, policy: DeadlinePolicy | None = None,
                 budget: RetryBudget | None = None,
                 rx_buf_bytes: int = 4096,
                 max_eager_size: int = 4096,
                 tuning: TuningParams | None = None,
                 integrity_budget: int = 3):
        self.world = int(world)
        self.policy = policy
        self.budget = budget if budget is not None else RetryBudget()
        self.rx_buf_bytes = int(rx_buf_bytes)
        self.max_eager_size = int(max_eager_size)
        self.tuning = tuning if tuning is not None else TuningParams.default()
        self._mu = threading.Lock()
        self._live: tuple[int, ...] = tuple(range(self.world))
        self._attempts: dict[int | None, int] = {}
        self._misses: list[DeadlineMissed] = []
        self._current: RecoveryPlan | None = None
        self._generation = 0
        # wire-health evidence: the last snapshot per observer rank, and
        # the lossy verdicts that did not become reconfigurations.
        # integrity_budget bounds how many consecutive lossy verdicts one
        # suspect may bank before its misses walk the dead-rank budget
        # anyway: the deltas are world-wide, so a rank that dies while
        # other links are lossy would otherwise read lossy forever.
        # note_recovery resets the streak.
        self.integrity_budget = int(integrity_budget)
        self._wire_snapshots: dict[int, dict] = {}
        self._integrity_faults: list[IntegrityFault] = []
        self._integrity_streak: dict[int | None, int] = {}
        # facade shapes whose first call (building its schedule, on the
        # card its kernels) has been seen: observe_call's warm-up
        self._warmed_shapes: set[tuple] = set()

    # -- state -------------------------------------------------------------

    @property
    def live_ranks(self) -> tuple[int, ...]:
        with self._mu:
            return self._live

    @property
    def generation(self) -> int:
        with self._mu:
            return self._generation

    @property
    def current_plan(self) -> RecoveryPlan | None:
        """The installed recovery plan, read between dispatches."""
        with self._mu:
            return self._current

    @property
    def misses(self) -> tuple[DeadlineMissed, ...]:
        with self._mu:
            return tuple(self._misses)

    # -- detect ------------------------------------------------------------

    def record_miss(self, miss: DeadlineMissed) -> str:
        """Feed one deadline-miss verdict; returns the recommended action:
        "retry" while the suspect's budget lasts (sleep
        ``retry_delay_s()`` and try again), "exclude" once it is spent."""
        with self._mu:
            self._misses.append(miss)
            key = miss.suspect_rank
            n = self._attempts.get(key, 0) + 1
            self._attempts[key] = n
            return "retry" if n <= self.budget.max_retries else "exclude"

    # -- escalation: lossy link against dead rank --------------------------

    @property
    def integrity_faults(self) -> tuple[IntegrityFault, ...]:
        with self._mu:
            return tuple(self._integrity_faults)

    def observe_wire_health(self, rank: int, stats: dict) -> dict:
        """Feed one observer rank's wire-health snapshot
        (``EmuRank.wire_stats()``, ``GPUDevice.wire_stats()``) and return
        its delta since that rank's previous snapshot."""
        with self._mu:
            prev = self._wire_snapshots.get(rank, {})
            delta = {k: int(v) - int(prev.get(k, 0))
                     for k, v in stats.items()
                     if isinstance(v, (int, float))}
            self._wire_snapshots[rank] = dict(stats)
        return delta

    @staticmethod
    def classify_wire_delta(delta: dict | None) -> str:
        """"lossy" when the delta shows repair activity (any of
        ``telemetry.export.WIRE_FAULT_KEYS`` moved), else "dark": frames
        not arriving at all, a dead rank's silence."""
        from ..telemetry.export import WIRE_FAULT_KEYS

        if not delta:
            return "dark"
        return ("lossy"
                if any(int(delta.get(k, 0)) > 0 for k in WIRE_FAULT_KEYS)
                else "dark")

    def assess_miss(self, miss: DeadlineMissed,
                    wire_delta: dict | None = None) -> str:
        """The escalation decision for one miss: a lossy delta records an
        :class:`IntegrityFault` (the miss's post-mortem carried over) and
        returns "integrity" without spending the retry budget; a dark one
        goes to :meth:`record_miss`. The lossy credit is bounded per
        suspect (``integrity_budget`` consecutive verdicts, reset by
        :meth:`note_recovery`); past it the miss walks the retry/exclude
        path under a lossy reading too."""
        if self.classify_wire_delta(wire_delta) == "lossy":
            with self._mu:
                streak = self._integrity_streak.get(
                    miss.suspect_rank, 0) + 1
                self._integrity_streak[miss.suspect_rank] = streak
            if streak > self.integrity_budget:
                return self.record_miss(miss)
            d = wire_delta or {}
            fault = IntegrityFault(
                op=miss.op, count=miss.count,
                suspect_rank=miss.suspect_rank,
                crc_drops=int(d.get("crc_drops", 0)),
                dup_drops=int(d.get("dup_drops", 0)),
                retransmits=int(d.get("retx_sent", 0)),
                retx_misses=int(d.get("retx_miss", 0)),
                nack_round_trips=int(d.get("nack_rx", 0)),
                elapsed_s=miss.elapsed_s,
                post_mortem=miss.post_mortem)
            with self._mu:
                self._integrity_faults.append(fault)
                self._misses.append(miss)
            return "integrity"
        return self.record_miss(miss)

    def retry_delay_s(self, suspect_rank: int | None = None) -> float:
        with self._mu:
            return self.budget.delay_s(
                self._attempts.get(suspect_rank, 1) - 1)

    def note_recovery(self, suspect_rank: int | None = None) -> None:
        """A retry succeeded: the suspect was a straggler. Its retry
        budget and its lossy streak start afresh."""
        with self._mu:
            self._attempts.pop(suspect_rank, None)
            self._integrity_streak.pop(suspect_rank, None)

    def reset_warmup(self) -> None:
        """Forget the facade's warm-up exemptions (``ACCL.soft_reset``
        drops the built schedules, so each shape's next call rebuilds)."""
        with self._mu:
            self._warmed_shapes.clear()

    def attribute_silent(self, reporters) -> int | None:
        """Attribution by silence: the one live rank that did not report
        the wave every other survivor reported; None unless exactly one
        rank is silent."""
        with self._mu:
            silent = [r for r in self._live if r not in set(reporters)]
        return silent[0] if len(silent) == 1 else None

    # -- exclude -----------------------------------------------------------

    def exclude(self, rank: int) -> tuple[int, ...]:
        """Remove a dead rank from the live set; returns the survivors. At
        least two must remain."""
        with self._mu:
            if rank not in self._live:
                raise ValueError(f"rank {rank} is not live ({self._live})")
            survivors = tuple(r for r in self._live if r != rank)
            if len(survivors) < 2:
                raise ValueError(
                    f"excluding rank {rank} leaves {survivors}: below "
                    "the 2-rank floor a recovery plan is meaningless")
            self._live = survivors
            self._attempts.pop(rank, None)
            return survivors

    # -- re-plan + re-certify ----------------------------------------------

    def replan(self, op: Operation = Operation.allreduce, *,
               count: int, elem_bytes: int = 4,
               function: ReduceFunction = ReduceFunction.SUM,
               ) -> RecoveryPlan:
        """Build and certify a recovery schedule over the current survivor
        world, dense (communicator ranks 0..P'-1; ``survivors`` maps them
        to global ranks). A library entry whose winning window covers the
        payload on the survivor world wins, else the ring of
        select_algorithm. Every candidate runs the whole proof stack
        before the plan exists; a failure raises
        :class:`UncertifiedRecoveryError` and nothing is installed."""
        from ..sequencer import synthesis
        from ..sequencer.plan import (
            Algorithm,
            Plan,
            Protocol,
            select_algorithm,
        )

        with self._mu:
            survivors = self._live
            generation = self._generation + 1
        new_world = len(survivors)
        source, synth_key = "ring", ""
        key = synthesis.select_entry(op, new_world, count * elem_bytes)
        if key is not None:
            plan = Plan(Protocol.EAGER, Algorithm.SYNTHESIZED, count, 1,
                        synth_key=key)
            source, synth_key = "synthesized", key
        else:
            plan = select_algorithm(
                op, count, elem_bytes, new_world,
                max_eager_size=self.max_eager_size,
                eager_rx_buf_size=self.rx_buf_bytes,
                tuning=self.tuning)
        certificate = self._certify(op, plan, new_world, count,
                                    function, source, synth_key)
        return RecoveryPlan(op=op.name, survivors=survivors,
                            world=new_world, count=count, source=source,
                            plan=plan, synth_key=synth_key,
                            certificate=certificate,
                            generation=generation)

    def _certify(self, op: Operation, plan: Any, world: int, count: int,
                 function: ReduceFunction, source: str,
                 synth_key: str) -> dict:
        """The proof stack over the candidate's hop-DAG: regenerate a
        library entry's DAG, or lift the port's schedule body; then order,
        contribution sets against the collective (ACCL501-504), the
        protocol simulation, and every legal match order (ACCL205-207).
        Returns the certificate; raises on any diagnostic."""
        from ..analysis import semantics
        from ..analysis.hopdag import rank_programs, validate_order
        from ..analysis.linter import SequenceLinter
        from ..analysis.protocol import simulate
        from ..sequencer import synthesis

        opts = CallOptions(scenario=op, count=count,
                           function=int(function),
                           data_type=DataType.float32)
        if source == "synthesized":
            spec = synthesis.entry_for_key(synth_key).spec
            cert_count = synthesis.canonical_count(spec)
            dag = synthesis.instantiate(
                spec, cert_count,
                func="max" if function == ReduceFunction.MAX else "sum")
            cert_opts = dataclasses.replace(opts, count=cert_count)
        else:
            cert_count = count
            dag = semantics.lift_call(opts, plan, world)
            cert_opts = opts
        diags = list(validate_order(dag))
        diags += semantics.certify(
            dag, semantics.collective_spec(cert_opts, world), op.name)
        programs = rank_programs(dag)
        diags += simulate(programs, blocking_sends=False)
        if not diags:
            diags += SequenceLinter(world).check_interleavings(programs)
        if diags:
            raise UncertifiedRecoveryError(
                f"recovery plan ({source}, {op.name} w{world}) failed "
                f"re-certification — NOT installed:",
                tuple(diags))
        return {
            "op": op.name,
            "world": world,
            "count": cert_count,
            "source": source,
            "synth_key": synth_key,
            "checks": ["order", "semantics(ACCL501-504)",
                       "protocol-simulate",
                       "modelcheck(ACCL205-207)"],
            "diagnostics": 0,
        }

    # -- install -----------------------------------------------------------

    def install(self, plan: RecoveryPlan) -> int:
        """Publish a certified recovery plan between dispatches; the new
        generation tells executors that the next dispatch runs the new
        membership. A plan without a clean certificate, or built for
        another membership, is refused."""
        if not plan.certificate or plan.certificate.get("diagnostics") != 0:
            raise UncertifiedRecoveryError(
                "refusing to install a recovery plan without a clean "
                "certificate")
        with self._mu:
            if tuple(plan.survivors) != self._live:
                raise ValueError(
                    f"plan membership {plan.survivors} does not match "
                    f"the live set {self._live}: replan after the "
                    "membership change, not before")
            self._current = plan
            self._generation += 1
            self._attempts.clear()
            return self._generation

    # -- degraded mode -----------------------------------------------------

    def degraded_live_ranks(self) -> tuple[int, ...]:
        """The survivors in the original world's rank space: the
        ``live_ranks`` of ``allreduce(mode="live_subset")``, where the
        full-world program keeps running and dead ranks relay zeros."""
        with self._mu:
            return self._live

    # -- the facade seam (ACCL.arm_resilience) -----------------------------

    def observe_call(self, op: Operation, count: int, elem_bytes: int,
                     elapsed_s: float) -> DeadlineMissed | None:
        """Deadline check of a completed facade call: with a policy, a
        call past its deadline gives the verdict (post-mortem attached),
        recorded here; nothing is raised, the call has completed.

        The first call of each (op, count, elem_bytes) shape is a warm-up
        and is not checked: it builds the call's schedule (on the card
        also its kernels and, for a sequence, its graph), far beyond any
        wire deadline. Deadlines are a steady-state claim."""
        if self.policy is None:
            return None
        if op in (Operation.config, Operation.nop, Operation.copy,
                  Operation.combine):
            return None  # no wire, no deadline
        shape = (op, int(count), int(elem_bytes))
        with self._mu:
            if shape not in self._warmed_shapes:
                self._warmed_shapes.add(shape)
                return None
        miss = self.policy.check(op, count, elem_bytes, elapsed_s)
        if miss is not None:
            self.record_miss(miss)
        return miss
