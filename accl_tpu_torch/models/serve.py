"""Continuous-batching decode serving over the fused decode step.

Counterpart of accl_tpu/models/serve.py. One token's compute is small, so
the per-token decode step is bounded by its dispatch seams: N layers x
(consumer launches + tp allreduce launches). transformer.
record_decode_step fuses the whole step into ONE SequenceProgram dispatch
(on the card one CUDA-graph replay), and this module multiplexes
concurrent requests over that one program:

  - the batch axis is STATIC (the program is compiled once for B slots);
    requests join and leave at step boundaries only, so the steady state
    never recompiles;
  - per-slot state is one integer, the slot's position: the KV cache
    lives on the device in the program's state buffers, and a newly
    admitted request starts writing rows at pos 0; the causal mask
    (t > pos) hides the previous occupant's stale tail, so slot reuse
    needs no cache reset;
  - the prompt is fed one token per step through the SAME decode program
    (teacher-forced prefill), while the other slots keep decoding;
  - every step is measured into the telemetry registry
    (accl_serve_step_seconds, accl_serve_tokens_total,
    accl_serve_active_requests).

Batched decode is bitwise-equal to sequential per-request decode through
the same program: every per-slot computation in the step is row-
independent, so occupancy cannot leak between requests.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from ..telemetry import metrics
from . import transformer as trf


@dataclasses.dataclass
class DecodeRequest:
    """One inference request: `prompt` streams in one token per step
    (teacher-forced prefill), then up to `max_new_tokens` tokens decode
    greedily. `generated` fills as the request runs; `done` flips when
    it leaves its slot."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: DecodeRequest
    pos: int = 0  # next position to feed (== tokens consumed so far)


class DecodeServer:
    """Multiplex concurrent decode requests over one fused decode-step
    program (mode="fused") or its dispatch-per-layer eager twin
    (mode="eager", the baseline). One instance owns its ACCL facade's
    decode buffers; all requests share them, one slot each.

    `params` is the parameter tree as torch tensors (interop.
    transformer_params_from_numpy converts the JAX package's); the
    consumers hold their weights on the facade's device and the server
    keeps a host copy of the embedding for staging.

    With a `scheduler` (scheduler.MultiTenantScheduler), request admission
    goes through its backpressure (SchedulerSaturatedError before a
    request is queued) and every fused step through its metered
    `dispatch_now` as tenant `tenant` (registered at priority 0 if new):
    the same program and the same run(to_device=True), so the tokens are
    the server's without a scheduler, bit for bit."""

    def __init__(self, accl, cfg, params, *, batch: int, max_len: int,
                 mode: str = "fused", lint: str = "error",
                 registry=None, time_fn=time.perf_counter,
                 scheduler=None, tenant: str = "serve"):
        if mode not in ("fused", "eager"):
            raise ValueError(f"mode must be 'fused'|'eager', got {mode!r}")
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.mode = mode
        self._accl = accl
        self._host = {"embed": params["embed"].detach().to("cpu")}
        self._time = time_fn
        self._buffers = trf.create_decode_buffers(accl, cfg, batch, max_len)
        if mode == "fused":
            self._program, _ = trf.make_decode_step_program(
                accl, cfg, params, batch=batch, max_len=max_len,
                lint=lint, buffers=self._buffers)
        else:
            self._program = None
            trf.register_decode_consumers(accl, cfg, params,
                                          self._buffers.dims)
        self._scheduler = scheduler
        self._tenant = tenant
        self._step_cost_s: float | None = None
        if scheduler is not None:
            if tenant not in scheduler.tenants:
                scheduler.register_tenant(tenant, priority=0)
            if self._program is not None:
                self._step_cost_s = scheduler.predict_cost_s(self._program)
        self._slots: list[_Slot | None] = [None] * batch
        self._queue: deque[DecodeRequest] = deque()
        self._next_rid = 0
        self.n_steps = 0
        reg = registry if registry is not None else metrics.get_registry()
        self._m_step = reg.histogram("accl_serve_step_seconds",
                                     mode=mode, batch=batch)
        self._m_tokens = reg.counter("accl_serve_tokens_total", mode=mode)
        self._m_active = reg.gauge("accl_serve_active_requests", mode=mode)

    # -- request intake ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> DecodeRequest:
        """Queue a request; it joins the batch at the next step boundary
        with a free slot. The prompt must be non-empty and
        prompt+generation must fit the compiled max_len window."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < self.cfg.vocab for t in prompt):
            raise ValueError("prompt token outside vocab")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}")
        if self._scheduler is not None:
            # the request's predicted cost: the steps it will hold a slot
            # for, at one fused step's price; a saturated scheduler
            # refuses it here, before it is queued
            step_cost = (self._step_cost_s
                         if self._step_cost_s is not None else 1e-5)
            self._scheduler.admit_request(
                self._tenant,
                cost_s=step_cost * (len(prompt) + int(max_new_tokens)))
        req = DecodeRequest(rid=self._next_rid, prompt=prompt,
                            max_new_tokens=int(max_new_tokens))
        self._next_rid += 1
        self._queue.append(req)
        return req

    @property
    def active(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def n_active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    # -- the step loop -----------------------------------------------------

    def _admit(self) -> None:
        """Join at the step boundary: fill free slots from the queue. No
        cache reset: the joining request's pos starts at 0, and the mask
        hides everything past the rows it will itself write."""
        for i in range(self.batch):
            if self._slots[i] is None and self._queue:
                self._slots[i] = _Slot(self._queue.popleft())

    def step(self) -> int:
        """One decode step for every occupied slot: admit at the boundary,
        stage [token, pos] rows, ONE dispatch (fused), harvest argmax
        tokens, retire finished requests. Returns the number of generated
        (non-prefill) tokens this step."""
        self._admit()
        tokens = [0] * self.batch
        pos = [0] * self.batch
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue  # idle rows feed (token 0, pos 0): harmless,
                # they touch only their own slot's cache row 0
            r = slot.req
            if slot.pos < len(r.prompt):
                tokens[i] = r.prompt[slot.pos]
            else:
                tokens[i] = r.generated[-1]
            pos[i] = slot.pos
        trf.write_decode_inputs(self._buffers, self._host, tokens, pos)
        t0 = self._time()
        if self._program is not None:
            # steady state: one dispatch; the kv caches stay on the device
            if self._scheduler is not None:
                self._scheduler.dispatch_now(self._tenant, self._program,
                                             to_device=True)
            else:
                self._program.run(to_device=True)
            logits = trf.read_decode_logits(self._buffers, sync=True)
        else:
            trf.run_decode_step_eager(self._accl, self.cfg, self._buffers)
            logits = trf.read_decode_logits(self._buffers)
        dt = self._time() - t0
        nxt = torch.argmax(logits, dim=-1).tolist()
        n_generated = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            r = slot.req
            slot.pos += 1
            if slot.pos >= len(r.prompt):
                # fed the last prompt token (or a generated one): the
                # argmax is a real generated token
                r.generated.append(nxt[i])
                n_generated += 1
            if (len(r.generated) >= r.max_new_tokens
                    or slot.pos >= self.max_len):
                r.done = True
                self._slots[i] = None  # leave at the boundary
        self.n_steps += 1
        self._m_step.observe(dt)
        if n_generated:
            self._m_tokens.inc(n_generated)
        self._m_active.set(self.n_active_slots + len(self._queue))
        return n_generated

    def run(self, max_steps: int | None = None) -> int:
        """Drive steps until every request drained (or max_steps).
        Returns total generated tokens."""
        total = 0
        while self.active:
            if max_steps is not None and self.n_steps >= max_steps:
                break
            total += self.step()
        return total


def generate(server: DecodeServer, prompts, max_new_tokens: int):
    """Convenience batch API: submit every prompt, drain, return the
    generated token lists in submission order."""
    reqs = [server.submit(p, max_new_tokens) for p in prompts]
    server.run()
    return [r.generated for r in reqs]
