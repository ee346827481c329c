"""Dataflow hazard analysis over a recorded descriptor batch.

Counterpart of accl_tpu/analysis/hazards.py. Reads and writes are
tracked through the same canonical address renaming the composite
signature uses (descriptor.SequenceDescriptor.signature,
sequencer/sequence.SequencePlan): buffer addresses become indices in
first-appearance order, and every access is a prefix region of its
buffer (step results land at offset 0 with a static width,
step_out_elems; operands are read as `[..., :in_elems]` slices,
step_in_elems), so overlap is exact.

Steps are ordered only by true data dependencies (a step consuming a
buffer an earlier step produced). The reference also orders its
slot-keyed Pallas ring steps with explicit edges; the port's ring
kernel holds no slots, so it has none. Aliasing between steps not
ordered by a dependency is a hazard (even though one CUDA stream runs
the port's steps in order, an executor free to overlap independent
steps could not):

  ACCL101 raw-hazard  a read wider than what its producer wrote: the
                      consumer sees a fresh prefix spliced onto stale
                      bytes (waived for declared persistent buffers).
  ACCL102 war-hazard  a later step overwrites a buffer an earlier
                      unordered step reads.
  ACCL103 waw-hazard  two unordered steps write one buffer.
  ACCL401             a step reads a buffer as another dtype than its
                      in-sequence producer wrote.
  ACCL405             a registered buffer is narrower than the widest
                      access the batch makes to it.
  ACCL406             a step requests a compressed wire with no
                      arithmetic-configuration lane for its payload
                      dtype (e.g. blockwise int8 on an int32 operand).

A compressed step's in-sequence result is back in the payload dtype
(cast lanes decompress on arrival, the quantized lanes dequantize), so
ACCL401 keys on the descriptor's data_type on both sides, and ACCL406
separately proves the requested lane pairing exists.
"""

from __future__ import annotations

import dataclasses

from ..arithconfig import DEFAULT_ARITH_CONFIG
from ..constants import CompressionFlags, DataType, Operation
from ..sequencer.sequence import step_in_elems, step_out_elems
from .diagnostics import Diagnostic, make


@dataclasses.dataclass(frozen=True)
class _Access:
    step: int
    buf: int  # canonical buffer index
    elems: int  # prefix width
    dtype: DataType


def _accesses(steps, world):
    """Resolve each step's read/write prefix accesses under canonical
    renaming. Returns (reads, writes, rename): per-step access lists
    plus the address -> canonical-index map itself (callers translate
    address-keyed annotations like `persistent_addrs` through it)."""
    rename: dict[int, int] = {}

    def idx(addr: int) -> int:
        return rename.setdefault(addr, len(rename))

    reads: list[list[_Access]] = []
    writes: list[_Access | None] = []
    for k, opts in enumerate(steps):
        r: list[_Access] = []
        in_n = step_in_elems(opts, world)
        if opts.addr_0:
            r.append(_Access(k, idx(opts.addr_0), in_n, opts.data_type))
        if opts.scenario == Operation.combine and opts.addr_1:
            r.append(_Access(k, idx(opts.addr_1), in_n, opts.data_type))
        reads.append(r)
        if opts.addr_2:
            writes.append(_Access(k, idx(opts.addr_2),
                                  step_out_elems(opts, world),
                                  opts.data_type))
        else:
            writes.append(None)
    return reads, writes, rename


def _reachability(n: int, edges: set[tuple[int, int]]) -> list[set[int]]:
    """reach[i] = every step ordered after step i (transitive closure).
    Steps per batch are few (tens), so the quadratic closure is fine."""
    succ: list[set[int]] = [set() for _ in range(n)]
    for a, b in edges:
        succ[a].add(b)
    reach: list[set[int]] = [set() for _ in range(n)]
    # process in reverse step order: edges always point forward in the
    # batch (a dependency's producer precedes its consumer)
    for i in range(n - 1, -1, -1):
        for j in succ[i]:
            reach[i].add(j)
            reach[i] |= reach[j]
    return reach


def analyze_dataflow(
    steps,
    world: int,
    *,
    buffer_widths: dict[int, int] | None = None,
    arith_table: dict | None = None,
    persistent_addrs: frozenset[int] | set[int] = frozenset(),
) -> list[Diagnostic]:
    """Run the RAW/WAR/WAW + dtype-flow hazard pass over a batch of
    CallOptions. `buffer_widths` maps buffer ADDRESS -> registered
    element width for the static underflow check (omit when widths are
    unknown, e.g. corpus replay of a bare descriptor stream);
    `arith_table` is the ACTIVE arithmetic
    configuration the batch will lower under (an ACCL built with a
    custom table lints against ITS lanes, not the defaults — omit for
    bare-descriptor replay, where the default table is the lane set).

    `persistent_addrs` declares DEVICE-RESIDENT STATE buffers (by
    address): buffers whose tail bytes are carried from one dispatch of
    the program to the next by contract (a KV cache, an optimizer
    state). For those buffers a read wider than its in-sequence
    producer's write is the declared steady-state pattern — the stale
    tail is last dispatch's result, not a mis-recorded count — so
    ACCL101 is waived for them. Nothing else is: WAR/WAW ordering,
    dtype flow, and the static width check still apply in full, so the
    annotation cannot hide a clobber, only a deliberate partial-width
    refresh."""
    diags: list[Diagnostic] = []
    reads, writes, rename = _accesses(steps, world)
    persistent = {rename[a] for a in persistent_addrs if a in rename}
    n = len(list(steps))
    table = arith_table if arith_table is not None else DEFAULT_ARITH_CONFIG

    # pass 0: compression-lane pairing — a wire dtype only exists where
    # an arithmetic-configuration row maps (payload, wire) to lanes; the
    # quantized lanes in particular pair ONLY with fp32 payloads
    for k, opts in enumerate(steps):
        wire = opts.compress_dtype
        if (wire == DataType.none
                or not opts.compression_flags
                & CompressionFlags.ETH_COMPRESSED):
            continue
        if (opts.data_type, wire) not in table:
            kind = ("blockwise-quantized" if wire == DataType.int8
                    else "compressed")
            diags.append(make(
                "ACCL406",
                f"step {k} ({opts.scenario.name}) requests a {kind} "
                f"{wire.name} wire for a {opts.data_type.name} payload, "
                "but no arithmetic-configuration lane implements that "
                "pairing", step=k))

    # pass 1: true-dependency edges + RAW coverage / dtype-flow checks
    edges: set[tuple[int, int]] = set()
    last_write: dict[int, _Access] = {}  # canonical buf -> latest write
    widest_write: dict[int, _Access] = {}
    for k in range(n):
        for acc in reads[k]:
            w = last_write.get(acc.buf)
            if w is None:
                continue  # reads pre-sequence contents: external input
            edges.add((w.step, k))
            if acc.elems > w.elems and acc.buf not in persistent:
                wider = widest_write.get(acc.buf)
                stale = ("bytes never written in this sequence"
                         if wider is None or wider.elems <= w.elems
                         else f"step {wider.step}'s older result")
                diags.append(make(
                    "ACCL101",
                    f"step {k} ({steps[k].scenario.name}) reads "
                    f"{acc.elems} elements of buffer #{acc.buf} but its "
                    f"producer step {w.step} "
                    f"({steps[w.step].scenario.name}) wrote only "
                    f"{w.elems}; the tail is {stale}",
                    step=k))
            if (acc.dtype != w.dtype
                    and DataType.none not in (acc.dtype, w.dtype)):
                diags.append(make(
                    "ACCL401",
                    f"step {k} reads buffer #{acc.buf} as "
                    f"{acc.dtype.name} but step {w.step} wrote it as "
                    f"{w.dtype.name}; the fused program would cast "
                    "silently",
                    step=k))
        w = writes[k]
        if w is not None:  # pass 2 re-derives WAW against the full order
            last_write[w.buf] = w
            ww = widest_write.get(w.buf)
            if ww is None or w.elems > ww.elems:
                widest_write[w.buf] = w

    reach = _reachability(n, edges)

    def ordered(a: int, b: int) -> bool:
        return b in reach[a]

    # pass 2: WAR / WAW between unordered aliased steps
    writers: dict[int, list[_Access]] = {}
    readers: dict[int, list[_Access]] = {}
    for k in range(n):
        w = writes[k]
        if w is not None:
            for r in readers.get(w.buf, ()):
                if r.step != k and not ordered(r.step, k):
                    diags.append(make(
                        "ACCL102",
                        f"step {k} ({steps[k].scenario.name}) overwrites "
                        f"buffer #{w.buf} while unordered step {r.step} "
                        f"({steps[r.step].scenario.name}) reads it; an "
                        "executor overlapping independent steps can "
                        "clobber the operand mid-read",
                        step=k))
            prev = writers.get(w.buf, ())
            if prev:
                lw = prev[-1]
                if not ordered(lw.step, k):
                    diags.append(make(
                        "ACCL103",
                        f"steps {lw.step} and {k} both write buffer "
                        f"#{w.buf} with no ordering between them; final "
                        "contents depend on completion order (and step "
                        f"{lw.step}'s result is never read)",
                        step=k))
            writers.setdefault(w.buf, []).append(w)
        for r in reads[k]:
            readers.setdefault(r.buf, []).append(r)

    # pass 3: static buffer-width underflow (when widths are known)
    if buffer_widths is not None:
        rename: dict[int, int] = {}
        addr_of: dict[int, int] = {}
        for opts in steps:
            for a in (opts.addr_0, opts.addr_1, opts.addr_2):
                if a and a not in rename:
                    addr_of[len(rename)] = a
                    rename[a] = len(rename)
        need: dict[int, int] = {}
        for k in range(n):
            accs = list(reads[k])
            w = writes[k]
            if w is not None:
                accs.append(w)
            for acc in accs:
                need[acc.buf] = max(need.get(acc.buf, 0), acc.elems)
        for buf, elems in sorted(need.items()):
            addr = addr_of[buf]
            have = buffer_widths.get(addr)
            if have is not None and have < elems:
                diags.append(make(
                    "ACCL405",
                    f"buffer {addr:#x} holds {have} elements but the "
                    f"batch accesses {elems}",
                ))
    return diags
