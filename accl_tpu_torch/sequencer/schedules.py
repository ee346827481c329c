"""Collective schedules over stacked rank tensors: every one-call family
of the reference (point-to-point and alltoall(v) included), on the
exact, cast and blockwise-int8 wires.

Counterpart of accl_tpu/sequencer/schedules.py. The reference's schedules
are shard_map bodies that see one rank's (n,) buffer and move data with
lax.ppermute. Here every schedule sees the whole stacked (world, n)
tensor — row r is rank r's buffer — and a hop is a permutation along the
rank axis (dim 0). The per-rank chunk arithmetic is the reference's,
evaluated for all ranks at once, so every fold happens in the same order
and the results are bitwise equal.

Conventions kept from the reference:
  - a rank not addressed by a hop's permutation receives zeros;
  - ring neighbour order follows the communicator (next = rank+1);
  - wire compression (ETH_COMPRESSED) casts payloads to the arithmetic
    configuration's compressed dtype around every cross-rank hop; on the
    blockwise-int8 wire a hop carries (codes, scales) instead, through
    Wire.encode/hop/decode and the fused ring steps, whose kernels
    (ops/quant_kernels.py) take every rank's row in one launch.

The reference's `jnp.where(me == j, recv, out)` selections are row
selections here: a hop moves only the rows its permutation addresses
(`Wire.transfer`), and the receiving rows of the schedule's own copy of
its buffer are updated in place. Every combine and every cast is one
lane-kernel launch (ops/lane_kernels.py) over the rows of that hop.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.overrides import handle_torch_function, has_torch_function

from ..constants import QUANT_BLOCK_ELEMS, ReduceFunction
from ..ops.compression import (
    compress,
    decompress,
    dequant_combine,
    dequant_combine_requant,
    dequantize_blockwise,
    dequantize_wire,
    is_quantized,
    quantize_blockwise,
    quantize_wire,
)
from ..ops.lane_kernels import cast
from ..ops.reduce_ops import combine_op, reduce_lane


def _ring_perm(world: int, distance: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + distance) % world) for i in range(world)]


def _ring_ctx(x: torch.Tensor, world: int, ring=None, wire=None):
    """The ring a schedule runs on: (rows, pos, perm). By default the ring
    IS the rank axis: row r's position is r (the stacked tensor's form of
    lax.axis_index; wire.first + r when the rows are one process's share
    of the ranks) and a hop is the distance-1 rotation. `ring=(pos, perm)`
    embeds the same schedule onto sub-rings of a wider rank axis
    (the two-tier compositions of hierarchical.py): `pos` holds every
    row's position on its ring, [0, world), and `perm` the global (src,
    dst) row pairs of one ring hop (every sub-ring advancing in
    lockstep). The chunk arithmetic depends only on (pos, world), so one
    body serves the flat axis and every tier embedding, as in the
    reference."""
    rows = torch.arange(x.shape[0], device=x.device)
    if ring is None:
        first = 0 if wire is None else wire.first
        return rows, (rows + first if first else rows), _ring_perm(world)
    pos, perm = ring
    return rows, pos, perm


def _ring_lines(world: int, ring=None) -> list[list[int]]:
    """The rows at each ring position: entry k lists, line by line in one
    order for every k, the row at position k of each sub-ring. By default
    the ring is the rank axis (one line, row k at position k). Under
    `ring=(pos, perm)` each line is walked from its position-0 row along
    perm's hops; the table is made once per embedding, so a schedule that
    addresses a root or a position (bcast, scatter, gather, reduce) moves
    every line's rows in one operation per hop."""
    if ring is None:
        return [[k] for k in range(world)]
    pos, perm = ring
    return [list(line) for line in _lines_of(pos, tuple(perm), world)]


@functools.cache
def _lines_of(pos: torch.Tensor, perm: tuple, world: int):
    # keyed by the pos tensor itself (held by the cache, so its identity
    # stays unique); read to the host once per embedding
    where = pos.tolist()
    succ = dict(perm)
    lines = []
    for start in (r for r, p in enumerate(where) if p == 0):
        line = [start]
        while len(line) < world:
            line.append(succ[line[-1]])
        if [where[r] for r in line] != list(range(world)):
            raise ValueError("ring positions do not follow its hops")
        lines.append(line)
    return tuple(zip(*lines))


def _index(rows: list[int], device: torch.device):
    """Index of `rows` on the rank axis: a slice (a view) when they are
    consecutive, else an index tensor on `device` (a gather)."""
    if rows == list(range(rows[0], rows[0] + len(rows))):
        return slice(rows[0], rows[0] + len(rows))
    return _row_tensor(tuple(rows), device)


@functools.cache
def _row_tensor(rows: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The index tensor of a row set, made once per row set and device:
    its host-to-device copy happens at the first use only, so a body that
    has run once can be captured into a CUDA graph (a copy from pageable
    host memory cannot be captured)."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


@functools.cache
def _live_mask(live_ranks: tuple[int, ...], world: int,
               device: torch.device) -> torch.Tensor:
    """(world, 1) booleans, True on the rows of `live_ranks`; made once per
    set and device, so a captured body never copies from the host."""
    mask = torch.zeros((world, 1), dtype=torch.bool)
    mask[list(live_ranks)] = True
    return mask.to(device)


def _permute(y: torch.Tensor, perm, transfer=None) -> torch.Tensor:
    """Row dst of the result is row src of y for each (src, dst) pair of
    perm, passed through `transfer` (what crossing the wire does to the
    moved rows; nothing by default); rows no pair addresses receive
    zeros. A full rotation (the ring hop) is a roll of the rank axis."""
    world = y.shape[0]
    src = [-1] * world
    for s, d in perm:
        src[d] = s
    shift = (-src[0]) % world
    if all(src[d] == (d - shift) % world for d in range(world)):
        return torch.roll(y if transfer is None else transfer(y), shift, 0)
    dst = [d for d, s in enumerate(src) if s >= 0]
    rows = y[_index([src[d] for d in dst], y.device)]
    if len(dst) == world:  # every row receives: one gather
        return rows if transfer is None else transfer(rows)
    moved = y.new_zeros(y.shape)
    moved[_index(dst, y.device)] = (rows if transfer is None
                                   else transfer(rows))
    return moved


class Wire:
    """Per-call datapath: the wire transform around each cross-rank hop
    (cast lanes when ETH_COMPRESSED is active) and the arithmetic lane
    reductions run through.

    Cast lanes wrap each hop as compress -> permute -> decompress. The
    blockwise int8 lanes carry an encoded (codes, scales) pair instead,
    through `encode`/`hop`/`decode`, so the ring relays or fuses the
    encoded form without going through fp32 at every hop.

    Every hop a body makes goes through this class: `ppermute`, `hop`,
    `exchange`, `swap`, `permute` and `move` (row moves addressed by
    rank), and a body names the rows it writes by rank through `local`
    and `row`. Here a body holds every rank's row, row r rank r's; the
    multi-process form's ProcessWire (device/dcn_transport.py) runs the
    same bodies on one process's consecutive share of the ranks (`first`
    is the rank of its row 0) and carries the hops that leave it across
    processes."""

    # the rank of the first row a body is given
    first = 0
    # run a segmented ring's whole segments in lockstep, one hop a ring
    # step for all of them (_allreduce_lockstep); such a wire has
    # per_rank(k), itself for tensors of k consecutive rows a rank
    lockstep = False

    def __init__(self, cfg=None, arith_lane: int | None = None):
        self.cfg = cfg  # ArithConfig when wire compression is active
        self.arith_lane = arith_lane
        self.quantized = cfg is not None and is_quantized(cfg)

    def send(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.cfg is None else compress(x, self.cfg)

    def recv(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return x if self.cfg is None else decompress(x, self.cfg, out_dtype)

    def transfer(self, rows: torch.Tensor) -> torch.Tensor:
        """What a hop does to the rows it moves, as the receiver sees
        them: nothing on the exact wire; compress -> decompress on a cast
        wire; on the quantized wire the reference's encode -> pack one
        message -> unpack -> decode, where the quantize kernel writes the
        message and the dequantize kernel reads it (an all-zero message
        decodes to zeros).

        A hop's boundary: it and `exchange` take part in the torch-function
        protocol, so the analysis lifter (analysis/semantics.py) sees each
        call as one wire crossing, sent where its rows land."""
        if has_torch_function((rows,)):
            return handle_torch_function(Wire.transfer, (rows,), self, rows)
        if self.quantized:
            n = rows.shape[-1]
            return dequantize_wire(quantize_wire(rows), n, rows.dtype)
        return self.recv(self.send(rows), rows.dtype)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """One cross-rank hop of the stacked tensor: row dst of the result
        is row src of the input, through the wire, for each (src, dst)
        pair of perm; rows no pair addresses receive zeros."""
        return _permute(x, perm, self.transfer)

    def permute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """A hop with no wire transform (a synthesized DAG's recv round,
        whose encodes and casts are nodes of their own)."""
        return _permute(x, perm)

    def move(self, x: torch.Tensor, src, dst, cols=None):
        """One hop of rows: rank src[k]'s row of x (its columns `cols`)
        lands at rank dst[k] through the wire. Returns (at, rows): the
        index of the landing rows this form holds and what lands there,
        in dst's order."""
        i = _index(list(src), x.device)
        rows = x[i] if cols is None else x[i, cols]
        return _index(list(dst), x.device), self.transfer(rows)

    def move_encoded(self, x: torch.Tensor, src, dst):
        """`move` of the int8 wire's encoded form: rank src[k]'s row is
        encoded at its sender and its (codes, scales) land at dst[k] as
        one message (which round-trips the pair exactly)."""
        return (_index(list(dst), x.device),
                self.encode(x[_index(list(src), x.device)]))

    def local(self, ranks, device: torch.device):
        """The index of the rows of `ranks` this form holds."""
        return _index(list(ranks), device)

    def row(self, rank: int) -> int | None:
        """The row of `rank`, None when this form does not hold it."""
        return rank

    def swap(self, grid: torch.Tensor) -> torch.Tensor:
        """The [rank, slot] transpose of a (rank, slot, ...) grid: slot s
        of rank r to slot r of rank s, no wire transform."""
        return grid.transpose(0, 1).contiguous()

    def combine(self, func: ReduceFunction, a: torch.Tensor,
                b: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """Elementwise reduction through the configured arith lane;
        `out_dtype` rounds a fp16/bf16 lane's result once to that dtype."""
        if self.arith_lane is not None:
            return reduce_lane(self.arith_lane, a, b, out_dtype)
        if out_dtype not in (None, a.dtype):
            raise TypeError(f"a {a.dtype} combine cannot emit {out_dtype}")
        return combine_op(func, a, b)

    # -- quantized-wire datapath (compressor lanes 4/5) --------------------

    def encode(self, x: torch.Tensor):
        """fp32 rows -> (int8 codes, per-block fp32 scales)."""
        return quantize_blockwise(x)

    def hop(self, enc, perm):
        """Permute an encoded payload: codes and scales cross the same
        hop, len(codes) + 4 * n_blocks bytes per rank."""
        q, s = enc
        return _permute(q, perm), _permute(s, perm)

    def exchange(self, enc, world: int):
        """The block-aligned int8 exchange's hops: slot s of rank r's codes
        and scales go to slot r of rank s, one transpose of each. The
        reference ships each hop's codes and scales as one packed message,
        which the bytes round-trip exactly."""
        if has_torch_function(enc):
            return handle_torch_function(Wire.exchange, enc, self, enc, world)
        return tuple(_exchange_slots(t, world) for t in enc)

    def decode(self, enc, n: int, out_dtype: torch.dtype) -> torch.Tensor:
        q, s = enc
        return dequantize_blockwise(q, s, n, out_dtype)

    def combine_decoded(self, func: ReduceFunction, enc,
                        local: torch.Tensor) -> torch.Tensor:
        """Fused dequantize -> reduce (terminal ring hop): fp32
        accumulation of an encoded arrival against the local operand."""
        q, s = enc
        return dequant_combine(q, s, local, quant_op(func))

    def combine_requant(self, func: ReduceFunction, enc, local: torch.Tensor):
        """Fused dequantize -> reduce -> requantize (interior ring step):
        only (codes, scales) travel to the next hop."""
        q, s = enc
        return dequant_combine_requant(q, s, local, quant_op(func))


def quant_op(func: ReduceFunction) -> str:
    """The quantized kernels' name of a reduce function."""
    return "sum" if func == ReduceFunction.SUM else "max"


def _exchange_slots(t: torch.Tensor, world: int) -> torch.Tensor:
    """Slot s of row r to slot r of row s: the transpose of the [rank,
    slot] grid of the last dimension (leading dimensions ride along)."""
    return t.reshape(world, *t.shape[1:-1], world,
                     t.shape[-1] // world).transpose(0, -2).reshape(t.shape)


def _fast_log2(x: int) -> int:
    return x.bit_length() - 1


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def copy_schedule(x: torch.Tensor, *, world: int, wire: Wire) -> torch.Tensor:
    """The result is a tensor of its own: a buffer's device image is
    mutable here, so it must not alias the source's."""
    return x.clone()


def combine_schedule(x: torch.Tensor, y: torch.Tensor, *, func, world: int,
                     wire: Wire) -> torch.Tensor:
    return wire.combine(func, x, y)


def sendrecv_schedule(x: torch.Tensor, *, src: int, dst: int, world: int,
                      wire: Wire) -> torch.Tensor:
    """Point-to-point: dst's output is src's buffer, every other rank
    keeps its input."""
    out = x.clone()
    if src == dst:
        return out
    at, got = wire.move(x, [src], [dst])
    out[at] = got
    return out


def fused_recv_reduce(acc: torch.Tensor, recv: torch.Tensor, rows,
                      func, wire: Wire) -> torch.Tensor:
    """The fused recv-reduce primitive: combine the partials that arrived
    at the accumulator's rows `rows` (an index; recv holds one row per
    receiver, in order) into the accumulator on those rows only, through
    the configured arith lane — combine(acc, recv), the reference's
    operand order. A lane of another dtype than the accumulator's (a bf16
    lane over fp32 buffers) is widened back, as the reference's select
    promotes it. Updates the schedule's own accumulator in place and
    returns it."""
    acc[rows] = cast(wire.combine(func, acc[rows], recv), acc.dtype)
    return acc


# `at` of a move that lands on no row this form holds
_NOWHERE = slice(0, 0)


def _hop_reduce(acc: torch.Tensor, src: torch.Tensor, senders, receivers,
                func, wire: Wire) -> torch.Tensor:
    """One hop of the partials held by the ranks `senders` (rows of
    `src`) to the ranks `receivers`, one sender a receiver, folded into
    the accumulator there. On the quantized wire the arrival's decode and
    the fold are one step (the fused dequantize-combine): XLA contracts
    the reference's decode multiply and its SUM add into one fused
    multiply-add. The reference packs the encoded pair into one message
    and unpacks it; the bytes round-trip exactly, so the pair is folded
    as encoded."""
    if not wire.quantized:
        at, got = wire.move(src, senders, receivers)
        if at is not _NOWHERE:
            fused_recv_reduce(acc, got, at, func, wire)
        return acc
    at, enc = wire.move_encoded(src, senders, receivers)
    if at is not _NOWHERE:
        acc[at] = wire.combine_decoded(func, enc, acc[at])
    return acc


def _tree_round(world: int, root: int, d: int, up: bool):
    """The (src, dst) pairs of one binomial-tree round at distance d, in
    ranks: toward the root (normalized ln -> ln-d, ln = d mod 2d) or away
    from it (ln -> ln+d, ln = 0 mod 2d)."""
    if up:
        return [((ln + root) % world, (ln - d + root) % world)
                for ln in range(d, world, 2 * d)]
    return [((ln + root) % world, (ln + d + root) % world)
            for ln in range(0, world, 2 * d) if ln + d < world]


# ---------------------------------------------------------------------------
# broadcast family
# ---------------------------------------------------------------------------


def bcast_flat_schedule(x: torch.Tensor, *, root: int, world: int,
                        wire: Wire, ring=None) -> torch.Tensor:
    """Flat fan-out: root sends its buffer to each rank with one hop per
    destination (W-1 hops). Under `ring` (_ring_lines) the root is a
    position on every line and each hop serves all lines."""
    lines = _ring_lines(world, ring)
    out = x.clone()
    for j in range(world):
        if j != root:
            at, got = wire.move(x, lines[root], lines[j])
            out[at] = got
    return out


def bcast_bin_tree_schedule(x: torch.Tensor, *, root: int, world: int,
                            wire: Wire) -> torch.Tensor:
    """Distance-doubling binary tree: the sender set doubles each round;
    round distances run d = 2^floor(log2(W-1)) .. 1, and each round is one
    hop of every sender's row."""
    x = x.clone()
    d = 1 << _fast_log2(world - 1)
    while d > 0:
        src, dst = zip(*_tree_round(world, root, d, up=False))
        at, got = wire.move(x, src, dst)
        x[at] = got
        d >>= 1
    return x


# ---------------------------------------------------------------------------
# scatter / gather family
# ---------------------------------------------------------------------------


def scatter_schedule(x: torch.Tensor, *, root: int, world: int,
                     wire: Wire, ring=None) -> torch.Tensor:
    """Root holds world*count elements; rank j receives chunk j (one hop
    per destination). Root keeps its own chunk root. x is (rows,
    world*count), the result (rows, count); `ring` as in
    bcast_flat_schedule."""
    count = x.shape[-1] // world
    lines = _ring_lines(world, ring)
    own = wire.local(lines[root], x.device)
    out = x.new_empty((x.shape[0], count))
    out[own] = x[own, root * count:(root + 1) * count]
    for j in range(world):
        if j != root:
            at, got = wire.move(x, lines[root], lines[j],
                                slice(j * count, (j + 1) * count))
            out[at] = got
    return out


def gather_ring_schedule(x: torch.Tensor, *, root: int, world: int,
                         wire: Wire, ring=None) -> torch.Tensor:
    """Eager daisy-chain gather: every rank relays its upstream
    neighbours' chunks around the ring; root collects W-1 chunks in
    arrival order (the step-s arrival originates from rank root-1-s).
    Every rank's result holds its own chunk at slot root. x is (rows,
    count), the result (rows, world*count); `ring` as in
    bcast_flat_schedule."""
    count = x.shape[-1]
    perm = _ring_perm(world) if ring is None else ring[1]
    dst = wire.local(_ring_lines(world, ring)[root], x.device)
    out = x.new_zeros((x.shape[0], world, count))
    out[:, root] = x
    relay = x
    for s in range(world - 1):
        recv = wire.ppermute(relay, perm)
        out[dst, (root - 1 - s) % world] = recv[dst]
        relay = recv
    return out.reshape(x.shape[0], world * count)


def gather_flat_schedule(x: torch.Tensor, *, root: int, world: int,
                         wire: Wire, fanin: int) -> torch.Tensor:
    """Rendezvous gather. With unbounded fan-in every rank sends straight
    to root (W-1 hops); with the tuning cap it is a binomial combining
    tree: at distance d the normalized ranks ln = d mod 2d send their
    whole accumulated buffer to ln-d, which keeps the chunks of the
    sender's subtree [ln, min(ln+d, W)). Every rank's result starts as
    zeros with its own chunk at its own slot."""
    count = x.shape[-1]
    rows, me, _ = _ring_ctx(x, world, wire=wire)
    out = x.new_zeros((x.shape[0], world, count))
    out[rows, me] = x
    if fanin >= world - 1:
        for j in range(world):
            if j != root:
                at, got = wire.move(x, [j], [root])
                out[at, j] = got
        return out.reshape(x.shape[0], world * count)
    flat = out.view(x.shape[0], world * count)
    d = 1
    while d < world:
        pairs = _tree_round(world, root, d, up=True)
        _, recv = wire.move(flat, [c for c, _ in pairs],
                            [p for _, p in pairs])
        for (child, parent), row in zip(
                [cp for cp in pairs if wire.row(cp[1]) is not None], recv):
            ln = (child - root) % world
            sub = _index([(root + k) % world
                          for k in range(ln, min(ln + d, world))], x.device)
            out[wire.row(parent), sub] = row.view(world, count)[sub]
        d *= 2
    return flat


def _chunks(x: torch.Tensor, world: int) -> torch.Tensor:
    """(rows, world*count) -> (rows, world, count): [row, chunk]."""
    return x.reshape(x.shape[0], world, x.shape[-1] // world)


def reduce_scatter_ring_schedule(x: torch.Tensor, *, func, world: int,
                                 wire: Wire,
                                 out_dtype: torch.dtype | None = None,
                                 ring=None) -> torch.Tensor:
    """Ring reduce-scatter: W-1 steps; at step s each rank combines the
    arriving partial with its local copy of chunk me-2-s and forwards;
    rank r ends holding reduced chunk r. x is (rows, world*count), the
    result (rows, count). `out_dtype` has the last fold round once to
    that dtype instead of x's (the fused combine+cast); `ring` embeds
    the ring onto sub-rings (_ring_ctx)."""
    if wire.quantized:
        return _reduce_scatter_ring_quant(x, func=func, world=world,
                                          wire=wire, ring=ring)
    rows, me, perm = _ring_ctx(x, world, ring, wire)
    xs = _chunks(x, world)
    v = xs[rows, (me - 1) % world]
    for s in range(world - 1):
        recv = wire.ppermute(v, perm)
        last = s == world - 2
        v = wire.combine(func, recv, xs[rows, (me - 2 - s) % world],
                         out_dtype if last else None)
    return v


def allgather_ring_schedule(x: torch.Tensor, *, world: int, wire: Wire,
                            ring=None) -> torch.Tensor:
    """Ring allgather: W-1 relay steps; the step-s arrival originates from
    rank me-1-s. x is (rows, count), the result (rows, world*count);
    `ring` embeds the ring onto sub-rings (_ring_ctx)."""
    if wire.quantized:
        return _allgather_ring_quant(x, world=world, wire=wire, ring=ring)
    rows, me, perm = _ring_ctx(x, world, ring, wire)
    count = x.shape[-1]
    out = x.new_zeros((x.shape[0], world, count))
    out[rows, me] = x
    relay = x
    for s in range(world - 1):
        recv = wire.ppermute(relay, perm)
        out[rows, (me - 1 - s) % world] = recv
        relay = recv
    return out.reshape(x.shape[0], world * count)


def _reduce_scatter_ring_quant(x: torch.Tensor, *, func, world: int,
                               wire: Wire, ring=None) -> torch.Tensor:
    """Quantized ring reduce-scatter: the travelling partial stays encoded
    between hops while every interior combine runs the fused dequantize
    -> reduce (fp32) -> requantize step; the terminal hop lands the fp32
    partial (W-1 quantization passes on a partial's path)."""
    rows, me, perm = _ring_ctx(x, world, ring, wire)
    xs = _chunks(x, world)
    out = xs[rows, (me - 1) % world]
    if world == 1:  # no hop: the local chunk (the reference's encode is dead)
        return out
    enc = wire.encode(out)
    for s in range(world - 1):
        enc = wire.hop(enc, perm)
        local = xs[rows, (me - 2 - s) % world]
        if s < world - 2:
            enc = wire.combine_requant(func, enc, local)
        else:
            out = wire.combine_decoded(func, enc, local)
    return out


def _allgather_ring_quant(x: torch.Tensor, *, world: int, wire: Wire,
                          ring=None) -> torch.Tensor:
    """Quantized ring allgather: each rank encodes its chunk once and the
    (codes, scales) pair relays unchanged. The local chunk takes the same
    encode/decode round trip as the remote copies, which is what makes
    the quantized allreduce's result identical on every rank."""
    rows, me, perm = _ring_ctx(x, world, ring, wire)
    count = x.shape[-1]
    out = x.new_zeros((x.shape[0], world, count))
    enc = wire.encode(x)
    out[rows, me] = wire.decode(enc, count, x.dtype)
    for s in range(world - 1):
        enc = wire.hop(enc, perm)
        out[rows, (me - 1 - s) % world] = wire.decode(enc, count, x.dtype)
    return out.reshape(x.shape[0], world * count)


# ---------------------------------------------------------------------------
# reduction family
# ---------------------------------------------------------------------------


def reduce_ring_schedule(x: torch.Tensor, *, root: int, func, world: int,
                         wire: Wire, ring=None) -> torch.Tensor:
    """Eager ring reduce: the partial relays around the ring from root+1,
    each hop a fused recv-reduce at the next rank, ending at root; `ring`
    as in bcast_flat_schedule."""
    lines = _ring_lines(world, ring)
    acc = x.clone()
    for s in range(world - 1):
        sender = (root + 1 + s) % world
        receiver = (sender + 1) % world
        _hop_reduce(acc, acc, lines[sender], lines[receiver], func, wire)
    return acc


def reduce_flat_schedule(x: torch.Tensor, *, root: int, func, world: int,
                         wire: Wire, ring=None) -> torch.Tensor:
    """Rendezvous flat-tree reduce: each child sends its buffer straight
    to root, which folds the arrivals into its accumulator in rank
    order; `ring` as in bcast_flat_schedule."""
    lines = _ring_lines(world, ring)
    acc = x.clone()
    for j in range(world):
        if j != root:
            _hop_reduce(acc, x, lines[j], lines[root], func, wire)
    return acc


def reduce_bin_tree_schedule(x: torch.Tensor, *, root: int, func,
                             world: int, wire: Wire) -> torch.Tensor:
    """Rendezvous binomial-tree reduce: at distance d the normalized ranks
    ln = d mod 2d send their partials to ln-d; ceil(log2 W) rounds, each
    one hop and one combine over every parent's row."""
    acc = x.clone()
    d = 1
    while d < world:
        src, dst = zip(*_tree_round(world, root, d, up=True))
        _hop_reduce(acc, acc, src, dst, func, wire)
        d *= 2
    return acc


def allreduce_ring_schedule(x: torch.Tensor, *, func, world: int, wire: Wire,
                            seg_count: int, ring=None,
                            live_ranks=None) -> torch.Tensor:
    """Segmented ring allreduce: per segment, a ring reduce-scatter over
    world-size chunks followed by a ring allgather; `ring` embeds both
    onto sub-rings (_ring_ctx). A stripe-overlapped plan's stripes are
    its segments (seg_count = the stripe width).

    `live_ranks` (the degraded live-subset mode, Plan.live_ranks) declares
    the surviving contributors: every other rank's row is masked to exact
    zeros here, at the source, before any hop, so the folds accumulate
    exactly the survivors' data and the certifier can hold the lifted
    body to the survivor sum (a dead rank's stale buffer never leaks a
    ghost contribution). Every rank still relays its ring position; SUM
    only, where zero is the fold's identity (the facade enforces it).

    On a `wire.lockstep` wire the whole segments run in lockstep
    (_allreduce_lockstep)."""
    if live_ranks is not None:
        x = torch.where(_live_mask(tuple(live_ranks), world, x.device), x,
                        torch.zeros_like(x))

    def one_segment(seg: torch.Tensor, wire=wire, ring=ring) -> torch.Tensor:
        padded = _pad_to_multiple(seg, world)
        red = reduce_scatter_ring_schedule(padded, func=func, world=world,
                                           wire=wire, ring=ring)
        gathered = allgather_ring_schedule(red, world=world, wire=wire,
                                           ring=ring)
        return gathered[:, : seg.shape[-1]]

    if wire.lockstep and ring is None and live_ranks is None:
        return _allreduce_lockstep(one_segment, x, world, wire, seg_count)
    return segmented_apply(one_segment, x, seg_count)


def _allreduce_lockstep(one_segment: Callable, x: torch.Tensor, world: int,
                        wire: Wire, seg_count: int) -> torch.Tensor:
    """The segmented ring with its whole segments in lockstep: each rank's
    k whole segments become k rows of its own (rank r's rows r*k ..
    r*k+k-1 at ring position r), so one ring body runs every segment and
    each of its hops carries that step's chunk of all of them (one message
    a peer a step across processes, not k). Segments are independent and
    every fold, cast and int8 block stays within one row, so each element
    is folded as in the per-segment loop, bitwise; a ragged last segment
    runs on its own."""
    count, rows = x.shape[-1], x.shape[0]
    k = count // seg_count
    if k < 2:
        return _segmented_apply(one_segment, x, seg_count)
    head = k * seg_count
    _, pos, perm = _ring_ctx(x, world, wire=wire)
    out = one_segment(x[:, :head].reshape(rows * k, seg_count),
                      wire.per_rank(k),
                      (pos.repeat_interleave(k), perm)).reshape(rows, head)
    if head == count:
        return out
    return torch.cat([out, one_segment(x[:, head:])], dim=-1)


def segmented_apply(one_segment: Callable, x: torch.Tensor, seg_count: int,
                    overlap_slots: int = 0) -> torch.Tensor:
    """Apply a per-segment schedule over the rank buffers in
    seg_count-element column pieces (the eager segmentation substrate);
    the last piece takes the ragged tail.

    overlap_slots=k calls one_segment(seg, slot) with segment i in slot
    i%k, for bodies whose resources come in k slots (the slot-keyed ring
    kernel). The reference orders only slot reuse so k segments can be in
    flight; PyTorch issues the segments in order on one stream, which
    keeps that ordering.

    It takes part in the torch-function protocol, so the analysis lifter
    can tell which segments the reference maps with one body."""
    if has_torch_function((x,)):
        return handle_torch_function(segmented_apply, (x,), one_segment, x,
                                     seg_count, overlap_slots)
    return _segmented_apply(one_segment, x, seg_count, overlap_slots)


def _segmented_apply(one_segment: Callable, x: torch.Tensor, seg_count: int,
                     overlap_slots: int = 0) -> torch.Tensor:
    count = x.shape[-1]
    if count <= seg_count:
        return one_segment(x, 0) if overlap_slots else one_segment(x)
    outs = []
    for i, lo in enumerate(range(0, count, seg_count)):
        seg = x[..., lo: lo + seg_count]
        outs.append(one_segment(seg, i % overlap_slots) if overlap_slots
                    else one_segment(seg))
    return torch.cat(outs, dim=-1)


def _pad_to_multiple(x: torch.Tensor, m: int) -> torch.Tensor:
    rem = (-x.shape[-1]) % m
    if rem:
        x = torch.nn.functional.pad(x, (0, rem))
    return x


# ---------------------------------------------------------------------------
# all-to-all
# ---------------------------------------------------------------------------


def alltoall_schedule(x: torch.Tensor, *, world: int,
                      wire: Wire) -> torch.Tensor:
    """Pairwise rotation exchange: at step k every rank sends slot me+k to
    rank me+k and files the arrival from rank me-k into slot me-k; W-1
    steps cover all peers. x and the result are (world, *lead,
    world*count): each (rank, lead) row is one buffer of the exchange, so
    leading dimensions between the rank axis and the slots (the sequences
    an MoE body vmaps the exchange over, a mesh's other axes:
    parallel/collectives.py) ride along, each row blocked on its own.

    Together the W-1 steps put slot s of rank r into slot r of rank s: a
    transpose of the [rank, slot] grid, which is how the exact and cast
    wires run it (a cast is elementwise, so casting every moved slot at
    once is bitwise the per-hop casts). The local slot crosses no wire
    and stays exact. On the blockwise-int8 wire every moved slot takes
    one quantization pass: hop by hop (one encode and one decode of
    every rank's slot a hop) unless the slot is a whole number of
    blocks, when the whole buffer is encoded and decoded once
    (`_alltoall_quant_aligned`)."""
    count = x.shape[-1] // world
    # [rank, slot, *lead, elem]
    grid = x.reshape(*x.shape[:-1], world, count).movedim(-2, 1)
    if wire.quantized:
        if count % QUANT_BLOCK_ELEMS == 0:
            return _alltoall_quant_aligned(x, world=world, wire=wire)
        rows, me, _ = _ring_ctx(x, world, wire=wire)
        out = torch.zeros_like(grid)
        out[rows, me] = grid[rows, me]
        for k in range(1, world):
            _alltoall_hop(out, grid[rows, (me + k) % world], k, wire, rows,
                          me)
        return out.movedim(1, -2).reshape(x.shape)
    out = wire.swap(grid)
    if wire.cfg is not None:
        rows, me, _ = _ring_ctx(x, world, wire=wire)
        out = wire.transfer(out)
        out[rows, me] = grid[rows, me]
    return out.movedim(1, -2).reshape(x.shape)


def _alltoall_hop(out: torch.Tensor, sent: torch.Tensor, k: int,
                  wire: Wire, rows: torch.Tensor, me: torch.Tensor) -> None:
    """Step k of the rotation: `sent` holds, per row (its rank in `me`),
    the (prefix of the) slot it sends to rank me+k; each arrival lands in
    slot me-k of its receiver's row of the [rank, slot, *lead, elem] grid
    `out`."""
    world = out.shape[1]
    recv = wire.ppermute(sent, _ring_perm(world, k))  # from rank me-k
    out[rows, (me - k) % world, ..., :sent.shape[-1]] = recv


def _alltoall_quant_aligned(x: torch.Tensor, *, world: int,
                            wire: Wire) -> torch.Tensor:
    """The block-aligned int8 exchange: with the slot a whole number of
    quantization blocks, blocks never span slots, so one encode of the
    whole send buffer gives every slot's codes and scales bitwise. Each
    hop moves its slice of codes and scales (the reference ships it as
    one packed message, which round-trips exactly; on one card the W-1
    hops are one transpose of each), and the received buffer is decoded
    once. The local slot is spliced in exact after the decode."""
    count = x.shape[-1] // world
    lead = x.shape[1:-1]
    out = wire.decode(wire.exchange(wire.encode(x), world), x.shape[-1],
                      x.dtype)
    rows, me, _ = _ring_ctx(x, world, wire=wire)
    grid = x.reshape(x.shape[0], *lead, world, count).movedim(-2, 1)
    out.view(x.shape[0], *lead, world, count).movedim(-2, 1)[rows, me] = \
        grid[rows, me]
    return out


def alltoallv_schedule(x: torch.Tensor, *, peer_counts, world: int,
                       wire: Wire) -> torch.Tensor:
    """Capacity-bounded pairwise exchange, the MoE dispatch's alltoallv:
    the dense alltoall's slot layout (count elements a slot), but peer p
    takes only the first peer_counts[p] elements of each source's slot p
    (its capacity), and the rest of every slot is zero: the overflow is
    dropped at the source. Every hop moves vmax = max(peer_counts)
    elements. The local slot crosses no wire and stays exact; on the
    int8 wire each moved prefix is encoded at its source and decoded at
    its destination, hop by hop."""
    count = x.shape[-1] // world
    counts = tuple(int(c) for c in peer_counts)
    if len(counts) != world:
        raise ValueError(
            f"alltoallv needs one peer count per rank: got {len(counts)} "
            f"for world {world}")
    if any(c <= 0 or c > count for c in counts):
        raise ValueError(
            f"peer counts {counts} outside (0, {count}] slot capacity")
    vmax = max(counts)
    grid = x.reshape(world, world, count)[..., :vmax]
    me = torch.arange(world, device=x.device)
    # valid[p, e]: element e lies inside peer p's capacity
    valid = (torch.arange(vmax, device=x.device)
             < _row_tensor(counts, x.device)[:, None])
    if wire.quantized:
        out = x.new_zeros((world, world, count))
        out[me, me, :vmax] = torch.where(valid, grid[me, me], 0)
        for k in range(1, world):
            dst = (me + k) % world
            _alltoall_hop(out, torch.where(valid[dst], grid[me, dst], 0), k,
                          wire, me, me)
        return out.reshape(x.shape)
    # rank r's slot s holds source s's slot r, cut to r's capacity
    moved = torch.where(valid[:, None], grid.transpose(0, 1), 0)
    if wire.cfg is not None:
        own = moved[me, me]
        moved = wire.transfer(moved)
        moved[me, me] = own
    if vmax == count:
        return moved.reshape(x.shape)
    out = x.new_zeros((world, world, count))
    out[..., :vmax] = moved
    return out.reshape(x.shape)


class SlotRows:
    """The layout of a slot-driven alltoallv, bound at record time: device
    tensors that a producer earlier in the same dispatch writes on the
    card (an MoE router, say), and that the exchange reads there, so
    that no count crosses to the host.

    The exchange moves rows of `width` elements. Each (rank s, token t)
    of the token side has `slots` slots; `slot_row[s, t, k]` is the row
    of the slot side, flat over the ranks (rank d's rows are
    d * rows_per_rank .. (d + 1) * rows_per_rank - 1), that slot k
    occupies, or -1 when the slot moves nothing. Every row that no slot
    names is left unwritten.

    `mode` "scatter": the operand is the token side (tokens rows a rank),
    the result the slot side (rows_per_rank rows a rank), each token row
    copied to its slots' rows. "gather": the reverse, each token row the
    sum of its slots' rows, each times `weight[s, t, k]`, in slot order.
    Both sides are sized for the worst case the producer allows, so
    nothing is ever dropped. The object's identity keys the compiled
    program: re-recording with the same layout builds nothing."""

    MODES = ("scatter", "gather")
    _made = 0

    def __init__(self, mode: str, *, width: int, tokens: int,
                 rows_per_rank: int, slot_row: torch.Tensor,
                 weight: torch.Tensor | None = None):
        if mode not in self.MODES:
            raise ValueError(f"slot alltoallv mode {mode!r}")
        if slot_row.dim() != 3 or slot_row.dtype != torch.int32:
            raise ValueError("slot_row: an int32 (world, tokens, slots) "
                             f"tensor, got {slot_row.dtype} "
                             f"{tuple(slot_row.shape)}")
        if slot_row.shape[1] != tokens:
            raise ValueError(f"slot_row {tuple(slot_row.shape)} for "
                             f"{tokens} tokens a rank")
        if mode == "gather" and (weight is None
                                 or weight.shape != slot_row.shape):
            raise ValueError("a gather layout needs a weight of slot_row's "
                             "shape")
        self.mode, self.width, self.tokens = mode, int(width), int(tokens)
        self.rows_per_rank = int(rows_per_rank)
        self.slot_row, self.weight = slot_row, weight
        SlotRows._made += 1
        self._label = SlotRows._made

    @property
    def in_rows(self) -> int:
        """Rows a rank of the operand holds."""
        return self.tokens if self.mode == "scatter" else self.rows_per_rank

    @property
    def out_rows(self) -> int:
        """Rows a rank of the result holds."""
        return self.rows_per_rank if self.mode == "scatter" else self.tokens

    def __repr__(self) -> str:
        return (f"SlotRows#{self._label}({self.mode}, width={self.width}, "
                f"{self.in_rows}->{self.out_rows} rows)")


def slot_alltoallv_schedule(x: torch.Tensor, *, layout: SlotRows,
                            world: int, wire: Wire) -> torch.Tensor:
    """The slot-driven alltoallv (a dropless MoE exchange, for one): each
    row moves where the layout's device tensors place it (SlotRows), in
    one kernel launch that touches only the rows a slot names
    (ops/moe_kernels.dispatch_rows, combine_rows). On a cast wire every
    moved row crosses it once: the scatter casts its token rows at the
    source, the gather the slot rows before they are summed; a row that
    stays on its rank crosses it too. The int8 wire is refused. While
    the layer gate is open the body is a `slot_scatter` or `slot_gather`
    layer span (on the card: at warm-up and capture, never at a
    replay)."""
    from ..ops.moe_kernels import combine_rows, dispatch_rows

    if wire.quantized:
        raise NotImplementedError(
            "the slot-driven alltoallv has no blockwise-int8 wire")
    if layout.slot_row.shape[0] != world or x.shape[0] != world:
        raise ValueError(f"slot alltoallv over {x.shape[0]} rows for "
                         f"world {world}")
    from ..telemetry import get_tracer

    with get_tracer().layer(f"slot_{layout.mode}", rows=layout.out_rows):
        x = wire.transfer(x) if wire.cfg is not None else x
        if layout.mode == "scatter":
            return dispatch_rows(x, layout.slot_row, layout.rows_per_rank)
        return combine_rows(x, layout.slot_row, layout.weight, layout.width)


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------


def barrier_schedule(token: torch.Tensor, *, world: int,
                     wire: Wire, ring=None) -> torch.Tensor:
    """Notification-only gather-to-0 and fan-out: the zero-payload
    messages are carried as a 1-element token per rank, reduced to rank 0
    and broadcast back (to position 0 of every line under `ring`)."""
    gathered = reduce_flat_schedule(token, root=0, func=ReduceFunction.SUM,
                                    world=world, wire=wire, ring=ring)
    return bcast_flat_schedule(gathered, root=0, world=world, wire=wire,
                               ring=ring)
