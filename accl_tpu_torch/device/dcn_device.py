"""DCNDevice: the multi-host backend over a two-tier (dcn, ici) world.

Counterpart of accl_tpu/device/dcn_device.py. The reference's third
backend spans hosts: one process per host joins jax.distributed, and a
compiled two-tier program keeps intra-host traffic on the inner (ICI)
tier and crosses hosts on the outer (DCN) tier. Global rank = process *
local + device (process-major, RankMap "outer_major"). Collectives with a
two-tier decomposition (HIER_OPS) lower to sequencer/hierarchical.py's
compositions, so the slow tier carries 1/inner_world of an allreduce's
traffic; every other call lowers flat over the combined (outer, inner)
world.

The port runs it in two forms, through one composition body each:

  - in-process, `DCNDevice(mesh=make_mesh({"dcn": P, "ici": L}, ...))`:
    the P*L ranks are virtual ranks of one card (stacked (world, n)
    buffers) and both tiers run the stacked ring schedules along one axis
    of the (P, L) world;
  - multi-process, `DCNDevice(num_processes, process_id,
    coordinator_address, local_device_count)`: one OS process per host,
    each owning local_device_count ranks (one or more). A composition's
    inner tier stays inside the process and its outer tier crosses
    processes over torch.distributed; every other call, and every step of
    a call sequence, runs the flat body over the combined world on the
    process's rows, its cross-process hops over the same transport
    (device/dcn_transport.py: ProcessTier and ProcessWorld). `link=`
    picks how a hop crosses: "ipc" (the default on cuda) writes it device
    to device into a region the peer process mapped, as the reference's
    device runtime moves it; "gloo" (the default on the CPU) stages it
    through the host.

Departures from the reference, each with its reason:
  - `torch_device` ("cuda" unless the caller asks for "cpu") takes the
    place of the reference's `platform=`;
  - every process holds every buffer's full (world, n) image, as the
    reference's host mirror does, and only its own rows are authoritative
    (no call writes a remote row): a buffer costs P times its share;
  - `link=` is an addition. The ipc link maps a peer's region with CUDA
    IPC, so it needs every process on one host (the card's form of a
    device-resident hop); its CPU form, for the tests, maps files under
    /dev/shm. On the gloo link, which moves CPU tensors only, a
    cross-process hop is staged through the host (the folds stay on the
    card);
  - the multi-process form's flat segmented ring runs its whole segments
    in lockstep (one message a peer a ring step for all of them; each
    element folds as in the segment loop, bitwise);
  - a call sequence of the multi-process form runs eagerly at each
    dispatch (DCNCompiler.sequence_graph): a CUDA graph cannot capture a
    hop's host token (ipc) or its host staging (gloo);
  - the degraded live-subset allreduce is refused (supports_live_subset
    False): the reference's compositions drop the plan's survivor mask.
"""

from __future__ import annotations

import functools

import torch

from ..constants import DataType, Operation, ReduceFunction
from ..buffers import GPUBuffer
from ..parallel.mesh import Mesh
from ..request import BaseRequest
from ..sequencer.hierarchical import (
    RankMap,
    StackedTier,
    hierarchical_allgather_schedule,
    hierarchical_allreduce_schedule,
    hierarchical_alltoall_schedule,
    hierarchical_barrier_schedule,
    hierarchical_bcast_schedule,
    hierarchical_gather_schedule,
    hierarchical_reduce_schedule,
    hierarchical_reduce_scatter_schedule,
    hierarchical_scatter_schedule,
    stacked_tiers,
)
from ..sequencer import schedules
from ..sequencer.lowering import (
    ScheduleCompiler,
    SequenceGraph,
    _arithcfg_for,
)
from ..sequencer.plan import Algorithm
from ..sequencer.sequence import slice_to
from .gpu_device import GPUDevice


class DCNCompiler(ScheduleCompiler):
    """Two-tier lowering over (outer, inner): the hierarchical
    compositions for the ops that have one whenever both tiers are wider
    than 1, flat combined-world schedules otherwise. Outputs are adapted
    from the compositions' inner-major chunk order to the device's
    process-major numbering with local transposes (RankMap.reorder_chunks).

    `mesh` is the two-axis world (port Mesh); with `transport` set the
    compiler is one process's view of the multi-process form: its bodies
    take the process's L rows, a composition's inner tier runs on them and
    its outer tier across `procs` (the global process rank at each outer
    position), and a flat body runs on them as the process's share of the
    combined world (flat_wire). The ring kernel stays off, as the
    reference lowers with the Pallas ring off."""

    HIER_OPS = frozenset(
        {Operation.allreduce, Operation.reduce_scatter,
         Operation.allgather, Operation.bcast, Operation.alltoall,
         Operation.scatter, Operation.gather, Operation.reduce,
         Operation.barrier}
    )

    def __init__(self, mesh: Mesh, outer_axis: str = "dcn",
                 inner_axis: str = "ici", arith_table=None, transport=None,
                 procs=None):
        super().__init__(mesh.size, mesh.device, arith_table=arith_table,
                         use_ring_kernel=False)
        self.mesh = mesh
        self.outer_axis = outer_axis
        self.inner_axis = inner_axis
        self.transport = transport
        P = mesh.shape[outer_axis]
        self.procs = tuple(range(P)) if procs is None else tuple(procs)
        self._tiers = None
        self._flat = None

    @property
    def outer_world(self) -> int:
        return self.mesh.shape[self.outer_axis]

    @property
    def inner_world(self) -> int:
        return self.mesh.shape[self.inner_axis]

    def tiers(self):
        """(inner, outer): the stacked tiers of the one-card world, or the
        process's own rows and the cross-process tier."""
        if self._tiers is None:
            L, P = self.inner_world, self.outer_world
            if self.transport is None:
                self._tiers = stacked_tiers(RankMap(L, P), self.torch_device)
            else:
                from .dcn_transport import ProcessTier

                self._tiers = (StackedTier(L),
                               ProcessTier(self.transport, self.procs))
        return self._tiers

    def _hier_tiers(self):
        return None if self.transport is None else self.tiers()

    def flat_world(self):
        """The ProcessWorld the flat bodies of the multi-process form run
        on; None when the rows a body is given are the whole (sub)world
        (the in-process form, or a group of one host)."""
        if self.transport is None or self.outer_world == 1:
            return None
        if self._flat is None:
            from .dcn_transport import ProcessWorld

            self._flat = ProcessWorld(self.transport, self.procs,
                                      self.inner_world)
        return self._flat

    def flat_wire(self, cfg=None, arith_lane=None) -> schedules.Wire:
        world = self.flat_world()
        if world is None:
            return super().flat_wire(cfg, arith_lane)
        return world.wire(cfg, arith_lane)

    def rank_rows(self) -> range:
        world = self.flat_world()
        if world is None:
            return super().rank_rows()
        return range(world.first, world.first + self.inner_world)

    def _build(self, options, plan, arithcfg):
        P, L = self.outer_world, self.inner_world
        op = options.scenario
        if (plan.algorithm == Algorithm.HIER_RS_AR_AG or P == 1 or L == 1
                or op not in self.HIER_OPS):
            # the register-gated striped composition, plan-driven (the
            # plan's RankMap is outer-major: this device's numbering), or
            # the flat body over the combined world (flat_wire)
            return super()._build(options, plan, arithcfg)

        func = ReduceFunction(options.function) if op in (
            Operation.allreduce, Operation.reduce_scatter,
            Operation.reduce) else None
        inner, outer = self.tiers()
        # the tiers carry the hops: the composition's wire is the base one
        common = dict(inner=inner, outer=outer, wire=schedules.Wire(
            *self._wire_config(options, arithcfg, func, False)))
        # the device's numbering is outer-major (process-major); roots and
        # chunk relabelling go through the one mapping helper
        rm = RankMap(L, P, "outer_major")
        root = options.root_src_dst
        roots = dict(root_outer=rm.outer_pos(root),
                     root_inner=rm.inner_pos(root))

        if op == Operation.allreduce:
            return functools.partial(hierarchical_allreduce_schedule,
                                     func=func, **common)
        if op == Operation.scatter:
            return functools.partial(hierarchical_scatter_schedule,
                                     **roots, **common)
        if op == Operation.gather:
            return functools.partial(hierarchical_gather_schedule,
                                     **roots, **common)
        if op == Operation.reduce:
            return functools.partial(hierarchical_reduce_schedule, func=func,
                                     **roots, **common)
        if op == Operation.barrier:
            return functools.partial(hierarchical_barrier_schedule, **common)
        if op == Operation.alltoall:
            # process-major on both ends: no relabelling
            return functools.partial(hierarchical_alltoall_schedule, **common)
        if op == Operation.bcast:
            return functools.partial(hierarchical_bcast_schedule,
                                     **roots, **common)
        if op == Operation.allgather:
            # the composition's output is inner-major: relabel locally
            def body(x, *, _c=common, _rm=rm):
                raw = hierarchical_allgather_schedule(x, **_c)
                return _rm.reorder_chunks(raw, raw.shape[-1] // _rm.world,
                                          "inner_major", "outer_major")
            return body

        # reduce_scatter: the input's process-major chunks go to the
        # composition's inner-major layout, so each rank ends with its own
        def rs_body(x, *, _c=common, _f=func, _rm=rm):
            xim = _rm.reorder_chunks(x, x.shape[-1] // _rm.world,
                                     "outer_major", "inner_major")
            return hierarchical_reduce_scatter_schedule(xim, func=_f, **_c)
        return rs_body

    def lower_step(self, options, plan):
        """A call-sequence step or a streamed call takes the flat body over
        the combined world, as the reference's compile_sequence and
        lower_streamed take its _body (not the two-tier _build): a
        recorded batch is bitwise the flat device's calls, in both forms."""
        key = ("flat", options.signature(), plan)
        fn = self._cache.get(key)
        if fn is None:
            arithcfg = None
            if options.data_type != DataType.none:
                arithcfg = _arithcfg_for(self.arith_table, options)
            fn = self._cache[key] = self._body(options, plan, arithcfg)
        return fn

    def compile_sequence(self, seq):
        if self.transport is not None and self.transport.rank not in \
                self.procs:
            # a host outside the communicator: its dispatch leaves its
            # rows as they are (the member hosts run the batch)
            out_idx = seq.out_idx
            return lambda *bufs: tuple(bufs[i] for i in out_idx)
        return super().compile_sequence(seq)

    def sequence_graph(self, seq, body, inputs, in_place=False):
        """The multi-process form's executable is eager by form: a hop
        waits on a host token or stages through the host, which a CUDA
        graph cannot capture, so
        each replay runs the composed body on the card (same bind / load /
        replay / results contract, every step staged)."""
        if self.transport is None:
            return super().sequence_graph(seq, body, inputs, in_place)
        return SequenceGraph(body, inputs, capture=False)


class DCNBuffer(GPUBuffer):
    """A stacked buffer of the multi-host device: every process holds the
    whole (world, n) image, and only the rows of its own ranks (`local`, a
    row slice; None: every row, the one-card form) are authoritative:
    sync_from_device reads back those rows alone, as each host of the
    reference syncs only its own devices' shards."""

    local: slice | None = None

    def sync_from_device(self):
        if self.device is None or self.local is None:
            return super().sync_from_device()
        host = self.host.clone()
        host[self.local] = self.device[self.local].to("cpu")
        self.host = host
        return self


class DCNDevice(GPUDevice):
    """The multi-host device over a (dcn, ici) world, in-process (`mesh=`)
    or one process per host (`num_processes` > 1)."""

    # sub-communicators must be outer-aligned: the full inner groups of a
    # subset of hosts (a cross-host program involves exactly the processes
    # owning its ranks). A within-one-host group selects the flat
    # inner-only path while the world selects the compositions.
    supports_split = True
    buffer_class = DCNBuffer
    # the two-tier alltoall has no capacity-masked form: uneven alltoallv
    # vectors are refused up front
    supports_alltoallv = False
    supports_slot_alltoallv = False
    # and the ALLTOALL_COMPRESS_MIN_COUNT rewrite stays off: its crossover
    # is the flat exchange's (explicit compress_dtype= stays available)
    auto_alltoall_wire = False
    # the compositions carry no survivor mask
    supports_live_subset = False

    def __init__(
        self,
        num_processes: int = 1,
        process_id: int = 0,
        coordinator_address: str | None = None,
        local_device_count: int | None = None,
        outer_axis: str = "dcn",
        inner_axis: str = "ici",
        mesh: Mesh | None = None,
        torch_device: torch.device | str = "cuda",
        transport=None,
        link: str | None = None,
    ):
        if link is not None:
            from .dcn_transport import link_name

            link_name(link, torch_device)  # an unknown name raises
            if transport is not None or mesh is not None:
                raise ValueError("link= picks the link of the transport "
                                 "DCNDevice connects: not with transport= "
                                 "or mesh=")
        if transport is not None:
            # a transport already up (a LoopbackHub's, one thread a host)
            num_processes, process_id = transport.size, transport.rank
        if mesh is None:
            torch_device = torch.device(torch_device)
            if torch_device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "DCNDevice on cuda needs a CUDA device; pass "
                    "torch_device='cpu' to run on the CPU")
            local = int(local_device_count or 1)
            if num_processes > 1:
                if transport is None:
                    from .dcn_transport import DCNTransport

                    transport = DCNTransport.connect(
                        num_processes, process_id, coordinator_address,
                        link=link, device=torch_device)
            mesh = Mesh({outer_axis: num_processes, inner_axis: local},
                        torch_device)
        else:
            if transport is not None:
                raise ValueError("mesh= is the in-process form: no transport")
            if len(mesh.axis_names) != 2:
                raise ValueError(
                    f"DCNDevice needs a two-axis mesh, got {mesh.shape}")
            outer_axis, inner_axis = mesh.axis_names
            torch_device = mesh.device
        super().__init__(mesh.size, torch_device,
                         hier_topology=(mesh.shape[inner_axis],
                                        mesh.shape[outer_axis]))
        self.mesh = mesh
        self.outer_axis = outer_axis
        self.inner_axis = inner_axis
        self.transport = transport
        self._process = transport.rank if transport is not None else 0
        L = mesh.shape[inner_axis]
        self._local = (slice(self._process * L, (self._process + 1) * L)
                       if transport is not None else None)
        self.compiler = DCNCompiler(mesh, outer_axis, inner_axis,
                                    transport=transport)
        self._members: dict[tuple[int, ...], bool] = {}

    @property
    def process_index(self) -> int:
        return self._process

    def local_rows(self) -> list[int]:
        """Global rank rows whose buffers this process owns."""
        if self._local is None:
            return list(range(self.world))
        return list(range(self._local.start, self._local.stop))

    def register_buffer(self, buf) -> None:
        if isinstance(buf, DCNBuffer):
            buf.local = self._local
        super().register_buffer(buf)

    def validate_split(self, rows: tuple) -> None:
        """Members must be outer-aligned (whole inner groups of a host
        subset): a cross-host call involves exactly the processes owning
        its ranks, and a partial host would strand ranks. Checked at
        split() time, so a bad group never allocates exchange memory."""
        L = self.mesh.shape[self.inner_axis]
        if len(rows) % L or any(
            rows[i * L + j] != rows[i * L] + j or rows[i * L] % L
            for i in range(len(rows) // L)
            for j in range(L)
        ):
            raise NotImplementedError(
                f"DCN sub-communicators must be whole-host groups "
                f"(members aligned to inner groups of {L}); got {rows}")

    def _group_compiler(self, rows: tuple[int, ...]) -> DCNCompiler:
        """A sub-communicator's compiler: the two-tier sub-world of its
        hosts, (len(rows) // L, L)."""
        self.validate_split(rows)
        L = self.mesh.shape[self.inner_axis]
        sub = Mesh({self.outer_axis: len(rows) // L, self.inner_axis: L},
                   self.torch_device)
        procs = [rows[i * L] // L for i in range(len(rows) // L)]
        return DCNCompiler(sub, self.outer_axis, self.inner_axis,
                           arith_table=self.compiler.arith_table,
                           transport=self.transport,
                           procs=procs if self.transport is not None
                           else None)

    def _member_process(self, ctx) -> bool:
        """Does this process own any rank of the communicator? Cached by
        member rows (start() is the dispatch hot path)."""
        if ctx.rows is None or self._local is None:
            return True
        member = self._members.get(ctx.rows)
        if member is None:
            L = self.mesh.shape[self.inner_axis]
            member = self._members[ctx.rows] = any(
                r // L == self._process for r in ctx.rows)
        return member

    def start(self, options):
        if options.scenario != Operation.config:
            ctx = self._comm_ctx(options.comm_addr)
            if not self._member_process(ctx):
                # MPI semantics: a collective on a communicator this host
                # is not part of is a no-op here (the member hosts run it)
                req = BaseRequest(options.scenario.name)
                req.running()
                req.complete(0)
                return req
        return super().start(options)

    # -- the multi-process form: a body takes this process's rows ------------

    def _operand_rows(self, ctx) -> int:
        if self._local is None:
            return super()._operand_rows(ctx)
        return self.mesh.shape[self.inner_axis]

    def _member_rows(self, t, ctx, n):
        if self._local is None:
            return GPUDevice._member_rows(t, ctx, n)
        return slice_to(t, n)[self._local]

    def _place(self, full, ctx, out):
        if self._local is None:
            return GPUDevice._place(full, ctx, out)
        full = full.clone()
        full[self._local, :out.shape[-1]] = out.to(full.dtype)
        return full
