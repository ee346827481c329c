"""Drive the PyTorch/CUDA port of accl-tpu on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc for sm_90a):

    python3 chip_smoke.py

What it does, in order, printing one JSON object per line:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build time of the kernels, which are compiled
     from accl_tpu_torch/csrc/ into accl_tpu_torch/_build/ at first use;
  2. kernel phase: each ring kernel against its plain PyTorch version on
     the card, bitwise (NaN-aware for float MAX), over worlds {1, 2, 5,
     8}, n {1, 1000, 4099, 1<<20}, six dtypes, SUM and MAX, every float
     tensor with subnormal and signed-zero columns (the flush-to-zero and
     IEEE-maximum repair); then worlds {3, 6}, n at a chunk boundary +-1,
     column views of wider buffers with an odd row stride and with
     16-byte-aligned ones, and out= views, so that the kernel's 16-byte
     vector and scalar instantiations both run (their case counts are
     printed);
  3. facade phase (the main path): ACCL(world=8).allreduce on the card,
     from_device/to_device, fp32 SUM at 4 KiB, 1 MiB, 25 MiB and 256 MiB
     per rank, bf16 SUM at 25 MiB, fp32 MAX at 1 MiB, then world 5 with
     ragged counts; every result held against a float64 sum within the
     recursive-summation bound (W-1)*u*sum|x_i| (MAX exactly), the 1 MiB
     and 25 MiB results also bitwise against the port's plain kernel path
     on the CPU, and the bidirectional kernel's launch count against the
     expected segment count; one host-staged call timed on its own;
  4. quantized kernel phase: the four blockwise-int8 step kernels and
     the wire message entries of kernels 5 and 6 (quantize_packed,
     dequantize_packed) against their plain versions on the card,
     bitwise (NaN matches NaN), over rows {1, 2, 5, 8} x n {1, 32, 255,
     257, 4099, 131072, 6553600}, SUM and MAX for the fused pair, with
     all-zero, signed-zero, +-127-rail, negative-rail, 1e-39, NaN and
     Inf blocks, and blocks whose quotients lie on and beside
     half-integers (kernel 5's exact divide); kernels 5 and 6 also over aligned and odd-stride column
     views and through their C entry points into sentinel-filled
     buffers (nothing written outside, a misaligned vector request
     refused), their vector and scalar launches counted; then the closed-form int8 ring allreduce
     against its plain version and against the torch-op quantized ring
     (the step kernels hop by hop) on the card, bitwise, over worlds
     {1, 2, 3, 5, 7, 8} x per-rank counts {1, 31, 255, 257, 4099, 1<<20}
     x two eager buffers each (ragged last segments, chunk lengths that
     are no multiple of 4 or 256) x SUM and MAX x special-valued blocks
     (all-zero, signed zeros, 1e-39, NaN, +-Inf, the +-127 rail), then
     aligned and odd-stride column views as operand and out= (its
     vector and scalar launches counted), and a misaligned vector
     request refused;
  5. int8-wire path: ACCL.allreduce(..., compress_dtype=int8) on the
     card, from_device/to_device: W=8 with a 4 MiB eager buffer, fp32
     SUM at 1 MiB and 25 MiB and MAX at 1 MiB per rank, W=5 with 1000003
     elements, and W=8 at 64 KiB with the default 1 KiB buffer (64
     segments); every rank identical, each result within W quantization
     passes of the float64 reduction (W*M*(1+W/254)/254 +
     (W-1)*u*sum|x_i|, M the segment's max of sum|x_i|), the 1 MiB and
     25 MiB results bitwise against the port's CPU run (the torch-op
     ring), one or two launches of the closed-form ring a call and none
     of the step kernels; then the int8-wire reduce, reduce_scatter,
     allgather, gather, scatter and bcast at W=8 (25 MiB and 1 MiB),
     bitwise against the port's CPU run, each call's step-kernel
     launches against its plan, with the (rows, n) of every launch, and
     a mover hop held to 3 device operations (profiled);
  6. timings: per facade size, medians of 20 runs timed with CUDA events
     of the whole call, the kernel alone over the same segments, the plain
     version, and the one PyTorch call computing the same function
     (a yardstick only, never called by the port), beside the bound; the
     int8-wire facade at 25 MiB beside the exact wire, and one int8 call
     under torch.profiler (device busy time and idle share, the costliest
     host operations, its launches); the fp16 and bf16 wires with fp32
     arithmetic (the torch-op ring) at 25 MiB the same way; the six
     int8-wire collectives' facade time at 25 MiB, the flat bcast
     profiled; the four quantized step kernels at every launch shape of
     their path and at (8, 131072) (device time and the bound; at the
     largest two and (8, 131072) through each entry, with the plain
     version, host cost per launch and a cold two-size fit), with each
     one's launches x (time - bound) over its path; then a breakdown of
     a ring launch into fixed device cost, the rate over its
     2*W*n*itemsize bytes and host-side wrapper cost, and of the
     closed-form int8 ring at (8, 1 048 576) (device and host time, the
     torch-op ring it replaces, a cold two-size fit);
  7. lane kernel phase: the three lane kernels (combine, combine_cast,
     cast) against their plain versions on the card, bitwise (NaN
     matches NaN), over rows {1, 2, 5, 8} x n {1, 127, 128, 129, 4099,
     1<<20}, every dtype and op of their path and every (in, out) pair
     of combine_cast, with signed zeros in both orders, subnormals of
     every width, NaN, +-Inf, fp16 overflow and int32 wrap; then all
     three over the layouts that choose their 16-byte vector or scalar
     instantiation (aligned and odd-stride column views, also of 70 000
     rows, more than grid.y's 65 535; bases 2, 4 and 8 bytes off; one
     row with a ragged tail; contiguous rows with odd n), with the cases
     of each instantiation counted; their C entry points writing into
     views of sentinel-filled buffers (nothing outside written, a
     misaligned vector request refused); and each over one row of
     2^31 + 3 elements, which takes the walk's 64-bit index, and cast
     over one of 2^32 + 5 (scalar), which strides over its grid; the
     ring kernel phase (2) carries the subnormal and signed-zero columns
     as well;
  8. collectives phase (the one-call collectives' path): ACCL(world=8)
     reduce, reduce_scatter, allgather, gather, scatter, bcast and
     combine at 25 MiB of fp32 (the whole buffer as nccl-tests sizes it),
     bf16 reduce and reduce_scatter, reduce, bcast and allgather on the
     bf16 wire, one barrier, and reduce and allgather at W = 5 with
     1000003 elements; movers exact, reductions within their rounding
     bound of a float64 reference (MAX exact), the cast wire within its
     half-precision bound; every case again at 1 MiB, bitwise against the
     port's CPU run; each call's lane-kernel launches against its plan;
     then each collective's facade time (median of 20, CUDA events) and
     nccl-tests bus bandwidth, and a breakdown of each lane kernel at its
     launch shape (held bitwise against its plain version there, then
     device time, host cost per launch, bound, the PyTorch call
     computing the same function; combine over float64 as well); then
     the three with cold operands at two sizes, fitted to a fixed cost
     plus a rate;
  9. sequence phase (call sequences): six batches at W = 8, 25 MiB and
     4 KiB per rank: an allreduce; reduce_scatter -> allgather; that
     chain and an allreduce on the int8 wire; reduce -> bcast in bf16;
     the allreduce on the fp16 wire with fp32 arithmetic (the torch-op
     ring); copy_from_stream -> allreduce with a res_stream consumer.
     Each is prepared once through SequenceRecorder.compile() as one
     CUDA graph and held bitwise against the same calls issued eagerly
     (on two input sets); dispatch k's results must survive dispatch
     k+1; the launches at compile must be twice the eager calls' (the
     warm-up run and the capture) and none at replay; one dispatch is
     profiled (one graph launch; the eager calls' device kernels, by
     name and count); then eager and replay facade_ms in alternating
     pairs, the replay's device time, host ms per dispatch, capture
     seconds and the copy-in's bytes and device ms;
 10. point-to-point phase: W = 8, fp32, 4 KiB and 25 MiB per rank on
     the exact, fp16, bf16 and int8 wires: send then recv, recv first,
     three TAG_ANY messages received in FIFO order, three tagged ones
     received in reverse, and a stream_put with a producer and a
     consumer; every row of each result bitwise with the port's CPU run,
     row dst bitwise row src on the exact wire and within one
     quantization pass on the int8 wire, each message's launches (int8:
     one quantize and one dequantize; fp16/bf16: two casts); then a
     send+recv pair's facade_ms, device ms and bound;
 11. sub-communicator phase: split([0, 2, 4, 6]) and split([1, 2, 5])
     of W = 8: the exact and int8 allreduce at 25 MiB per rank (kernel 1
     at world g, ceil(bytes/4 MiB) launches; the closed-form int8 ring),
     bcast, reduce (fp32, bf16), reduce_scatter, allgather, gather,
     scatter and alltoall on 1024*g elements; member rows bitwise with
     the port's CPU run, other rows unchanged; a reduce_scatter ->
     allgather sequence on the group of four replayed as one CUDA graph,
     bitwise with its eager twin; the group allreduce's facade_ms,
     device ms and bound beside the full world's;
 12. alltoall phase: W = 8, 25 MiB per rank in slots of 819 200 (the
     int8 wire's aligned exchange) and 8 000 elements in slots of 1 000,
     alltoall and alltoallv (capacities 819 200 x (1, 3/4, 1/2, 1/4,
     ...)) on the exact and int8 wires, ALLTOALL_COMPRESS_MIN_COUNT set
     and at 0; exact bitwise with numpy's transpose, int8 bitwise with
     the port's CPU run, local slots exact, the aligned call one
     quantize and one dequantize; facade_ms, device ms and bound;
 13. tuned phase (ACCL.autotune and the plans it opens): autotune at
     W = 4, 8, 16 and at W = 8 with hier_topology=(4, 2), the crossovers,
     registers and tier wires against the reference's values; then the
     plans they open through the facade: the latency-grid synthesized
     entry at 1, 4 and 16 KiB (and bf16), the stripe-overlapped
     allreduce at 64 KiB and 25 MiB, the rs_ag entry at 1 and 4 MiB, the
     allgather and reduce_scatter entries, W = 16's rs_ag entry, the
     two-tier allreduce on (4, 2) with the autotuned (int8, int8) wires
     at 1 and 25 MiB, exact at 25 MiB and fp16 at 1 MiB, a tiered entry
     on (2, 4), and the int8 exchange entry through an explicit plan;
     each call's plan and kernel launches as predicted, the result
     bitwise with the same plan on CPU tensors (the exact 25 MiB and
     4 MiB calls within their float64 bound), facade_ms and device ms
     beside the default plan's; a recorded sequence of a HIER and a
     synthesized step as one CUDA graph, bitwise with the eager calls;
 14. telemetry phase (accl_tpu_torch/telemetry/): at W = 8, fp32,
     allreduce at 4 KiB, 64 KiB, 1, 4 and 25 MiB per rank (5 calls
     each), one on the int8 wire, a reduce_scatter -> allgather sequence
     run once and as a compiled program twice, and one run_async call,
     first with the tracer off, then on: results bitwise and launches
     equal; the trace validates, exports to the facade and device
     tracks, every call span names its plan and a positive prediction;
     the copied timing model's residuals against the spans, the
     registry's exposition and the drift sentinel's report; each exact
     call's CUDA-event duration lifted through telemetry.native into a
     fit of the card (calibrate_from_trace), the registers
     autotune_from_trace sets beside autotune()'s, and for the tuned
     phase's windows the plan and device ms each register set gives, checked
     against the CPU twin; the always-on cost at 4 KiB (observability
     off, live spans only, on, tracing on); a timed-out recv's
     post-mortem from the flight recorder;
 15. serve phase (accl_tpu_torch/models/): the flagship transformer's
     widths in fp32 (vocab 32 768, d_model 1024, 16 heads, 4 kv heads,
     8 layers, d_ff 4096) at W = 4 tensor-parallel virtual ranks,
     batch 8, max_len 1024, TF32 off: the fused decode step (one
     CUDA-graph replay a token) bitwise with its eager twin over 16
     ragged steps, within 1e-4 * max|ref| of the port's CPU run (4
     steps) and of forward_local (32 positions), a DecodeServer's six
     ragged requests bitwise with each decoded alone; with the default
     registers and after autotune(): the allreduce plan, the launches
     against it (kernel 7 sixteen times a step plus the plan's), one
     profiled replay (one graph launch, the hand-written kernels inside
     it), the fused and eager step's ms (events and host clock),
     tokens/s, accl_serve_step_seconds p50/p99, the bytes staged a step
     (xp alone) and the step's bound;
 16. train phase (models/transformer.py's train step): the flagship
     widths in fp32 (155 205 632 parameters), W = 4 data-parallel ranks,
     tokens (4, 2, 1024), lr 1e-3, TF32 off: the fused step (forward,
     backward, gradient allreduce and SGD combine in one CUDA-graph
     replay) bitwise with its eager twin, with the default registers and
     with the overlap register open (the plan stripes); the update within
     1e-4 of max|update| of a plain autograd oracle and of the port's
     CPU run (tokens (4, 1, 64)); the loss lower after the step; kernel 1
     and 7 launches against the plan; then the fused and eager step's
     p50/p99 (events, host clock), tokens/s, the FLOP bound (67 TFLOP/s)
     and the step's share of it, the allreduce's and combine's device ms
     in one profiled replay, peak device memory;
 17. MoE phase (models/moe.py's facade form): d_model 1024, d_ff 4096,
     4 experts over W = 4, top-2, 2048 tokens a rank (C = 1280): fused,
     eager and the staged expert program bitwise; within 1e-4 of a
     plain per-rank oracle; the int8 wire within the reference's 5%
     bound, its register form bitwise; wire capacity 640 dropping the
     oracle's tokens; kernels 5 and 6 launches against the plan; the
     layer step's ms, fused and eager, exact and int8, beside its bound;
     then DeepSeek-V3's MoE layer step, near the end (v3_moe_phase;
     `chip_smoke.py v3_moe` runs it alone): two layers at the published
     widths (hidden 7168, expert width 2048, 32 held experts, W = 8, 128
     tokens a rank) as one replay; its three kernels' launches at
     compile, a replay and an eager step; fused against eager; each
     kernel on the step's own tensors against its plain version; their
     device ms beside bound, plain and library ms;
 18. mesh phase (accl_tpu_torch/parallel/ and the mesh forms of
     models/transformer.py and models/moe.py): the flagship widths in
     fp32, tokens (8, 1024), TF32 off: make_forward on dp2.sp2.tp2 (8
     virtual ranks) against forward_local; make_train_step there (the
     leaf, striped and remat syncs) against an autograd oracle and each
     other; the pipelined forward and step on dp2.tp2.pp2; 32 decode
     positions on dp2.tp2 against make_forward; Ulysses at B 4, T 1024
     over sp 4 on the exact and int8 wires; the MoE forward and step on
     dp2.ep2 against the oracle and the dp1.ep1 step; kernel 7's
     launches against each step's schedule, kernels 5 and 6 against the
     int8 alltoalls' plan; each form's ms, tokens/s, the train step's
     share of its FLOP bound, kernel 7's device ms in a profiled step,
     peak memory;
 19. analysis phase (accl_tpu_torch/analysis/ and synthesis's certify/
     search/verify_library): verify_library over the 31 library entries
     (each regenerates to its dag_sha256, certifies clean, keeps its
     window); search at W = 4 and 8 and tiered (2, 4) finds the
     library's winners; every entry at 1, 5 and 37 times its canonical
     count, SUM and (exact-wire allreduce) MAX, certified and lowered on
     the card: the exact wire bitwise with hopdag.execute and the numpy
     oracle, the int8 wire within the reference's bound and bitwise with
     the CPU lowering, kernels 7, 4, 5 and 6 launched as each DAG's round
     plan gives (synthesis.round_launches); the reference's mutants of
     every entry against the certifier's verdicts (0 disagreements); the
     27 program-level lint fixtures, deep off and on;
 20. lift phase (analysis/semantics.py's lifter, protocol.py's recorded
     hops, the linter's semantic pass and deep tier, interference.py):
     the reference's family grid (26 calls) and the probe set (8
     operations x W 2/4/5/8 x counts 7/1000/300 000) lifted and
     certified strictly, cold and cached; each call through the facade
     on the card (every kernel of its lowering) equal to hopdag.execute
     of its lifted DAG and the numpy oracle, bitwise on the exact and
     cast wires, within the reference's bound on int8; each DAG's
     mutants (seeds 3-8) against execution, 0 disagreements; tenant
     sequences on the card: a disjoint pair certified with no escalation,
     stamped, and bitwise with its serial composition from two threads;
     a write/write pair and a shared stream endpoint rejected (ACCL601),
     A;B != B;A; the flagship decode-step and train-step batches
     prepared with lint="error" and lint="deep", each tier's host ms;
 21. resilience phase (device/emu_device.py, drain_world, resilience/,
     the live-subset allreduce, the armed facade seam): the port's own
     g++ build of native/src (its seconds; started beside the nvcc
     builds); EmuWorld(4, "local") over CPU tensors, five collectives at
     1024 and 65 536 elements bitwise with the card facade on the same
     integer-valued rows, drain_world one span a call a rank, a CUDA
     operand refused; a rank killed mid-stream: every survivor misses its
     NativeDeadlineGuard deadline, attribute_silent names it, the
     certified ring replan over 3 survivors installs generation 1, and
     after flush_rx the recovered allreduce is the survivor sum bitwise;
     allreduce(mode="live_subset") at W = 8 for three survivor sets at
     1024 and 1 048 576 elements bitwise with the survivor oracle,
     kernel 7 (W-1) times a segment and kernel 1 never, certify_call
     clean, a ghost contribution exactly ACCL501, its ms beside the ring
     kernel's full allreduce; the armed seam over the card's own fit:
     bitwise, no miss, its cost on a 4 KiB allreduce in alternating
     pairs, a tight policy's miss once the shape is warm;
 22. scheduler phase (scheduler/): two tenants on disjoint split()
     groups under drain(workers=2), certified, bitwise with their serial
     composition; a write/write pair serialized with nothing dropped; the
     DecodeServer at serve_phase's widths with and without a scheduler,
     tokens bitwise; report()'s fairness and certificate counts;
 23. dcn phase (device/dcn_device.py, dcn_transport.py and the nine
     two-tier compositions of sequencer/hierarchical.py): the in-process
     DCNDevice over {"dcn": 2, "ici": 4}, the allreduce at 4 and 25 MiB
     a rank on the exact, fp16 (fp32 arithmetic) and int8 wires, every
     other two-tier op at 262 144 elements (roots 3 and 6), p2p 1 -> 7
     and host 1's sub-communicator, each bitwise with the port's CPU run,
     exact results within their float64 fold bound, kernel launches as
     each composition implies; then 2 run_dcn processes x 4 ranks, 3 x 2
     with a cross-host sub-communicator, 2 x 1 and 4 x 1 on cuda:0 over
     the ipc link (each hop a device copy into a region the peer mapped
     with CUDA IPC, a token over gloo), each child's rows bitwise its
     own in-process device's, the bytes a process sent across the
     boundary against the schedule's count, none staged through the
     host; the 4 and 25 MiB allreduce's median ms on the two-process
     devices on the ipc and the gloo link in alternating pairs (host
     clock), the in-process DCNDevice and the flat GPUDevice;
 24. entry phase (accl_tpu_torch/examples/ and accl_tpu_torch/tools/):
     in process at the flagship widths, the generation example's
     generate_tokens on its dp2.tp2 mesh (batch 8, 120 new tokens: each
     decode step's logits within TRAIN_TOL of make_forward's, greedy
     tokens their argmax, two sampled runs from one seed equal), the
     dense trainer on dp2.sp2.tp2 and the MoE trainer on dp2.ep4, each
     2 steps + save_checkpoint + restore + 2 steps bitwise 4 straight
     steps, kernel 7 launched as the schedule gives; then every CLI as
     a user runs it (generate, train_lm with --ckpt twice, --model moe,
     --pp 2, --remat, accl_lint's three CI gates, accl_synth
     --verify-library, accl_trace --selftest, run_emulator on tcp and
     udp), each a child process that must exit 0 with its success
     lines; ms a decode step, tokens/s, ms a train step beside the mesh
     phase's leaf step, checkpoint bytes and seconds, each child's
     seconds;
 25. sweep phase (accl_tpu_torch/tools/bench_emulator, rt_stats_sweep,
     timing_model): each child alone, into a temporary directory, its
     seconds host time of the machine, not card work: the emulator sweep
     at -n 4 and -n 8 on tcp and -n 4 on local and udp (40 rows a world
     less the announced skips, every Protocol the selection rule's and
     the committed accl_log/emu_bench*.csv's), the counter sweep's nine
     default configs (spans, no drops, retcodes [0]); then the card's
     own profile in the reference's format (kernel 7's fp32 SUM at 1 KiB
     to 1 GiB an operand, CUDA events with the host held off, the 1 GiB
     result bitwise its plain version; the world-1 facade allreduce's
     dispatch at 4 KiB, 256 KiB and 16 MiB, host clock with the sync),
     the timing model fitted from the sweeps and that profile (its six
     sections, finite medians, the tier's 3 x HBM stream rate within the
     card's 3.35 TB/s) and ACCL(GPUDevice(8)).autotune(tier="tpu") on it,
     the registers equal to those derived from the tier's link;
 26. the kernels line (with each kernel's launches on the sequence,
     point-to-point, sub-communicator, alltoall, tuned, telemetry,
     serve, train, MoE, mesh, analysis, lift, resilience, scheduler,
     dcn, entry and sweep paths); last, the device line.

Any failed check raises, and the script then exits non-zero without the
last line. It needs no network and one card.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
SEG_BYTES = 4 * MIB  # the compiler's per-launch cap of the ring kernel
QUANT_BUF = 4 * MIB  # the eager buffer of the int8-wire facade cases
# the four blockwise-int8 kernels and the TPU kernels they replace
QUANT_KERNELS = {
    "quantize": "accl_tpu/ops/pallas_kernels.py:246",
    "dequantize": "accl_tpu/ops/pallas_kernels.py:279",
    "dequant_combine": "accl_tpu/ops/pallas_kernels.py:353",
    "dequant_combine_requant": "accl_tpu/ops/pallas_kernels.py:362",
}
# the closed-form int8 ring allreduce: the int8 allreduce's counterpart of
# the fused interior ring step (and of its quantize, terminal combine and
# allgather dequantize), on row 3's route
QUANT_RING = ("quant_ring_allreduce", "accl_tpu/ops/pallas_kernels.py:362")
# the three lane kernels and the TPU kernels they replace
LANE_KERNELS = {
    "combine": "accl_tpu/ops/pallas_kernels.py:80",
    "combine_cast": "accl_tpu/ops/pallas_kernels.py:167",
    "cast": "accl_tpu/ops/pallas_kernels.py:127",
}
COLL_BYTES = 25 * MIB  # the collectives phase's buffer (nccl-tests' size)
BF16_UNIT = 2.0 ** -8
F32_UNIT = 2.0 ** -24


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    """Bitwise equality; a NaN matches any NaN at the same place."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.itemsize]
    return bool(torch.equal(a[~nan].view(ints), b[~nan].view(ints)))


def max_abs_err(a, b) -> float:
    import torch

    d = (a.double() - b.double()).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run_ms(fn, count: int = 20, repeats: int = 5) -> float:
    """Device time per call in steady state: CUDA events around a run of
    `count` back-to-back calls, divided by the count; median of
    `repeats` runs. While the host enqueues faster than the card drains,
    host time hides behind device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(count):
            fn()
        e1.record()
        e1.synchronize()
        runs.append(e0.elapsed_time(e1) / count)
    return statistics.median(runs)


def device_ms(fn, count: int = 50, tries: int = 3) -> float:
    """Device time per call with the host out of the way: a spin kernel
    holds the stream while the host enqueues `count` calls, so the events
    around them time the card's work and the gaps between launches, not
    the wrapper's host cost. A run whose spin ended before the last call
    was enqueued (a stall of the shared host) is not a measurement: it
    is run again with twice the spin, and fails after `tries` runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int((3 * host_s + 1e-3) * spin_cycles_per_s())
    for _ in range(tries):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(count):
            fn()
        e1.record()
        held = not e0.query()
        e1.synchronize()
        if held:
            return e0.elapsed_time(e1) / count
        spin *= 2
    raise AssertionError(f"spin ended before the calls were enqueued, "
                         f"{tries} times")


def spin_cycles_per_s() -> float:
    """The rate of torch.cuda._sleep's spin, timed over a ~10 ms spin."""
    import torch

    cycles = 20_000_000
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(cycles)
    e1.record()
    e1.synchronize()
    return cycles / (e0.elapsed_time(e1) * 1e-3)


def host_ms(fn, count: int = 200) -> float:
    """The host clock's time per call over `count` calls enqueued back to
    back: a wrapper's host cost per launch while the card keeps up."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    ms = (time.perf_counter() - t0) / count * 1e3
    torch.cuda.synchronize()
    return ms


def rank_data(world: int, count: int, dtype, gen):
    import torch

    if dtype.is_floating_point:
        return torch.randn((world, count), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min // 2, info.max // 2, (world, count),
                         generator=gen, device="cuda", dtype=dtype)


SUBNORMAL = {"float32": 1e-39, "float64": 1e-310, "bfloat16": 1e-39,
             "float16": 6e-8}


def repair_columns(x) -> None:
    """Columns 0-3 of a float rank tensor: a subnormal on rank 0 only, a
    subnormal on every rank, -0 on every rank but the last (+0), and a
    negative subnormal beside that +0 — where an add that keeps
    subnormals and torch.maximum's zero tie differ from the contract."""
    tiny = SUBNORMAL[str(x.dtype).split(".")[-1]]
    x[:, :4] = 0.0
    x[0, 0] = tiny
    x[:, 1] = tiny
    x[:, 2] = -0.0
    x[:-1, 3] = -tiny
    x[-1, 2:4] = 0.0


def ring_cases(ring, dirs: int, gen):
    """(description, x, out or None, nan case, repair columns) for one ring
    kernel: the product of worlds {1, 2, 5, 8} and n {1, 1000, 4099,
    1<<20}, then worlds {3, 6}, n at the chunk boundary +-1 (where the
    chunk grows by a tile), and column views of wider buffers, as operand
    and as out=, with an odd row stride (scalar instantiation) and
    16-byte-aligned (vector)."""
    import torch

    def views(world, n, dtype, aligned):
        """A (world, n) column view of a wider buffer: at element 16 of
        rows a multiple of 8 elements wide (16-byte aligned for every
        dtype) or at element 3 of rows n + 7 wide."""
        width, lo = ((-(-n // 8) * 8 + 32, 16) if aligned else (n + 7, 3))
        return rank_data(world, width, dtype, gen), lo

    plain = [(w, n) for w in (1, 2, 5, 8) for n in (1, 1000, 4099, 1 << 20)]
    plain += [(w, n) for w in (3, 6) for n in (1, 1000, 4099, 1 << 20)]
    for world, n in plain:
        for dtype in ring.SUPPORTED_DTYPES:
            x = rank_data(world, n, dtype, gen)
            yield f"world={world} n={n}", x, None, n == 4099, True
    for world in (3, 5, 8):
        for dtype in ring.SUPPORTED_DTYPES:
            edge = dirs * world * ring.chunk_elems(1, 1, dtype, 1)
            for n in (edge - 1, edge + 1):
                x = rank_data(world, n, dtype, gen)
                yield f"world={world} n={n} (chunk edge)", x, None, True, True
    for world in (3, 8):
        for n in (1000, 4099, 65536 + 5):
            for dtype in ring.SUPPORTED_DTYPES:
                for aligned in (False, True):
                    buf, lo = views(world, n, dtype, aligned)
                    obuf, olo = views(world, n, dtype, aligned)
                    kind = "aligned" if aligned else "odd-stride"
                    yield (f"world={world} n={n} {kind} view",
                           buf[:, lo:lo + n], None, False, True)
                    yield (f"world={world} n={n} {kind} view, out= view",
                           buf[:, lo:lo + n], (obuf, olo), False, True)


def kernel_phase(ring):
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    gen = torch.Generator(device="cuda").manual_seed(1234)
    pairs = (("ring_allreduce_bidir", ring.ring_allreduce_bidir,
              ring.ring_allreduce_bidir_ref, 2),
             ("ring_allreduce", ring.ring_allreduce, ring.ring_allreduce_ref,
              1))
    errs = {}
    for name, kernel, plain, dirs in pairs:
        cases, err, nan_cases, repair_cases = 0, 0.0, 0, 0
        by_path = {"vector": 0, "scalar": 0}
        for where, x, out_buf, nan_case, repair in ring_cases(ring, dirs, gen):
            world, n = x.shape
            dtype = x.dtype
            if repair and dtype.is_floating_point and n >= 4:
                repair_columns(x)
                repair_cases += 1
            for func in (ReduceFunction.SUM, ReduceFunction.MAX):
                xi = x
                if (func == ReduceFunction.MAX and dtype.is_floating_point
                        and nan_case and world > 1):
                    xi = x.clone()
                    xi[1, 7] = float("nan")
                    nan_cases += 1
                kw = {}
                if out_buf is not None:
                    obuf, olo = out_buf
                    before = obuf.clone()
                    kw["out"] = obuf[:, olo:olo + n]
                got = kernel(xi, world, func, **kw)
                path = ring.vector_path(xi, got)  # as the wrapper chose
                want = plain(xi, world, func)
                torch.cuda.synchronize()
                if out_buf is not None:
                    outside = torch.ones_like(obuf, dtype=torch.bool)
                    outside[:, olo:olo + n] = False
                    if (got.data_ptr() != kw["out"].data_ptr() or not
                            same_bits(obuf[outside], before[outside])):
                        raise AssertionError(
                            f"{name} wrote outside its out= view: {where}")
                if not same_bits(got, want):
                    raise AssertionError(
                        f"{name} differs from its plain version: {where} "
                        f"{dtype} {func.name} "
                        f"max|diff|={max_abs_err(got, want)}")
                if (repair and n >= 4 and world > 1 and dtype in (
                        torch.float32, torch.float64, torch.bfloat16)):
                    # the repair: subnormals flushed, +0 above -0
                    if not ((got[:, :2] == 0).all() and not
                            torch.signbit(got[:, 2]).any()):
                        raise AssertionError(
                            f"{name} keeps a subnormal or orders "
                            f"zeros wrongly: {dtype} {func.name}")
                err = max(err, max_abs_err(got, want))
                by_path["vector" if path else "scalar"] += 1
                cases += 1
        if 0 in by_path.values():
            raise AssertionError(f"{name}: an instantiation never ran "
                                 f"{by_path}")
        errs[name] = err
        emit({"phase": "kernel", "kernel": name, "cases": cases,
              "cases_by_instantiation": by_path, "nan_cases": nan_cases,
              "repair_column_tensors": repair_cases,
              "bitwise_equal": True, "max_abs_err": err})
    errs["ring_allreduce_indirect"] = indirect_check(ring)
    return errs


def indirect_check(ring) -> float:
    """Kernel 1's indirect entry against the plain version on the CPU at
    the decode cell's launch shape: W = 8, 64 x 12288 fp32 columns a rank
    (one allreduce of the batch-64 token step, one launch). Three calls'
    operands are views of one flat tensor, as the benchmark's are, and
    each launch takes its two pointers from its own row of one device
    table; SUM and MAX, both directions, the vector instantiation and the
    scalar one (3 columns more, so rows and views lie off 16 bytes).
    Bitwise, or it raises; returns the largest |difference| (0.0)."""
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    world, calls, card = 8, 3, torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(2607)
    cases = 0
    for n, vec in ((64 * 12288, True), (64 * 12288 + 3, False)):
        flat = torch.randn(calls * world * n, generator=gen, device=card)
        xs = [flat[k * world * n:(k + 1) * world * n].view(world, n)
              for k in range(calls)]
        outs = [torch.empty_like(x) for x in xs]
        table = torch.tensor([p for x, o in zip(xs, outs)
                              for p in (x.data_ptr(), o.data_ptr())],
                             dtype=torch.int64, device=card)
        for func in (ReduceFunction.SUM, ReduceFunction.MAX):
            for dirs, wrapper in ((2, ring.ring_allreduce_bidir),
                                  (1, ring.ring_allreduce)):
                for o in outs:
                    o.fill_(7.0)
                for k in range(calls):
                    ring.ring_allreduce_indirect(
                        table.data_ptr() + 16 * k, card, torch.float32,
                        world, n, n, n, vec, func, dirs)
                torch.cuda.synchronize()
                for k, (x, o) in enumerate(zip(xs, outs)):
                    want = wrapper(x.cpu(), world, func)  # the plain version
                    if not same_bits(o.cpu(), want):
                        raise AssertionError(
                            f"ring_allreduce_indirect differs from the plain "
                            f"version: call {k} n={n} {func.name} "
                            f"dirs={dirs} max|diff|="
                            f"{max_abs_err(o.cpu(), want)}")
                    cases += 1
    emit({"phase": "kernel", "kernel": "ring_allreduce_indirect",
          "cases": cases, "shape": {"world": world, "n": 64 * 12288,
                                    "dtype": "float32", "calls": calls},
          "against": "plain version on the CPU", "bitwise_equal": True,
          "max_abs_err": 0.0})
    return 0.0


def check_against_float64(out, x, func, unit: float) -> float:
    """|out - sum(x)| <= (W-1)*u*sum|x_i| elementwise (MAX: exact); works
    in column blocks to bound the float64 temporaries."""
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    world, n = x.shape
    worst = 0.0
    for lo in range(0, n, 8 * MIB):
        xs = x[:, lo:lo + 8 * MIB].double()
        got = out[:, lo:lo + 8 * MIB].double()
        if func == ReduceFunction.MAX:
            ref = xs.amax(0, keepdim=True)
            bound = torch.zeros_like(ref)
        else:
            ref = xs.sum(0, keepdim=True)
            bound = (world - 1) * unit * xs.abs().sum(0, keepdim=True)
        excess = (got - ref).abs() - bound
        worst = max(worst, float(excess.max()))
        if worst > 0:
            raise AssertionError(
                f"allreduce result outside the bound by {worst}")
    return worst


def facade_phase(ring):
    import torch

    from accl_tpu_torch import ACCL
    from accl_tpu_torch.constants import ReduceFunction

    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [  # (world, bytes per rank, dtype, func, bitwise vs CPU)
        (8, 4 * 1024, torch.float32, ReduceFunction.SUM, False),
        (8, MIB, torch.float32, ReduceFunction.SUM, True),
        (8, 25 * MIB, torch.float32, ReduceFunction.SUM, True),
        (8, 256 * MIB, torch.float32, ReduceFunction.SUM, False),
        (8, 25 * MIB, torch.bfloat16, ReduceFunction.SUM, True),
        (8, MIB, torch.float32, ReduceFunction.MAX, True),
        (5, 329 * 4, torch.float32, ReduceFunction.SUM, False),
        (5, 1_000_003 * 4, torch.float32, ReduceFunction.SUM, False),
    ]
    accls = {8: ACCL(world=8), 5: ACCL(world=5)}
    for a in accls.values():
        if not a.cclo.compiler.use_ring_kernel:
            raise AssertionError("ACCL on the card must take the ring kernel")
    cpu_accl = ACCL(world=8, torch_device="cpu")
    cpu_accl.cclo.compiler.use_ring_kernel = True  # the kernel's plain version

    ring.ring_allreduce_bidir.launches = 0
    ring.ring_allreduce.launches = 0
    expected = 0
    kept = {}
    for world, nbytes, dtype, func, vs_cpu in cases:
        accl = accls[world]
        count = nbytes // dtype.itemsize
        x = rank_data(world, count, dtype, gen)
        sb = accl.create_buffer(count, dtype)
        rb = accl.create_buffer(count, dtype)
        sb.device.copy_(x)  # rank data made on the card, seeded
        before = ring.ring_allreduce_bidir.launches
        accl.allreduce(sb, rb, count, func, from_device=True, to_device=True)
        torch.cuda.synchronize()
        segs = math.ceil(count * dtype.itemsize / SEG_BYTES)
        launched = ring.ring_allreduce_bidir.launches - before
        if launched != segs:
            raise AssertionError(
                f"bidir kernel launched {launched} times for {segs} segments")
        expected += segs
        out = rb.device
        unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
        check_against_float64(out, x, func, unit)
        row_equal = bool((out == out[:1]).all())
        bitwise = None
        if vs_cpu:
            csb = cpu_accl.create_buffer(count, dtype, data=x.cpu())
            crb = cpu_accl.create_buffer(count, dtype)
            cpu_accl.allreduce(csb, crb, count, func)
            bitwise = same_bits(out.cpu(), crb.host)
            if not bitwise:
                raise AssertionError("card result differs from the plain "
                                     "kernel path on the CPU")
            cpu_accl.free_buffer(csb)
            cpu_accl.free_buffer(crb)
        emit({"phase": "facade", "world": world, "bytes_per_rank": nbytes,
              "count": count, "dtype": str(dtype).split(".")[-1],
              "func": func.name, "segments": segs, "launches": launched,
              "within_bound": True, "ranks_identical": row_equal,
              "bitwise_vs_cpu_plain": bitwise,
              "finite": bool(torch.isfinite(out).all())})
        if world == 8 and func == ReduceFunction.SUM:
            kept[(nbytes, dtype)] = (sb, rb, count)
        else:
            accl.free_buffer(sb)
            accl.free_buffer(rb)
    launches = {"ring_allreduce_bidir": ring.ring_allreduce_bidir.launches,
                "ring_allreduce": ring.ring_allreduce.launches}
    if launches["ring_allreduce_bidir"] != expected or expected == 0:
        raise AssertionError(f"main path launched {launches}, expected "
                             f"{expected} bidirectional launches")

    # one host-staged call: stage in from the host mirror, copy back out
    sb, rb, count = kept[(25 * MIB, torch.float32)]
    sb.sync_from_device()
    t0 = time.perf_counter()
    accls[8].allreduce(sb, rb, count, ReduceFunction.SUM)
    staged_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "facade", "host_staged": True, "bytes_per_rank": 25 * MIB,
          "host_clock_ms": staged_ms})
    return accls[8], kept, launches


def timing_phase(ring, accl, kept):
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    world = accl.world
    for (nbytes, dtype), (sb, rb, count) in sorted(
            kept.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        x = sb.device
        seg = SEG_BYTES // dtype.itemsize
        bounds = [(lo, min(lo + seg, count)) for lo in range(0, count, seg)]

        def facade():
            accl.allreduce(sb, rb, count, ReduceFunction.SUM,
                           from_device=True, to_device=True)

        res = torch.empty_like(x)

        def kernel_alone():  # the body's launches: one result, column views
            for lo, hi in bounds:
                ring.ring_allreduce_bidir(x[:, lo:hi], world,
                                          out=res[:, lo:hi])

        def plain():
            for lo, hi in bounds:
                ring.ring_allreduce_bidir_ref(x[:, lo:hi], world)

        def library():
            x.sum(0, keepdim=True).expand_as(x).contiguous()

        t = {"facade_ms": median_ms(facade), "kernel_ms": median_ms(kernel_alone),
             "kernel_device_ms": device_ms(kernel_alone, count=5),
             "plain_ms": median_ms(plain), "library_ms": median_ms(library)}
        bound_ms = 2 * world * count * dtype.itemsize / HBM_BYTES_PER_S * 1e3
        bus = 2 * (world - 1) / world * count * dtype.itemsize
        row = {"phase": "timing", "world": world, "bytes_per_rank": nbytes,
               "dtype": str(dtype).split(".")[-1], "segments": len(bounds),
               **t, "bound_ms": bound_ms,
               "facade_busbw_GBps": bus / (t["facade_ms"] * 1e-3) / 1e9,
               "kernel_busbw_GBps": bus / (t["kernel_ms"] * 1e-3) / 1e9}
        emit(row)


def breakdown_phase(ring):
    """Where a launch's time goes at W=8, fp32. Device side, with the host
    held off: t(n) = fixed + bytes(n) / rate, bytes(n) = 2*W*n*itemsize
    (every rank row read once, every output row written once, which is
    what the kernel moves); two launch sizes of the main path (2 MiB and
    4 MiB per rank) give the rate and the fixed cost per launch. Each
    launch takes the next of several operand and result pairs, 268 MB
    in all, so that it finds its data in device memory and not in the
    50 MB L2, as the segments of a large call do. Host side: the
    wrapper's cost per launch on the host clock, over launches of a
    one-element world-1 kernel the card finishes at once."""
    import itertools

    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    world = 8
    sizes = (SEG_BYTES // 8, SEG_BYTES // 4)  # 512 Ki and 1 Mi fp32 elements
    nbytes = [2 * world * n * 4 for n in sizes]
    t = []
    for n, b in zip(sizes, nbytes):
        pairs = [(rank_data(world, n, torch.float32, gen),
                  torch.empty((world, n), device="cuda"))
                 for _ in range(268_435_456 // b)]
        turn = itertools.cycle(pairs)

        def cold():
            x, out = next(turn)
            ring.ring_allreduce_bidir(x, world, out=out)

        t.append(device_ms(cold))
    ms_per_byte = (t[1] - t[0]) / (nbytes[1] - nbytes[0])
    fixed = t[0] - nbytes[0] * ms_per_byte
    one = rank_data(1, 1, torch.float32, gen)
    ring.ring_allreduce_bidir(one, 1)
    emit({"phase": "breakdown", "world": world,
          "bytes_per_launch": dict(zip(("2MiB", "4MiB"), nbytes)),
          "device_ms": dict(zip(("2MiB", "4MiB"), t)),
          "rate_TBps": 1e-9 / ms_per_byte,
          "fixed_device_ms": fixed,
          "fixed_share_4MiB": fixed / t[1],
          "host_ms_per_launch": host_ms(
              lambda: ring.ring_allreduce_bidir(one, 1))})


def quant_payload(rows: int, n: int, case: str, gen):
    """Rows of fp32 with one edge block (block 0 of every row), and a
    local operand with subnormals, signed zeros and, for "nan", a NaN."""
    import torch

    x = rank_data(rows, n, torch.float32, gen) * 3
    local = rank_data(rows, n, torch.float32, gen)
    local[:, ::7] = -1e-39
    local[:, 3::11] = -0.0
    m = min(n, 256)
    if case == "zero":
        x[:, :m] = 0.0
    elif case == "signed_zeros":  # a block of +-0 alone, then -0 beside values
        x[:, :m] = 0.0
        x[:, :m:2] = -0.0
        x[:, 256::3] = -0.0
    elif case == "negative_rail":
        x[:, :m] = torch.linspace(-8.0, 3.0, 256, device="cuda")[:m]
    elif case == "rail":  # codes -127 .. 127, the rails exactly
        x[:, :m] = torch.linspace(-127.0, 127.0, 256, device="cuda")[:m] / 64
    elif case == "subnormal":
        x[:, :m] = 1e-39
    elif case == "ties":  # quotients on and one ulp beside half-integers
        scale = torch.tensor(127.0) * torch.tensor(1 / 127)  # the fp32 rule
        half = torch.arange(m, device="cuda") % 254 - 126.5
        ties = (half * scale.item()).float()
        ties[1::2] = torch.nextafter(ties[1::2], ties[1::2] * 2)
        ties[0] = 127.0  # the block's max: scale 1.0, the quotients exact
        # other rows scaled: quotients within a few ulps of the ties
        x[:, :m] = ties * torch.linspace(1.0, 3.0, rows,
                                         device="cuda")[:, None]
    elif case == "nan":
        x[:, m // 2] = float("nan")
        local[0, n // 2] = float("nan")
    elif case == "inf":
        x[0, 0] = float("inf")
        x[-1, n - 1] = float("-inf")
    return x, local


QUANT_EDGE = ("random", "zero", "signed_zeros", "negative_rail", "rail",
              "subnormal", "ties", "nan", "inf")
# the wire message entries of kernels 5 and 6
QUANT_PACKED = {"quantize_packed": "quantize",
                "dequantize_packed": "dequantize"}


def same_message(a, b, n: int) -> bool:
    """Two int8 wire messages of n elements a row, bitwise: the codes
    byte for byte, the scale bytes as fp32 with a NaN matching any NaN."""
    import torch

    nb = -(-n // 256)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False

    def scales(m):
        return m[..., n:n + 4 * nb].clone(
            memory_format=torch.contiguous_format).view(torch.float32)

    return bool(same_bits(a[..., :n], b[..., :n])
                and same_bits(scales(a), scales(b))
                and same_bits(a[..., n + 4 * nb:], b[..., n + 4 * nb:]))


def same_result(entry: str, got, want, n: int) -> bool:
    """An entry's result (a tensor or a tuple of them) against its plain
    version's, bitwise; a wire message as same_message compares it."""
    if entry == "quantize_packed":
        return same_message(got, want, n)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(map(same_bits, got, want))


def quant_bounds_check(qk):
    """Kernels 5 and 6 write nothing outside their outputs: their C entry
    points, called with outputs that are views into wider buffers filled
    with a sentinel (codes and scales, a wire message, fp32 rows), in
    quantize's vector instantiation (16-byte-aligned views, n a multiple
    of 4 with a ragged last block) and the scalar one (views 1 or 3
    elements off, n % 4 != 0, so a message's scale bytes lie off a
    4-byte boundary), and dequantize's scalar lanes on both layouts,
    must leave every sentinel in place and write the plain version's
    values; a vector request to quantize on the scalar layouts must be
    refused (cudaErrorInvalidValue) without a write. Returns the cases by
    instantiation."""
    import torch

    from accl_tpu_torch.ops import compression as C

    lib = qk._library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(2357)
    by_path = {"vector": 0, "scalar": 0}

    def quantize(xv, q, s_ptr, ld_s):
        """The wrapper's launch of kernel 5 here: (launch taking a vector
        flag, the wrapper's flag)."""
        rows, n, ld_x, ld_q, ld_s, vec = qk.quant_launch(xv, q, s_ptr, ld_s)
        return (lambda v: lib.accl_quantize(
            xv.data_ptr(), ld_x, q.data_ptr(), ld_q, s_ptr, ld_s, rows, n,
            int(v), stream)), vec

    def dequantize(q, s_ptr, ld_s, out):
        """Kernel 6's launch here (scalar lanes only: no vector flag)."""
        rows, n, ld_o, ld_q, ld_s, _ = qk.quant_launch(out, q, s_ptr, ld_s)
        return (lambda _: lib.accl_dequantize(
            q.data_ptr(), ld_q, s_ptr, ld_s, out.data_ptr(), ld_o, rows, n,
            stream)), None

    def buffer(rows, width, dtype):
        fill = 90 if dtype == torch.int8 else -7.0
        return torch.full((rows, width), fill, dtype=dtype, device="cuda")

    for rows, n, lo in ((4, 1000, 16), (4, 1003, 3), (1, 4100, 16),
                        (1, 4099, 1)):
        nb, kind = -(-n // 256), ("aligned view" if lo == 16
                                  else "odd-stride view")
        width = n + 4 * nb
        x = lay_out(quant_payload(rows, n, "nan", gen)[0], kind)
        want_q, want_s = C._quantize_impl(x)
        want_msg = C.pack_wire(want_q, want_s)
        want_out = C._dequantize_impl(want_q, want_s)
        q_in, msg_in = lay_out(want_q, kind), lay_out(want_msg, kind)
        qbuf, sbuf = buffer(rows, n + 24, torch.int8), buffer(
            rows, nb + 8, torch.float32)
        mbuf = buffer(rows, width + 24, torch.int8)
        obuf = buffer(rows, n + 24, torch.float32)
        qv, sv = qbuf[:, lo:lo + n], sbuf[:, 1:1 + nb]
        mv, ov = mbuf[:, lo:lo + width], obuf[:, lo:lo + n]
        s_in = lay_out(want_s, kind)
        cases = (  # (entry, [(buffer, written columns)], (launch, vector
            # flag), (result, plain version) ...)
            ("quantize", [(qbuf, lo, lo + n), (sbuf, 1, 1 + nb)],
             quantize(x, qv, sv.data_ptr(), 4 * sv.stride(0)),
             (qv, want_q), (sv, want_s)),
            ("quantize_packed", [(mbuf, lo, lo + width)],
             quantize(x, mv, mv.data_ptr() + n, mv.stride(0)),
             (mv, want_msg)),
            ("dequantize", [(obuf, lo, lo + n)],
             dequantize(q_in, s_in.data_ptr(), 4 * s_in.stride(0), ov),
             (ov, want_out)),
            ("dequantize_packed", [(obuf, lo, lo + n)],
             dequantize(msg_in, msg_in.data_ptr() + n, msg_in.stride(0), ov),
             (ov, want_out)),
        )
        for entry, written, (launch, vec), *results in cases:
            for buf, _, _ in written:
                buf.fill_(90 if buf.dtype == torch.int8 else -7.0)
            before = [buf.clone() for buf, _, _ in written]
            where = f"{entry} {rows}x{n} at {lo}"
            if vec is False:  # a vector request is refused, nothing written
                err = launch(True)
                torch.cuda.synchronize()
                if err != 1 or not all(same_bits(buf, b) for (buf, _, _), b
                                       in zip(written, before)):
                    raise AssertionError(f"a misaligned vector request "
                                         f"returned {err} or wrote: {where}")
            err = launch(bool(vec))
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"{where}: entry point returned {err}")
            for (buf, a, b), old in zip(written, before):
                outside = torch.ones_like(buf, dtype=torch.bool)
                outside[:, a:b] = False
                if not same_bits(buf[outside], old[outside]):
                    raise AssertionError(f"{where} wrote outside its output")
            for got, want in results:
                if not same_result(entry, got, want, n):
                    raise AssertionError(f"{where} differs from its plain "
                                         "version")
            by_path["vector" if vec else "scalar"] += 1
    return by_path


def quant_kernel_phase(qk):
    """The four step kernels and the two wire message entries against
    their plain versions, bitwise (NaN matches NaN): rows {1, 2, 5, 8} x
    n {1, 32, 255, 257, 4099, 131072, 6553600} x the edge blocks of
    QUANT_EDGE; kernels 5 and 6 also over column views of wider buffers
    (aligned and odd-stride: codes, scales and messages as inputs) and
    through their C entry points into sentinel-filled buffers
    (quant_bounds_check), with their launches counted by instantiation."""
    import torch

    from accl_tpu_torch.ops import compression as C

    gen = torch.Generator(device="cuda").manual_seed(2468)
    names = (*QUANT_KERNELS, *QUANT_PACKED)
    cases = {name: 0 for name in names}
    errs = {name: 0.0 for name in names}
    by_path = {"vector": 0, "scalar": 0}

    def check(name, got, want, where, n=None):
        torch.cuda.synchronize()
        pairs = tuple(zip(*(t if isinstance(t, tuple) else (t,)
                            for t in (got, want))))
        if not same_result(name, got, want, n):
            raise AssertionError(
                f"{name} differs from its plain version: {where} max|diff|="
                f"{max(max_abs_err(g, w) for g, w in pairs)}")
        for g, w in pairs:
            errs[name] = max(errs[name], max_abs_err(g, w))
        cases[name] += 1

    def path(f, q, s_ptr, ld_s):  # a quantize launch's instantiation
        by_path["vector" if qk.quant_launch(f, q, s_ptr, ld_s)[-1]
                else "scalar"] += 1

    def kernels_5_6(x, n, where, q_as=None, msg_as=None):
        """Both entries of each kernel on x; dequantize reads the codes
        and the message laid out by q_as / msg_as (default: as made)."""
        nb = -(-n // 256)
        q, s = qk.quantize(x)
        check("quantize", (q, s), C._quantize_impl(x), where)
        path(x, q, s.data_ptr(), 4 * nb)
        msg = qk.quantize_packed(x)
        check("quantize_packed", msg, C.pack_wire(*C._quantize_impl(x)),
              where, n)
        path(x, msg, msg.data_ptr() + n, msg.stride(0))
        q = q if q_as is None else q_as(q)
        msg = msg if msg_as is None else msg_as(msg)
        check("dequantize", qk.dequantize(q, s), C._dequantize_impl(q, s),
              where)
        check("dequantize_packed", qk.dequantize_packed(msg, n),
              C._dequantize_impl(*C.unpack_wire(msg, n)), where)
        by_path["scalar"] += 2  # dequantize has only its scalar lanes
        return q, s

    for rows in (1, 2, 5, 8):
        for n in (1, 32, 255, 257, 4099, 131072, 6553600):
            for case in QUANT_EDGE:
                where = f"rows={rows} n={n} case={case}"
                x, local = quant_payload(rows, n, case, gen)
                q, s = kernels_5_6(x, n, where)
                for op in ("sum", "max"):
                    check("dequant_combine",
                          qk.dequant_combine(q, s, local, op),
                          C._dequant_combine_impl(q, s, local, op),
                          f"{where} {op}")
                    check("dequant_combine_requant",
                          qk.dequant_combine_requant(q, s, local, op),
                          C._dequant_combine_requant_impl(q, s, local, op),
                          f"{where} {op}")
    for rows, n in ((3, 1000), (8, 4099), (5, 131072 + 4), (1, 6553600)):
        for kind in ("aligned view", "odd-stride view"):
            x = lay_out(quant_payload(rows, n, "nan", gen)[0], kind)
            kernels_5_6(x, n, f"rows={rows} n={n} {kind}",
                        q_as=lambda t, kind=kind: lay_out(t, kind),
                        msg_as=lambda t, kind=kind: lay_out(t, kind))
    bounds = quant_bounds_check(qk)
    for k, v in bounds.items():
        by_path[k] += v
    if 0 in by_path.values():
        raise AssertionError(f"kernels 5 and 6: an instantiation never ran "
                             f"{by_path}")
    for name in names:
        emit({"phase": "quant_kernel", "kernel": name, "cases": cases[name],
              "bitwise_equal": True, "max_abs_err": errs[name]})
    emit({"phase": "quant_kernel_5_6", "launches_by_instantiation": by_path,
          "bounds_cases_by_instantiation": bounds, "written_outside": False,
          "misaligned_vector_refused": True})
    for packed, kernel in QUANT_PACKED.items():
        errs[kernel] = max(errs[kernel], errs.pop(packed))
    return errs


def check_quant_bound(out, x, func, seg: int) -> float:
    """Per segment: |out - reduce(x)| <= W*M*(1+W/254)/254 (+ (W-1)*u*
    sum|x_i| for SUM), M the segment's max of sum|x_i|: W quantization
    passes on each element's path (W-1 in the reduce-scatter, one in the
    allgather), each within half a step of its block's scale."""
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    world, n = x.shape
    worst = -math.inf
    for lo in range(0, n, seg):
        xs = x[:, lo:lo + seg].double()
        got = out[:, lo:lo + seg].double()
        absum = xs.abs().sum(0, keepdim=True)
        quant = world * float(absum.max()) * (1 + world / 254) / 254
        if func == ReduceFunction.MAX:
            ref = xs.amax(0, keepdim=True)
            bound = torch.full_like(ref, quant)
        else:
            ref = xs.sum(0, keepdim=True)
            bound = quant + (world - 1) * 2.0 ** -24 * absum
        worst = max(worst, float(((got - ref).abs() - bound).max()))
        if worst > 0:
            raise AssertionError(
                f"int8-wire allreduce outside its bound by {worst}")
    return worst


def ring_launch_count(count: int, seg: int) -> int:
    """Launches of the closed-form int8 ring for one call: one for the
    full segments, one for a ragged last one."""
    return int(count >= seg) + int(count % seg != 0)


def quant_facade_phase(qk, ring):
    """The int8-wire allreduce through the facade: the closed-form ring
    kernel, at most two launches a call, none of the four step kernels
    and no exact ring kernel. Returns its launch count over this path's
    run and the W=8 facade with its 25 MiB buffers."""
    import torch

    from accl_tpu_torch import ACCL, DataType
    from accl_tpu_torch.constants import ReduceFunction

    gen = torch.Generator(device="cuda").manual_seed(8642)
    accls = {"w8": ACCL(world=8, egr_rx_buf_size=QUANT_BUF),
             "w5": ACCL(world=5, egr_rx_buf_size=QUANT_BUF),
             "w8_default_buf": ACCL(world=8)}
    cpu_accl = ACCL(world=8, torch_device="cpu", egr_rx_buf_size=QUANT_BUF)
    cases = [  # (facade, count per rank, func, bitwise vs CPU)
        ("w8", MIB // 4, ReduceFunction.SUM, True),
        ("w8", 25 * MIB // 4, ReduceFunction.SUM, True),
        ("w8", MIB // 4, ReduceFunction.MAX, True),
        ("w5", 1_000_003, ReduceFunction.SUM, False),
        ("w8_default_buf", 64 * 1024 // 4, ReduceFunction.SUM, False),
    ]
    steps = {name: getattr(qk, name) for name in QUANT_KERNELS}
    kernel = qk.quant_ring_allreduce
    for k in (*steps.values(), kernel):
        k.launches = 0
    ring.ring_allreduce_bidir.launches = 0
    ring.ring_allreduce.launches = 0
    expected = 0
    kept = None
    for key, count, func, vs_cpu in cases:
        accl = accls[key]
        world = accl.world
        buf = accl.cclo.eager_rx_buf_size
        seg = ring_seg(world, buf)
        segs = math.ceil(count / seg)
        x = rank_data(world, count, torch.float32, gen)
        sb = accl.create_buffer(count)
        rb = accl.create_buffer(count)
        sb.device.copy_(x)
        before = kernel.launches
        req = accl.allreduce(sb, rb, count, func, from_device=True,
                             to_device=True, compress_dtype=DataType.int8)
        torch.cuda.synchronize()
        if req.plan.num_segments != segs:
            raise AssertionError(f"plan has {req.plan.num_segments} segments,"
                                 f" expected {segs}")
        launched = kernel.launches - before
        want = ring_launch_count(count, seg)
        if launched != want or launched > 2:
            raise AssertionError(f"quant_ring_allreduce launched {launched} "
                                 f"times, expected {want}")
        expected += want
        out = rb.device
        if not torch.equal(out, out[:1].expand_as(out)):
            raise AssertionError("int8-wire result differs between ranks")
        excess = check_quant_bound(out, x, func, seg)
        bitwise = None
        if vs_cpu:  # the CPU facade runs the torch-op ring's plain steps
            csb = cpu_accl.create_buffer(count, data=x.cpu())
            crb = cpu_accl.create_buffer(count)
            cpu_accl.allreduce(csb, crb, count, func,
                               compress_dtype=DataType.int8)
            bitwise = same_bits(out.cpu(), crb.host)
            if not bitwise:
                raise AssertionError("int8-wire card result differs from "
                                     "the port's CPU run")
            cpu_accl.free_buffer(csb)
            cpu_accl.free_buffer(crb)
        emit({"phase": "quant_facade", "world": world,
              "eager_rx_buf_size": buf, "bytes_per_rank": count * 4,
              "count": count, "func": func.name, "segments": segs,
              "launches": {QUANT_RING[0]: launched}, "within_bound": True,
              "bound_margin": -excess, "ranks_identical": True,
              "bitwise_vs_cpu_plain": bitwise,
              "finite": bool(torch.isfinite(out).all())})
        if key == "w8" and count == 25 * MIB // 4:
            kept = (sb, rb, count)
        else:
            accl.free_buffer(sb)
            accl.free_buffer(rb)
    if kernel.launches != expected or expected == 0:
        raise AssertionError(f"int8-wire allreduce launched "
                             f"{kernel.launches}, expected {expected}")
    stray = {name: k.launches for name, k in steps.items() if k.launches}
    if (stray or ring.ring_allreduce_bidir.launches
            or ring.ring_allreduce.launches):
        raise AssertionError(f"the int8-wire allreduce launched {stray} of "
                             "the step kernels or an exact ring kernel")
    return {QUANT_RING[0]: kernel.launches}, accls["w8"], kept


# (op, root) of the int8-wire collectives other than allreduce: where the
# four step kernels stay
QUANT_COLL_CASES = (("reduce", 3), ("reduce_scatter", 0), ("allgather", 0),
                    ("gather", 5), ("scatter", 2), ("bcast", 0))


def expected_quant_launches(op: str, world: int) -> dict:
    """Launches of the four step kernels one int8-wire call makes, from
    its eager plan: a hop of a mover (flat bcast and scatter, the
    gather's ring relay) is one encode and one decode; the allgather's
    ring encodes once and decodes W times; the ring reduce's hop is one
    encode and one fused decode+combine; the ring reduce-scatter encodes
    once, runs W-2 fused interior steps and one terminal one."""
    hops = world - 1
    return {
        "reduce": {"quantize": hops, "dequant_combine": hops},
        "reduce_scatter": {"quantize": 1, "dequant_combine_requant": hops - 1,
                           "dequant_combine": 1},
        "allgather": {"quantize": 1, "dequantize": world},
    }.get(op, {"quantize": hops, "dequantize": hops})


def quant_collectives_phase(qk):
    """The int8-wire collectives other than allreduce through the facade,
    W=8, at 25 MiB (the whole buffer, as nccl-tests sizes it) and 1 MiB:
    every result bitwise against the port's CPU run (the step kernels'
    plain versions), each call's step-kernel launches against its plan,
    with the (rows, n) of every launch, no launch of the closed-form
    ring, and 3 device operations a mover hop (mover_hop_ops). Returns the four step kernels' launch counts over this path's
    run, the shapes they launched at and the timing inputs."""
    import torch

    from accl_tpu_torch import ACCL

    gen = torch.Generator(device="cuda").manual_seed(4680)
    world = 8
    accl = ACCL(world=world)
    cpu = ACCL(world=world, torch_device="cpu")
    kernels = {name: getattr(qk, name) for name in QUANT_KERNELS}
    for k in (*kernels.values(), qk.quant_ring_allreduce):
        k.launches = 0
    for k in kernels.values():
        k.shapes = {}
    expected = {name: 0 for name in kernels}
    timing = []
    for op, root in QUANT_COLL_CASES:
        for nbytes in (COLL_BYTES, MIB):
            count = coll_count(op, world, nbytes // 4)
            width = count * world if op in WIDE_IN else count
            x = rank_data(world, width, torch.float32, gen)
            before = {k: f.launches for k, f in kernels.items()}
            seen = {k: dict(f.shapes) for k, f in kernels.items()}
            out, req = run_collective(accl, op, count, x, None, root, "SUM",
                                      "int8")
            launched = {k: f.launches - before[k] for k, f in kernels.items()}
            want = {k: expected_quant_launches(op, world).get(k, 0)
                    for k in kernels}
            if launched != want:
                raise AssertionError(f"int8-wire {op} launched {launched}, "
                                     f"expected {want}")
            for k in expected:
                expected[k] += want[k]
            cout, _ = run_collective(cpu, op, count, x.cpu(), None, root,
                                     "SUM", "int8")
            if not same_bits(out.cpu(), cout):
                raise AssertionError(f"int8-wire {op} at {nbytes} bytes "
                                     "differs from the port's CPU run")
            shapes = {k: [[*sh, c - seen[k].get(sh, 0)]
                          for sh, c in f.shapes.items()
                          if c > seen[k].get(sh, 0)]
                      for k, f in kernels.items()}
            emit({"phase": "quant_collective", "op": op, "world": world,
                  "root": root, "count": count, "buffer_bytes": nbytes,
                  "plan": req.plan.algorithm.name, "launches": launched,
                  "shapes": {k: v for k, v in shapes.items() if v},
                  "bitwise_vs_cpu": True,
                  "finite": bool(torch.isfinite(out).all())})
            if nbytes == COLL_BYTES:
                timing.append((op, world, nbytes // 4, torch.float32, "int8",
                               root, "SUM", count, x, None))
    launches = {k: f.launches for k, f in kernels.items()}
    if launches != expected or 0 in launches.values():
        raise AssertionError(f"int8-wire collectives launched {launches}, "
                             f"expected {expected}")
    if qk.quant_ring_allreduce.launches:
        raise AssertionError("an int8-wire collective launched the ring")
    shapes = {k: dict(f.shapes) for k, f in kernels.items()}
    emit({"phase": "quant_shapes",
          "launches_by_shape": {k: [[*sh, c] for sh, c in v.items()]
                                for k, v in shapes.items()}})
    hop_ops = mover_hop_ops(COLL_BYTES // 4)
    emit({"phase": "quant_mover_hop", "shape": [1, COLL_BYTES // 4],
          "device_ops": hop_ops})
    if hop_ops != 3:  # quantize_packed, dequantize_packed, the row copy
        raise AssertionError(f"an int8-wire mover hop ran {hop_ops} device "
                             "operations, not 3")
    return launches, shapes, ({world: accl}, timing)


def mover_hop_ops(n: int) -> int:
    """Device operations of one int8-wire mover hop at (1, n), the flat
    bcast's `out[j:j+1] = wire.transfer(x[root:root+1])`, counted under
    torch.profiler: the encode, what carries the message, the decode
    and the copy into the receiving row."""
    import torch

    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
    from accl_tpu_torch.constants import DataType
    from accl_tpu_torch.sequencer import schedules

    wire = schedules.Wire(DEFAULT_ARITH_CONFIG[(DataType.float32,
                                                DataType.int8)])
    gen = torch.Generator(device="cuda").manual_seed(4242)
    x = rank_data(8, n, torch.float32, gen)
    out = x.clone()

    def hop():
        out[1:2] = wire.transfer(x[0:1])

    return profile_call(hop)["device_kernels"]


def quant_collectives_timing_phase(qk, accls, timing):
    """The six int8-wire collectives at 25 MiB, W=8: facade time (median
    of 20, CUDA events around the whole call) and one flat bcast under
    the profiler (device operations a call, busy time, idle share)."""
    time_collectives(accls, timing, "quant_collective_timing",
                     profiled={("bcast", "int8")})


def cold_fit(make, call, nbytes, shapes) -> dict:
    """Device time with the host held off over cold operands at each of
    two shapes: each launch takes the next of several operand sets
    (`make(rows, n)`), 268 MB or more in all, and the last results are
    held, so that each launch finds its data in device memory and writes
    a block of its own; then the fit t = fixed + bytes / rate."""
    import collections
    import itertools

    t, sizes = [], []
    for rows, n in shapes:
        b = nbytes(rows, n)
        sets = [make(rows, n) for _ in range(max(2, -(-268_435_456 // b)))]
        turn = itertools.cycle(sets)
        held = collections.deque(maxlen=len(sets))
        t.append(device_ms(lambda: held.append(call(next(turn)))))
        sizes.append(b)
        del sets, turn, held
    ms_per_byte = (t[1] - t[0]) / (sizes[1] - sizes[0])
    return {"cold_shapes": [list(sh) for sh in shapes],
            "cold_bytes_per_launch": sizes, "cold_device_ms": t,
            "rate_TBps": 1e-9 / ms_per_byte,
            "fixed_device_ms": t[0] - sizes[0] * ms_per_byte}


def quant_shape_entries(qk):
    """Per quantized step kernel: its entry points, the one its path takes
    most first (the packed entries for the mover hops), each as (operand
    set made from (rows, n) fp32 rows, launch on a set, plain version on
    a set); the fused pair over SUM."""
    import torch

    from accl_tpu_torch.ops import compression as C

    gen = torch.Generator(device="cuda").manual_seed(1113)

    def rows_of(rows, n):
        return rank_data(rows, n, torch.float32, gen)

    def arrival(rows, n):  # (codes, scales, local operand)
        return (*qk.quantize(rows_of(rows, n)), rows_of(rows, n))

    return {
        "quantize": {
            "quantize_packed": (rows_of, qk.quantize_packed,
                                lambda x: C.pack_wire(*C._quantize_impl(x))),
            "quantize": (rows_of, qk.quantize, C._quantize_impl)},
        "dequantize": {
            "dequantize_packed": (
                lambda rows, n: (qk.quantize_packed(rows_of(rows, n)), n),
                lambda a: qk.dequantize_packed(*a),
                lambda a: C._dequantize_impl(*C.unpack_wire(*a))),
            "dequantize": (lambda rows, n: qk.quantize(rows_of(rows, n)),
                           lambda enc: qk.dequantize(*enc),
                           lambda enc: C._dequantize_impl(*enc))},
        "dequant_combine": {"dequant_combine": (
            arrival, lambda a: qk.dequant_combine(*a, "sum"),
            lambda a: C._dequant_combine_impl(*a, "sum"))},
        "dequant_combine_requant": {"dequant_combine_requant": (
            arrival, lambda a: qk.dequant_combine_requant(*a, "sum"),
            lambda a: C._dequant_combine_requant_impl(*a, "sum"))},
    }


def quant_shapes_phase(qk, shapes):
    """The four step kernels at every launch shape of the int8
    collectives' path (`shapes`, launches by (rows, n)) and at
    (8, 131072), one rank chunk of a 4 MiB segment at W=8: device time
    with the host held off on one operand set (warm) and the bound
    (quant_bytes over 3.35 TB/s) through the entry the path takes most,
    each held bitwise against its plain version first; at the two largest
    path shapes (by elements, then launches) and at (8, 131072) through
    every entry, with the plain version's device time (10 calls), events
    around back-to-back calls, the wrapper's host cost per launch and a
    cold two-size fit at the shape and at half its rows' length. Then
    each kernel's launches x (time - bound) summed over its path shapes.
    Returns per kernel the row of its first entry at its largest path
    shape, with that sum, for the kernels line."""
    out = {}
    chunk = (8, QUANT_BUF // 4 // 8)
    for name, entries in quant_shape_entries(qk).items():
        path = sorted(shapes[name], key=lambda sh: (sh[0] * sh[1],
                                                     shapes[name][sh]),
                      reverse=True)
        gap = 0.0
        for shape in (*path, *([] if chunk in path else [chunk])):
            rows, n = shape
            full = shape in path[:2] or shape == chunk
            for i, (entry, (make, call, plain)) in enumerate(entries.items()):
                if i and not full:
                    continue
                warm = make(rows, n)
                if not same_result(entry, call(warm), plain(warm), n):
                    raise AssertionError(f"{entry} differs from its plain "
                                         f"version at {shape}")
                row = {"phase": "quant_shape_timing", "kernel": name,
                       "entry": entry, "shape": [rows, n],
                       "path_launches": shapes[name].get(shape, 0),
                       "device_ms": device_ms(lambda: call(warm)),
                       "bound_ms": quant_bytes(name, rows, n)
                       / HBM_BYTES_PER_S * 1e3}
                if full:
                    row["plain_ms"] = device_ms(lambda: plain(warm), count=10)
                    row["back_to_back_ms"] = run_ms(lambda: call(warm))
                    row["host_ms_per_launch"] = host_ms(lambda: call(warm))
                    row.update(cold_fit(make, call,
                                        lambda r, m: quant_bytes(name, r, m),
                                        ((rows, n // 2), (rows, n))))
                del warm
                emit(row)
                if i == 0:
                    gap += row["path_launches"] * (row["device_ms"]
                                                   - row["bound_ms"])
                    if shape == path[0]:
                        out[name] = row
        out[name]["launches_x_gap_ms"] = gap
        emit({"phase": "quant_path_gap", "kernel": name,
              "path_launches": sum(shapes[name].values()),
              "launches_x_gap_ms": gap})
    return out


def quant_timing_phase(qk, accl, kept):
    """The int8-wire facade at 25 MiB per rank beside the exact wire on
    the same buffers and facade, in turns, and one int8 call under the
    profiler with its launches of the closed-form ring and of the four
    step kernels counted."""
    from accl_tpu_torch import DataType
    from accl_tpu_torch.constants import ReduceFunction

    sb, rb, count = kept

    def call(wire):
        return lambda: accl.allreduce(sb, rb, count, ReduceFunction.SUM,
                                      from_device=True, to_device=True,
                                      compress_dtype=wire)

    t = {"exact_ms": median_ms(call(None)), "int8_ms": median_ms(call(DataType.int8))}
    t["exact_ms_again"] = median_ms(call(None))
    t["int8_ms_again"] = median_ms(call(DataType.int8))
    emit({"phase": "quant_timing", "world": accl.world,
          "bytes_per_rank": count * 4, "eager_rx_buf_size": QUANT_BUF,
          "segments": math.ceil(count / (QUANT_BUF // 4)), **t,
          "int8_over_exact": t["int8_ms"] / t["exact_ms"]})
    kernels = {name: getattr(qk, name)
               for name in (QUANT_RING[0], *QUANT_KERNELS)}
    before = {name: k.launches for name, k in kernels.items()}
    row = profile_call(call(DataType.int8))  # two calls: warm-up, profiled
    launched = {name: (k.launches - before[name]) // 2
                for name, k in kernels.items()}
    if launched[QUANT_RING[0]] > 2 or any(
            launched[name] for name in QUANT_KERNELS):
        raise AssertionError(f"an int8-wire allreduce launched {launched}")
    emit({"phase": "quant_profile", "launches_per_call": launched, **row})


def cast_wire_timing_phase():
    """The fp16 and bf16 wires with the arithmetic in fp32 (rows whose
    arith_is_compressed is False, given to the facade and to its
    schedule compiler: every hop casts to the wire dtype and back, every
    fold is fp32), which keep the torch-op ring on the card: the
    allreduce at W=8 and 25 MiB per rank with a 4 MiB eager buffer (the
    int8 cases' 7 segments; the default 1 KiB buffer cuts 25 600), facade
    time (median of 20,
    CUDA events) beside the exact wire in the same run, one call under
    the profiler; first held bitwise against the port's CPU run at
    1 MiB."""
    import torch

    from accl_tpu_torch import ACCL, DataType
    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
    from accl_tpu_torch.constants import ReduceFunction

    table = dict(DEFAULT_ARITH_CONFIG)
    for wire, lanes in ((DataType.float16, (0, 1)),
                        (DataType.bfloat16, (2, 3))):
        table[(DataType.float32, wire)] = ArithConfig(4, 2, 0, *lanes, False,
                                                      (0, 5))
    accl = ACCL(world=8, arith_config=table, egr_rx_buf_size=QUANT_BUF)
    cpu = ACCL(world=8, torch_device="cpu", arith_config=table,
               egr_rx_buf_size=QUANT_BUF)
    for a in (accl, cpu):  # the lowering reads its own table, as the
        a.cclo.compiler.arith_table = table  # reference's does
    gen = torch.Generator(device="cuda").manual_seed(5791)
    for wire in (DataType.float16, DataType.bfloat16):
        count = MIB // 4
        x = rank_data(8, count, torch.float32, gen)
        sb, rb = accl.create_buffer(count), accl.create_buffer(count)
        sb.device.copy_(x)
        accl.allreduce(sb, rb, count, ReduceFunction.SUM, from_device=True,
                       to_device=True, compress_dtype=wire)
        csb = cpu.create_buffer(count, data=x.cpu())
        crb = cpu.create_buffer(count)
        req = cpu.allreduce(csb, crb, count, ReduceFunction.SUM,
                            compress_dtype=wire)
        if not same_bits(rb.device.cpu(), crb.host):
            raise AssertionError(f"{wire.name}-wire allreduce differs from "
                                 "the port's CPU run")
        for b in (sb, rb):
            accl.free_buffer(b)
        count = 25 * MIB // 4
        sb, rb = accl.create_buffer(count), accl.create_buffer(count)
        sb.device.copy_(rank_data(8, count, torch.float32, gen))

        def call(cd, sb=sb, rb=rb, count=count):
            return lambda: accl.allreduce(sb, rb, count, ReduceFunction.SUM,
                                          from_device=True, to_device=True,
                                          compress_dtype=cd)

        t = {"exact_ms": median_ms(call(None)),
             "facade_ms": median_ms(call(wire))}
        t["exact_ms_again"] = median_ms(call(None))
        t["facade_ms_again"] = median_ms(call(wire))
        emit({"phase": "cast_wire_timing", "wire": wire.name, "world": 8,
              "bytes_per_rank": count * 4, "plan": req.plan.algorithm.name,
              "bitwise_vs_cpu_1MiB": True, **t,
              "profile": profile_call(call(wire))})
        for b in (sb, rb):
            accl.free_buffer(b)


def profile_call(fn) -> dict:
    """One call under torch.profiler: its host-clock time (profiler on),
    the device's busy time (the sum of its kernels' durations) and idle
    share, and the host operations that cost the most CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) * 1e-3
    by_cpu = sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:8]
    return {"wall_ms_profiled": wall_ms, "device_kernels": len(kernels),
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "top_host_ops": [{"op": e.key, "count": e.count,
                              "self_cpu_ms": e.self_cpu_time_total * 1e-3}
                             for e in by_cpu]}


def quant_bytes(name: str, rows: int, n: int) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    nb = -(-n // 256)
    codes, scales, fp32 = n, 4 * nb, 4 * n
    per_row = {"quantize": fp32 + codes + scales,
               "dequantize": codes + scales + fp32,
               "dequant_combine": codes + scales + fp32 + fp32,
               "dequant_combine_requant": codes + scales + fp32 + codes + scales,
               }[name]
    return rows * per_row


RING_SPECIAL = ("random", "zero_blocks", "signed_zeros", "subnormal", "nan",
                "inf", "rail")


def ring_payload(world: int, count: int, case: str, gen):
    """(world, count) fp32 rank rows on the card with one kind of
    special-valued blocks, as tests/test_torch_quant_ring.py makes them:
    all-zero blocks, +-0 in both orders across ranks, 1e-39 (flushed),
    NaN, +-Inf (and Inf on every rank: Inf/Inf quotients), values on the
    +-127 codes of their scale."""
    import torch

    x = rank_data(world, count, torch.float32, gen) * 3
    if case == "zero_blocks":
        x[:, :300] = 0.0
        x[:, count // 2:count // 2 + 260] = 0.0
    elif case == "signed_zeros":
        x[::2, ::5] = -0.0
        x[1::2, ::5] = 0.0
        x[0, 1::5] = 0.0
        x[1:, 1::5] = -0.0
        x[:, 2::5] = -0.0
    elif case == "subnormal":
        x[:, ::3] = 1e-39
        x[-1, 1::3] = -1e-39
        x[:, :256] = 1e-39
    elif case == "nan":
        x[world // 2, 7 % count] = float("nan")
        x[0, count - 1] = float("nan")
    elif case == "inf":
        x[0, 3 % count] = float("inf")
        x[-1, count // 2] = float("-inf")
        x[:, count - 1] = float("inf")
    elif case == "rail":
        k = min(count, 256)
        x[:, :k] = torch.linspace(-127.0, 127.0, k, device="cuda") / 64
        x[0, count - 1] = -1270.0
    return x


def ring_seg(world: int, buf: int) -> int:
    """The int8 allreduce plan's segment for an eager buffer of buf
    bytes: its fp32 elements, rounded down to a multiple of the world."""
    seg = buf // 4
    return max(seg - seg % world, world)


def quant_ring_phase(qk):
    """The closed-form int8 ring allreduce against its plain version and
    against the torch-op quantized ring (the four step kernels hop by
    hop), both on the card, bitwise (NaN matches NaN): worlds {1, 2, 3,
    5, 7, 8} x per-rank counts {1, 31, 255, 257, 4099, 1<<20} x two eager
    buffers each (ragged last segments; chunk lengths that are no
    multiple of 4 or 256) x SUM and MAX x the special-valued blocks of
    RING_SPECIAL; then odd-stride and aligned column views as operand and
    as out= (nothing written outside), with the launches counted by
    instantiation, and a misaligned vector request refused."""
    import torch

    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
    from accl_tpu_torch.constants import DataType, ReduceFunction
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.sequencer import schedules

    wire = schedules.Wire(DEFAULT_ARITH_CONFIG[(DataType.float32,
                                                DataType.int8)])
    gen = torch.Generator(device="cuda").manual_seed(97)
    by_path = {"vector": 0, "scalar": 0}
    cases, ragged, err = 0, 0, 0.0

    def check(x, world, func, seg, out=None, where=""):
        nonlocal cases, ragged, err
        op = schedules.quant_op(func)
        got = qk.quant_ring_allreduce(x, world, op, seg, out=out)
        launches = qk.ring_launches(x, got, world, seg)
        for want, what in ((C._quant_ring_impl(x, world, op, seg), "plain"),
                           (schedules.allreduce_ring_schedule(
                               x, func=func, world=world, wire=wire,
                               seg_count=seg), "torch-op ring")):
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(
                    f"quant_ring_allreduce differs from the {what}: {where} "
                    f"W={world} {op} seg={seg} "
                    f"max|diff|={max_abs_err(got, want)}")
            err = max(err, max_abs_err(got, want))
        for *_, vec in launches:
            by_path["vector" if vec else "scalar"] += 1
        ragged += x.shape[-1] % seg != 0
        cases += 1
        return got

    for world in (1, 2, 3, 5, 7, 8):
        for count in (1, 31, 255, 257, 4099, 1 << 20):
            bufs = (QUANT_BUF, MIB) if count == 1 << 20 else (1024, 4096)
            for buf in bufs:
                for case in RING_SPECIAL:
                    x = ring_payload(world, count, case, gen)
                    for func in (ReduceFunction.SUM, ReduceFunction.MAX):
                        check(x, world, func, ring_seg(world, buf),
                              where=f"n={count} buf={buf} {case}")
    views = 0
    for world in (3, 5, 8):
        for count in (4099, 1 << 20, (1 << 20) + 5):
            seg = ring_seg(world, QUANT_BUF)
            x = ring_payload(world, count, "random", gen)
            for kind in ("aligned view", "odd-stride view"):
                xv = lay_out(x, kind)
                obuf = torch.full((world, count + 40), -7.0, device="cuda")
                lo = 16 if kind == "aligned view" else 3
                before = obuf.clone()
                for func in (ReduceFunction.SUM, ReduceFunction.MAX):
                    check(xv, world, func, seg, where=f"n={count} {kind}")
                    check(x, world, func, seg, out=obuf[:, lo:lo + count],
                          where=f"n={count} out= {kind}")
                outside = torch.ones_like(obuf, dtype=torch.bool)
                outside[:, lo:lo + count] = False
                if not same_bits(obuf[outside], before[outside]):
                    raise AssertionError("quant_ring_allreduce wrote outside "
                                         f"its out= view: {kind}")
                views += 1
    # a vector request on an odd-stride view is refused, nothing written
    lib = qk._library()
    x = lay_out(ring_payload(8, 4096, "random", gen), "odd-stride view")
    obuf = torch.full((8, 4096 + 7), -7.0, device="cuda")
    before = obuf.clone()
    rc = lib.accl_quant_ring(0, x.data_ptr(), x.stride(0),
                             obuf[:, 3:].data_ptr(), obuf.stride(0), 8, 1,
                             4096, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 1 or not same_bits(obuf, before):
        raise AssertionError(f"a misaligned vector request returned {rc} or "
                             "wrote")
    if 0 in by_path.values():
        raise AssertionError(f"quant_ring_allreduce: an instantiation never "
                             f"ran {by_path}")
    emit({"phase": "quant_ring", "cases": cases,
          "launches_by_instantiation": by_path,
          "ragged_last_segment_cases": ragged, "view_layouts": views,
          "bitwise_vs_plain": True, "bitwise_vs_torch_op_ring": True,
          "written_outside": False, "misaligned_vector_refused": True,
          "max_abs_err": err})
    return {QUANT_RING[0]: err}


def quant_ring_breakdown_phase(qk):
    """The closed-form int8 ring at the main path's launch, one 4 MiB
    segment at W=8 ((8, 1 048 576) fp32), held bitwise against its plain
    version there; device time with the host held off (warm: repeated on
    the same operand, as the kernels line times every kernel), beside
    events around back-to-back launches, the wrapper's host cost per
    launch, the plain version (back to back), the torch-op quantized
    ring it replaces on the same segment (events around one call:
    host-bound) and the bound, 2*W*n*4 bytes over 3.35 TB/s. Then cold,
    at 2 MiB and 4 MiB per rank (cold_fit)."""
    import torch

    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
    from accl_tpu_torch.constants import DataType, ReduceFunction
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.sequencer import schedules

    gen = torch.Generator(device="cuda").manual_seed(31)
    world, n = 8, QUANT_BUF // 4
    x = rank_data(world, n, torch.float32, gen)
    wire = schedules.Wire(DEFAULT_ARITH_CONFIG[(DataType.float32,
                                                DataType.int8)])

    def kernel():
        return qk.quant_ring_allreduce(x, world, "sum", n)

    def plain():
        return C._quant_ring_impl(x, world, "sum", n)

    def torch_op_ring():
        return schedules.allreduce_ring_schedule(
            x, func=ReduceFunction.SUM, world=world, wire=wire, seg_count=n)

    got, want = kernel(), plain()
    if not same_bits(got, want):
        raise AssertionError("quant_ring_allreduce differs from its plain "
                             f"version at (8, {n}): "
                             f"max|diff|={max_abs_err(got, want)}")
    del got, want
    row = {"shape": [world, n], "bitwise_equal": True,
           "device_ms": device_ms(kernel), "back_to_back_ms": run_ms(kernel),
           "host_ms_per_launch": host_ms(kernel),
           # the plain version's ~300 operations a call fill the launch
           # queue behind a spin: timed back to back, device-bound
           "plain_ms": run_ms(plain),
           "torch_op_ring_ms": median_ms(torch_op_ring),
           "bound_ms": 2 * world * n * 4 / HBM_BYTES_PER_S * 1e3,
           **cold_fit(lambda r, m: rank_data(r, m, torch.float32, gen),
                      lambda t: qk.quant_ring_allreduce(t, world, "sum",
                                                        t.shape[1]),
                      lambda r, m: 2 * r * m * 4,
                      ((world, n // 2), (world, n)))}
    emit({"phase": "quant_ring_breakdown", **row})
    return row


LANE_SPECIAL = [  # (a, b) pairs, in float64 before the cast to the dtype
    (0.0, -0.0), (-0.0, 0.0), (-0.0, -0.0), (1e-39, 0.0), (0.0, 1e-39),
    (1e-39, 1e-39), (-1e-39, 0.0), (1e-39, -1e-39), (1e-310, 0.0),
    (1e-310, -1e-310), (6e-8, 0.0), (6e-8, -6e-8), (math.nan, 0.0),
    (0.0, math.nan), (math.inf, -math.inf), (math.inf, 1.0),
    (-math.inf, -math.inf), (65504.0, 65504.0), (-65504.0, -65504.0),
    (65520.0, 0.0), (3.4e38, 3.4e38),
]
CAST_SPECIAL = [1e-39, 1e-40, -1e-39, 7e-8, -0.0, math.nan, math.inf,
                -math.inf, 65520.0, 3.4e38, 1.2e-38, 6e-8]


def lane_operands(rows: int, n: int, dtype, gen):
    """(a, b) rows of a lane dtype: random values with the special pairs
    in row 0 and, reversed, in the last row; integers with the wrap
    pairs."""
    import torch

    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        a, b = (torch.randint(info.min, info.max, (rows, n), generator=gen,
                              device="cuda", dtype=dtype) for _ in range(2))
        wrap = [(info.max, 1), (info.min, -1), (info.max, info.max),
                (-1, info.min)][:n]
        for k, (u, v) in enumerate(wrap):
            a[0, k], b[0, k] = u, v
        return a, b
    a, b = (torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    sp = torch.tensor(LANE_SPECIAL[:n], dtype=torch.float64).to(dtype).cuda()
    a[0, :len(sp)], b[0, :len(sp)] = sp[:, 0], sp[:, 1]
    a[-1, :len(sp)], b[-1, :len(sp)] = sp.flip(0)[:, 1], sp.flip(0)[:, 0]
    return a, b


def cast_operand(rows: int, n: int, dtype, gen):
    """Rows of a cast's source dtype: random values up to f16 overflow,
    the cast's special values in row 0."""
    import torch

    x = (torch.randn((rows, n), generator=gen, device="cuda") * 3000).to(
        dtype)
    sp = torch.tensor(CAST_SPECIAL[:n], dtype=torch.float64)
    x[0, :len(sp)] = sp.to(dtype).cuda()
    return x


def lane_cases(L):
    """(kernel name, description, operands, kernel call, plain call) over
    every dtype and op of the lane kernels' path, and every (in, out)
    pair of combine_cast."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3579)
    for rows in (1, 2, 5, 8):
        for n in (1, 127, 128, 129, 4099, 1 << 20):
            for dtype in (torch.float32, torch.float64, torch.int32,
                          torch.int64):
                a, b = lane_operands(rows, n, dtype, gen)
                for op in ("sum", "max"):
                    yield ("combine", f"{rows}x{n} {dtype} {op}", (a, b),
                           lambda a=a, b=b, op=op: L.combine(a, b, op),
                           lambda a=a, b=b, op=op: L._combine_impl(a, b, op))
            for dtype in L.COMBINE_CAST_DTYPES:
                a, b = lane_operands(rows, n, dtype, gen)
                for out in L.COMBINE_CAST_DTYPES:
                    for op in ("sum", "max"):
                        yield combine_cast_case(L, f"{rows}x{n}", a, b, op,
                                                out)
            for src, dst in L.CAST_PAIRS:
                x = cast_operand(rows, n, src, gen)
                yield cast_case(L, f"{rows}x{n}", x, dst)


def combine_cast_case(L, where, a, b, op, out):
    import torch

    return ("combine_cast", f"{where} {a.dtype}->{out} {op}", (a, b),
            lambda: L.combine_cast(a, b, op, torch.float32, out),
            lambda: L._combine_cast_impl(a, b, op, torch.float32, out))


def cast_case(L, where, x, dst):
    return ("cast", f"{where} {x.dtype}->{dst}", (x,),
            lambda: L.cast(x, dst),
            lambda: L._cast_impl(x, dst))


def lay_out(x, kind: str):
    """x's values in another layout: a column view of a wider buffer, at
    element 16 of rows a multiple of 8 elements wide (16-byte-aligned
    base and row stride for every dtype) or at element 3 of rows n + 7
    wide (odd stride); contiguous rows whose base is 2 or 4 bytes off a
    16-byte multiple; or x itself."""
    import torch

    rows, n = x.shape
    if kind in ("aligned view", "odd-stride view"):
        width, lo = ((-(-n // 8) * 8 + 32, 16) if kind == "aligned view"
                     else (n + 7, 3))
        buf = torch.full((rows, width), -3.0, device="cuda").to(x.dtype)
        view = buf[:, lo:lo + n]
    elif kind.startswith("base+"):
        off = int(kind[5:-1]) // x.itemsize
        flat = torch.full((rows * n + 8,), -3.0, device="cuda").to(x.dtype)
        view = flat[off:off + rows * n].view(rows, n)
    else:
        return x
    view.copy_(x)
    return view


# (rows, n, layouts) of the layout cases: views of wider buffers (vector
# when aligned, scalar at an odd stride; 70 000 rows pass grid.y's 65 535
# and make the walk stride over rows), bases 2, 4 and 8 bytes off (scalar),
# one row with a ragged tail inside a vector launch, and contiguous rows
# with odd n (folded into one row)
LANE_LAYOUTS = (
    [(rows, n, ("aligned view", "odd-stride view"))
     for rows in (3, 8) for n in (1000, 4099, 65536 + 5)]
    + [(70_000, 9, ("aligned view", "odd-stride view"))]
    + [(rows, n, ("base+2B", "base+4B", "base+8B")) for rows in (1, 5)
       for n in (1000, 4099)]
    + [(1, 8 * 1000 + r, ("contiguous",)) for r in range(1, 8)]
    + [(rows, n, ("contiguous",)) for rows, n in ((5, 4099), (8, 1001),
                                                  (3, 131073))])


def lane_layout_cases(L):
    """The three lane kernels over the layouts that choose their
    instantiation (LANE_LAYOUTS): combine over its dtypes, every (in,
    out) pair of combine_cast, every cast, SUM and MAX; a base is never
    off by less than its element."""
    import torch

    def fits(kind, dtype):
        return not kind.startswith("base+") or int(kind[5:-1]) % (
            torch.empty(0, dtype=dtype).element_size()) == 0

    gen = torch.Generator(device="cuda").manual_seed(8642)
    for rows, n, kinds in LANE_LAYOUTS:
        for kind in kinds:
            where = f"{rows}x{n} {kind}"
            for dtype in L.COMBINE_DTYPES:
                if not fits(kind, dtype):
                    continue
                a, b = (lay_out(t, kind)
                        for t in lane_operands(rows, n, dtype, gen))
                for op in ("sum", "max"):
                    yield ("combine", f"{where} {dtype} {op}", (a, b),
                           lambda a=a, b=b, op=op: L.combine(a, b, op),
                           lambda a=a, b=b, op=op: L._combine_impl(a, b, op))
            for dtype in L.COMBINE_CAST_DTYPES:
                if not fits(kind, dtype):
                    continue
                a, b = (lay_out(t, kind)
                        for t in lane_operands(rows, n, dtype, gen))
                for out in L.COMBINE_CAST_DTYPES:
                    for op in ("sum", "max"):
                        yield combine_cast_case(L, where, a, b, op, out)
            for src, dst in L.CAST_PAIRS:
                if not fits(kind, src):
                    continue
                yield cast_case(L, where,
                                lay_out(cast_operand(rows, n, src, gen), kind),
                                dst)


def lane_bounds_check(L):
    """The lane kernels write nothing outside their output: their C entry
    points, called with an output that is a view into a wider buffer
    filled with a sentinel (inputs in the same layout), in the vector
    instantiation (aligned views with a ragged n per row; one row with a
    ragged tail) and the scalar one (odd stride; one row 2 bytes off),
    must leave every sentinel in place and write the plain version's
    values; a vector request on the misaligned layouts must be refused
    (cudaErrorInvalidValue) without a write. Returns the cases by
    instantiation."""
    import torch

    lib = L._library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(1357)
    by_path = {"vector": 0, "scalar": 0}
    layouts = ((4, 1003, 1040, 16), (4, 1003, 1010, 3),
               (1, 8 * 1000 + 5, 8 * 1000 + 24, 8),
               (1, 8 * 1000 + 5, 8 * 1000 + 24, 1))
    for rows, n, width, lo in layouts:
        def place(t):
            buf = torch.full((rows, width), -7.0, device="cuda").to(t.dtype)
            buf[:, lo:lo + n] = t
            return buf

        calls = []
        for dtype in L.COMBINE_DTYPES:
            a, b = (place(t)[:, lo:lo + n]
                    for t in lane_operands(rows, n, dtype, gen))
            for op in ("sum", "max"):
                calls.append((
                    dtype, (a, b),
                    lambda ops, view, vec, sh, dtype=dtype, op=op:
                    lib.accl_lane_combine(
                        L._CODES[dtype], L._op(op), ops[0].data_ptr(),
                        sh[2][0], ops[1].data_ptr(), sh[2][1],
                        view.data_ptr(), sh[2][2], sh[0], sh[1], vec, stream),
                    lambda a=a, b=b, op=op: L._combine_impl(a, b, op)))
        for src in L.COMBINE_CAST_DTYPES:
            a, b = (place(t)[:, lo:lo + n]
                    for t in lane_operands(rows, n, src, gen))
            for dst in L.COMBINE_CAST_DTYPES:
                for op in ("sum", "max"):
                    calls.append((
                        dst, (a, b),
                        lambda ops, view, vec, sh, src=src, dst=dst, op=op:
                        lib.accl_lane_combine_cast(
                            L._CODES[src], L._CODES[dst], L._op(op),
                            ops[0].data_ptr(), sh[2][0], ops[1].data_ptr(),
                            sh[2][1], view.data_ptr(), sh[2][2], sh[0], sh[1],
                            vec, stream),
                        lambda a=a, b=b, dst=dst, op=op: L._combine_cast_impl(
                            a, b, op, torch.float32, dst)))
        for src, dst in L.CAST_PAIRS:
            x = place(cast_operand(rows, n, src, gen))[:, lo:lo + n]
            calls.append((
                dst, (x,),
                lambda ops, view, vec, sh, src=src, dst=dst:
                lib.accl_lane_cast(
                    L._CODES[src], L._CODES[dst], ops[0].data_ptr(), sh[2][0],
                    view.data_ptr(), sh[2][1], sh[0], sh[1], vec, stream),
                lambda x=x, dst=dst: L._cast_impl(x, dst)))
        for dst, ops, call, plain in calls:
            obuf = torch.full((rows, width), -7.0, device="cuda").to(dst)
            before = obuf.clone()
            view = obuf[:, lo:lo + n]
            sh = L._launch_shape(*ops, view)
            vec = sh[3]
            if not vec:  # a vector request here is refused, nothing written
                err = call(ops, view, 1, sh)
                torch.cuda.synchronize()
                if err != 1 or not same_bits(obuf, before):
                    raise AssertionError(
                        f"a misaligned vector request returned {err} or "
                        f"wrote: {rows}x{n} at {lo} in {width}")
            err = call(ops, view, int(vec), sh)
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"lane entry point returned {err}")
            outside = torch.ones_like(obuf, dtype=torch.bool)
            outside[:, lo:lo + n] = False
            if not same_bits(obuf[outside], before[outside]):
                raise AssertionError(f"lane kernel wrote outside its output: "
                                     f"{rows}x{n} at {lo} in {width} {dst}")
            if not same_bits(view, plain()):
                raise AssertionError(f"lane kernel differs from its plain "
                                     f"version: {rows}x{n} at {lo} in "
                                     f"{width} {dst}")
            by_path["vector" if vec else "scalar"] += 1
    return by_path


# (kernel, elements, instantiations) of the long-row cases: rows past
# INT_MAX, so the walk of kernels 7, 8 and 9 takes its 64-bit index; the
# last a scalar walk of more than 2^32 units, more than its 2^24 blocks
# of 256 threads cover in one pass, so that it strides over the grid
LONG_ROWS = (("combine", (1 << 31) + 3, ("vector", "scalar")),
             ("combine_cast", (1 << 31) + 3, ("vector", "scalar")),
             ("cast", (1 << 31) + 3, ("vector", "scalar")),
             ("cast", (1 << 32) + 5, ("scalar",)))


def lane_long_row_check(L):
    """The lane kernels over the single rows of LONG_ROWS: combine f32
    SUM, combine_cast bf16 SUM and cast f32 -> bf16, from aligned
    operands (vector) and
    from operands one element off (scalar), with the special values at
    the row's start and end, held bitwise against the plain version
    chunk by chunk (it is elementwise; whole, it would need several
    times the memory). Returns the cases run."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(97531)
    chunk = 1 << 28
    sp = torch.tensor(LANE_SPECIAL, dtype=torch.float64)
    csp = torch.tensor(CAST_SPECIAL, dtype=torch.float64)

    def filled(n, dtype, special):
        buf = torch.empty((1, n + 1), dtype=dtype, device="cuda")
        buf.normal_(generator=gen)
        k = len(special)
        for lo in (0, 1, n + 1 - k):
            buf[0, lo:lo + k] = special.to(dtype).cuda()
        return buf

    kernels = {  # operands of a row of n, kernel call, plain call
        "combine": (lambda n: (filled(n, torch.float32, sp[:, 0]),
                               filled(n, torch.float32, sp[:, 1])),
                    lambda a, b: L.combine(a, b, "sum"),
                    lambda a, b: L._combine_impl(a, b, "sum")),
        "combine_cast": (lambda n: (filled(n, torch.bfloat16, sp[:, 0]),
                                    filled(n, torch.bfloat16, sp[:, 1])),
                         lambda a, b: L.combine_cast(a, b, "sum"),
                         lambda a, b: L._combine_cast_impl(
                             a, b, "sum", torch.float32, torch.bfloat16)),
        "cast": (lambda n: (filled(n, torch.float32, csp),),
                 lambda x: L.cast(x, torch.bfloat16),
                 lambda x: L._cast_impl(x, torch.bfloat16)),
    }
    cases = []
    for name, n, paths in LONG_ROWS:
        make, kernel, plain = kernels[name]
        bufs = make(n)
        for path in paths:
            ops = [buf[:, int(path == "scalar"):][:, :n] for buf in bufs]
            got = kernel(*ops)
            if L._launch_shape(*ops, got)[3] != (path == "vector"):
                raise AssertionError(f"{name} long row: not the {path} "
                                     "instantiation")
            for i in range(0, n, chunk):
                if not same_bits(got[:, i:i + chunk],
                                 plain(*(t[:, i:i + chunk] for t in ops))):
                    raise AssertionError(
                        f"{name} differs from its plain version on a row "
                        f"of {n} ({path}), elements {i}..")
            unit = (16 // ops[0].element_size() if name == "combine"
                    else 8)  # elements of the kernel's vector unit
            units = n // (unit if path == "vector" else 1)
            cases.append({"kernel": name, "n": n, "instantiation": path,
                          "index": "64-bit" if n + 256 > (1 << 31) - 1
                          else "32-bit",
                          "grid_stride": -(-units // 256) > 1 << 24})
            del got
        del bufs
        torch.cuda.empty_cache()
    return cases


def lane_kernel_phase(L):
    """The lane kernels against their plain versions, bitwise (NaN
    matches NaN): the path's dtypes and shapes, then all three over the
    layouts that choose their instantiation, with the cases counted
    by instantiation (as the wrapper chose: `_launch_shape` over the
    operands and the result), and their bounds check."""
    import itertools

    import torch

    cases = {name: 0 for name in LANE_KERNELS}
    errs = {name: 0.0 for name in LANE_KERNELS}
    by_path = {name: {"vector": 0, "scalar": 0} for name in LANE_KERNELS}
    for name, where, ops, kernel, plain in itertools.chain(
            lane_cases(L), lane_layout_cases(L)):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{where} max|diff|={max_abs_err(got, want)}")
        errs[name] = max(errs[name], max_abs_err(got, want))
        cases[name] += 1
        if name in by_path:
            shape = L._launch_shape(*(L._rows(t) for t in (*ops, got)))
            by_path[name]["vector" if shape[3] else "scalar"] += 1
    bounds = lane_bounds_check(L)
    long_row = lane_long_row_check(L)
    for name in LANE_KERNELS:
        row = {"phase": "lane_kernel", "kernel": name, "cases": cases[name],
               "bitwise_equal": True, "max_abs_err": errs[name]}
        if name in by_path:
            if 0 in by_path[name].values():
                raise AssertionError(f"{name}: an instantiation never ran "
                                     f"{by_path[name]}")
            row["cases_by_instantiation"] = by_path[name]
        emit(row)
    emit({"phase": "lane_bounds", "cases_by_instantiation": bounds,
          "written_outside": False, "misaligned_vector_refused": True})
    emit({"phase": "lane_long_row", "cases": long_row,
          "bitwise_equal": True})
    return errs


# (op, world, elements of the whole buffer at COLL_BYTES, dtype name,
# wire, root, func): the collectives phase; "reduce_scatter", "scatter",
# "gather" and "allgather" split the whole buffer into W rank chunks
COLL_CASES = [
    ("reduce", 8, None, "float32", None, 3, "SUM"),
    ("reduce_scatter", 8, None, "float32", None, 0, "SUM"),
    ("allgather", 8, None, "float32", None, 0, "SUM"),
    ("gather", 8, None, "float32", None, 5, "SUM"),
    ("scatter", 8, None, "float32", None, 2, "SUM"),
    ("bcast", 8, None, "float32", None, 0, "SUM"),
    ("combine", 8, None, "float32", None, 0, "MAX"),
    ("reduce", 8, None, "bfloat16", None, 3, "SUM"),
    ("reduce_scatter", 8, None, "bfloat16", None, 0, "SUM"),
    ("reduce", 8, None, "float32", "bfloat16", 3, "SUM"),
    ("bcast", 8, None, "float32", "bfloat16", 0, "SUM"),
    ("allgather", 8, None, "float32", "bfloat16", 0, "SUM"),
    ("reduce", 5, 1_000_003, "float32", None, 2, "SUM"),
    ("allgather", 5, 5 * 1_000_003, "float32", None, 0, "SUM"),
]
CHUNKED = ("reduce_scatter", "scatter", "gather", "allgather")
WIDE_IN = ("reduce_scatter", "scatter")


def coll_count(op, world, total):
    """Per-rank count of a call whose whole buffer holds `total`."""
    return total // world if op in CHUNKED else total


def busbw_factor(op, world):
    """nccl-tests' busbw = algbw * factor, algbw = buffer bytes / time
    (None: no nccl-tests counterpart)."""
    if op in ("reduce", "bcast"):
        return 1.0
    if op in CHUNKED:
        return (world - 1) / world
    return None


def expected_lane_launches(op, plan, world, dtype, wire):
    """Launches of (combine, combine_cast, cast) one call makes, from its
    plan: a fold is one combine (combine_cast on a fp16/bf16 lane or in
    the compressed domain), W-1 folds for a flat tree or ring and
    ceil(log2 W) for a binomial tree; a hop of the cast wire is two
    casts; a compressed-domain reduction casts in and out once, except
    a reduce-scatter, whose last fold emits fp32 itself."""
    import torch

    tree_depth = math.ceil(math.log2(world))
    alg = plan.algorithm.name
    domain = wire is not None and op in ("reduce", "reduce_scatter")
    folds = hops = 0
    if op == "combine":
        folds = 1
    elif op == "barrier":
        folds = world - 1
    elif op in ("reduce", "reduce_scatter"):
        stage = plan.stages[0] if alg == "RNDZV_REDUCE_SCATTER" else plan
        folds = (tree_depth if stage.algorithm.name == "RNDZV_BIN_TREE"
                 else world - 1)
    elif wire is not None:
        binomial = alg == "RNDZV_BIN_TREE" or (
            op == "gather" and alg == "RNDZV_FLAT_TREE"
            and plan.tree_fanin < world - 1)
        hops = tree_depth if binomial else world - 1
    half = dtype in (torch.float16, torch.bfloat16) or domain
    casts = 2 * hops
    if domain:
        casts += 1 if op == "reduce_scatter" else 2
    return {"combine": 0 if half else folds,
            "combine_cast": folds if half else 0, "cast": casts}


def run_collective(accl, op, count, x, y, root, func, wire):
    """One facade call on the stacked operand x (and y for combine),
    from/to device; returns (result tensor, request)."""
    import torch

    from accl_tpu_torch import DataType, ReduceFunction

    world = accl.world
    on_card = accl.cclo.torch_device.type == "cuda"
    cd = None if wire is None else DataType[wire]
    f = ReduceFunction[func]
    width = {"gather": count * world, "allgather": count * world}.get(
        op, count)

    def make(t):
        b = accl.create_buffer(t.shape[1], t.dtype, data=None if on_card
                               else t)
        if on_card:
            b.device.copy_(t)
        return b

    src = make(x)
    res = accl.create_buffer(width, x.dtype)
    kw = dict(from_device=True, to_device=True) if on_card else {}
    if op == "combine":
        other = make(y)
        req = accl.combine(count, f, src, other, res, **kw)
        accl.free_buffer(other)
    elif op == "bcast":
        req, res = accl.bcast(src, count, root, compress_dtype=cd, **kw), src
    elif op == "scatter":
        req = accl.scatter(src, res, count, root, compress_dtype=cd, **kw)
    elif op == "gather":
        req = accl.gather(src, res, count, root, compress_dtype=cd, **kw)
    elif op == "allgather":
        req = accl.allgather(src, res, count, compress_dtype=cd, **kw)
    elif op == "reduce":
        req = accl.reduce(src, res, count, root, f, compress_dtype=cd, **kw)
    else:
        req = accl.reduce_scatter(src, res, count, f, compress_dtype=cd, **kw)
    out = res.device if on_card else res.host
    if res is not src:
        accl.free_buffer(src)
    accl.free_buffer(res)
    torch.cuda.synchronize()
    return out, req


def check_collective(op, out, x, y, root, func, wire, world, count):
    """Movers exact (the cast wire within one half-precision rounding),
    reductions within their rounding bound of a float64 reference, MAX
    exact; returns the worst excess over the bound (<= 0)."""
    import torch

    half = x.dtype in (torch.float16, torch.bfloat16)
    unit = BF16_UNIT if (half or wire) else F32_UNIT
    if op in ("reduce", "reduce_scatter", "combine"):
        if op == "combine":
            got, xs = out, torch.stack([x, y]).double()
        elif op == "reduce":
            got, xs = out[root:root + 1], x.double()
        else:
            got = out.reshape(1, -1)
            xs = x.double()
        if func == "MAX":
            ref = xs.amax(0)
            return float((got.double() - ref).abs().max())  # exact: <= 0
        ref = xs.sum(0, keepdim=True)
        # each term rounded at most `terms` times: into the wire dtype
        # (compressed domain) and at each of the W-1 folds
        terms = world - (0 if (wire and not half) else 1)
        bound = ((1 + unit) ** terms - 1) * xs.abs().sum(0, keepdim=True)
        return float(((got.double() - ref).abs() - bound).max())
    flat = x.reshape(-1)
    if op == "bcast":
        got, ref = out, x[root].expand_as(out)
    elif op == "scatter":
        got, ref = out, x[root].reshape(world, count)
    elif op == "gather":
        got, ref = out[root], flat
    else:
        got, ref = out, flat.expand_as(out)
    diff = (got.double() - ref.double()).abs()
    bound = (BF16_UNIT * ref.double().abs()) if wire else 0.0
    return float((diff - bound).max())


def collectives_phase(L):
    """This slice's path: the one-call collectives through the facade.
    Returns the lane kernels' launch counts over the path's run and the
    timing inputs."""
    import torch

    from accl_tpu_torch import ACCL

    gen = torch.Generator(device="cuda").manual_seed(97531)
    accls = {8: ACCL(world=8), 5: ACCL(world=5)}
    cpu = {8: ACCL(world=8, torch_device="cpu"),
           5: ACCL(world=5, torch_device="cpu")}
    kernels = {name: getattr(L, name) for name in LANE_KERNELS}
    for k in kernels.values():
        k.launches = 0
    expected = {name: 0 for name in kernels}
    timing = []
    for op, world, total, dname, wire, root, func in COLL_CASES:
        dtype = getattr(torch, dname)
        accl = accls[world]
        for nbytes in (COLL_BYTES, MIB):
            n = total if (total and nbytes == COLL_BYTES) else (
                nbytes // dtype.itemsize)
            count = coll_count(op, world, n)
            width = count * world if op in WIDE_IN else count
            x = rank_data(world, width, dtype, gen)
            y = rank_data(world, count, dtype, gen) if op == "combine" \
                else None
            before = {k: f.launches for k, f in kernels.items()}
            out, req = run_collective(accl, op, count, x, y, root, func, wire)
            launched = {k: f.launches - before[k] for k, f in kernels.items()}
            want = expected_lane_launches(op, req.plan, world, dtype, wire)
            if launched != want:
                raise AssertionError(f"{op} {dname} wire={wire} W={world} "
                                     f"launched {launched}, expected {want}")
            for k in expected:
                expected[k] += want[k]
            excess = check_collective(op, out, x, y, root, func, wire, world,
                                      count)
            if excess > 0:
                raise AssertionError(f"{op} {dname} wire={wire} W={world} "
                                     f"outside its bound by {excess}")
            bitwise = None
            if nbytes == MIB:
                cout, _ = run_collective(cpu[world], op, count, x.cpu(),
                                         None if y is None else y.cpu(),
                                         root, func, wire)
                bitwise = same_bits(out.cpu(), cout)
                if not bitwise:
                    raise AssertionError(f"{op} {dname} wire={wire} "
                                         f"W={world} differs from the "
                                         "port's CPU run")
            emit({"phase": "collective", "op": op, "world": world,
                  "dtype": dname, "wire": wire, "root": root, "func": func,
                  "count": count, "buffer_bytes": n * dtype.itemsize,
                  "plan": req.plan.algorithm.name,
                  "lane_launches": launched, "bound_margin": -excess,
                  "bitwise_vs_cpu": bitwise,
                  "finite": bool(torch.isfinite(out).all())})
            if nbytes == COLL_BYTES:
                timing.append((op, world, n, dtype, wire, root, func, count,
                               x, y))
    before = {k: f.launches for k, f in kernels.items()}
    req = accls[8].barrier()
    torch.cuda.synchronize()
    launched = {k: f.launches - before[k] for k, f in kernels.items()}
    want = expected_lane_launches("barrier", req.plan, 8, torch.float32, None)
    if launched != want:
        raise AssertionError(f"barrier launched {launched}, expected {want}")
    for k in expected:
        expected[k] += want[k]
    emit({"phase": "collective", "op": "barrier", "world": 8,
          "plan": req.plan.algorithm.name, "lane_launches": launched})
    launches = {k: f.launches for k, f in kernels.items()}
    if launches != expected or 0 in launches.values():
        raise AssertionError(f"collectives path launched {launches}, "
                             f"expected {expected}")
    return launches, accls, timing


def collectives_timing_phase(accls, timing):
    """Facade time of each collective: median of 20 calls, CUDA events
    around the whole call (from/to device), and nccl-tests' busbw; the
    f32 reduce and the allgather on the bf16 wire profiled."""
    import torch

    time_collectives(accls, timing, "collective_timing",
                     profiled={("reduce", None), ("allgather", "bfloat16")})
    barrier_ms = median_ms(accls[8].barrier)
    emit({"phase": "collective_timing", "op": "barrier", "world": 8,
          "facade_ms": barrier_ms})
    torch.cuda.synchronize()


def time_collectives(accls, timing, phase: str, profiled) -> None:
    """One row per timing case: facade ms (median of 20, CUDA events),
    busbw, and for the W=8 fp32 (op, wire) pairs in `profiled` one call
    under the profiler."""
    import torch

    from accl_tpu_torch import DataType, ReduceFunction

    for op, world, n, dtype, wire, root, func, count, x, y in timing:
        accl = accls[world]
        cd = None if wire is None else DataType[wire]
        f = ReduceFunction[func]
        src = accl.create_buffer(x.shape[1], dtype)
        src.device.copy_(x)
        width = count * world if op in ("gather", "allgather") else count
        res = accl.create_buffer(width, dtype)
        other = None
        kw = dict(from_device=True, to_device=True)
        if op == "combine":
            other = accl.create_buffer(count, dtype)
            other.device.copy_(y)
        call = {
            "reduce": lambda: accl.reduce(src, res, count, root, f,
                                          compress_dtype=cd, **kw),
            "reduce_scatter": lambda: accl.reduce_scatter(
                src, res, count, f, compress_dtype=cd, **kw),
            "allgather": lambda: accl.allgather(src, res, count,
                                                compress_dtype=cd, **kw),
            "gather": lambda: accl.gather(src, res, count, root,
                                          compress_dtype=cd, **kw),
            "scatter": lambda: accl.scatter(src, res, count, root,
                                            compress_dtype=cd, **kw),
            "bcast": lambda: accl.bcast(src, count, root, compress_dtype=cd,
                                        **kw),
            "combine": lambda: accl.combine(count, f, src, other, res, **kw),
        }[op]
        ms = median_ms(call)
        factor = busbw_factor(op, world)
        nbytes = n * dtype.itemsize
        row = {"phase": phase, "op": op, "world": world,
               "dtype": str(dtype).split(".")[-1], "wire": wire,
               "buffer_bytes": nbytes, "facade_ms": ms,
               "busbw_GBps": None if factor is None
               else nbytes / (ms * 1e-3) * factor / 1e9}
        if world == 8 and dtype == torch.float32 and (op, wire) in profiled:
            row["profile"] = profile_call(call)  # where the call's time goes
        emit(row)
        for b in (src, res, other):
            if b is not None:
                accl.free_buffer(b)


def lane_shape_calls(L):
    """Per lane kernel at its launch shape on the collectives path: (shape,
    bytes the function must move, kernel call, plain call, library call):
    one fold of the 25 MiB fp32 reduce at its root, one fold of the
    25 MiB bf16 reduce, and the compressed-domain cast of the W = 8,
    25 MiB-per-rank fp32 buffer to bf16; and combine over float64 at the
    fp32 fold's shape (its 8-byte lane, four 16-byte accesses a unit)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(24680)
    n32 = COLL_BYTES // 4
    a, b = (torch.randn((1, n32), generator=gen, device="cuda")
            for _ in range(2))
    h, k = (torch.randn((1, 2 * n32), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    x = torch.randn((8, n32), generator=gen, device="cuda")
    a64, b64 = a.double(), b.double()
    return {
        "combine": ((1, n32), 3 * 4 * n32,
                    lambda: L.combine(a, b, "sum"),
                    lambda: L._combine_impl(a, b, "sum"),
                    lambda: torch.add(a, b)),
        "combine_float64": ((1, n32), 3 * 8 * n32,
                            lambda: L.combine(a64, b64, "sum"),
                            lambda: L._combine_impl(a64, b64, "sum"),
                            lambda: torch.add(a64, b64)),
        "combine_cast": ((1, 2 * n32), 3 * 2 * 2 * n32,
                         lambda: L.combine_cast(h, k, "sum"),
                         lambda: L._combine_cast_impl(
                             h, k, "sum", torch.float32, torch.bfloat16),
                         lambda: torch.add(h, k)),
        "cast": ((8, n32), 8 * n32 * (4 + 2),
                 lambda: L.cast(x, torch.bfloat16),
                 lambda: L._cast_impl(x, torch.bfloat16),
                 lambda: x.to(torch.bfloat16)),
    }


def lane_breakdown_phase(L):
    """Each lane kernel at its launch shape: first held bitwise against
    its plain version there (kernels 8 and 9 fold it into one row of
    13 107 200 and 52 428 800 elements), then device time with the host
    held off, host cost per launch on the host clock, the plain version,
    the PyTorch call computing the same function (which does not flush
    subnormals) and the byte bound. Returns the rows for the kernels
    line."""
    rows = {}
    for name, (shape, nbytes, kernel, plain, library) in lane_shape_calls(
            L).items():
        got, want = kernel(), plain()
        if not same_bits(got, want):
            raise AssertionError(
                f"{name} differs from its plain version at its launch shape "
                f"{shape}: max|diff|={max_abs_err(got, want)}")
        del got, want
        rows[name] = {"shape": list(shape), "bitwise_equal": True,
                      "device_ms": device_ms(kernel),
                      "host_ms_per_launch": host_ms(kernel),
                      "plain_ms": device_ms(plain, count=10),
                      "library_ms": device_ms(library),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "lane_breakdown", **rows})
    return rows


def lane_cold_phase(L):
    """The lane kernels with cold operands, at their launch shape on the
    path and at half of it: each launch takes the next of several operand
    sets, 268 MB or more in all, and the last results are held so that
    each launch writes a block of its own, so that it finds its data in
    device memory and not in the 50 MB L2 (a result block the allocator
    hands back at once stays partly in L2); device time with the host
    held off. The fit t = fixed + bytes / rate over the two sizes says
    whether a launch is held by its fixed cost or by its rate."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13579)
    n32 = COLL_BYTES // 4

    def bf16(rows, n):
        return torch.randn((rows, n), generator=gen,
                           device="cuda").to(torch.bfloat16)

    kernels = {  # shapes, bytes per launch, operand set, call on a set
        "combine": ([(1, n32 // 2), (1, n32)],
                    lambda rows, n: 3 * 4 * rows * n,
                    lambda rows, n: tuple(torch.randn(
                        (rows, n), generator=gen, device="cuda")
                        for _ in range(2)),
                    lambda ops: L.combine(*ops, "sum")),
        "combine_cast": ([(1, n32), (1, 2 * n32)],
                         lambda rows, n: 3 * 2 * rows * n,
                         lambda rows, n: (bf16(rows, n), bf16(rows, n)),
                         lambda ops: L.combine_cast(*ops, "sum")),
        "cast": ([(8, n32 // 2), (8, n32)],
                 lambda rows, n: rows * n * (4 + 2),
                 lambda rows, n: torch.randn((rows, n), generator=gen,
                                             device="cuda"),
                 lambda x: L.cast(x, torch.bfloat16)),
    }
    row = {}
    for name, (shapes, nbytes, make, call) in kernels.items():
        fit = cold_fit(make, call, nbytes, shapes)
        row[name] = {**fit, "bound_ms": [b / HBM_BYTES_PER_S * 1e3
                                         for b in fit["cold_bytes_per_launch"]],
                     "fixed_share_path_shape": fit["fixed_device_ms"]
                     / fit["cold_device_ms"][1]}
    emit({"phase": "lane_cold", **row})
    return row


SEQ_SIZES = (25 * MIB, 4096)  # bytes per rank: DDP's bucket, the host-bound end
SEQ_PAIRS = 10


def seq_kernels(ring, qk, L) -> dict:
    """Every kernel wrapper by its kernels-line name."""
    return {"ring_allreduce_bidir": ring.ring_allreduce_bidir,
            "ring_allreduce": ring.ring_allreduce,
            **{name: getattr(qk, name) for name in QUANT_KERNELS},
            QUANT_RING[0]: qk.quant_ring_allreduce,
            **{name: getattr(L, name) for name in LANE_KERNELS}}


def seq_batches(nbytes: int, gen):
    """The batches of the sequence phase at `nbytes` per rank, W = 8:
    (name, facade kind, {buffer: (width, dtype, input tensor or None)},
    issue(ops, bufs, feed)), issue recording or calling the batch on a
    recorder or a facade. Facade kinds: "exact" (the defaults), "int8"
    (a 4 MiB eager buffer), "fp32_arith" (the fp16/bf16 rows with fp32
    arithmetic, as cast_wire_timing builds them)."""
    import torch

    from accl_tpu_torch import DataType
    from accl_tpu_torch.constants import ReduceFunction

    w, n, h = 8, nbytes // 4, nbytes // 2
    S, M = ReduceFunction.SUM, ReduceFunction.MAX
    f32, bf16, i8 = torch.float32, torch.bfloat16, DataType.int8

    def x(width, dtype=f32):
        return rank_data(w, width, dtype, gen)

    def a(ops, b, feed):
        ops.allreduce(b["a"], b["b"], n, S)

    def rs_ag(ops, b, feed):
        ops.reduce_scatter(b["a"], b["b"], n // w, S)
        ops.allgather(b["b"], b["c"], n // w)

    def int8(ops, b, feed):
        ops.reduce_scatter(b["a"], b["b"], n // w, S, compress_dtype=i8)
        ops.allgather(b["b"], b["c"], n // w, compress_dtype=i8)
        ops.allreduce(b["c"], b["d"], n, M, compress_dtype=i8)

    def reduce_bcast(ops, b, feed):
        ops.reduce(b["a"], b["b"], h, 3, S)
        ops.bcast(b["b"], h, 3)

    def fp16_wire(ops, b, feed):
        ops.allreduce(b["a"], b["b"], n, S, compress_dtype=DataType.float16)

    def streams(ops, b, feed):
        if isinstance(ops, _Facade):  # the facade's own form
            ops.copy_from_stream(b["a"], n, op0_stream=41)
        else:
            ops.copy(b["a"], b["a"], n, op0_stream=41)
        ops.allreduce(b["a"], b["b"], n, S, res_stream=42)

    return [
        ("allreduce", "exact", {"a": (n, f32, x(n)), "b": (n, f32, None)}, a),
        ("reduce_scatter+allgather", "exact",
         {"a": (n, f32, x(n)), "b": (n // w, f32, None),
          "c": (n, f32, None)}, rs_ag),
        ("int8 reduce_scatter+allgather+allreduce", "int8",
         {"a": (n, f32, x(n)), "b": (n // w, f32, None), "c": (n, f32, None),
          "d": (n, f32, None)}, int8),
        ("bf16 reduce+bcast", "exact",
         {"a": (h, bf16, x(h, bf16)), "b": (h, bf16, None)}, reduce_bcast),
        ("allreduce fp16 wire fp32 arith", "fp32_arith",
         {"a": (n, f32, x(n)), "b": (n, f32, None)}, fp16_wire),
        ("copy_from_stream+allreduce res_stream", "exact",
         {"a": (n, f32, None), "b": (n, f32, None)}, streams),
    ]


def seq_facade(kind: str):
    from accl_tpu_torch import ACCL, DataType
    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig

    if kind == "exact":
        return ACCL(world=8)
    if kind == "int8":
        return ACCL(world=8, egr_rx_buf_size=QUANT_BUF)
    table = dict(DEFAULT_ARITH_CONFIG)
    for wire, lanes in ((DataType.float16, (0, 1)),
                        (DataType.bfloat16, (2, 3))):
        table[(DataType.float32, wire)] = ArithConfig(4, 2, 0, *lanes, False,
                                                      (0, 5))
    accl = ACCL(world=8, arith_config=table, egr_rx_buf_size=QUANT_BUF)
    accl.cclo.compiler.arith_table = table
    return accl


PROFILE_RUNS = 5      # runs of fn in one kernel_profile session
PROFILE_SESSIONS = 5  # sessions kernel_profile may take to get one whole
# the runtime calls whose device work carries their correlation id
RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cudaGraphLaunch")


def profile_session(fn) -> list[dict]:
    """One torch.profiler session over PROFILE_RUNS runs of fn, each
    ending in a synchronize, marked by a record_function range and
    followed by 5 ms of idle. Returns, for each run, the graph launches
    the host made and the device kernels and memory copies the card ran
    for it, by name.

    A device event belongs to the run whose range holds the host call
    that launched it: the runtime event (cudaLaunchKernel,
    cudaGraphLaunch, ...) of the same correlation id, whose time is on
    the host's clock. Only a device event with no such host event is
    placed by its own time, in the run whose range starts at most 2.5 ms
    after it: the card's clock in a trace can lag the host's by more
    than that (one run of this script saw every device event of a run
    land in the run before it), so that rule is the fallback, and the
    count of events it placed is returned with each run, and, by name,
    the device kernels that belong to a graph launch (`graph_kernels`)
    and each kernel's summed device ms (`kernel_ms`). Each run also
    counts its runtime launches (cudaLaunchKernel, cudaLaunchKernelExC,
    cudaGraphLaunch) that no device event answers (`lost_launches`):
    every such launch runs before the run's synchronize, so a nonzero
    count means the trace lost the card's side of it."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    names = [f"kernel_profile_run{i}" for i in range(PROFILE_RUNS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name in names:
            with record_function(name):
                fn()
                torch.cuda.synchronize()
            time.sleep(0.005)
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != cuda]
    # the record_function ranges also appear as device-side ranges, the
    # run markers' and the program's own (its tracer opens an
    # `accl:<track>/<name>` range for each span while a profiler records)
    dev = [e for e in events if e.device_type() == cuda
           and e.name() not in names and not e.name().startswith("accl:")]
    starts = sorted(e.start_ns() for e in host if e.name() in names)
    if len(starts) != PROFILE_RUNS:
        raise AssertionError(
            f"the profile holds {len(starts)} of {PROFILE_RUNS} runs")
    launched_at = {e.correlation_id(): e.start_ns() for e in host
                   if e.name().startswith("cu") and e.correlation_id() > 0}
    answered = {e.correlation_id() for e in dev}

    def run_of(t: int) -> int:  # the index of the run a host time lies in
        return sum(t >= s for s in starts) - 1

    runs = [{"graph_launches": 0, "kernels": collections.Counter(),
             "graph_kernels": collections.Counter(),
             "kernel_ms": collections.Counter(),
             "memcpy": 0, "busy_ms": 0.0, "placed_by_device_clock": 0,
             "lost_launches": 0}
            for _ in names]
    for e in host:
        if (e.name() in RUNTIME_LAUNCHES and e.correlation_id() > 0
                and e.correlation_id() not in answered
                and run_of(e.start_ns()) >= 0):
            runs[run_of(e.start_ns())]["lost_launches"] += 1
    graph_ids = set()
    for e in host:
        if "GraphLaunch" in e.name() and run_of(e.start_ns()) >= 0:
            runs[run_of(e.start_ns())]["graph_launches"] += 1
            graph_ids.add(e.correlation_id())
    for e in dev:
        t = launched_at.get(e.correlation_id())
        if t is None:
            t = e.start_ns() + 2_500_000
        i = run_of(t)
        if i < 0:
            continue
        r = runs[i]
        r["placed_by_device_clock"] += e.correlation_id() not in launched_at
        if e.name().startswith("Memcpy"):
            r["memcpy"] += 1
        elif not e.name().startswith("Memset"):
            r["kernels"][e.name()] += 1
            r["kernel_ms"][e.name()] += e.duration_ns() * 1e-6
            if e.correlation_id() in graph_ids:
                r["graph_kernels"][e.name()] += 1
        r["busy_ms"] += e.duration_ns() * 1e-6
    return runs


def kernel_profile(fn) -> dict:
    """The graph launches, device kernels and memory copies of one run
    of fn, from profile_session. A session's first and last runs are not
    read: device events at a session's edges can go missing (one run of
    this script lost one kernel of each eager chain and two copies of
    each dispatch at the start, and another lost every device event of a
    session's eager calls). Its three middle runs must agree and hold no
    lost launch, and the first of them is returned. Any other session is
    taken again, up to PROFILE_SESSIONS sessions in all, and then the
    profile fails with every session's runs; the returned dict says how
    many sessions it took."""
    def key(r):
        return r["kernels"], r["memcpy"], r["graph_launches"]

    seen = []
    for session in range(1, PROFILE_SESSIONS + 1):
        middle = profile_session(fn)[1:-1]
        if (all(key(r) == key(middle[0]) for r in middle)
                and not any(r["lost_launches"] for r in middle)):
            return {**middle[0], "profile_sessions": session}
        seen.append(middle)
    raise AssertionError(f"no session of {PROFILE_SESSIONS} gave three "
                         f"whole runs that agree: {seen}")


def launch_counter(kernels):
    """(counts, delta): every kernel's launches, and the kernels whose
    count moved since `before`, by how much."""
    def counts():
        return {name: k.launches for name, k in kernels.items()}

    def delta(before):
        return {name: k.launches - before[name]
                for name, k in kernels.items() if k.launches != before[name]}

    return counts, delta


def in_place_steps(graph) -> int:
    """The steps a captured sequence runs through kernel 1's indirect
    entry, reading operands in place (0: every step staged)."""
    return len(graph.placement.steps) if graph.placement else 0


def direct_kernel_names(kernels):
    """A profile's kernel counts with kernel 1's indirect entry counted as
    its direct entry of the same template arguments: a captured sequence
    runs the indirect entry (the same fold, its two pointers read from a
    table) where the eager calls run the direct one."""
    import collections
    import re

    out = collections.Counter()
    for name, n in kernels.items():
        m = re.search(r"ring_allreduce_kernel(?:_indirect)?<([^>]*)>", name)
        out[f"ring_allreduce_kernel<{m.group(1)}>" if m else name] += n
    return out


def sequence_phase(ring, qk, L):
    """This slice's path: call sequences. Each batch of seq_batches at
    25 MiB and 4 KiB per rank, W = 8, is recorded and prepared once
    through SequenceRecorder.compile() (one CUDA graph), then checked:
    dispatch bitwise equal to the same calls issued eagerly through the
    facade on the same inputs (NaN as NaN), on two sets of inputs;
    dispatch k's result tensors unchanged after dispatch k+1; the kernel
    launches at compile (the warm-up run and the capture) equal to twice
    the eager calls' and none at replay; one dispatch profiled: one graph
    launch, and the eager calls' device kernels (by name and count;
    kernel 1's indirect entry counted as its direct entry).
    Then facade_ms of the eager chain and of program.run() in SEQ_PAIRS
    alternating pairs on the same tensors (median and both ends), the
    replay's device ms (its request's events), host ms per dispatch
    (run_async, 50 back to back), capture seconds, and the copy-in's
    bytes and device ms. Returns every kernel's launches over the checked runs of
    the phase (counts set to 0 just before it; the timing runs are not
    counted), and fails if a kernel of the path (all but the
    unidirectional ring kernel) was launched no time."""
    import torch

    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    # the path's launches: every batch's checked run (eager twins,
    # compile, dispatches, profiles), without its timing runs
    path = dict.fromkeys(kernels, 0)
    gen = torch.Generator(device="cuda").manual_seed(8008)
    counts, delta = launch_counter(kernels)

    for nbytes in SEQ_SIZES:
        for name, kind, spec, issue in seq_batches(nbytes, gen):
            accl = seq_facade(kind)
            feed = rank_data(8, spec["a"][0], spec["a"][1], gen)
            accl.register_stream_producer(
                41, lambda ranks, feed=feed: feed + ranks.to(feed.dtype))
            accl.register_stream_consumer(42, lambda r: r * 0.5)

            def make():
                bufs = {k: accl.create_buffer(width, dtype)
                        for k, (width, dtype, _) in spec.items()}
                for k, (_, _, t) in spec.items():
                    if t is not None:  # inputs: one tensor for both sides
                        bufs[k].device = t
                return bufs

            eager, fused = make(), make()

            def run_eager():
                issue(_Facade(accl), eager, feed)
                torch.cuda.synchronize()

            start = before = counts()
            run_eager()
            eager_launches = delta(before)
            rec = accl.sequence()
            issue(rec, fused, feed)
            written = [k for k in spec if any(
                b is fused[k] for b in rec._sync_sets()[1])]
            before = counts()
            t0 = time.perf_counter()
            prog = rec.compile()
            compile_s = time.perf_counter() - t0
            compile_launches = delta(before)
            graph = prog.graph
            if graph.graph is None:
                raise AssertionError(f"{name}: no CUDA graph was captured")
            if compile_launches != {k: 2 * v
                                    for k, v in eager_launches.items()}:
                raise AssertionError(
                    f"{name}: launches at compile {compile_launches}, the "
                    f"eager calls' {eager_launches}")
            kept = []
            for k_dispatch in range(2):
                before = counts()
                req = prog.run(from_device=True, to_device=True)
                torch.cuda.synchronize()
                if delta(before):
                    raise AssertionError(f"{name}: a replay ticked "
                                         f"{delta(before)}")
                if req.num_dispatches != 1:
                    raise AssertionError(f"{name}: {req.num_dispatches} "
                                         "dispatches")
                for k in written:
                    got, want = fused[k].device, eager[k].device
                    if not same_bits(got, want):
                        raise AssertionError(
                            f"{name} {nbytes} B: buffer {k} of dispatch "
                            f"{k_dispatch} differs from the eager calls")
                    if not torch.isfinite(got.float()).all():
                        raise AssertionError(f"{name}: non-finite {k}")
                kept.append([(fused[k].device, fused[k].device.clone())
                             for k in written])
                # other inputs for the next dispatch, and the eager twin
                for k, (_, _, t) in spec.items():
                    if t is not None:
                        t.copy_(rank_data(8, t.shape[1], t.dtype, gen))
                feed.copy_(rank_data(8, feed.shape[1], feed.dtype, gen))
                run_eager()
            survived = all(same_bits(t, saved) for t, saved in kept[0])
            if not survived:
                raise AssertionError(f"{name}: dispatch 0's results changed "
                                     "in dispatch 1")
            moved = any(not same_bits(a, b)
                        for (a, _), (b, _) in zip(kept[0], kept[1]))

            prof_seq = kernel_profile(
                lambda: prog.run(from_device=True, to_device=True))
            prof_eager = kernel_profile(run_eager)
            if prof_seq["graph_launches"] != 1:
                raise AssertionError(f"{name}: {prof_seq['graph_launches']} "
                                     "graph launches in one dispatch")
            same_kernels = (direct_kernel_names(prof_seq["kernels"])
                            == direct_kernel_names(prof_eager["kernels"]))
            if not same_kernels:
                raise AssertionError(f"{name}: a dispatch ran the kernels "
                                     f"{prof_seq['kernels']}, the eager "
                                     f"calls {prof_eager['kernels']}")
            for k, v in delta(start).items():
                path[k] += v

            def run_seq():
                prog.run(from_device=True, to_device=True)

            times = {"eager": [], "sequence": []}
            for p in range(SEQ_PAIRS):
                for side in (("eager", "sequence") if p % 2 == 0
                             else ("sequence", "eager")):
                    fn = run_eager if side == "eager" else run_seq
                    times[side].append(median_ms(fn, reps=5, warmup=1))
            replay = []
            for _ in range(5):
                req = prog.run(from_device=True, to_device=True)
                replay.append(req.get_duration_ns() * 1e-6)
            host = host_ms(lambda: prog.run(from_device=True, to_device=True,
                                            run_async=True), count=50)
            binding = graph.bind([prog._prepared.bufs[a].device
                                  for a in prog._prepared.seq.buffer_addrs])
            graph.allocate(binding)
            load_ms = device_ms(lambda: graph.load(binding), count=20)
            emit({"phase": "sequence", "batch": name, "world": 8,
                  "bytes_per_rank": nbytes,
                  "plans": [p.algorithm.name for p in prog.plans],
                  "cuda_graph": True,
                  "bitwise_vs_eager": True, "dispatches_checked": 2,
                  "results_survive_next_dispatch": survived,
                  "next_dispatch_results_differ": moved,
                  "launches_eager": eager_launches,
                  "launches_at_compile": compile_launches,
                  "launches_per_replay": 0,
                  "graph_launches_per_dispatch": prof_seq["graph_launches"],
                  "device_kernels_per_dispatch": sum(
                      prof_seq["kernels"].values()),
                  "device_kernels_eager": sum(prof_eager["kernels"].values()),
                  "same_kernels_as_eager": same_kernels,
                  "indirect_kernels_per_dispatch": sum(
                      n for k, n in prof_seq["kernels"].items()
                      if "ring_allreduce_kernel_indirect<" in k),
                  "memcpy_per_dispatch": prof_seq["memcpy"],
                  "profile_sessions": {"sequence": prof_seq["profile_sessions"],
                                       "eager": prof_eager["profile_sessions"]},
                  "placed_by_device_clock": {
                      "sequence": prof_seq["placed_by_device_clock"],
                      "eager": prof_eager["placed_by_device_clock"]},
                  "memcpy_eager": prof_eager["memcpy"],
                  "device_busy_ms": {"sequence": prof_seq["busy_ms"],
                                     "eager": prof_eager["busy_ms"]},
                  "facade_ms": {side: {"median": statistics.median(t),
                                       "min": min(t), "max": max(t)}
                                for side, t in times.items()},
                  "facade_ms_pairs": times,
                  "replay_ms": statistics.median(replay),
                  "host_ms_per_dispatch": host,
                  "compile_s": compile_s, "warmup_s": graph.warmup_s,
                  "capture_s": graph.capture_s,
                  "copy_in_bytes": graph.load_bytes,
                  "in_place_steps": in_place_steps(graph),
                  "copy_in_ms": load_ms})
            del prog, rec, graph, binding, kept, eager, fused
            accl.cclo.compiler._cache.clear()
            del accl
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    idle = [k for k, v in path.items() if v == 0 and k != "ring_allreduce"]
    if idle:
        raise AssertionError(f"the sequence path launched no {idle}")
    return path


class _Facade:
    """The facade's calls with from_device/to_device, under the recorder's
    method names, so one issue() drives both."""

    def __init__(self, accl):
        self.accl = accl

    def __getattr__(self, op):
        fn = getattr(self.accl, op)

        def call(*args, **kw):
            kw["to_device"] = True
            if op != "copy_from_stream":  # which reads no buffer
                kw["from_device"] = True
            return fn(*args, **kw)

        return call


P2P_COUNTS = (1024, 6_553_600)  # per rank: 4 KiB, and 25 MiB (a pipeline
# stage's boundary activation)
P2P_WIRES = (None, "float16", "bfloat16", "int8")
P2P_SRC, P2P_DST = 1, 6


def per_message(wire) -> dict:
    """The hand-written kernels one send/recv message launches: on the
    int8 wire one quantize (writing the message) and one dequantize
    (reading it); on a cast wire two casts; none on the exact wire."""
    if wire == "int8":
        return {"quantize": 1, "dequantize": 1}
    return {"cast": 2} if wire else {}


def quant_pass_excess(got, x) -> float:
    """The worst excess of |got - x| over one blockwise-int8 quantization
    pass's bound per 256-element block of max |x_b| = M: half a step,
    M / 254, plus 4 fp32 units of M for the roundings around it (the
    scale's product with fp32(1/127), the quotient x / scale and the
    decode's product q * scale); <= 0 within."""
    xb = x.double().reshape(-1, 256)
    err = (got.double().reshape(-1, 256) - xb).abs()
    amax = xb.abs().amax(1, keepdim=True)
    return float((err - (amax / 254 + 4 * F32_UNIT * amax)).max())


def p2p_phase(ring, qk, L):
    """This slice's point-to-point path, W = 8, fp32, at 4 KiB and 25 MiB
    per rank on the exact, fp16, bf16 and int8 wires, rank 1 to rank 6:
    a send then its recv; a recv first (async), then its send; three
    TAG_ANY messages on one channel, received in FIFO order; three
    messages with their own tags received in reverse order; then a
    stream_put with a producer and a consumer. Every result, every row,
    bitwise with the port's CPU run of the same calls on the same
    payload; on the exact wire row dst bitwise row src; on the int8 wire
    row dst within one quantization pass of row src; each message's
    kernel launches as per_message says. Then facade_ms of a send+recv
    pair (median of 20), its device ms and its bound (every row of the
    result is written: 2*W*n*4 bytes). Returns every kernel's launches
    over the checked runs (timing runs not counted)."""
    import torch

    from accl_tpu_torch import ACCL, DataType, TAG_ANY

    world = 8
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    accl, cpu = ACCL(world=world), ACCL(world=world, torch_device="cpu")
    f32 = torch.float32
    expected: dict = {}
    timing = []
    for n in P2P_COUNTS:
        xs = [rank_data(world, n, f32, gen) for _ in range(3)]
        sbs = [accl.create_buffer(n) for _ in xs]
        for sb, x in zip(sbs, xs):
            sb.device.copy_(x)
        csbs = [cpu.create_buffer(n, data=x.cpu()) for x in xs]
        rbs = [accl.create_buffer(n) for _ in range(3)]
        crb = cpu.create_buffer(n)
        for wire in P2P_WIRES:
            cd = None if wire is None else DataType[wire]
            kw = dict(compress_dtype=cd)
            # the CPU run of one message of payload k: the same calls
            twins = []
            for csb in csbs:
                cpu.send(csb, n, P2P_SRC, P2P_DST, tag=1, **kw)
                cpu.recv(crb, n, P2P_SRC, P2P_DST, tag=1, **kw)
                twins.append(crb.host.to("cuda"))

            def send(k, tag):
                accl.send(sbs[k], n, P2P_SRC, P2P_DST, tag=tag,
                          from_device=True, **kw)

            def recv(rb, tag, **extra):
                return accl.recv(rb, n, P2P_SRC, P2P_DST, tag=tag,
                                 to_device=True, **kw, **extra)

            def first():  # send, then its recv
                send(0, 1)
                recv(rbs[0], 1)
                return [0]

            def recv_first():  # the recv parks, the send pairs it
                req = recv(rbs[0], 2, run_async=True)
                if req.test():
                    raise AssertionError("a recv with no send completed")
                send(1, 2)
                accl.wait(req)
                return [1]

            def tag_any():  # FIFO on one channel
                for k in range(3):
                    send(k, TAG_ANY)
                for rb in rbs:
                    recv(rb, TAG_ANY)
                return [0, 1, 2]

            def reverse():  # own tags, received last first
                for k in range(3):
                    send(k, 10 + k)
                for rb, k in zip(rbs, (2, 1, 0)):
                    recv(rb, 10 + k)
                return [2, 1, 0]

            for name, traffic in (("send_then_recv", first),
                                  ("recv_then_send", recv_first),
                                  ("tag_any_fifo", tag_any),
                                  ("tags_reversed", reverse)):
                before = counts()
                order = traffic()
                torch.cuda.synchronize()
                launched = delta(before)
                want = {k: v * len(order) for k, v in per_message(wire).items()}
                if launched != want:
                    raise AssertionError(f"p2p {name} n={n} wire={wire}: "
                                         f"launched {launched}, expected "
                                         f"{want}")
                for k, v in want.items():
                    expected[k] = expected.get(k, 0) + v
                excess = None
                for rb, k in zip(rbs, order):
                    out = rb.device
                    if not same_bits(out, twins[k]):
                        raise AssertionError(f"p2p {name} n={n} wire={wire}:"
                                             " differs from the CPU run")
                    rows = [r for r in range(world) if r != P2P_DST]
                    if not same_bits(out[rows], xs[k][rows]):
                        raise AssertionError(f"p2p {name}: a row other than "
                                             "dst is not its send row")
                    if wire is None and not same_bits(out[P2P_DST],
                                                      xs[k][P2P_SRC]):
                        raise AssertionError(f"p2p {name}: row dst is not "
                                             "row src")
                    if wire == "int8":
                        e = quant_pass_excess(out[P2P_DST], xs[k][P2P_SRC])
                        if e > 0:
                            raise AssertionError(f"p2p {name}: int8 row "
                                                 f"outside its bound by {e}")
                        excess = e if excess is None else max(excess, e)
                emit({"phase": "p2p", "traffic": name, "world": world,
                      "count": n, "bytes_per_rank": n * 4, "wire": wire,
                      "messages": len(order), "launches": launched,
                      "bitwise_vs_cpu": True, "int8_bound_margin":
                      None if excess is None else -excess})
            timing.append((n, wire, cd))
        # stream_put: the producer's rows, rank 1's to rank 6, then the
        # consumer; no wire, no hand-written kernel
        feed = rank_data(world, n, f32, gen)
        cfeed = feed.cpu()
        accl.register_stream_producer(31, lambda ranks: feed)
        accl.register_stream_consumer(31, lambda r: r * 0.5)
        cpu.register_stream_producer(31, lambda ranks: cfeed)
        cpu.register_stream_consumer(31, lambda r: r * 0.5)
        before = counts()
        accl.stream_put(n, 31, P2P_SRC, P2P_DST, rbs[0])
        launched = delta(before)
        cpu.stream_put(n, 31, P2P_SRC, P2P_DST, crb)
        out = rbs[0].device
        if launched or not same_bits(out, crb.host.to("cuda")) or \
                not same_bits(out[P2P_DST], feed[P2P_SRC] * 0.5):
            raise AssertionError(f"stream_put n={n}: launched {launched}, "
                                 "or differs from the CPU run")
        emit({"phase": "p2p", "traffic": "stream_put", "world": world,
              "count": n, "launches": launched, "bitwise_vs_cpu": True})
        for b in (*sbs, *rbs):
            accl.free_buffer(b)
        for b in (*csbs, crb):
            cpu.free_buffer(b)
    path = counts()
    want = {k: expected.get(k, 0) for k in kernels}
    if path != want:
        raise AssertionError(f"p2p path launched {path}, expected {want}")
    for n, wire, cd in timing:
        sb, rb = accl.create_buffer(n), accl.create_buffer(n)
        sb.device.copy_(rank_data(world, n, f32, gen))

        def pair(run_async=False):
            accl.send(sb, n, P2P_SRC, P2P_DST, tag=5, from_device=True,
                      compress_dtype=cd)
            accl.recv(rb, n, P2P_SRC, P2P_DST, tag=5, to_device=True,
                      compress_dtype=cd, run_async=run_async)

        emit({"phase": "p2p_timing", "world": world, "count": n,
              "bytes_per_rank": n * 4, "wire": wire,
              "facade_ms": median_ms(pair),
              "device_ms": device_ms(lambda: pair(run_async=True)),
              "bound_ms": 2 * world * n * 4 / HBM_BYTES_PER_S * 1e3})
        accl.free_buffer(sb)
        accl.free_buffer(rb)
    torch.cuda.synchronize()
    return path


COMM_GROUPS = ((0, 2, 4, 6), (1, 2, 5))  # a tensor-parallel group of four
# in an eight-GPU node, and a group of three in no order of the ranks
COMM_COUNT = 6_553_600  # 25 MiB per rank
COMM_SMALL = ("bcast", "reduce", "reduce_scatter", "allgather", "gather",
              "scatter", "alltoall")


def comm_call(accl, op, sb, rb, count, comm, **kw):
    """One call on a communicator (roots are its rank 1)."""
    from accl_tpu_torch.constants import ReduceFunction

    s = ReduceFunction.SUM
    return {
        "allreduce": lambda: accl.allreduce(sb, rb, count, s, comm=comm,
                                            **kw),
        "bcast": lambda: accl.bcast(sb, count, 1, comm=comm, **kw),
        "reduce": lambda: accl.reduce(sb, rb, count, 1, s, comm=comm, **kw),
        "reduce_scatter": lambda: accl.reduce_scatter(sb, rb, count, s,
                                                      comm=comm, **kw),
        "allgather": lambda: accl.allgather(sb, rb, count, comm=comm, **kw),
        "gather": lambda: accl.gather(sb, rb, count, 1, comm=comm, **kw),
        "scatter": lambda: accl.scatter(sb, rb, count, 1, comm=comm, **kw),
        "alltoall": lambda: accl.alltoall(sb, rb, count, comm=comm, **kw),
    }[op]()


def comm_phase(ring, qk, L):
    """Sub-communicators, W = 8: split([0, 2, 4, 6]) and split([1, 2, 5]).
    On each, the allreduce at 25 MiB per rank on the exact wire (kernel 1
    at world g, ceil(bytes/4 MiB) launches) and the int8 wire (the
    closed-form ring at world g), then bcast, reduce (fp32 and bf16),
    reduce_scatter, allgather, gather, scatter and alltoall on buffers
    of 1024*g elements (slots of 1024). Every result bitwise with the
    port's CPU run (the kernels' plain versions) on member rows, and
    non-member rows bitwise what they held before; lane kernel launches
    as the group's plans say. Then one call sequence on the group of four
    (reduce_scatter -> allgather, 25 MiB), replayed as one CUDA graph:
    bitwise with its eager twin on two input sets, one graph launch a
    dispatch (profiled). Then facade_ms, device ms and the bound
    2*g*n*4 bytes of the group allreduce beside the full world's.
    Returns every kernel's launches over the checked runs."""
    import torch

    from accl_tpu_torch import ACCL, DataType
    from accl_tpu_torch.constants import ReduceFunction

    world = 8
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    gen = torch.Generator(device="cuda").manual_seed(1357)
    accl = ACCL(world=world, egr_rx_buf_size=QUANT_BUF)
    cpu = ACCL(world=world, torch_device="cpu", egr_rx_buf_size=QUANT_BUF)
    cpu.cclo.compiler.use_ring_kernel = True  # the kernels' plain versions
    expected: dict = {}

    def check(op, members, count, width_in, width_out, dtype=torch.float32,
              wire=None):
        g = len(members)
        comm, ccomm = accl.split(list(members)), cpu.split(list(members))
        x = rank_data(world, width_in, dtype, gen)
        prior = rank_data(world, width_out, dtype, gen)  # what rb held
        sb, rb = accl.create_buffer(width_in, dtype), \
            accl.create_buffer(width_out, dtype)
        sb.device.copy_(x)
        rb.device.copy_(prior)
        csb = cpu.create_buffer(width_in, dtype, data=x.cpu())
        crb = cpu.create_buffer(width_out, dtype, data=prior.cpu())
        cd = None if wire is None else DataType[wire]
        before = counts()
        req = comm_call(accl, op, sb, rb, count, comm, from_device=True,
                        to_device=True, compress_dtype=cd)
        torch.cuda.synchronize()
        launched = delta(before)
        comm_call(cpu, op, csb, crb, count, ccomm, compress_dtype=cd)
        out = (sb if op == "bcast" else rb).device
        before_rows = x if op == "bcast" else prior
        others = [r for r in range(world) if r not in members]
        if not same_bits(out, (csb if op == "bcast" else crb).host.to(
                "cuda")):
            raise AssertionError(f"comm {op} {members}: differs from the "
                                 "CPU run")
        if not same_bits(out[others], before_rows[others]):
            raise AssertionError(f"comm {op} {members}: a non-member row "
                                 "changed")
        if op == "allreduce" and wire is None:
            want = {"ring_allreduce_bidir": math.ceil(count * 4 / SEG_BYTES)}
        elif op == "allreduce":
            want = {QUANT_RING[0]: ring_launch_count(
                count, ring_seg(g, QUANT_BUF))}
        else:
            want = {k: v for k, v in expected_lane_launches(
                op, req.plan, g, dtype, None).items() if v}
        if launched != want:
            raise AssertionError(f"comm {op} {members} wire={wire}: "
                                 f"launched {launched}, expected {want}")
        for k, v in want.items():
            expected[k] = expected.get(k, 0) + v
        emit({"phase": "comm", "op": op, "members": list(members),
              "group": g, "count": count, "wire": wire,
              "dtype": str(dtype).split(".")[-1],
              "plan": req.plan.algorithm.name, "launches": launched,
              "bitwise_vs_cpu": True, "non_members_unchanged": True})
        for b in (sb, rb):
            accl.free_buffer(b)
        for b in (csb, crb):
            cpu.free_buffer(b)

    for members in COMM_GROUPS:
        g = len(members)
        for wire in (None, "int8"):
            check("allreduce", members, COMM_COUNT, COMM_COUNT, COMM_COUNT,
                  wire=wire)
        small = 1024 * g
        for op in COMM_SMALL:
            count = 1024 if op in ("reduce_scatter", "allgather", "gather",
                                   "scatter", "alltoall") else small
            w_in = small if op in ("reduce_scatter", "scatter",
                                   "alltoall") else count
            w_out = small if op in ("allgather", "gather", "alltoall") \
                else count
            check(op, members, count, w_in, w_out)
        check("reduce", members, small, small, small, dtype=torch.bfloat16)

    # one call sequence on the group of four, replayed as one CUDA graph
    members = COMM_GROUPS[0]
    g, n = len(members), COMM_COUNT
    comm = accl.split(list(members))
    s = ReduceFunction.SUM

    def bufs():
        b = [accl.create_buffer(n), accl.create_buffer(n // g),
             accl.create_buffer(n)]
        for buf in b[1:]:
            buf.device.zero_()
        return b

    fused, eager = bufs(), bufs()

    def issue(ops, b, **kw):
        ops.reduce_scatter(b[0], b[1], n // g, s, **kw)
        ops.allgather(b[1], b[2], n // g, **kw)

    def run_eager():
        issue(accl, eager, comm=comm, from_device=True, to_device=True)

    rec = accl.sequence(comm=comm)
    issue(rec, fused)
    before = counts()
    prog = rec.compile()
    compile_launches = delta(before)
    if prog.graph.graph is None:
        raise AssertionError("the group's sequence captured no CUDA graph")
    for k, v in compile_launches.items():
        expected[k] = expected.get(k, 0) + v
    for dispatch in range(2):
        x = rank_data(world, n, torch.float32, gen)
        fused[0].device.copy_(x)  # the bound buffer, written in place
        eager[0].device.copy_(x)
        before = counts()
        prog.run(from_device=True, to_device=True)
        if delta(before):
            raise AssertionError(f"a replay launched {delta(before)}")
        before = counts()
        run_eager()
        torch.cuda.synchronize()
        eager_launches = delta(before)
        if compile_launches != {k: 2 * v for k, v in eager_launches.items()}:
            raise AssertionError(f"the group's sequence launched "
                                 f"{compile_launches} at compile, its eager "
                                 f"twin {eager_launches}")
        for k, v in eager_launches.items():
            expected[k] = expected.get(k, 0) + v
        for i in (1, 2):
            if not same_bits(fused[i].device, eager[i].device):
                raise AssertionError(f"the group's sequence differs from "
                                     f"its eager twin (buffer {i}, dispatch "
                                     f"{dispatch})")
    prof = kernel_profile(lambda: prog.run(from_device=True, to_device=True))
    if prof["graph_launches"] != 1:
        raise AssertionError(f"{prof['graph_launches']} graph launches in "
                             "one dispatch of the group's sequence")
    path = counts()
    want = {k: expected.get(k, 0) for k in kernels}
    if path != want:
        raise AssertionError(f"comm path launched {path}, expected {want}")
    idle = [k for k in ("ring_allreduce_bidir", QUANT_RING[0], "combine",
                        "combine_cast") if path[k] == 0]
    if idle:
        raise AssertionError(f"the comm path launched no {idle}")
    emit({"phase": "comm_sequence", "members": list(members), "group": g,
          "bytes_per_rank": n * 4, "cuda_graph": True,
          "bitwise_vs_eager": True, "dispatches_checked": 2,
          "launches_at_compile": compile_launches,
          "graph_launches_per_dispatch": prof["graph_launches"],
          "device_kernels_per_dispatch": sum(prof["kernels"].values()),
          "memcpy_per_dispatch": prof["memcpy"],
          "facade_ms": {"eager": median_ms(run_eager),
                        "sequence": median_ms(lambda: prog.run(
                            from_device=True, to_device=True))}})
    for b in (*fused, *eager):
        accl.free_buffer(b)
    del prog, rec

    # the group allreduce's time beside the full world's
    sb, rb = accl.create_buffer(n), accl.create_buffer(n)
    sb.device.copy_(rank_data(world, n, torch.float32, gen))
    for members in (None, *COMM_GROUPS):
        comm = None if members is None else accl.split(list(members))
        g = world if members is None else len(members)
        for wire in (None, "int8"):
            cd = None if wire is None else DataType.int8

            def call(run_async=False):
                accl.allreduce(sb, rb, n, s, comm=comm, from_device=True,
                               to_device=True, compress_dtype=cd,
                               run_async=run_async)

            emit({"phase": "comm_timing", "op": "allreduce",
                  "members": members and list(members), "group": g,
                  "bytes_per_rank": n * 4, "wire": wire,
                  "facade_ms": median_ms(call),
                  "device_ms": device_ms(lambda: call(run_async=True)),
                  "bound_ms": 2 * g * n * 4 / HBM_BYTES_PER_S * 1e3})
    accl.free_buffer(sb)
    accl.free_buffer(rb)
    torch.cuda.synchronize()
    return path


A2A_COUNT = 6_553_600  # per rank: 25 MiB of fp32
A2A_SLOT = A2A_COUNT // 8  # 819 200 = 3 200 blocks of 256: the aligned path
A2A_CAPACITY = tuple(A2A_SLOT * q // 4 for q in (4, 3, 2, 1, 4, 3, 2, 1))
A2A_SMALL_SLOT = 1000  # no whole number of blocks: a hop's encode each


def a2a_oracle(x, slot: int, capacity=None):
    """numpy's transpose of the [rank, slot] grid, each receiver's slots
    cut to its capacity."""
    w = x.shape[0]
    out = x.reshape(w, w, slot).transpose(1, 0, 2).copy()
    for r, c in enumerate(capacity or ()):
        out[r, :, c:] = 0
    return out.reshape(w, w * slot)


def alltoall_phase(ring, qk, L):
    """alltoall and alltoallv, W = 8, fp32: a 25 MiB buffer per rank with
    slots of 819 200 (3 200 quantization blocks: the int8 wire's aligned
    exchange, one quantize and one dequantize of the whole buffer) and an
    8 000-element buffer with slots of 1 000 (a quantize and a dequantize
    a hop); alltoallv with capacities 819 200 x (1, 3/4, 1/2, 1/4, 1, 3/4,
    1/2, 1/4), the MoE expert-capacity dispatch; the exact and int8
    wires, and ALLTOALL_COMPRESS_MIN_COUNT set (the fp32 call takes the
    int8 wire) and back at 0 (the exact wire's bits). The exact wire
    bitwise with numpy's transpose, the int8 wire bitwise with the port's
    CPU run with every local slot exact, the launches as the wire says.
    Then facade_ms, device ms and the bound 2*W*n*4 bytes. Returns every
    kernel's launches over the checked runs."""
    import torch

    from accl_tpu_torch import ACCL, DataType, TuningParams

    world = 8
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    gen = torch.Generator(device="cuda").manual_seed(9753)
    accl, cpu = ACCL(world=world), ACCL(world=world, torch_device="cpu")
    expected: dict = {}
    kept = {}
    cases = [  # (slot, wire, capacity, register)
        (A2A_SLOT, None, None, 0), (A2A_SLOT, "int8", None, 0),
        (A2A_SLOT, None, A2A_CAPACITY, 0), (A2A_SLOT, "int8", A2A_CAPACITY, 0),
        (A2A_SLOT, None, None, 4096), (A2A_SLOT, None, A2A_CAPACITY, 4096),
        (A2A_SMALL_SLOT, None, None, 0), (A2A_SMALL_SLOT, "int8", None, 0),
    ]
    xs = {}
    for slot, wire, capacity, register in cases:
        n = world * slot
        if slot not in xs:
            xs[slot] = rank_data(world, n, torch.float32, gen)
        x = xs[slot]
        sb, rb = accl.create_buffer(n), accl.create_buffer(n)
        sb.device.copy_(x)
        cd = None if wire is None else DataType[wire]
        accl.configure_tuning_parameters(TuningParams(
            alltoall_compress_min_count=register))
        before = counts()
        try:
            if capacity is None:
                req = accl.alltoall(sb, rb, slot, from_device=True,
                                    to_device=True, compress_dtype=cd)
            else:
                req = accl.alltoallv(sb, rb, slot, capacity, from_device=True,
                                     to_device=True, compress_dtype=cd)
        finally:
            accl.configure_tuning_parameters(TuningParams.default())
        torch.cuda.synchronize()
        launched = delta(before)
        out = rb.device
        int8 = wire == "int8" or register > 0
        if req.plan.wire_dtype != (DataType.int8 if int8 else DataType.none):
            raise AssertionError(f"alltoall slot={slot} wire={wire} "
                                 f"register={register}: plan wire "
                                 f"{req.plan.wire_dtype}")
        if int8:
            hops = 1 if (capacity is None and slot % 256 == 0) else world - 1
            want = {"quantize": hops, "dequantize": hops}
        else:
            want = {}
        if launched != want:
            raise AssertionError(f"alltoall slot={slot} wire={wire} "
                                 f"capacity={capacity is not None} register="
                                 f"{register}: launched {launched}, expected "
                                 f"{want}")
        for k, v in want.items():
            expected[k] = expected.get(k, 0) + v
        grid, xgrid = out.reshape(world, world, slot), x.reshape(
            world, world, slot)
        me = torch.arange(world, device="cuda")
        own = xgrid[me, me].clone()
        for r, c in enumerate(capacity or ()):
            own[r, c:] = 0
        if not same_bits(grid[me, me], own):
            raise AssertionError(f"alltoall slot={slot} wire={wire}: a "
                                 "local slot is not exact")
        key = (slot, capacity)
        if int8 and register:  # the register's call is the explicit one's
            ok = same_bits(out, kept[key, "int8"])
        elif int8:
            csb = cpu.create_buffer(n, data=x.cpu())
            crb = cpu.create_buffer(n)
            if capacity is None:
                cpu.alltoall(csb, crb, slot, compress_dtype=cd)
            else:
                cpu.alltoallv(csb, crb, slot, capacity, compress_dtype=cd)
            ok = same_bits(out, crb.host.to("cuda"))
            cpu.free_buffer(csb)
            cpu.free_buffer(crb)
        else:
            ok = same_bits(out.cpu(), torch.from_numpy(
                a2a_oracle(x.cpu().numpy(), slot, capacity)))
        if not ok:
            raise AssertionError(f"alltoall slot={slot} wire={wire} "
                                 f"capacity={capacity is not None} register="
                                 f"{register}: wrong result")
        kept.setdefault((key, "int8" if int8 else None), out)
        emit({"phase": "alltoall", "world": world, "slot": slot,
              "bytes_per_rank": n * 4, "wire": wire,
              "alltoallv_capacity": capacity, "compress_register": register,
              "plan": req.plan.algorithm.name,
              "plan_wire": req.plan.wire_dtype.name, "launches": launched,
              "local_slot_exact": True,
              "checked_against": ("explicit int8 call" if int8 and register
                                  else "cpu run" if int8
                                  else "numpy transpose")})
        accl.free_buffer(sb)
        accl.free_buffer(rb)
    # register back at 0: the exact wire's bits
    sb, rb = accl.create_buffer(world * A2A_SLOT), \
        accl.create_buffer(world * A2A_SLOT)
    sb.device.copy_(xs[A2A_SLOT])
    accl.alltoall(sb, rb, A2A_SLOT, from_device=True, to_device=True)
    if not same_bits(rb.device, kept[(A2A_SLOT, None), None]):
        raise AssertionError("register 0 does not give the exact wire's bits")
    path = counts()
    want = {k: expected.get(k, 0) for k in kernels}
    if path != want or not (path["quantize"] and path["dequantize"]):
        raise AssertionError(f"alltoall path launched {path}, expected "
                             f"{want}")
    kept.clear()
    for capacity in (None, A2A_CAPACITY):
        for wire in (None, "int8"):
            cd = None if wire is None else DataType.int8

            def call(run_async=False):
                if capacity is None:
                    accl.alltoall(sb, rb, A2A_SLOT, from_device=True,
                                  to_device=True, compress_dtype=cd,
                                  run_async=run_async)
                else:
                    accl.alltoallv(sb, rb, A2A_SLOT, capacity,
                                   from_device=True, to_device=True,
                                   compress_dtype=cd, run_async=run_async)

            emit({"phase": "alltoall_timing", "world": world,
                  "slot": A2A_SLOT, "bytes_per_rank": A2A_COUNT * 4,
                  "wire": wire, "alltoallv_capacity": capacity,
                  "facade_ms": median_ms(call),
                  # an int8 alltoallv is ~80 device operations: 5 calls
                  # stay inside the launch queue behind the spin
                  "device_ms": device_ms(lambda: call(run_async=True),
                                         count=5),
                  "bound_ms": 2 * world * A2A_COUNT * 4 / HBM_BYTES_PER_S
                  * 1e3})
    accl.free_buffer(sb)
    accl.free_buffer(rb)
    torch.cuda.synchronize()
    return path


# ---------------------------------------------------------------------------
# the tuned path: ACCL.autotune and the plans it opens
# ---------------------------------------------------------------------------

KIB = 1 << 10
# the shipped timing model's crossovers (bytes) by (world, topology), as
# the reference computes them on the CPU; the registers are
# TuningParams.from_crossovers of them (the synth MAX registers capped at
# 4 MiB)
TUNED_CROSSOVERS = {
    (4, None): dict(synth_allreduce_max_bytes=2097152,
                    synth_allgather_max_bytes=524288,
                    synth_reduce_scatter_max_bytes=16777216,
                    synth_latency_max_bytes=32768,
                    hier_allreduce_min_bytes=0, overlap_min_bytes=1024),
    (8, None): dict(synth_allreduce_max_bytes=4194304,
                    synth_allgather_max_bytes=524288,
                    synth_reduce_scatter_max_bytes=16777216,
                    synth_latency_max_bytes=16384,
                    hier_allreduce_min_bytes=0, overlap_min_bytes=1024),
    (16, None): dict(synth_allreduce_max_bytes=8388608,
                     synth_allgather_max_bytes=524288,
                     synth_reduce_scatter_max_bytes=16777216,
                     synth_latency_max_bytes=0,
                     hier_allreduce_min_bytes=0, overlap_min_bytes=1024),
    (8, (4, 2)): dict(synth_allreduce_max_bytes=4194304,
                      synth_allgather_max_bytes=524288,
                      synth_reduce_scatter_max_bytes=16777216,
                      synth_latency_max_bytes=16384,
                      hier_allreduce_min_bytes=1024,
                      overlap_min_bytes=1024),
}
TUNED_REGISTER_CAP = 4 * MIB
# (label, world, topology, op, bytes per rank of the send buffer, dtype,
#  tier wires (None: autotune's), the plan: (algorithm, library key,
#  stripes), the launches of one call, how the result is checked: "cpu"
#  bitwise with the same plan on CPU tensors, "f64" within the rounding
#  bound of a float64 sum)
TUNED_CASES = (
    ("latency 1 KiB", 8, None, "allreduce", KIB, "float32", None,
     ("SYNTHESIZED", "allreduce_w8_exchange_d1_2_4_lat", 1),
     {"combine": 3}, "cpu"),
    ("latency 4 KiB", 8, None, "allreduce", 4 * KIB, "float32", None,
     ("SYNTHESIZED", "allreduce_w8_exchange_d1_2_4_lat", 1),
     {"combine": 3}, "cpu"),
    ("latency 16 KiB", 8, None, "allreduce", 16 * KIB, "float32", None,
     ("SYNTHESIZED", "allreduce_w8_exchange_d1_2_4_lat", 1),
     {"combine": 3}, "cpu"),
    ("latency 16 KiB bf16", 8, None, "allreduce", 16 * KIB, "bfloat16",
     None, ("SYNTHESIZED", "allreduce_w8_exchange_d1_2_4_lat", 1),
     {"combine_cast": 3}, "cpu"),
    ("overlap 64 KiB", 8, None, "allreduce", 64 * KIB, "float32", None,
     ("EAGER_RING_RS_AG", "", 4), {"ring_allreduce_bidir": 4}, "cpu"),
    ("synth 1 MiB", 8, None, "allreduce", MIB, "float32", None,
     ("SYNTHESIZED", "allreduce_w8_rs_ag_d1_2_4", 1), {"combine": 7},
     "cpu"),
    ("synth 4 MiB", 8, None, "allreduce", 4 * MIB, "float32", None,
     ("SYNTHESIZED", "allreduce_w8_rs_ag_d1_2_4", 1), {"combine": 7},
     "f64"),
    ("overlap 25 MiB", 8, None, "allreduce", 25 * MIB, "float32", None,
     ("EAGER_RING_RS_AG", "", 8), {"ring_allreduce_bidir": 8}, "f64"),
    ("allgather 256 KiB", 8, None, "allgather", 256 * KIB, "float32", None,
     ("SYNTHESIZED", "allgather_w8_doubling_d1_2_4", 1), {}, "cpu"),
    ("reduce_scatter 16 MiB", 8, None, "reduce_scatter", 16 * MIB,
     "float32", None,
     ("SYNTHESIZED", "reduce_scatter_w8_halving_d1_2_4", 1),
     {"combine": 7}, "cpu"),
    ("W16 synth 4 MiB", 16, None, "allreduce", 4 * MIB, "float32", None,
     ("SYNTHESIZED", "allreduce_w16_rs_ag_d1_2_4_8", 1), {"combine": 15},
     "f64"),
    ("hier int8 1 MiB", 8, (4, 2), "allreduce", MIB, "float32", None,
     ("HIER_RS_AR_AG", "", 1),
     {"quantize": 4, "dequant_combine_requant": 2, "dequant_combine": 2,
      "dequantize": 6}, "cpu"),
    ("hier int8 25 MiB", 8, (4, 2), "allreduce", 25 * MIB, "float32", None,
     ("HIER_RS_AR_AG", "", 2),
     {"quantize": 8, "dequant_combine_requant": 4, "dequant_combine": 4,
      "dequantize": 12}, "cpu"),
    ("hier exact 25 MiB", 8, (4, 2), "allreduce", 25 * MIB, "float32",
     ("none", "none"), ("HIER_RS_AR_AG", "", 8), {"combine": 32}, "f64"),
    ("hier fp16 1 MiB", 8, (4, 2), "allreduce", MIB, "float32",
     ("float16", "float16"), ("HIER_RS_AR_AG", "", 1),
     {"cast": 16, "combine": 4}, "cpu"),
    ("tiered synth 160 KiB", 8, (2, 4), "allreduce", 160 * KIB, "float32",
     None, ("SYNTHESIZED", "allreduce_w8_t2x4_lg_exchange_d1_o1_2", 1),
     {"combine": 3}, "cpu"),
)
TUNED_INT8_ENTRY = "allreduce_w8_exchange_d1_2_4_int8"  # explicit plan


def queued_device_ms(fn) -> float:
    """device_ms over as many calls as the launch queue holds behind the
    spin: a synthesized or two-tier call is tens to hundreds of device
    operations, so the count is what the host enqueues in about 4 ms
    (2 to 50 calls, by the host time of three calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    per_call = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    return device_ms(fn, count=max(2, min(50, int(4e-3 / per_call))))


def tuned_facades(world, topology, device):
    """(tuned, default) facades of `world` on `device`: the first
    autotuned from the shipped model with the ring kernel's body on
    either device (so the CPU twin runs the card's plan, plain versions),
    the second with the default registers."""
    from accl_tpu_torch import ACCL
    from accl_tpu_torch.device.gpu_device import GPUDevice

    tuned = ACCL(device=GPUDevice(world, device, hier_topology=topology))
    tuned.cclo.compiler.use_ring_kernel = True
    tuned.autotune()
    default = ACCL(device=GPUDevice(world, device, hier_topology=topology))
    default.cclo.compiler.use_ring_kernel = True
    return tuned, default


def tuned_phase(ring, qk, L):
    """ACCL.autotune on the card and every plan it opens. (1) autotune at
    W = 4, 8 and 16 and at W = 8 with hier_topology=(4, 2): the
    crossovers and registers against TUNED_CROSSOVERS, the tier wires
    (int8, int8). (2) TUNED_CASES through the facade, from/to device:
    the plan (algorithm, library entry, stripes) as the CPU predicted it,
    each call's kernel launches against TUNED_CASES, and the result
    bitwise with the same plan run on CPU tensors (the plain versions),
    or, for the exact calls at 4 and 25 MiB where the host is too slow,
    within the float64 sum's rounding bound; the W = 8 int8 exchange
    entry through an explicit plan the same way. (3) Each case's facade_ms and device ms beside the default
    plan's (registers 0) at the same size: recorded, selection
    unchanged. (4) One recorded sequence on the (4, 2) world holding a
    HIER allreduce and a synthesized reduce_scatter, prepared as one CUDA
    graph: bitwise with the eager calls, one graph launch a dispatch,
    launches at compile twice the eager calls' and none at replay.
    Returns every kernel's launches over the checked runs (counts set to
    0 just before the path; timing runs not counted) and fails if a
    kernel of the path was launched no time."""
    import torch

    from accl_tpu_torch import CallOptions, DataType, Operation, TuningParams
    from accl_tpu_torch.constants import ReduceFunction
    from accl_tpu_torch.sequencer.plan import Algorithm, Plan, Protocol
    from accl_tpu_torch.sequencer.timing import tuning_crossovers
    from accl_tpu_torch.telemetry import feedback

    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    gen = torch.Generator(device="cuda").manual_seed(10_010)
    S = ReduceFunction.SUM

    # (1) autotune
    facades = {}
    for (world, topo), want in TUNED_CROSSOVERS.items():
        tuned, default = tuned_facades(world, topo, "cuda")
        cross = tuning_crossovers(
            feedback.default_link(), world=world,
            tier_links=feedback.default_tier_links(), topology=topo,
            compute_fit=feedback.default_compute_fit())
        got = {k: cross[k] for k in want}
        regs = tuned.cclo.tuning()
        want_regs = {
            "synth_allreduce_max_count": min(
                want["synth_allreduce_max_bytes"], TUNED_REGISTER_CAP),
            "synth_allgather_max_count": min(
                want["synth_allgather_max_bytes"], TUNED_REGISTER_CAP),
            "synth_reduce_scatter_max_count": min(
                want["synth_reduce_scatter_max_bytes"], TUNED_REGISTER_CAP),
            "synth_latency_max_count": want["synth_latency_max_bytes"],
            "hier_allreduce_min_count": want["hier_allreduce_min_bytes"],
            "overlap_min_count": want["overlap_min_bytes"]}
        got_regs = {k: getattr(regs, k) for k in want_regs}
        wires = [w.name for w in tuned.cclo.hier_wires]
        want_wires = ["int8", "int8"] if topo else ["none", "none"]
        if got != want or got_regs != want_regs or wires != want_wires:
            raise AssertionError(
                f"autotune W={world} topology={topo}: crossovers {got}, "
                f"registers {got_regs}, tier wires {wires}; expected "
                f"{want}, {want_regs}, {want_wires}")
        emit({"phase": "tuned_autotune", "world": world, "topology": topo,
              "crossovers": got, "registers": got_regs,
              "tier_wires": wires})
        facades[world, topo] = tuned, default
    facades[8, (2, 4)] = tuned_facades(8, (2, 4), "cuda")
    cpu_twins: dict = {}

    def cpu_twin(world, topo):
        if (world, topo) not in cpu_twins:
            cpu_twins[world, topo] = tuned_facades(world, topo, "cpu")[0]
        return cpu_twins[world, topo]

    path = dict.fromkeys(kernels, 0)
    rows = []
    for (label, world, topo, op, nbytes, dt, wires, plan_want, launches_want,
         check) in TUNED_CASES:
        tuned, default = facades[world, topo]
        dtype = getattr(torch, dt)
        width_in = nbytes // dtype.itemsize
        count = width_in // world if op == "reduce_scatter" else width_in
        width_out = count * world if op == "allgather" else count
        x = rank_data(world, width_in, dtype, gen)
        bufs = {}
        for side, accl in (("tuned", tuned), ("default", default)):
            sb = accl.create_buffer(width_in, dtype)
            rb = accl.create_buffer(width_out, dtype)
            sb.device.copy_(x)
            bufs[side] = sb, rb
        saved = tuned.cclo.hier_wires
        if wires is not None:
            tuned.cclo.hier_wires = tuple(DataType[w] for w in wires)

        def call(side, run_async=False):
            accl = tuned if side == "tuned" else default
            sb, rb = bufs[side]
            if op == "allgather":
                return accl.allgather(sb, rb, count, from_device=True,
                                      to_device=True, run_async=run_async)
            return getattr(accl, op)(sb, rb, count, S, from_device=True,
                                     to_device=True, run_async=run_async)

        before = counts()
        req = call("tuned")
        torch.cuda.synchronize()
        launched = delta(before)
        for k, v in launched.items():
            path[k] += v
        plan = (req.plan.algorithm.name, req.plan.synth_key,
                req.plan.stripes)
        if plan != plan_want or launched != launches_want:
            raise AssertionError(f"tuned {label}: plan {plan}, launches "
                                 f"{launched}; expected {plan_want}, "
                                 f"{launches_want}")
        out = bufs["tuned"][1].device
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"tuned {label}: non-finite result")
        if check == "cpu":
            twin = cpu_twin(world, topo)
            if wires is not None:
                twin.cclo.hier_wires = tuned.cclo.hier_wires
            csb = twin.create_buffer(width_in, dtype, data=x.cpu())
            crb = twin.create_buffer(width_out, dtype)
            if op == "allgather":
                creq = twin.allgather(csb, crb, count)
            else:
                creq = getattr(twin, op)(csb, crb, count, S)
            twin.cclo.hier_wires = saved
            if creq.plan != req.plan or not same_bits(out.cpu(), crb.host):
                raise AssertionError(f"tuned {label}: differs from the "
                                     "same plan on CPU tensors")
            twin.free_buffer(csb)
            twin.free_buffer(crb)
            err = 0.0
        else:
            err = check_against_float64(out, x, S, F32_UNIT)
        tuned.cclo.hier_wires = saved
        row = {"phase": "tuned", "case": label, "world": world,
               "topology": topo, "op": op, "bytes_per_rank": nbytes,
               "dtype": dt, "plan": plan,
               "tier_wires": [req.plan.inner_wire_dtype.name,
                              req.plan.outer_wire_dtype.name],
               "launches": launched, "checked_against": check,
               "bound_excess": err}
        for side in ("tuned", "default"):
            if side == "tuned" and wires is not None:
                tuned.cclo.hier_wires = tuple(DataType[w] for w in wires)
            dreq = call(side)
            row[f"{side}_plan"] = dreq.plan.algorithm.name
            row[f"{side}_facade_ms"] = median_ms(lambda: call(side))
            row[f"{side}_device_ms"] = queued_device_ms(
                lambda: call(side, run_async=True))
            tuned.cclo.hier_wires = saved
        row["bound_ms"] = (nbytes + width_out * dtype.itemsize) * world \
            / HBM_BYTES_PER_S * 1e3
        emit(row)
        rows.append(row)
        for side, accl in (("tuned", tuned), ("default", default)):
            for b in bufs[side]:
                accl.free_buffer(b)

    # the int8 exchange entry through an explicit plan (never auto-selected)
    tuned, default = facades[8, None]
    count = 16 * KIB
    plan = Plan(Protocol.EAGER, Algorithm.SYNTHESIZED, count, 1,
                synth_key=TUNED_INT8_ENTRY)
    opts = CallOptions(scenario=Operation.allreduce, count=count,
                       function=0, data_type=DataType.float32)
    body = tuned.cclo.compiler.lower(opts, plan)
    x = rank_data(8, count, torch.float32, gen)
    before = counts()
    out = body(x)
    torch.cuda.synchronize()
    launched = delta(before)
    for k, v in launched.items():
        path[k] += v
    want = {"quantize": 3, "dequant_combine": 3}
    cpu_out = cpu_twin(8, None).cclo.compiler.lower(opts, plan)(x.cpu())
    if launched != want or not same_bits(out.cpu(), cpu_out):
        raise AssertionError(f"int8 entry: launches {launched} (expected "
                             f"{want}) or differs from the CPU run")
    sb, rb = default.create_buffer(count), default.create_buffer(count)
    sb.device.copy_(x)

    def int8_default(run_async=False):
        return default.allreduce(sb, rb, count, S, from_device=True,
                                 to_device=True, run_async=run_async,
                                 compress_dtype=DataType.int8)

    emit({"phase": "tuned", "case": "int8 exchange entry 64 KiB",
          "world": 8, "plan": ("SYNTHESIZED", TUNED_INT8_ENTRY, 1),
          "launches": launched, "checked_against": "cpu",
          "tuned_device_ms": queued_device_ms(lambda: body(x)),
          "tuned_body_ms": median_ms(lambda: body(x)),
          "default_plan": int8_default().plan.algorithm.name,
          "default_facade_ms": median_ms(int8_default),
          "default_device_ms": queued_device_ms(lambda: int8_default(True)),
          "bound_ms": 2 * 8 * count * 4 / HBM_BYTES_PER_S * 1e3})
    default.free_buffer(sb)
    default.free_buffer(rb)

    # (4) a recorded sequence with HIER and SYNTHESIZED steps
    tuned = facades[8, (4, 2)][0]
    n, c = 25 * MIB // 4, 25 * MIB // 32

    def seq_bufs():
        return (tuned.create_buffer(n), tuned.create_buffer(n),
                tuned.create_buffer(c), tuned.create_buffer(n))

    def issue(ops, a, b, cc, d):
        ops.allreduce(a, b, n, S)
        ops.reduce_scatter(b, cc, c, S)
        ops.allgather(cc, d, c)

    eager, fused = seq_bufs(), seq_bufs()
    x = rank_data(8, n, torch.float32, gen)
    eager[0].device.copy_(x)
    fused[0].device.copy_(x)

    def run_eager():
        issue(_Facade(tuned), *eager)
        torch.cuda.synchronize()

    before = counts()
    run_eager()
    eager_launches = delta(before)
    rec = tuned.sequence()
    issue(rec, *fused)
    before = counts()
    prog = rec.compile()
    compile_launches = delta(before)
    for k, v in eager_launches.items():
        path[k] += 3 * v  # the eager twin, the warm-up run, the capture
    if compile_launches != {k: 2 * v for k, v in eager_launches.items()}:
        raise AssertionError(f"tuned sequence: launches at compile "
                             f"{compile_launches}, the eager calls' "
                             f"{eager_launches}")
    before = counts()
    req = prog.run(from_device=True, to_device=True)
    torch.cuda.synchronize()
    plans = [p.algorithm.name for p in req.plans]
    if (delta(before) or req.num_dispatches != 1
            or plans != ["HIER_RS_AR_AG", "SYNTHESIZED", "RNDZV_RING"]):
        raise AssertionError(f"tuned sequence: plans {plans}, "
                             f"{req.num_dispatches} dispatches, replay "
                             f"launches {delta(before)}")
    for got, want in zip(fused[1:], eager[1:]):
        if not same_bits(got.device, want.device):
            raise AssertionError("tuned sequence differs from the eager "
                                 "calls")
    prof = kernel_profile(lambda: prog.run(from_device=True, to_device=True))
    if prof["graph_launches"] != 1:
        raise AssertionError(f"tuned sequence: {prof['graph_launches']} "
                             "graph launches a dispatch")
    emit({"phase": "tuned_sequence", "world": 8, "topology": (4, 2),
          "bytes_per_rank": 25 * MIB, "plans": plans,
          "bitwise_vs_eager": True, "launches_eager": eager_launches,
          "launches_at_compile": compile_launches, "launches_per_replay": 0,
          "graph_launches_per_dispatch": prof["graph_launches"],
          "device_kernels_per_dispatch": sum(prof["kernels"].values()),
          "eager_facade_ms": median_ms(run_eager, reps=5, warmup=1),
          "replay_facade_ms": median_ms(
              lambda: prog.run(from_device=True, to_device=True), reps=5,
              warmup=1)})
    del prog, rec
    for accls in facades.values():
        for accl in accls:
            accl.cclo.compiler._cache.clear()
    facades.clear()
    cpu_twins.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    idle = [k for k, v in path.items() if v == 0 and k not in
            ("ring_allreduce", QUANT_RING[0])]
    if idle:
        raise AssertionError(f"the tuned path launched no {idle}")
    return path


TELE_SIZES = (4 * KIB, 64 * KIB, MIB, 4 * MIB, 25 * MIB)  # bytes per rank
TELE_CALLS = 5  # traced calls per size
TELE_INT8 = MIB  # the int8-wire call's bytes per rank
TELE_SEQ = MIB  # the reduce_scatter -> allgather sequence's, per rank
TELE_PAIRS = 10  # alternating rounds of the always-on cost
# the tuned phase's windows: (op, bytes per rank of the send buffer, how the
# result is checked, as TUNED_CASES)
TELE_WINDOWS = (("allreduce", KIB, "cpu"), ("allreduce", 16 * KIB, "cpu"),
                ("allreduce", MIB, "cpu"), ("allreduce", 4 * MIB, "f64"),
                ("allreduce", 25 * MIB, "f64"),
                ("allgather", 256 * KIB, "cpu"))


def tele_workload(accl, x, counts, delta, seen):
    """The telemetry path's calls on one W = 8 facade, from/to device:
    TELE_CALLS allreduces at each of TELE_SIZES, one on the int8 wire, a
    reduce_scatter -> allgather sequence run once through the recorder,
    then compiled and run twice, and one run_async allreduce waited on.
    After each call, seen(label, request, result tensor, launches); the
    result tensor is the buffer's own (clone it to keep it)."""
    import torch

    from accl_tpu_torch import DataType
    from accl_tpu_torch.constants import ReduceFunction

    S = ReduceFunction.SUM

    def record(label, fn, buf):
        before = counts()
        req = fn()
        torch.cuda.synchronize()
        seen(label, req, buf.device, delta(before))

    for nbytes in TELE_SIZES:
        n = nbytes // 4
        sb, rb = accl.create_buffer(n), accl.create_buffer(n)
        sb.device.copy_(x[:, :n])
        for i in range(TELE_CALLS):
            record(f"allreduce {nbytes}", lambda: accl.allreduce(
                sb, rb, n, S, from_device=True, to_device=True), rb)
        accl.free_buffer(sb)
        accl.free_buffer(rb)
    n = TELE_INT8 // 4
    sb, rb = accl.create_buffer(n), accl.create_buffer(n)
    sb.device.copy_(x[:, :n])
    record("allreduce int8", lambda: accl.allreduce(
        sb, rb, n, S, from_device=True, to_device=True,
        compress_dtype=DataType.int8), rb)
    n = TELE_SEQ // 4
    c = n // 8
    a, b, d = (accl.create_buffer(n), accl.create_buffer(c),
               accl.create_buffer(n))
    a.device.copy_(x[:, :n])

    def batch(ops):
        ops.reduce_scatter(a, b, c, S)
        ops.allgather(b, d, c)
        return ops

    record("sequence", lambda: batch(accl.sequence()).run(
        from_device=True, to_device=True), d)
    prog = batch(accl.sequence()).compile()
    for _ in range(2):
        d.device.zero_()
        record("program", lambda: prog.run(from_device=True, to_device=True),
               d)
    n = MIB // 4

    def run_async():
        req = accl.allreduce(sb, rb, n, S, from_device=True, to_device=True,
                             run_async=True)
        return accl.wait(req)

    record("allreduce async", run_async, rb)
    for buf in (sb, rb, a, b, d):
        accl.free_buffer(buf)


def telemetry_phase(ring, qk, L):
    """Telemetry on the card (accl_tpu_torch/telemetry/). (1) Trace: the
    calls of tele_workload run once with the tracer off and once on,
    each on a new facade;
    the results bitwise and each call's kernel launches the same; the
    trace validates (the port's own validator), exports to the facade,
    device and layer tracks, every call span names its request's plan
    and a positive prediction, the phase spans off the layer track share
    one signature, the
    recorded sequence's prediction is the sum of its steps'. (2) The
    copied timing model's residuals against those host-measured spans,
    the registry's exposition and the sentinel's report. (3) Each exact
    synchronous call's CUDA-event duration lifted into a raw record
    through telemetry.native.native_event under the facade's own eager
    geometry and registers (its plan must be the plan that ran),
    calibrate_from_trace over them (the card's LinkParams),
    residual_improvement, and autotune_from_trace's registers beside
    autotune()'s; for TELE_WINDOWS the plan each register set selects,
    its device ms, each call checked as tuned_phase checks it. (4) The
    always-on cost: the 4 KiB allreduce's facade_ms with observability
    off, with live spans and predictions only, on (the default) and
    tracing on, in TELE_PAIRS rotating rounds.
    (5) The flight recorder: a recv no send matches times out; the
    sticky retcode freezes a valid post-mortem holding the error marker
    and the preceding call span, accl_errors_total rises by one;
    GPUDevice.wire_stats is the stats2 surface at 0. Returns each
    kernel's launches over the checked runs of (1), (3) and (5)."""
    import torch

    from accl_tpu_torch import ACCL, ACCLError, Operation
    from accl_tpu_torch import telemetry as T
    from accl_tpu_torch.constants import ReduceFunction
    from accl_tpu_torch.device.base import STATS2_FIELDS
    from accl_tpu_torch.device.gpu_device import GPUDevice

    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    path = dict.fromkeys(kernels, 0)

    def add(launched):
        for k, v in launched.items():
            path[k] += v

    gen = torch.Generator(device="cuda").manual_seed(11_011)
    x = rank_data(8, max(TELE_SIZES) // 4, torch.float32, gen)
    S = ReduceFunction.SUM
    tr = T.get_tracer()
    if not T.observability_enabled() or tr.enabled:
        raise AssertionError("telemetry: expected the defaults (ACCL_OBS "
                             "on, tracing off)")

    # (1) the workload with tracing off, then on, each on a facade of its
    # own (a second facade compiles and captures afresh, as the first
    # did); the traced run compares each result as it comes and keeps no
    # clone, so its calls reuse the allocator's blocks as a loop would
    off, on = [], []
    tele_workload(ACCL(world=8), x, counts, delta,
                  lambda *call: off.append((*call[:2], call[2].clone(),
                                            call[3])))

    def check(label, req, got, launched):
        want_label, _, want, l_off = off[len(on)]
        add(launched)
        add(l_off)
        if (label != want_label or not same_bits(got, want)
                or launched != l_off):
            raise AssertionError(f"telemetry {label}: traced result or "
                                 f"launches {launched} differ from "
                                 f"untraced ({l_off})")
        on.append((label, req))

    accl = ACCL(world=8)
    tr.clear()
    tr.enable()
    t0 = time.perf_counter()
    tele_workload(accl, x, counts, delta, check)
    traced_s = time.perf_counter() - t0
    tr.disable()
    trace = tr.to_trace({"world": 8, "device": torch.cuda.get_device_name(0)})
    tr.clear()
    del off
    T.validate_trace(trace)
    chrome = T.to_chrome(trace)
    tracks = {e["args"]["name"] for e in chrome["traceEvents"]
              if e["ph"] == "M"}
    spans = trace["spans"]
    calls = [s for s in spans if s["cat"] == "call"]
    reqs = [(label, req) for label, req in on
            if label.startswith("allreduce")]
    # the layer track holds the dispatches' layer spans (bind, load, ...)
    if tracks != {"facade", "device", "layer"} or len(calls) != len(reqs):
        raise AssertionError(f"telemetry: tracks {tracks}, {len(calls)} "
                             f"call spans for {len(reqs)} calls")
    for span, (label, req) in zip(calls, reqs):
        a = span["args"]
        if (a.get("algorithm") != req.plan.algorithm.name
                or not a.get("predicted_s", 0) > 0
                or a.get("dispatch_only", False) != (label.endswith("async"))):
            raise AssertionError(f"telemetry {label}: span args {a}, "
                                 f"plan {req.plan.algorithm.name}")
    sigs = {s["args"]["signature"] for s in spans
            if s["cat"] == "phase" and s["track"] != "layer"}
    recorded = next(s for s in spans if s["cat"] == "sequence")
    steps = [s for s in spans if s["cat"] == "step"][:2]
    if len(sigs) != 1 or recorded["args"]["predicted_s"] != sum(
            s["args"]["predicted_s"] for s in steps):
        raise AssertionError(f"telemetry: phase signatures {sigs}, the "
                             f"sequence's prediction {recorded['args']}")
    emit({"phase": "telemetry_trace", "spans": len(spans),
          "by_cat": {c: sum(s["cat"] == c for s in spans)
                     for c in sorted({s["cat"] for s in spans})},
          "tracks": sorted(tracks), "signature": sigs.pop(),
          "valid": True, "bitwise_vs_untraced": True,
          "launches_same_as_untraced": True, "traced_workload_s": traced_s})

    # (2) the copied model's residuals against the host-measured spans
    rows = T.residual_rows(trace)
    replay = T.replay_trace(trace)
    per_size = {}
    for span in calls:
        a = span["args"]
        if a.get("dispatch_only"):
            continue
        key = f"{a['op']} {a['count'] * 4} B {a['algorithm']}"
        per_size.setdefault(key, []).append(
            (span["dur_ns"] / 1e6, a["predicted_s"] * 1e3))
    emit({"phase": "telemetry_residuals",
          "summary": T.residual_summary(rows),
          "facade_span_ms_vs_predicted_ms": {
              k: {"measured_median": statistics.median(m for m, _ in v),
                  "predicted": v[0][1]} for k, v in per_size.items()},
          "exposition_lines": len(replay.registry.expose_text().splitlines()),
          "live_exposition_lines": len(
              T.get_registry().expose_text().splitlines()),
          "sentinel": replay.sentinel.report()})

    # (3) device durations lifted into raw records, the card's fit
    cclo = accl.cclo
    lifted = []
    for label, req in on:
        if label.startswith("allreduce") and label[10:].isdigit():
            n = int(label[10:]) // 4
            raw = {"opcode": int(Operation.allreduce), "count": n,
                   "bytes": n * 4, "start_ns": 0,
                   "end_ns": req.get_duration_ns(), "retcode": req.retcode,
                   "detail": 0, "d_passes": 0, "d_parks": 0,
                   "d_seek_hit": 0, "d_seek_miss": 0}
            ev = T.native.native_event(
                raw, world=8, track="device/events", link=T.default_link(),
                max_eager_size=cclo.max_eager_size,
                rx_buf_bytes=cclo.eager_rx_buf_size, tuning=cclo.tuning())
            if ev["args"]["algorithm"] != req.plan.algorithm.name:
                raise AssertionError(f"telemetry {label}: the lifted plan "
                                     f"{ev['args']['algorithm']} is not "
                                     f"{req.plan.algorithm.name}")
            lifted.append(ev)
    fit_trace = {"schema": T.SCHEMA_VERSION,
                 "meta": {"world": 8, "source": "CUDA-event durations"},
                 "spans": lifted}
    T.validate_trace(fit_trace)
    card = T.calibrate_from_trace(fit_trace)
    improvement = T.residual_improvement(fit_trace)
    copied = ACCL(device=GPUDevice(8, "cuda"))
    fitted = ACCL(device=GPUDevice(8, "cuda"))
    twins = {}
    for side, facade in (("copied", copied), ("fitted", fitted)):
        facade.cclo.compiler.use_ring_kernel = True
        twin = ACCL(device=GPUDevice(8, "cpu"))
        twin.cclo.compiler.use_ring_kernel = True
        for f in (facade, twin):
            if side == "copied":
                f.autotune()
            else:
                T.autotune_from_trace(f, fit_trace)
        if vars(twin.cclo.tuning()) != vars(facade.cclo.tuning()):
            raise AssertionError(f"telemetry: the {side} CPU twin's "
                                 "registers differ")
        twins[side] = twin
    emit({"phase": "telemetry_fit",
          "label": "one card: prices launches and memory copies, not a link",
          "samples": len(lifted),
          "card_link": {"alpha_us": card.alpha * 1e6,
                        "beta_gbps": card.beta / 1e9},
          "residual_improvement": improvement,
          "registers": {"copied_autotune": vars(copied.cclo.tuning()),
                        "autotune_from_trace": vars(fitted.cclo.tuning())}})
    for op, nbytes, check in TELE_WINDOWS:
        n = nbytes // 4
        width_out = n * 8 if op == "allgather" else n
        row = {"phase": "telemetry_window", "op": op,
               "bytes_per_rank": nbytes, "checked_against": check,
               "bound_ms": (nbytes + width_out * 4) * 8
               / HBM_BYTES_PER_S * 1e3}
        for side, facade in (("copied", copied), ("fitted", fitted)):
            sb = facade.create_buffer(n)
            rb = facade.create_buffer(width_out)
            sb.device.copy_(x[:, :n])

            def call(run_async=False):
                if op == "allgather":
                    return facade.allgather(sb, rb, n, from_device=True,
                                            to_device=True,
                                            run_async=run_async)
                return facade.allreduce(sb, rb, n, S, from_device=True,
                                        to_device=True, run_async=run_async)

            before = counts()
            req = call()
            torch.cuda.synchronize()
            add(delta(before))
            out = rb.device
            if check == "cpu":
                twin = twins[side]
                csb = twin.create_buffer(n, data=x[:, :n].cpu())
                crb = twin.create_buffer(width_out)
                creq = (twin.allgather(csb, crb, n) if op == "allgather"
                        else twin.allreduce(csb, crb, n, S))
                if creq.plan != req.plan or not same_bits(out.cpu(),
                                                          crb.host):
                    raise AssertionError(f"telemetry {side} {op} {nbytes}: "
                                         "differs from its CPU twin")
                twin.free_buffer(csb)
                twin.free_buffer(crb)
            else:
                check_against_float64(out, x[:, :n], S, F32_UNIT)
            row[f"{side}_plan"] = (req.plan.algorithm.name,
                                   req.plan.synth_key, req.plan.stripes)
            row[f"{side}_device_ms"] = queued_device_ms(
                lambda: call(run_async=True))
            facade.free_buffer(sb)
            facade.free_buffer(rb)
        emit(row)

    # (4) the always-on cost at 4 KiB, in rotating rounds of four states
    n = 1024
    sb, rb = accl.create_buffer(n), accl.create_buffer(n)
    sb.device.copy_(x[:, :n])

    def no_op(ev):
        pass

    def state(name):
        # "spans": live spans and predictions, no metrics or recorder (a
        # no-op observer keeps the tracer active): splits the default's
        # cost between the emission seam and the observers
        if name == "default" or name == "tracing":
            T.enable_observability()
        else:
            T.disable_observability()
        (tr.add_observer if name == "spans" else tr.remove_observer)(no_op)
        (tr.enable if name == "tracing" else tr.disable)()

    def fn():
        accl.allreduce(sb, rb, n, S, from_device=True, to_device=True)

    names = ("off", "spans", "default", "tracing")
    times = {s: [] for s in names}
    for p in range(TELE_PAIRS):
        for s in names[p % 4:] + names[:p % 4]:
            state(s)
            times[s].append(median_ms(fn, reps=5, warmup=1))
    state("default")
    tr.clear()
    us = {s: statistics.median(t) * 1e3 for s, t in times.items()}
    emit({"phase": "telemetry_cost", "bytes_per_rank": 4 * KIB,
          "facade_us_per_call": us,
          "over_off_us": {s: us[s] - us["off"] for s in names[1:]},
          "facade_ms_rounds": times})

    # (5) the flight recorder on a timed-out recv
    def errors_total():
        return sum(r["value"] for r in T.get_registry().snapshot()
                   ["counters"].get("accl_errors_total", []))

    T.get_recorder().clear()
    before_errors = errors_total()
    before = counts()
    fn()
    add(delta(before))
    accl.set_timeout(20_000)
    try:
        accl.recv(rb, n, src=0, dst=1, tag=77)
    except ACCLError as e:
        if "RECEIVE_TIMEOUT" not in str(e):
            raise
    else:
        raise AssertionError("telemetry: the unmatched recv did not fail")
    finally:
        accl.set_timeout(1_000_000)
    doc = T.last_error_trace()
    T.validate_trace(doc)
    kinds = [(s["name"], s["cat"]) for s in doc["spans"]]
    marker = doc["spans"][-1]
    stats = accl.cclo.wire_stats()
    health = T.wire_health_report({0: stats})
    T.validate_trace({"schema": T.SCHEMA_VERSION, "spans": [],
                      "meta": {"wire_health": health}})
    if (kinds[-2:] != [("allreduce", "call"), ("recv", "error")]
            or errors_total() != before_errors + 1
            or tuple(stats) != STATS2_FIELDS or any(stats.values())):
        raise AssertionError(f"telemetry: post-mortem spans {kinds}, "
                             f"errors {errors_total() - before_errors}, "
                             f"wire_stats {stats}")
    emit({"phase": "telemetry_flight", "reason": doc["meta"]["reason"],
          "spans": kinds, "marker": marker["args"],
          "errors_total_delta": 1, "valid": True,
          "wire_stats_all_zero": True})
    accl.free_buffer(sb)
    accl.free_buffer(rb)
    for f in (accl, copied, fitted):
        f.cclo.compiler._cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    idle = [k for k in ("ring_allreduce_bidir", QUANT_RING[0], "combine")
            if path[k] == 0]
    if idle:
        raise AssertionError(f"the telemetry path launched no {idle}")
    return path


# the flagship transformer's widths (bench.py's flagship LM) in fp32, the
# one dtype the fused decode step takes, at a tensor-parallel world of 4
SERVE_CFG = dict(vocab=32768, d_model=1024, n_heads=16, n_kv_heads=4,
                 n_layers=8, d_ff=4096)
SERVE_WORLD, SERVE_BATCH, SERVE_LEN = 4, 8, 1024
SERVE_STEPS = 16  # fused against eager
SERVE_CPU_STEPS = 4  # the card against the port's CPU run
SERVE_SEQ = 32  # decode against forward_local
SERVE_REPS = 50  # timed steps
SERVE_JOIN = (0, 0, 0, 0, 7, 19)  # the step each request is submitted at
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SERVE_TOL = 1e-4  # |delta| <= SERVE_TOL * max|ref| (card against CPU/oracle)
# the parts of a hand-written kernel's (demangled) name in a profile ->
# its kernels-line name
SERVE_PROFILE_NAMES = {("lane_walk<", "Combine<"): "combine",
                       ("ring_allreduce_kernel",): "ring_allreduce_bidir"}


def serve_bound(cfg, world: int, batch: int, pos) -> dict:
    """The least time of one decode step: the bytes it must move (every
    layer weight and the unembedding read once, the embedded inputs and
    positions read once, each slot's cache rows 0..pos read once and one
    row written, the logits written once) over 3.35 TB/s, and its float32
    operations (the projections, MLP and head of B tokens, each slot's
    attention over pos+1 rows) over 67 TFLOP/s (TF32 is off), for this
    step's positions `pos`."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    F, V, L = cfg.d_ff, cfg.vocab, cfg.n_layers
    layer_w = D * H * hd + D * 2 * KV * hd + H * hd * D + 2 * D * F + 2 * D
    rows = sum(int(p) + 1 for p in pos)  # cache rows attended, all slots
    nbytes = 4 * (L * layer_w + D * V + batch * (D + 1)
                  + L * 2 * KV * hd * (rows + batch) + batch * V)
    flops = (2 * batch * (L * (layer_w - 2 * D) + D * V)
             + L * 2 * 2 * H * hd * rows)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def serve_requests(vocab: int):
    """The server's six ragged requests: prompts of 3-40 tokens, 8-48 new
    tokens, each submitted at its SERVE_JOIN step."""
    import numpy as np

    rng = np.random.default_rng(1212)
    return [(join, [int(t) for t in rng.integers(1, vocab,
                                                 int(rng.integers(3, 41)))],
             int(rng.integers(8, 49))) for join in SERVE_JOIN]


def serve_drive(srv, requests) -> dict:
    """Run `requests` (join step, prompt, max_new_tokens) through the
    server, each submitted at its join step. Returns, by request index,
    its generated tokens, the logits row of every step it took part in
    (host copies) and the slot it held."""
    import torch

    V = srv.cfg.vocab
    rows, slot_of, reqs = {}, {}, {}
    pending = list(enumerate(requests))
    while pending or srv.active:
        while pending and pending[0][1][0] <= srv.n_steps:
            i, (_, prompt, new) = pending.pop(0)
            reqs[i] = srv.submit(prompt, new)
        srv._admit()
        slots = [(b, s.req.rid) for b, s in enumerate(srv._slots)
                 if s is not None]
        srv.step()
        logits = srv._buffers.logits.host[0, :srv.batch * V].view(
            srv.batch, V)
        for b, rid in slots:
            rows.setdefault(rid, []).append(logits[b].clone())
            slot_of[rid] = b
    return {i: (r.generated, torch.stack(rows[r.rid]), slot_of[r.rid])
            for i, r in reqs.items()}


def serve_alone(srv, host, slot: int, prompt, new: int):
    """One request decoded alone through the server's program, in slot
    `slot`, every other slot idle (token 0 at position 0, as the server
    feeds idle slots): the prompt teacher-forced a token a step, then
    greedy tokens until `new`. The sequential reference of the batched
    run: an allreduce folds each element in an order set by its chunk of
    the row, so a slot's logits are bitwise only slot for slot."""
    import torch

    from accl_tpu_torch.models import transformer as trf

    B, bf = srv.batch, srv._buffers
    generated, rows = [], []
    for pos in range(len(prompt) + new - 1):
        toks, at = [0] * B, [0] * B
        toks[slot] = prompt[pos] if pos < len(prompt) else generated[-1]
        at[slot] = pos
        trf.write_decode_inputs(bf, host, toks, at)
        srv._program.run(to_device=True)
        logits = trf.read_decode_logits(bf, sync=True)[slot]
        rows.append(logits)
        if pos + 1 >= len(prompt):
            generated.append(int(torch.argmax(logits)))
    return generated, torch.stack(rows)


def serve_phase(ring, qk, L):
    """The serving path (accl_tpu_torch/models/) on the card at the
    flagship transformer's widths, fp32, W = 4 tensor-parallel virtual
    ranks, batch 8, max_len 1024, random weights from a seed. TF32 must
    be off. (1) 16 steps at ragged per-slot positions through the fused
    program (one CUDA-graph replay a step) and the eager twin: logits
    and every layer's state bitwise equal. (2) The first 4 of them on
    CPU tensors (the plain versions): within SERVE_TOL * max|ref| of the
    card. (3) 8 sequences of 32 tokens decoded step by step (through the
    same program: the stale caches are masked) against forward_local on
    the card, position by position, within the same bound. (4) A fused
    DecodeServer with six ragged requests joining and leaving at step
    boundaries: tokens and every logits row bitwise equal to each
    request decoded alone through the same program in the slot it held
    (serve_alone). (5) With the default
    registers and after autotune(): the allreduce steps' plan; a lone
    allreduce of the step's size on the same registers gives the plan's
    launches, and the eager step must launch kernel 7 16 times plus 16
    times the plan's; compile (warm-up and capture) twice that, a replay
    none; one replay profiled: one graph launch, and inside it kernel 7
    and the ring kernel as many times as the eager step launches them.
    (6) For each register set: the fused and the eager step's ms (median
    of 50, CUDA events and host clock: stage xp, run, read the logits),
    tokens/s at batch 8, accl_serve_step_seconds p50/p99 over the ragged
    workload, the bytes staged per step (only xp: W * n_out * 4), and
    the step's bound. Returns each kernel's launches over the checked
    runs of (1), (4) and (5)."""
    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, ReduceFunction
    from accl_tpu_torch.buffers import GPUBuffer
    from accl_tpu_torch.models import serve
    from accl_tpu_torch.models import transformer as trf
    from accl_tpu_torch.telemetry.metrics import MetricsRegistry, quantile_key

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("serve: TF32 is on; fp32 products must be fp32")
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    path = dict.fromkeys(kernels, 0)

    def add(launched):
        for k, v in launched.items():
            path[k] += v

    cfg = trf.TransformerConfig(**SERVE_CFG)
    W, B, T, V = SERVE_WORLD, SERVE_BATCH, SERVE_LEN, cfg.vocab
    params = trf.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(1212), "cuda")
    host = {"embed": params["embed"].cpu()}
    rng = np.random.default_rng(2024)
    start = before = counts()

    def fused_step(prog, bf, toks, pos):
        trf.write_decode_inputs(bf, host, toks, pos)
        prog.run(to_device=True)
        return trf.read_decode_logits(bf, sync=True)

    def eager_step(accl, bf, toks, pos):
        trf.write_decode_inputs(bf, host, toks, pos)
        trf.run_decode_step_eager(accl, cfg, bf)
        return trf.read_decode_logits(bf)

    def eager_twin(accl):
        be = trf.create_decode_buffers(accl, cfg, B, T)
        trf.register_decode_consumers(accl, cfg, params, be.dims)
        return be

    def states(bf):
        return [s.device for s in bf.state]

    # (1) fused against eager, 16 chained steps at ragged positions
    accl_f, accl_e = ACCL(world=W), ACCL(world=W)
    before = counts()
    t0 = time.perf_counter()
    prog, bf = trf.make_decode_step_program(accl_f, cfg, params, batch=B,
                                            max_len=T)
    compile_s = time.perf_counter() - t0
    compile_launches = delta(before)
    be = eager_twin(accl_e)
    start_pos = rng.integers(0, T - SERVE_STEPS, B)
    steps = [(rng.integers(1, V, B), start_pos + s)
             for s in range(SERVE_STEPS)]
    card = []
    for s, (toks, pos) in enumerate(steps):
        before = counts()
        lf = fused_step(prog, bf, toks, pos)
        if delta(before):
            raise AssertionError(f"serve: a replay ticked {delta(before)}")
        le = eager_step(accl_e, be, toks, pos)
        if not same_bits(lf, le) or not all(
                same_bits(a, b) for a, b in zip(states(bf), states(be))):
            raise AssertionError(f"serve step {s}: fused != eager")
        if not torch.isfinite(lf).all():
            raise AssertionError(f"serve step {s}: non-finite logits")
        if s < SERVE_CPU_STEPS:
            card.append((lf, [t.cpu() for t in states(bf)]))
    del be, accl_e

    # (2) the card against the port's CPU run of the first steps
    cpu = ACCL(world=W, torch_device="cpu")
    cpu.cclo.compiler.use_ring_kernel = True  # the ring kernel's order
    params_cpu = {"embed": host["embed"], "unembed": params["unembed"].cpu(),
                  "layers": [{k: v.cpu() for k, v in lyr.items()}
                             for lyr in params["layers"]]}
    cprog, cbf = trf.make_decode_step_program(cpu, cfg, params_cpu, batch=B,
                                              max_len=T)
    cpu_err = 0.0
    for s, ((toks, pos), (lf, st)) in enumerate(zip(steps, card)):
        ref = fused_step(cprog, cbf, toks, pos)
        for got, want in ((lf, ref), *zip(st, states(cbf))):
            err = max_abs_err(got, want)
            bound = SERVE_TOL * float(want.abs().max())
            if not err <= bound:
                raise AssertionError(f"serve step {s}: card against CPU "
                                     f"{err} > {bound}")
            cpu_err = max(cpu_err, err / float(want.abs().max()))
    del cprog, cbf, cpu, params_cpu, card

    # (3) decode against the full-context forward on the card
    seqs = torch.from_numpy(rng.integers(1, V, (B, SERVE_SEQ))).cuda()
    with torch.no_grad():
        full = trf.forward_local(params, seqs, cfg)
    oracle_err = 0.0
    for t in range(SERVE_SEQ):
        lf = fused_step(prog, bf, seqs[:, t].cpu(), [t] * B).cuda()
        err = max_abs_err(lf, full[:, t])
        bound = SERVE_TOL * float(full[:, t].abs().max())
        if not err <= bound:
            raise AssertionError(f"serve position {t}: decode against "
                                 f"forward_local {err} > {bound}")
        oracle_err = max(oracle_err, err / float(full[:, t].abs().max()))
    del full
    add(delta(start))

    # (4) batched against sequential through one server's program
    requests = serve_requests(V)
    before = counts()
    srv = serve.DecodeServer(ACCL(world=W), cfg, params, batch=B,
                             max_len=T, registry=MetricsRegistry())
    batched = serve_drive(srv, requests)
    steps_batched = srv.n_steps
    for i, (toks, rows, slot) in batched.items():
        _, prompt, new = requests[i]
        s_toks, s_rows = serve_alone(srv, host, slot, prompt, new)
        if toks != s_toks or not same_bits(rows, s_rows):
            raise AssertionError(
                f"serve request {i} (slot {slot}): batched != sequential, "
                f"tokens {toks} against {s_toks}, max |diff| "
                f"{max_abs_err(rows, s_rows) if rows.shape == s_rows.shape else rows.shape}")
    add(delta(before))
    emit({"phase": "serve", "world": W, "batch": B, "max_len": T,
          "config": {**SERVE_CFG, "dtype": "float32"},
          "tf32": False, "compile_s": compile_s,
          "launches_at_compile": compile_launches,
          "fused_eq_eager_bitwise_steps": SERVE_STEPS,
          "state_bytes_per_layer": bf.state[0].device.numel() * 4,
          "cpu_steps": SERVE_CPU_STEPS, "card_vs_cpu_rel_err": cpu_err,
          "decode_vs_forward_local_positions": SERVE_SEQ,
          "decode_vs_forward_local_rel_err": oracle_err,
          "tolerance": SERVE_TOL,
          "requests": [{"join": j, "prompt": len(p), "new": n}
                       for j, p, n in requests],
          "batched_steps": steps_batched,
          "tokens": sum(len(t) for t, _, _ in batched.values()),
          "slots": [batched[i][2] for i in sorted(batched)],
          "batched_eq_sequential_bitwise": True})
    del srv, prog, bf

    # (5), (6) each register set: plans, launches, profile, times
    for regs in ("default", "autotune"):
        def facade():
            accl = ACCL(world=W)
            if regs == "autotune":
                accl.autotune()
            return accl

        one = facade()
        a, r = one.create_buffer(B * cfg.d_model), one.create_buffer(
            B * cfg.d_model)
        before = counts()
        req = one.allreduce(a, r, B * cfg.d_model, ReduceFunction.SUM,
                            from_device=True, to_device=True)
        torch.cuda.synchronize()
        per_allreduce = delta(before)
        plan = req.plan.algorithm.name + (
            f" {req.plan.synth_key}" if req.plan.synth_key else "")
        want = {k: 2 * cfg.n_layers * v for k, v in per_allreduce.items()}
        want["combine"] = want.get("combine", 0) + 2 * cfg.n_layers
        del one, a, r

        accl_f, accl_e = facade(), facade()
        before = counts()
        prog, bf = trf.make_decode_step_program(accl_f, cfg, params,
                                                batch=B, max_len=T)
        at_compile = delta(before)
        add(at_compile)
        be = eager_twin(accl_e)
        plans = sorted({p.algorithm.name for p, o in zip(
            prog.plans, prog._prepared.desc.steps)
            if o.scenario.name == "allreduce"})
        toks, pos = steps[0]
        fused_step(prog, bf, toks, pos)
        before = counts()
        eager_step(accl_e, be, toks, pos)
        eager_launches = delta(before)
        add(eager_launches)
        if (eager_launches != want
                or at_compile != {k: 2 * v for k, v in want.items()}):
            raise AssertionError(
                f"serve {regs}: eager step launched {eager_launches}, "
                f"compile {at_compile}; the plan ({plan}) gives {want}")
        before = counts()
        prof = kernel_profile(lambda: fused_step(prog, bf, toks, pos))
        if delta(before):
            raise AssertionError(f"serve {regs}: a replay ticked "
                                 f"{delta(before)}")
        hand = {}
        for name, n in prof["kernels"].items():
            for parts, k in SERVE_PROFILE_NAMES.items():
                if all(part in name for part in parts):
                    hand[k] = hand.get(k, 0) + n
                    if prof["graph_kernels"][name] != n:
                        raise AssertionError(
                            f"serve {regs}: {name} launched outside the "
                            "graph at replay")
        expect = {k: want[k] for k in set(SERVE_PROFILE_NAMES.values())
                  if want.get(k)}
        if prof["graph_launches"] != 1 or hand != expect:
            raise AssertionError(f"serve {regs}: replay ran {hand} in "
                                 f"{prof['graph_launches']} graph launches, "
                                 f"the plan gives {want}; kernels "
                                 f"{sorted(prof['kernels'])}")

        # the bytes staged per step: every host-to-device buffer sync
        staged = []
        sync = GPUBuffer.sync_to_device

        def counted(buf):
            staged.append(buf.host.numel() * buf.host.element_size())
            return sync(buf)

        GPUBuffer.sync_to_device = counted
        try:
            fused_step(prog, bf, toks, pos)
        finally:
            GPUBuffer.sync_to_device = sync
        if staged != [W * bf.dims.n_out * 4]:
            raise AssertionError(f"serve {regs}: staged {staged} bytes a "
                                 "step, not xp alone")

        def timed_steps(step, accl_or_prog, buffers):
            i = itertools.count()

            def cycled():  # each run the next of the 16 steps' inputs
                toks, pos = steps[next(i) % SERVE_STEPS]
                step(accl_or_prog, buffers, toks, pos)

            return timed_runs(cycled, SERVE_REPS, warmup=3)

        fused = timed_steps(fused_step, prog, bf)
        # the fused step's parts: stage xp in, copy the bound buffers into
        # the graph's inputs, replay, clone the results out, read logits
        replay = []
        for _ in range(20):
            req = prog.run(from_device=True, to_device=True)
            replay.append(req.get_duration_ns() * 1e-6)
        binding = prog.graph.bind([prog._prepared.bufs[a].device
                                   for a in prog._prepared.seq.buffer_addrs])
        prog.graph.allocate(binding)
        parts = {"stage_xp_ms": median_ms(bf.xp.sync_to_device),
                 "copy_in_ms": device_ms(lambda: prog.graph.load(binding),
                                         count=20),
                 "replay_ms": statistics.median(replay),
                 "results_out_ms": device_ms(
                     lambda: prog.graph.results(binding), count=20),
                 "read_logits_ms": median_ms(bf.logits.sync_from_device)}
        top = sorted(prof["kernel_ms"].items(), key=lambda kv: -kv[1])[:12]
        eager = timed_steps(eager_step, accl_e, be)
        reg = MetricsRegistry()
        srv = serve.DecodeServer(facade(), cfg, params, batch=B, max_len=T,
                                 registry=reg)
        served = serve_drive(srv, requests)
        hist = reg.snapshot()["histograms"]["accl_serve_step_seconds"][0]
        tokens_total = reg.snapshot()["counters"][
            "accl_serve_tokens_total"][0]["value"]
        # the timed steps cycle through the 16 steps' positions
        bounds = [serve_bound(cfg, W, B, pos) for _, pos in steps]
        bound = {"bound_ms": statistics.mean(b["bound_ms"] for b in bounds),
                 "bound_by": bounds[0]["bound_by"],
                 "bytes": statistics.mean(b["bytes"] for b in bounds),
                 "flops": statistics.mean(b["flops"] for b in bounds)}
        emit({"phase": "serve_timing", "registers": regs,
              "allreduce_plan": plan, "step_plans": plans,
              "launches_per_allreduce": per_allreduce,
              "launches_eager_step": eager_launches,
              "launches_at_compile": at_compile,
              "launches_per_replay": 0,
              "replay_hand_kernels": hand,
              "graph_launches_per_step": prof["graph_launches"],
              "device_kernels_per_step": sum(prof["kernels"].values()),
              "graph_kernels_per_step": sum(prof["graph_kernels"].values()),
              "memcpy_per_step": prof["memcpy"],
              "device_busy_ms": prof["busy_ms"],
              "fused_step_ms": fused, "fused_step_parts": parts,
              "replay_top_kernels": [
                  {"name": name[:140], "ms": ms,
                   "count": prof["kernels"][name]} for name, ms in top],
              "eager_step_ms": eager,
              "tokens_per_s": B / fused["host_ms_p50"] * 1e3,
              "server_steps": srv.n_steps, "server_tokens": tokens_total,
              "step_seconds_p50": hist[quantile_key(0.5)],
              "step_seconds_p99": hist[quantile_key(0.99)],
              "server_tokens_per_s": tokens_total / hist["sum"],
              "same_tokens_as_default": all(
                  served[i][0] == batched[i][0] for i in batched),
              "staged_bytes_per_step": sum(staged),
              "graph_copy_in_bytes": prog.graph.load_bytes,
              "graph_in_place_steps": in_place_steps(prog.graph),
              "bound": bound})
        del srv, prog, bf, be, accl_f, accl_e
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    idle = [k for k in ("ring_allreduce_bidir", "combine") if path[k] == 0]
    if idle:
        raise AssertionError(f"the serve path launched no {idle}")
    return path


# the train step at the flagship widths in fp32: W = 4 data-parallel
# virtual ranks, each with 2 sequences of 1024 tokens (bench.py's flagship
# lane's global batch of 8 x 1024)
TRAIN_WORLD, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 1024
TRAIN_LR = 1e-3
TRAIN_REPS = 10  # timed steps, fused and eager
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 1, 64  # the card against the port's CPU run
# |update - oracle| <= TRAIN_TOL * max|update| + 1e-7 (card against the
# autograd oracle and against the CPU run; new parameters one ulp more)
TRAIN_TOL = 1e-4


def train_flops(cfg, tokens: int, seq: int) -> float:
    """One step's matrix operations: 6 per token (forward and backward)
    for each parameter a product reads, which leaves out the embedding
    (a gather) and keeps the unembedding, plus the attention term
    12 * layers * tokens * seq * d_model. bench.py's flagship formula
    counts the embedding too."""
    from accl_tpu_torch.models import transformer as trf

    matmul_params = trf.train_param_count(cfg) - cfg.vocab * cfg.d_model
    return (6.0 * matmul_params * tokens
            + 12.0 * cfg.n_layers * tokens * seq * cfg.d_model)


def ring_launches(plan, n: int) -> int:
    """Kernel 1's launches for one allreduce of n fp32 elements under
    `plan`: each stripe (the whole row when unstriped) in 4 MiB
    segments."""
    seg = SEG_BYTES // 4
    step = plan.seg_count if plan.stripes > 1 else n
    return sum(-(-min(step, n - lo) // seg) for lo in range(0, n, step))


def timed_runs(fn, reps: int, warmup: int = 1) -> dict:
    """p50, p99, min and max of `reps` runs of fn (after `warmup`
    untimed runs), each timed by CUDA events around it (device ms) and
    by the host clock up to its last event's completion (host ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev, host = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    out = {}
    for clock, t in (("events_ms", ev), ("host_ms", host)):
        q = statistics.quantiles(t, n=100, method="inclusive")
        out.update({f"{clock}_p50": q[49], f"{clock}_p99": q[98],
                    f"{clock}_min": min(t), f"{clock}_max": max(t)})
    return out


def train_oracle(flat, tokens, targets, cfg, lr: float, world: int):
    """The update a step should make, with no facade: for each rank,
    torch.autograd.grad of local_train_loss at the flat parameters,
    scaled by -lr/world; summed over ranks with torch.sum."""
    import torch

    from accl_tpu_torch.models import transformer as trf

    grads = []
    for r in range(world):
        leaves = [p.detach().requires_grad_()
                  for p in trf._split_flat(flat, cfg)]
        with torch.enable_grad():
            loss = trf.local_train_loss(trf._tree_from_leaves(leaves, cfg),
                                        tokens[r], targets[r], cfg)
            g = torch.autograd.grad(loss, leaves)
        grads.append(torch.cat([x.reshape(-1) for x in g]) * (-lr / world))
    return torch.sum(torch.stack(grads), 0)


def train_loss(flat, tokens, targets, cfg, world: int) -> float:
    """The step's batch loss: the mean over ranks of local_train_loss."""
    import torch

    from accl_tpu_torch.models import transformer as trf

    tree = trf.unflatten_train_params(flat, cfg)
    with torch.no_grad():
        return sum(float(trf.local_train_loss(tree, tokens[r], targets[r],
                                              cfg))
                   for r in range(world)) / world


def check_update(got, want, what: str) -> float:
    """|got - want| <= TRAIN_TOL * max|want| + 1e-7 on every element;
    returns the error relative to max|want|."""
    scale = float(want.abs().max())
    err = max_abs_err(got, want)
    if not err <= TRAIN_TOL * scale + 1e-7:
        raise AssertionError(f"train: {what} {err} > "
                             f"{TRAIN_TOL * scale + 1e-7}")
    return err / scale


def train_phase(ring, qk, L):
    """The training path (accl_tpu_torch/models/transformer.py) on the
    card: the data-parallel train step at the flagship transformer's
    widths in fp32 (155 205 632 parameters), W = 4 virtual ranks with
    tokens (4, 2, 1024) from a seed, targets the tokens rolled by one, lr
    1e-3, TF32 off. Gates, each failing the run: (1) the fused step (one
    CUDA-graph replay: forward, backward, allreduce and combine) bitwise
    with run_train_step_eager, with the default registers and with
    OVERLAP_MIN_COUNT open (the plan must stripe); (2) the update within
    TRAIN_TOL of a plain oracle (train_oracle); (3) the card's step
    within TRAIN_TOL of the port's CPU run of the same step at tokens
    (4, 1, 64); (4) the batch's loss lower after the step; (5) kernel 1
    launched ring_launches(plan) times a step and kernel 7 once, twice
    that at compile (warm-up and capture), none at a replay. Numbers:
    the fused and eager step's p50/p99 (CUDA events, host clock),
    tokens/s, the FLOP bound and the step's share of it, the allreduce's
    and the combine's device ms inside one profiled replay, peak memory.
    Returns each kernel's launches over the checked runs."""
    import numpy as np
    import torch

    from accl_tpu_torch import ACCL
    from accl_tpu_torch.constants import TuningParams
    from accl_tpu_torch.models import transformer as trf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("train: TF32 is on; fp32 products must be fp32")
    emit({"phase": "train_setup",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()})
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    path = dict.fromkeys(kernels, 0)

    def add(launched):
        for k, v in launched.items():
            path[k] += v

    mem = {}

    def mark(tag):
        mem[tag] = torch.cuda.memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    mark("entry")
    cfg = trf.TransformerConfig(**SERVE_CFG)
    W, B, T, V = TRAIN_WORLD, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab
    n = trf.train_param_count(cfg)
    flat = trf.flatten_train_params(trf.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1313), "cuda"))
    rng = np.random.default_rng(1313)
    tokens = rng.integers(0, V, (W, B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=2)
    tok, tgt = (torch.from_numpy(a).cuda().long() for a in (tokens, targets))

    def facade(overlap: bool):
        accl = ACCL(world=W)
        if overlap:
            tp = TuningParams.default()
            tp.overlap_min_count = 1
            accl.configure_tuning_parameters(tp)
        bufs = trf.create_train_step_buffers(accl, cfg)
        bufs[0].device = flat.expand(W, n).contiguous()
        return accl, bufs

    def want_launches(plan):
        return {"ring_allreduce_bidir": ring_launches(plan, n), "combine": 1}

    # (3) first, the card's side of the CPU comparison: the eager step at
    # tokens (4, 1, 64) on a facade of its own
    small_t = tokens[:, :TRAIN_CPU_BATCH, :TRAIN_CPU_SEQ]
    small_g = targets[:, :TRAIN_CPU_BATCH, :TRAIN_CPU_SEQ]
    accl, bufs = facade(False)
    trf._register_train_consumers(accl, cfg, small_t, small_g, TRAIN_LR)
    before = counts()
    trf.run_train_step_eager(accl, cfg, bufs)
    torch.cuda.synchronize()
    add(delta(before))
    card_upd, card_new = bufs[2].device.cpu(), bufs[3].device.cpu()
    del accl, bufs
    mark("start")

    result = {"phase": "train", "gpu": card_name(), "world": W,
              "tokens": [W, B, T],
              "lr": TRAIN_LR, "params": n,
              "config": {**SERVE_CFG, "dtype": "float32"}}
    for regs in ("default", "overlap"):
        accl, bufs = facade(regs == "overlap")
        mark(f"{regs}_facade")
        before = counts()
        t0 = time.perf_counter()
        prog, _ = trf.make_train_step_program(accl, cfg, tokens, targets,
                                              lr=TRAIN_LR, buffers=bufs)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        mark(f"{regs}_compiled")
        at_compile = delta(before)
        add(at_compile)
        plan = prog.plans[1]
        want = want_launches(plan)
        if regs == "overlap" and plan.stripes < 2:
            raise AssertionError(f"train: the overlap register gave {plan}")
        before = counts()
        prog.run(from_device=True, to_device=True)
        if delta(before):
            raise AssertionError(f"train {regs}: a replay ticked "
                                 f"{delta(before)}")
        fused_upd, fused_new = bufs[2].device.clone(), bufs[3].device.clone()
        before = counts()
        trf.run_train_step_eager(accl, cfg, bufs)
        torch.cuda.synchronize()
        eager_launches = delta(before)
        add(eager_launches)
        if (eager_launches != want
                or at_compile != {k: 2 * v for k, v in want.items()}):
            raise AssertionError(
                f"train {regs}: eager step launched {eager_launches}, "
                f"compile {at_compile}; the plan ({plan.stripes} stripes) "
                f"gives {want}")
        if not (same_bits(bufs[3].device, fused_new)
                and same_bits(bufs[2].device, fused_upd)):
            raise AssertionError(f"train {regs}: fused != eager")
        if not torch.isfinite(fused_new).all():
            raise AssertionError(f"train {regs}: non-finite parameters")
        row = {"registers": regs, "stripes": plan.stripes,
               "allreduce_plan": plan.algorithm.name,
               "compile_s": compile_s, "warmup_s": prog.graph.warmup_s,
               "capture_s": prog.graph.capture_s,
               "launches_at_compile": at_compile,
               "launches_eager_step": eager_launches,
               "launches_per_replay": 0, "fused_eq_eager_bitwise": True}
        mark(f"{regs}_fused_and_eager")
        if regs == "default":
            oracle = train_oracle(flat, tok, tgt, cfg, TRAIN_LR, W)
            row["update_vs_oracle_rel_err"] = max(
                check_update(fused_upd[r], oracle, f"rank {r} update "
                             "against the oracle") for r in range(W))
            del oracle
            loss0 = train_loss(flat, tok, tgt, cfg, W)
            loss1 = train_loss(fused_new[0], tok, tgt, cfg, W)
            if not loss1 < loss0:
                raise AssertionError(f"train: loss {loss0} -> {loss1}")
            row.update(loss_before=loss0, loss_after=loss1)
            default_new = fused_new
        else:
            row["striped_vs_unstriped_max_abs"] = max_abs_err(fused_new,
                                                              default_new)
            del default_new
        del fused_upd, fused_new

        def fused_step():
            prog.run(from_device=True, to_device=True)

        def eager_step():
            trf.run_train_step_eager(accl, cfg, bufs)

        reps = TRAIN_REPS if regs == "default" else TRAIN_REPS // 2
        before = counts()
        fused = timed_runs(fused_step, reps)
        replay = []
        for _ in range(5):
            replay.append(prog.run(from_device=True, to_device=True)
                          .get_duration_ns() * 1e-6)
        mark(f"{regs}_timed_fused")
        if delta(before):
            raise AssertionError(f"train {regs}: a replay ticked "
                                 f"{delta(before)}")
        eager = timed_runs(eager_step, reps)
        mark(f"{regs}_timed_eager")
        flops = train_flops(cfg, W * B * T, T)
        bound_ms = flops / FP32_FLOPS_PER_S * 1e3
        row.update(fused_step_ms=fused, eager_step_ms=eager,
                   replay_ms_p50=statistics.median(replay),
                   tokens_per_s=W * B * T / fused["host_ms_p50"] * 1e3,
                   flops=flops, bound_ms=bound_ms, bound_by="operations",
                   bound_share=bound_ms / fused["events_ms_p50"],
                   graph_copy_in_bytes=prog.graph.load_bytes,
                   graph_in_place_steps=in_place_steps(prog.graph))
        if regs == "default":
            prof = kernel_profile(fused_step)
            mark("default_profiled")
            parts = {}
            for name, ms in prof["kernel_ms"].items():
                for keys, k in SERVE_PROFILE_NAMES.items():
                    if all(part in name for part in keys):
                        parts[k] = parts.get(k, 0.0) + ms
                        if prof["graph_kernels"][name] != \
                                prof["kernels"][name]:
                            raise AssertionError(f"train: {name} launched "
                                                 "outside the graph")
            hand = {k: sum(c for name, c in prof["kernels"].items()
                           if all(p in name for p in keys))
                    for keys, k in SERVE_PROFILE_NAMES.items()}
            if prof["graph_launches"] != 1 or hand != want:
                raise AssertionError(f"train: a replay ran {hand} in "
                                     f"{prof['graph_launches']} graph "
                                     f"launches; the plan gives {want}")
            top = sorted(prof["kernel_ms"].items(), key=lambda kv: -kv[1])
            row.update(
                allreduce_device_ms=parts["ring_allreduce_bidir"],
                combine_device_ms=parts["combine"],
                device_busy_ms=prof["busy_ms"],
                device_kernels_per_step=sum(prof["kernels"].values()),
                memcpy_per_step=prof["memcpy"],
                replay_top_kernels=[
                    {"name": name[:140], "ms": ms,
                     "count": prof["kernels"][name]}
                    for name, ms in top[:12]],
                max_memory_allocated=torch.cuda.max_memory_allocated())
        row["memory_allocated"] = dict(mem)
        emit({**result, **row})
        del prog, bufs, accl
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    result["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    cpu = ACCL(world=W, torch_device="cpu")
    cpu.cclo.compiler.use_ring_kernel = True  # the ring kernel's fold order
    cbufs = trf.create_train_step_buffers(cpu, cfg)
    flat_cpu = flat.cpu()
    cbufs[0].device = flat_cpu.expand(W, n).contiguous()
    trf._register_train_consumers(cpu, cfg, small_t, small_g, TRAIN_LR)
    trf.run_train_step_eager(cpu, cfg, cbufs)
    cpu_err = check_update(card_upd, cbufs[2].device, "card against CPU")
    ulp = 2.0 ** -23 * cbufs[3].device.abs()
    new_err = (card_new - cbufs[3].device).abs()
    if not bool((new_err <= TRAIN_TOL * float(cbufs[2].device.abs().max())
                 + 1e-7 + ulp).all()):
        raise AssertionError("train: card's new parameters against CPU")
    emit({"phase": "train_cpu", "gpu": result["gpu"],
          "tokens": [W, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ],
          "card_vs_cpu_update_rel_err": cpu_err,
          "card_vs_cpu_new_max_abs": float(new_err.max()),
          "tolerance": TRAIN_TOL, "cpu_s": time.perf_counter() - t0,
          "max_memory_allocated": result["max_memory_allocated"]})
    del cpu, cbufs, flat_cpu, card_upd, card_new, flat
    torch.cuda.empty_cache()
    idle = [k for k in ("ring_allreduce_bidir", "combine") if path[k] == 0]
    if idle:
        raise AssertionError(f"the train path launched no {idle}")
    return path


# the MoE layer step at the flagship FFN widths: W = 4 ranks of one expert
# each, top-2 routing, 2048 tokens a rank; C = 1280, so a peer's chunk is
# 1280 x 1024 fp32 (5.24 MB) and a rank's dispatch 21 MB
MOE_CFG = dict(d_model=1024, d_ff=4096, n_experts=4, experts_per_rank=1,
               top_k=2, capacity_factor=1.25)
MOE_WORLD, MOE_TOKENS = 4, 2048
MOE_WIRE_CAPACITY = 640  # half of C: the alltoallv's dropping case
MOE_REPS = 20
MOE_TOL = 1e-4  # |delta| <= MOE_TOL * max|ref| (card against the oracle)
MOE_INT8_BOUND = 0.05  # the reference's: 0 < err < 0.05 * max|ref|


def int8_alltoall_launches(steps, plans, world: int) -> dict:
    """Kernels 5 and 6's launches for one run of a recorded batch, from
    its descriptors and the plans they resolved to: per alltoall leg on
    the int8 wire, one quantize and one dequantize pass when the plan is
    the dense alltoall and a slot is a whole number of 256-element
    blocks (the whole buffer encoded and decoded once), else one of each
    a hop (world - 1)."""
    from accl_tpu_torch import DataType, Operation
    from accl_tpu_torch.constants import QUANT_BLOCK_ELEMS
    from accl_tpu_torch.sequencer.plan import Algorithm

    n = 0
    for opts, plan in zip(steps, plans):
        if (opts.scenario != Operation.alltoall
                or opts.compress_dtype != DataType.int8):
            continue
        aligned = (plan.algorithm == Algorithm.FLAT_ALLTOALL
                   and opts.count % QUANT_BLOCK_ELEMS == 0)
        n += 1 if aligned else world - 1
    return {"quantize": n, "dequantize": n} if n else {}


def moe_oracle(x, params, cfg, capacity: int):
    """The stacked FFN contributions with no facade and no dispatch
    buffer: per rank, the router's softmax, the top k by a stable sort
    (lower expert first on ties, as lax.top_k), each expert's first
    `capacity` pseudo-tokens in token order through gelu(x @ w_up) @
    w_down, weighted by the gate and added into the token's row."""
    import torch
    import torch.nn.functional as F

    W, T, D = x.shape
    k, E = cfg.top_k, cfg.n_experts
    out = torch.zeros_like(x)
    for r in range(W):
        probs = torch.softmax((x[r] @ params["router"]).float(), -1)
        topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        topv, topi = topv[:, :k], topi[:, :k]
        gates = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
        assign, gate = topi.reshape(-1), gates.reshape(-1)
        for e in range(E):
            idx = (assign == e).nonzero()[:capacity, 0]
            tok = idx // k
            h = F.gelu(x[r, tok] @ params["w_up"][e], approximate="tanh")
            out[r].index_add_(0, tok, (h @ params["w_down"][e])
                              * gate[idx, None])
    return out


def moe_phase(ring, qk, L):
    """The MoE layer step's facade form (accl_tpu_torch/models/moe.py) on
    the card at the flagship FFN widths: MoEConfig(d_model=1024,
    d_ff=4096, n_experts=4, experts_per_rank=1, top_k=2,
    capacity_factor=1.25), W = 4, 2048 tokens a rank from a seed, TF32
    off. Gates, each failing the run: (1) fused (one recorded sequence),
    eager and eager with make_expert_program bitwise on the exact wire;
    (2) the FFN contributions within MOE_TOL of a plain per-rank oracle
    (moe_oracle); (3) the int8 wire within the reference's bound, 0 <
    err < 0.05 * max|ref|, its explicit, eager and register-selected
    forms bitwise; (4) wire_capacity 640 drops exactly the pseudo-tokens the
    oracle at capacity 640 drops (zero rows where it gives zero, within
    MOE_TOL elsewhere); (5) an eager int8 layer step launches kernels 5
    and 6 as its plan gives (int8_alltoall_launches), the fused one twice
    that at compile (warm-up and capture) and none at a replay, and the
    exact wire none. Numbers: the layer step's
    device ms (events) and host ms, fused against eager, exact against
    int8, beside its bound. Returns each kernel's launches over the
    checked runs."""
    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, DataType
    from accl_tpu_torch.constants import TuningParams
    from accl_tpu_torch.models import moe

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("moe: TF32 is on; fp32 products must be fp32")
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    start = counts()
    cfg = moe.MoEConfig(**MOE_CFG)
    W, T, D = MOE_WORLD, MOE_TOKENS, cfg.d_model
    params = moe.init_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(1414), "cuda")
    rng = np.random.default_rng(1414)
    x = torch.from_numpy(rng.standard_normal((W, T, D)).astype(
        np.float32)).cuda()
    C = moe._capacity(cfg, T * cfg.top_k)
    count = cfg.experts_per_rank * C * D
    accl = ACCL(world=W)
    bufs = moe.create_moe_layer_buffers(accl, cfg, C)

    def ffn(**kw):
        before = counts()
        y = moe.moe_ffn_via_sequence(accl, x, params, cfg, buffers=bufs,
                                     **kw)
        torch.cuda.synchronize()
        return y, delta(before)

    # (1) exact wire: fused, eager, descriptor-per-stage
    fused, l_fused = ffn()
    eager, l_eager = ffn(fused=False)
    dispatch, safe_e, safe_c, keep, gate = moe._route(x, params, cfg, C)
    disp, mid, out = bufs
    disp.device = dispatch.reshape(W, -1)
    expert = moe.make_expert_program(accl, cfg, C, params["w_up"],
                                     params["w_down"])
    moe.run_moe_layer(accl, disp, mid, out, count, fused=False,
                      expert_fn=expert, from_device=True, to_device=True)
    staged = moe._combine_tokens(out.device.reshape(W, cfg.n_experts, C, D),
                                 safe_e, safe_c, keep, gate, T, cfg.top_k,
                                 D, torch.float32)
    if not (same_bits(fused, eager) and same_bits(fused, staged)):
        raise AssertionError("moe: fused, eager and staged differ")
    if l_fused or l_eager:
        raise AssertionError(f"moe: the exact wire launched {l_fused} "
                             f"fused, {l_eager} eager")
    # (2) against the oracle
    ref = moe_oracle(x, params, cfg, C)
    scale = float(ref.abs().max())
    oracle_err = max_abs_err(fused, ref)
    if not (torch.isfinite(fused).all() and oracle_err <= MOE_TOL * scale):
        raise AssertionError(f"moe: against the oracle {oracle_err} > "
                             f"{MOE_TOL * scale}")
    # (3) the int8 wire, explicit and through the register; (5) its
    # launches against the layer step's plan
    int8, l_int8 = ffn(compress_dtype=DataType.int8)
    int8_eager, l_int8_eager = ffn(compress_dtype=DataType.int8,
                                   fused=False)
    accl.configure_tuning_parameters(
        TuningParams(alltoall_compress_min_count=1))
    via_register, l_register = ffn()
    accl.configure_tuning_parameters(TuningParams())
    # the fused int8 call compiled this batch: recording it again reads
    # its descriptors and plans from the cache, launching nothing
    before = counts()
    prog8 = moe.make_moe_layer_program(accl, disp, mid, out, count,
                                       compress_dtype=DataType.int8)
    if delta(before):
        raise AssertionError(f"moe: re-recording the int8 step launched "
                             f"{delta(before)}")
    want = int8_alltoall_launches(prog8._prepared.desc.steps, prog8.plans, W)
    del prog8
    int8_err = max_abs_err(int8, fused)
    if not 0 < int8_err < MOE_INT8_BOUND * float(fused.abs().max()):
        raise AssertionError(f"moe: int8 error {int8_err} against max "
                             f"{float(fused.abs().max())}")
    if not (same_bits(via_register, int8) and same_bits(int8_eager, int8)):
        raise AssertionError("moe: int8 register, explicit and eager forms "
                             "differ")
    # the register writes the explicit form's descriptors, so its batch
    # replays the program the explicit call compiled: no launch
    if (set(want) != {"quantize", "dequantize"} or l_int8_eager != want
            or l_int8 != {k: 2 * v for k, v in want.items()}
            or l_register):
        raise AssertionError(f"moe: int8 launches {l_int8} fused, "
                             f"{l_int8_eager} eager, {l_register} register; "
                             f"the plan gives {want} a step")
    # (4) capacity on the wire
    trimmed, _ = ffn(wire_capacity=MOE_WIRE_CAPACITY)
    ref_cap = moe_oracle(x, params, cfg, MOE_WIRE_CAPACITY)
    zero = (ref_cap == 0).all(-1)
    cap_err = max_abs_err(trimmed, ref_cap)
    if not (bool((trimmed[zero] == 0).all()) and bool(zero.any())
            and cap_err <= MOE_TOL * float(ref_cap.abs().max())):
        raise AssertionError(f"moe: wire capacity {MOE_WIRE_CAPACITY}: "
                             f"{cap_err}, dropped rows not zero")
    dropped_rows = int(zero.sum())
    path = delta(start)
    gpu = card_name()
    emit({"phase": "moe", "gpu": gpu, "world": W, "tokens_per_rank": T,
          "capacity": C,
          "config": MOE_CFG, "chunk_bytes": count * 4,
          "dispatch_bytes_per_rank": W * count * 4,
          "fused_eq_eager_eq_staged_bitwise": True,
          "oracle_rel_err": oracle_err / scale, "tolerance": MOE_TOL,
          "int8_rel_err": int8_err / float(fused.abs().max()),
          "int8_register_eq_explicit_bitwise": True,
          "wire_capacity": MOE_WIRE_CAPACITY,
          "wire_capacity_dropped_token_rows": dropped_rows,
          "wire_capacity_rel_err": cap_err / float(ref_cap.abs().max()),
          "launches_int8_plan": want,
          "launches_int8_layer_step": l_int8_eager,
          "launches_int8_at_compile": l_int8})
    del ref, ref_cap, trimmed, staged, eager, int8, int8_eager, via_register

    # the layer step alone: routed dispatch in place, programs compiled
    timing = {}
    disp.device = dispatch.reshape(W, -1)
    for wire in ("exact", "int8"):
        cd = DataType.int8 if wire == "int8" else None
        prog = moe.make_moe_layer_program(accl, disp, mid, out, count,
                                          compress_dtype=cd)
        before = counts()
        timing[wire] = {
            "fused": timed_runs(lambda: prog.run(from_device=True,
                                                 to_device=True), MOE_REPS),
            "eager": timed_runs(lambda: moe.run_moe_layer(
                accl, disp, mid, out, count, fused=False, compress_dtype=cd,
                from_device=True, to_device=True), MOE_REPS)}
        launched = delta(before)
        if wire == "exact" and launched:
            raise AssertionError(f"moe: exact layer steps launched "
                                 f"{launched}")
    rows = W * W * cfg.experts_per_rank * C
    flops = rows * 2 * 2 * D * cfg.d_ff
    nbytes = 4 * (2 * W * W * count + 2 * cfg.n_experts * D * cfg.d_ff)
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    emit({"phase": "moe_timing", "gpu": gpu, "layer_step_ms": timing,
          "bound_ms": max(t_ops, t_bytes) * 1e3,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "flops": flops, "bytes": nbytes})
    del accl, bufs, params, x, dispatch, fused
    torch.cuda.empty_cache()
    idle = [k for k in ("quantize", "dequantize") if not path.get(k)]
    if idle:
        raise AssertionError(f"the moe path launched no {idle}")
    return {name: path.get(name, 0) for name in kernels}


# the mesh forms (parallel/, models/ over a dp x sp x tp (x pp) mesh of
# virtual ranks) at the flagship widths: 8 sequences of 1024 tokens
MESH_AXES = {"dp": 2, "sp": 2, "tp": 2}
MESH_PP_AXES = {"dp": 2, "sp": 1, "tp": 2, "pp": 2}
MESH_DECODE_AXES = {"dp": 2, "sp": 1, "tp": 2}
MESH_BATCH, MESH_SEQ = 8, 1024
MESH_MICROBATCHES = 4  # the pipelined step's, 4 layers a stage
MESH_STRIPES = 4  # the striped gradient sync's
MESH_DECODE_LEN, MESH_DECODE_STEPS = 1024, 32  # cache length, positions
MESH_REPS = 5  # timed runs of each form
# Ulysses at the flagship attention widths: B 4, T 1024 over sp 4
MESH_ULYSSES = dict(batch=4, seq=1024, heads=16, head_dim=64, sp=4)
MESH_ULYSSES_STRIPES = 4  # head groups of 4: each still divides over sp
MESH_MOE_AXES = {"dp": 2, "ep": 2}
MESH_MOE_CFG = dict(MOE_CFG, n_experts=4, experts_per_rank=2, vocab=32768,
                    seq=1024)
MESH_TIMES: dict = {}  # the leaf train step's timed runs, for entry_phase


def ring_folds(n: int) -> int:
    """Kernel 7's launches in one ring allreduce over an axis of n ranks:
    n - 1 folds (the reduce-scatter's), each one launch over every rank's
    row; one segment, as the mesh forms' seg_count is the whole row."""
    return n - 1


def mesh_step_folds(cfg, axes, *, remat=False, stripes=None,
                    n_microbatches=None) -> int:
    """Kernel 7's launches in one make_train_step step on a mesh of
    `axes`, from the step's schedule: each block's two tp allreduces in
    the forward and again in the backward (their transpose; a pipelined
    stage runs its layers at every one of its M + P - 1 steps); with
    remat, the attention's allreduce once more in the recompute
    (torch.utils.checkpoint stops at the block's last saved activation,
    so the MLP's allreduce, on which none depends, is not run again, as
    in the reference's rematerialized step); the pipeline bcast's
    transpose (one fold a tree round); the gradient sync (per leaf, or
    per stripe after the tp treatment) and the pp embedding sum; the
    loss's dp and sp means."""
    dp, sp, tp, pp = (axes.get(a, 1) for a in ("dp", "sp", "tp", "pp"))
    L = cfg.n_layers
    if pp > 1:
        block_runs = ((n_microbatches or pp) + pp - 1) * (L // pp)
        leaves, tp_replicated = 2 + 7, 2 + 2  # stacked layer leaves
    else:
        block_runs = L
        leaves, tp_replicated = 2 + 7 * L, 2 + 2 * L
    n = block_runs * ring_folds(tp) * (5 if remat else 4)
    if pp > 1:
        n += (pp - 1).bit_length()  # the bcast transpose's tree rounds
    mean = ring_folds(dp) + ring_folds(sp)
    if stripes:
        n += tp_replicated * ring_folds(tp) + stripes * mean
    else:
        n += leaves * mean + tp_replicated * ring_folds(tp)
    if pp > 1:
        n += ring_folds(pp)  # the embedding's SUM over pp
    return n + mean  # the loss


def mesh_global(trf, mesh, tree, cfg):
    """The stacked parameter tree read back as the global list form."""
    pp = mesh.shape.get("pp", 1) > 1
    specs = trf.pp_param_specs(cfg) if pp else trf.param_specs(cfg)
    tree = trf._tree_map(mesh.unshard, tree, specs)
    return trf.unstack_layer_params(tree, cfg.n_layers) if pp else tree


def mesh_flat(trf, tree):
    import torch

    return torch.cat([t.reshape(-1) for t in trf._tree_leaves(tree)])


def mesh_oracle_grads(trf, params, tokens, targets, cfg):
    """The gradient with no mesh: torch.autograd of local_train_loss (the
    axis-free forward) over the whole batch, flat in the tree's leaf
    order, and the loss."""
    import torch

    leaves = [p.detach().requires_grad_() for p in trf._tree_leaves(params)]
    it = iter(leaves)
    tree = trf._tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = trf.local_train_loss(tree, tokens, targets, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return torch.cat([g.reshape(-1) for g in grads]), float(loss.detach())


def check_mesh_update(lr: float, got, want, what: str) -> float:
    """The update -lr * got within TRAIN_TOL * max|lr * want| of -lr *
    want on every element, that is got within TRAIN_TOL * max|want| of
    want; returns the error relative to max|want|."""
    scale = float(want.abs().max())
    err = max_abs_err(got, want)
    if not err <= TRAIN_TOL * scale:
        raise AssertionError(f"mesh: {what}: the update differs by "
                             f"{lr * err} > {TRAIN_TOL * lr * scale}")
    return err / scale


def check_applied(new, old, grads, lr: float, what: str) -> int:
    """The step's new parameters are p - lr * g of its own synced
    gradients, to one rounding of the parameter; returns how many
    elements differ at all."""
    import torch

    want = old - lr * grads
    diff = (new - want).abs()
    if not (bool(torch.isfinite(new).all())
            and bool((diff <= 2.0 ** -23 * want.abs()).all())):
        raise AssertionError(f"mesh: {what}: new parameters are not "
                             f"p - lr * g ({float(diff.max())})")
    return int((diff != 0).sum())


# DeepSeek-V3's MoE layer step at its published widths (v3_moe_phase)
V3_CFG = dict(hidden=7168, n_group=8, topk_group=4, top_k=8,
              routed_scaling=2.5, held_first=0, held=32, tokens=128)
V3_WIDTH, V3_EXPERTS, V3_WORLD, V3_LAYERS = 2048, 256, 8, 2
V3_BIAS_STD = 0.065  # the router bias's spread: a hot held expert or two
V3_EXPERT_TOL = 1e-5  # |kernel - plain| <= tol * max|plain| (fp32 orders)
V3_COMBINE_TOL = 1e-6  # fmaf against a multiply and an add, 8 slots


def v3_moe_phase():
    """DeepSeek-V3's MoE layer step (models/moe.py's V3MoEStep, the path
    the benchmark's moe_ep_decode_t128 cell runs) on the card at its
    published widths: hidden 7168, expert width 2048, group 0's 32 of 256
    routed experts held over W = 8, 128 tokens a rank, V3_LAYERS layers
    recorded as one sequence; weights and tokens from a seed, TF32 off.
    The three kernels' launch counts are set to 0 just before the step is
    built. Gates, each failing the run: (1) the compile (warm-up and
    capture) launches each kernel a whole number of times a step, a
    replay none, an eager step gate/up and down, dispatch and combine
    once a layer; (2) the fused step within V3_EXPERT_TOL of the eager
    step (bitwise reported: the shared expert's cuBLAS products may take
    another algorithm under capture), and no slot dropped; (3) on the
    step's own tensors (each layer's input and the layout its router
    wrote in the replay) each kernel against its plain version:
    dispatch_rows bitwise on every placed row, expert_swiglu within
    V3_EXPERT_TOL of the per-expert cuBLAS products relative to their
    largest magnitude, combine_rows within V3_COMBINE_TOL; and the three
    kernels plus the shared expert within V3_EXPERT_TOL of the layer's
    result (bitwise reported). Numbers: each kernel's device ms (host
    held off) on layer 0, its bound (the bytes it must move over
    3.35 TB/s; the expert's the larger of that and its flops over 67
    TFLOP/s FP32), its plain version's ms and a library call's; the
    fused step's device ms. Returns the launches of the checked runs."""
    import torch

    from accl_tpu_torch import ACCL
    from accl_tpu_torch.models import moe
    from accl_tpu_torch.ops import moe_kernels as mk

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("v3_moe: TF32 is on; fp32 products must be "
                             "fp32")
    kernels = {"expert_swiglu": mk.expert_swiglu,
               "dispatch_rows": mk.dispatch_rows,
               "combine_rows": mk.combine_rows}
    counts, delta = launch_counter(kernels)
    cfg = moe.V3MoEConfig(**V3_CFG)
    W, T, D, F, H = V3_WORLD, cfg.tokens, cfg.hidden, V3_WIDTH, cfg.held
    gen = torch.Generator(device="cuda").manual_seed(2828)

    def normal(*shape, std):
        return torch.empty(shape, device="cuda").normal_(0.0, std,
                                                         generator=gen)

    layers = [dict(router=normal(V3_EXPERTS, D, std=D ** -0.5),
                   bias=normal(V3_EXPERTS, std=V3_BIAS_STD),
                   w_gate=normal(H, F, D, std=D ** -0.5),
                   w_up=normal(H, F, D, std=D ** -0.5),
                   w_down=normal(H, D, F, std=F ** -0.5),
                   shared_gate=normal(F, D, std=D ** -0.5),
                   shared_up=normal(F, D, std=D ** -0.5),
                   shared_down=normal(D, F, std=F ** -0.5))
              for _ in range(V3_LAYERS)]
    inputs = [normal(W, T * D, std=1.0) for _ in layers]

    def build(fused):
        accl = ACCL(world=W, torch_device="cuda")
        xs = [accl.create_buffer(T * D) for _ in layers]
        ys = [accl.create_buffer(T * D) for _ in layers]
        for b, x in zip(xs, inputs):
            b.device = x.clone()
        return moe.V3MoEStep(accl, cfg, layers, xs, ys, fused=fused,
                             lint="off"), ys

    for k in kernels.values():
        k.launches = 0
    before = counts()
    step, ys = build(fused=True)
    compiled = delta(before)
    before = counts()
    step.wait(step.run())
    torch.cuda.synchronize()
    replayed = delta(before)
    fused = [y.device.clone() for y in ys]
    replay_ms = run_ms(lambda: step.wait(step.run()), count=5, repeats=3)
    before = counts()
    eager_step, eager_ys = build(fused=False)
    eager_step.wait(eager_step.run())
    torch.cuda.synchronize()
    eager = delta(before)
    n = len(layers)
    per_step = {"expert_swiglu": 2 * n, "dispatch_rows": n,
                "combine_rows": n}
    if replayed or eager != per_step or set(compiled) != set(per_step) \
            or any(compiled[k] % per_step[k] for k in per_step):
        raise AssertionError(f"v3_moe: launches at compile {compiled}, a "
                             f"replay {replayed}, eager {eager}; "
                             f"{per_step} a step")
    bitwise = {}
    for l, (a, b) in enumerate(zip(fused, eager_ys)):
        bitwise[f"eager_{l}"] = same_bits(a, b.device)
        if not max_abs_err(a, b.device) <= V3_EXPERT_TOL * float(
                a.abs().max()):
            raise AssertionError(f"v3_moe: layer {l}: fused and eager "
                                 "steps differ")
    counters = step.counters()
    if counters["moe_dropped"]:
        raise AssertionError(f"v3_moe: {counters['moe_dropped']} dropped")
    del eager_step, eager_ys

    rows_per_rank = step.routings[0].rows_per_rank
    errs, times = {}, {}
    for l, (x, r, w) in enumerate(zip(inputs, step.routings, layers)):
        placed = r.slot_row[r.slot_row >= 0].long()
        mid = mk.dispatch_rows(x, r.slot_row, rows_per_rank)
        plain_mid = mk._dispatch_rows_impl(
            x, r.slot_row, torch.zeros_like(mid).view(-1, D))
        if not same_bits(mid.view(-1, D)[placed], plain_mid[placed]):
            raise AssertionError(f"v3_moe: layer {l}: dispatch_rows")
        rows = mid.view(-1, D)
        eo = mk.expert_swiglu(rows, r.expert_starts, r.expert_rows,
                              w["w_gate"], w["w_up"], w["w_down"],
                              max_rows=W * T)
        plain_eo = mk._expert_swiglu_impl(
            rows, r.expert_starts, r.expert_rows, w["w_gate"], w["w_up"],
            w["w_down"], torch.zeros_like(rows))
        scale = float(plain_eo[placed].abs().max())
        err = max_abs_err(eo[placed], plain_eo[placed])
        if not err <= V3_EXPERT_TOL * scale:
            raise AssertionError(f"v3_moe: layer {l}: expert_swiglu off "
                                 f"by {err} of {scale}")
        eo = eo.view(W, -1)
        back = mk.combine_rows(eo, r.slot_row, r.gate, D)
        plain_back = mk._combine_rows_impl(
            eo.reshape(-1, D), r.slot_row, r.gate,
            torch.empty_like(back).view(W, T, D)).view(W, -1)
        cerr = max_abs_err(back, plain_back)
        cscale = float(plain_back.abs().max())
        if not cerr <= V3_COMBINE_TOL * cscale:
            raise AssertionError(f"v3_moe: layer {l}: combine_rows off by "
                                 f"{cerr} of {cscale}")
        shared = moe.v3_shared_expert(x.view(-1, D), w).view(W, -1)
        bitwise[f"kernels_{l}"] = same_bits(shared + back, fused[l])
        if not max_abs_err(shared + back, fused[l]) <= V3_EXPERT_TOL * \
                float(fused[l].abs().max()):
            raise AssertionError(f"v3_moe: layer {l}: the kernels and the "
                                 "shared expert are not the step's result")
        errs[l] = {"expert_rel": err / scale, "combine_rel": cerr / cscale}
        if l:
            continue
        live = int((r.expert_rows > 0).sum())
        nrows = int(r.expert_rows.sum())
        routed = int((r.slot_row >= 0).any(-1).sum())
        ebytes = 4.0 * (3 * live * D * F + 2 * nrows * D)
        slot = r.slot_row.reshape(-1).long()
        keep = slot >= 0
        src = x.view(W, T, 1, D).expand(W, T, cfg.top_k, D).reshape(-1, D)
        flat_eo = eo.reshape(-1, D)
        idx = r.slot_row.clamp(min=0).long().view(W * T, -1)
        g = torch.where(r.slot_row >= 0, r.gate, 0.0).view(W * T, 1, -1)
        times = {
            "expert_swiglu": {
                "ms": device_ms(lambda: mk.expert_swiglu(
                    rows, r.expert_starts, r.expert_rows, w["w_gate"],
                    w["w_up"], w["w_down"], max_rows=W * T), count=10),
                "bound_ms": 1e3 * max(ebytes / HBM_BYTES_PER_S,
                                      6.0 * nrows * D * F / 67e12),
                "plain_ms": median_ms(lambda: mk._expert_swiglu_impl(
                    rows, r.expert_starts, r.expert_rows, w["w_gate"],
                    w["w_up"], w["w_down"], torch.empty_like(rows)),
                    reps=5),
                "library_ms": None, "rows": nrows, "experts_live": live},
            "dispatch_rows": {
                "ms": device_ms(lambda: mk.dispatch_rows(
                    x, r.slot_row, rows_per_rank)),
                "bound_ms": 1e3 * 4.0 * D * (routed + nrows)
                / HBM_BYTES_PER_S,
                "plain_ms": median_ms(lambda: mk._dispatch_rows_impl(
                    x, r.slot_row, mid.view(-1, D))),
                "library_ms": median_ms(lambda: mid.view(-1, D).index_put_(
                    (slot[keep],), src[keep])),
                "tokens_routed": routed},
            "combine_rows": {
                "ms": device_ms(lambda: mk.combine_rows(
                    eo, r.slot_row, r.gate, D)),
                "bound_ms": 1e3 * 4.0 * D * (nrows + W * T)
                / HBM_BYTES_PER_S,
                "plain_ms": median_ms(lambda: mk._combine_rows_impl(
                    flat_eo, r.slot_row, r.gate,
                    torch.empty_like(back).view(W, T, D))),
                "library_ms": median_ms(lambda: torch.bmm(g, flat_eo[idx])),
            }}
    emit({"phase": "v3_moe", "world": W, "tokens": T, "hidden": D,
          "width": F, "held": H, "layers": len(layers),
          "launches": {"compile": compiled, "replay": replayed,
                       "eager": eager},
          "counters": counters, "errs": errs, "bitwise": bitwise,
          "kernels": times,
          "replay_ms": replay_ms,
          "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30})
    del step, ys, layers, inputs
    torch.cuda.empty_cache()
    return {k: compiled[k] + eager[k] for k in kernels}


def check_logits(got, want, what: str) -> float:
    """|got - want| <= TRAIN_TOL * max|want|; the error relative to it."""
    scale = float(want.abs().max())
    err = max_abs_err(got, want)
    if not err <= TRAIN_TOL * scale:
        raise AssertionError(f"mesh: {what}: {err} > {TRAIN_TOL * scale}")
    return err / scale


def ulysses_int8_launches(batch, seq, heads, head_dim, sp, stripes=1):
    """Kernels 5 and 6's launches in one int8-wire ulysses_attention:
    per head group, three in-alltoalls (q, k, v) and one out-alltoall,
    each one quantize and one dequantize pass when its slot (B * T_local
    * heads_a_group/sp * head_dim elements) is a whole number of
    256-element blocks, else one of each a hop (sp - 1)."""
    from accl_tpu_torch.constants import QUANT_BLOCK_ELEMS

    slot = batch * (seq // sp) * (heads // stripes // sp) * head_dim
    per = 1 if slot % QUANT_BLOCK_ELEMS == 0 else sp - 1
    n = stripes * 4 * per
    return {"quantize": n, "dequantize": n}


def plain_attention(q, k, v):
    """Causal attention over the whole sequence, (B, T, H, D), in fp32
    torch ops: the Ulysses oracle."""
    import torch

    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(mask, s, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def mesh_phase(ring, qk, L):
    """The mesh forms (accl_tpu_torch/parallel/, the mesh half of
    models/transformer.py and models/moe.py) on the card at the flagship
    transformer's widths in fp32 (SERVE_CFG), tokens (8, 1024) from a
    seed, TF32 off. Gates, each failing the run:
      (1) make_forward on dp2.sp2.tp2 (R = 8) within TRAIN_TOL *
          max|ref| of forward_local over the same global weights;
      (2) make_train_step on dp2.sp2.tp2, lr 1e-3: the leaf step's new
          parameters within TRAIN_TOL * max|update| (+ 1e-7 + an ulp of
          the parameter) of a plain autograd oracle of local_train_loss
          over the global batch, its loss within 1e-5 of the oracle's;
          the striped sync (4 stripes) and remat=True within the same
          bound of the leaf step; kernel 7 launched mesh_step_folds()
          times a step in each;
      (3) the pipelined forward and step on dp2.tp2.pp2 (4 layers a
          stage, 4 microbatches) against the same oracles, its launches
          likewise;
      (4) make_decode_step on dp2.tp2, batch 8, init_kv_cache at max_len
          1024: 32 positions decoded token by token within TRAIN_TOL *
          max|ref| of make_forward's logits on the same mesh, kernel 7
          16 times a step;
      (5) ulysses_attention at B 4, T 1024 over sp 4, 16 heads of 64:
          the exact wire within TRAIN_TOL * max|ref| of plain causal
          attention, 4 head stripes within 1e-6 * max|ref| of it (and
          whether bitwise, printed); the int8 wire within the reference's 5e-2 * max|ref|
          of the exact wire and not equal to it, kernels 5 and 6 launched
          as its alltoalls' plan gives (ulysses_int8_launches);
      (6) the MoE mesh forms at MOE_CFG's widths with vocab 32 768, seq
          1024, batch 8 on dp2.ep2 with 2 experts a rank: make_moe_forward
          within TRAIN_TOL of moe_reference_forward, one
          make_moe_train_step within TRAIN_TOL * max|update| of the same
          step on dp1.ep1 with 4 experts a rank.
    Numbers: each form's ms (CUDA events, p50 of MESH_REPS), tokens/s,
    the train step's share of train_flops over 67 TFLOP/s, kernel 7's
    device ms and the top device operations in one profiled step, peak
    memory. Returns each kernel's launches over the checked runs (the
    timed and profiled runs not counted)."""
    import dataclasses

    import numpy as np
    import torch

    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
    from accl_tpu_torch.constants import DataType
    from accl_tpu_torch.models import moe
    from accl_tpu_torch.models import transformer as trf
    from accl_tpu_torch.parallel import make_mesh, ulysses_attention
    from accl_tpu_torch.parallel.mesh import P
    from accl_tpu_torch.sequencer import schedules

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("mesh: TF32 is on; fp32 products must be fp32")
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    torch.cuda.reset_peak_memory_stats()
    gpu = card_name()
    cfg = trf.TransformerConfig(**SERVE_CFG)
    B, T, lr = MESH_BATCH, MESH_SEQ, TRAIN_LR
    params = trf.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(1515), "cuda")
    rng = np.random.default_rng(1515)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T))).cuda()
    targets = torch.roll(tokens, -1, 1)
    times, gates = {}, {}
    path = dict.fromkeys(kernels, 0)  # launches over the checked runs

    def launched(fn, what, want):
        """fn's result; its launches, added to the path's, must be
        `want` of kernel 7 and none of another kernel."""
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        got = delta(before)
        for k, v in got.items():
            path[k] += v
        if got != ({"combine": want} if want else {}):
            raise AssertionError(f"mesh: {what} launched {got}; the "
                                 f"schedule gives {want} of kernel 7")
        return out

    # (1) the forward on dp2.sp2.tp2
    mesh = make_mesh(MESH_AXES)
    sharded = trf.shard_params(params, cfg, mesh)
    forward = trf.make_forward(cfg, mesh)
    fold = ring_folds(MESH_AXES["tp"])
    logits = launched(lambda: forward(sharded, tokens), "the forward",
                      2 * cfg.n_layers * fold)
    with torch.no_grad():
        ref = trf.forward_local(params, tokens, cfg)
    gates["forward_rel_err"] = check_logits(logits, ref, "forward")
    del logits
    times["forward"] = timed_runs(lambda: forward(sharded, tokens),
                                  MESH_REPS)

    # (2) the train step on dp2.sp2.tp2 against the oracle
    want_g, want_loss = mesh_oracle_grads(trf, params, tokens, targets, cfg)
    old = mesh_flat(trf, params)

    def checked_step(step, mesh, folds, what):
        """One step and its synced gradients, each launching kernel 7
        `folds` times; the step's new parameters checked to be p - lr * g
        of those gradients; the gradients flat and the loss returned."""
        new, loss = launched(lambda: step(sharded, tokens, targets),
                             f"the {what} step", folds)
        g, _ = launched(lambda: step.grads(sharded, tokens, targets),
                        f"the {what} step's gradients", folds)
        g = mesh_flat(trf, mesh_global(trf, mesh, g, cfg))
        gates[f"train_{what}_new_params_off_by_an_ulp"] = check_applied(
            mesh_flat(trf, mesh_global(trf, mesh, new, cfg)), old, g, lr,
            what)
        gates[f"train_{what}_kernel7_per_step"] = folds
        loss = float(loss)
        if not abs(loss - want_loss) <= 1e-5 * abs(want_loss):
            raise AssertionError(f"mesh: the {what} step's loss {loss} "
                                 f"against the oracle's {want_loss}")
        return g, loss

    steps = {}
    for name, kw in (("leaf", {}),
                     ("striped", dict(grad_sync="striped",
                                      grad_stripes=MESH_STRIPES)),
                     ("remat", dict(remat=True))):
        step = steps[name] = trf.make_train_step(cfg, mesh, lr=lr, **kw)
        g, loss = checked_step(
            step, mesh, mesh_step_folds(cfg, MESH_AXES,
                                        remat=name == "remat",
                                        stripes=kw.get("grad_stripes")),
            name)
        if name == "leaf":
            gates["train_leaf_vs_oracle_rel_err"] = check_mesh_update(
                lr, g, want_g, "the leaf step against the oracle")
            gates.update(train_loss=loss, oracle_loss=want_loss)
            leaf_g = g
        else:
            gates[f"train_{name}_vs_leaf_rel_err"] = check_mesh_update(
                lr, g, leaf_g, f"the {name} step against the leaf step")
        del g
    del leaf_g
    for name in ("leaf", "striped"):
        times[f"train_{name}"] = timed_runs(
            lambda: steps[name](sharded, tokens, targets), MESH_REPS)
    prof = kernel_profile(lambda: steps["leaf"](sharded, tokens, targets))
    combine_ms = sum(ms for n, ms in prof["kernel_ms"].items()
                     if "lane_walk<" in n and "Combine<" in n)
    combine_n = sum(c for n, c in prof["kernels"].items()
                    if "lane_walk<" in n and "Combine<" in n)
    if combine_n != gates["train_leaf_kernel7_per_step"]:
        raise AssertionError(f"mesh: a profiled step ran {combine_n} "
                             "kernel 7 launches")
    top = sorted(prof["kernel_ms"].items(), key=lambda kv: -kv[1])[:12]
    del steps, sharded, forward, mesh

    # (3) the pipelined forward and step on dp2.tp2.pp2
    mesh = make_mesh(MESH_PP_AXES)
    sharded = trf.shard_params(params, cfg, mesh)
    M = MESH_MICROBATCHES
    pp_runs = (M + MESH_PP_AXES["pp"] - 1) * (cfg.n_layers
                                              // MESH_PP_AXES["pp"])
    forward = trf.make_forward(cfg, mesh, n_microbatches=M)
    logits = launched(lambda: forward(sharded, tokens), "the pp forward",
                      2 * pp_runs * ring_folds(MESH_PP_AXES["tp"]))
    gates["pp_forward_rel_err"] = check_logits(logits, ref, "pp forward")
    del logits, forward
    step = trf.make_train_step(cfg, mesh, lr=lr, n_microbatches=M)
    g, _ = checked_step(step, mesh,
                        mesh_step_folds(cfg, MESH_PP_AXES, n_microbatches=M),
                        "pp")
    gates["train_pp_vs_oracle_rel_err"] = check_mesh_update(
        lr, g, want_g, "the pp step against the oracle")
    del g, want_g, old, ref
    times["train_pp"] = timed_runs(lambda: step(sharded, tokens, targets),
                                   MESH_REPS)
    del step, sharded, mesh
    torch.cuda.empty_cache()

    # (4) decode on dp2.tp2 against make_forward on the same mesh
    mesh = make_mesh(MESH_DECODE_AXES)
    sharded = trf.shard_params(params, cfg, mesh)
    dec_tok = tokens[:, :MESH_DECODE_STEPS]
    with torch.no_grad():
        ref = trf.make_forward(cfg, mesh)(sharded, dec_tok)
    decode = trf.make_decode_step(cfg, mesh)
    cache = trf.init_kv_cache(cfg, mesh, B, MESH_DECODE_LEN)
    positions = torch.arange(MESH_DECODE_LEN, device=tokens.device)
    outs = []
    dfold = 2 * cfg.n_layers * ring_folds(MESH_DECODE_AXES["tp"])
    for t in range(MESH_DECODE_STEPS):
        lg, cache = launched(
            lambda: decode(sharded, cache, dec_tok[:, t:t + 1],
                           positions[t:t + 1]), "a decode step", dfold)
        outs.append(lg)
    gates["decode_vs_forward_rel_err"] = check_logits(
        torch.cat(outs, 1), ref, "decode against make_forward")
    gates["decode_kernel7_per_step"] = dfold
    del outs, ref
    t_next = [MESH_DECODE_STEPS]

    def decode_one():
        t = t_next[0]
        t_next[0] += 1
        decode(sharded, cache, tokens[:, t:t + 1], positions[t:t + 1])

    times["decode_step"] = timed_runs(decode_one, MESH_REPS)
    del cache, sharded, decode, mesh, params
    torch.cuda.empty_cache()

    # (5) Ulysses at the flagship attention widths
    u = MESH_ULYSSES
    mesh = make_mesh({"sp": u["sp"]})
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (u["batch"], u["seq"], u["heads"], u["head_dim"])).astype(
            np.float32)).cuda() for _ in range(3))
    args = [mesh.shard(t, P(None, "sp")) for t in (q, k, v)]
    exact = launched(lambda: ulysses_attention(*args, mesh=mesh,
                                               axis_name="sp"),
                     "exact Ulysses", 0)
    exact = mesh.unshard(exact, P(None, "sp"))
    gates["ulysses_exact_rel_err"] = check_logits(
        exact, plain_attention(q, k, v), "Ulysses against attention")
    striped = mesh.unshard(launched(
        lambda: ulysses_attention(*args, mesh=mesh, axis_name="sp",
                                  stripes=MESH_ULYSSES_STRIPES),
        "striped Ulysses", 0), P(None, "sp"))
    serr = max_abs_err(striped, exact)
    if not serr <= 1e-6 * float(exact.abs().max()):
        raise AssertionError(f"mesh: striped Ulysses {serr} from unstriped")
    gates.update(ulysses_striped_rel_err=serr / float(exact.abs().max()),
                 ulysses_striped_bitwise=same_bits(striped, exact))
    del striped
    wire = schedules.Wire(DEFAULT_ARITH_CONFIG[(DataType.float32,
                                                DataType.int8)])
    before = counts()
    quant = ulysses_attention(*args, mesh=mesh, axis_name="sp", wire=wire)
    torch.cuda.synchronize()
    got = delta(before)
    for k, v in got.items():
        path[k] += v
    want = ulysses_int8_launches(u["batch"], u["seq"], u["heads"],
                                 u["head_dim"], u["sp"])
    if got != want:
        raise AssertionError(f"mesh: int8 Ulysses launched {got}; its "
                             f"alltoalls' plan gives {want}")
    quant = mesh.unshard(quant, P(None, "sp"))
    qerr = max_abs_err(quant, exact)
    if not 0 < qerr < MOE_INT8_BOUND * float(exact.abs().max()):
        raise AssertionError(f"mesh: int8 Ulysses error {qerr}")
    gates.update(ulysses_int8_rel_err=qerr / float(exact.abs().max()),
                 ulysses_int8_launches=want)
    times["ulysses_exact"] = timed_runs(
        lambda: ulysses_attention(*args, mesh=mesh, axis_name="sp"),
        MESH_REPS)
    times["ulysses_int8"] = timed_runs(
        lambda: ulysses_attention(*args, mesh=mesh, axis_name="sp",
                                  wire=wire), MESH_REPS)
    del q, k, v, args, exact, quant, mesh

    # (6) the MoE mesh forms on dp2.ep2, 2 experts a rank
    mcfg = moe.MoEConfig(**MESH_MOE_CFG)
    mparams = moe.init_moe_params(mcfg, torch.Generator(device="cuda")
                                  .manual_seed(1516), "cuda")
    mtok = torch.from_numpy(rng.integers(0, mcfg.vocab,
                                         (B, mcfg.seq))).cuda()
    mtgt = torch.roll(mtok, -1, 1)
    mesh = make_mesh(MESH_MOE_AXES)
    placed = moe.place_moe_params(mparams, mcfg, mesh)
    with torch.no_grad():
        ref = moe.moe_reference_forward(mparams, mtok, mcfg)
    out = launched(lambda: moe.make_moe_forward(mcfg, mesh)(placed, mtok),
                   "the MoE forward", 0)
    gates["moe_forward_rel_err"] = check_logits(out, ref, "MoE forward")
    del out, ref
    one = dataclasses.replace(mcfg, experts_per_rank=mcfg.n_experts)
    mesh1 = make_mesh({"dp": 1, "ep": 1})
    specs = moe.moe_param_specs(mcfg)
    names = list(mparams)

    def flat(m, tree):
        return torch.cat([m.unshard(tree[n], specs[n]).reshape(-1)
                          for n in names])

    want_g, _ = moe.make_moe_train_step(one, mesh1, lr=lr).grads(
        moe.place_moe_params(mparams, one, mesh1), mtok, mtgt)
    want_g = flat(mesh1, want_g)
    step = moe.make_moe_train_step(mcfg, mesh, lr=lr)
    # per leaf the dp mean, the three replicated leaves the ep mean; the
    # loss's dp and ep means
    mfolds = 5 * ring_folds(MESH_MOE_AXES["dp"]) \
        + 3 * ring_folds(MESH_MOE_AXES["ep"]) \
        + ring_folds(MESH_MOE_AXES["dp"]) + ring_folds(MESH_MOE_AXES["ep"])
    new, _ = launched(lambda: step(placed, mtok, mtgt), "the MoE step",
                      mfolds)
    g, _ = launched(lambda: step.grads(placed, mtok, mtgt),
                    "the MoE step's gradients", mfolds)
    g = flat(mesh, g)
    old = torch.cat([mparams[n].reshape(-1) for n in names])
    gates["moe_step_new_params_off_by_an_ulp"] = check_applied(
        flat(mesh, new), old, g, lr, "the MoE step")
    gates["moe_step_vs_dp1_ep1_rel_err"] = check_mesh_update(
        lr, g, want_g, "the MoE step against dp1.ep1")
    gates["moe_kernel7_per_step"] = mfolds
    del new, want_g, g, old
    times["moe_step"] = timed_runs(lambda: step(placed, mtok, mtgt),
                                   MESH_REPS)
    del placed, mparams, step, mesh, mesh1
    idle = [k for k in ("combine", "quantize", "dequantize") if not path[k]]
    if idle:
        raise AssertionError(f"the mesh path launched no {idle}")

    flops = train_flops(cfg, B * T, T)
    bound_ms = flops / FP32_FLOPS_PER_S * 1e3
    leaf_ms = times["train_leaf"]["events_ms_p50"]
    MESH_TIMES["train_leaf"] = times["train_leaf"]
    emit({"phase": "mesh", "gpu": gpu, "config": {**SERVE_CFG,
                                                  "dtype": "float32"},
          "tokens": [B, T], "axes": MESH_AXES, "pp_axes": MESH_PP_AXES,
          "decode_axes": MESH_DECODE_AXES, "ulysses": MESH_ULYSSES,
          "moe_axes": MESH_MOE_AXES, "moe_config": MESH_MOE_CFG,
          "lr": lr, "tolerance": TRAIN_TOL, "gates": gates,
          "launches": path})
    emit({"phase": "mesh_timing", "gpu": gpu,
          "ms_p50": {k: v["events_ms_p50"] for k, v in times.items()},
          "timed_runs": times,
          "train_tokens_per_s": B * T / leaf_ms * 1e3,
          "train_flops": flops, "train_bound_ms": bound_ms,
          "bound_by": "operations", "train_bound_share": bound_ms / leaf_ms,
          "profiled_step_kernel7_ms": combine_ms,
          "profiled_step_kernel7_launches": combine_n,
          "profiled_step_device_busy_ms": prof["busy_ms"],
          "profiled_step_kernels": sum(prof["kernels"].values()),
          "profiled_step_top": [{"name": n[:140], "ms": ms,
                                 "count": prof["kernels"][n]}
                                for n, ms in top],
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    torch.cuda.empty_cache()
    return path


# the analysis path: each library entry at these multiples of its
# canonical count (multiples keep every family's chunking rule), the
# mutant seeds, and the class code each mutation kind must carry when
# the certifier flags it (the reference's tests/test_semantics.py)
ANALYSIS_COUNTS = (1, 5, 37)
ANALYSIS_SEEDS = (0, 1, 2)
ANALYSIS_MUTATION_CODE = {"drop_combine": "ACCL502",
                          "duplicate_combine": "ACCL503",
                          "reorder_combine": "ACCL504",
                          "swap_send_values": "ACCL501"}
# round_launches' names -> the kernels line's
ANALYSIS_KERNELS = {"combine": "combine", "dequant_combine": "dequant_combine",
                    "quantize": "quantize", "dequantize": "dequantize",
                    "cast": "cast"}


def analysis_payload(dag, quantized, rng):
    """The reference's _payloads (tests/test_semantics.py) as
    (world, in_elems) rows: unique integer-valued fp32 on the exact wire
    (every sum exact in fp32, a misroute visible), small positive
    integers on the int8 wire."""
    import numpy as np

    w, n = dag.world, dag.in_elems
    if quantized:
        return rng.integers(1, 9, (w, n)).astype(np.float32)
    return np.arange(w * n, dtype=np.float32).reshape(w, n) + 1.0


def analysis_oracle(op, x, count, func):
    """The numpy meaning of a library collective over rows x."""
    import numpy as np

    red = np.max if func == "max" else np.sum
    w = x.shape[0]
    if op == "allreduce":
        return np.tile(red(x, axis=0), (w, 1))
    if op == "allgather":
        return np.tile(x.reshape(-1), (w, 1))
    full = red(x, axis=0)  # reduce_scatter
    return np.stack([full[r * count:(r + 1) * count] for r in range(w)])


def analysis_mutations(dag, quantized):
    """The reference's _applicable_mutations (tests/test_semantics.py)."""
    kinds = []
    combines = [n for n in dag.nodes if n.kind == "combine"]
    if combines:
        kinds.append("drop_combine")
        if any(any(dag.nodes[p.node].kind == "recv" for p in n.refs())
               for n in combines):
            kinds.append("reorder_combine")
    if any(n.func == "sum" for n in combines):
        kinds.append("duplicate_combine")
    if not quantized:
        kinds.append("swap_send_values")
    return kinds


def analysis_phase(ring, qk, L):
    """The analysis stack's program and DAG half (accl_tpu_torch/
    analysis/, synthesis's certify/search/verify_library) with the
    certified library checked against its lowered run on the card.
    Gates, each failing the run:
      (1) synthesis.verify_library(): all 31 entries regenerate to their
          dag_sha256, certify clean and keep their windows;
      (2) search for flat allreduce at W = 4 and 8 under shipped_link()
          and tiered at (2, 4) under shipped_tier_links() finds the
          library's entries for those cells, keys and win_bytes;
      (3) every entry at ANALYSIS_COUNTS x its canonical count, SUM and,
          for the exact-wire allreduce entries, MAX: certify_dag clean;
          lower_dag(dag) on CUDA tensors of the reference's payloads,
          each call launching kernels 7, 4, 5, 6 (and the cast kernel)
          exactly as synthesis.round_launches reads off the lowering's
          round plan; the exact wire bitwise equal to hopdag.execute and
          to the numpy oracle; the int8 wire within (W+1)·W·max|x|/254 +
          1e-5 of the oracle and bitwise equal to the same lowering on
          the CPU (the kernels' plain versions); the int8 exchange
          entries are rank-divergent by design (each rank rounds its own
          partials), which is counted, not gated;
      (4) per entry, each mutation kind the reference's
          _applicable_mutations allows and ANALYSIS_SEEDS: certify the
          mutant; run it on the card where lower_dag accepts it (launches
          as its round plan gives, the exact wire bitwise with
          hopdag.execute), else through hopdag.execute on the host; the
          reference's rule: clean-certified computes the oracle's values,
          a flagged mutant carries its class code, a flagged drop,
          duplicate or swap under SUM computes wrong values (outside the
          bound, or on the int8 wire other values than the clean DAG on
          the same path: from W = 15 the bound exceeds one
          contribution); 0 disagreements;
      (5) the 27 rank_programs/slots/hopdag fixtures of tools/
          lint_corpus/ give their expect/expect_semantic codes through
          analysis.corpus.lint_fixture, deep off and on.
    Prints one "analysis" line (counts, seconds, launches by kernel) and
    returns each kernel's launches over the phase's runs on the card."""
    import random

    import numpy as np
    import torch

    from accl_tpu_torch.analysis import corpus, hopdag, semantics
    from accl_tpu_torch.constants import Operation, ReduceFunction
    from accl_tpu_torch.sequencer import synthesis

    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    gpu = card_name()
    seconds = {}
    t_phase = time.perf_counter()

    # (1) the library gate
    t = time.perf_counter()
    msgs = []
    if not synthesis.verify_library(log=msgs.append):
        raise AssertionError("analysis: verify_library failed:\n"
                             + "\n".join(m for m in msgs if "FAIL" in m))
    seconds["verify_library"] = time.perf_counter() - t

    # (2) the search finds the library's winners
    t = time.perf_counter()
    link, tier_links = synthesis.shipped_link(), synthesis.shipped_tier_links()
    lib = synthesis.library()
    winners = {}
    for world, tiers in ((4, None), (8, None), (8, (2, 4))):
        kw = {} if tiers is None else {"tiers": tiers,
                                       "tier_links": tier_links}
        found = {r.spec.key: r.win_bytes for r in synthesis.search(
            Operation.allreduce, world, link, **kw)}
        want = {k: e.win_bytes for k, e in lib.items()
                if e.spec.op == "allreduce" and e.spec.world == world
                and e.spec.grid == "std"
                and e.spec.tiers == (tiers or ())}
        if found != want or not found:
            raise AssertionError(f"analysis: search W={world} tiers={tiers} "
                                 f"found {found}, library {want}")
        winners[f"w{world}" + (f"_t{tiers[0]}x{tiers[1]}" if tiers else "")] \
            = sorted(found)
    seconds["search"] = time.perf_counter() - t

    path = dict.fromkeys(kernels, 0)

    def lowered_on_card(dag, x, what):
        """lower_dag(dag) over x on the card; its launches, added to the
        path's, must be the round plan's."""
        want = {ANALYSIS_KERNELS[k]: n
                for k, n in synthesis.round_launches(dag).items() if n}
        before = counts()
        out = synthesis.lower_dag(dag)(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        got = delta(before)
        if got != want:
            raise AssertionError(f"analysis: {what} launched {got}, its "
                                 f"round plan {want}")
        for name, n in got.items():
            path[name] += n
        return out.cpu().numpy()

    # (3) certifier against execution
    t = time.perf_counter()
    runs = divergent = 0
    worst_over_bound = 0.0
    for key, entry in sorted(lib.items()):
        spec = entry.spec
        quantized = spec.wire == "int8"
        funcs = ["sum"] + (["max"] if spec.op == "allreduce"
                           and not quantized else [])
        rng = np.random.default_rng(sum(map(ord, key)))
        for mult in ANALYSIS_COUNTS:
            count = mult * entry.canonical_count
            for func in funcs:
                what = f"{key} count {count} {func}"
                fn = (ReduceFunction.MAX if func == "max"
                      else ReduceFunction.SUM)
                dag = synthesis.instantiate(spec, count, func)
                diags = synthesis.certify_dag(dag, spec, count, fn)
                if diags:
                    raise AssertionError(f"analysis: {what} does not "
                                         f"certify: {diags[:2]}")
                x = analysis_payload(dag, quantized, rng)
                want = analysis_oracle(spec.op, x, count, func)
                got = lowered_on_card(dag, x, what)
                if quantized:
                    bound = ((dag.world + 1) * dag.world
                             * float(np.abs(x).max()) / 254.0 + 1e-5)
                    err = float(np.abs(got - want).max())
                    cpu = synthesis.lower_dag(dag)(torch.from_numpy(x))
                    if err > bound or not same_bits(torch.from_numpy(got),
                                                    cpu):
                        raise AssertionError(
                            f"analysis: {what}: int8 error {err} (bound "
                            f"{bound}), bitwise with the CPU lowering: "
                            f"{same_bits(torch.from_numpy(got), cpu)}")
                    worst_over_bound = max(worst_over_bound, err / bound)
                    divergent += not all(np.array_equal(got[0], row)
                                         for row in got)
                else:
                    ex = np.stack(hopdag.execute(dag, [[r] for r in x]))
                    if not (np.array_equal(got, ex)
                            and np.array_equal(got, want)):
                        raise AssertionError(
                            f"analysis: {what}: lowered on the card is not "
                            "bitwise hopdag.execute and the oracle")
                runs += 1
    seconds["certify_vs_execution"] = time.perf_counter() - t

    # (4) mutants
    t = time.perf_counter()
    mutants = flagged = on_card = refused = 0
    disagreements = []
    for key, entry in sorted(lib.items()):
        spec = entry.spec
        quantized = spec.wire == "int8"
        count = entry.canonical_count
        dag = synthesis.instantiate(spec, count)
        sem_spec = semantics.collective_spec(
            synthesis._call_options(spec, count), spec.world)
        x = analysis_payload(dag, quantized,
                             np.random.default_rng(sum(map(ord, key))))
        want = analysis_oracle(spec.op, x, count, "sum")
        bound = ((dag.world + 1) * dag.world * float(np.abs(x).max())
                 / 254.0 + 1e-5)
        clean = np.stack(hopdag.execute(dag, [[r] for r in x]))
        clean_card = None
        for kind in analysis_mutations(dag, quantized):
            for seed in ANALYSIS_SEEDS:
                mut = hopdag.mutate(dag, kind, random.Random(seed))
                if mut is None:
                    continue
                mutants += 1
                what = f"{key} {kind} seed {seed}"
                codes = {d.code for d in semantics.certify(mut, sem_spec,
                                                           spec.op)}
                flagged += bool(codes)
                out = np.stack(hopdag.execute(mut, [[r] for r in x]))
                same_path = clean
                try:
                    synthesis.round_launches(mut)
                except synthesis.SynthesisError:
                    refused += 1
                else:
                    card = lowered_on_card(mut, x, what)
                    on_card += 1
                    if not quantized and not np.array_equal(card, out):
                        disagreements.append(f"{what}: lowered on the card "
                                             "!= hopdag.execute")
                    if clean_card is None:
                        clean_card = lowered_on_card(dag, x, key)
                    out, same_path = card, clean_card
                broken = (not np.allclose(out, want, rtol=0, atol=bound)
                          if quantized else not np.array_equal(out, want))
                if not codes:
                    if broken:
                        disagreements.append(f"{what}: certified clean, "
                                             "computes wrong values")
                    continue
                if ANALYSIS_MUTATION_CODE[kind] not in codes or not all(
                        c.startswith("ACCL5") for c in codes):
                    disagreements.append(f"{what}: flagged {sorted(codes)}")
                if (kind in ("drop_combine", "duplicate_combine",
                             "swap_send_values") and not broken
                        and not (quantized
                                 and not np.array_equal(out, same_path))):
                    disagreements.append(f"{what}: flagged, computes the "
                                         "oracle's values")
    seconds["mutants"] = time.perf_counter() - t
    if disagreements:
        raise AssertionError("analysis: certifier/execution disagreements: "
                             + "; ".join(disagreements[:8]))

    # (5) the corpus's program-level fixtures
    t = time.perf_counter()
    fixtures = 0
    for fpath in sorted(corpus.CORPUS_DIR.glob("*.json")):
        fx = json.loads(fpath.read_text())
        if fx.get("kind", "sequence") not in corpus.PROGRAM_KINDS:
            continue
        for deep in (False, True):
            diags = corpus.lint_fixture(fx, deep=deep)
            if not corpus.fixture_ok(fx, diags):
                raise AssertionError(
                    f"analysis: fixture {fpath.name} deep={deep} gave "
                    f"{[d.code for d in diags]}")
        fixtures += 1
    if fixtures != 27:
        raise AssertionError(f"analysis: {fixtures} program fixtures, not 27")
    seconds["fixtures"] = time.perf_counter() - t

    # the library's round plans fold (kernel 7), fuse decode+fold (4) and
    # encode (5); none reads a decode round unfused (kernel 6) or casts
    idle = [k for k in ("combine", "dequant_combine", "quantize")
            if not path[k]]
    if idle:
        raise AssertionError(f"the analysis path launched no {idle}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "analysis", "gpu": gpu, "entries": len(lib),
          "verify_library": True, "search_winners": winners,
          "runs": runs, "counts": list(ANALYSIS_COUNTS),
          "int8_rank_divergent_runs": divergent,
          "int8_worst_err_over_bound": worst_over_bound,
          "mutants": mutants, "flagged": flagged, "lowered_on_card": on_card,
          "refused_by_lowering": refused, "disagreements": 0,
          "fixtures": fixtures, "fixture_runs": 2 * fixtures,
          "seconds": seconds, "launches": path})
    return path


# the lifting half: the reference's family grid (analysis.corpus.
# FAMILY_GRID) and the probe set below, each call lifted and certified
LIFT_OPS = ("allreduce", "allgather", "reduce_scatter", "bcast", "scatter",
            "gather", "reduce", "alltoall")
LIFT_WORLDS = (2, 4, 5, 8)
LIFT_COUNTS = (7, 1000, 300_000)
LIFT_SEEDS = range(3, 9)  # hopdag.mutate seeds, the reference's kind rule
LIFT_TENANT_COUNT = 1 << 18  # elements a rank of each tenant's allreduce
LIFT_STREAM = 77  # the shared stream endpoint of the rejected tenant pair


def lift_payload(world: int, elems: int, quantized: bool):
    """Integer-valued fp32 rows whose every sum is exact in fp32 (so any
    fold order gives the same bits and a misrouted element is visible):
    (w*n + j) mod 131071 + 1 on the exact and cast wires, small positive
    integers on the int8 wire, as the reference's _payloads."""
    import numpy as np

    if quantized:
        return (np.arange(world * elems, dtype=np.int64) % 8 + 1).astype(
            np.float32).reshape(world, elems)
    return (np.arange(world * elems, dtype=np.int64) % 131071 + 1).astype(
        np.float32).reshape(world, elems)


def lift_oracle(opts, x):
    """The numpy meaning of a one-call collective over rows x (None where
    the collective leaves a rank's output unspecified)."""
    import numpy as np

    from accl_tpu_torch.constants import Operation, ReduceFunction

    w, scen, count = x.shape[0], opts.scenario, opts.count
    root = opts.root_src_dst
    red = (np.max if ReduceFunction(opts.function) == ReduceFunction.MAX
           else np.sum)
    if scen == Operation.bcast:
        return [x[root]] * w
    if scen == Operation.scatter:
        return [x[root, r * count:(r + 1) * count] for r in range(w)]
    if scen == Operation.gather:
        return [x.reshape(-1) if r == root else None for r in range(w)]
    if scen == Operation.allgather:
        return [x.reshape(-1)] * w
    if scen == Operation.reduce:
        return [red(x, axis=0) if r == root else None for r in range(w)]
    if scen == Operation.allreduce:
        return [red(x, axis=0)] * w
    if scen == Operation.reduce_scatter:
        full = red(x, axis=0)
        return [full[r * count:(r + 1) * count] for r in range(w)]
    if scen == Operation.send:
        src, dst = root & 0xFFFF, (root >> 16) & 0xFFFF
        return [x[src] if r == dst else x[r] for r in range(w)]
    assert scen == Operation.alltoall
    pc = opts.peer_counts or (count,) * w
    out = []
    for r in range(w):
        row = np.zeros(w * count, np.float32)
        for c in range(w):
            row[c * count:c * count + pc[r]] = \
                x[c, r * count:r * count + pc[r]]
        out.append(row)
    return out


def lift_class_codes(kind: str) -> set:
    """The codes a flagged mutant of `kind` may carry: its class's
    (ANALYSIS_MUTATION_CODE), and for a swap of two sends' payloads also
    ACCL502. A swap misroutes: the certifier reports foreign data
    (ACCL501) where a receiver keeps the misrouted region, but only the
    missing contribution (ACCL502) where the payload it keeps is zero fill
    (a tree gather sends its whole buffer, a ring its padding) or the
    misrouted region is dropped. The reference's rule expects ACCL501
    alone: its lift fails on the bodies that show this (queue 3)."""
    codes = {ANALYSIS_MUTATION_CODE[kind]}
    if kind == "swap_send_values":
        codes.add("ACCL502")
    return codes


def lift_calls(counts=LIFT_COUNTS):
    """(label, options, plan, world, trees) of the family grid (each at
    its own world and count) and the probe set."""
    from accl_tpu_torch.analysis import corpus
    from accl_tpu_torch.constants import Operation

    calls = []
    for scen, count, world, kw in corpus.FAMILY_GRID:
        tags = ",".join(f"{k}={getattr(v, 'name', v)}"
                        for k, v in kw.items())
        opts, plan = corpus.family_call(scen, count, world, **kw)
        calls.append((f"grid {scen.name} {count} W{world} {tags}", opts,
                      plan, world, bool(kw.get("trees"))))
    for op in LIFT_OPS:
        for world in LIFT_WORLDS:
            for count in counts:
                opts, plan = corpus.family_call(Operation[op], count, world)
                calls.append((f"probe {op} {count} W{world}", opts, plan,
                              world, False))
    return calls


def lift_facade_run(accl, opts, x):
    """One call through the facade's collective methods on rows x, the
    card's lowering (kernels and all), device to device; returns (the
    result rows, the request)."""
    import torch

    from accl_tpu_torch.constants import DataType, Operation, ReduceFunction
    from accl_tpu_torch.sequencer.sequence import step_out_elems

    scen, count, world = opts.scenario, opts.count, accl.world
    root, f = opts.root_src_dst, ReduceFunction(opts.function)
    cd = opts.compress_dtype if opts.compress_dtype != DataType.none \
        else None
    src = accl.create_buffer(x.shape[1])
    src.device.copy_(x)
    res = accl.create_buffer(max(step_out_elems(opts, world), x.shape[1]))
    kw = dict(from_device=True, to_device=True, compress_dtype=cd)
    if scen == Operation.bcast:
        req, res = accl.bcast(src, count, root, **kw), src
    elif scen == Operation.scatter:
        req = accl.scatter(src, res, count, root, **kw)
    elif scen == Operation.gather:
        req = accl.gather(src, res, count, root, **kw)
    elif scen == Operation.allgather:
        req = accl.allgather(src, res, count, **kw)
    elif scen == Operation.reduce:
        req = accl.reduce(src, res, count, root, f, **kw)
    elif scen == Operation.allreduce:
        req = accl.allreduce(src, res, count, f, **kw)
    elif scen == Operation.reduce_scatter:
        req = accl.reduce_scatter(src, res, count, f, **kw)
    elif scen == Operation.alltoall and opts.peer_counts:
        req = accl.alltoallv(src, res, count, list(opts.peer_counts), **kw)
    elif scen == Operation.alltoall:
        req = accl.alltoall(src, res, count, **kw)
    else:
        s, d = root & 0xFFFF, (root >> 16) & 0xFFFF
        accl.send(src, count, s, d, run_async=True, from_device=True,
                  compress_dtype=cd)
        req = accl.recv(res, count, s, d, to_device=True, compress_dtype=cd)
    out = res.device.clone()
    for b in {id(src): src, id(res): res}.values():
        accl.free_buffer(b)
    if out.is_cuda:
        torch.cuda.synchronize()
    return out, req


def lift_phase(ring, qk, L, *, device="cuda", counts=LIFT_COUNTS,
               model_cfg=None):
    """The analysis stack's lifting half (analysis/semantics.py's lifter,
    protocol.py's recorded hops, linter.py's semantic pass and deep tier,
    interference.py) against the card. Gates, each failing the run:
      (1) every call of the reference's family grid (26, at their own
          world and count) and of the probe set (LIFT_OPS x LIFT_WORLDS x
          LIFT_COUNTS) lifts and certifies clean (an unliftable call
          fails), host ms of the lift and certification; on the calls
          inside the in-band budget also certify_call through
          check_batch_semantics(strict=True), cold and cached;
      (2) each call through the facade on the card, the real lowering
          with its kernels, on lift_payload rows: equal to hopdag.execute
          of the lifted DAG and to the numpy oracle, bitwise on the exact
          and cast wires (the payloads' sums are exact in fp32, so any
          fold order gives the same bits), within the reference's bound
          (W+1)*W*max|x|/254 + 1e-5 on the int8 wire; on random normal
          rows, the calls whose card result is bitwise hopdag.execute's
          are counted (the fold order), not gated;
      (3) per DAG, hopdag.mutate with seeds 3-8 (kind by the reference's
          rule): a mutant that certifies clean computes the oracle's
          values, a flagged one carries its class code (lift_class_codes:
          a swap may show as a missing contribution), a
          flagged drop/duplicate/swap under SUM computes wrong values; 0
          disagreements;
      (4) tenant sequences prepared on the card (W 8, LIFT_TENANT_COUNT
          elements a rank): a disjoint pair certifies with 0 escalations
          and is stamped, its two programs dispatched from two threads
          equal their serial composition bitwise; a write/write pair and
          a shared stream endpoint reject ACCL601, and the write/write
          pair's A;B and B;A differ;
      (5) the flagship transformer's decode-step batch (W 4, batch 8,
          max_len 1024) and train-step batch (W 4, 155 205 632
          parameters), each prepared with lint="error" (the default
          tier's semantic pass: its host ms in the first prepare) and
          with lint="deep" (the interleaving tier) on the card, clean.
    Prints one "lift" line and returns each kernel's launches over the
    checked runs of (2)."""
    import random
    import threading

    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, ReduceFunction, telemetry
    from accl_tpu_torch.analysis import (
        InterferenceCertifier,
        corpus,
        hopdag,
        semantics,
    )
    from accl_tpu_torch.constants import DataType, TuningParams
    from accl_tpu_torch.models import transformer as trf

    on_card = device == "cuda"
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts_of, delta = launch_counter(kernels)
    path = dict.fromkeys(kernels, 0)
    seconds = {}
    t_phase = time.perf_counter()

    # (1) lift and certify every call (a certify_call miss: the lift and
    # the certification); the strict entry point, cold and cached, on
    # the calls inside the in-band budget (the default tier's)
    t = time.perf_counter()
    calls = lift_calls(counts)
    semantics.clear_cache()
    lifted, cold, cached, dags = [], [], [], []
    for label, opts, plan, world, trees in calls:
        t0 = time.perf_counter()
        dag = semantics.lift_call(opts, plan, world)
        diags = semantics.certify(dag, semantics.collective_spec(
            opts, world), opts.scenario.name)
        lifted.append((time.perf_counter() - t0) * 1e3)
        if diags:
            raise AssertionError(f"lift: {label} does not certify: "
                                 f"{[str(d) for d in diags[:2]]}")
        if semantics._within_inband_budget(opts, plan, world):
            t0 = time.perf_counter()
            diags = semantics.check_batch_semantics([opts], [plan], world,
                                                    strict=True)
            t1 = time.perf_counter()
            diags += semantics.check_batch_semantics([opts], [plan], world,
                                                     strict=True)
            cold.append((t1 - t0) * 1e3)
            cached.append((time.perf_counter() - t1) * 1e3)
            if diags:
                raise AssertionError(f"lift: {label}: certify_call gave "
                                     f"{[str(d) for d in diags[:2]]}")
        dags.append(dag)
    seconds["certify"] = time.perf_counter() - t
    emit({"phase": "lift_progress", "gate": 1, "calls": len(calls),
          "seconds": seconds["certify"]})

    # (2) the card against the lifted DAG and the oracle
    t = time.perf_counter()
    facades = {}

    def facade(world, trees):
        if (world, trees) not in facades:
            accl = ACCL(world=world, torch_device=device)
            if trees:
                accl.configure_tuning_parameters(
                    TuningParams(**corpus._TREES))
            facades[(world, trees)] = accl
        return facades[(world, trees)]

    random_bitwise = random_runs = 0
    worst_int8 = 0.0
    nodes = 0
    checked = []
    for (label, opts, plan, world, trees), dag in zip(calls, dags):
        nodes += len(dag.nodes)
        quantized = opts.compress_dtype == DataType.int8
        x = lift_payload(world, dag.in_elems, quantized)
        want = lift_oracle(opts, x)
        ex = hopdag.execute(dag, [[r] for r in x])
        accl = facade(world, trees)
        before = counts_of()
        got, req = lift_facade_run(accl, opts,
                                   torch.from_numpy(x).to(device))
        for name, n in delta(before).items():
            path[name] += n
        req_plan = getattr(req, "plan", None)
        if req_plan is not None and req_plan.algorithm != plan.algorithm:
            raise AssertionError(f"lift: {label}: the facade chose "
                                 f"{req_plan.algorithm.name}, the lift "
                                 f"{plan.algorithm.name}")
        got = got.cpu().numpy()
        bound = (world + 1) * world * float(np.abs(x).max()) / 254 + 1e-5
        for r in range(world):
            if want[r] is None:
                continue
            n = len(want[r])
            g, e = got[r, :n], ex[r][:n]
            if quantized:
                err = max(float(np.abs(g - want[r]).max()),
                          float(np.abs(e - want[r]).max()))
                worst_int8 = max(worst_int8, err / bound)
                ok = err <= bound
            else:
                ok = np.array_equal(g, e) and np.array_equal(g, want[r])
            if not ok:
                raise AssertionError(f"lift: {label}: rank {r} on the card "
                                     "disagrees with hopdag.execute or the "
                                     "oracle")
        if not quantized and dag.in_elems * world <= 1 << 16:
            xr = np.random.default_rng(world).standard_normal(
                (world, dag.in_elems)).astype(np.float32)
            exr = hopdag.execute(dag, [[r] for r in xr])
            gotr, _ = lift_facade_run(accl, opts,
                                      torch.from_numpy(xr).to(device))
            gotr = gotr.cpu().numpy()
            random_runs += 1
            random_bitwise += all(
                np.array_equal(gotr[r, :len(exr[r])], exr[r])
                for r in range(world) if want[r] is not None)
        checked.append((label, opts, dag, x, want, quantized))
    del facades, dags
    seconds["card_vs_dag"] = time.perf_counter() - t
    emit({"phase": "lift_progress", "gate": 2,
          "seconds": seconds["card_vs_dag"]})

    # (3) mutants against execution
    t = time.perf_counter()
    mutants = flagged = 0
    disagreements = []
    for label, opts, dag, x, want, quantized in checked:
        spec = semantics.collective_spec(opts, dag.world)
        kinds = analysis_mutations(dag, quantized)
        bound = (dag.world + 1) * dag.world * float(np.abs(x).max()) / 254 \
            + 1e-5
        for seed in LIFT_SEEDS:
            if not kinds:
                break
            kind = kinds[seed % len(kinds)]
            mut = hopdag.mutate(dag, kind, random.Random(seed))
            if mut is None:
                continue
            mutants += 1
            codes = {d.code for d in semantics.certify(
                mut, spec, opts.scenario.name)}
            flagged += bool(codes)
            outs = hopdag.execute(mut, [[r] for r in x])
            broken = False
            for r in range(dag.world):
                if want[r] is None:
                    continue
                o = outs[r][:len(want[r])]
                broken |= (not np.allclose(o, want[r], rtol=0, atol=bound)
                           if quantized else not np.array_equal(o, want[r]))
            what = f"{label} {kind} seed {seed}"
            if not codes:
                if broken:
                    disagreements.append(f"{what}: certified clean, "
                                         "computes wrong values")
                continue
            if not codes & lift_class_codes(kind) \
                    or not all(c.startswith("ACCL5") for c in codes):
                disagreements.append(f"{what}: flagged {sorted(codes)}")
            if (ReduceFunction(opts.function) == ReduceFunction.SUM
                    and kind in ("drop_combine", "duplicate_combine",
                                 "swap_send_values") and not broken):
                disagreements.append(f"{what}: flagged, computes the "
                                     "oracle's values")
    if disagreements:
        raise AssertionError("lift: certifier/execution disagreements: "
                             + "; ".join(disagreements[:8]))
    seconds["mutants"] = time.perf_counter() - t
    emit({"phase": "lift_progress", "gate": 3, "mutants": mutants,
          "seconds": seconds["mutants"]})

    # (4) tenants on the card
    t = time.perf_counter()
    accl = ACCL(world=8, torch_device=device)
    n = LIFT_TENANT_COUNT
    a_in, a_out, b_in, b_out, shared = (accl.create_buffer(n)
                                        for _ in range(5))

    def program(src, dst):
        seq = accl.sequence()
        seq.allreduce(src, dst, n, ReduceFunction.SUM)
        return seq.compile()

    pa, pb = program(a_in, a_out), program(b_in, b_out)
    cert = InterferenceCertifier()
    accl._interference = cert
    t0 = time.perf_counter()
    if accl.certify_concurrent([pa, pb]) != []:
        raise AssertionError("lift: the disjoint tenants do not certify")
    pair_cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    accl.certify_concurrent([pa, pb])
    pair_cached_ms = (time.perf_counter() - t0) * 1e3
    if cert.escalations or pa.certificate is None \
            or pa.certificate != pb.certificate:
        raise AssertionError("lift: the disjoint pair escalated or is not "
                             "stamped")
    gen = torch.Generator(device=device).manual_seed(1616)
    threads_equal = 0
    for _ in range(3):
        xa = torch.randn((8, n), generator=gen, device=device)
        xb = torch.randn((8, n), generator=gen, device=device)
        a_in.device, b_in.device = xa.clone(), xb.clone()
        pa.run(from_device=True, to_device=True)
        pb.run(from_device=True, to_device=True)
        serial = (a_out.device.clone(), b_out.device.clone())
        a_in.device, b_in.device = xa.clone(), xb.clone()
        a_out.device.zero_()
        b_out.device.zero_()
        errs = []

        def drive(prog):
            try:
                prog.run(from_device=True, to_device=True)
            except Exception as e:  # surfaced below
                errs.append(e)

        ts = [threading.Thread(target=drive, args=(p,)) for p in (pa, pb)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        if errs or not (same_bits(a_out.device, serial[0])
                        and same_bits(b_out.device, serial[1])):
            raise AssertionError(f"lift: two-thread dispatch differs from "
                                 f"the serial composition ({errs})")
        threads_equal += 1
    pw, pv = program(a_in, shared), program(b_in, shared)
    t0 = time.perf_counter()
    ww = accl.certify_concurrent([pw, pv], mode="off")
    ww_ms = (time.perf_counter() - t0) * 1e3
    if [d.code for d in ww] != ["ACCL601"] or pw.certificate is not None:
        raise AssertionError(f"lift: the write/write pair gave {ww}")
    orders = []
    for first, second in ((pw, pv), (pv, pw)):
        a_in.device, b_in.device = xa.clone(), xb.clone()
        first.run(from_device=True, to_device=True)
        second.run(from_device=True, to_device=True)
        orders.append(shared.device.clone())
    if same_bits(*orders):
        raise AssertionError("lift: the rejected pair's A;B equals B;A")
    accl.register_stream_consumer(LIFT_STREAM, lambda y: y)
    streamed = []
    for src, dst in ((a_in, a_out), (b_in, b_out)):
        seq = accl.sequence()
        seq.copy(src, dst, n, res_stream=LIFT_STREAM)
        streamed.append(seq.compile())
    t0 = time.perf_counter()
    st = accl.certify_concurrent(streamed, mode="off")
    stream_ms = (time.perf_counter() - t0) * 1e3
    if [d.code for d in st] != ["ACCL601"] \
            or "stream endpoint" not in st[0].message:
        raise AssertionError(f"lift: the shared stream pair gave {st}")
    del accl, pa, pb, pw, pv, streamed
    seconds["tenants"] = time.perf_counter() - t

    # (5) the flagship batches, default and deep tiers
    t = time.perf_counter()
    cfg = trf.TransformerConfig(**(model_cfg or SERVE_CFG))
    tracer = telemetry.get_tracer()
    tier_ms = {}

    def prepare_tiers(name, record):
        semantics.clear_cache()
        tracer.clear()
        tracer.enable()
        try:
            for lint in ("error", "deep"):
                seq = record(lint)
                seq.compile()
        finally:
            spans = tracer.snapshot()
            tracer.clear()
            tracer.disable()
        lints = [s for s in spans if s["cat"] == "phase"
                 and s["name"] == "lint"]
        if [s["args"].get("tier") for s in lints] != ["error", "deep"]:
            raise AssertionError(f"lift: {name}: lint spans {lints}")
        tier_ms[name] = {s["args"]["tier"]: s["dur_ns"] / 1e6 for s in lints}

    params = trf.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(1717), device)
    saccl = ACCL(world=SERVE_WORLD, torch_device=device)
    sbufs = trf.create_decode_buffers(saccl, cfg, SERVE_BATCH, SERVE_LEN)
    prepare_tiers("serve", lambda lint: trf.record_decode_step(
        saccl, cfg, params, batch=SERVE_BATCH, max_len=SERVE_LEN,
        lint=lint, buffers=sbufs)[0])
    del saccl, sbufs
    torch.cuda.empty_cache() if on_card else None
    taccl = ACCL(world=TRAIN_WORLD, torch_device=device)
    tbufs = trf.create_train_step_buffers(taccl, cfg)
    tok = np.random.default_rng(1717).integers(
        0, cfg.vocab, (TRAIN_WORLD, 1, 16)).astype(np.int32)
    prepare_tiers("train", lambda lint: trf.record_train_step(
        taccl, cfg, tok, np.roll(tok, -1, axis=2), lint=lint,
        buffers=tbufs)[0])
    del taccl, tbufs, params
    torch.cuda.empty_cache() if on_card else None
    seconds["flagship_tiers"] = time.perf_counter() - t

    if on_card:
        idle = [k for k in ("ring_allreduce_bidir", "quantize", "dequantize",
                            "dequant_combine", "dequant_combine_requant",
                            "quant_ring_allreduce", "combine", "cast")
                if not path[k]]
        if idle:
            raise AssertionError(f"the lift path launched no {idle}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "lift", "gpu": card_name() if on_card else "cpu",
          "calls": len(calls), "grid": len(corpus.FAMILY_GRID),
          "counts": list(counts), "dag_nodes": nodes,
          "lift_and_certify_ms": {"total": sum(lifted), "median":
                                  statistics.median(lifted),
                                  "max": max(lifted)},
          "inband_calls": len(cold),
          "certify_call_cold_ms": {"total": sum(cold), "median":
                                   statistics.median(cold),
                                   "max": max(cold)},
          "certify_call_cached_ms": {"total": sum(cached), "median":
                                     statistics.median(cached),
                                     "max": max(cached)},
          "int8_worst_err_over_bound": worst_int8,
          "random_bitwise": f"{random_bitwise}/{random_runs}",
          "mutants": mutants, "flagged": flagged, "disagreements": 0,
          "tenants": {"pair_cold_ms": pair_cold_ms,
                      "pair_cached_ms": pair_cached_ms,
                      "write_write_ms": ww_ms, "stream_pair_ms": stream_ms,
                      "escalations": cert.escalations,
                      "two_thread_runs_bitwise": threads_equal},
          "lint_tier_ms": tier_ms, "seconds": seconds, "launches": path})
    return path


RES_WORLD = 4  # the emulated world's ranks
RES_COUNTS = (1024, 1 << 16)  # elements a rank of the emulator's calls
RES_RECOVERY_COUNT = 1024  # the recovery allreduce (the lift stays small)
RES_VICTIM = 2
RES_LIVE_WORLD = 8
RES_LIVE_SETS = ((0, 1, 2, 3, 4, 5, 6), (1, 3, 5, 7), (2,))
RES_LIVE_COUNTS = (1024, 1 << 20)
RES_LIVE_EAGER = 4 * MIB  # the facade's eager buffer: one segment a call
RES_SEAM_COUNT = 1024  # the 4 KiB allreduce the seam's cost is read on
RES_SEAM_CALLS = 100  # calls a side of each alternating pair
RES_FIT_COUNTS = (1024, 16384, 1 << 18, 1 << 20)  # the card's own fit
SCHED_COUNT = 1 << 18  # elements a rank of each tenant's allreduce
SCHED_REPEATS = 4
SCHED_GROUPS = ((0, 1, 2, 3), (4, 5, 6, 7))


def emu_rows(world: int, count: int, seed: int):
    """Integer-valued fp32 rows from a seed: their sums are exact in any
    fold order, so every schedule gives the same bits."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(-64, 64, size=(world, count)).astype(np.float32)


def emu_collectives(world, xs, count):
    """Run allreduce, bcast (root 2), allgather, alltoall and
    reduce_scatter on every rank of a native world over CPU tensors;
    returns {op: per-rank results}. xs is (W, W*count)."""
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    W = len(world.ranks)

    def body(rank, i):
        row = torch.from_numpy(xs[i])
        head = row[:count].clone()
        out = {}
        out["allreduce"] = torch.zeros(count)
        rank.allreduce(head.clone(), out["allreduce"], count,
                       ReduceFunction.SUM)
        out["bcast"] = head.clone()
        rank.bcast(out["bcast"], count, root=2)
        out["allgather"] = torch.zeros(W * count)
        rank.allgather(head.clone(), out["allgather"], count)
        out["alltoall"] = torch.zeros(W * count)
        rank.alltoall(row.clone(), out["alltoall"], count)
        out["reduce_scatter"] = torch.zeros(count)
        rank.reduce_scatter(row.clone(), out["reduce_scatter"], count,
                            ReduceFunction.SUM)
        return out

    return world.run(body, timeout_s=60)


def facade_collectives(accl, xs, count):
    """The same five collectives through the GPUDevice facade on the same
    rows (staged to the card); returns {op: (W, n) host tensors}."""
    import torch

    from accl_tpu_torch.constants import ReduceFunction

    W = accl.world
    full = torch.from_numpy(xs)
    head = full[:, :count].contiguous()
    out = {}

    def run(name, send, n_out, call):
        sb = accl.create_buffer(send.shape[1], torch.float32, send)
        rb = accl.create_buffer(n_out, torch.float32)
        call(sb, rb)
        out[name] = rb.host.clone()
        accl.free_buffer(sb)
        accl.free_buffer(rb)

    run("allreduce", head, count, lambda s, r: accl.allreduce(
        s, r, count, ReduceFunction.SUM))
    b = accl.create_buffer(count, torch.float32, head)
    accl.bcast(b, count, 2)
    out["bcast"] = b.host.clone()
    accl.free_buffer(b)
    run("allgather", head, W * count,
        lambda s, r: accl.allgather(s, r, count))
    run("alltoall", full, W * count,
        lambda s, r: accl.alltoall(s, r, count))
    run("reduce_scatter", full, count, lambda s, r: accl.reduce_scatter(
        s, r, count, ReduceFunction.SUM))
    return out


def card_link(accl, counts=RES_FIT_COUNTS, reps: int = 20):
    """A LinkParams of the card's own synchronous allreduce: host seconds
    of device-resident calls (the median of `reps`) fitted by
    timing.calibrate against each call's aggregate cost coefficients.
    Returns (link, samples, median relative residual)."""
    import torch

    from accl_tpu_torch.constants import Operation, ReduceFunction
    from accl_tpu_torch.sequencer import timing
    from accl_tpu_torch.sequencer.plan import select_algorithm

    W, dev = accl.world, accl.cclo
    rows = []
    for n in counts:
        sb = accl.create_buffer(n, torch.float32)
        rb = accl.create_buffer(n, torch.float32)
        accl.allreduce(sb, rb, n, ReduceFunction.SUM)  # built, staged
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            accl.allreduce(sb, rb, n, ReduceFunction.SUM, from_device=True,
                           to_device=True)
            times.append(time.perf_counter() - t0)
        plan = select_algorithm(
            Operation.allreduce, n, 4, W, max_eager_size=dev.max_eager_size,
            eager_rx_buf_size=dev.eager_rx_buf_size, tuning=dev.tuning())
        m, b = timing.coefficients_aggregate(
            Operation.allreduce, plan, n, 4, W,
            rx_buf_bytes=dev.eager_rx_buf_size)
        rows.append((m, b, statistics.median(times), plan))
        accl.free_buffer(sb)
        accl.free_buffer(rb)
    link = timing.calibrate([(m, b, t) for m, b, t, _ in rows])
    rel = [abs(link.seconds(m, b) - t) / t for m, b, t, _ in rows]
    return link, [{"count": n, "host_s": t} for n, (_, _, t, _) in
                  zip(counts, rows)], statistics.median(rel)


def resilience_phase(ring, qk, L, native_build, *, device="cuda"):
    """The native emulator, resilience and the degraded allreduce
    (device/emu_device.py, telemetry/native.py's drain_world,
    resilience/, the live-subset allreduce and the armed facade seam).
    Gates, each failing the run:
      (1) libacclrt built by the port from native/src (its seconds, in a
          thread started with the kernels' builds); EmuWorld(4, "local")
          over CPU tensors runs allreduce, bcast, allgather, alltoall and
          reduce_scatter on integer-valued fp32 rows at 1024 and 65 536
          elements a rank, each equal bitwise to the card facade's answer
          on the same rows; drain_world gives one span a call a rank; a
          CUDA tensor operand raises TypeError;
      (2) a rank of the EmuWorld killed mid-stream: every survivor misses
          its NativeDeadlineGuard deadline (the shipped emulator link),
          attribute_silent names the victim, the manager excludes it,
          replans over the 3 survivors (the ring, lifted from the port's
          body), certifies with 0 diagnostics and installs generation 1;
          after flush_rx the survivors' allreduce on the recovery
          communicator equals the numpy survivor oracle bitwise;
      (3) allreduce(mode="live_subset") on the card at W = 8 for three
          survivor sets at 1024 and 1 048 576 elements: equal to the
          numpy survivor oracle bitwise, kernel 7 launched (W-1) times a
          segment, kernel 1 never; certify_call clean on each set at
          1024 and a ghost contribution exactly ACCL501; the call's ms
          beside the ring kernel's full allreduce at the same size;
      (4) the armed seam: a DeadlinePolicy over the card's own fit
          (card_link); armed and disarmed calls bitwise equal with no
          miss; its cost on a 4 KiB allreduce in alternating pairs; a
          tight policy's miss recorded once the shape is warm.
    Prints one "resilience" line and returns each kernel's launches over
    the checked runs of (1) and (3)."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, ReduceFunction
    from accl_tpu_torch.analysis import semantics
    from accl_tpu_torch.communicator import Communicator, Rank
    from accl_tpu_torch.constants import DataType, Operation
    from accl_tpu_torch.descriptor import CallOptions
    from accl_tpu_torch.device import emu_device as emu
    from accl_tpu_torch.device.base import CCLOAddr
    from accl_tpu_torch.resilience import (
        DeadlineMissedError,
        DeadlinePolicy,
        NativeDeadlineGuard,
        ResilienceManager,
        RetryBudget,
    )
    from accl_tpu_torch.sequencer.plan import select_algorithm
    from accl_tpu_torch.sequencer.timing import LinkParams
    from accl_tpu_torch.telemetry import native
    from accl_tpu_torch.telemetry.feedback import default_link

    on_card = device == "cuda"
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts_of, delta = launch_counter(kernels)
    path = dict.fromkeys(kernels, 0)
    seconds = {}
    t_phase = time.perf_counter()

    def add(launched):
        for k, v in launched.items():
            path[k] += v

    # (1) the port's build, its binding, and the emulator against the card
    t = time.perf_counter()
    native_build.join()
    if native_build.error is not None:
        raise AssertionError(f"resilience: libacclrt did not build: "
                             f"{native_build.error}")
    emu.load_native()
    build = {"seconds": native_build.seconds,
             "library": str(emu.library_path().relative_to(
                 emu.BUILD_DIR.parent.parent))}
    W = RES_WORLD
    prev = os.environ.get("ACCL_RT_TRACE")
    os.environ["ACCL_RT_TRACE"] = "1"
    try:
        world = emu.EmuWorld(W, transport="local")
    finally:
        if prev is None:
            os.environ.pop("ACCL_RT_TRACE")
        else:
            os.environ["ACCL_RT_TRACE"] = prev
    accl = ACCL(world=W, torch_device=device)
    emu_calls = 0
    try:
        for n in RES_COUNTS:
            xs = emu_rows(W, W * n, 40 + n)
            got = emu_collectives(world, xs, n)
            before = counts_of()
            want = facade_collectives(accl, xs, n)
            add(delta(before))
            for op, rows in want.items():
                for r in range(W):
                    if not same_bits(got[r][op], rows[r].cpu()):
                        raise AssertionError(
                            f"resilience: emulator {op} at {n} differs "
                            f"from the card facade on rank {r}")
            emu_calls += len(want)
        events, dropped = native.drain_world(world)
        tracks = {}
        for e in events:
            tracks[e["track"]] = tracks.get(e["track"], 0) + 1
        if dropped or tracks != {f"emu/r{r}": emu_calls for r in range(W)}:
            raise AssertionError(f"resilience: drain_world gave {tracks} "
                                 f"(dropped {dropped}), not {emu_calls} "
                                 "spans a rank")
        if on_card:
            try:
                world.ranks[0].start(
                    CallOptions(scenario=Operation.copy, count=4,
                                data_type=DataType.float32),
                    op0=torch.zeros(4, device="cuda"), res=torch.zeros(4))
            except TypeError as e:
                card_refused = ".cpu().contiguous()" in str(e)
            else:
                card_refused = False
            if not card_refused:
                raise AssertionError("resilience: a CUDA operand was "
                                     "not refused")
    finally:
        world.close()
    del accl
    seconds["emulator"] = time.perf_counter() - t

    # (2) kill one rank mid-stream; detect, exclude, replan, recover
    t = time.perf_counter()
    n = RES_RECOVERY_COUNT
    link = default_link()
    pol = DeadlinePolicy(link, world=W)
    pol.arm_reference("allreduce", 0.3)
    budget = RetryBudget(max_retries=1, backoff_base_s=0.01)
    mgr = ResilienceManager(W, policy=pol, budget=budget)
    guard = NativeDeadlineGuard(pol)
    xs = torch.from_numpy(emu_rows(W, n, 77))
    victim = RES_VICTIM
    opts = CallOptions(scenario=Operation.allreduce, count=n,
                       function=int(ReduceFunction.SUM),
                       data_type=DataType.float32)
    world = emu.EmuWorld(W, transport="local")
    try:
        def healthy(rank, i):
            guard.arm(rank, "allreduce", n)
            out = torch.zeros(n)
            h = rank.start(opts, op0=xs[i].clone(), res=out)
            return guard.wait(rank, h, "allreduce", n), out

        for miss, out in world.run(healthy, timeout_s=60):
            if miss is not None or not torch.equal(out, xs.sum(0)):
                raise AssertionError("resilience: the healthy allreduce")
        world.ranks[victim].kill()
        t_detect = time.perf_counter()
        action, attempts, misses = None, 0, []
        while action != "exclude":
            attempts += 1
            if attempts > budget.max_retries + 1:
                raise AssertionError("resilience: the victim was never "
                                     "excluded")

            def attempt(rank, i):
                if i == victim:
                    return None
                guard.arm(rank, "allreduce", n)
                h = rank.start(opts, op0=xs[i].clone(), res=torch.zeros(n))
                try:
                    guard.wait(rank, h, "allreduce", n)
                except DeadlineMissedError as e:
                    return e.miss
                return None

            verdicts = world.run(attempt, timeout_s=60)
            reporters = [i for i, v in enumerate(verdicts) if v is not None]
            if reporters != [r for r in range(W) if r != victim]:
                raise AssertionError(f"resilience: survivors {reporters} "
                                     "missed, not every survivor")
            suspect = mgr.attribute_silent(reporters)
            if suspect != victim:
                raise AssertionError(f"resilience: attribute_silent named "
                                     f"{suspect}, not {victim}")
            misses.append(verdicts[reporters[0]])
            action = mgr.record_miss(dataclasses.replace(
                verdicts[reporters[0]], suspect_rank=suspect,
                attribution="silent"))
        detect_s = time.perf_counter() - t_detect
        survivors = mgr.exclude(victim)
        world.run(lambda rank, i: rank.flush_rx() if i != victim else None,
                  timeout_s=60)
        t0 = time.perf_counter()
        rp = mgr.replan(Operation.allreduce, count=n)
        replan_ms = (time.perf_counter() - t0) * 1e3
        if (rp.certificate["diagnostics"] != 0 or rp.world != W - 1
                or rp.source != "ring" or mgr.install(rp) != 1):
            raise AssertionError(f"resilience: replan {rp}")
        addr = int(CCLOAddr.DYNAMIC_BASE)
        comm = Communicator([Rank(device_index=g, session_id=g)
                             for g in survivors], 0, addr)
        want = xs[list(survivors)].sum(0)

        def recover(rank, i):
            if i == victim:
                return None
            rank.write_communicator(comm)
            guard.arm(rank, "allreduce", n)
            out = torch.zeros(n)
            h = rank.start(dataclasses.replace(opts, comm_addr=addr),
                           op0=xs[i].clone(), res=out)
            if guard.wait(rank, h, "allreduce", n) is not None:
                raise AssertionError("resilience: a recovery call was late")
            return out

        for i, out in enumerate(world.run(recover, timeout_s=60)):
            if i != victim and not torch.equal(out, want):
                raise AssertionError(f"resilience: rank {i}'s recovered "
                                     "allreduce is not the survivor sum")
    finally:
        world.close()
    recovery = {"victim": victim, "survivors": list(survivors),
                "attempts": attempts, "detect_s": detect_s,
                "deadline_s": misses[0].deadline_s,
                "predicted_s": misses[0].predicted_s,
                "replan_ms": replan_ms, "certificate": rp.certificate,
                "generation": mgr.generation,
                "link": {"alpha": link.alpha, "beta": link.beta}}
    seconds["kill_recover"] = time.perf_counter() - t

    # (3) the degraded allreduce on the card
    t = time.perf_counter()
    LW = RES_LIVE_WORLD
    accl = ACCL(world=LW, torch_device=device,
                egr_rx_buf_size=RES_LIVE_EAGER)
    live_rows, live_launches = [], dict.fromkeys(("combine",
                                                  "ring_allreduce_bidir"), 0)
    sel = dict(max_eager_size=accl.cclo.max_eager_size,
               eager_rx_buf_size=accl.cclo.eager_rx_buf_size,
               tuning=accl.cclo.tuning())
    for cnt in RES_LIVE_COUNTS:
        data = emu_rows(LW, cnt, 90 + cnt)
        sb = accl.create_buffer(cnt, torch.float32, torch.from_numpy(data))
        rb = accl.create_buffer(cnt, torch.float32)
        for live in RES_LIVE_SETS:
            before = counts_of()
            req = accl.allreduce(sb, rb, cnt, ReduceFunction.SUM,
                                 mode="live_subset", live_ranks=live)
            launched = delta(before)
            add(launched)
            want = np.tile(data[list(live)].sum(0), (LW, 1))
            if not np.array_equal(rb.host.numpy(), want):
                raise AssertionError(f"resilience: live_subset {live} at "
                                     f"{cnt} is not the survivor oracle")
            folds = req.plan.num_segments * (LW - 1)
            if on_card and (launched.get("combine", 0) != folds
                            or launched.get("ring_allreduce_bidir", 0)):
                raise AssertionError(f"resilience: live_subset launched "
                                     f"{launched}, not {folds} combines")
            for k in live_launches:
                live_launches[k] += launched.get(k, 0)
            if cnt == RES_LIVE_COUNTS[0]:
                o = CallOptions(scenario=Operation.allreduce, count=cnt,
                                function=0, data_type=DataType.float32,
                                live_ranks=live)
                p = select_algorithm(Operation.allreduce, cnt, 4, LW,
                                     live_ranks=live, **sel)
                if p != req.plan or semantics.certify_call(o, p, LW):
                    raise AssertionError(f"resilience: live set {live} "
                                         "does not certify")
        live = RES_LIVE_SETS[0]
        row = {"count": cnt, "live_ranks": list(live)}
        if on_card:
            row["live_ms"] = median_ms(lambda: accl.allreduce(
                sb, rb, cnt, ReduceFunction.SUM, mode="live_subset",
                live_ranks=live, from_device=True, to_device=True))
            row["full_ms"] = median_ms(lambda: accl.allreduce(
                sb, rb, cnt, ReduceFunction.SUM, from_device=True,
                to_device=True))
            row["live_device_ms"] = accl.allreduce(
                sb, rb, cnt, ReduceFunction.SUM, mode="live_subset",
                live_ranks=live, from_device=True,
                to_device=True).get_duration_ns() / 1e6
            row["full_device_ms"] = accl.allreduce(
                sb, rb, cnt, ReduceFunction.SUM, from_device=True,
                to_device=True).get_duration_ns() / 1e6
            row["bound_ms"] = 2 * LW * cnt * 4 / HBM_BYTES_PER_S * 1e3
        # the degraded form recorded into a batch: one graph replay
        seq = accl.sequence()
        seq.allreduce(sb, rb, cnt, ReduceFunction.SUM, mode="live_subset",
                      live_ranks=live)
        rb.host.zero_()
        before = counts_of()
        seq.compile().run()
        add(delta(before))
        if not np.array_equal(rb.host.numpy(), np.tile(
                data[list(live)].sum(0), (LW, 1))):
            raise AssertionError(f"resilience: the recorded live_subset "
                                 f"at {cnt} is not the survivor oracle")
        live_rows.append(row)
        accl.free_buffer(sb)
        accl.free_buffer(rb)
    live = RES_LIVE_SETS[0]
    cnt = RES_LIVE_COUNTS[0]
    o_live = CallOptions(scenario=Operation.allreduce, count=cnt,
                         function=0, data_type=DataType.float32,
                         live_ranks=live)
    o_full = dataclasses.replace(o_live, live_ranks=())
    plan_full = select_algorithm(Operation.allreduce, cnt, 4, LW, **sel)
    ghost = sorted({d.code for d in semantics.certify(
        semantics.lift_call(o_full, plan_full, LW),
        semantics.collective_spec(o_live, LW), "allreduce")})
    if ghost != ["ACCL501"]:
        raise AssertionError(f"resilience: a ghost contribution gave "
                             f"{ghost}, not exactly ACCL501")
    seconds["live_subset"] = time.perf_counter() - t

    # (4) the armed seam on the card, over the card's own fit
    t = time.perf_counter()
    fit, fit_rows, fit_rel = card_link(accl)
    pol = DeadlinePolicy(fit, world=LW,
                         rx_buf_bytes=accl.cclo.eager_rx_buf_size,
                         max_eager_size=accl.cclo.max_eager_size,
                         tuning=accl.cclo.tuning())
    pol.arm_reference("allreduce", fit_rel)
    n = RES_SEAM_COUNT
    data = torch.from_numpy(emu_rows(LW, n, 5))
    sb = accl.create_buffer(n, torch.float32, data)
    rb = accl.create_buffer(n, torch.float32)

    def call():
        accl.allreduce(sb, rb, n, ReduceFunction.SUM, from_device=True,
                       to_device=True)

    accl.allreduce(sb, rb, n, ReduceFunction.SUM)
    plain = rb.host.clone()
    mgr = ResilienceManager(LW, policy=pol)
    accl.arm_resilience(mgr)
    try:
        for _ in range(10):
            accl.allreduce(sb, rb, n, ReduceFunction.SUM)
            if not same_bits(rb.host, plain):
                raise AssertionError("resilience: the armed seam changed "
                                     "a result")
    finally:
        accl.arm_resilience(None)
    if mgr.misses:
        raise AssertionError(f"resilience: the control run missed "
                             f"{len(mgr.misses)} deadlines")
    armed_us, plain_us = [], []
    for _ in range(SEQ_PAIRS):
        for armed, out in ((False, plain_us), (True, armed_us)):
            accl.arm_resilience(mgr if armed else None)
            try:
                call()
                torch.cuda.synchronize() if on_card else None
                t0 = time.perf_counter()
                for _ in range(RES_SEAM_CALLS):
                    call()
                out.append((time.perf_counter() - t0)
                           / RES_SEAM_CALLS * 1e6)
            finally:
                accl.arm_resilience(None)
    if mgr.misses:
        raise AssertionError("resilience: the timed armed calls missed")
    tight = DeadlinePolicy(LinkParams(alpha=1e-12, beta=1e15), world=LW,
                           floor_s=0.0)
    tight.arm_reference("allreduce", 0.0)
    tight.band_floor = 0.0
    tmgr = ResilienceManager(LW, policy=tight)
    accl.arm_resilience(tmgr)
    try:
        accl.allreduce(sb, rb, n - 1, ReduceFunction.SUM)  # a new shape
        warm_misses = len(tmgr.misses)
        accl.allreduce(sb, rb, n - 1, ReduceFunction.SUM)
    finally:
        accl.arm_resilience(None)
    if warm_misses or len(tmgr.misses) != 1:
        raise AssertionError(f"resilience: the tight policy recorded "
                             f"{warm_misses} misses warming, "
                             f"{len(tmgr.misses)} in all, not 0 and 1")
    accl.free_buffer(sb)
    accl.free_buffer(rb)
    del accl
    seam = {"fit": {"alpha_s": fit.alpha, "beta_Bps": fit.beta,
                    "median_rel_residual": fit_rel, "samples": fit_rows},
            "deadline_s_4KiB": pol.deadline_s("allreduce", n),
            "predicted_s_4KiB": pol.predict_s("allreduce", n),
            "plain_us_per_call": statistics.median(plain_us),
            "armed_us_per_call": statistics.median(armed_us),
            "overhead_us_per_call": statistics.median(
                a - p for a, p in zip(armed_us, plain_us)),
            "overhead_us_pairs": [a - p for a, p in zip(armed_us,
                                                         plain_us)],
            "forced_miss": tmgr.misses[0].verdict()}
    seconds["seam"] = time.perf_counter() - t

    if on_card:
        idle = [k for k in ("combine", "ring_allreduce_bidir") if not path[k]]
        if idle:
            raise AssertionError(f"the resilience path launched no {idle}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "resilience", "gpu": card_name() if on_card else "cpu",
          "native_build": build, "emulator_calls": emu_calls,
          "drained_spans": len(events), "recovery": recovery,
          "live_subset": live_rows, "live_launches": live_launches,
          "ghost_codes": ghost, "seam": seam, "seconds": seconds,
          "launches": path})
    return path


def scheduler_phase(ring, qk, L, *, device="cuda", serve_cfg=None,
                    serve_world=SERVE_WORLD, serve_batch=SERVE_BATCH,
                    serve_len=SERVE_LEN):
    """The multi-tenant scheduler (scheduler/) on the card. Gates, each
    failing the run:
      (1) two tenants on the disjoint split() groups of W = 8, each a
          prepared allreduce of SCHED_COUNT elements a rank, certified
          clean together (certify_concurrent), drained under two worker
          threads: the results equal their serial composition bitwise,
          and no dispatch overlapped uncertified;
      (2) a write/write pair (ACCL601) admitted in serial fallback and
          drained under two workers: every dispatch ran, none
          concurrently, the result one of the two serial orders';
      (3) DecodeServer(scheduler=) at serve_phase's widths and requests:
          its tokens equal the server's without a scheduler, bitwise,
          every fused step metered.
    Prints one "scheduler" line (report()'s fairness and certificate
    counts) and returns each kernel's launches over the checked runs."""
    import numpy as np
    import torch

    from accl_tpu_torch import ACCL, ReduceFunction
    from accl_tpu_torch.models import serve
    from accl_tpu_torch.models import transformer as trf
    from accl_tpu_torch.telemetry.metrics import MetricsRegistry

    on_card = device == "cuda"
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts_of, delta = launch_counter(kernels)
    seconds = {}
    t_phase = time.perf_counter()

    # (1) two tenants on disjoint groups
    t = time.perf_counter()
    W, n = 8, SCHED_COUNT
    accl = ACCL(world=W, torch_device=device)
    sched = accl.scheduler(capacity_s=1e9, registry=MetricsRegistry())
    sched.register_tenant("a", priority=1, weight=2.0)
    sched.register_tenant("b", priority=1, weight=1.0)
    progs, outs = {}, {}
    for name, group, seed in (("a", SCHED_GROUPS[0], 1),
                              ("b", SCHED_GROUPS[1], 2)):
        comm = accl.split(list(group))
        x = accl.create_buffer(n, torch.float32,
                               torch.from_numpy(emu_rows(W, n, seed)))
        y = accl.create_buffer(n, torch.float32)
        seq = accl.sequence(comm=comm)
        seq.allreduce(x, y, n, ReduceFunction.SUM)
        progs[name] = seq.compile()
        outs[name] = y
    if accl.certify_concurrent(list(progs.values())):
        raise AssertionError("scheduler: the disjoint pair is not clean")
    for name in progs:
        progs[name].run()
    serial = {name: y.host.clone() for name, y in outs.items()}
    for y in outs.values():
        y.host.zero_()
        y.sync_to_device()
    for name in progs:
        sched.submit(name, progs[name], repeats=SCHED_REPEATS)
    if sched.drain(workers=2) != 2 * SCHED_REPEATS:
        raise AssertionError("scheduler: the pair's dispatches")
    for name, y in outs.items():
        y.sync_from_device()
        if not same_bits(y.host, serial[name]):
            raise AssertionError(f"scheduler: tenant {name}'s result is "
                                 "not its serial composition's")
    rep = sched.report()
    order = [tn for tn, *_ in sorted(sched._history, key=lambda h: h[1])]
    if rep["stats"]["uncertified_concurrent"]:
        raise AssertionError("scheduler: an uncertified overlap")
    pair = {"stats": rep["stats"], "tenants": rep["tenants"],
            "dispatch_order": "".join(order),
            "certificates": sorted({p.certificate for p in progs.values()}),
            "shared": rep["namespaces"]["shared"]}
    seconds["pair"] = time.perf_counter() - t

    # (2) a write/write pair serializes and drops nothing
    t = time.perf_counter()
    sched2 = accl.scheduler(capacity_s=1e9, registry=MetricsRegistry())
    sched2.register_tenant("a")
    sched2.register_tenant("b")
    shared = accl.create_buffer(n, torch.float32)
    ww = {}
    for name, seed in (("a", 3), ("b", 4)):
        x = accl.create_buffer(n, torch.float32,
                               torch.from_numpy(emu_rows(W, n, seed)))
        seq = accl.sequence()
        seq.allreduce(x, shared, n, ReduceFunction.SUM)
        ww[name] = seq.compile()
    orders = []
    for first, second in (("a", "b"), ("b", "a")):
        ww[first].run()
        ww[second].run()
        orders.append(shared.host.clone())
    for name in ww:
        sched2.submit(name, ww[name], repeats=SCHED_REPEATS)
    if sched2.stats["serialized_admissions"] != SCHED_REPEATS:
        raise AssertionError(f"scheduler: the write/write pair admitted "
                             f"{sched2.stats}")
    if sched2.drain(workers=2) != 2 * SCHED_REPEATS:
        raise AssertionError("scheduler: the serial pair dropped work")
    shared.sync_from_device()
    st2 = sched2.stats
    if st2["concurrent_dispatches"] or st2["uncertified_concurrent"] or \
            not any(same_bits(shared.host, o) for o in orders):
        raise AssertionError(f"scheduler: the serial pair {st2}")
    seconds["serial_pair"] = time.perf_counter() - t
    path = counts_of()
    del accl, sched, sched2
    torch.cuda.empty_cache() if on_card else None

    # (3) the DecodeServer seam at the flagship widths
    t = time.perf_counter()
    cfg = trf.TransformerConfig(**(serve_cfg or SERVE_CFG))
    gen = torch.Generator(device=device).manual_seed(1212)
    params = trf.init_params(cfg, gen, device)
    prompts = [(p, new) for _, p, new in serve_requests(cfg.vocab)]
    prompts = [(p[:serve_len // 2], min(new, serve_len // 2 - 1))
               for p, new in prompts]
    tokens = {}
    before = counts_of()
    for label in ("plain", "scheduled"):
        accl = ACCL(world=serve_world, torch_device=device)
        sch = (accl.scheduler(capacity_s=1e9, registry=MetricsRegistry())
               if label == "scheduled" else None)
        srv = serve.DecodeServer(accl, cfg, params, batch=serve_batch,
                                 max_len=serve_len,
                                 registry=MetricsRegistry(), scheduler=sch)
        reqs = [srv.submit(p, new) for p, new in prompts]
        srv.run()
        tokens[label] = [r.generated for r in reqs]
        if sch is not None:
            tenant = sch.tenants.get("serve")
            if tenant.dispatched != srv.n_steps or \
                    sch.stats["uncertified_concurrent"]:
                raise AssertionError(f"scheduler: the serve tenant "
                                     f"dispatched {tenant.dispatched} of "
                                     f"{srv.n_steps} steps")
            serve_report = {"steps": srv.n_steps,
                            "tenant": tenant.account(),
                            "stats": sch.stats,
                            "step_cost_s": srv._step_cost_s}
        del srv, accl
        torch.cuda.empty_cache() if on_card else None
    if tokens["plain"] != tokens["scheduled"]:
        raise AssertionError("scheduler: the scheduled server's tokens "
                             "differ from the plain server's")
    for k, v in delta(before).items():
        path[k] += v
    seconds["serve"] = time.perf_counter() - t

    if on_card:
        idle = [k for k in ("ring_allreduce_bidir", "combine")
                if not path[k]]
        if idle:
            raise AssertionError(f"the scheduler path launched no {idle}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "scheduler", "gpu": card_name() if on_card else "cpu",
          "pair": pair, "serial_pair": st2, "serve": serve_report,
          "tokens": sum(map(len, tokens["plain"])), "seconds": seconds,
          "launches": path})
    return path


DCN_TOPO = {"dcn": 2, "ici": 4}  # the in-process form: P = 2 hosts x L = 4
DCN_AR_COUNTS = (MIB, 25 * MIB // 4)  # the allreduce: 4 and 25 MiB a rank
DCN_OP_ELEMS = 262_144  # a rank's buffer in every other two-tier op
DCN_FLAT_ELEMS = 16_384  # a rank's buffer at one rank a host: 64 segments
DCN_ROOTS = (3, 6)
DCN_CHILD_TIMEOUT_S = 150
DCN_HOP_BYTES = (4 * KIB, 4 * MIB)  # the links' own hop, 2 x 1 children


def dcn_fp32_arith_table():
    """The default table with fp32 arithmetic on the fp16 wire (a hop
    casts to fp16 and back, every fold is fp32): the two-tier compositions
    lower with compressed-domain arithmetic off, as the reference's do."""
    from accl_tpu_torch import DataType
    from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig

    table = dict(DEFAULT_ARITH_CONFIG)
    table[(DataType.float32, DataType.float16)] = ArithConfig(
        4, 2, 0, 0, 1, False, (0, 5))
    return table


def dcn_expected(op: str, wire: str, P: int, L: int) -> dict:
    """Kernel launches one in-process two-tier call makes, from its
    composition: a ring fold is one launch for every line of its tier, so
    an exact allreduce is (L-1) + (P-1) combines; a cast wire adds two
    casts a hop; the int8 allreduce's rings are one encode each, the
    fused steps and a decode a relayed chunk."""
    folds = {"allreduce": (L - 1) + (P - 1),
             "reduce_scatter": (L - 1) + (P - 1),
             "reduce": (L - 1) + (P - 1), "barrier": (L - 1) + (P - 1)}
    if wire == "int8":
        return {"combine": 0, "quantize": 4,
                "dequant_combine_requant": max(L - 2, 0) + max(P - 2, 0),
                "dequant_combine": 2, "dequantize": P + L}
    want = {"combine": folds.get(op, 0)}
    if wire == "float16":
        want["cast"] = 2 * (2 * (L - 1) + 2 * (P - 1))
    return want


def dcn_children(n_procs: int, args, device: str = "cuda"):
    """Start n_procs `python -m accl_tpu_torch.tools.run_dcn` processes on
    cuda:0, their process group (gloo) on 127.0.0.1 at a free port, each
    hop on run_dcn's default link for the device; each checks its rows
    bitwise against its own in-process device. A child that exits
    non-zero or outlives DCN_CHILD_TIMEOUT_S fails the phase (every child still
    running is killed). Returns each child's parsed JSON lines and its
    seconds."""
    import os
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "accl_tpu_torch.tools.run_dcn",
         "--procs", str(n_procs), "--proc-id", str(i), "--port", str(port),
         "--device", device, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ)) for i in range(n_procs)]
    outs, rcs = [], []
    try:
        for p in procs:
            left = max(DCN_CHILD_TIMEOUT_S - (time.perf_counter() - t0), 1.0)
            try:
                outs.append(p.communicate(timeout=left)[0])
                rcs.append(p.returncode)
            except subprocess.TimeoutExpired:
                rcs.append(None)
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if rcs != [0] * n_procs:
        raise AssertionError(f"dcn: run_dcn children exited {rcs}:\n"
                             + "\n---\n".join(o[-3000:] for o in outs))
    lines = [[json.loads(line) for line in out.splitlines()
              if line.startswith("{")] for out in outs]
    for i, out in enumerate(outs):
        if f"proc {i}/{n_procs} OK" not in out:
            raise AssertionError(f"dcn: child {i} printed no RANKS line")
    return lines, time.perf_counter() - t0


def fold_excess(got, terms) -> float:
    """|got - sum(terms)| - (k-1)*u*sum|terms| at its largest (k terms
    stacked on dim 0, each shaped like got): <= 0 inside the recursive
    summation bound of any fold order."""
    t = terms.double()
    ref = t.sum(0)
    bound = (t.shape[0] - 1) * F32_UNIT * t.abs().sum(0)
    worst = float(((got.double() - ref).abs() - bound).max())
    if worst > 0:
        raise AssertionError(f"result outside its fold bound by {worst}")
    return worst


def dcn_phase(ring, qk, L, *, device="cuda"):
    """The multi-host backend (device/dcn_device.py, dcn_transport.py,
    the nine two-tier compositions of sequencer/hierarchical.py). Gates,
    each failing the run:
      (1) in-process: DCNDevice(mesh=make_mesh({"dcn": 2, "ici": 4})) on
          the card; the allreduce at 4 and 25 MiB a rank on the exact,
          fp16 (fp32 arithmetic) and int8 wires, every other two-tier op
          at 262 144 elements a rank's buffer (roots 3 and 6), p2p 1 -> 7
          across the host boundary and host 1's sub-communicator: each
          result bitwise the same call of the port on the CPU (plain
          versions), each exact one within its float64 fold bound
          (movers equal), each call's kernel launches those its
          composition implies (dcn_expected);
      (2) multi-process: 2 run_dcn children x 4 ranks (with the sequence
          stage: recorded batches on the exact and int8 wires, a streamed
          allreduce, stream_put), then 3 x 2 with a cross-host
          sub-communicator of 2 hosts, on cuda:0 on the default link
          (ipc on the card: each hop a device copy into a region the
          peer mapped, the host sending only a token over gloo); each
          child's rows bitwise its own in-process device's, its outer
          bytes the composition's count, a recorded allreduce step's flat
          bytes the flat ring's and its messages one a ring step, and
          none of them staged through the host;
      (3) one rank a host: 2 children x 1 rank on ipc, every stage flat
          across processes on the exact, fp16 and int8 wires at
          DCN_FLAT_ELEMS elements a rank plus the sequence stage; then
          4 x 1, the allreduce, bcast and a 2-host group. Each child's
          flat bytes the flat ring's count (4 194 304 B at 2 x 1 and
          4 MiB), one message a ring step, none staged;
      (4) the two links side by side: the 2 x 4 and 2 x 1 children time
          the exact allreduce at 4 and 25 MiB a rank on a device of each
          link (ipc and gloo) in alternating pairs on the same operands;
          each link's rows bitwise the in-process device's and the other
          link's, its bytes the schedule's count, staged 0 on ipc and
          every byte sent on gloo; the 2 x 1 children also time each
          link's hop alone, no body (4 KiB and 4 MiB, half a round trip,
          its bytes unchanged).
    Prints "dcn" (checks, launches, bytes) and "dcn_timing" (median ms of
    the 4 and 25 MiB allreduce: the two-process devices, 2 x 4 two-tier
    and 2 x 1 flat, on the host clock with the device synchronised, each
    link's median and range, and each link's µs a hop; the in-process
    DCNDevice and the flat GPUDevice (kernel 1) on CUDA events; with the
    card's name and power limit) and returns each kernel's launches over the checked in-process
    calls, and over the children's flat calls (their "dcn_launches"
    lines: every call of the 2 x 1 and 4 x 1 children, the 2 x 4
    children's sequence and stream stages), which must include kernels
    7, 9 and 3-6."""
    import torch

    from accl_tpu_torch import ACCL, DataType, ReduceFunction
    from accl_tpu_torch.device.dcn_device import DCNDevice
    from accl_tpu_torch.device.dcn_transport import link_name
    from accl_tpu_torch.parallel import make_mesh

    on_card = device == "cuda"
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts_of, delta = launch_counter(kernels)
    path = {name: 0 for name in kernels}
    seconds = {}
    t_phase = time.perf_counter()
    P, Lw = DCN_TOPO["dcn"], DCN_TOPO["ici"]
    W = P * Lw
    table = dcn_fp32_arith_table()
    facades = {}
    for where in (device, "cpu"):
        a = ACCL(device=DCNDevice(mesh=make_mesh(DCN_TOPO, world=W,
                                                 device=where)),
                 arith_config=table)
        a.cclo.compiler.arith_table = table  # the lowering reads its own
        facades[where] = a
    accl, cpu = facades[device], facades["cpu"]
    gen = torch.Generator(device=device).manual_seed(1818)

    def data(n):
        return torch.randn((W, n), generator=gen, device=device)

    checks = []
    io = dict(from_device=True, to_device=True)

    def run(op, call, shapes, wire="exact", rows=None, expect=None):
        """`call(facade, *bufs)` on the card and on the CPU over buffers
        of (count, data) shapes, the last one the result; `rows`: the rows
        the call defines (None: every row). Returns the card's result (a
        tensor of its own) and the request."""
        bufs = []
        for count, data in shapes:
            b = accl.create_buffer(count)
            if data is not None:
                b.device.copy_(data)
            bufs.append(b)
        before = counts_of()
        req = call(accl, *bufs)
        if on_card:
            torch.cuda.synchronize()
        moved = delta(before)
        for k, v in moved.items():
            path[k] += v
        cbufs = []
        for count, data in shapes:
            b = cpu.create_buffer(count)
            if data is not None:
                b.device.copy_(data.cpu())
            cbufs.append(b)
        call(cpu, *cbufs)
        got = bufs[-1].device.clone()
        sel = slice(None) if rows is None else rows
        if not same_bits(got.cpu()[sel], cbufs[-1].device[sel]):
            raise AssertionError(f"dcn: {op} ({wire}) differs from the "
                                 "port's CPU run")
        if not torch.isfinite(got[sel]).all():
            raise AssertionError(f"dcn: {op} ({wire}) is not finite")
        if callable(expect):
            expect = expect(req)
        if on_card and expect is not None:
            seen = {k: moved.get(k, 0) for k in expect}
            if seen != expect:
                raise AssertionError(f"dcn: {op} ({wire}) launched {seen}, "
                                     f"its composition {expect}")
        checks.append({"op": op, "wire": wire, "elems": shapes[0][0],
                       "rows": "all" if rows is None else rows,
                       "bitwise_vs_cpu": True, "launches": moved})
        for f, bs in ((accl, bufs), (cpu, cbufs)):
            for b in bs:
                f.free_buffer(b)
        return got, req

    # (1) the in-process form. The allreduce on three wires, two sizes
    t = time.perf_counter()
    for n in DCN_AR_COUNTS:
        x = data(n)
        for wire, dt in (("exact", None), ("float16", DataType.float16),
                         ("int8", DataType.int8)):
            kw = dict(io) if dt is None else dict(io, compress_dtype=dt)
            got, _ = run("allreduce", lambda f, s, d, kw=kw, n=n:
                         f.allreduce(s, d, n, ReduceFunction.SUM, **kw),
                         [(n, x), (n, None)], wire,
                         expect=dcn_expected("allreduce", wire, P, Lw))
            if wire == "exact":
                checks[-1]["bound_excess"] = check_against_float64(
                    got, x, ReduceFunction.SUM, F32_UNIT)
            del got
        del x
    seconds["allreduce"] = time.perf_counter() - t

    # every other op of HIER_OPS on the exact wire, a rank's buffer of
    # DCN_OP_ELEMS elements
    t = time.perf_counter()
    n, c = DCN_OP_ELEMS, DCN_OP_ELEMS // W
    x = data(n)
    got, _ = run("reduce_scatter", lambda f, s, d: f.reduce_scatter(
        s, d, c, ReduceFunction.SUM, **io), [(n, x), (c, None)],
        expect=dcn_expected("reduce_scatter", "exact", P, Lw))
    checks[-1]["bound_excess"] = fold_excess(got, x.reshape(W, W, c))
    got, _ = run("allgather", lambda f, s, d: f.allgather(s, d, c, **io),
                 [(c, x[:, :c].contiguous()), (n, None)],
                 expect=dcn_expected("allgather", "exact", P, Lw))
    if not same_bits(got, x[:, :c].reshape(1, -1).expand(W, n)):
        raise AssertionError("dcn: allgather is not every rank's chunk")
    got, _ = run("alltoall", lambda f, s, d: f.alltoall(s, d, c, **io),
                 [(n, x), (n, None)],
                 expect=dcn_expected("alltoall", "exact", P, Lw))
    if not same_bits(got, x.reshape(W, W, c).transpose(0, 1).reshape(W, n)):
        raise AssertionError("dcn: alltoall is not the transpose")
    for root in DCN_ROOTS:
        got, _ = run(f"bcast/{root}", lambda f, b, r=root: f.bcast(
            b, n, r, **io), [(n, x)],
            expect=dcn_expected("bcast", "exact", P, Lw))
        if not same_bits(got, x[root].expand(W, n)):
            raise AssertionError(f"dcn: bcast from {root}")
        got, _ = run(f"scatter/{root}", lambda f, s, d, r=root: f.scatter(
            s, d, c, r, **io), [(n, x), (c, None)],
            expect=dcn_expected("scatter", "exact", P, Lw))
        if not same_bits(got, x[root].reshape(W, c)):
            raise AssertionError(f"dcn: scatter from {root}")
        got, _ = run(f"gather/{root}", lambda f, s, d, r=root: f.gather(
            s, d, c, r, **io), [(c, x[:, :c].contiguous()), (n, None)],
            rows=[root], expect=dcn_expected("gather", "exact", P, Lw))
        if not same_bits(got[root], x[:, :c].reshape(-1)):
            raise AssertionError(f"dcn: gather to {root}")
        got, _ = run(f"reduce/{root}", lambda f, s, d, r=root: f.reduce(
            s, d, n, r, ReduceFunction.SUM, **io), [(n, x), (n, None)],
            rows=[root], expect=dcn_expected("reduce", "exact", P, Lw))
        checks[-1]["bound_excess"] = fold_excess(got[[root]], x[:, None])
    before = counts_of()
    for f in (accl, cpu):
        f.barrier()
    moved = delta(before)
    for k, v in moved.items():
        path[k] += v
    if on_card and moved.get("combine", 0) != dcn_expected(
            "barrier", "exact", P, Lw)["combine"]:
        raise AssertionError(f"dcn: the barrier launched {moved}")
    checks.append({"op": "barrier", "launches": moved})

    # p2p across the host boundary, and host 1's sub-communicator (the
    # flat inner path: the torch-op ring, W-1 folds a segment)
    def p2p(f, s, d):
        f.send(s, n, src=1, dst=W - 1, tag=3, from_device=True)
        return f.recv(d, n, src=1, dst=W - 1, tag=3, to_device=True)

    got, _ = run("p2p 1->7", p2p, [(n, x), (n, None)], expect={"combine": 0})
    if not same_bits(got[W - 1], x[1]):
        raise AssertionError("dcn: p2p 1 -> 7")
    host1 = list(range(Lw, 2 * Lw))
    m = min(32_768, n)
    got, _ = run("allreduce host 1", lambda f, s, d: f.allreduce(
        s, d, m, ReduceFunction.SUM, comm=f.split(host1), **io),
        [(m, x[:, :m].contiguous()), (m, None)],
        expect=lambda req: {"combine": req.plan.num_segments * (Lw - 1)})
    checks[-1]["bound_excess"] = fold_excess(
        got[host1], x[host1, :m][:, None].expand(Lw, Lw, m))
    if got[:Lw].any():
        raise AssertionError("dcn: the host-1 group wrote host 0's rows")
    del x, got
    seconds["ops"] = time.perf_counter() - t
    if on_card:
        idle = [k for k in ("combine", "cast", "quantize", "dequantize",
                            "dequant_combine", "dequant_combine_requant")
                if not path[k]]
        if idle:
            raise AssertionError(f"the dcn path launched no {idle}")

    # the in-process and flat devices' allreduce times (not counted)
    t = time.perf_counter()
    timing = {}
    flat = ACCL(world=W, torch_device=device)
    for n in DCN_AR_COUNTS:
        row = {}
        for name, f in (("in_process_dcn_ms", accl), ("flat_gpu_ms", flat)):
            s, d = f.create_buffer(n), f.create_buffer(n)
            s.device.copy_(data(n))
            call = (lambda f=f, s=s, d=d, n=n: f.allreduce(
                s, d, n, ReduceFunction.SUM, **io))
            row[name] = median_ms(call, reps=10, warmup=2) if on_card \
                else None
            for b in (s, d):
                f.free_buffer(b)
        timing[str(n * 4)] = row
    del flat, accl, cpu, facades
    if on_card:
        torch.cuda.empty_cache()
    seconds["in_process_timing"] = time.perf_counter() - t

    # (2) the multi-process form: one OS process a host on cuda:0, on the
    # default link (ipc on the card); (4) the timed children run both
    t = time.perf_counter()
    counts = ",".join(str(n) for n in DCN_AR_COUNTS)
    link = link_name(None, device)  # run_dcn's default: ipc on the card
    both_links = ["--time-links", "ipc,gloo"]
    two, two_s = dcn_children(2, ["--local-devices", "4", "--time", counts,
                                  "--sequence", *both_links], device)
    three, three_s = dcn_children(3, ["--local-devices", "2",
                                      "--subset-hosts", "2"], device)
    # (3) one rank a host: every call flat across processes
    flat2, flat2_s = dcn_children(2, [
        "--local-devices", "1", "--wires", "exact,float16,int8",
        "--count", str(DCN_FLAT_ELEMS), "--sequence", "--time", counts,
        "--hop-time", ",".join(str(b) for b in DCN_HOP_BYTES), *both_links],
        device)
    flat4, flat4_s = dcn_children(4, [
        "--local-devices", "1", "--stages", "allreduce,bcast",
        "--subset-hosts", "2", "--count", str(DCN_FLAT_ELEMS)], device)

    def staged_as_its_link(e, what):
        """None staged through the host on ipc, every byte sent on gloo."""
        sent = (e.get("sent", 0), e["flat_sent"])
        staged = (e.get("staged", 0), e["flat_staged"])
        if staged != ((0, 0) if e["link"] == "ipc" else sent):
            raise AssertionError(f"dcn: {what} staged {staged} of {sent} "
                                 f"on the {e['link']} link")

    bytes_rows = []
    for lines in two + three + flat2 + flat4:
        for line in lines:
            for key in ("dcn_bytes", "dcn_sequence"):
                if key not in line:
                    continue
                e = line[key]
                if (e["flat_sent"], e["flat_messages"]) != (
                        e["flat_bytes"], e["flat_want_messages"]):
                    raise AssertionError(f"dcn: {key} {e} is not the flat "
                                         "ring's count")
                if e["link"] != link:
                    raise AssertionError(f"dcn: {key} {e} ran on the "
                                         f"{e['link']} link, not {link}")
                staged_as_its_link(e, key)
                bytes_rows.append(dict(e, line=key))

    def timed_links(tm, n, e, schedule):
        """Each link's timed row: its bytes the schedule's, its staging
        its link's, its rows bitwise (run_dcn held them against the
        in-process device's and each other's); returns the link rows."""
        if set(e["links"]) != {"ipc", "gloo"} or not e["links_bitwise"]:
            raise AssertionError(f"dcn: process {tm['proc']} timed "
                                 f"{e['links']} in a {n}-element allreduce")
        rows = {}
        for name, r in e["links"].items():
            got = {k: r[k] for k in schedule}
            if got != schedule:
                raise AssertionError(f"dcn: process {tm['proc']} sent {got} "
                                     f"on {name} in a {n}-element "
                                     f"allreduce, want {schedule}")
            staged_as_its_link(dict(r, link=name), f"{n}-element {name}")
            rows[name] = {k: r[k] for k in ("median_ms", "min_ms", "max_ms",
                                            "staged", "flat_staged")}
        return rows

    for lines in two:
        tm = next(line["dcn_time"] for line in lines if "dcn_time" in line)
        for n in DCN_AR_COUNTS:
            e = tm["allreduce"][str(n)]
            if e["line_hop_bytes"] != e["composition_line_bytes"] or \
                    e["sent"] != tm["local"] * e["composition_line_bytes"]:
                raise AssertionError(f"dcn: process {tm['proc']} sent {e} "
                                     f"in a {n}-element allreduce")
            links = timed_links(tm, n, e, {
                "sent": e["sent"], "line_hop_bytes": e["line_hop_bytes"],
                "flat_sent": 0})
            bytes_rows.append({"proc": tm["proc"], "procs": tm["procs"],
                               "local": tm["local"], "count": n,
                               "sent": e["sent"],
                               "line_hop_bytes": e["line_hop_bytes"],
                               "composition_line_bytes":
                                   e["composition_line_bytes"],
                               "staged": {k: v["staged"]
                                          for k, v in links.items()}})
            row = timing[str(n * 4)]
            row.setdefault("two_process_host_ms", []).append(e["median_ms"])
            for name, r in links.items():
                row.setdefault(f"two_process_{name}", []).append(
                    {"proc": tm["proc"], **r})
    for lines in flat2:
        tm = next(line["dcn_time"] for line in lines if "dcn_time" in line)
        for n in DCN_AR_COUNTS:
            e = tm["allreduce"][str(n)]
            if (e["flat_sent"], e["flat_messages"]) != (
                    e["flat_bytes"], e["flat_want_messages"]) or \
                    not e["bitwise_vs_in_process"]:
                raise AssertionError(f"dcn: process {tm['proc']} of 2 x 1 "
                                     f"sent {e} in a {n}-element allreduce")
            links = timed_links(tm, n, e, {
                "sent": 0, "flat_sent": e["flat_bytes"],
                "flat_messages": e["flat_want_messages"]})
            bytes_rows.append({"proc": tm["proc"], "procs": tm["procs"],
                               "local": 1, "count": n,
                               "flat_sent": e["flat_sent"],
                               "flat_messages": e["flat_messages"],
                               "flat_bytes": e["flat_bytes"],
                               "flat_staged": {k: v["flat_staged"]
                                               for k, v in links.items()}})
            row = timing[str(n * 4)]
            row.setdefault("flat_2x1_host_ms", []).append(e["median_ms"])
            for name, r in links.items():
                row.setdefault(f"flat_2x1_{name}", []).append(
                    {"proc": tm["proc"], **r})
    # each link's own hop, no body: half a round trip between the 2 x 1
    # children, by size (host clock, the device synchronised)
    hop_us = {}
    for lines in flat2:
        hop = next(line["dcn_hop"] for line in lines if "dcn_hop" in line)
        for name, by_size in hop["us_per_hop"].items():
            for size in DCN_HOP_BYTES:
                us = by_size[str(size)]
                if not all(math.isfinite(u) and u > 0 for u in us):
                    raise AssertionError(f"dcn: a {size}-byte hop on {name} "
                                         f"took {us} us")
                hop_us.setdefault(name, {}).setdefault(str(size), []).append(
                    {"proc": hop["proc"], "us": us})
    if DCN_AR_COUNTS[0] == MIB and any(
            r["count"] == MIB and r["local"] == 1 and r["procs"] == 2
            and r["flat_sent"] != 4_194_304 for r in bytes_rows):
        raise AssertionError("dcn: the 2 x 1 flat allreduce at 4 MiB did "
                             "not send 4 194 304 B")
    seconds["children"] = {"2x4": two_s, "3x2": three_s, "2x1": flat2_s,
                           "4x1": flat4_s}
    # the flat path's launches: each child's counts over its multi-process
    # facade's checked calls (every call at one rank a host; the 2 x 4
    # children's sequence and stream stages)
    flat_path = {name: 0 for name in kernels}
    for children, stages in ((flat2, None), (flat4, None), (two, (
            "sequence", "stream"))):
        for line in (line for lines in children for line in lines):
            if "dcn_launches" not in line:
                continue
            for st, moved in line["dcn_launches"]["by_stage"].items():
                if stages is None or st.startswith(stages):
                    for k, v in moved.items():
                        flat_path[k] += v
    if on_card:
        idle = [k for k in ("combine", "cast", "quantize", "dequantize",
                            "dequant_combine", "dequant_combine_requant")
                if not flat_path[k]]
        if idle:
            raise AssertionError(f"the flat dcn path launched no {idle}")
    seconds["multi_process"] = time.perf_counter() - t
    seconds["phase"] = time.perf_counter() - t_phase
    gpu = card_name() if on_card else "cpu"
    emit({"phase": "dcn", "gpu": gpu, "topology": DCN_TOPO, "link": link,
          "checks": checks, "bytes": bytes_rows, "seconds": seconds,
          "launches": path, "flat_launches": flat_path})
    emit({"phase": "dcn_timing", "gpu": gpu, "link": link,
          "reps": {"in_process": 10, "two_process": 5, "flat_2x1": 5},
          "pairs": "ipc and gloo alternating, same operands",
          "allreduce_bytes_per_rank": timing,
          "hop_us_by_bytes": hop_us, "hop_round_trips": 50})
    return path, flat_path


# the entry points (accl_tpu_torch/examples/, accl_tpu_torch/tools/): the
# generation example on dp2.tp2 (its mesh at --world 4), the dense
# trainer on factorize_devices(8) and the MoE trainer on dp2.ep4 (its
# expert layout at --world 8), at the flagship widths
ENTRY_GEN_BATCH, ENTRY_PROMPT, ENTRY_NEW = 8, 8, 120  # max_len 128
ENTRY_TEMP, ENTRY_SEED = 0.8, 2020
ENTRY_SEQ = 1024  # the trainers' sequence length
ENTRY_STEPS = 2  # steps before and after the checkpoint
ENTRY_WORKERS = 4  # CLI children run at once
ENTRY_CHILD_TIMEOUT_S = 300
# each CLI child as a user runs it, and what its output must hold; a
# tuple of commands runs in order in one job (the second resumes the
# first's checkpoint, written into {ckpt})
ENTRY_CLIS = (
    ("generate", [("examples.generate", "--steps", "16")],
     ("generated=16",)),
    ("generate_sampled",
     [("examples.generate", "--steps", "16", "--temp", "0.8")],
     ("generated=16",)),
    ("train_lm_ckpt",
     [("examples.train_lm", "--steps", "3", "--ckpt", "{ckpt}"),
      ("examples.train_lm", "--steps", "3", "--ckpt", "{ckpt}")],
     ("saved {ckpt}/step_000003", "resumed from {ckpt}/step_000003",
      "saved {ckpt}/step_000006")),
    ("train_lm_moe", [("examples.train_lm", "--model", "moe", "--top-k",
                       "2", "--steps", "2")],
     ("MoE with 4 experts, top-2 routing", "step    1  loss")),
    ("train_lm_pp", [("examples.train_lm", "--pp", "2", "--steps", "2")],
     ("'pp': 2}", "step    1  loss")),
    ("train_lm_remat", [("examples.train_lm", "--remat", "--steps", "2")],
     (" remat\n", "step    1  loss")),
    ("accl_lint_default", [("tools.accl_lint", "--corpus", "--schedules")],
     ("corpus: 50 fixtures (33 known-bad, 17 known-good)",
      "schedules: 374 (scenario, world, root, size, tuning, wire) "
      "configurations interpreted clean")),
    ("accl_lint_interference",
     [("tools.accl_lint", "--interference", "--corpus")],
     ("interference: 114 pairs", "5 concurrent corpus fixtures replayed "
      "clean")),
    ("accl_lint_deep", [("tools.accl_lint", "--deep", "--corpus",
                         "--schedules", "--sample", "64")],
     ("configurations interpreted + model-checked clean",)),
    ("accl_synth", [("tools.accl_synth", "--verify-library")],
     ("  ok  ",)),
    ("accl_trace", [("tools.accl_trace", "--selftest")], ("selftest OK",)),
    ("run_emulator", [("tools.run_emulator", "-n", "4")],
     ("all 4 ranks OK",)),
    ("run_emulator_udp",
     [("tools.run_emulator", "-n", "4", "--transport", "udp")],
     ("all 4 ranks OK",)),
)

def entry_child(name, commands, wants, ckpt):
    """One CLI job: its commands in order, each a child `python -m
    accl_tpu_torch.<module> ...` with no --device (the card); fails
    unless every command exits 0 within ENTRY_CHILD_TIMEOUT_S and the
    output holds every wanted line. Returns its seconds and the tail of
    its output."""
    t0 = time.perf_counter()
    out = ""
    for cmd in commands:
        argv = [a.replace("{ckpt}", ckpt) for a in cmd]
        try:
            p = subprocess.run(
                [sys.executable, "-m", f"accl_tpu_torch.{argv[0]}",
                 *argv[1:]], capture_output=True, text=True,
                timeout=ENTRY_CHILD_TIMEOUT_S,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"entry: {name}: {argv} ran past "
                                 f"{ENTRY_CHILD_TIMEOUT_S} s") from e
        out += p.stdout
        if p.returncode != 0:
            raise AssertionError(f"entry: {name}: {argv} exited "
                                 f"{p.returncode}:\n{p.stdout[-2000:]}\n"
                                 f"{p.stderr[-3000:]}")
    for want in wants:
        want = want.replace("{ckpt}", ckpt)
        if want not in out:
            raise AssertionError(f"entry: {name} printed no {want!r}:\n"
                                 f"{out[-2000:]}")
    if name == "accl_synth" and " FAIL " in out:
        raise AssertionError(f"entry: accl_synth: {out[-2000:]}")
    return {"seconds": time.perf_counter() - t0,
            "last_line": out.strip().splitlines()[-1][:200]}


def entry_phase(ring, qk, L, *, device="cuda"):
    """The entry points (accl_tpu_torch/examples/ and the tools) on the
    card. (a) in process, through the examples' own functions at the
    flagship widths (SERVE_CFG; MOE_CFG's d_model and d_ff), TF32 off.
    Gates, each failing the run:
      (1) generate_tokens on the example's mesh at --world 4 (dp2.tp2),
          batch 8, prompt 8, 120 generated tokens (max_len 128): greedy,
          then at temp 0.8 twice from one seed; every decode step's
          logits within TRAIN_TOL * max|ref| of make_forward's over the
          greedy sequence on the same mesh, each greedy token the argmax
          of its step's logits, the two sampled runs the same tokens,
          kernel 7 16 times a step;
      (2) the dense trainer at factorize_devices(8) (dp2.sp2.tp2) with
          the example's batch rule at seq 1024 (4 x 1024): 2 steps,
          save_checkpoint, latest_checkpoint + restore, 2 more steps in
          a fresh train call, bitwise the stacked parameters of 4
          straight steps; the saved tree re-placed bitwise the stacked
          one (every replica of a leaf equal); kernel 7
          mesh_step_folds() times a step;
      (3) the MoE trainer at --world 8 (dp2.ep4, one expert a rank,
          top-2) with vocab 32 768 and seq 1024, its batch of 16 rows:
          the same 2 + 2 against 4 gate, kernel 7 18 times a step.
    (b) every CLI as a user runs it, each a child `python -m
    accl_tpu_torch...` on the card (ENTRY_CLIS), ENTRY_WORKERS at once:
    each must exit 0 and print its success lines.
    Numbers: ms a decode step and generated tokens/s (CUDA events and
    host clock over the greedy loop), the trainers' ms a step beside
    mesh_phase's leaf step, the checkpoints' bytes and save and restore
    seconds, peak memory, each child's seconds. Returns each kernel's
    launches over the in-process runs (a child's launches are its own
    process's, not counted)."""
    import concurrent.futures
    import shutil
    import tempfile

    import torch

    from accl_tpu_torch.examples import generate as gen_ex
    from accl_tpu_torch.examples import train_lm as train_ex
    from accl_tpu_torch.models import transformer as trf

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kernels = seq_kernels(ring, qk, L)
    for k in kernels.values():
        k.launches = 0
    counts, delta = launch_counter(kernels)
    torch.cuda.reset_peak_memory_stats()
    gpu = card_name()
    path = dict.fromkeys(kernels, 0)
    gates, numbers = {}, {}

    def launched(fn, what, want):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        got = delta(before)
        for k, v in got.items():
            path[k] += v
        if got != {"combine": want}:
            raise AssertionError(f"entry: {what} launched {got}; the "
                                 f"schedule gives {want} of kernel 7")
        return out

    def clocked(fn):
        """fn's result, its CUDA-event ms and its host ms."""
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3

    # (1) generation
    cfg = trf.TransformerConfig(**SERVE_CFG)
    mesh = gen_ex.example_mesh(4, device)
    params = trf.shard_params(trf.init_params(
        cfg, torch.Generator(device=device).manual_seed(ENTRY_SEED), device),
        cfg, mesh)
    B = gen_ex.round_batch(ENTRY_GEN_BATCH, mesh)
    prompt = gen_ex.make_prompt(cfg.vocab, B, ENTRY_PROMPT, ENTRY_SEED)
    total = ENTRY_PROMPT + ENTRY_NEW
    dfold = 2 * cfg.n_layers * ring_folds(mesh.shape["tp"])
    logits = []
    (toks, ev_ms, host_ms) = launched(
        lambda: clocked(lambda: gen_ex.generate_tokens(
            cfg, mesh, params, prompt, ENTRY_NEW, logits=logits)),
        "greedy generation", dfold * (total - 1))
    with torch.no_grad():
        ref = trf.make_forward(cfg, mesh)(params, toks)
    got = torch.stack(logits, 1)
    gates["decode_vs_forward_rel_err"] = check_logits(
        got, ref[:, :total - 1], "decode steps against make_forward")
    if not torch.equal(toks[:, ENTRY_PROMPT:],
                       got[:, ENTRY_PROMPT - 1:].argmax(-1)):
        raise AssertionError("entry: a greedy token is not its step's "
                             "argmax")
    del logits, got, ref
    gates["decode_kernel7_per_step"] = dfold
    numbers.update(decode_steps=total - 1,
                   decode_step_events_ms=ev_ms / (total - 1),
                   decode_step_host_ms=host_ms / (total - 1),
                   generated_tokens_per_s=B * ENTRY_NEW / host_ms * 1e3)
    sampled = [launched(lambda: gen_ex.generate_tokens(
        cfg, mesh, params, prompt, ENTRY_NEW, temp=ENTRY_TEMP,
        generator=torch.Generator(device=device).manual_seed(
            ENTRY_SEED + 1)), "sampled generation", dfold * (total - 1))
        for _ in range(2)]
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError("entry: two sampled runs from one seed "
                             "differ")
    gates["sampled_runs_equal"] = True
    gates["sampled_tokens_differ_from_greedy"] = int(
        (sampled[0] != toks).sum())
    del sampled, toks, params, mesh

    # (2), (3) the trainers: 2 steps, checkpoint, restore, 2 more steps
    # against 4 straight steps, bitwise
    def resumed(run, what, folds):
        params = run.init_params(
            torch.Generator(device=device).manual_seed(ENTRY_SEED))
        placed = run.place(params)
        n = 2 * ENTRY_STEPS
        (straight, _), ev, host = launched(
            lambda: clocked(lambda: train_ex.train(run, placed, 0, n,
                                                   log=None)),
            f"{what}: {n} straight steps", n * folds)
        again = run.place(run.global_params(straight))
        if not all(same_bits(a, b) for a, b in zip(
                trf._tree_leaves(again), trf._tree_leaves(straight))):
            raise AssertionError(f"entry: {what}: a leaf's replicas "
                                 "differ")
        del again
        first, _ = launched(
            lambda: train_ex.train(run, placed, 0, ENTRY_STEPS, log=None),
            f"{what}: {ENTRY_STEPS} steps", ENTRY_STEPS * folds)
        ckpt = tempfile.mkdtemp(prefix="entry-ckpt-")
        try:
            t0 = time.perf_counter()
            saved = train_ex.save_checkpoint(run, first, ckpt, ENTRY_STEPS)
            save_s = time.perf_counter() - t0
            nbytes = (saved / train_ex.CKPT_FILE).stat().st_size
            del first
            t0 = time.perf_counter()
            latest = train_ex.latest_checkpoint(ckpt)
            restored = run.place(train_ex.restore(latest))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(ckpt)
        if latest != saved:
            raise AssertionError(f"entry: {what}: latest_checkpoint gave "
                                 f"{latest}, not {saved}")
        second, _ = launched(
            lambda: train_ex.train(run, restored, ENTRY_STEPS, ENTRY_STEPS,
                                   log=None),
            f"{what}: {ENTRY_STEPS} resumed steps", ENTRY_STEPS * folds)
        if not all(same_bits(a, b) for a, b in zip(
                trf._tree_leaves(second), trf._tree_leaves(straight))):
            raise AssertionError(f"entry: {what}: {ENTRY_STEPS} + "
                                 f"{ENTRY_STEPS} resumed steps are not "
                                 f"{n} straight steps bitwise")
        gates[f"{what}_resumed_bitwise"] = True
        gates[f"{what}_kernel7_per_step"] = folds
        tokens = run.tokens.numel()
        numbers[what] = {
            "axes": run.axes, "tokens": list(run.tokens.shape),
            "step_events_ms": ev / n, "step_host_ms": host / n,
            "tokens_per_s": tokens / (host / n) * 1e3,
            "checkpoint_bytes": nbytes, "save_s": save_s,
            "restore_s": restore_s}

    dense = train_ex.dense_run(8, device=device, cfg=cfg, seq=ENTRY_SEQ)
    resumed(dense, "dense", mesh_step_folds(cfg, dense.axes))
    del dense
    torch.cuda.empty_cache()
    mrun = train_ex.moe_run(8, top_k=2, device=device,
                            d_model=MOE_CFG["d_model"],
                            d_ff=MOE_CFG["d_ff"], vocab=SERVE_CFG["vocab"],
                            seq=ENTRY_SEQ)
    dp, ep = mrun.axes["dp"], mrun.axes["ep"]
    resumed(mrun, "moe", 6 * ring_folds(dp) + 4 * ring_folds(ep))
    del mrun
    leaf = MESH_TIMES.get("train_leaf")
    if leaf is not None:
        numbers["mesh_train_leaf"] = {
            "step_events_ms": leaf["events_ms_p50"],
            "tokens": [MESH_BATCH, MESH_SEQ],
            "tokens_per_s": MESH_BATCH * MESH_SEQ
            / leaf["events_ms_p50"] * 1e3}
    numbers["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    t_inproc = time.perf_counter() - t_phase

    # (b) every CLI as a user runs it
    children = {}
    ckpt = tempfile.mkdtemp(prefix="entry-cli-ckpt-")
    try:
        with concurrent.futures.ThreadPoolExecutor(ENTRY_WORKERS) as pool:
            jobs = {name: pool.submit(entry_child, name, cmds, wants, ckpt)
                    for name, cmds, wants in ENTRY_CLIS}
            for name, job in jobs.items():
                children[name] = job.result()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "entry", "gpu": gpu, "config": SERVE_CFG,
          "moe_widths": {k: MOE_CFG[k] for k in ("d_model", "d_ff")},
          "generation": {"axes": {"dp": 2, "sp": 1, "tp": 2}, "batch": B,
                         "prompt": ENTRY_PROMPT, "new": ENTRY_NEW,
                         "temp": ENTRY_TEMP},
          "tolerance": TRAIN_TOL, "gates": gates, "numbers": numbers,
          "children": children, "in_process_s": t_inproc,
          "phase_s": time.perf_counter() - t_phase, "launches": path})
    return path


# each bench_emulator child of the sweep phase: (transport, world), the
# default --iters
SWEEP_BENCH = (("tcp", 4), ("tcp", 8), ("local", 4), ("udp", 4))
SWEEP_CHILD_TIMEOUT_S = 300
# the card's profile in the reference's format (bench.py's profile.csv,
# Test,Bytes,Seconds,GBps,Regime): kernel 7's fp32 SUM at these bytes an
# operand, and the world-1 facade allreduce's dispatch at these bytes
SWEEP_COMBINE_BYTES = (KIB, 16 * KIB, 256 * KIB, 4 * MIB, 64 * MIB, 1 << 30)
SWEEP_DISPATCH_BYTES = (4 * KIB, 256 * KIB, 16 * MIB)
SWEEP_STREAM_BYTES = 256 * MIB  # Regime "stream" from here up (bench.py)
SWEEP_REPS = 20
# CUDA events resolve about 0.5 us: a combine whose median is within this
# of an empty event pair's is Regime "noise" (a resolution floor)
EVENT_RESOLUTION_MS = 0.0005
HBM_GBPS = HBM_BYTES_PER_S / 1e9


def sweep_child(module: str, *args: str):
    """One tool child, `python -m accl_tpu_torch.tools.<module> ...`, run
    alone (its seconds are host time, which siblings would distort);
    fails unless it exits 0 within SWEEP_CHILD_TIMEOUT_S. Returns its
    seconds, stdout and stderr."""
    t0 = time.perf_counter()
    argv = [sys.executable, "-m", f"accl_tpu_torch.tools.{module}", *args]
    try:
        p = subprocess.run(argv, capture_output=True, text=True,
                           timeout=SWEEP_CHILD_TIMEOUT_S,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"sweep: {argv[2:]} ran past "
                             f"{SWEEP_CHILD_TIMEOUT_S} s") from e
    if p.returncode != 0:
        raise AssertionError(f"sweep: {argv[2:]} exited {p.returncode}:\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    return time.perf_counter() - t0, p.stdout, p.stderr


def held_samples(fn, reps: int = SWEEP_REPS, tries: int = 3):
    """`reps` single calls of fn, each between two CUDA events with a spin
    kernel holding the stream while the host enqueues it (the host held
    off): the events time the card's work alone. A sample whose spin
    ended first is taken again with twice the spin, at most `tries`
    times in all. Returns each sample's ms, fn's last result and the
    calls made (2 + reps + the samples taken again)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int((3 * host_s + 1e-3) * spin_cycles_per_s())
    times, missed, calls = [], 0, 2
    while len(times) < reps:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        e0.record()
        out = fn()
        calls += 1
        e1.record()
        held = not e0.query()
        e1.synchronize()
        if held:
            times.append(e0.elapsed_time(e1))
            continue
        missed += 1
        if missed >= tries:
            raise AssertionError(f"spin ended before the call was "
                                 f"enqueued, {tries} times")
        spin *= 2
    return times, out, calls


def sweep_profile(L, kernels, path: str):
    """The card's profile (tools/timing_model's --profile input), written
    to `path` in the reference's format, and its rows. combine_sum_fp32:
    kernel 7 on (1, n) fp32 operands at SWEEP_COMBINE_BYTES each, the
    median of held_samples (host held off); GBps = Bytes / Seconds;
    Regime "stream" from SWEEP_STREAM_BYTES, "latency" below, "noise"
    where the median is within EVENT_RESOLUTION_MS of an empty event
    pair's. The 1 GiB result is held bitwise against kernel 7's plain
    version on the same operands. allreduce_w1_dispatch_datapath_fp32:
    one facade allreduce on GPUDevice(1) at SWEEP_DISPATCH_BYTES, device
    buffers in and out, the host clock around the call and a
    synchronize, median of SWEEP_REPS after 3 warm-up calls (the
    reference's host-observed per-dispatch cost); its result must be its
    operand bitwise. Returns the rows, each dispatch size's launches and
    the empty event pair's median ms."""
    import torch

    from accl_tpu_torch import ACCL
    from accl_tpu_torch.constants import ReduceFunction
    from accl_tpu_torch.device.gpu_device import GPUDevice

    counts, delta = launch_counter(kernels)
    gen = torch.Generator(device="cuda").manual_seed(2121)
    floor = statistics.median(held_samples(lambda: None)[0])
    rows = []
    for nbytes in SWEEP_COMBINE_BYTES:
        n = nbytes // 4
        a = torch.randn((1, n), generator=gen, device="cuda")
        b = torch.randn((1, n), generator=gen, device="cuda")
        before = counts()
        times, out, calls = held_samples(lambda: L.combine(a, b, "sum"))
        if delta(before) != {"combine": calls}:
            raise AssertionError(f"sweep: {calls} combine calls launched "
                                 f"{delta(before)}")
        ms = statistics.median(times)
        if nbytes == SWEEP_COMBINE_BYTES[-1]:
            plain = L._combine_impl(a, b, "sum")
            if not same_bits(out, plain):
                raise AssertionError("sweep: the 1 GiB combine differs from "
                                     "kernel 7's plain version")
            del plain
        del a, b, out
        regime = ("noise" if ms <= floor + EVENT_RESOLUTION_MS
                  else "stream" if nbytes >= SWEEP_STREAM_BYTES
                  else "latency")
        rows.append(("combine_sum_fp32", nbytes, ms * 1e-3,
                     nbytes / (ms * 1e-3) / 1e9, regime))
    torch.cuda.empty_cache()
    accl = ACCL(device=GPUDevice(1))
    dispatch_launches = {}
    for nbytes in SWEEP_DISPATCH_BYTES:
        n = nbytes // 4
        sb, rb = accl.create_buffer(n), accl.create_buffer(n)
        sb.device.copy_(torch.randn((1, n), generator=gen, device="cuda"))

        def call():
            accl.allreduce(sb, rb, n, ReduceFunction.SUM, from_device=True,
                           to_device=True)
            torch.cuda.synchronize()

        before = counts()
        call()
        dispatch_launches[nbytes] = delta(before)
        if not same_bits(rb.device, sb.device):
            raise AssertionError("sweep: the world-1 allreduce changed its "
                                 "operand")
        for _ in range(2):
            call()
        secs = []
        for _ in range(SWEEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            secs.append(time.perf_counter() - t0)
        s = statistics.median(secs)
        rows.append(("allreduce_w1_dispatch_datapath_fp32", nbytes, s,
                     nbytes / s / 1e9, "latency"))
        accl.free_buffer(sb)
        accl.free_buffer(rb)
    with open(path, "w") as f:
        f.write("Test,Bytes,Seconds,GBps,Regime\n")
        for t, nb, s, g, regime in rows:
            f.write(f"{t},{nb},{s:.6e},{g:.3f},{regime}\n")
    return rows, dispatch_launches, floor


def sweep_phase(ring, qk, L):
    """The emulator measuring tools (accl_tpu_torch/tools/bench_emulator,
    rt_stats_sweep, timing_model) and the card's own on-chip tier, every
    output in a temporary directory, every child run alone (its seconds
    are host time of the machine that holds the card, not card work):
      (1) bench_emulator at SWEEP_BENCH (-n 4 and -n 8 on tcp, -n 4 on
          local and udp), default --iters;
      (2) rt_stats_sweep's default grid (W 8, allreduce/bcast/allgather at
          64 KiB, 1 and 4 MiB, tcp), one child a config through the
          tool's run_child/summarize/write_csv;
      (3) the card's profile (sweep_profile): kernel 7 and the world-1
          facade allreduce on the card;
      (4) timing_model --sweep-dir --profile --out as a child;
      (5) ACCL(GPUDevice(8)).autotune(tier="tpu") on that model.
    Gates, each failing the run: every child exits 0; each sweep 40 rows
    a world and transport less the announced skips, which are exactly
    the skip rule's; every Protocol protocol_label's and the committed
    accl_log/emu_bench*.csv's (read only) wherever it holds the same
    (Collective, Bytes, World); every rt_stats config spans > 0,
    span_dropped 0, retcodes [0]; the 1 GiB combine bitwise its plain
    version; the fit's six sections present and its medians finite; the
    tier's 3 x hbm_stream_gbps at most the card's 3 350 GB/s; the
    registers autotune applies equal the ones derived by hand from the
    tier's link. Returns each kernel's launches over (3) and (5)."""
    import csv
    import shutil
    import tempfile

    import torch

    from accl_tpu_torch import ACCL
    from accl_tpu_torch.constants import TuningParams
    from accl_tpu_torch.device import emu_device
    from accl_tpu_torch.device.gpu_device import GPUDevice
    from accl_tpu_torch.sequencer.timing import LinkParams, tuning_crossovers
    from accl_tpu_torch.tools import bench_emulator as be
    from accl_tpu_torch.tools import rt_stats_sweep as rts

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    kernels = seq_kernels(ring, qk, L)
    counts, _ = launch_counter(kernels)
    gates, children = {}, {}
    tmp = tempfile.mkdtemp(prefix="sweep-")
    try:
        # (1) the emulator sweeps
        skips = {}
        for transport, world in SWEEP_BENCH:
            secs, out, err = sweep_child(
                "bench_emulator", "-n", str(world), "--transport", transport,
                "--out-dir", tmp)
            children[f"bench_emulator_{transport}_w{world}"] = secs
            announced = sum("SKIPPED" in ln for ln in err.splitlines())
            want = sum(be.skipped(name, be.protocol_label(
                name, nb // 4, world, transport), nb, world)
                for nb in be.SIZES for name in be.COLLECTIVES)
            if announced != want:
                raise AssertionError(f"sweep: {transport} w{world} "
                                     f"announced {announced} skips, the "
                                     f"rule gives {want}")
            skips[(transport, world)] = announced
        rows_a_sweep, matched = {}, 0
        for transport, name in be.CSV_NAMES.items():
            with open(os.path.join(tmp, name)) as f:
                got = list(csv.DictReader(f))
            with open(os.path.join(here, "accl_log", name)) as f:
                committed = {(r["Collective"], r["Bytes"], r["World"]):
                             r["Protocol"] for r in csv.DictReader(f)}
            for (tr, world), skipped in skips.items():
                if tr != transport:
                    continue
                n = sum(r["World"] == str(world) for r in got)
                if n != len(be.SIZES) * len(be.COLLECTIVES) - skipped:
                    raise AssertionError(f"sweep: {name} holds {n} rows at "
                                         f"w{world} ({skipped} skipped)")
                rows_a_sweep[f"{transport}_w{world}"] = n
            for r in got:
                want = be.protocol_label(r["Collective"], int(r["Bytes"]) // 4,
                                         int(r["World"]), transport)
                key = (r["Collective"], r["Bytes"], r["World"])
                if r["Protocol"] != want or committed.get(key, want) != want:
                    raise AssertionError(f"sweep: {name} {key} Protocol "
                                         f"{r['Protocol']}, rule {want}, "
                                         f"committed {committed.get(key)}")
                matched += key in committed
        gates.update(rows_a_sweep=rows_a_sweep, skips=sum(skips.values()),
                     protocols_match_rule=True,
                     protocols_match_committed_rows=matched)

        # (2) the counter sweep, one child a config, one at a time
        emu_device.load_native()
        rt_rows, t0 = [], time.perf_counter()
        for world in map(int, rts.WORLDS.split(",")):
            for name in rts.COLLECTIVES.split(","):
                for nb in map(int, rts.SIZES.split(",")):
                    rep = rts.run_child(name, nb, world, "tcp", rts.ITERS)
                    if rep is None:
                        raise AssertionError(f"sweep: rt_stats {name} {nb} "
                                             f"w{world} failed")
                    if (rep["spans"] <= 0 or rep["span_dropped"] != 0
                            or rep["retcodes"] != [0]):
                        raise AssertionError(
                            f"sweep: rt_stats {name} {nb} w{world}: spans "
                            f"{rep['spans']}, dropped {rep['span_dropped']},"
                            f" retcodes {rep['retcodes']}")
                    rt_rows.append(rts.summarize(rep, name, nb, world,
                                                 "tcp", rts.ITERS))
        rts.write_csv(rt_rows, os.path.join(tmp, "rt_stats.csv"))
        children["rt_stats_sweep"] = time.perf_counter() - t0
        gates["rt_stats_configs_clean"] = len(rt_rows)

        # (3) the card's profile: the path, counts set to 0 just before
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        profile = os.path.join(tmp, "profile.csv")
        prof_rows, dispatch_launches, floor = sweep_profile(L, kernels,
                                                            profile)
        profile_s = time.perf_counter() - t0
        gates["combine_1gib_bitwise_plain"] = True

        # (4) the fit
        model_path = os.path.join(tmp, "timing_model.json")
        secs, fit_out, _ = sweep_child(
            "timing_model", "--sweep-dir", tmp, "--profile", profile,
            "--out", model_path)
        children["timing_model"] = secs
        with open(model_path) as f:
            model = json.load(f)
        for key in ("link_per_collective", "fit", "rows", "local_poe_tier",
                    "udp_poe_tier", "tuning_crossovers"):
            if not model.get(key):
                raise AssertionError(f"sweep: the model has no {key}")
        medians = {
            "main": model["fit"]["median_pred_over_meas"],
            "holdout": model["fit"]["median_holdout_pred_over_meas"],
            "local": model["local_poe_tier"]["fit"]["median_pred_over_meas"],
            "udp": model["udp_poe_tier"]["fit"]["median_pred_over_meas"]}
        if not all(isinstance(v, float) and math.isfinite(v)
                   for v in medians.values()):
            raise AssertionError(f"sweep: a median is not finite: {medians}")
        tier = model["tpu_tier"]
        if not tier or not tier.get("hbm_stream_gbps"):
            raise AssertionError(f"sweep: no card tier: {tier}")
        if 3 * tier["hbm_stream_gbps"] > HBM_GBPS:
            raise AssertionError(
                f"sweep: 3 x {tier['hbm_stream_gbps']} GB/s of HBM traffic "
                f"exceeds the card's {HBM_GBPS}: a broken timer")
        gates["fit_sections_and_medians"] = True
        gates["tier_hbm_traffic_within_card"] = True

        # (5) autotune on the card's tier
        accl = ACCL(device=GPUDevice(8))
        applied = accl.autotune(tier="tpu", timing_model_path=model_path)
        link = LinkParams(alpha=tier["dispatch_alpha_us"] * 1e-6,
                          beta=tier["hbm_stream_gbps"] * 1e9)
        want = TuningParams.from_crossovers(tuning_crossovers(link, world=8))
        if (vars(applied) != vars(want)
                or vars(accl.cclo.tuning()) != vars(want)):
            raise AssertionError(f"sweep: autotune applied {vars(applied)},"
                                 f" the tier's link gives {vars(want)}")
        gates["autotune_registers_equal"] = True
        path = counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "sweep", "gpu": card_name(), "gates": gates,
          "children_s": children,
          "rt_stats": [dict(zip(("collective", "bytes", "world", "ms_a_call",
                                 "passes", "parks", "park_ms", "seek_hit",
                                 "seek_miss", "agg_wire_gbps"),
                                (r[0], r[1], r[2], r[5] * 1e3, *r[6:])))
                       for r in rt_rows],
          "fit": {"link_per_collective": model["link_per_collective"],
                  "medians": medians, "worlds": model["fit"]["worlds"]},
          "profile": [dict(zip(("test", "bytes", "seconds", "gbps",
                                "regime"), r)) for r in prof_rows],
          "event_pair_floor_ms": floor, "profile_s": profile_s,
          "dispatch_launches": {str(k): v
                                for k, v in dispatch_launches.items()},
          "card_tier": {k: tier[k] for k in (
              "dispatch_alpha_us", "dispatch_beta_gbps", "hbm_stream_gbps",
              "projected_crossovers")},
          "applied_registers": vars(applied), "fit_stdout": fit_out,
          "phase_s": time.perf_counter() - t_phase, "launches": path})
    return path


class NativeBuild(threading.Thread):
    """The native emulator's g++ build, started beside the kernels' nvcc
    builds; its seconds and any error are read after join()."""

    def __init__(self):
        super().__init__(daemon=True)
        self.error = None
        self.seconds = None

    def run(self):
        from accl_tpu_torch.device import emu_device

        t = time.perf_counter()
        try:
            emu_device.build_native()
        except Exception as e:  # reported by the resilience phase
            self.error = e
        self.seconds = time.perf_counter() - t


def kernel_line(ring, qk, errs, launches, ring_row, lane_rows, quant_rows,
                path_launches):
    """Per kernel: device time per launch at the main path's launch
    shape with the host held off (device_ms), its plain version and the
    library yardstick, timed the same way. Ring kernels: W=8, fp32, 4 MiB
    per rank, with events around back-to-back launches beside it
    (`back_to_back_ms`, which times the host once the wrapper's host cost
    exceeds the device's); their plain version back to back. The four
    quantized step kernels: the rows of quant_shapes_phase, each at the
    largest launch shape of its path (the packed entries for kernels 5
    and 6). The closed-form int8 ring: the row of
    its breakdown, (8, 1 048 576) fp32, one 4 MiB segment at W=8. Lane
    kernels: the rows of the lane breakdown. Kernel 1's launches count
    its indirect entry too (a captured sequence's in-place steps tick the
    direct wrapper of the same direction count). `sequence_launches`: each
    kernel's launches over the sequence phase's checked runs (its eager
    twins, and the warm-up run and capture at compile; a replay runs
    the captured kernels without the host's wrappers); `p2p_launches`,
    `comm_launches`, `alltoall_launches`, `tuned_launches`,
    `telemetry_launches`, `serve_launches`, `train_launches`,
    `moe_launches`, `mesh_launches`, `analysis_launches`,
    `lift_launches`, `resilience_launches`, `scheduler_launches`,
    `dcn_launches`, `dcn_flat_launches`, `entry_launches` and
    `sweep_launches` likewise over the checked runs of the
    point-to-point, sub-communicator, alltoall, tuned, telemetry, serve,
    train, MoE, mesh, analysis, lift, resilience, scheduler, multi-host
    (the flat calls across processes apart), entry-point (the examples'
    in-process runs) and sweep paths (the card's profile: kernel 7's
    combine rows and the world-1 allreduce's dispatch rows)."""
    import torch

    world, n = 8, SEG_BYTES // 4
    gen = torch.Generator(device="cuda").manual_seed(99)
    x = rank_data(world, n, torch.float32, gen)
    bound_ms = 2 * world * n * 4 / HBM_BYTES_PER_S * 1e3
    library_ms = device_ms(
        lambda: x.sum(0, keepdim=True).expand_as(x).contiguous())
    entries = []
    for name, kernel, plain, replaces, main_path in (
            ("ring_allreduce_bidir", ring.ring_allreduce_bidir,
             ring.ring_allreduce_bidir_ref,
             "accl_tpu/ops/ring_allreduce.py:303", True),
            ("ring_allreduce", ring.ring_allreduce, ring.ring_allreduce_ref,
             "accl_tpu/ops/ring_allreduce.py:151", False)):
        entries.append({
            "name": name, "route": "cuda",
            "source": "accl_tpu_torch/csrc/ring_allreduce.cu",
            "replaces": replaces, "on_main_path": main_path,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": device_ms(lambda: kernel(x, world)),
            "back_to_back_ms": run_ms(lambda: kernel(x, world)),
            # the plain version's ~100 launches a call fill the launch
            # queue behind a spin: timed back to back, device-bound
            "plain_ms": run_ms(lambda: plain(x, world)),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
            "shape": {"world": world, "n": n, "dtype": "float32"}})
    for name, row in quant_rows.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": "accl_tpu_torch/csrc/quant_wire.cu",
            "replaces": QUANT_KERNELS[name], "on_main_path": True,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "entry": row["entry"],
            "cold_device_ms": row["cold_device_ms"][1],
            "launches_x_gap_ms": row["launches_x_gap_ms"],
            "shape": {"rows": row["shape"][0], "n": row["shape"][1],
                      "dtype": "float32"}})
    entries.append({
        "name": QUANT_RING[0], "route": "cuda",
        "source": "accl_tpu_torch/csrc/quant_wire.cu",
        "replaces": QUANT_RING[1], "on_main_path": True,
        "launches": launches[QUANT_RING[0]],
        "max_abs_err": errs[QUANT_RING[0]], "ms": ring_row["device_ms"],
        "back_to_back_ms": ring_row["back_to_back_ms"],
        "plain_ms": ring_row["plain_ms"], "bound_ms": ring_row["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "torch_op_ring_ms": ring_row["torch_op_ring_ms"],
        "shape": {"world": world, "n": n, "dtype": "float32"}})
    for name in LANE_KERNELS:
        row = lane_rows[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "accl_tpu_torch/csrc/lanes.cu",
            "replaces": LANE_KERNELS[name], "on_main_path": True,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"], "shape": row["shape"]})
    for entry in entries:
        for path, counted in path_launches.items():
            entry[f"{path}_launches"] = counted[entry["name"]]
    emit({"kernels": entries})


def main(argv: list[str] | None = None) -> int:
    """`chip_smoke.py` runs every phase; `chip_smoke.py v3_moe` the kernels'
    build and DeepSeek-V3's MoE phase alone."""
    import torch

    only = sys.argv[1:] if argv is None else argv
    if only not in ([], ["v3_moe"]):
        print(f"chip_smoke: unknown arguments {only}", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from accl_tpu_torch.ops import _build
        from accl_tpu_torch.ops import lane_kernels as L
        from accl_tpu_torch.ops import quant_kernels as qk
        from accl_tpu_torch.ops import ring_allreduce as ring
    except ImportError as e:
        print(f"chip_smoke: run from the root of an accl-tpu checkout ({e})",
              file=sys.stderr)
        return 2

    smi = card_name()
    print(smi, flush=True)
    if only:  # its one library builds at its first launch
        t = time.perf_counter()
        v3 = v3_moe_phase()
        emit({"phase": "clock", "seconds": {
            "v3_moe_phase": round(time.perf_counter() - t, 1)},
            "v3_moe_launches": v3})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    t0 = time.perf_counter()
    # the native emulator's g++ build runs beside the kernels' nvcc builds
    native_build = NativeBuild()
    native_build.start()
    # the kernels, and the ipc link's CUDA IPC binding (dcn_phase)
    sources = ("ring_allreduce", "quant_wire", "lanes", "ipc_link", "moe")
    _build.load_libraries(list(sources))  # one nvcc each, started together
    ptxas = {name: sorted(set(
        line.split("info    : ")[-1].strip()
        for line in _build.build_log.get(name, "").splitlines()
        if "registers" in line or "spill" in line)) for name in sources}
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": {name: _build.build_seconds[name] for name in sources},
          "load_s": time.perf_counter() - t0, "ptxas": ptxas})

    clock = {}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        clock[fn.__name__] = round(time.perf_counter() - t, 1)
        return out

    errs = timed(kernel_phase, ring)
    errs.update(timed(quant_kernel_phase, qk))
    errs.update(timed(quant_ring_phase, qk))
    errs.update(timed(lane_kernel_phase, L))
    # each path runs with its kernels' counts set to 0 just before it
    accl, kept, launches = timed(facade_phase, ring)  # the exact wire
    qlaunches, qaccl, qkept = timed(quant_facade_phase, qk, ring)  # int8
    launches.update(qlaunches)
    # the int8-wire collectives: the four step kernels
    qclaunches, qshapes, qtiming = timed(quant_collectives_phase, qk)
    launches.update(qclaunches)
    llaunches, caccls, ctiming = timed(collectives_phase, L)  # collectives
    launches.update(llaunches)
    timed(timing_phase, ring, accl, kept)
    timed(quant_timing_phase, qk, qaccl, qkept)
    timed(cast_wire_timing_phase)
    timed(collectives_timing_phase, caccls, ctiming)
    timed(quant_collectives_timing_phase, qk, *qtiming)
    timed(breakdown_phase, ring)
    quant_rows = timed(quant_shapes_phase, qk, qshapes)
    ring_row = timed(quant_ring_breakdown_phase, qk)
    lane_rows = timed(lane_breakdown_phase, L)
    timed(lane_cold_phase, L)
    # the timing phases' facades and kept results are done with: the
    # train phase needs most of the card's memory
    del accl, kept, qaccl, qkept, caccls, ctiming, qtiming, qshapes
    torch.cuda.empty_cache()
    # call sequences: every kernel inside one CUDA graph per batch; then
    # point-to-point, sub-communicators and alltoall, each path with every
    # kernel's count set to 0 just before it
    paths = {"sequence": timed(sequence_phase, ring, qk, L),
             "p2p": timed(p2p_phase, ring, qk, L),
             "comm": timed(comm_phase, ring, qk, L),
             "alltoall": timed(alltoall_phase, ring, qk, L),
             "tuned": timed(tuned_phase, ring, qk, L),
             "telemetry": timed(telemetry_phase, ring, qk, L),
             "serve": timed(serve_phase, ring, qk, L),
             "train": timed(train_phase, ring, qk, L),
             "moe": timed(moe_phase, ring, qk, L),
             "mesh": timed(mesh_phase, ring, qk, L),
             "analysis": timed(analysis_phase, ring, qk, L),
             "lift": timed(lift_phase, ring, qk, L),
             "resilience": timed(resilience_phase, ring, qk, L,
                                 native_build),
             "scheduler": timed(scheduler_phase, ring, qk, L)}
    paths["dcn"], paths["dcn_flat"] = timed(dcn_phase, ring, qk, L)
    paths["entry"] = timed(entry_phase, ring, qk, L)
    paths["sweep"] = timed(sweep_phase, ring, qk, L)
    v3 = timed(v3_moe_phase)
    emit({"phase": "clock", "seconds": clock, "v3_moe_launches": v3})
    kernel_line(ring, qk, errs, launches, ring_row, lane_rows, quant_rows,
                paths)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
