"""The port's continuous-batching DecodeServer.

Ragged prompts multiplexed over fewer slots than requests (requests
join and leave at step boundaries) generate, bitwise, the tokens each
request generates decoded alone through the same program, in fused and
eager mode; a dirty slot serves its next request with no cache reset;
the port's server generates the JAX package's server's tokens for the
same requests and weights; its request checks, its metrics and a
saturated scheduler's refusal (tests/test_torch_scheduler.py holds the
scheduler seam's tokens).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.models import serve as ref_serve
from accl_tpu.models import transformer as ref_trf
from accl_tpu_torch import ACCL
from accl_tpu_torch.interop import transformer_params_from_numpy
from accl_tpu_torch.models import serve
from accl_tpu_torch.models import transformer as trf
from accl_tpu_torch.telemetry.metrics import MetricsRegistry

CFG = trf.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=64)
GQA = trf.TransformerConfig(vocab=64, d_model=32, n_heads=8, n_kv_heads=4,
                            n_layers=2, d_ff=64)
T = 12


def _params_np(cfg, seed):
    ref_cfg = ref_trf.TransformerConfig(**dataclasses.asdict(cfg))
    return jax.tree.map(np.asarray,
                        ref_trf.init_params(ref_cfg, jax.random.key(seed)))


def _prompts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, int(rng.integers(1, 5)))))
            for _ in range(n)]


def _server(cfg, world, params, **kw):
    kw.setdefault("batch", 3)
    kw.setdefault("max_len", T)
    return serve.DecodeServer(ACCL(world=world, torch_device="cpu"), cfg,
                              params, registry=MetricsRegistry(), **kw)


@pytest.mark.parametrize("cfg,world", [(CFG, 2), (GQA, 4)],
                         ids=["cfg", "gqa"])
def test_batched_equals_sequential_ragged_join_leave(cfg, world):
    """5 ragged requests over 3 slots: the batched tokens equal each
    request's drained alone, and the eager server's."""
    params = transformer_params_from_numpy(_params_np(cfg, 2), "cpu")
    prompts = _prompts(5, 5, cfg.vocab)

    def run(mode, sequential):
        srv = _server(cfg, world, params, mode=mode)
        if sequential:
            outs = []
            for p in prompts:
                outs.extend(serve.generate(srv, [p], 4))
            return outs
        return serve.generate(srv, prompts, 4)

    batched = run("fused", sequential=False)
    assert batched == run("fused", sequential=True), \
        "batched != sequential (join/leave churn leaked between slots)"
    assert batched == run("eager", sequential=False), \
        "fused server != eager server"
    assert all(len(g) == 4 for g in batched)


def test_batched_logits_equal_sequential_slot_for_slot():
    """Every logits row of a batched request is bitwise the row of the
    same request decoded alone through the same program in the slot it
    held (other slots idle). Across slots only the tokens are held
    equal: the ring allreduce folds each element in an order set by its
    chunk of the row, so a slot's last bits depend on its place."""
    params = transformer_params_from_numpy(_params_np(GQA, 8), "cpu")
    prompts = _prompts(13, 4, GQA.vocab)
    srv = _server(GQA, 4, params)
    bf = srv._buffers
    V = GQA.vocab
    reqs = [srv.submit(p, 4) for p in prompts]
    rows = {}
    while srv.active:
        srv._admit()
        held = [(b, s.req.rid) for b, s in enumerate(srv._slots) if s]
        srv.step()
        logits = bf.logits.host[0, :srv.batch * V].view(srv.batch, V)
        for b, rid in held:
            rows.setdefault(rid, (b, []))[1].append(logits[b].clone())
    embed = {"embed": params["embed"]}
    for r in reqs:
        slot, got = rows[r.rid]
        for pos in range(len(r.prompt) + 3):
            toks, at = [0] * srv.batch, [0] * srv.batch
            toks[slot] = (r.prompt + r.generated)[pos]
            at[slot] = pos
            trf.write_decode_inputs(bf, embed, toks, at)
            srv._program.run(to_device=True)
            want = trf.read_decode_logits(bf, sync=True)[slot]
            assert torch.equal(got[pos].view(torch.int32),
                               want.view(torch.int32)), (r.rid, pos)


def test_slot_reuse_needs_no_cache_reset():
    """One slot serving two requests back to back matches two fresh
    single-request servers."""
    params = transformer_params_from_numpy(_params_np(CFG, 3), "cpu")
    srv = _server(CFG, 2, params, batch=1)
    a = serve.generate(srv, [[5, 9, 2]], 4)[0]
    b = serve.generate(srv, [[7, 1]], 4)[0]  # reuses the dirty slot
    assert b == serve.generate(_server(CFG, 2, params, batch=1),
                               [[7, 1]], 4)[0]
    assert a == serve.generate(_server(CFG, 2, params, batch=1),
                               [[5, 9, 2]], 4)[0]


@pytest.mark.parametrize("cfg,world", [(CFG, 2), (GQA, 4)],
                         ids=["cfg", "gqa"])
def test_port_server_generates_the_jax_servers_tokens(cfg, world):
    params_np = _params_np(cfg, 4)
    prompts = _prompts(9, 4, cfg.vocab)
    ref_cfg = ref_trf.TransformerConfig(**dataclasses.asdict(cfg))
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    want = ref_serve.generate(
        ref_serve.DecodeServer(RefACCL(mesh), ref_cfg, params_np, batch=3,
                               max_len=T), prompts, 5)
    got = serve.generate(
        _server(cfg, world, transformer_params_from_numpy(params_np, "cpu")),
        prompts, 5)
    assert got == want


def test_server_metrics():
    params = transformer_params_from_numpy(_params_np(CFG, 6), "cpu")
    reg = MetricsRegistry()
    srv = serve.DecodeServer(ACCL(world=2, torch_device="cpu"), CFG, params,
                             batch=2, max_len=T, registry=reg)
    outs = serve.generate(srv, [[3, 4], [5]], 3)
    snap = reg.snapshot()
    steps = {tuple(sorted(r["labels"].items())): r
             for r in snap["histograms"]["accl_serve_step_seconds"]}
    row = steps[(("batch", "2"), ("mode", "fused"))]
    assert row["count"] == srv.n_steps == 4
    tokens = snap["counters"]["accl_serve_tokens_total"][0]
    assert tokens["value"] == sum(map(len, outs)) == 6
    assert snap["gauges"]["accl_serve_active_requests"][0]["value"] == 0


def test_server_errors_match_the_reference():
    params_np = _params_np(CFG, 0)
    params = transformer_params_from_numpy(params_np, "cpu")
    ref_cfg = ref_trf.TransformerConfig(**dataclasses.asdict(CFG))
    ref = ref_serve.DecodeServer(
        RefACCL(Mesh(np.array(jax.devices()[:2]), ("ccl",))), ref_cfg,
        params_np, batch=1, max_len=8)
    port = _server(CFG, 2, params, batch=1, max_len=8)
    for prompt, n in (([], 2), ([CFG.vocab], 2), ([1, 2, 3], 8),
                      ([-1], 1)):
        with pytest.raises(ValueError) as want:
            ref.submit(prompt, n)
        with pytest.raises(ValueError) as got:
            port.submit(prompt, n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mode"):
        _server(CFG, 2, params, mode="speculative")
    # a saturated scheduler refuses a request before it is queued, with
    # the reference's error for the same accounting
    from accl_tpu.scheduler import SchedulerSaturatedError as RefSaturated
    from accl_tpu_torch.scheduler import SchedulerSaturatedError

    accl = ACCL(world=2, torch_device="cpu")
    srv = serve.DecodeServer(accl, CFG, params, batch=1, max_len=8,
                             registry=MetricsRegistry(),
                             scheduler=accl.scheduler(capacity_s=1e-12,
                                                      registry=MetricsRegistry()))
    with pytest.raises(SchedulerSaturatedError) as got:
        srv.submit([1, 2], 2)
    e = got.value
    assert not srv.active
    assert str(e) == str(RefSaturated(e.tenant, e.requested_s, e.queued_s,
                                      e.capacity_s))
