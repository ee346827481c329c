"""The port's MoE layer step on the facade against the JAX package's.

The same weights (drawn by the JAX package, carried across with
interop.moe_params_from_numpy) and the same stacked (W, T, D) tokens go
through the JAX facade's moe_ffn_via_sequence and the port's, at W = 4,
T = 24, d_model 16, d_ff 32, in two configurations: top-1 routing over
one expert a rank (the reference test's), and top-2 over two experts a
rank. The port's tests of the reference's facade tests
(tests/test_moe.py): fused == eager bitwise, a program re-dispatched
without rebuilding, the int8 wire within the reference's bound and its
register form bitwise with the explicit one, capacity dropped on the
wire, the consumer memo. Against the JAX package: every result, the
int8 wire's too, and the oracle's logits within 1e-5 * max|ref| + 1e-8
(torch's float32 matmuls against XLA's; 1e-7 to 2e-7 measured, so no
int8 code differs). `_route` ranks tied probabilities as lax.top_k does.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.constants import DataType as RefDataType
from accl_tpu.models import moe as ref_moe
from accl_tpu_torch import ACCL
from accl_tpu_torch.constants import DataType, TuningParams
from accl_tpu_torch.interop import moe_params_from_numpy
from accl_tpu_torch.models import moe

W, T = 4, 24
CASES = {
    "top1": moe.MoEConfig(d_model=16, d_ff=32, n_experts=4,
                          experts_per_rank=1, vocab=32, seq=16),
    "top2": moe.MoEConfig(d_model=16, d_ff=32, n_experts=8,
                          experts_per_rank=2, top_k=2, vocab=32, seq=16),
}
TOL = 1e-5


def _ref_cfg(cfg):
    return ref_moe.MoEConfig(**dataclasses.asdict(cfg))


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    bound = tol * np.abs(want).max() + 1e-8
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def _params_np(cfg, seed):
    return jax.tree.map(np.asarray,
                        ref_moe.init_moe_params(_ref_cfg(cfg),
                                                jax.random.key(seed)))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One configuration's weights and tokens and the JAX facade's exact,
    int8 and (one expert a rank) wire-capacity-1 results, with the JAX
    oracle's logits."""
    cfg = CASES[request.param]
    rcfg = _ref_cfg(cfg)
    params_np = _params_np(cfg, 7)
    rng = np.random.default_rng(11_000 + cfg.n_experts)
    x = rng.standard_normal((W, T, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (3, cfg.seq)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:W]), ("ccl",))
    accl = RefACCL(mesh)
    C = ref_moe._capacity(rcfg, T * cfg.top_k)
    bufs = ref_moe.create_moe_layer_buffers(accl, rcfg, C)
    ref = dict(cfg=cfg, params_np=params_np, x=x, tokens=tokens, C=C,
               params=moe_params_from_numpy(params_np, "cpu"))
    ref["exact"] = ref_moe.moe_ffn_via_sequence(accl, x, params_np, rcfg,
                                                buffers=bufs)
    ref["int8"] = ref_moe.moe_ffn_via_sequence(
        accl, x, params_np, rcfg, buffers=bufs,
        compress_dtype=RefDataType.int8)
    if cfg.experts_per_rank == 1:
        ref["wire1"] = ref_moe.moe_ffn_via_sequence(
            accl, x, params_np, rcfg, buffers=bufs, wire_capacity=1)
    ref["logits"] = np.asarray(ref_moe.moe_reference_forward(
        params_np, tokens, rcfg))
    return ref


def _port(case):
    accl = ACCL(world=W, torch_device="cpu")
    bufs = moe.create_moe_layer_buffers(accl, case["cfg"], case["C"])
    return accl, bufs


def _ffn(accl, bufs, case, **kw):
    return moe.moe_ffn_via_sequence(accl, case["x"], case["params"],
                                    case["cfg"], buffers=bufs, **kw)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_moe_params_carry_across_bit_for_bit(case):
    params_np, params = case["params_np"], case["params"]
    assert params.keys() == params_np.keys()
    for k, a in params_np.items():
        assert params[k].dtype == torch.float32
        assert np.array_equal(params[k].numpy().view(np.int32),
                              a.view(np.int32)), k
    own = moe.init_moe_params(case["cfg"], torch.Generator().manual_seed(0),
                              "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: a.shape for k, a in params_np.items()}


def test_fused_eager_and_expert_program_bitwise(case):
    """Fused (one recorded sequence), eager (two calls) and the
    descriptor-per-stage form through make_expert_program: bitwise the
    same, and within the bound of the JAX facade's fused result."""
    accl, bufs = _port(case)
    fused = _ffn(accl, bufs, case)
    eager = _ffn(accl, bufs, case, fused=False)
    assert fused.shape == (W, T, case["cfg"].d_model)
    assert torch.equal(_bits(fused), _bits(eager))
    cfg, params = case["cfg"], case["params"]
    dispatch, safe_e, safe_c, keep, gate = moe._route(
        torch.from_numpy(case["x"]), params, cfg, case["C"])
    disp, mid, out = bufs
    disp.device = dispatch.reshape(W, -1)
    expert = moe.make_expert_program(accl, cfg, case["C"], params["w_up"],
                                     params["w_down"])
    moe.run_moe_layer(accl, disp, mid, out,
                      cfg.n_experts // W * case["C"] * cfg.d_model,
                      fused=False, expert_fn=expert, from_device=True,
                      to_device=True)
    staged = moe._combine_tokens(
        out.device.reshape(W, cfg.n_experts, case["C"], cfg.d_model),
        safe_e, safe_c, keep, gate, T, cfg.top_k, cfg.d_model,
        torch.float32)
    assert torch.equal(_bits(staged), _bits(fused))
    _close(fused, case["exact"], "fused against the JAX facade")


def test_layer_program_redispatches_without_recompiling(case):
    """make_moe_layer_program: record once, dispatch many; the compile
    cache does not grow and fresh buffer contents flow in."""
    accl, bufs = _port(case)
    cfg, params = case["cfg"], case["params"]
    disp, mid, out = bufs
    accl.register_stream_consumer(
        moe.MOE_EXPERT_STREAM,
        moe.moe_expert_consumer(cfg, case["C"], params["w_up"],
                                params["w_down"], W))
    count = cfg.n_experts // W * case["C"] * cfg.d_model
    program = moe.make_moe_layer_program(accl, disp, mid, out, count)
    rng = np.random.default_rng(5)
    disp.device = torch.from_numpy(
        rng.standard_normal(disp.shape).astype(np.float32))
    program.run(from_device=True, to_device=True)
    first = out.device.clone()
    n_compiled = len(accl.cclo.compiler._cache)
    program.run(from_device=True, to_device=True)
    assert torch.equal(out.device, first)
    disp.device = torch.zeros(disp.shape)
    program.run(from_device=True, to_device=True)
    assert float(out.device.abs().max()) == 0.0
    assert len(accl.cclo.compiler._cache) == n_compiled


def test_int8_wire_within_bound_and_register_driven(case):
    """The int8 layer step, explicit and through the
    ALLTOALL_COMPRESS_MIN_COUNT register, within the reference's bound
    of the exact result and bitwise between the two forms; the JAX
    facade's int8 result within the same bound of its exact one, and
    the port's within TOL of the JAX facade's."""
    accl, bufs = _port(case)
    ref = _ffn(accl, bufs, case)
    explicit = _ffn(accl, bufs, case, compress_dtype=DataType.int8)
    err = float((explicit - ref).abs().max())
    assert 0 < err < float(ref.abs().max()) * 0.05
    jerr = np.abs(case["int8"] - case["exact"]).max()
    assert 0 < jerr < np.abs(case["exact"]).max() * 0.05
    _close(explicit, case["int8"], "int8 against the JAX facade")
    accl.configure_tuning_parameters(
        TuningParams(alltoall_compress_min_count=1))
    assert torch.equal(_bits(_ffn(accl, bufs, case)), _bits(explicit))
    accl.configure_tuning_parameters(TuningParams())
    assert torch.equal(_bits(_ffn(accl, bufs, case)), _bits(ref))


def test_wire_capacity_drops_on_the_wire(case):
    """wire_capacity routes both legs through alltoallv: at full
    capacity it is the dense exchange bit for bit; at 1, overflow tokens
    lose their expert contribution (exactly zero) while in-capacity ones
    keep their dense values; the JAX facade drops the same tokens."""
    accl, bufs = _port(case)
    dense = _ffn(accl, bufs, case)
    if case["cfg"].experts_per_rank != 1:
        with pytest.raises(ValueError, match="experts_per_rank == 1"):
            _ffn(accl, bufs, case, wire_capacity=1)
        return
    same = _ffn(accl, bufs, case, wire_capacity=case["C"])
    assert torch.equal(_bits(same), _bits(dense))
    trimmed = _ffn(accl, bufs, case, wire_capacity=1)
    changed = ~torch.isclose(trimmed, dense).all(-1)
    assert bool(changed.any())
    assert float(trimmed[changed].abs().max()) == 0.0
    want_dropped = ~np.isclose(case["wire1"], case["exact"]).all(-1)
    assert np.array_equal(changed.numpy(), want_dropped)
    _close(trimmed, case["wire1"], "wire capacity 1 against the JAX facade")


def test_consumer_memo_tracks_the_stream_binding():
    """Repeat calls with the same weights reuse one endpoint (the compile
    cache stays flat); new weights register a new one once; switching
    configs on the shared stream re-registers (cfg1 -> cfg2 -> cfg1
    returns cfg1's result bitwise)."""
    accl = ACCL(world=W, torch_device="cpu")
    cfg1 = CASES["top1"]
    cfg2 = dataclasses.replace(cfg1, d_model=32, d_ff=64)
    p1 = moe.init_moe_params(cfg1, torch.Generator().manual_seed(11), "cpu")
    p2 = moe.init_moe_params(cfg2, torch.Generator().manual_seed(12), "cpu")
    rng = np.random.default_rng(17)
    x1 = rng.standard_normal((W, T, 16)).astype(np.float32)
    x2 = rng.standard_normal((W, T, 32)).astype(np.float32)
    b1 = moe.create_moe_layer_buffers(accl, cfg1, moe._capacity(cfg1, T))
    b2 = moe.create_moe_layer_buffers(accl, cfg2, moe._capacity(cfg2, T))
    first = moe.moe_ffn_via_sequence(accl, x1, p1, cfg1, buffers=b1)
    n_compiled = len(accl.cclo.compiler._cache)
    for _ in range(3):
        again = moe.moe_ffn_via_sequence(accl, x1, p1, cfg1, buffers=b1)
    assert torch.equal(_bits(again), _bits(first))
    assert len(accl.cclo.compiler._cache) == n_compiled
    p1b = {**p1, "w_up": p1["w_up"] * 2}
    moe.moe_ffn_via_sequence(accl, x1, p1b, cfg1, buffers=b1)
    n2 = len(accl.cclo.compiler._cache)
    assert n2 > n_compiled
    moe.moe_ffn_via_sequence(accl, x1, p1b, cfg1, buffers=b1)
    assert len(accl.cclo.compiler._cache) == n2
    moe.moe_ffn_via_sequence(accl, x2, p2, cfg2, buffers=b2)
    back = moe.moe_ffn_via_sequence(accl, x1, p1, cfg1, buffers=b1)
    assert torch.equal(_bits(back), _bits(first))


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_ranks_ties_as_lax_top_k(top_k):
    """Tied probabilities rank the lower expert first, as lax.top_k does:
    a zero router ties all experts, a router with equal columns ties
    pairs. Small integers keep the logits exact in both packages, so the
    dispatch, slots and drops are bitwise the reference's; the gates,
    whose softmax each package rounds its own way, agree within 4 ulps."""
    cfg = dataclasses.replace(CASES["top1"], top_k=top_k,
                              capacity_factor=0.5)
    rng = np.random.default_rng(23)
    x = rng.integers(-3, 4, (T, cfg.d_model)).astype(np.float32)
    col = rng.integers(-2, 3, (cfg.d_model, 1)).astype(np.float32) / 8
    other = rng.integers(-2, 3, (cfg.d_model, 1)).astype(np.float32) / 8
    C = moe._capacity(cfg, T * top_k)
    for router in (np.zeros((cfg.d_model, cfg.n_experts), np.float32),
                   np.concatenate([other, col, other, col], 1)):
        want = jax.jit(lambda xi, r: ref_moe._route(
            xi, {"router": r}, _ref_cfg(cfg), C))(x, router)
        got = moe._route(torch.from_numpy(x),
                         {"router": torch.from_numpy(router)}, cfg, C)
        for g, w, name in zip(got[:4], want[:4], ("dispatch", "safe_e",
                                                  "safe_c", "keep")):
            w = np.asarray(w)
            assert np.array_equal(g.numpy().astype(w.dtype), w), name
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=2.0 ** -21, atol=0)


def test_reference_forward_matches_jax(case):
    """The single-device oracle's logits against the JAX package's, and
    the facade's FFN against the oracle's own dense experts."""
    cfg, params = case["cfg"], case["params"]
    logits = moe.moe_reference_forward(
        params, torch.from_numpy(case["tokens"]).long(), cfg)
    _close(logits, case["logits"], "moe_reference_forward")
    x = torch.from_numpy(case["x"])
    dispatch, safe_e, safe_c, keep, gate = moe._route(x, params, cfg,
                                                      case["C"])
    h = moe._gelu(torch.einsum("wecd,edf->wecf", dispatch, params["w_up"]))
    dense = torch.einsum("wecf,efd->wecd", h, params["w_down"])
    want = moe._combine_tokens(dense, safe_e, safe_c, keep, gate, T,
                               cfg.top_k, cfg.d_model, torch.float32)
    accl, bufs = _port(case)
    _close(_ffn(accl, bufs, case), want, "facade against dense experts")
