"""The port's fused KV-cache decode step against the JAX package's.

The same weights (drawn by the JAX package, converted with
interop.transformer_params_from_numpy) and the same tokens at ragged
per-slot positions go through the JAX facade's make_decode_step_program
and the port's. Two configurations: the reference test's (4 heads, 2 kv
heads, W = 2) and a wider grouped-query one (8 heads, 4 kv heads,
W = 4). Logits and every layer's state buffer ([o_partial, pos, kv
cache] per rank) agree within 1e-5 * max|ref| + 1e-6 (the JAX package
runs XLA's CPU matmuls and, under x64, its attention scale in float64;
the port runs torch's in float32), greedy tokens are equal. Within the
port, fused == eager holds bitwise, and decoding a sequence token by
token reproduces both the JAX package's make_forward on a 1x1x1 mesh
and the port's own forward_local.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.models import transformer as ref_trf
from accl_tpu.parallel import make_mesh
from accl_tpu_torch import ACCL
from accl_tpu_torch.errors import LintError
from accl_tpu_torch.interop import transformer_params_from_numpy
from accl_tpu_torch.models import transformer as trf

CFG = trf.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=64)
GQA = trf.TransformerConfig(vocab=64, d_model=32, n_heads=8, n_kv_heads=4,
                            n_layers=2, d_ff=64)
CASES = {"cfg": (CFG, 2), "gqa": (GQA, 4)}
B, T = 3, 12
STEPS = 6


def _ref_cfg(cfg):
    return ref_trf.TransformerConfig(**dataclasses.asdict(cfg))


def _params_np(cfg, seed):
    return jax.tree.map(np.asarray,
                        ref_trf.init_params(_ref_cfg(cfg), jax.random.key(seed)))


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    tol = 1e-5 * np.abs(want).max() + 1e-6
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def _steps(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, CFG.vocab, B), rng.integers(0, T, B))
            for _ in range(STEPS)]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One configuration's weights (numpy and the port's tensors) and the
    JAX facade's fused program over them."""
    cfg, world = CASES[request.param]
    params_np = _params_np(cfg, 11)
    mesh = Mesh(np.array(jax.devices()[:world]), ("ccl",))
    ref = ref_trf.make_decode_step_program(RefACCL(mesh), _ref_cfg(cfg),
                                           params_np, batch=B, max_len=T)
    return dict(cfg=cfg, world=world, params_np=params_np,
                params=transformer_params_from_numpy(params_np, "cpu"),
                ref=ref)


def _port_fused(case):
    return trf.make_decode_step_program(
        ACCL(world=case["world"], torch_device="cpu"), case["cfg"],
        case["params"], batch=B, max_len=T)


def _port_eager(case):
    accl = ACCL(world=case["world"], torch_device="cpu")
    buffers = trf.create_decode_buffers(accl, case["cfg"], B, T)
    trf.register_decode_consumers(accl, case["cfg"], case["params"],
                                  buffers.dims)
    return accl, buffers


def test_param_conversion_round_trips():
    params_np = _params_np(GQA, 3)
    params = transformer_params_from_numpy(params_np, "cpu")
    flat_np = jax.tree.leaves(params_np)
    flat = [params["embed"], params["unembed"]] + [
        t for lyr in params["layers"] for t in lyr.values()]
    assert len(flat) == len(flat_np)
    for lyr_np, lyr in zip(params_np["layers"], params["layers"]):
        assert lyr.keys() == lyr_np.keys()
        for k, a in lyr_np.items():
            assert lyr[k].dtype == torch.float32
            assert np.array_equal(lyr[k].numpy().view(np.int32),
                                  a.view(np.int32)), k
    for k in ("embed", "unembed"):
        assert np.array_equal(params[k].numpy(), params_np[k])
    # the port's own draw has the reference's tree shapes
    own = trf.init_params(GQA, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(np.shape, params_np)
    assert {k: tuple(v.shape) for k, v in own["layers"][0].items()} == \
        shapes["layers"][0]
    assert tuple(own["embed"].shape) == shapes["embed"]


def test_decode_step_matches_the_jax_facade(case):
    """6 steps at ragged positions: logits, every state buffer and the
    greedy tokens against the JAX facade's program."""
    (rprog, rbf), (pprog, pbf) = case["ref"], _port_fused(case)
    for step, (toks, pos) in enumerate(_steps(52_100 + case["world"])):
        ref_trf.write_decode_inputs(rbf, case["params_np"], toks, pos)
        rprog.run(to_device=True)
        want = ref_trf.read_decode_logits(rbf, sync=True)
        trf.write_decode_inputs(pbf, case["params"], toks, pos)
        pprog.run(to_device=True)
        got = trf.read_decode_logits(pbf, sync=True)
        _close(got, want, f"step {step} logits")
        assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))
        for l, (rs, ps) in enumerate(zip(rbf.state, pbf.state)):
            rs.sync_from_device()
            _close(ps.device, rs.host, f"step {step} state[{l}]")


def test_fused_equals_eager_bitwise(case):
    """The one-program step and the eager twin: bitwise-equal logits and
    states on a chain of ragged steps (no reset between them)."""
    pprog, pbf = _port_fused(case)
    accl_e, be = _port_eager(case)
    for toks, pos in _steps(7_000 + case["world"]):
        trf.write_decode_inputs(pbf, case["params"], toks, pos)
        pprog.run(to_device=True)
        lf = trf.read_decode_logits(pbf, sync=True)
        trf.write_decode_inputs(be, case["params"], toks, pos)
        trf.run_decode_step_eager(accl_e, case["cfg"], be)
        le = trf.read_decode_logits(be)
        assert torch.equal(lf.view(torch.int32), le.view(torch.int32))
        for fs, es in zip(pbf.state, be.state):
            assert torch.equal(fs.device.view(torch.int32),
                               es.device.view(torch.int32))


def test_decode_matches_full_forward():
    """The cache is the context: a sequence decoded token by token gives
    the logits of the JAX package's make_forward (1x1x1 mesh) and of the
    port's forward_local, position by position."""
    cfg, world = GQA, 4
    params_np = _params_np(cfg, 1)
    params = transformer_params_from_numpy(params_np, "cpu")
    toks = np.random.default_rng(7).integers(1, cfg.vocab, (B, T)) \
        .astype(np.int32)
    omesh = make_mesh({"dp": 1, "sp": 1, "tp": 1},
                      devices=jax.devices()[:1])
    rparams = jax.tree.map(jax.numpy.asarray, params_np)
    ref = np.asarray(ref_trf.make_forward(_ref_cfg(cfg), omesh)(
        ref_trf.shard_params(rparams, _ref_cfg(cfg), omesh), toks))
    own = trf.forward_local(params, torch.from_numpy(toks).long(), cfg)
    _close(own, ref, "forward_local")
    prog, bf = trf.make_decode_step_program(
        ACCL(world=world, torch_device="cpu"), cfg, params, batch=B,
        max_len=T)
    for t in range(T):
        trf.write_decode_inputs(bf, params, toks[:, t], np.full(B, t))
        prog.run(to_device=True)
        lf = trf.read_decode_logits(bf, sync=True)
        _close(lf, ref[:, t], f"position {t} against make_forward")
        _close(lf, own[:, t], f"position {t} against forward_local")


def test_decode_append_clamps_the_position_as_lax_does():
    """A position past the window appends at max_len - 1, as
    lax.dynamic_update_slice clamps, and never faults."""
    cfg, world = CFG, 2
    params = transformer_params_from_numpy(_params_np(cfg, 5), "cpu")
    dims = trf.decode_dims(cfg, world, B, T)
    attn = trf.make_decode_attn_consumer(cfg, params["layers"][0], dims,
                                         world)
    rng = np.random.default_rng(41)
    state = torch.from_numpy(
        rng.standard_normal((world, dims.n_state)).astype(np.float32))
    b_d = B * cfg.d_model
    state[:, b_d:b_d + B] = torch.tensor([T + 5.0, T - 1.0, 0.0])
    out = attn(state)
    cache = out[:, b_d + B:].view(world, 2, B, T, dims.kv_heads_local,
                                  cfg.head_dim)
    before = state[:, b_d + B:].view_as(cache)
    changed = (cache != before).any(-1).any(-1)  # (world, 2, B, T)
    assert changed[:, :, 0].nonzero()[:, -1].unique().tolist() == [T - 1]
    assert changed[:, :, 1].nonzero()[:, -1].unique().tolist() == [T - 1]
    assert changed[:, :, 2].nonzero()[:, -1].unique().tolist() == [0]
    assert torch.equal(out[:, b_d:b_d + B], state[:, b_d:b_d + B])


def test_decode_dims_errors_match_the_reference():
    for cfg, world in ((CFG, 3), (dataclasses.replace(CFG, dtype="bfloat16"),
                                  2)):
        with pytest.raises(ValueError) as want:
            ref_trf.decode_dims(_ref_cfg(cfg), world, B, T)
        with pytest.raises(ValueError) as got:
            trf.decode_dims(cfg, world, B, T)
        assert str(got.value) == str(want.value)


def test_decode_lint_requires_persistent_annotation(monkeypatch):
    """Strip the persistent waiver and the default lint tier rejects the
    recording with ACCL101, as the reference's does."""
    params = transformer_params_from_numpy(_params_np(CFG, 0), "cpu")
    monkeypatch.setattr(trf.DecodeBuffers, "persistent",
                        property(lambda self: ()))
    with pytest.raises(LintError) as err:
        trf.make_decode_step_program(ACCL(world=2, torch_device="cpu"), CFG,
                                     params, batch=B, max_len=T)
    assert "ACCL101" in err.value.codes
