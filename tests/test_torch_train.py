"""The port's fused train step against the JAX package's.

The same weights (drawn by the JAX package, carried across with
interop.transformer_params_from_numpy and stacked_train_params_from_
numpy) and the same tokens go through the JAX package's train-step
functions and the port's, at W = 4 data-parallel ranks, tokens
(4, 1, 8), in the decode test's two configurations (4 heads and 2 kv
heads; 8 heads and 4 kv heads; vocab 64, d_model 32, 2 layers).

Bounds: the loss within 1e-6 of its value, and every gradient, update
and parameter within 1e-5 * max|ref| + 1e-8 of the JAX package's (XLA's
CPU matmuls and, under x64, its attention scale in float64, against
torch's float32 autograd: 4e-7 of max|ref| measured). Within the port, fused == eager holds
bitwise with the overlap register closed and open (stripes > 1, the
calibration pinned as the reference's fuzz pins it); the update is
within the ring's fold bound (W - 1) * 2^-24 * sum_r |g_r| of the
float64 sum of the consumer's rows, and the new parameters are exactly
params + update (the combine is one add).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accl_tpu.accl import ACCL as RefACCL
from accl_tpu.models import transformer as ref_trf
from accl_tpu_torch import ACCL
from accl_tpu_torch.constants import TuningParams
from accl_tpu_torch.interop import (stacked_train_params_from_numpy,
                                    transformer_params_from_numpy)
from accl_tpu_torch.models import transformer as trf

CFG = trf.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=64)
GQA = trf.TransformerConfig(vocab=64, d_model=32, n_heads=8, n_kv_heads=4,
                            n_layers=2, d_ff=64)
CASES = {"cfg": CFG, "gqa": GQA}
W = 4
LR = 1e-2
TOL = 1e-5


def _ref_cfg(cfg):
    return ref_trf.TransformerConfig(**dataclasses.asdict(cfg))


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    bound = tol * np.abs(want).max() + 1e-8
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One configuration's weights, tokens, the JAX package's per-rank
    losses and scaled gradients (jax.grad of local_train_loss) and its
    facade's fused train step (update and new parameters)."""
    cfg = CASES[request.param]
    rcfg = _ref_cfg(cfg)
    params_np = jax.tree.map(
        np.asarray, ref_trf.init_params(rcfg, jax.random.key(1)))
    flat_np = np.asarray(ref_trf.flatten_train_params(params_np))
    rng = np.random.default_rng(13_000 + cfg.n_heads)
    tokens = rng.integers(0, cfg.vocab, (W, 1, 8)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=2)
    scale = np.float32(-LR / W)

    def loss_and_grad(p, t, g):
        loss, grads = jax.value_and_grad(
            lambda q: scale * ref_trf.local_train_loss(q, t, g, rcfg))(p)
        return loss / scale, ref_trf.flatten_train_params(grads)

    fn = jax.jit(loss_and_grad)
    out = [fn(params_np, tokens[r], targets[r]) for r in range(W)]
    mesh = Mesh(np.array(jax.devices()[:W]), ("ccl",))
    accl = RefACCL(mesh)
    bufs = ref_trf.create_train_step_buffers(accl, rcfg)
    bufs[0].write(np.tile(flat_np, (W, 1)))
    bufs[0].sync_to_device()
    prog, _ = ref_trf.make_train_step_program(accl, rcfg, tokens, targets,
                                              lr=LR, buffers=bufs)
    prog.run(from_device=True, to_device=True)
    return dict(cfg=cfg, params_np=params_np, flat_np=flat_np,
                tokens=tokens, targets=targets,
                losses=np.array([float(l) for l, _ in out]),
                grads=np.stack([np.asarray(g) for _, g in out]),
                update=np.asarray(bufs[2].device),
                new=np.asarray(bufs[3].device))


@pytest.fixture
def pinned_overlap(monkeypatch):
    """The overlap calibration the plan reads, pinned as the reference's
    fuzz pins it (tests/test_cross_executor_fuzz.py)."""
    from accl_tpu_torch.sequencer.timing import (ComputeFit, LinkParams,
                                                 TierLinks)
    from accl_tpu_torch.telemetry import feedback

    tiers = TierLinks(inner=LinkParams(2e-6, 2e9),
                      outer=LinkParams(600e-6, 0.3e9))
    monkeypatch.setattr(feedback, "default_tier_links",
                        lambda path=None: tiers)
    monkeypatch.setattr(feedback, "default_compute_fit",
                        lambda path=None: ComputeFit(2e-3, 0.3e9))


def _port_buffers(case, overlap: bool):
    accl = ACCL(world=W, torch_device="cpu")
    if overlap:
        tp = TuningParams.default()
        tp.overlap_min_count = 1
        accl.configure_tuning_parameters(tp)
    bufs = trf.create_train_step_buffers(accl, case["cfg"])
    bufs[0].device = stacked_train_params_from_numpy(case["flat_np"], W,
                                                     "cpu")
    return accl, bufs


def _port_fused(case, overlap: bool):
    accl, bufs = _port_buffers(case, overlap)
    prog, _ = trf.make_train_step_program(
        accl, case["cfg"], case["tokens"], case["targets"], lr=LR,
        buffers=bufs)
    prog.run(from_device=True, to_device=True)
    return prog, bufs


def _port_eager(case, overlap: bool):
    accl, bufs = _port_buffers(case, overlap)
    trf._register_train_consumers(accl, case["cfg"], case["tokens"],
                                  case["targets"], LR)
    trf.run_train_step_eager(accl, case["cfg"], bufs)
    return bufs


def test_flat_layout_is_the_reference_and_round_trips(case):
    cfg = case["cfg"]
    params = transformer_params_from_numpy(case["params_np"], "cpu")
    flat = trf.flatten_train_params(params)
    assert trf.train_param_count(cfg) == \
        ref_trf.train_param_count(_ref_cfg(cfg)) == flat.numel()
    assert np.array_equal(flat.numpy().view(np.int32),
                          case["flat_np"].view(np.int32))
    tree = trf.unflatten_train_params(flat, cfg)
    for got, want in zip(trf._backward_ordered_leaves(tree),
                         trf._backward_ordered_leaves(params)):
        assert got.shape == want.shape and torch.equal(got, want)
        assert got.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()  # a view, no copy
    assert torch.equal(trf.flatten_train_params(tree), flat)
    rows = stacked_train_params_from_numpy(case["flat_np"], W, "cpu")
    assert rows.shape == (W, flat.numel())
    assert all(torch.equal(r, flat) for r in rows)


def test_loss_and_consumer_grads_match_jax(case):
    cfg = case["cfg"]
    params = transformer_params_from_numpy(case["params_np"], "cpu")
    for r in range(W):
        loss = trf.local_train_loss(
            params, torch.from_numpy(case["tokens"][r]),
            torch.from_numpy(case["targets"][r]), cfg)
        assert abs(float(loss) - case["losses"][r]) <= 1e-6 * \
            case["losses"][r], (r, float(loss), case["losses"][r])
    consumer = trf.make_grad_consumer(cfg, case["tokens"], case["targets"],
                                      scale=-LR / W, device="cpu")
    rows = stacked_train_params_from_numpy(case["flat_np"], W, "cpu")
    got = consumer(rows)
    assert got.shape == rows.shape and got.dtype == torch.float32
    for r in range(W):
        _close(got[r], case["grads"][r], f"rank {r} gradient")
    assert torch.equal(rows[0], torch.tensor(case["flat_np"]))


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "striped"])
def test_fused_equals_eager_bitwise(case, overlap, pinned_overlap):
    prog, fused = _port_fused(case, overlap)
    stripes = prog.plans[1].stripes
    assert (stripes > 1) if overlap else (stripes == 1), prog.plans[1]
    eager = _port_eager(case, overlap)
    for f, e in zip(fused[1:], eager[1:]):
        assert torch.equal(f.device.view(torch.int32),
                           e.device.view(torch.int32))
    # the replay re-reads the bound buffers: a second run from the new
    # parameters steps again
    first = fused[3].device.clone()
    fused[0].device = first
    prog.run(from_device=True, to_device=True)
    assert not torch.equal(fused[3].device, first)


def test_step_matches_the_jax_facade(case):
    _, bufs = _port_fused(case, False)
    _close(bufs[2].device, case["update"], "update")
    _close(bufs[3].device - torch.tensor(case["flat_np"]),
           case["new"] - case["flat_np"], "new - params")
    _close(bufs[3].device, case["new"], "new params")


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "striped"])
def test_new_params_are_init_plus_the_consumer_rows(case, overlap,
                                                    pinned_overlap):
    _, bufs = _port_fused(case, overlap)
    g = bufs[1].device.double()
    fold = (W - 1) * 2.0 ** -24 * g.abs().sum(0)
    err = (bufs[2].device.double() - g.sum(0)).abs()
    assert bool((err <= fold).all()), float((err - fold).max())
    init = torch.tensor(case["flat_np"])
    assert torch.equal(bufs[3].device, init + bufs[2].device)
    assert not torch.equal(bufs[3].device[0], init)
