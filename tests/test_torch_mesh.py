"""The port's transformer and MoE mesh forms against the JAX package's.

The same weights (drawn by the JAX package, carried across with
interop.transformer_params_from_numpy / moe_params_from_numpy) and the
same tokens (np.random.default_rng) go through the JAX package's
shard_map programs on its 8-device CPU mesh and the port's forms on a
mesh of virtual ranks on the CPU (vocab 32, d_model 16, 4 heads, 2 kv
heads, 2 layers, d_ff 32; batch 4, seq 16).

The JAX package compiles a mesh program in 5-13 s here, so its programs
are built in module-scoped fixtures, five in all: the forward at
dp2.sp2.tp2, the train step at dp2.sp2.tp2 and at dp1.sp2.tp2.pp2, and
the MoE forward and train step at dp2.ep4. Every other case is held
against the port's own single-rank forms (a dp1.sp1.tp1 mesh, the
axis-free forward_local and an autograd oracle of local_train_loss).

Bounds: logits within 2e-4 (rtol and atol, the reference test's); new
parameters within the reference test's rtol=2e-4, atol=2e-5, the loss
within 1e-5; against the port's own forms, 1e-5 * max|ref| + 1e-7
(float32 products and ring folds in another order), and bitwise where
only the schedule's shape changes (striped_serial against striped).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from accl_tpu.models import moe as ref_moe
from accl_tpu.models import transformer as ref_trf
from accl_tpu.parallel import make_mesh as ref_make_mesh
from accl_tpu_torch.interop import (moe_params_from_numpy,
                                    transformer_params_from_numpy)
from accl_tpu_torch.models import moe
from accl_tpu_torch.models import transformer as trf
from accl_tpu_torch.parallel import make_mesh

CFG = trf.TransformerConfig(vocab=32, d_model=16, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=32)
B, T = 4, 16
LR = 0.1
TOL = 1e-5


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    bound = tol * np.abs(want).max() + 1e-7
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def _mesh(axes):
    return make_mesh(axes, device="cpu")


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _global(mesh, tree, cfg=CFG):
    """The port's stacked parameter tree read back as the global tree
    (the list-of-layers form), for comparison with the JAX package's."""
    pp = mesh.shape.get("pp", 1) > 1
    specs = trf.pp_param_specs(cfg) if pp else trf.param_specs(cfg)
    tree = trf._tree_map(mesh.unshard, tree, specs)
    return trf.unstack_layer_params(tree, cfg.n_layers) if pp else tree


def _leaves(tree):
    return trf._tree_leaves(tree)


@pytest.fixture(scope="module")
def weights():
    """The JAX package's global weights and the same as port tensors, a
    token batch and its targets."""
    rcfg = ref_trf.TransformerConfig(**dataclasses.asdict(CFG))
    params_np = jax.tree.map(np.asarray,
                             ref_trf.init_params(rcfg, jax.random.key(2)))
    rng = np.random.default_rng(14_000)
    tokens = rng.integers(0, CFG.vocab, (B, T)).astype(np.int32)
    return {"rcfg": rcfg, "np": params_np,
            "torch": transformer_params_from_numpy(params_np, "cpu"),
            "tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _ref_step(weights, axes):
    mesh = _ref_mesh(axes)
    rcfg = weights["rcfg"]
    new, loss = ref_trf.make_train_step(rcfg, mesh, lr=LR)(
        ref_trf.shard_params(weights["np"], rcfg, mesh),
        weights["tokens"], weights["targets"])
    if axes.get("pp", 1) > 1:
        new = ref_trf.unstack_layer_params(new, rcfg.n_layers)
    return jax.tree.map(np.asarray, new), float(loss)


@pytest.fixture(scope="module")
def ref_forward(weights):
    mesh = _ref_mesh({"dp": 2, "sp": 2, "tp": 2})
    rcfg = weights["rcfg"]
    return np.asarray(ref_trf.make_forward(rcfg, mesh)(
        ref_trf.shard_params(weights["np"], rcfg, mesh), weights["tokens"]))


@pytest.fixture(scope="module")
def ref_steps(weights):
    return {name: _ref_step(weights, axes) for name, axes in (
        ("dp2sp2tp2", {"dp": 2, "sp": 2, "tp": 2}),
        ("dp1sp2tp2pp2", {"dp": 1, "sp": 2, "tp": 2, "pp": 2}))}


def _port_step(weights, axes, **kw):
    mesh = _mesh(axes)
    params = trf.shard_params(weights["torch"], CFG, mesh)
    new, loss = trf.make_train_step(CFG, mesh, lr=LR, **kw)(
        params, weights["tokens"], weights["targets"])
    return _global(mesh, new), float(loss)


def _oracle_grads(weights):
    """Autograd of local_train_loss (the axis-free forward) over the
    whole batch: the gradients leaf by leaf and the loss."""
    params = weights["torch"]
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    it = iter(leaves)
    tree = trf._tree_map(lambda _: next(it), params)
    tok = torch.as_tensor(weights["tokens"]).long()
    tgt = torch.as_tensor(weights["targets"]).long()
    loss = trf.local_train_loss(tree, tok, tgt, CFG)
    return torch.autograd.grad(loss, leaves), float(loss.detach())


def _oracle_step(weights):
    """The axis-free step: p - lr * g of the oracle's gradients."""
    grads, loss = _oracle_grads(weights)
    return [p - LR * g for p, g in zip(_leaves(weights["torch"]), grads)], \
        loss


def test_forward_dp2_sp2_tp2_matches_the_jax_package(weights, ref_forward):
    mesh = _mesh({"dp": 2, "sp": 2, "tp": 2})
    out = trf.make_forward(CFG, mesh)(
        trf.shard_params(weights["torch"], CFG, mesh), weights["tokens"])
    assert out.shape == (B, T, CFG.vocab)
    np.testing.assert_allclose(out.numpy(), ref_forward, rtol=2e-4,
                               atol=2e-4)
    _close(out, trf.forward_local(weights["torch"],
                                  torch.as_tensor(weights["tokens"]).long(),
                                  CFG), "against forward_local")


@pytest.mark.parametrize("axes", [{"dp": 1, "sp": 1, "tp": 1, "pp": 2},
                                  {"dp": 2, "sp": 1, "tp": 2, "pp": 2},
                                  {"dp": 1, "sp": 4, "tp": 2}])
def test_forward_other_meshes_match_the_axis_free_forward(weights, axes):
    mesh = _mesh(axes)
    out = trf.make_forward(CFG, mesh)(
        trf.shard_params(weights["torch"], CFG, mesh), weights["tokens"])
    _close(out, trf.forward_local(weights["torch"],
                                  torch.as_tensor(weights["tokens"]).long(),
                                  CFG), str(axes))


@pytest.mark.parametrize("name,axes", [
    ("dp2sp2tp2", {"dp": 2, "sp": 2, "tp": 2}),
    ("dp1sp2tp2pp2", {"dp": 1, "sp": 2, "tp": 2, "pp": 2})])
def test_train_step_matches_the_jax_package(weights, ref_steps, name, axes):
    """Parameter by parameter within the reference test's bounds: the
    tp x amplification, the 1/tp rescale, the dp/sp means and the pp
    embedding sum all come out as the reference's."""
    new, loss = _port_step(weights, axes)
    ref_new, ref_loss = ref_steps[name]
    assert abs(loss - ref_loss) < 1e-5
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_new)[0]
    flat_new = jax.tree.leaves(trf._tree_map(torch.Tensor.numpy, new))
    for (path, r), got in zip(flat_ref, flat_new):
        np.testing.assert_allclose(
            got, r, rtol=2e-4, atol=2e-5,
            err_msg=f"param {jax.tree_util.keystr(path)} on {axes}")


@pytest.mark.parametrize("axes", [{"dp": 1, "sp": 1, "tp": 2},
                                  {"dp": 2, "sp": 2, "tp": 2},
                                  {"dp": 1, "sp": 1, "tp": 1, "pp": 2},
                                  {"dp": 2, "sp": 1, "tp": 2, "pp": 2},
                                  {"dp": 1, "sp": 2, "tp": 2, "pp": 2},
                                  {"dp": 1, "sp": 1, "tp": 1}])
def test_train_step_matches_the_autograd_oracle(weights, axes):
    """The reference's test_transformer_train_step_matches_single_device
    shapes against the port's axis-free step, leaf by leaf."""
    new, loss = _port_step(weights, axes)
    want, want_loss = _oracle_step(weights)
    assert abs(loss - want_loss) < 1e-5
    for i, (got, w) in enumerate(zip(_leaves(new), want)):
        _close(got, w.detach(), f"leaf {i} on {axes}")


def test_striped_grad_sync_matches_leaf_and_its_serial_twin(weights):
    axes = {"dp": 2, "sp": 2, "tp": 2}
    leaf, l_leaf = _port_step(weights, axes)
    striped, l_striped = _port_step(weights, axes, grad_sync="striped",
                                    grad_stripes=4)
    serial, l_serial = _port_step(weights, axes,
                                  grad_sync="striped_serial",
                                  grad_stripes=4)
    assert l_leaf == l_striped == l_serial
    for a, b, c in zip(_leaves(leaf), _leaves(striped), _leaves(serial)):
        assert torch.equal(b, c)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"grad_sync": "striped",
                                    "grad_stripes": 3}],
                         ids=["leaf", "striped"])
def test_step_applies_its_synced_gradients(weights, kw):
    """step.grads is the step before its update: the step's new
    parameters are p - lr * g of those gradients, bitwise, and the
    gradients are the oracle's leaf by leaf."""
    mesh = _mesh({"dp": 2, "sp": 2, "tp": 2})
    params = trf.shard_params(weights["torch"], CFG, mesh)
    step = trf.make_train_step(CFG, mesh, lr=LR, **kw)
    new, loss = step(params, weights["tokens"], weights["targets"])
    grads, loss_g = step.grads(params, weights["tokens"], weights["targets"])
    assert torch.equal(loss, loss_g)
    for p, g, n in zip(_leaves(params), _leaves(grads), _leaves(new)):
        assert torch.equal(n, p - LR * g)
    want, _ = _oracle_grads(weights)
    for i, (g, w) in enumerate(zip(_leaves(_global(mesh, grads)), want)):
        _close(g, w, f"gradient {i}")


def test_default_grad_stripes_come_from_the_cost_model(weights):
    mesh = _mesh({"dp": 2, "sp": 2, "tp": 2})
    stripes = trf._default_grad_stripes(CFG, mesh)
    assert stripes in (1, 2, 4, 8)
    new, _ = _port_step(weights, {"dp": 2, "sp": 2, "tp": 2},
                        grad_sync="striped")
    leaf, _ = _port_step(weights, {"dp": 2, "sp": 2, "tp": 2})
    for a, b in zip(_leaves(new), _leaves(leaf)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2, "tp": 2},
                                  {"dp": 2, "sp": 1, "tp": 2, "pp": 2}])
def test_remat_step_matches_plain(weights, axes):
    plain, l_plain = _port_step(weights, axes)
    rem, l_rem = _port_step(weights, axes, remat=True)
    assert l_plain == pytest.approx(l_rem, abs=1e-6)
    for a, b in zip(_leaves(plain), _leaves(rem)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(axes))


def test_remat_reruns_the_collectives_the_reference_reruns(weights,
                                                          monkeypatch):
    """Rematerialization reruns one tp allreduce a block in both packages:
    the reference's gradient jaxpr of one remat block at tp 2 holds two
    ppermutes (one allreduce) more than the plain block's, and the port's
    remat step folds once more a layer (torch.utils.checkpoint stops at
    the block's last saved activation, so the MLP's allreduce runs once)."""
    from accl_tpu.sequencer import schedules as ref_schedules
    from accl_tpu_torch.ops import lane_kernels

    rcfg = weights["rcfg"]
    lyr = dict(weights["np"]["layers"][0])
    for k, (axis, n) in {"wq": (1, 2), "wkv": (2, 1), "wo": (0, 2),
                         "w_up": (1, 16), "w_down": (0, 16)}.items():
        lyr[k] = np.take(lyr[k], np.arange(n), axis=axis)
    x = np.ones((1, 8, CFG.d_model), np.float32)

    def ref_ppermutes(remat):
        blk = ref_trf._block_fn(rcfg, ref_schedules.Wire(None), remat)
        jp = jax.make_jaxpr(
            jax.grad(lambda a, b: blk(a, b).sum(), argnums=(0, 1)),
            axis_env=[("tp", 2), ("sp", 1)])(x, lyr)
        return str(jp).count("ppermute[")

    folds = []
    real = lane_kernels.combine

    def counting(*a, **k):
        folds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(lane_kernels, "combine", counting)
    per_remat = {}
    for remat in (False, True):
        folds.clear()
        _port_step(weights, {"dp": 1, "sp": 1, "tp": 2}, remat=remat)
        per_remat[remat] = len(folds)
    ref_extra = (ref_ppermutes(True) - ref_ppermutes(False)) // 2
    assert ref_extra == 1
    assert (per_remat[True] - per_remat[False]) == ref_extra * CFG.n_layers


def test_train_step_decreases_loss(weights):
    mesh = _mesh({"dp": 2, "sp": 2, "tp": 2})
    params = trf.shard_params(weights["torch"], CFG, mesh)
    tokens, targets = trf.demo_batch(CFG, mesh, batch=4, seq=16)
    step = trf.make_train_step(CFG, mesh, lr=5e-2)
    losses = []
    for _ in range(4):
        params, loss = step(params, tokens, targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_train_step_errors(weights):
    mesh = _mesh({"dp": 1, "sp": 1, "tp": 1, "pp": 2})
    with pytest.raises(ValueError, match="grad_sync"):
        trf.make_train_step(CFG, mesh, grad_sync="bucketed")
    with pytest.raises(NotImplementedError, match="pp=1"):
        trf.make_train_step(CFG, mesh, grad_sync="striped", grad_stripes=2)
    with pytest.raises(ValueError, match="divide over pp"):
        trf.shard_params(weights["torch"], CFG,
                         _mesh({"dp": 1, "sp": 1, "tp": 1, "pp": 4}))


def _decode_all(mesh, params, tokens, cfg=CFG):
    step = trf.make_decode_step(cfg, mesh)
    cache = trf.init_kv_cache(cfg, mesh, tokens.shape[0],
                              max_len=tokens.shape[1])
    positions = torch.arange(tokens.shape[1], device=mesh.device)
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(params, cache, tokens[:, t:t + 1],
                             positions[t:t + 1])
        outs.append(logits)
    return torch.cat(outs, 1)


def test_decode_dp2_tp2_equals_forward(weights, ref_forward):
    """Decoding token by token gives the forward's logits position by
    position: the JAX package's (at dp2.sp2.tp2, the same weights and
    tokens) and the port's make_forward on the decode mesh."""
    mesh = _mesh({"dp": 2, "sp": 1, "tp": 2})
    params = trf.shard_params(weights["torch"], CFG, mesh)
    tokens = torch.as_tensor(weights["tokens"])
    dec = _decode_all(mesh, params, tokens)
    np.testing.assert_allclose(dec.numpy(), ref_forward, rtol=2e-4,
                               atol=2e-4)
    _close(dec, trf.make_forward(CFG, mesh)(params, tokens), "forward")


@pytest.mark.parametrize("axes", [{"dp": 1, "sp": 1, "tp": 1},
                                  {"dp": 1, "sp": 1, "tp": 2}])
def test_gqa_decode_matches_full_forward(axes):
    cfg = trf.TransformerConfig(vocab=64, d_model=32, n_heads=8,
                                n_kv_heads=2, n_layers=2, d_ff=64)
    params = trf.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    mesh = _mesh(axes)
    tokens = torch.as_tensor(
        np.random.default_rng(14_001).integers(0, cfg.vocab, (2, 9)))
    dec = _decode_all(mesh, trf.shard_params(params, cfg, mesh), tokens,
                      cfg)
    _close(dec, trf.forward_local(params, tokens, cfg), str(axes))


def test_decode_cache_is_grouped_updated_in_place_and_pos_clamped(weights):
    cfg = trf.TransformerConfig(vocab=64, d_model=32, n_heads=8,
                                n_kv_heads=2, n_layers=1, d_ff=64)
    mesh = _mesh({"dp": 1, "sp": 1, "tp": 2})
    cache = trf.init_kv_cache(cfg, mesh, batch=2, max_len=16)
    # the global (2, 16, 2, 4) cache: kv heads over tp
    assert cache[0]["k"].shape == (2, 2, 16, 1, 4)
    params = trf.shard_params(
        trf.init_params(cfg, torch.Generator().manual_seed(3), "cpu"),
        cfg, mesh)
    step = trf.make_decode_step(cfg, mesh)
    k = cache[0]["k"]
    _, out = step(params, cache, torch.tensor([[5], [7]]), torch.tensor([3]))
    assert out[0]["k"] is k
    assert k[:, :, 3].abs().sum() > 0 and k[:, :, :3].abs().sum() == 0
    step(params, cache, torch.tensor([[5], [7]]), torch.tensor([40]))
    assert k[:, :, 15].abs().sum() > 0  # clamped into the last row


def test_decode_rejects_sp_and_pp_meshes():
    for axes, what in (({"dp": 1, "sp": 2, "tp": 1}, "sp=1"),
                       ({"dp": 1, "sp": 1, "tp": 1, "pp": 2}, "pp=1")):
        with pytest.raises(ValueError, match=what):
            trf.make_decode_step(CFG, _mesh(axes))


def test_specs_and_layer_stacking(weights):
    rcfg = weights["rcfg"]
    ref = ref_trf.param_specs(rcfg)
    port = trf.param_specs(CFG)
    assert tuple(port["layers"][0]["wq"]) == tuple(ref["layers"][0]["wq"])
    assert {k: tuple(v) for k, v in trf.pp_param_specs(CFG)["layers"]
            .items()} == {k: tuple(v) for k, v in
                          ref_trf.pp_param_specs(rcfg)["layers"].items()}
    stacked = trf.stack_layer_params(weights["torch"])
    assert stacked["layers"]["wq"].shape == (2, 16, 4, 4)
    back = trf.unstack_layer_params(stacked, CFG.n_layers)
    for a, b in zip(_leaves(back), _leaves(weights["torch"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE = moe.MoEConfig(d_model=16, d_ff=32, n_experts=4, experts_per_rank=1,
                    vocab=32, seq=16)


@pytest.fixture(scope="module")
def moe_case():
    rcfg = ref_moe.MoEConfig(**dataclasses.asdict(MOE))
    params_np = jax.tree.map(np.asarray,
                             ref_moe.init_moe_params(rcfg, jax.random.key(1)))
    rng = np.random.default_rng(14_002)
    tokens = rng.integers(0, MOE.vocab, (8, MOE.seq)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    mesh = _ref_mesh({"dp": 2, "ep": 4})
    placed = ref_moe.place_moe_params(params_np, rcfg, mesh)
    ref_logits = np.asarray(ref_moe.make_moe_forward(rcfg, mesh)(placed,
                                                                 tokens))
    new, loss = ref_moe.make_moe_train_step(rcfg, mesh, lr=LR)(
        placed, tokens, targets)
    return {"params": moe_params_from_numpy(params_np, "cpu"),
            "tokens": tokens, "targets": targets, "logits": ref_logits,
            "new": jax.tree.map(np.asarray, new), "loss": float(loss)}


def test_moe_forward_dp2_ep4_matches_the_jax_package(moe_case):
    mesh = _mesh({"dp": 2, "ep": 4})
    out = moe.make_moe_forward(MOE, mesh)(
        moe.place_moe_params(moe_case["params"], MOE, mesh),
        moe_case["tokens"])
    np.testing.assert_allclose(out.numpy(), moe_case["logits"], rtol=2e-4,
                               atol=2e-5)
    _close(out, moe.moe_reference_forward(
        moe_case["params"], torch.as_tensor(moe_case["tokens"]).long(), MOE),
        "against moe_reference_forward")


def test_moe_train_step_dp2_ep4_matches_the_jax_package(moe_case):
    """Expert grads rescaled by 1/ep, replicated grads mean-allreduced
    over ep: parameter by parameter within the reference test's bounds."""
    mesh = _mesh({"dp": 2, "ep": 4})
    new, loss = moe.make_moe_train_step(MOE, mesh, lr=LR)(
        moe.place_moe_params(moe_case["params"], MOE, mesh),
        moe_case["tokens"], moe_case["targets"])
    assert abs(float(loss) - moe_case["loss"]) < 1e-5
    specs = moe.moe_param_specs(MOE)
    for k, want in moe_case["new"].items():
        np.testing.assert_allclose(mesh.unshard(new[k], specs[k]).numpy(),
                                   want, rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("dp,ep,epr,top_k", [(2, 2, 2, 1), (1, 4, 1, 2),
                                             (4, 2, 2, 2)])
def test_moe_mesh_forms_match_the_single_rank_forms(moe_case, dp, ep, epr,
                                                    top_k):
    """The forward against moe_reference_forward and the train step
    against the same step on a dp1.ep1 mesh with every expert local (the
    reference's own check, tests/test_moe.py)."""
    cfg = dataclasses.replace(MOE, n_experts=ep * epr, experts_per_rank=epr,
                              top_k=top_k)
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(ep),
                                 "cpu")
    tokens, targets = moe_case["tokens"], moe_case["targets"]
    mesh = _mesh({"dp": dp, "ep": ep})
    placed = moe.place_moe_params(params, cfg, mesh)
    _close(moe.make_moe_forward(cfg, mesh)(placed, tokens),
           moe.moe_reference_forward(params, torch.as_tensor(tokens).long(),
                                     cfg), "forward")
    one = dataclasses.replace(cfg, experts_per_rank=cfg.n_experts)
    mesh1 = _mesh({"dp": 1, "ep": 1})
    want, want_loss = moe.make_moe_train_step(one, mesh1, lr=LR)(
        moe.place_moe_params(params, one, mesh1), tokens, targets)
    new, loss = moe.make_moe_train_step(cfg, mesh, lr=LR)(placed, tokens,
                                                          targets)
    assert abs(float(loss) - float(want_loss)) < 1e-6
    specs = moe.moe_param_specs(cfg)
    for k in params:
        _close(mesh.unshard(new[k], specs[k]),
               mesh1.unshard(want[k], specs[k]), k)
