"""The port's parallel layer against the JAX package's: the mesh, the
differentiable axis collectives, ring attention, Ulysses and GPipe.

The same inputs (np.random.default_rng) go through the JAX package's
bodies under shard_map on its 8-device CPU mesh and through the port's
forms over a mesh of virtual ranks on the CPU, whose stacked (R, ...)
rows are the reference's per-device shards.

Bounds: attention outputs within 1e-5 of the JAX package's (float32
products in another order; the reference test's own bound against a
float64 oracle is 2e-4, held too); the q-gradient within 1e-5 *
max|ref|; GPipe's outputs within the reference test's rtol=2e-4,
atol=2e-5 and its gradients within rtol=5e-4, atol=5e-5; the exact and
int8 re-shardings bitwise (pure routing; the int8 wire bitwise as the
port's alltoall is with the JAX package's wire functions); the int8
Ulysses within the reference's 5e-2 of the exact wire. The reference's
own striped-Ulysses test fails here (its striped and unstriped outputs
are 3.6e-7 apart), so the port's striped form is held against its
unstriped one within 1e-6 * max|ref| and against a float64 oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as RefP

from accl_tpu.parallel import factorize_devices as ref_factorize
from accl_tpu.parallel import pipeline as ref_pipeline
from accl_tpu.parallel import ulysses as ref_ulysses
from accl_tpu.parallel.ring_attention import (
    ring_attention as ref_ring_attention)
from accl_tpu.sequencer import schedules as ref_schedules
from accl_tpu_torch.arithconfig import DEFAULT_ARITH_CONFIG
from accl_tpu_torch.constants import DataType, ReduceFunction
from accl_tpu_torch.parallel import (collectives, factorize_devices,
                                     gpipe_schedule, make_mesh,
                                     ring_attention, ulysses_attention)
from accl_tpu_torch.parallel import pipeline, ulysses
from accl_tpu_torch.parallel.mesh import P
from accl_tpu_torch.sequencer import schedules

RNG = np.random.default_rng(14_100)


def _normal(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _mesh(axes):
    return make_mesh(axes, device="cpu")


def _close(got, want, what, tol=1e-5):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    bound = tol * np.abs(want).max() + 1e-7
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |diff| {err} > {bound}"


def _ref_sp(fn, world, n_in=3):
    """jit(shard_map(fn)) over a ("sp",) mesh of `world` devices, each
    input and the output sharded on dim 1 (the sequence)."""
    mesh = RefMesh(np.array(jax.devices()[:world]), ("sp",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(RefP(None, "sp"),) * n_in,
        out_specs=RefP(None, "sp"), check_vma=False))


def _stacked(mesh, x):
    """A global (B, T, ...) array sharded on the sequence over sp."""
    return mesh.shard(torch.from_numpy(x), P(None, "sp"))


def reference_attention(q, k, v, causal):
    s = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64)
    s /= np.sqrt(q.shape[-1])
    if causal:
        T = q.shape[1]
        s = np.where(np.tril(np.ones((T, T), bool))[None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names", [("dp", "sp", "tp"), ("dp", "ep"),
                                   ("pp", "x")])
def test_factorize_devices_matches_the_jax_package(names):
    for n in range(1, 17):
        assert factorize_devices(n, names) == ref_factorize(n, names)


def test_make_mesh_axes_coordinates_and_the_world_check(monkeypatch):
    mesh = _mesh({"dp": 2, "sp": 2, "tp": 2})
    assert mesh.shape == {"dp": 2, "sp": 2, "tp": 2} and mesh.size == 8
    for i, name in enumerate(mesh.axis_names):
        want = np.unravel_index(np.arange(8), (2, 2, 2))[i]
        assert mesh.axis_index(name).tolist() == list(want)
    assert make_mesh(world=8, device="cpu").shape == factorize_devices(8)
    with pytest.raises(ValueError, match="cover"):
        make_mesh({"dp": 3}, world=8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh({"dp": 2})


def test_shard_and_unshard_place_blocks_as_partition_specs_do():
    mesh = _mesh({"dp": 2, "ep": 2, "tp": 2})
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    s = mesh.shard(x, P(("dp", "ep"), None, "tp"))
    assert s.shape == (8, 2, 6, 2)
    for r, (d, e, t) in enumerate(mesh.coords):
        blk = d * 2 + e
        assert torch.equal(s[r], x[blk * 2:blk * 2 + 2, :, t * 2:t * 2 + 2])
    assert torch.equal(mesh.unshard(s, P(("dp", "ep"), None, "tp")), x)
    assert torch.equal(mesh.unshard(mesh.shard(x)), x)


# ---------------------------------------------------------------------------
# the differentiable axis collectives
# ---------------------------------------------------------------------------

AXES = {"dp": 2, "sp": 3, "tp": 2}


def _lines(mesh, axis):
    """The global ranks of each line of `axis`, in coordinate order."""
    i = mesh.axis_names.index(axis)
    lines = {}
    for r, c in enumerate(mesh.coords):
        lines.setdefault(c[:i] + c[i + 1:], []).append(r)
    return list(lines.values())


@pytest.mark.parametrize("axis", list(AXES))
def test_axis_allreduce_is_the_ring_on_each_line_and_its_own_transpose(axis):
    """Bitwise with the flat ring schedule run on each line's rows alone;
    the backward is the allreduce of the cotangent (JAX's transpose)."""
    mesh = _mesh(AXES)
    x = torch.from_numpy(_normal(mesh.size, 5, 7)).requires_grad_()
    out = collectives.axis_allreduce(x, mesh, axis)
    n = AXES[axis]
    for rows in _lines(mesh, axis):
        want = schedules.allreduce_ring_schedule(
            x.detach()[rows].reshape(n, -1), func=ReduceFunction.SUM,
            world=n, wire=schedules.Wire(None), seg_count=35)
        assert torch.equal(out.detach()[rows].reshape(n, -1), want)
    g = torch.from_numpy(_normal(mesh.size, 5, 7))
    (gx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(gx, collectives.allreduce(g, mesh, axis))


def test_axis_ppermute_backward_is_the_inverse_permutation():
    mesh = _mesh(AXES)
    x = torch.from_numpy(_normal(mesh.size, 4)).requires_grad_()
    pairs = [(0, 1), (1, 2)]  # coordinate 0 receives nothing
    y = collectives.axis_ppermute(x, mesh, "sp", pairs)
    sp = mesh.axis_index("sp")
    src = mesh.shift_source("sp")
    assert torch.equal(y.detach()[sp == 0], torch.zeros(4, 4))
    assert torch.equal(y.detach()[sp > 0], x.detach()[src][sp > 0])
    g = torch.from_numpy(_normal(mesh.size, 4))
    (gx,) = torch.autograd.grad(y, x, g)
    # coordinate 2 sends nothing: zero cotangent
    assert torch.equal(gx[sp == 2], torch.zeros(4, 4))
    back = torch.zeros_like(g)
    back[src] = g
    assert torch.equal(gx[sp < 2], back[sp < 2])


@pytest.mark.parametrize("count", [3, 256])
def test_axis_alltoall_transposes_each_line_and_is_its_own_transpose(count):
    mesh = _mesh(AXES)
    n = AXES["sp"]
    x = torch.from_numpy(_normal(mesh.size, 2, n * count)).requires_grad_()
    y = collectives.axis_alltoall(x, mesh, "sp")
    for rows in _lines(mesh, "sp"):
        grid = x.detach()[rows].reshape(n, 2, n, count)
        assert torch.equal(y.detach()[rows].reshape(n, 2, n, count),
                           grid.permute(2, 1, 0, 3))
    g = torch.from_numpy(_normal(*x.shape))
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, collectives.alltoall(g, mesh, "sp"))
    # on the int8 wire each (rank, lead) row is one buffer of the
    # exchange: bitwise with the stacked 2-D calls, one lead row at a time
    wire = schedules.Wire(DEFAULT_ARITH_CONFIG[(DataType.float32,
                                                DataType.int8)])
    q = collectives.alltoall(x.detach(), mesh, "sp", wire)
    for rows in _lines(mesh, "sp"):
        for j in range(2):
            want = schedules.alltoall_schedule(x.detach()[rows, j], world=n,
                                               wire=wire)
            assert torch.equal(q[rows, j], want)


def test_axis_bcast_and_its_transpose_match_the_jax_package():
    """Forward: the root's row on every rank of the line. Backward: the
    tree's transpose (a sum of every rank's cotangent on the root, zero
    elsewhere), bitwise with jax.grad through the JAX package's
    bcast_bin_tree_schedule under shard_map."""
    world, root = 5, 3
    mesh = _mesh({"dp": 2, "pp": world})
    x = torch.from_numpy(_normal(mesh.size, 6)).requires_grad_()
    y = collectives.axis_bcast(x, mesh, "pp", root)
    pp = mesh.axis_index("pp")
    roots = x.detach()[pp == root]
    assert torch.equal(y.detach(), roots.repeat_interleave(world, 0))
    g = _normal(mesh.size, 6)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(g))

    wire = ref_schedules.Wire(None)

    def body(xi, gi):
        return jax.grad(lambda xx: jnp.sum(
            ref_schedules.bcast_bin_tree_schedule(
                xx, root=root, axis="pp", world=world, wire=wire) * gi))(xi)

    ref_mesh = RefMesh(np.array(jax.devices()[:world]), ("pp",))
    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=ref_mesh, in_specs=(RefP("pp"),) * 2,
        out_specs=RefP("pp"), check_vma=False))(
            x.detach().numpy().reshape(2, world, 6)[0],
            g.reshape(2, world, 6)[0]))
    assert np.array_equal(gx.numpy().reshape(2, world, 6)[0], want)
    assert torch.equal(gx[pp != root], torch.zeros(2 * (world - 1), 6))


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,hkv", [(True, 4), (False, 4), (True, 2)])
def test_ring_attention_matches_the_jax_package(causal, hkv):
    world, B, T, H, D = 4, 2, 32, 4, 16
    q = _normal(B, T, H, D)
    k, v = _normal(B, T, hkv, D), _normal(B, T, hkv, D)
    body = functools.partial(ref_ring_attention, axis_name="sp",
                             causal=causal)
    want = np.asarray(_ref_sp(body, world)(q, k, v))
    mesh = _mesh({"sp": world})
    got = ring_attention(*(_stacked(mesh, t) for t in (q, k, v)), mesh=mesh,
                         axis_name="sp", causal=causal)
    got = mesh.unshard(got, P(None, "sp")).numpy()
    _close(got, want, "against the JAX package")
    G = H // hkv
    np.testing.assert_allclose(
        got, reference_attention(q, np.repeat(k, G, 2), np.repeat(v, G, 2),
                                 causal), rtol=2e-4, atol=2e-4)


def test_ring_attention_q_gradient_matches_the_jax_package():
    world = 4
    q, k, v = (_normal(1, 32, 2, 8) for _ in range(3))

    def body(q, k, v):
        return jax.grad(lambda qq: jnp.sum(ref_ring_attention(
            qq, k, v, axis_name="sp", causal=True) ** 2))(q)

    want = np.asarray(_ref_sp(body, world)(q, k, v))
    mesh = _mesh({"sp": world})
    qs = _stacked(mesh, q).requires_grad_()
    out = ring_attention(qs, _stacked(mesh, k), _stacked(mesh, v),
                         mesh=mesh, axis_name="sp", causal=True)
    (g,) = torch.autograd.grad((out ** 2).sum(), qs)
    _close(mesh.unshard(g, P(None, "sp")), want, "q gradient")


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

QWIRE = DEFAULT_ARITH_CONFIG[(DataType.float32, DataType.int8)]


def _ref_qwire():
    from accl_tpu.arithconfig import DEFAULT_ARITH_CONFIG as REF_ARITH
    from accl_tpu.constants import DataType as RefDataType

    return ref_schedules.Wire(REF_ARITH[(RefDataType.float32,
                                         RefDataType.int8)])


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_exact_wire_matches_the_jax_package(causal):
    world, B, T, H, D = 4, 2, 32, 4, 8
    q, k, v = (_normal(B, T, H, D) for _ in range(3))
    body = functools.partial(ref_ulysses.ulysses_attention, axis_name="sp",
                             causal=causal)
    want = np.asarray(_ref_sp(body, world)(q, k, v))
    mesh = _mesh({"sp": world})
    got = mesh.unshard(ulysses_attention(
        *(_stacked(mesh, t) for t in (q, k, v)), mesh=mesh, axis_name="sp",
        causal=causal), P(None, "sp")).numpy()
    _close(got, want, "against the JAX package")
    np.testing.assert_allclose(got, reference_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


def test_ulysses_int8_wire_reshardings_bitwise_and_within_bound():
    """Each re-sharding of 64-element slots on the int8 wire (hop by hop,
    one quantization pass a slot) is bitwise the JAX package's; the
    round trip lands within the reference's 5e-2 of the exact wire."""
    world, B, T, H, D = 4, 2, 32, 4, 8
    q, k, v = (_normal(B, T, H, D) for _ in range(3))
    rwire = _ref_qwire()

    def body(x):
        return ref_ulysses._seq_to_heads(x, "sp", world, rwire)

    mesh = _mesh({"sp": world})
    want = np.asarray(_ref_sp(body, world, n_in=1)(q))
    wire = schedules.Wire(QWIRE)
    heads = ulysses._seq_to_heads(_stacked(mesh, q), mesh, "sp", world, wire)
    assert np.array_equal(mesh.unshard(heads, P(None, "sp")).numpy(), want)
    back = ulysses._heads_to_seq(heads, mesh, "sp", world, wire)
    want_back = np.asarray(_ref_sp(
        lambda x: ref_ulysses._heads_to_seq(body(x), "sp", world, rwire),
        world, n_in=1)(q))
    assert np.array_equal(mesh.unshard(back, P(None, "sp")).numpy(),
                          want_back)

    args = [_stacked(mesh, t) for t in (q, k, v)]
    exact = ulysses_attention(*args, mesh=mesh, axis_name="sp")
    quant = ulysses_attention(*args, mesh=mesh, axis_name="sp", wire=wire)
    assert not torch.equal(quant, exact)  # the wire really engaged
    np.testing.assert_allclose(quant.numpy(), exact.numpy(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("stripes", [2, 4])
def test_ulysses_striped_matches_unstriped_and_the_oracle(stripes):
    world, B, T, H, D = 4, 2, 8, 4 * stripes, 16
    q, k, v = (_normal(B, T * world, H, D) for _ in range(3))
    mesh = _mesh({"sp": world})
    args = [_stacked(mesh, t) for t in (q, k, v)]
    base = ulysses_attention(*args, mesh=mesh, axis_name="sp")
    striped = ulysses_attention(*args, mesh=mesh, axis_name="sp",
                                stripes=stripes)
    serial = ulysses_attention(*args, mesh=mesh, axis_name="sp",
                               stripes=stripes, serial=True)
    assert torch.equal(striped, serial)
    _close(striped, base, "striped against unstriped", tol=1e-6)
    np.testing.assert_allclose(
        mesh.unshard(striped, P(None, "sp")).numpy(),
        reference_attention(q, k, v, True), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="stripes"):
        ulysses_attention(*args, mesh=mesh, axis_name="sp",
                          stripes=3 * stripes)


def test_ulysses_is_differentiable_through_the_alltoall():
    world, B, T, H, D = 2, 1, 8, 2, 4
    q, k, v = (_normal(B, T, H, D) for _ in range(3))
    mesh = _mesh({"sp": world})
    qs = _stacked(mesh, q).requires_grad_()
    out = ulysses_attention(qs, _stacked(mesh, k), _stacked(mesh, v),
                            mesh=mesh, axis_name="sp")
    (g,) = torch.autograd.grad((out ** 2).sum(), qs)
    rq = torch.from_numpy(q).requires_grad_()
    ring = ring_attention(*(t[None] for t in (rq, torch.from_numpy(k),
                                              torch.from_numpy(v))),
                          mesh=_mesh({"sp": 1}), axis_name="sp")
    (want,) = torch.autograd.grad((ring ** 2).sum(), rq)
    _close(mesh.unshard(g, P(None, "sp")), want, "q gradient")


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------


def _gpipe_params(pp, d, hidden):
    return {"w1": _normal(pp, d, hidden) * 0.1,
            "b1": _normal(pp, hidden) * 0.1,
            "w2": _normal(pp, hidden, d) * 0.1}


def _sequential(params, x):
    h = x
    for i in range(params["w1"].shape[0]):
        h = h + np.tanh(h @ params["w1"][i] + params["b1"][i]) \
            @ params["w2"][i]
    return h


@pytest.mark.parametrize("pp,mb", [(4, 4), (8, 4), (2, 2)])
def test_gpipe_mlp_forward_matches_the_jax_package(pp, mb):
    d = 16
    params = _gpipe_params(pp, d, 32)
    x = _normal(mb * 3, d)
    mesh = _mesh({"pp": pp})
    stacked = {k: mesh.shard(torch.from_numpy(v), P("pp"))
               for k, v in params.items()}
    out = pipeline.make_gpipe_mlp_forward(mesh, n_microbatches=mb)(
        stacked, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, _sequential(params, x), rtol=2e-4,
                               atol=2e-5)
    if pp == 4:
        ref_mesh = RefMesh(np.array(jax.devices()[:pp]), ("pp",))
        want = np.asarray(ref_pipeline.make_gpipe_mlp_forward(
            ref_mesh, n_microbatches=mb)(params, x))
        _close(out, want, "against the JAX package")


def test_gpipe_gradients_match_the_jax_package():
    """Gradients of a scalar loss w.r.t. every stage's weights through
    the pipeline (the inverse hops, the bcast's transpose, the 1/P
    descale) against jax.grad through the JAX package's gpipe_schedule
    under shard_map."""
    pp, mb, d = 4, 4, 8
    params = _gpipe_params(pp, d, 16)
    x = _normal(mb * 2, d)
    wire = ref_schedules.Wire(None)

    def body(p, xv):
        def loss_fn(pl):
            loc = jax.tree.map(lambda t: t[0], pl)

            def st(h):
                return h + jnp.tanh(h @ loc["w1"] + loc["b1"]) @ loc["w2"]

            out = ref_pipeline.gpipe_schedule(
                xv.reshape((mb, -1, d)), st, axis="pp", world=pp, wire=wire)
            return jnp.sum(out ** 2)

        return jax.grad(loss_fn)(p)

    ref_mesh = RefMesh(np.array(jax.devices()[:pp]), ("pp",))
    want = jax.jit(jax.shard_map(
        body, mesh=ref_mesh, in_specs=({k: RefP("pp") for k in params},
                                       RefP()),
        out_specs={k: RefP("pp") for k in params}, check_vma=False))(
            params, x)

    mesh = _mesh({"pp": pp})
    leaves = {k: mesh.shard(torch.from_numpy(v), P("pp")).requires_grad_()
              for k, v in params.items()}
    local = {k: v[:, 0] for k, v in leaves.items()}

    def stage(h):
        return h + torch.tanh(h @ local["w1"] + local["b1"][:, None]) \
            @ local["w2"]

    xs = mesh.shard(torch.from_numpy(x)).reshape(pp, mb, -1, d)
    out = gpipe_schedule(xs, stage, mesh=mesh, axis="pp",
                         wire=schedules.Wire(None))
    # every rank computes the same loss, as every reference device does
    loss = (out ** 2).sum(dim=(1, 2, 3)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (k, g) in zip(leaves, grads):
        np.testing.assert_allclose(mesh.unshard(g, P("pp")).numpy(),
                                   np.asarray(want[k]), rtol=5e-4,
                                   atol=5e-5, err_msg=k)
