"""DeepSeek-V3's MoE layer on the port (models/moe.py's V3 half): the
group-limited sigmoid router, the shares of the held experts against the
plain reference (models/deepseek_v3_reference.py), the fused step, its
eager twin and the reference, and the slot-driven alltoallv
(schedules.SlotRows) whose rows the router places, against a plain
oracle under skew.

Small widths that keep the structure: hidden 64, expert width 32, 32
routed experts in 8 groups, the top 4 groups, the top 8 experts. The
tests marked `card` run the kernels of ops/moe_kernels.py against their
plain versions and the fused step on a CUDA device; they skip without
one. This file imports no JAX, so on a machine with a card it runs as

    python -m pytest --noconftest tests/test_torch_moe_deepseek.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from accl_tpu_torch import ACCL, DataType
from accl_tpu_torch.models import deepseek_v3_reference as ref
from accl_tpu_torch.models import moe
from accl_tpu_torch.sequencer import schedules

D, FW, E, T = 64, 32, 32, 6
CFG = dict(hidden=D, n_group=8, topk_group=4, top_k=8, tokens=T)
ROUTE = dict(n_group=8, topk_group=4, top_k=8, routed_scaling=2.5)


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normal(rng, *shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32)


def _layer(rng, experts=E, bias=0.1):
    """One layer's weights: the router over every expert, `experts`
    stacked expert weights, the shared expert."""
    return dict(router=_normal(rng, E, D, scale=D ** -0.5),
                bias=_normal(rng, E, scale=bias),
                w_gate=_normal(rng, experts, FW, D, scale=D ** -0.5),
                w_up=_normal(rng, experts, FW, D, scale=D ** -0.5),
                w_down=_normal(rng, experts, D, FW, scale=FW ** -0.5),
                shared_gate=_normal(rng, FW, D, scale=D ** -0.5),
                shared_up=_normal(rng, FW, D, scale=D ** -0.5),
                shared_down=_normal(rng, D, FW, scale=FW ** -0.5))


def _held(w, first, n):
    return {k: v[first:first + n] if k in ("w_gate", "w_up", "w_down")
            else v for k, v in w.items()}


def _f64(w):
    return {k: v.double() for k, v in w.items()}


# -- the router -------------------------------------------------------------


def test_router_selects_and_gates_as_the_reference():
    rng = np.random.default_rng(2801)
    w = _layer(rng)
    x = _normal(rng, 96, D)
    cfg = moe.V3MoEConfig(**CFG)
    idx, gate = moe.v3_route(x, w["router"], w["bias"], cfg)
    ridx, rgate, margin = ref.route(x.double(), w["router"], w["bias"],
                                    **ROUTE)
    sure = margin > 1e-5  # float32 and float64 agree off near ties
    assert sure.float().mean() > 0.9
    assert torch.equal(idx[sure], ridx[sure])
    torch.testing.assert_close(gate[sure].double(), rgate[sure],
                               rtol=1e-6, atol=0)
    # every token picks its experts inside 4 of the 8 groups
    for row in idx:
        assert len(set((row // (E // 8)).tolist())) <= 4


def test_the_bias_moves_selection_but_not_gates():
    rng = np.random.default_rng(2802)
    w = _layer(rng, bias=0.0)
    x = _normal(rng, 128, D)
    cfg = moe.V3MoEConfig(**CFG)
    bias = torch.zeros(E)
    bias[5] = 1.0  # expert 5 wins selection wherever its group is chosen
    idx0, gate0 = moe.v3_route(x, w["router"], bias * 0, cfg)
    idx1, gate1 = moe.v3_route(x, w["router"], bias, cfg)
    assert (idx1 == 5).any(1).sum() > (idx0 == 5).any(1).sum()
    # gates are the unbiased scores: where the selection is the same set,
    # the gates are the same numbers
    same = (idx0.sort(1).values == idx1.sort(1).values).all(1)
    assert same.any() and (~same).any()
    g0 = gate0.gather(1, idx0.argsort(1))
    g1 = gate1.gather(1, idx1.argsort(1))
    torch.testing.assert_close(g0[same], g1[same], rtol=1e-6, atol=0)


def test_the_shares_of_the_groups_add_up_to_the_whole_layer():
    rng = np.random.default_rng(2803)
    w = _f64(_layer(rng))
    x = _normal(rng, 64, D).double()
    whole, _ = ref.layer_share(x, w, held_first=0, held=E, route_kw=ROUTE)
    per_group = E // 8
    total = ref.swiglu(x, w["shared_gate"], w["shared_up"],
                       w["shared_down"])
    for g in range(8):
        share, _ = ref.layer_share(x, _held(w, g * per_group, per_group),
                                   held_first=g * per_group,
                                   held=per_group, shared=False,
                                   route_kw=ROUTE)
        total = total + share
    torch.testing.assert_close(total, whole, rtol=1e-12, atol=1e-12)


# -- the layer step -----------------------------------------------------------


def _step(world, held, layers, inputs, *, fused, device="cpu", wire=None):
    accl = ACCL(world=world, torch_device=device)
    cfg = moe.V3MoEConfig(**CFG, held=held)
    xs = [accl.create_buffer(T * D) for _ in layers]
    ys = [accl.create_buffer(T * D) for _ in layers]
    for b, x in zip(xs, inputs):
        b.device = x.to(device).clone()
    weights = [{k: v.to(device) for k, v in _held(w, 0, held).items()}
               for w in layers]
    step = moe.V3MoEStep(accl, cfg, weights, xs, ys, fused=fused,
                         compress_dtype=wire, lint="warn")
    for _ in range(2):  # a second dispatch over the same bound buffers
        step.wait(step.run())
    return [y.device.cpu() for y in ys], step.counters()


@pytest.mark.parametrize("world,held", [(4, 4), (2, 8)],
                         ids=["w4.one_group", "w2.two_groups"])
def test_fused_eager_and_reference_agree(world, held):
    rng = np.random.default_rng(2804 + world)
    layers = [_layer(rng) for _ in range(2)]
    inputs = [_normal(rng, world, T * D) for _ in layers]
    fused, counted = _step(world, held, layers, inputs, fused=True)
    eager, _ = _step(world, held, layers, inputs, fused=False)
    for a, b in zip(fused, eager):
        assert torch.equal(a, b)
    assert counted["moe_dropped"] == 0 and counted["moe_rows"] > 0
    # the token rows the dispatch reads: those with a held expert
    cfg = moe.V3MoEConfig(**CFG, held=held)
    assert counted["moe_tokens_routed"] == sum(
        int((moe.v3_route(x.reshape(-1, D), w["router"], w["bias"],
                          cfg)[0] < held).any(-1).sum())
        for x, w in zip(inputs, layers))
    for y, x, w in zip(fused, inputs, layers):
        x64 = x.reshape(world * T, D).double()
        want, margin = ref.layer_share(x64, _f64(_held(w, 0, held)),
                                       held_first=0, held=held,
                                       route_kw=ROUTE)
        sure = margin > 1e-5
        # float32 against float64: a few units of 2**-24 of the largest
        # contribution a token sums (K = 64-long products, one SwiGLU)
        err = (y.reshape(world * T, D).double() - want).abs()
        assert err[sure].max() <= 64 * 2.0 ** -24 * want.abs().max()


def test_the_bfloat16_wire_changes_the_result_by_its_rounding():
    rng = np.random.default_rng(2806)
    layers = [_layer(rng)]
    inputs = [_normal(rng, 4, T * D)]
    exact, _ = _step(4, 4, layers, inputs, fused=True)
    cast, _ = _step(4, 4, layers, inputs, fused=True,
                    wire=DataType.bfloat16)
    gap = (exact[0] - cast[0]).abs().max().item()
    assert 1e-4 < gap < 0.1


# -- the count-driven exchange ----------------------------------------------


def _skewed(kind, world, held, rng):
    """(W, T, K) routing of held experts 0 .. held-1 plus unheld ones."""
    K = 8
    idx = torch.tensor(rng.integers(held, E, (world, T, K)))
    per_rank = held // world
    for s in range(world):
        for t in range(T):
            if kind == "to_one_rank":    # every token to rank 1's experts
                idx[s, t, :per_rank] = torch.arange(per_rank) + per_rank
            elif kind == "none_to_rank_0":
                choice = rng.choice(np.arange(per_rank, held), 3,
                                    replace=False)
                idx[s, t, :3] = torch.tensor(choice)
            else:
                choice = rng.choice(held, 3, replace=False)
                idx[s, t, :3] = torch.tensor(choice)
    gate = torch.tensor(rng.random((world, T, K)), dtype=torch.float32)
    return idx, gate


def _oracle(x, idx, gate, held, world, rows_per_rank):
    """The exchange, row by row: expert e's rows on rank e // per_rank,
    one expert after the other, each by source rank then token."""
    per_rank = held // world
    expert_out = torch.zeros(world * rows_per_rank, D)
    where = {}
    for d in range(world):
        row = d * rows_per_rank
        for e in range(d * per_rank, (d + 1) * per_rank):
            for s in range(world):
                for t in range(T):
                    for k in range(idx.shape[-1]):
                        if idx[s, t, k] == e:
                            expert_out[row] = x[s, t]
                            where[(s, t, k)] = row
                            row += 1
    back = torch.zeros(world, T, D)
    for (s, t, k), row in sorted(where.items()):
        back[s, t] = back[s, t] + gate[s, t, k] * (expert_out[row] * 1.5)
    return expert_out, where, back


@pytest.mark.parametrize("kind", ["spread", "to_one_rank",
                                  "none_to_rank_0"])
def test_the_counted_exchange_matches_a_plain_oracle(kind):
    world, held = 4, 8
    rng = np.random.default_rng(2807)
    cfg = moe.V3MoEConfig(**CFG, held=held)
    accl = ACCL(world=world, torch_device="cpu")
    routing = moe.V3Routing(cfg, world, "cpu")
    idx, gate = _skewed(kind, world, held, rng)
    routing.plan(idx, gate)
    assert int(routing.dropped) == 0
    x = _normal(rng, world, T, D)
    rows = routing.rows_per_rank
    src = accl.create_buffer(T * D)
    mid = accl.create_buffer(rows * D)
    out = accl.create_buffer(T * D)
    src.device = x.reshape(world, -1).clone()
    accl.alltoallv(src, mid, D, routing.dispatch, from_device=True,
                   to_device=True)
    expert_out, where, back = _oracle(x, idx, gate, held, world, rows)
    got = mid.device.reshape(-1, D)
    placed = sorted(set(where.values()))
    assert torch.equal(got[placed], expert_out[placed])
    # each (source, destination) count is what the oracle moved
    counts = torch.zeros(world, world, dtype=torch.int32)
    for (s, _, _), row in where.items():
        counts[s, row // rows] += 1
    assert torch.equal(routing.counts, counts)
    if kind == "to_one_rank":
        assert counts[:, 1].sum() == counts.sum()
    if kind == "none_to_rank_0":
        assert counts[:, 0].sum() == 0
    # the combine leg, over expert rows scaled as an expert would
    mid.device = mid.device * 1.5
    accl.alltoallv(mid, out, D, routing.combine, from_device=True,
                   to_device=True)
    assert torch.equal(out.device.reshape(world, T, D), back)


def test_a_counted_layout_refuses_what_it_cannot_run():
    cfg = moe.V3MoEConfig(**CFG, held=8)
    routing = moe.V3Routing(cfg, 4, "cpu")
    accl = ACCL(world=4, torch_device="cpu")
    a = accl.create_buffer(T * D)
    b = accl.create_buffer(routing.rows_per_rank * D)
    with pytest.raises(ValueError, match="row width"):
        accl.alltoallv(a, b, D + 1, routing.dispatch)
    with pytest.raises(NotImplementedError, match="int8"):
        accl.alltoallv(a, b, D, routing.dispatch,
                       compress_dtype=DataType.int8)
    with pytest.raises(ValueError, match="mode"):
        schedules.SlotRows("combine", width=D, tokens=T, rows_per_rank=8,
                           slot_row=routing.slot_row)
    with pytest.raises(ValueError, match="weight"):
        schedules.SlotRows("gather", width=D, tokens=T, rows_per_rank=8,
                           slot_row=routing.slot_row)


# -- on the card --------------------------------------------------------------


@pytest.mark.card
def test_on_the_card_the_kernels_match_their_plain_versions(card):
    from accl_tpu_torch.ops import moe_kernels as mk

    rng = np.random.default_rng(2808)
    H, Dk, Fk, rows = 6, 256, 128, 70
    counts = torch.tensor([0, 1, 33, 70, 5, 32], dtype=torch.int32)
    starts = torch.tensor([0, 70, 140, 210, 280, 350], dtype=torch.int32)
    x = _normal(rng, H * rows, Dk)
    wg = _normal(rng, H, Fk, Dk, scale=Dk ** -0.5)
    wu = _normal(rng, H, Fk, Dk, scale=Dk ** -0.5)
    wd = _normal(rng, H, Dk, Fk, scale=Fk ** -0.5)
    want = mk.expert_swiglu(x, starts, counts, wg, wu, wd, rows)
    got = mk.expert_swiglu(*(t.to(card) for t in (x, starts, counts, wg, wu,
                                                   wd)), rows).cpu()
    for e in range(H):
        lo, n = int(starts[e]), int(counts[e])
        torch.testing.assert_close(got[lo:lo + n], want[lo:lo + n],
                                   rtol=1e-4, atol=1e-5)
    world, held = 4, 8
    cfg = moe.V3MoEConfig(**CFG, held=held)
    for kind in ("spread", "to_one_rank", "none_to_rank_0"):
        idx, gate = _skewed(kind, world, held, rng)
        plans = []
        for dev in ("cpu", card):
            r = moe.V3Routing(cfg, world, dev)
            r.plan(idx.to(dev), gate.to(dev))
            plans.append(r)
        assert torch.equal(plans[0].slot_row, plans[1].slot_row.cpu())
        x = _normal(rng, world, T * D)
        rows_ = plans[0].rows_per_rank
        cpu_mid = mk.dispatch_rows(x, plans[0].slot_row, rows_)
        card_mid = mk.dispatch_rows(x.to(card), plans[1].slot_row, rows_)
        placed = plans[0].slot_row[plans[0].slot_row >= 0].long()
        assert torch.equal(card_mid.cpu().view(-1, D)[placed],
                           cpu_mid.view(-1, D)[placed])
        back = mk.combine_rows(cpu_mid, plans[0].slot_row, gate, D)
        got = mk.combine_rows(card_mid, plans[1].slot_row, gate.to(card), D)
        torch.testing.assert_close(got.cpu(), back, rtol=1e-6, atol=1e-6)


@pytest.mark.card
def test_on_the_card_the_fused_step_matches_eager_and_the_reference(card):
    rng = np.random.default_rng(2809)
    world, held = 4, 8
    layers = [_layer(rng) for _ in range(2)]
    inputs = [_normal(rng, world, T * D) for _ in layers]
    fused, _ = _step(world, held, layers, inputs, fused=True, device=card)
    eager, _ = _step(world, held, layers, inputs, fused=False, device=card)
    for a, b in zip(fused, eager):
        assert torch.equal(a, b)
    for y, x, w in zip(fused, inputs, layers):
        want, margin = ref.layer_share(
            x.reshape(world * T, D).double(), _f64(_held(w, 0, held)),
            held_first=0, held=held, route_kw=ROUTE)
        sure = margin > 1e-5
        err = (y.reshape(world * T, D).double() - want).abs()
        assert err[sure].max() <= 64 * 2.0 ** -24 * want.abs().max()
