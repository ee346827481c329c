"""Ring attention: exact attention over sequences sharded across a mesh
axis, with K/V blocks rotating around the ring.

Counterpart of accl_tpu/parallel/ring_attention.py. The per-hop payload
is the K/V block and the local combine a numerically stable online
softmax (running max m, normalizer l, weighted value acc), merged hop by
hop. The tensors are the mesh's stacked (R, B, T_local, H, D) shards;
every rank's block attends at once, one batched product a hop. A hop is
a gather along the rank axis (row r takes the row of its predecessor on
the axis, `Mesh.shift_source`), which autograd differentiates as it is,
so the same function serves training.
"""

from __future__ import annotations

import math

import torch


def _block_attend(q, k, v, q_pos, k_pos, causal, sm_scale):
    """Scores + masked online-softmax statistics for one K/V block.

    q: (R, B, Tq, H, D), k/v: (R, B, Tk, Hkv, D) with H a multiple of Hkv
    (grouped-query attention), q_pos (R, Tq) and k_pos (R, Tk) the global
    positions. Returns (m, l, acc) partials in fp32 with a (R, B, Hkv, G,
    ...) head layout: per-query running max, normalizer, and value
    accumulator."""
    R, B, Tq, H, D = q.shape
    Hkv = k.shape[3]
    qg = q.reshape(R, B, Tq, Hkv, H // Hkv, D)
    s = torch.einsum("rbqhgd,rbkhd->rbhgqk", qg, k).float() * sm_scale
    if causal:
        mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (R, Tq, Tk)
        s = torch.where(mask[:, None, None, None], s, -math.inf)
    m = s.amax(-1)  # (R, B, Hkv, G, Tq)
    # guard fully-masked rows (m = -inf) so exp stays finite
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("rbhgqk,rbkhd->rbhgqd", p.to(v.dtype), v).float()
    return m_safe, l, acc


def _merge(state, new):
    """Combine two online-softmax partials (the associative flash merge)."""
    m0, l0, a0 = state
    m1, l1, a1 = new
    m = torch.maximum(m0, m1)
    c0 = torch.exp(m0 - m)
    c1 = torch.exp(m1 - m)
    l = l0 * c0 + l1 * c1
    a = a0 * c0[..., None] + a1 * c1[..., None]
    return m, l, a


def ring_attention(q, k, v, *, mesh, axis_name: str, causal: bool = True,
                   sm_scale: float | None = None):
    """q, k, v: the stacked local sequence shards (R, B, T_local, H, D)
    (k and v at Hkv heads); the global sequence is the concatenation of
    the shards over the axis in coordinate order. Returns the stacked
    local attention output (R, B, T_local, H, D)."""
    world = mesh.axis_size(axis_name)
    me = mesh.axis_index(axis_name)  # (R,)
    R, B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    local = torch.arange(T, device=q.device)
    q_pos = me[:, None] * T + local  # (R, T)

    # local block first
    state = _block_attend(q, k, v, q_pos, q_pos, causal, sm_scale)
    src = mesh.shift_source(axis_name)
    k_r, v_r = k, v
    for s in range(world - 1):
        k_r, v_r = k_r[src], v_r[src]
        # after s+1 hops the arriving block originated at rank me-1-s
        origin = (me - 1 - s) % world
        k_pos = origin[:, None] * T + local
        new = _block_attend(q, k_r, v_r, q_pos, k_pos, causal, sm_scale)
        state = _merge(state, new)

    m, l, acc = state
    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows emit zeros
    out = (acc / l[..., None]).to(q.dtype)  # (R, B, Hkv, G, T, D)
    # head h = hkv*G + g, matching the grouping in _block_attend
    return out.reshape(R, B, H, T, D).transpose(2, 3)
