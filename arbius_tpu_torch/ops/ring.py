"""Ring attention over the `sp` lanes of a mesh: sequence parallelism.

Twin of arbius_tpu/ops/ring.py in lane form. The sequence is sharded
over the lanes; each lane keeps its Q and the K/V shards rotate around
the ring (`parallel.collectives.ring_pass`) while each lane accumulates
attention in the online-softmax form: running max m, normaliser l and
weighted sum acc, all float32. After sp - 1 rotations every query has
seen every key without any lane holding the whole sequence's K/V.

Each block is a product, as in the reference (not a kernel call). For
bf16 inputs the port takes a block's scores and its P V in float32 from
the bf16 operands and rounds P to the input dtype before P V, as the
flash kernels do (ops/flash.py `error_bound` bounds both); the
reference's einsums round S and each block's P V to bf16. In float32
the two are the same arithmetic.

    outs = ring_attention(qs, ks, vs)   # one [B, H, S/sp, D] per lane
"""
from __future__ import annotations

import math

import torch

from arbius_tpu_torch.parallel.collectives import ring_pass
from arbius_tpu_torch.parallel.mesh import on_device


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # P rounded to the input dtype, the product in float32
    return torch.matmul(p.to(v.dtype).float(), v.float())


def _attn_block(q, k, v):
    """One (local Q, one K/V shard) block: (row max [B, H, Sq],
    exp-weighted sum [B, H, Sq, D], normaliser [B, H, Sq]), float32."""
    s = _scores(q, k)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, _pv(p, v), p.sum(dim=-1)


def ring_attention(qs, ks, vs, *, axis_name: str = "sp",
                   mesh=None) -> list[torch.Tensor]:
    """Exact attention over a sequence sharded on `axis_name`'s lanes.

    q/k/v per lane [B, H, S_local, D]; returns one [B, H, S_local, D] in
    q's dtype per lane. `mesh` as in parallel/collectives.py (None: the
    lists are one ring)."""
    n = len(qs) if mesh is None else mesh.shape[axis_name]
    state = []
    for q, k, v in zip(qs, ks, vs):
        with on_device(q.device):
            state.append(_attn_block(q, k, v))
    for _ in range(n - 1):
        ks = ring_pass(ks, axis_name, mesh=mesh)
        vs = ring_pass(vs, axis_name, mesh=mesh)
        for i, (q, k, v) in enumerate(zip(qs, ks, vs)):
            with on_device(q.device):
                m, acc, l = state[i]
                mb, accb, lb = _attn_block(q, k, v)
                m_new = torch.maximum(m, mb)
                a1 = torch.exp(m - m_new)
                a2 = torch.exp(mb - m_new)
                state[i] = (m_new, acc * a1[..., None] + accb * a2[..., None],
                            l * a1 + lb * a2)
    return [(acc / l[..., None]).to(q.dtype)
            for q, (_, acc, l) in zip(qs, state)]


def sp_attention_reference(q, k, v) -> torch.Tensor:
    """Single-device exact attention with the same float32 policy: the
    oracle ring attention is held to."""
    return _pv(torch.softmax(_scores(q, k), dim=-1), v).to(q.dtype)
