"""Ulysses-style all-to-all sequence parallelism over the `sp` lanes.

Twin of arbius_tpu/ops/ulysses.py in lane form: one `all_to_all`
re-shards q, k and v from sequence-sharded to head-sharded, each lane's
head group then attends over the full sequence with the port's
`ops.flash.attention` (a Hopper kernel for CUDA tensors, the plain
version for CPU ones), and a second `all_to_all` restores sequence
sharding. Needs heads % sp == 0. Exact, like ring attention: the same
math over a different layout.

    outs = ulysses_attention(qs, ks, vs)   # one [B, H, S/sp, D] per lane
"""
from __future__ import annotations

import torch

from arbius_tpu_torch.ops.flash import attention
from arbius_tpu_torch.parallel.collectives import all_to_all
from arbius_tpu_torch.parallel.mesh import on_device


def ulysses_attention(qs, ks, vs, *, axis_name: str = "sp",
                      mesh=None) -> list[torch.Tensor]:
    """Exact attention over a sequence sharded on `axis_name`'s lanes.

    q/k/v per lane [B, H, S_local, D] with H % sp == 0; returns one
    [B, H, S_local, D] in q's dtype per lane. `mesh` as in
    parallel/collectives.py (None: the lists are one group)."""
    sp = len(qs) if mesh is None else mesh.shape[axis_name]
    h = qs[0].shape[1]
    if h % sp:
        raise ValueError(f"ulysses needs heads ({h}) divisible by the "
                         f"sp axis size ({sp})")

    def seq_to_heads(xs):
        # [B, H, S/sp, D] -> [B, H/sp, S, D]: each lane a head group over
        # the full sequence
        return all_to_all(xs, axis_name, split_axis=1, concat_axis=2,
                          mesh=mesh)

    qs, ks, vs = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    outs = []
    for q, k, v in zip(qs, ks, vs):
        with on_device(q.device):
            outs.append(attention(q, k, v))
    return all_to_all(outs, axis_name, split_axis=2, concat_axis=1,
                      mesh=mesh)
