"""The solve path of the port: runner, registry entry, factory."""
from arbius_tpu_torch.node.factory import build_anythingv3
from arbius_tpu_torch.node.solver import (
    RegisteredModel,
    SD15Runner,
    chunk_items,
    solve_cid_batch,
    solve_files_batch,
)

__all__ = [
    "RegisteredModel",
    "SD15Runner",
    "build_anythingv3",
    "chunk_items",
    "solve_cid_batch",
    "solve_files_batch",
]
