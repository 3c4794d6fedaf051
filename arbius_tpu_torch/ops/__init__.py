"""Attention ops: the Hopper flash kernels, the rule between them, and
their plain version; ring and Ulysses sequence parallelism over a mesh's
lanes."""
from arbius_tpu_torch.ops.flash import (
    attention,
    error_bound,
    flash_attention,
    flash_attention_reference,
    route,
)
from arbius_tpu_torch.ops.ring import ring_attention, sp_attention_reference
from arbius_tpu_torch.ops.ulysses import ulysses_attention

__all__ = ["attention", "error_bound", "flash_attention",
           "flash_attention_reference", "ring_attention", "route",
           "sp_attention_reference", "ulysses_attention"]
