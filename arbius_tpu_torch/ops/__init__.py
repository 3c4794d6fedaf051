"""Attention ops: the Hopper flash kernels, the rule between them, and
their plain version."""
from arbius_tpu_torch.ops.flash import (
    attention,
    error_bound,
    flash_attention,
    flash_attention_reference,
    route,
)

__all__ = ["attention", "error_bound", "flash_attention",
           "flash_attention_reference", "route"]
