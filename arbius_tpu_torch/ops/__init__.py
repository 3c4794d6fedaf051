"""Attention ops: the Hopper flash kernel and its plain version."""
from arbius_tpu_torch.ops.flash import (
    attention,
    flash_attention,
    flash_attention_reference,
)

__all__ = ["attention", "flash_attention", "flash_attention_reference"]
