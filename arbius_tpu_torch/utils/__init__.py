"""Device selection and the determinism settings of the port, and its
checkpoint files."""
from arbius_tpu_torch.utils.checkpoint import (
    cast_floating,
    load_params,
    load_safetensors,
    save_params,
)
from arbius_tpu_torch.utils.platform import card_info, setup_device

__all__ = ["card_info", "cast_floating", "load_params", "load_safetensors",
           "save_params", "setup_device"]
