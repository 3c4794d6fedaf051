"""Device selection and the determinism settings of the port."""
from arbius_tpu_torch.utils.platform import card_info, setup_device

__all__ = ["card_info", "setup_device"]
