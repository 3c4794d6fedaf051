"""Precision modes: the JAX-free name registry (`modes.py`, a copy of
arbius_tpu/quant/modes.py) and the quantization math (`core.py`, the
torch twin of arbius_tpu/quant/core.py; docs/quantization.md)."""
from arbius_tpu_torch.quant.core import (
    QUANT_KEYS,
    QuantAxis,
    QuantizedWeights,
    dequantize_first,
    dequantize_leaf,
    dequantize_state,
    is_quantized_leaf,
    quantize_leaf,
    quantize_state,
    storage_dtype,
)
from arbius_tpu_torch.quant.modes import (
    DEFAULT_MODE,
    FP8_BOUND,
    INT8_BOUND,
    PRECISION_MODES,
    mode_tag,
    validate_mode,
    wire_width,
)

__all__ = [
    "DEFAULT_MODE", "FP8_BOUND", "INT8_BOUND", "PRECISION_MODES",
    "QUANT_KEYS", "QuantAxis", "QuantizedWeights", "dequantize_first",
    "dequantize_leaf", "dequantize_state", "is_quantized_leaf", "mode_tag",
    "quantize_leaf", "quantize_state", "storage_dtype", "validate_mode",
    "wire_width",
]
