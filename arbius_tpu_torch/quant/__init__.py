"""Precision modes. Only the JAX-free name registry (`modes.py`, a copy
of arbius_tpu/quant/modes.py) is ported; the quantisation math
(`quant/core.py`) waits for the port of precision modes."""
