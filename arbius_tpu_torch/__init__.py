"""PyTorch/CUDA port of the arbius_tpu solve path for one NVIDIA H100.

The JAX package `arbius_tpu` is the reference; this package mirrors its
module paths (``arbius_tpu_torch/ops/flash.py`` is the twin of
``arbius_tpu/ops/flash.py``) and imports nothing of it, nor JAX. Host
layers that need no accelerator (L0 hashing, codecs, templates) are kept
as copies here, and the tests hold every copy's output byte-equal to its
twin's.

Entry points take ``device=`` and default to ``"cuda"``: on a host with no
CUDA they raise unless the caller passes ``device="cpu"``.
"""
