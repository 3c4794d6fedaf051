"""Deterministic PNG encoding — the artifact-byte layer of the solve path.

Copies of the reference's `codecs/png.py` and `codecs/deflate.py` (and
its native deflate core, as csrc/codecs.cc): the solution CID is computed
over the encoded bytes, so they are pinned by specification and every
miner produces the same bytes.
"""
from arbius_tpu_torch.codecs.png import encode_png

__all__ = ["encode_png"]
