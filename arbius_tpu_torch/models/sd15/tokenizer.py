"""Deterministic prompt tokenizer.

The reference's tokenization happens inside its cog container (CLIP BPE).
This environment has zero egress, so the real BPE vocab/merges can't be
fetched; the framework therefore ships a fully deterministic byte-level
tokenizer as the default. (The reference's `CLIPBPETokenizer`, for a
locally provided CLIP vocabulary, is not ported yet.)

Determinism is the property the protocol needs — the tokenizer is part of
the model's identity (a template pins a specific model build), and any
fixed mapping works as long as every miner runs the same one.
"""
from __future__ import annotations

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
MAX_LENGTH = 77


class ByteTokenizer:
    """UTF-8 byte-level tokenizer into the CLIP id space.

    ids 0..255 are raw bytes; BOS/EOS/pad use the CLIP special ids so the
    embedding table shape matches the standard text tower.
    """

    def __init__(self, max_length: int = MAX_LENGTH,
                 bos_id: int = BOS_ID, eos_id: int = EOS_ID):
        self.max_length = max_length
        self.bos_id = bos_id
        self.eos_id = eos_id

    def encode(self, text: str) -> np.ndarray:
        raw = list(text.encode("utf-8"))[: self.max_length - 2]
        ids = [self.bos_id] + raw + [self.eos_id]
        ids += [self.eos_id] * (self.max_length - len(ids))  # CLIP pads with EOS
        return np.asarray(ids, dtype=np.int32)

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])
