"""Deterministic prompt tokenizer.

The reference's tokenization happens inside its cog container (CLIP BPE).
This environment has zero egress, so the real BPE vocab/merges can't be
fetched; the framework therefore ships a fully deterministic byte-level
tokenizer as the default, and can load a standard CLIP BPE vocab from local
files when an operator provides one (`CLIPBPETokenizer.from_files`).

Determinism is the property the protocol needs — the tokenizer is part of
the model's identity (a template pins a specific model build), and any
fixed mapping works as long as every miner runs the same one.
"""
from __future__ import annotations

import json
import re

import numpy as np

# CLIP's pre-tokenization pattern (contractions, letter runs, single digits,
# punctuation runs) expressed with stdlib re: [^\W\d_]+ matches unicode
# letter runs, \d single digits, [^\s\w]+ punctuation/symbol runs.
_CLIP_SPLIT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+|_+", re.IGNORECASE)

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


class CLIPBPETokenizer:
    """Standard CLIP byte-pair tokenizer, loaded from local vocab files.

    Implements lowercasing, whitespace-split + punctuation regex-free word
    splitting, and greedy merge ranking over `merges.txt`, producing ids
    compatible with pretrained CLIP text towers.
    """

    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = MAX_LENGTH):
        self.encoder = encoder
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.bos_id = encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = encoder.get("<|endoftext|>", EOS_ID)
        self._byte_encoder = _bytes_to_unicode()

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPBPETokenizer":
        with open(vocab_path) as f:
            encoder = json.load(f)
        with open(merges_path) as f:
            lines = f.read().splitlines()
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        return cls(encoder, merges)

    def _bpe(self, token: str) -> list[str]:
        # CLIP attaches </w> to the LAST CHARACTER, not as its own symbol
        if token.endswith("</w>") and len(token) > 4:
            base = token[:-4]
            word = list(base[:-1]) + [base[-1] + "</w>"]
        else:
            word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> np.ndarray:
        text = re.sub(r"\s+", " ", text.lower().strip())
        words = _CLIP_SPLIT.findall(text)
        ids = [self.bos_id]
        for w in words:
            mapped = "".join(self._byte_encoder[b] for b in w.encode("utf-8"))
            for piece in self._bpe(mapped + "</w>"):
                ids.append(self.encoder.get(piece, self.eos_id))
        ids = ids[: self.max_length - 1] + [self.eos_id]
        ids += [self.eos_id] * (self.max_length - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))
