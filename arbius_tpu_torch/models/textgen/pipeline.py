"""textgen pipeline: deterministic LLM text serving, in-process.

Twin of arbius_tpu/models/textgen/pipeline.py, single-device. A bucket is
(batch, prompt_bucket, decode_bucket, sampler). Prompts pad to the prompt
bucket edge with eos (the byte tokenizer, bos 257, eos 258, no attention
mask), and the loop always runs the whole decode bucket; the runner
truncates each task to its requested budget on the host, which is sound
because generation is causally prefix-stable: token i depends only on
tokens < i, so a longer decode bucket gives byte-identical prefixes.

The reference jits one program per bucket: prefill, t0 from prefill's
logits at step 0, and a `lax.scan` whose step i embeds t_{i-1} at
position P+i-1 and samples t_i. Here that program is `_run`, a Python
loop over static positions. On CUDA, `generate` captures it once per
bucket as a CUDA graph over static input buffers (the prompt ids and the
seed words) and replays it: one launch a chunk. In int8 or fp8 `_run`
begins by dequantizing the weights, so the dequantization is the graph's
first nodes, writing into the graph's own memory, from which the rest of
the graph reads them. `_run` run eagerly is
the plain loop: the CPU always takes it, and the card only when the
caller passes `eager=True` (chip_smoke.py holds the graph to it). A
failed capture raises.

Sampling: greedy is the first argmax of the float32 logits. Seeded top-k
keeps `lax.top_k`'s order (descending, the lower index first among equal
values: a stable descending sort, as `torch.topk` promises no order among
ties on CUDA) and draws `categorical(fold_in(key, step), vals)` from the
per-task key fold_in(PRNGKey(seed_lo), seed_hi).

`prefill_program` and `decode_program`, which the reference keeps only as
graph-audit trace specs, are not ported (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from arbius_tpu_torch import random as jrandom
from arbius_tpu_torch.models.sd15.bridge import init_params, load_weights
from arbius_tpu_torch.models.sd15.tokenizer import ByteTokenizer
from arbius_tpu_torch.models.textgen.model import TextGenConfig, TextGenModel
from arbius_tpu_torch.quant.core import dequantize_first
from arbius_tpu_torch.quant.modes import mode_tag, validate_mode
from arbius_tpu_torch.utils.platform import setup_device

# the byte tokenizer's control ids: raw UTF-8 bytes are ids 0..255
BOS_ID = 257
EOS_ID = 258

SAMPLERS = ("greedy", "top_k")


def tokens_to_bytes(ids, limit: int, eos_id: int = EOS_ID) -> bytes:
    """Host-side detokenize: the first `limit` generated ids, stopped at
    the first eos, non-byte ids (bos, unused vocab tail) dropped."""
    out = bytearray()
    for tok in np.asarray(ids)[:limit]:
        tok = int(tok)
        if tok == eos_id:
            break
        if 0 <= tok < 256:
            out.append(tok)
    return bytes(out)


class _Graph:
    """One bucket's captured program: static inputs, the graph, its
    output."""

    def __init__(self, run, ids: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor):
        self.ids, self.lo, self.hi = ids.clone(), lo.clone(), hi.clone()
        # warm up on a side stream (cuBLAS handles, allocator), as
        # torch.cuda.graphs asks before a capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(self.ids, self.lo, self.hi)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.tokens = run(self.ids, self.lo, self.hi)

    def __call__(self, ids, lo, hi) -> torch.Tensor:
        self.ids.copy_(ids)
        self.lo.copy_(lo)
        self.hi.copy_(hi)
        self.graph.replay()
        # the next replay overwrites the output buffer
        return self.tokens.clone()


class TextGenPipeline:
    """The decoder on one device plus the bucket program."""

    BOS_ID = BOS_ID
    EOS_ID = EOS_ID

    def __init__(self, config: TextGenConfig | None = None,
                 device: str | torch.device = "cuda",
                 prompt_buckets: tuple = (32, 64),
                 decode_buckets: tuple = (16, 32), top_k: int = 8,
                 precision: str = "bf16"):
        self.config = config or TextGenConfig()
        # precision mode (docs/quantization.md): int8 and fp8 hold the
        # eligible weights quantized and each bucket program begins by
        # dequantizing them; each mode is its own determinism class
        self.precision = validate_mode(precision)
        self.quantized = None
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.decode_buckets = tuple(sorted(int(b) for b in decode_buckets))
        if not self.prompt_buckets or not self.decode_buckets:
            raise ValueError("prompt_buckets and decode_buckets must be "
                             "non-empty")
        if self.prompt_buckets[0] < 3:
            raise ValueError("prompt bucket edges must be >= 3 "
                             "(bos + at least one byte + eos)")
        if self.decode_buckets[0] < 1:
            raise ValueError("decode bucket edges must be >= 1")
        need = self.prompt_buckets[-1] + self.decode_buckets[-1]
        if need > self.config.max_positions:
            raise ValueError(
                f"bucket edges need {need} positions but the model tops "
                f"out at {self.config.max_positions}")
        self.top_k = int(top_k)
        if not 1 <= self.top_k <= self.config.vocab_size:
            raise ValueError(
                f"top_k ({self.top_k}) must be in [1, vocab_size]")
        self.device = setup_device(device)
        self.model = TextGenModel(self.config, self.device).eval()
        self.model.requires_grad_(False)
        self._graphs: dict[tuple, _Graph] = {}
        self._tokenizers: dict[int, ByteTokenizer] = {}

    # -- bucket policy ---------------------------------------------------
    def prompt_bucket_for(self, prompt: str) -> int:
        """Smallest prompt edge that fits bos + bytes + eos; longer
        prompts truncate into the top edge."""
        need = len(str(prompt).encode("utf-8")) + 2
        for edge in self.prompt_buckets:
            if need <= edge:
                return edge
        return self.prompt_buckets[-1]

    def decode_bucket_for(self, max_new_tokens: int) -> int:
        """Smallest decode edge covering the budget; larger budgets clamp
        to the top edge."""
        n = max(1, int(max_new_tokens))
        for edge in self.decode_buckets:
            if n <= edge:
                return edge
        return self.decode_buckets[-1]

    def _tokenizer(self, prompt_bucket: int) -> ByteTokenizer:
        tok = self._tokenizers.get(prompt_bucket)
        if tok is None:
            tok = ByteTokenizer(max_length=prompt_bucket,
                                bos_id=self.BOS_ID, eos_id=self.EOS_ID)
            self._tokenizers[prompt_bucket] = tok
        return tok

    # -- params ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Seeded random weights on the pipeline's device, flax's default
        distributions (bridge.init_params)."""
        return init_params(self.model, seed, self.device)

    def load_params(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Copy a state_dict in (every key required); linear weights round
        to their compute dtype here, once. The copy is in place, so a
        captured graph reads the new weights. In int8 or fp8 the eligible
        leaves are quantized here instead (bridge.load_weights) into new
        storage, which no captured graph reads: the graphs are dropped."""
        self.quantized = load_weights(self.model, state_dict, self.precision)
        if self.quantized is not None:
            self._graphs.clear()

    def bucket_tag(self, batch: int, prompt_bucket: int, decode_bucket: int,
                   sampler: str) -> str:
        """The one definition of this family's bucket tag; a quantized
        mode suffixes it (".int8"/".fp8")."""
        return "textgen." + ".".join(
            str(k) for k in (batch, prompt_bucket, decode_bucket, sampler)) \
            + mode_tag(self.precision)

    # -- the bucket program ------------------------------------------------
    def _sample(self, sampler: str, logits: torch.Tensor, keys: torch.Tensor,
                step: int) -> torch.Tensor:
        """logits [B, V] float32 -> token ids [B] (int64)."""
        if sampler == "greedy":
            return torch.argmax(logits, dim=-1)
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :self.top_k], idx[:, :self.top_k]
        choice = jrandom.categorical(jrandom.fold_in(keys, step), vals)
        return idx.gather(1, choice[:, None])[:, 0]

    @torch.no_grad()
    @dequantize_first
    def _run(self, ids: torch.Tensor, seeds_lo: torch.Tensor,
             seeds_hi: torch.Tensor, decode_bucket: int,
             sampler: str) -> torch.Tensor:
        """ids [B, P], seed words [B] (int64 on the device) -> tokens
        [B, T] (int64): prefill, t0 at step 0, then step i embeds t_{i-1}
        at position P+i-1 and samples t_i."""
        p, t = ids.shape[1], decode_bucket
        keys = jrandom.fold_in(jrandom.prng_key(seeds_lo, ids.device),
                               seeds_hi)
        logits, kv = self.model.prefill(ids, p + t)
        tok = self._sample(sampler, logits, keys, 0)
        out = [tok]
        for i in range(1, t):
            logits = self.model.decode(tok, kv, p + i - 1)
            tok = self._sample(sampler, logits, keys, i)
            out.append(tok)
        return torch.stack(out, dim=1)

    def generate(self, prompts: list[str], seeds: list[int], *,
                 prompt_bucket: int, decode_bucket: int,
                 sampler: str = "greedy", as_device: bool = False,
                 eager: bool = False):
        """Run a sequence bucket; returns int64 token ids [B, T].

        On CUDA the bucket's captured graph runs, unless `eager=True`
        asks for the plain loop; on the CPU the plain loop runs. With
        `as_device=True` the device tensor comes back without waiting for
        the card; same bits either way."""
        batch = len(prompts)
        if len(seeds) != batch:
            raise ValueError("prompts/seeds must align")
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}")
        p, t = int(prompt_bucket), int(decode_bucket)
        if p not in self.prompt_buckets:
            raise ValueError(
                f"prompt_bucket {p} is not a configured edge "
                f"{self.prompt_buckets}")
        if t not in self.decode_buckets:
            raise ValueError(
                f"decode_bucket {t} is not a configured edge "
                f"{self.decode_buckets}")
        ids = self._tokenizer(p).encode_batch([str(x) for x in prompts])
        seeds_arr = np.asarray(seeds, dtype=np.uint64)

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(
                self.device, non_blocking=True)

        args = (dev(ids), dev(seeds_arr & np.uint64(0xFFFFFFFF)),
                dev(seeds_arr >> np.uint64(32)))
        if self.device.type == "cpu" or eager:
            tokens = self._run(*args, t, sampler)
        else:
            key = (batch, p, t, sampler)
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = _Graph(
                    lambda i, lo, hi: self._run(i, lo, hi, t, sampler),
                    *args)
            tokens = graph(*args)
        if as_device:
            return tokens
        return tokens.cpu().numpy()
