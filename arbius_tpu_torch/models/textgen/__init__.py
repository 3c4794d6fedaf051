"""textgen: deterministic LLM text generation (the reference's
docs/text-serving.md), in PyTorch, single-device, in bf16, int8 or fp8.
Its dp layout on the port's mesh of lanes (parallel/) waits for ROADMAP.md
queue 1 item 11; the factory refuses it until then."""
from arbius_tpu_torch.models.textgen.model import TextGenConfig, TextGenModel
from arbius_tpu_torch.models.textgen.pipeline import (
    BOS_ID,
    EOS_ID,
    SAMPLERS,
    TextGenPipeline,
    tokens_to_bytes,
)

__all__ = [
    "BOS_ID",
    "EOS_ID",
    "SAMPLERS",
    "TextGenConfig",
    "TextGenModel",
    "TextGenPipeline",
    "tokens_to_bytes",
]
