"""Precision-mode registry — the names, nothing else.

Kept jax-free so config validation (`node/config.py`) and CLI tooling
can name-check a mode without importing the accelerator stack; the
actual quantization math lives in `quant/core.py`.

A precision mode is a DETERMINISM CLASS, exactly like a mesh layout or
a canonical batch size (docs/quantization.md): `bf16` is the zoo's
shipped bf16-compute/f32-stats program, byte-for-byte; `int8`/`fp8`
quantize the checkpoint weights (per-output-channel symmetric, f32
dequant scales carried as explicit params) and dequantize inside the
jitted bucket program, so each mode is its OWN pinned XLA program —
its own graphlint golden, its own AOT cache key, its own cost-model
rows. A fleet mines one mode per template; modes are never mixed
inside one program.
"""
from __future__ import annotations

# mode → wire/storage width in bytes for a quantized tensor element.
# bf16 maps to None: "no quantization — the leaf's own dtype" (the
# pre-quant path, byte-identical).
PRECISION_MODES: dict[str, int | None] = {"bf16": None, "int8": 1,
                                          "fp8": 1}

DEFAULT_MODE = "bf16"

# symmetric quantization bounds: int8 uses the symmetric [-127, 127]
# grid (never -128 — the symmetric grid keeps 0 exact and negation
# lossless); fp8 e4m3 saturates at +-448
INT8_BOUND = 127.0
FP8_BOUND = 448.0


def validate_mode(mode, where: str = "precision") -> str:
    """Name-check a precision mode with a one-sentence boot-quality
    error (the mesh/slo/aot_cache ConfigError style)."""
    if mode not in PRECISION_MODES:
        known = "|".join(sorted(PRECISION_MODES))
        raise ValueError(
            f"{where}: unknown precision mode {mode!r} — each mode is a "
            f"pinned determinism class, and only {known} ship goldens "
            "(docs/quantization.md)")
    return mode


def wire_width(mode: str) -> int | None:
    """Bytes per element a quantized tensor of this mode occupies on
    the wire (and in HBM); None = the leaf's own dtype width (bf16 —
    no quantization)."""
    return PRECISION_MODES[validate_mode(mode)]


def mode_tag(mode: str) -> str:
    """The suffix a non-default mode contributes to executable-cache
    tags and golden keys; empty for bf16 so every pre-quant tag — and
    therefore every existing golden, AOT entry, and warm-set join —
    stays byte-identical."""
    validate_mode(mode)
    return "" if mode == DEFAULT_MODE else f".{mode}"
