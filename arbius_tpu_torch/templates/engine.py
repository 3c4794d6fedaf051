"""Template parsing, input hydration, and mining filters.

Behavioral parity with the reference miner's `models.ts`:
  - hydrate_input       ≡ hydrateInput   (`miner/src/models.ts:145-220`)
  - check_model_filter  ≡ checkModelFilter (`miner/src/models.ts:100-143`)

Two deliberate divergences from reference bugs, both documented here:
  1. `models.ts:194` writes ``row > col.max`` (comparing the schema row
     object against an undefined property), so the reference never enforces
     the declared max. We enforce both bounds.
  2. `models.ts:185-188` type-checks ``decimal`` with the same int cast as
     ``int`` (``col !== (col|0)``), so fractional decimals like
     guidance_scale 17.5 are rejected by the reference validator even though
     templates declare decimal ranges. We accept finite int/float.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from importlib import resources
from typing import Any

VALID_TYPES = ("string", "int", "decimal", "string_enum", "int_enum", "file")
VALID_OUTPUT_TYPES = ("image", "video", "text", "audio")


class HydrationError(ValueError):
    """Input does not satisfy the template schema."""


@dataclass(frozen=True)
class InputField:
    variable: str
    type: str
    required: bool = False
    default: Any = None
    min: float | None = None
    max: float | None = None
    choices: tuple = ()
    description: str = ""


@dataclass(frozen=True)
class OutputField:
    filename: str
    type: str


@dataclass(frozen=True)
class Template:
    """Parsed model template (schema in `docs/src/pages/register-model.mdx`)."""
    title: str
    description: str
    version: int
    git: str = ""
    docker: str = ""
    inputs: tuple[InputField, ...] = ()
    outputs: tuple[OutputField, ...] = ()

    @classmethod
    def from_dict(cls, raw: dict) -> "Template":
        meta = raw.get("meta", {})
        inputs = []
        for row in raw.get("input", []):
            typ = row["type"]
            if typ not in VALID_TYPES:
                raise ValueError(f"unknown input type {typ!r} for {row.get('variable')}")
            inputs.append(InputField(
                variable=row["variable"],
                type=typ,
                required=bool(row.get("required", False)),
                default=row.get("default"),
                min=row.get("min"),
                max=row.get("max"),
                choices=tuple(row.get("choices", ())),
                description=row.get("description", ""),
            ))
        outputs = []
        for row in raw.get("output", []):
            if row["type"] not in VALID_OUTPUT_TYPES:
                raise ValueError(f"unknown output type {row['type']!r}")
            outputs.append(OutputField(filename=row["filename"], type=row["type"]))
        return cls(
            title=meta.get("title", ""),
            description=meta.get("description", ""),
            version=int(meta.get("version", 0)),
            git=meta.get("git", ""),
            docker=meta.get("docker", ""),
            inputs=tuple(inputs),
            outputs=tuple(outputs),
        )

    def to_json_bytes(self) -> bytes:
        """Canonical bytes for CID/registration purposes — not reconstructed,
        use the original file via load_template_bytes for registration."""
        raise NotImplementedError("register with the original template bytes")


def _data_root():
    return resources.files("arbius_tpu_torch.templates") / "data"


def template_names() -> list[str]:
    return sorted(p.name[:-5] for p in _data_root().iterdir() if p.name.endswith(".json"))


def load_template_bytes(name: str) -> bytes:
    return (_data_root() / f"{name}.json").read_bytes()


def load_template(name: str) -> Template:
    return Template.from_dict(json.loads(load_template_bytes(name)))


def _is_int(value: Any) -> bool:
    return isinstance(value, int) and not isinstance(value, bool)


def _is_number(value: Any) -> bool:
    return (_is_int(value) or isinstance(value, float)) and math.isfinite(value)


def hydrate_input(preprocessed: dict, template: Template) -> dict:
    """Validate raw task input against the template; fill defaults.

    Mirrors `miner/src/models.ts:145-220`: required-field check, type check,
    range check for numerics, enum membership, defaults for absent optionals.
    Raises HydrationError with a message in the reference's format.
    """
    out: dict[str, Any] = {}
    for row in template.inputs:
        col = preprocessed.get(row.variable)
        present = row.variable in preprocessed

        if row.required and not present:
            raise HydrationError(f"input missing required field ({row.variable})")

        if present:
            if row.type in ("string", "string_enum", "file"):
                if not isinstance(col, str):
                    raise HydrationError(f"input wrong type ({row.variable})")
            elif row.type in ("int", "int_enum"):
                if not _is_int(col):
                    raise HydrationError(f"input wrong type ({row.variable})")
            elif row.type == "decimal":
                if not _is_number(col):
                    raise HydrationError(f"input wrong type ({row.variable})")

            if row.type in ("int", "decimal"):
                if row.min is not None and col < row.min:
                    raise HydrationError(f"input out of bounds ({row.variable})")
                if row.max is not None and col > row.max:
                    raise HydrationError(f"input out of bounds ({row.variable})")

            if row.type in ("string_enum", "int_enum"):
                if col not in row.choices:
                    raise HydrationError(f"input not in enum ({row.variable})")

            out[row.variable] = col
        else:
            out[row.variable] = row.default

    return out


@dataclass(frozen=True)
class MiningFilter:
    """Operator-side task acceptance rule (`miner/src/types.ts` MiningFilter)."""
    minfee: int = 0          # wei; task fee must be >= this
    mintime: int = 0         # seconds the task must have aged, 0 = no wait
    owner: str | None = None  # restrict to a task owner address


@dataclass(frozen=True)
class FilterResult:
    model_enabled: bool
    filter_passed: bool
    template: Template | None


def check_model_filter(
    models: dict[str, tuple[Template, list[MiningFilter]]],
    *,
    model: str,
    now: float,
    fee: int,
    blocktime: float,
    owner: str,
) -> FilterResult:
    """≡ checkModelFilter (`miner/src/models.ts:100-143`).

    Note the reference semantics, preserved here: a model with an EMPTY
    filter list never passes — operators must configure at least one filter
    (MiningFilter() accepts everything).
    """
    entry = models.get(model)
    if entry is None:
        return FilterResult(False, False, None)
    template, filters = entry
    for f in filters:
        if f.owner and owner != f.owner:
            continue
        if not fee >= f.minfee:
            continue
        age = now - blocktime
        if f.mintime > 0 and age < f.mintime:
            continue
        return FilterResult(True, True, template)
    return FilterResult(True, False, template)
