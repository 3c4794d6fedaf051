"""Template/schema engine — a copy of the reference's
`arbius_tpu/templates/engine.py`, shipping the anythingv3, kandinsky2,
zeroscopev2xl and damo templates."""
from arbius_tpu_torch.templates.engine import (
    FilterResult,
    HydrationError,
    InputField,
    MiningFilter,
    OutputField,
    Template,
    check_model_filter,
    hydrate_input,
    load_template,
    load_template_bytes,
    template_names,
)

__all__ = [
    "FilterResult",
    "HydrationError",
    "InputField",
    "MiningFilter",
    "OutputField",
    "Template",
    "check_model_filter",
    "hydrate_input",
    "load_template",
    "load_template_bytes",
    "template_names",
]
