"""Template/schema engine — a copy of the reference's
`arbius_tpu/templates/engine.py`, shipping the anythingv3 template."""
from arbius_tpu_torch.templates.engine import (
    HydrationError,
    Template,
    hydrate_input,
    load_template,
    load_template_bytes,
)

__all__ = [
    "HydrationError",
    "Template",
    "hydrate_input",
    "load_template",
    "load_template_bytes",
]
