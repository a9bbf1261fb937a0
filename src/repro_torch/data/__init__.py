"""Data pipeline substrate (port of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLM  # noqa: F401
