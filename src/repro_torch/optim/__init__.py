"""Optimizer substrate (AdamW + schedules), port of ``repro.optim``."""
from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
