"""Training step factories, the fault-tolerant loop and greedy
generation (port of ``repro.train``)."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainState, make_optimizer, make_train_step)
from repro_torch.train.serve_step import greedy_generate  # noqa: F401
