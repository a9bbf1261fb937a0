"""Deterministic synthetic LM data (port of ``repro.data.pipeline``),
restart-exact.

Batches are keyed by (seed, step) only, so a restart at step N reproduces
the exact stream. Tokens follow a Zipf-like distribution with induced
bigram structure so models learn (loss decreases). The draws are the
reference's, in numpy, call for call: the same batches in both packages.

Layout: (grad_accum, micro_batch, seq), the train step's microbatches on
the leading axis. ``batch_specs`` (the dry run's stand-ins) is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    device: torch.device | str | None = None    # cuda unless "cpu"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        v = self.cfg.vocab
        # fixed random bigram successor table: token t -> t' (learnable)
        self.succ = rng.integers(0, v, size=v, dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.probs = p / p.sum()

    def batch(self, step: int, grad_accum: int = 1) -> dict:
        """Step ``step``'s batch: int32 ``tokens`` and ``labels`` (and f32
        ``context`` for a config with context embeddings), shaped
        (grad_accum, global_batch // grad_accum, ...), on ``device``."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s, v = self.global_batch, self.seq_len, self.cfg.vocab
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.choice(v, size=b, p=self.probs)
        noise = rng.random((b, s))
        fresh = rng.choice(v, size=(b, s), p=self.probs)
        for t in range(s):
            follow = self.succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, follow, fresh[:, t])
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.n_context_tokens or self.cfg.is_encdec:
            ctx = rng.standard_normal(
                (b, self.cfg.n_context_tokens, self.cfg.d_model)) * 0.02
            out["context"] = ctx.astype(np.float32)
        if grad_accum > 1:
            out = {k: a.reshape((grad_accum, b // grad_accum) + a.shape[1:])
                   for k, a in out.items()}
        else:
            out = {k: a[None] for k, a in out.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for k, a in out.items()}
