"""Serving-step factories and the greedy generation loop (port of
``repro.train.serve_step``): one prefill, then one decode step per
generated token, eagerly. The factories are plain closures over the
model (the reference jits them; the port runs them as they are)."""
from __future__ import annotations

import torch

from repro_torch.models.model import Model

__all__ = ["make_prefill", "make_decode_step", "greedy_generate"]


def make_prefill(model: Model, max_len: int):
    """``prefill(params, batch) -> (logits, caches)`` over dense caches of
    ``max_len`` positions."""
    def prefill(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill


def make_decode_step(model: Model):
    """``decode_step(params, caches, token, step) -> (logits, caches)``:
    one new token (B, 1) at position ``step``."""
    def decode_step(params, caches, token, step):
        return model.decode_step(params, caches, token, step)
    return decode_step


def greedy_generate(model: Model, params, batch, max_len: int,
                    n_steps: int) -> torch.Tensor:
    """Prefill then greedy-decode; returns exactly ``n_steps`` tokens.

    The result is ``(B, n_steps)`` int32 on the model's device. Token 0 is
    the argmax over the prefill logits at the last prompt position; tokens
    1..n_steps-1 come from ``n_steps - 1`` decode steps. ``n_steps=0``
    returns an empty ``(B, 0)`` tensor without running the model; negative
    ``n_steps`` raises. A config with cross blocks takes its context
    embeddings from ``batch["context"]`` at the prefill; decode reads
    them from the cross caches.
    """
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    b, prompt_len = tokens.shape
    if n_steps == 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=model.device)
    step_fn = make_decode_step(model)
    logits, caches = make_prefill(model, max_len)(
        params, {**batch, "tokens": tokens})
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = [tok]
    for i in range(n_steps - 1):
        logits, caches = step_fn(params, caches, tok, prompt_len + i)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1)
