"""Serving-step factories and the greedy generation loop (port of
``repro.train.serve_step``): one prefill, then one decode step per
generated token, eagerly. The factories are plain closures over the
model (the reference jits them; the port runs them as they are).

``greedy_generate(mesh=)`` is the data-parallel serve cell in eager SPMD:
every rank of the mesh calls it with the same arguments, the batch goes
under the ``batch`` rule (:func:`_place_batch`: each rank keeps its rows,
or every rank all of them where the extent does not divide the batch,
with the warning), each rank prefills and decodes its rows, and the
tokens are gathered once, through the host, into the whole ``(B,
n_steps)`` array on every rank. A row's reductions never leave its rank,
so the tokens are bit-identical to one rank's.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding
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


def _place_batch(batch, mesh) -> dict:
    """The batch as DTensors on ``mesh``: each leaf's leading (batch) dim
    under the ``batch`` logical rule where the extent divides it (else
    replicated, and ``spec`` warns), the rest replicated."""
    def one(v):
        v = torch.as_tensor(v)
        pl = sharding.spec("batch", *([None] * (v.ndim - 1)),
                           shape=tuple(v.shape), mesh=mesh)
        return sharding.distribute(v, mesh, pl)
    return {k: one(v) for k, v in batch.items()}


def _prefill_placed(model: Model, params, placed: dict, max_len: int):
    """Prefill this rank's rows of a placed batch: (its last-position
    logits, the caches as DTensors under the batch's placement: ``Shard``
    on each leaf's batch dim, dim 1 under a stacked ``body`` and 0 in the
    ``tail``, where the batch is split)."""
    from torch.distributed.tensor import Shard
    local = {k: v.to_local() for k, v in placed.items()}
    logits, caches = model.prefill(params, local, max_len)
    rows = placed["tokens"].placements
    mesh = placed["tokens"].device_mesh

    def place(tree, bdim):
        if isinstance(tree, dict):
            return {k: place(v, bdim) for k, v in tree.items()}
        pl = tuple(Shard(bdim) if p.is_shard() else p for p in rows)
        return sharding.wrap_local(tree, mesh, pl)
    return logits, {k: place(v, 1 if k == "body" else 0)
                    for k, v in caches.items()}


def _generate_on_mesh(model, params, batch, max_len, n_steps, mesh):
    params = sharding.local_tree(params)
    with sharding.set_mesh(mesh):
        placed = _place_batch(batch, mesh)
        logits, caches = _prefill_placed(model, params, placed, max_len)
        caches = sharding.local_chunks(caches)
        step_fn = make_decode_step(model)
        prompt_len = batch["tokens"].shape[1]
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(n_steps - 1):
            logits, caches = step_fn(params, caches, tok, prompt_len + i)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            toks.append(tok)
        return sharding.gather_rows(torch.cat(toks, dim=1), mesh,
                                    placed["tokens"].placements)


def greedy_generate(model: Model, params, batch, max_len: int,
                    n_steps: int, *, mesh=None) -> torch.Tensor:
    """Prefill then greedy-decode; returns exactly ``n_steps`` tokens.

    The result is ``(B, n_steps)`` int32 on the model's device. Token 0 is
    the argmax over the prefill logits at the last prompt position; tokens
    1..n_steps-1 come from ``n_steps - 1`` decode steps. ``n_steps=0``
    returns an empty ``(B, 0)`` tensor without running the model; negative
    ``n_steps`` raises. A config with cross blocks takes its context
    embeddings from ``batch["context"]`` at the prefill; decode reads
    them from the cross caches.

    ``mesh=`` (a DeviceMesh every rank calls this on) runs the loop as the
    data-parallel serve cell (module docstring): each rank prefills and
    decodes its rows of the batch, and the whole ``(B, n_steps)`` tokens
    come back on every rank, bit-identical to one rank's. Plans placed on
    the mesh (``attach_device_plans(mesh=)``) are read as each rank holds
    them. A mesh with a ``model`` axis above 1 is refused (ROADMAP
    A10.2).
    """
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if mesh is not None:
        sharding.require_batch_mesh(mesh, "greedy_generate(mesh=)")
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    b, prompt_len = tokens.shape
    if n_steps == 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=model.device)
    if mesh is not None:
        return _generate_on_mesh(model, params, {**batch, "tokens": tokens},
                                 max_len, n_steps, mesh)
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
