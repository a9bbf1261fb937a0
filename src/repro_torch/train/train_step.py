"""Train-step factory (port of ``repro.train.train_step``): microbatched
gradient accumulation and the AdamW update.

``train_step(state, batch) -> (state, metrics)``; the state's params and
optimizer moments are updated in place on their device, as the
reference's donated state is. The compressed data-parallel step of the
reference (``make_compressed_dp_train_step``) is multi-device work, not
ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import (global_norm, leaves, tree_map,
                                     unflatten)

__all__ = ["TrainState", "make_optimizer", "init_state", "make_train_step"]

TrainState = dict[str, Any]


def _bf16_state(cfg: ModelConfig) -> bool:
    return str(cfg.opt_state_dtype).removeprefix("torch.") in (
        "bfloat16", "bf16")


def make_optimizer(cfg: ModelConfig) -> AdamW:
    mdt = torch.bfloat16 if _bf16_state(cfg) else torch.float32
    return AdamW(moment_dtype=mdt, factored_v=cfg.factored_second_moment)


def init_state(model: Model, opt: AdamW, seed: int = 0) -> TrainState:
    """Params drawn from ``seed`` on the model's device
    (``Model.init(seed, on_device=True)``: on the card no host copy), their
    AdamW state and a step counter (int32 scalar)."""
    params = model.init(seed, on_device=True)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def _value_and_grad(loss_fn, params, mb):
    """(loss, grads laid out like params) of one microbatch."""
    flat = leaves(params)
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss = loss_fn(params, mb)
    return loss.detach(), unflatten(params, torch.autograd.grad(loss, flat))


def _accum_grads(loss_fn, params, batch, n_micro: int,
                 accum_dtype=torch.float32):
    """Average loss and grads over the microbatches (the batch's leading
    axis), in order: the loss sum in f32, the gradient sum in
    ``accum_dtype`` (bf16 halves its memory beside bf16 moments), each
    multiplied by ``1 / n_micro`` at the end. One microbatch: its loss and
    grads as they are."""
    def micro(i):
        return {k: v[i] for k, v in batch.items()}
    if n_micro == 1:
        return _value_and_grad(loss_fn, params, micro(0))
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                          device=p.device), params)
    for i in range(n_micro):
        loss, g = _value_and_grad(loss_fn, params, micro(i))
        for a, b in zip(leaves(gsum), leaves(g)):
            a += b.to(a.dtype)
        del g
        loss_sum = loss_sum + loss
    inv = 1.0 / n_micro
    for g in leaves(gsum):
        g *= inv
    return loss_sum * inv, gsum


def make_train_step(model: Model, opt: AdamW, lr_fn):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch leaves are (grad_accum, micro_batch, ...) on the model's device.
    ``lr`` is read at ``state["step"]`` before the increment; the metric
    ``grad_norm`` is the unclipped global norm of the averaged gradients,
    the one the optimizer clips by."""
    cfg = model.cfg
    accum_dtype = torch.bfloat16 if _bf16_state(cfg) else torch.float32

    def train_step(state: TrainState, batch):
        params = state["params"]
        loss, grads = _accum_grads(model.loss, params, batch, cfg.grad_accum,
                                   accum_dtype)
        lr = lr_fn(state["step"])
        gnorm = global_norm(grads)
        opt.update(grads, state["opt"], params, lr, gnorm=gnorm)
        del grads
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
