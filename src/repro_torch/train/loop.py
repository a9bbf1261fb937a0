"""Fault-tolerant training loop (port of ``repro.train.loop``): checkpoint
cadence, exact-restart data, straggler monitoring, metrics logging.

``train(cfg, seq_len=..., global_batch=..., steps=..., ckpt_dir=...)`` is
what ``launch/train.py`` and the examples drive; it is resumable —
rerunning with the same ckpt_dir continues from the latest checkpoint
(the restart path ``run_with_restarts`` exercises). It runs on ``cuda``
unless ``device="cpu"`` is passed; the weights are drawn on that device
from the seed.
"""
from __future__ import annotations

import json
import logging
import os
import time

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.models.model import Model
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.train_step import (init_state, make_optimizer,
                                          make_train_step)

log = logging.getLogger("repro_torch.train")


def train(cfg: ModelConfig, *, seq_len: int, global_batch: int,
          steps: int, ckpt_dir: str | None = None, ckpt_every: int = 50,
          lr: float = 3e-4, seed: int = 0, log_every: int = 10,
          metrics_path: str | None = None,
          fail_at_step: int | None = None, device=None):
    """Run (or resume) a training job; returns (final_state, history).

    ``fail_at_step`` injects a crash once (fault-tolerance tests and
    examples). ``history`` holds each step's loss and grad_norm."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    opt = make_optimizer(cfg)
    lr_fn = cosine_schedule(lr, warmup=max(steps // 20, 2), total=steps)
    step_fn = make_train_step(model, opt, lr_fn)
    data = SyntheticLM(cfg, seq_len, global_batch, seed=seed, device=dev)

    state = init_state(model, opt, seed)
    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2)
        restored, rstep = mgr.restore_latest(state)
        if restored is not None:
            state, start = restored, rstep
            log.info("resumed from step %d", start)

    mon = StragglerMonitor()
    history = []
    failed = {"done": False}
    t_total = time.time()
    for step in range(start, steps):
        if fail_at_step is not None and step == fail_at_step \
                and not failed["done"]:
            failed["done"] = True
            raise RuntimeError(f"injected failure at step {step}")
        batch = data.batch(step, cfg.grad_accum)
        mon.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        mon.stop()
        history.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"])})
        if step % log_every == 0:
            log.info("step %d loss %.4f", step, loss)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state)
    if mgr:
        mgr.save(steps, state)
        mgr.wait()
    if metrics_path:
        os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
        with open(metrics_path, "w") as f:
            for h in history:
                f.write(json.dumps(h) + "\n")
    log.info("trained %d steps in %.1fs; stragglers=%d",
             steps - start, time.time() - t_total, mon.stragglers)
    return state, history
