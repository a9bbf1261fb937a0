"""Training launcher CLI (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --seq 512 --batch 32 --ckpt build/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 20 --seq 64 --batch 8

Runs on ``cuda`` unless ``--device cpu`` is given. Resumable: rerunning
with the same --ckpt continues from the latest checkpoint; crashes
restart through the fault policy (max 3 retries).
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import run_with_restarts
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="width-reduced config (CPU-friendly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    device = resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)

    def loop(_attempt):
        _, hist = train(cfg, seq_len=args.seq, global_batch=args.batch,
                        steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=args.ckpt_every, lr=args.lr,
                        seed=args.seed, device=device,
                        metrics_path=(f"{args.ckpt}/metrics.jsonl"
                                      if args.ckpt else None))
        return hist

    hist, restarts = run_with_restarts(loop, max_restarts=3)
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({len(hist)} steps this attempt, {restarts} restarts)")
    return hist, restarts


if __name__ == "__main__":
    main()
