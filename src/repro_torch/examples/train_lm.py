"""End-to-end example (port of ``examples/train_lm.py``): train smollm for
a few hundred steps with checkpointing + fault-tolerant restart, then
resume and verify continuity.

By default a width-reduced smollm; ``--full`` for the real 135M config.
Runs on ``cuda`` unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
      --steps 50 --ckpt build/train_lm [--inject-failure]
"""
import argparse
import logging

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import run_with_restarts
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default="build/train_lm")
    ap.add_argument("--inject-failure", action="store_true",
                    help="crash once mid-run to demo restart-from-checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    device = resolve_device(args.device)

    cfg = get_config("smollm_135m") if args.full \
        else get_reduced("smollm_135m")
    seq, gb = (512, 32) if args.full else (64, 16)

    def loop(attempt):
        _, hist = train(cfg, seq_len=seq, global_batch=gb, steps=args.steps,
                        ckpt_dir=args.ckpt, ckpt_every=25, lr=3e-3,
                        metrics_path=f"{args.ckpt}/metrics.jsonl",
                        fail_at_step=args.steps // 2
                        if (args.inject_failure and attempt == 0) else None,
                        device=device)
        return hist

    hist, restarts = run_with_restarts(loop, max_restarts=2)
    print(f"\nfirst loss {hist[0]['loss']:.3f} -> last {hist[-1]['loss']:.3f}"
          f" (restarts: {restarts})")
    return hist, restarts


if __name__ == "__main__":
    main()
